"""The benchmark's plain reference, at toy size on the CPU, equals the
port's plain reference step (``pass_impl="reference"``) bit for bit, and
the port's plain whole-step body with the analytic velocity scales (the
card's float32 default) to rounding, through the CLI loop's flux and SST
updates."""

import dataclasses

import numpy as np
import pytest
import torch

from kppbench import inputs, spec
from kppbench.reference import column

STEPS = 9


# the benchmark's configuration, and one at nz 40 without SST relaxation
VARIANTS = {"terramaris": {},
            "nz40_no_relax": {"nz": 40, "relax_sst_days": None, "sst": None}}


def _toy(tmp_path, variant="terramaris", seed=20240611):
    cell = spec.resolve("terramaris.kpp_means")
    cfg = dict(cell.config, nx=6, ny=5, **VARIANTS[variant])
    data = str(tmp_path / "in")
    inputs.prepare(cfg, cell.traffic, str(tmp_path / "static"), data, seed)
    with open(f"{data}/3D_ocn.nml", "w") as f:
        f.write(inputs.namelist(cfg, STEPS, 0))
    return cfg, data


def _port(data, impl, wscale):
    from mckpp_torch import forcing, setup
    from mckpp_torch.utils import namelist as nml
    kcfg, _ = nml.load_config(f"{data}/3D_ocn.nml")
    kcfg = dataclasses.replace(
        kcfg, dtype="float64", physics=dataclasses.replace(
            kcfg.physics, pass_impl=impl, wscale_mode=wscale))
    model, st, prm, frc, _, mgr = setup.build(kcfg, data, device="cpu")
    t = kcfg.time
    states = [st]
    for nt in range(1, STEPS + 1):
        time_days = t.startt + (nt - 1) * t.dto / 86400.0
        if (nt - 1) % t.ndtocn == 0:
            raw = forcing.constant_test_fluxes(st.u.shape[0], model.dtype)
            st, frc = forcing.update_fluxes(kcfg, st, prm, frc, raw, nt <= 1,
                                            model.grid.dm)
        if nt != 1:
            frc = mgr.update(nt, time_days, frc)
        st = model.step(st, prm, frc, first_step=nt <= 1)
        states.append(st)
    return states, prm, frc


def _ref(cfg, data, wscale, steps):
    cols = np.arange(cfg["nx"] * cfg["ny"])
    col = column.load_columns(cfg, data, cols, wscale=wscale)
    st, prm, frc = column.initial_state(cfg, data, col, cols)
    if steps:
        st, frc, _, _ = column.run(col, st, prm, frc, 0, steps, [])
    return st, prm, frc


FIELDS = ("u", "x", "hmix", "kmix", "rho", "cp", "us", "xs", "difm",
          "difs", "dift", "ghat", "wxnt", "swdk_opt")


def test_initial_state_equals_the_port(tmp_path):
    cfg, data = _toy(tmp_path)
    states, prm, frc = _port(data, "reference", "nodal")
    st, rprm, rfrc = _ref(cfg, data, "nodal", 0)
    for f in FIELDS:
        assert torch.equal(getattr(states[0], f), getattr(st, f)), f
    for f in ("sref", "f", "relax_sst", "l_ocean", "jerlov"):
        assert torch.equal(getattr(prm, f), getattr(rprm, f)), f


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reference_step_equals_the_port(tmp_path, variant):
    cfg, data = _toy(tmp_path, variant)
    states, _, frc = _port(data, "reference", "nodal")
    st, _, rfrc = _ref(cfg, data, "nodal", STEPS)
    for f in FIELDS:
        assert torch.equal(getattr(states[-1], f), getattr(st, f)), f
    assert torch.equal(frc.sst0, rfrc.sst0)
    assert torch.equal(frc.sflux, rfrc.sflux)


def test_analytic_step_matches_the_fused_body(tmp_path):
    cfg, data = _toy(tmp_path)
    states, _, _ = _port(data, "eager_step", "analytic")
    st, _, _ = _ref(cfg, data, "analytic", STEPS)
    got = states[-1]
    assert torch.equal(got.kmix, st.kmix)
    for f in ("u", "x", "hmix"):
        a, b = getattr(got, f), getattr(st, f)
        scale = b.abs().max()
        assert float((a - b).abs().max() / scale) < 1e-10, f
