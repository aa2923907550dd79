"""Chaining in mckpp_torch (``models/chain.py``).

``plan_segments`` is held to mckpp_tpu's on the cadences of
tests/test_chain.py.  The port's chain, run eagerly on the CPU, is held
to its own per-step loop plus ``DiagnosticsManager.step``: the same
trajectory bit for bit and the same emitted windows, with and without a
reducing stream that samples a wide field.  The chain replayed as CUDA
graphs is held to the eager chain on the card, in
tests/test_torch_kernels.py (it runs there without jax).
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mckpp_tpu.io.diagnostics import DiagnosticsManager as JDiag
from mckpp_tpu.io.diagnostics import Stream as JStream
from mckpp_tpu.models import chain as jchain

import mckpp_torch as T
from mckpp_torch import forcing as tforcing
from mckpp_torch.grid import coriolis
from mckpp_torch.io.diagnostics import DiagnosticsManager, Stream
from mckpp_torch.models import chain as tchain
from mckpp_torch.state import init_params


CADENCES = [
    # (num_steps, ndtocn, streams (name, op, freq), start steps, max_k)
    (18, 3, [("i", "instant", 3), ("m", "average", 9)], (), 32),
    (6, 3, [("i", "instant", 3), ("m", "average", 9)], (2,), 32),
    (10, 100, [], (), 4),
    (4, 1, [("i", "instant", 1)], (), 32),
    (24, 3, [("a", "instant", 3), ("b", "average", 9), ("c", "maximum", 9)],
     (7, 16), 5),
]


@pytest.mark.parametrize("case", range(len(CADENCES)))
def test_plan_segments_matches_jax(case):
    n, ndtocn, spec, starts, max_k = CADENCES[case]
    zm = np.linspace(0, -10, 4)
    jd = JDiag([JStream(s, op, f, fields=("T",)) for s, op, f in spec],
               1, 1, zm)
    td = DiagnosticsManager([Stream(s, op, f, fields=("T",))
                             for s, op, f in spec], 1, 1, zm)
    got = tchain.plan_segments(
        n, ndtocn=ndtocn, end_pred=lambda nt: tchain.emit_due(td, nt),
        start_pred=lambda nt: nt in starts, max_k=max_k)
    ref = jchain.plan_segments(
        n, ndtocn=ndtocn, end_pred=lambda nt: jchain.emit_due(jd, nt),
        start_pred=lambda nt: nt in starts, max_k=max_k)
    assert got == ref
    assert sum(k for _, k in got) == n


def _setup(outdir, wide, ncol=3, nz=16, physics=None):
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=250.0),
        time=T.TimeConfig(dtsec=3600.0, ndtocn=3, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(**(physics or {})), dtype="float32")
    model = T.KppModel(cfg, device="cpu")
    nzp1 = nz + 1
    zm = model.grid.zm.double().cpu().numpy()
    t0 = np.tile(20.0 + 5.0 * np.exp(zm / 50.0), (ncol, 1))
    s0 = np.tile(35.0 - 0.5 * np.exp(zm / 100.0), (ncol, 1))
    u0 = np.zeros((ncol, nzp1, 2))
    prm = init_params(ncol, nzp1, dtype=model.dtype, device=model.device)
    lat = torch.linspace(5.0, 25.0, ncol, dtype=model.dtype,
                         device=model.device)
    prm = prm.replace(f=coriolis(lat), dlat=lat)
    st, prm, frc = model.initial_state(u0, t0, s0, prm)
    raw = tforcing.constant_test_fluxes(ncol, model.dtype, model.device)
    st, frc = tforcing.update_fluxes(cfg, st, prm, frc, raw, True,
                                     model.grid.dm)
    # instant every 2 steps, a narrow mean every 4 and a min every 4 that
    # samples a wide field in the wide variant (every step then
    # materializes the diagnostics)
    streams = [Stream("inst2", "instant", 2, fields=("T", "hmix", "difs")),
               Stream("mean4", "average", 4, fields=("S", "hmix")),
               Stream("min4", "minimum", 4,
                      fields=("difm",) if wide else ("T",))]
    diag = DiagnosticsManager(streams, nx=ncol, ny=1, zm=zm, outdir=outdir,
                              dto_seconds=cfg.time.dto, async_write=False)
    return model, st, prm, frc, diag, cfg


def _per_step(model, st, prm, frc, diag, n):
    for nt in range(1, n + 1):
        st = model.step(st, prm, frc, first_step=(nt <= 1),
                        with_diags=diag.needs_full(nt))
        diag.step(nt, st, prm, frc)
    return st


def _chained(model, st, prm, frc, diag, cfg, n):
    stepper = tchain.ChainedStepper(model._step, diag)

    def end(nt):
        return (tchain.emit_due(diag, nt)
                or (diag.needs_full(nt) and not stepper.wide_reducing))

    segs = tchain.plan_segments(n, ndtocn=cfg.time.ndtocn, end_pred=end)
    assert max(k for _, k in segs) > 1          # the test must chain
    for nt0, k in segs:
        st = stepper.run(nt0, k, st, prm, frc)
    return st, stepper


def _same_state(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x.cpu(), y.cpu()), f.name


def _same_files(paths_a, paths_b):
    assert set(paths_a) == set(paths_b)
    for key in paths_a:
        with netcdf_file(paths_a[key], "r", mmap=False) as na, \
                netcdf_file(paths_b[key], "r", mmap=False) as nb:
            assert set(na.variables) == set(nb.variables)
            for v in na.variables:
                np.testing.assert_array_equal(np.asarray(na.variables[v][:]),
                                              np.asarray(nb.variables[v][:]),
                                              err_msg=f"{key}:{v}")


def _chain_vs_per_step(tmp_path, wide, physics=None):
    n = 9
    model, st, prm, frc, diag, cfg = _setup(str(tmp_path / "ref"), wide,
                                            physics=physics)
    st_ref = _per_step(model, st, prm, frc, diag, n)
    paths_ref = diag.flush()

    model2, st2, prm2, frc2, diag2, _ = _setup(str(tmp_path / "ch"), wide,
                                               physics=physics)
    st_ch, stepper = _chained(model2, st2, prm2, frc2, diag2, cfg, n)
    assert stepper.wide_reducing == wide
    assert stepper.captures == 0               # eager on the CPU
    paths_ch = diag2.flush()
    _same_state(st_ref, st_ch)
    _same_files(paths_ref, paths_ch)
    return model


@pytest.mark.parametrize("wide", [False, True])
def test_chain_bitwise_vs_per_step(tmp_path, wide):
    _chain_vs_per_step(tmp_path, wide)


@pytest.mark.parametrize("wide", [False, True])
def test_chain_bitwise_vs_per_step_reference(tmp_path, wide):
    """The same over the reference step (Thomas solver, wscale table),
    which always materialises its diagnostics."""
    model = _chain_vs_per_step(tmp_path, wide, dict(solver="thomas",
                                                    wscale_mode="table"))
    assert model.pass_impl == "reference"


def test_chain_first_step_flag(tmp_path):
    """A chain over steps 1..2 applies the first-step semantics to step 1
    only: it equals two manual steps."""
    model, st, prm, frc, diag, cfg = _setup(str(tmp_path), False)
    st_a = model.step(st, prm, frc, first_step=True, with_diags=False)
    st_a = model.step(st_a, prm, frc, first_step=False, with_diags=False)
    stepper = tchain.ChainedStepper(model._step, diag)
    st_b = stepper.exec(1, 2, st, prm, frc, final_full=False)[0]
    _same_state(st_a, st_b)
