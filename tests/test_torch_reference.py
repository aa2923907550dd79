"""The reference step (``pass_impl="reference"``: ``ops/ocnstep.py`` over
``ops/vmix.py`` and ``ops/ocnint.py``) of mckpp_torch, in float64 on the
CPU, held three ways:

* against the independent loop-for-loop NumPy transliteration of the
  Fortran (tests/oracle_fortran.py) with the reference's operation order
  (solver "thomas") and the resident wscale table, over the trajectories
  of tests/test_oracle_trajectory.py (constant forcing 12 steps;
  relaxation, corrections and damping 8 steps; advection 6 steps) and the
  extra_iters case of tests/test_extra_iters.py, each field under that
  file's FIELD_TOL with kmix, old, new and reset_flag equal.  The oracle
  needs no JAX compile, so these run in the fast tier;
* against mckpp_tpu's reference model: 3 steps with the instability trap
  firing, a land column and current damping, at rtol 1e-9 by the field
  scales of tests/test_fused_parity.py (the JAX package's own bar for
  fused against reference), kmix/old/new equal.  The JAX reference step
  compiles slowly on the CPU, so only the (thomas, table) case runs in the
  fast tier and the others are marked slow;
* against the port's own fused step ("eager_step", pcr, nodal) on the same
  inputs at the same bar, and for properties of its own: land
  pass-through, column independence (bit for bit), float32 purity and
  the option rules.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mckpp_tpu as J
import oracle_fortran as orc
import test_oracle_trajectory as tj
from test_torch_model import NCOL as NCOL_M
from test_torch_model import (TRAP_LAND_DAMP, assert_states_close, configs,
                              fields, jax_run, jax_start, port_run,
                              port_start, taux_of)

import mckpp_torch as T
from mckpp_torch import convert
from mckpp_torch import forcing as tforcing
from mckpp_torch.grid import coriolis
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.state import init_params

NCOL, NZ, NZP1 = tj.NCOL, tj.NZ, tj.NZP1


# ---------------------------------------------------------------------------
# against the Fortran transliteration
# ---------------------------------------------------------------------------

def oracle_model(**phys):
    """The oracle trajectories' configuration (test_oracle_trajectory
    make_model) in the port."""
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=NCOL, ny=1, nz=NZ, dmax=200.0),
        time=T.TimeConfig(dtsec=1200.0, ndtocn=1, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(solver="thomas", wscale_mode="table",
                               pass_impl="reference", **phys),
        dtype="float64")
    return T.KppModel(cfg, device="cpu")


def with_features(model, boundary=None, forcing=None):
    cfg = model.cfg
    if boundary:
        cfg = cfg.replace(boundary=dataclasses.replace(cfg.boundary,
                                                       **boundary))
    if forcing:
        cfg = cfg.replace(forcing=dataclasses.replace(cfg.forcing,
                                                      **forcing))
    return T.KppModel(cfg, device="cpu")


def oracle_initial(model):
    """test_oracle_trajectory.make_initial in the port."""
    zm = model.grid.zm.numpy()
    t0 = np.stack([20.0 + 8.0 * np.exp(zm / 60.0),
                   12.0 + 5.0 * np.exp(zm / 40.0),
                   26.0 + 3.0 * np.exp(zm / 90.0)])
    s0 = np.stack([35.0 - 0.4 * np.exp(zm / 80.0),
                   34.0 + 0.3 * np.exp(zm / 50.0),
                   35.5 - 0.2 * np.exp(zm / 70.0)])
    u0 = np.zeros((NCOL, NZP1, 2))
    u0[:, :, 0] = 0.08 * np.exp(zm / 30.0)[None, :]
    u0[:, :, 1] = -0.05 * np.exp(zm / 45.0)[None, :]
    lat = torch.tensor([10.0, 35.0, -20.0], dtype=torch.float64)
    prm = init_params(NCOL, NZP1).replace(
        f=coriolis(lat), dlat=lat,
        jerlov=torch.tensor([2, 0, 4], dtype=torch.int32))
    return model.initial_state(u0, t0, s0, prm)


def oracle_trajectory(model, n_steps, raw_fn=None, frc_mod=None,
                      prm_mod=None):
    """test_oracle_trajectory.run_trajectory with the port's model: the
    oracle is seeded from the state after the first flux update and both
    step side by side, compared every step."""
    st, prm, frc = oracle_initial(model)
    if prm_mod is not None:
        prm = prm_mod(prm)
    if frc_mod is not None:
        frc = frc_mod(frc)
    cst = tj.make_cst(model)
    flds = None
    for nt in range(1, n_steps + 1):
        raw = (raw_fn(nt) if raw_fn is not None
               else tforcing.constant_test_fluxes(NCOL))
        st, frc = tforcing.update_fluxes(model.cfg, st, prm, frc, raw,
                                         nt <= 1, model.grid.dm)
        if flds is None:
            flds = [tj.state_to_fld(st, prm, frc, i) for i in range(NCOL)]
        else:
            for i, fld in enumerate(flds):
                fld["sflux"][1:] = frc.sflux[i].numpy()
                orc.ntflux(fld, cst, nt)
        st = model.step(st, prm, frc, first_step=(nt <= 1))
        for i, fld in enumerate(flds):
            orc.ocnstep(fld, cst, nt)
            orc.check_profile(fld, cst)
            tj.compare_column(st, i, fld, nt)
    return st, flds


def test_oracle_constant_forcing():
    """12 steps, constant test fluxes, no ancillaries."""
    model = oracle_model()
    assert model.pass_impl == "reference"
    before = dict(ck.LAUNCHES)
    oracle_trajectory(model, 12)
    assert dict(ck.LAUNCHES) == before          # no kernel on this path


def test_oracle_relaxation_corrections_damping():
    """SST relaxation, 3-D T and S relaxation and current damping: the
    ocnint correction branches and the damping block."""
    model = with_features(
        oracle_model(),
        boundary=dict(l_relax_sst=True, l_relax_sal=True, l_relax_ocnt=True),
        forcing=dict(l_fcorr=False, l_damp_curr=True, dtuvdamp=360))
    dt = torch.float64

    def prm_mod(prm):
        return prm.replace(
            relax_sst=torch.full((NCOL,), 1.0 / (5.0 * 86400.0), dtype=dt),
            relax_sal=torch.full((NCOL,), 1.0 / (10.0 * 86400.0), dtype=dt),
            relax_ocnt=torch.full((NCOL,), 1.0 / (15.0 * 86400.0), dtype=dt))

    def frc_mod(frc):
        zm = model.grid.zm.numpy()
        ocnt = np.stack([19.0 + 7.0 * np.exp(zm / 55.0),
                         11.0 + 6.0 * np.exp(zm / 45.0),
                         25.0 + 4.0 * np.exp(zm / 85.0)])
        return frc.replace(sst0=torch.tensor([21.0, 13.0, 26.5]),
                           ocnt_clim=torch.tensor(ocnt),
                           sal_clim=torch.full((NCOL, NZP1), 0.05))

    st, _ = oracle_trajectory(model, 8, frc_mod=frc_mod, prm_mod=prm_mod)
    assert float(st.dampu_flag.max()) > 0.0, "damping did not act"


def test_oracle_advection():
    """Mixed rhsmod modes across columns, salinity only: the temperature
    modes are configured and must be ignored."""
    model = with_features(oracle_model(), boundary=dict(l_advect=True))

    def prm_mod(prm):
        nmode = np.zeros((NCOL, 2), np.int32)
        mode = np.zeros((NCOL, tj.MAXMODEADV, 2), np.int32)
        mag = np.zeros((NCOL, tj.MAXMODEADV, 2))
        nmode[0, 1], mode[0, :2, 1], mag[0, :2, 1] = 2, [1, 3], [2e-6, -1e-6]
        nmode[1, 1], mode[1, :2, 1], mag[1, :2, 1] = 2, [2, 4], [1.5e-6, 1e-6]
        nmode[2, 1] = 3
        mode[2, :3, 1], mag[2, :3, 1] = [5, 6, 7], [1e-6, 2e-6, -5e-7]
        nmode[:, 0], mode[:, 0, 0], mag[:, 0, 0] = 1, 3, 50.0
        return prm.replace(nmodeadv=torch.tensor(nmode),
                           modeadv=torch.tensor(mode),
                           advection=torch.tensor(mag))

    oracle_trajectory(model, 6, prm_mod=prm_mod)


def convective(nt):
    """test_extra_iters.convective: strong surface cooling, no sun."""
    raw = tforcing.constant_test_fluxes(NCOL)
    return raw._replace(swf=torch.zeros(NCOL),
                        lhf=torch.full((NCOL,), -900.0),
                        taux=torch.full((NCOL,), 0.2))


def test_oracle_extra_iters():
    """The hmix loop's deepening branch past itermax: with a generous
    extra_iters cap the port equals the oracle's unbounded loop; with a
    cap of 1 the long-iterating column differs but stays finite."""
    itermax, tolfrac = 4, 1e-7
    model = oracle_model(itermax=itermax, hmixtolfrac=tolfrac,
                         extra_iters=400)
    st, prm, frc = oracle_initial(model)
    st, frc = tforcing.update_fluxes(model.cfg, st, prm, frc, convective(1),
                                     True, model.grid.dm)
    cst = tj.make_cst(model)
    flds = [tj.state_to_fld(st, prm, frc, i) for i in range(NCOL)]
    st1 = model.step(st, prm, frc, first_step=True)
    niters = []
    for i, fld in enumerate(flds):
        orc.ocnstep(fld, cst, 1)
        orc.check_profile(fld, cst)
        niters.append(fld["niter"])
        tj.compare_column(st1, i, fld, 1)
    assert max(niters) > itermax + 2, niters

    capped = oracle_model(itermax=itermax, hmixtolfrac=tolfrac, extra_iters=1)
    st_c = capped.step(st, prm, frc, first_step=True)
    assert torch.isfinite(st_c.x).all()
    i = int(np.argmax(niters))
    assert not np.isclose(float(st_c.hmix[i]), flds[i]["hmix"], rtol=1e-12)


# ---------------------------------------------------------------------------
# against mckpp_tpu's reference model, and the port's fused step
# ---------------------------------------------------------------------------

def ref_configs(pkg, dtype="float64", **physics):
    cfg = configs(pkg, "reference", dtype, **TRAP_LAND_DAMP)
    return cfg.replace(physics=dataclasses.replace(cfg.physics, **physics))


def held_to_jax(**physics):
    jm, jst, jprm, jfrc = jax_start(ref_configs(J, **physics))
    tm, tst, tprm, tfrc = port_start(ref_configs(T, **physics))
    assert jm.pass_impl == tm.pass_impl == "reference"
    before = dict(ck.LAUNCHES)
    port = port_run(tm, tst, tprm, tfrc, 3)
    assert dict(ck.LAUNCHES) == before
    ref = jax_run(jm, jst, jprm, jfrc, 3)
    assert abs(float(ref.reset_flag[0])) == 999.0, "trap did not fire"
    assert_states_close(port, ref, rtol=1e-9)
    for name in ("reset_flag", "kmix", "old", "new"):
        np.testing.assert_array_equal(fields(port)[name], fields(ref)[name])
    return port


def test_reference_step_matches_jax_thomas_table():
    held_to_jax(solver="thomas", wscale_mode="table")


@pytest.mark.slow
@pytest.mark.parametrize("physics", [
    dict(solver="pcr", wscale_mode="nodal"),
    dict(solver="thomas", wscale_mode="nodal", ldd=True, l_ssref=False)],
    ids=["pcr_nodal", "thomas_nodal_ldd"])
def test_reference_step_matches_jax(physics):
    held_to_jax(**physics)


def test_reference_matches_fused_step():
    """pcr + nodal: the reference step against the port's plain whole-step
    body on the same inputs (trap, land and damping as above)."""
    tm, st, prm, frc = port_start(ref_configs(T, wscale_mode="nodal"))
    fm = port_start(configs(T, "eager_step", **TRAP_LAND_DAMP))[0]
    ref = port_run(tm, st, prm, frc, 3)
    fused = port_run(fm, st, prm, frc, 3)
    assert_states_close(ref, fused, rtol=1e-9)
    # the land column passes through the reference step untouched
    for k in ("x", "u", "us", "xs", "hmix", "difm"):
        np.testing.assert_array_equal(fields(ref)[k][2], fields(st)[k][2])


def test_reference_float32_stays_float32():
    """thomas + table in float32: every float state field stays float32,
    the resident tables included."""
    model, st, prm, frc = port_start(
        ref_configs(T, "float32", solver="thomas", wscale_mode="table"),
        dtype=torch.float32)
    assert all(t.dtype == torch.float32 and t.shape == (892, 50)
               for t in model.tables)
    out = port_run(model, st, prm, frc, 2)
    for name, a in convert.to_numpy(out).items():
        if np.issubdtype(a.dtype, np.floating):
            assert a.dtype == np.float32, name
    assert np.isfinite(convert.to_numpy(out)["x"]).all()
    assert out.kmix.dtype == torch.int32


@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("wscale_mode", ["table", "nodal"])
def test_reference_options_construct_and_step(solver, wscale_mode):
    model, st, prm, frc = port_start(ref_configs(
        T, solver=solver, wscale_mode=wscale_mode))
    assert model.pass_impl == "reference"
    assert (model.tables is not None) == (wscale_mode == "table")
    out = port_run(model, st, prm, frc, 1)
    assert torch.isfinite(out.x).all()
    assert bool((out.kmix[prm.run_physics] >= 2).all())


def test_reference_columns_independent():
    """A column's step does not depend on its neighbours: the trap column
    and a quiet one stepped alone equal the same columns of the whole
    batch bit for bit (the loops run longer in the batch)."""
    tm, st, prm, frc = port_start(ref_configs(T, solver="thomas",
                                              wscale_mode="table"))

    def run(cols):
        take = lambda obj: type(obj)(**{
            f.name: getattr(obj, f.name)[cols]
            for f in dataclasses.fields(obj)})
        s, p, f = take(st), take(prm), take(frc)
        for nt in (1, 2):
            raw = tforcing.constant_test_fluxes(len(cols))._replace(
                taux=torch.tensor(taux_of(nt)[cols]))
            s, f = tforcing.update_fluxes(tm.cfg, s, p, f, raw, nt <= 1,
                                          tm.grid.dm)
            s = tm.step(s, p, f, first_step=nt <= 1)
        return fields(s)

    whole = run(np.arange(NCOL_M))
    keep = np.array([0, 3])
    alone = run(keep)
    assert abs(float(whole["reset_flag"][0])) == 999.0   # the trap fired
    for name, a in alone.items():
        np.testing.assert_array_equal(a, whole[name][keep], err_msg=name)
