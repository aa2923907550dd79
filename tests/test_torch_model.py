"""The ocean step at model level: mckpp_torch's ``KppModel`` against
mckpp_tpu's, in float64 on the CPU.

A 4-step trajectory from the same warm start with the flux update on the
ndtocn cadence: port ``KppModel(cfg, device="cpu")`` with pass_impl
"eager_step" against JAX ``KppModel`` with "fused_xla_step", wscale
pinned, held by the field scales of tests/test_fused_parity.py at rtol
1e-9 with kmix/old/new equal.  One configuration covers the instability
trap (hurricane stress on column 0), an inactive land column and current
damping at once, because the JAX model's compile dominates the cost.
Then properties of the port alone: land pass-through, the lazy
(with_diags=False) prognostics, per-pass loops == whole-step body,
float32 purity, the numpy round trip and the options that raise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mckpp_tpu as J
from mckpp_tpu import forcing as jforcing
from mckpp_tpu.grid import coriolis as jcoriolis
from mckpp_tpu.state import init_params as jinit_params

import mckpp_torch as T
from mckpp_torch import convert
from mckpp_torch import forcing as tforcing
from mckpp_torch.grid import coriolis as tcoriolis

NCOL, NZ = 5, 12
LAT = np.array([5.0, 25.0, 45.0, -15.0, 60.0])
DMAX, DTO = 120.0, 1200.0

# typical magnitude of fields whose values sit far below O(1): the absolute
# tolerance is rtol * scale (copied from tests/test_fused_parity.py)
FIELD_SCALE = {"difm": 1e-2, "difs": 1e-2, "dift": 1e-2, "ghat": 1e2,
               "wu": 1e-3, "wx": 1e-3, "wxnt": 1e-3, "tinc_fcorr": 1e-2,
               "sinc_fcorr": 1e-3, "scorr": 1e-6}


def fields(obj):
    if isinstance(obj, (T.State, T.ColumnParams, T.Forcing)):
        return convert.to_numpy(obj)
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def assert_states_close(sa, sb, rtol, atol=1e-12):
    """sa, sb: port or JAX states (the checker of test_fused_parity.py)."""
    a_, b_ = fields(sa), fields(sb)
    for name in ("u", "x", "us", "xs", "hmix", "rho", "cp", "difm", "difs",
                 "dift", "ghat", "wu", "wx", "wxnt", "swdk_opt", "hmixd",
                 "tinc_fcorr", "sinc_fcorr", "scorr", "fcorr", "ssurf",
                 "reset_flag", "dampu_flag", "dampv_flag"):
        atol_f = max(atol, rtol * FIELD_SCALE.get(name, 0.0))
        np.testing.assert_allclose(a_[name], b_[name], rtol=rtol,
                                   atol=atol_f, err_msg=f"field {name}")
    for name in ("kmix", "old", "new"):
        np.testing.assert_array_equal(a_[name], b_[name], err_msg=name)


def configs(pkg, pass_impl, dtype="float64", **forcing_kw):
    return pkg.KppConfig(
        domain=pkg.DomainConfig(nx=NCOL, ny=1, nz=NZ, dmax=DMAX),
        time=pkg.TimeConfig(dtsec=2 * DTO, ndtocn=2, startt=0.0, finalt=1.0),
        physics=pkg.PhysicsFlags(pass_impl=pass_impl, wscale_mode="nodal"),
        forcing=pkg.ForcingConfig(**forcing_kw), dtype=dtype)


# trap + land + damping in one configuration; L_NO_ISOTHERM keeps
# check_profile from zeroing the trap's reset flag (as in
# tests/test_fused_parity.py test_fused_instability_trap_and_damping_parity)
TRAP_LAND_DAMP = dict(l_damp_curr=True, dtuvdamp=360, l_no_isotherm=True,
                      isotherm_bottom=4, isotherm_threshold=1e-12,
                      ocnt_file="clim.nc", sal_file="clim.nc")
RUN = np.array([True, True, False, True, True])


def initial_profiles(zm):
    rng = np.random.RandomState(7)
    t0 = 20.0 + 5.0 * np.exp(zm / 40.0) + 0.05 * rng.randn(NCOL, NZ + 1)
    s0 = 35.0 - 0.3 * np.exp(zm / 60.0) + 0.01 * rng.randn(NCOL, NZ + 1)
    u0 = 0.02 * rng.randn(NCOL, NZ + 1, 2)
    return u0, t0, s0


def taux_of(nt):
    return np.array([400.0] + [0.01] * (NCOL - 1))


def jax_start(cfg):
    model = J.KppModel(cfg)
    u0, t0, s0 = initial_profiles(np.asarray(model.grid.zm))
    prm = dataclasses.replace(jinit_params(NCOL, NZ + 1),
                              f=jcoriolis(jnp.asarray(LAT)),
                              run_physics=jnp.asarray(RUN))
    st, prm, frc = model.warm_start(jnp.asarray(u0), jnp.asarray(t0),
                                    jnp.asarray(s0), prm)
    return model, st, prm, frc


def port_start(cfg, dtype=torch.float64):
    model = T.KppModel(cfg, device="cpu")
    u0, t0, s0 = initial_profiles(model.grid.zm.double().numpy())
    prm = convert.params_from_numpy(fields(jinit_params(NCOL, NZ + 1)),
                                    dtype=dtype)
    prm = prm.replace(f=tcoriolis(torch.tensor(LAT, dtype=dtype)),
                      run_physics=torch.tensor(RUN))
    return (model,) + model.warm_start(u0, t0, s0, prm)


def jax_run(model, st, prm, frc, n):
    for nt in range(1, n + 1):
        if (nt - 1) % model.cfg.time.ndtocn == 0:
            raw = jforcing.constant_test_fluxes(NCOL)._replace(
                taux=jnp.asarray(taux_of(nt)))
            st, frc = jforcing.update_fluxes(model.cfg, st, prm, frc, raw,
                                             jnp.asarray(nt <= 1),
                                             model.grid.dm)
        st = model.step(st, prm, frc, first_step=(nt <= 1))
    return st


def port_run(model, st, prm, frc, n, with_diags=True):
    for nt in range(1, n + 1):
        if (nt - 1) % model.cfg.time.ndtocn == 0:
            raw = tforcing.constant_test_fluxes(NCOL, model.dtype)._replace(
                taux=torch.tensor(taux_of(nt), dtype=model.dtype))
            st, frc = tforcing.update_fluxes(model.cfg, st, prm, frc, raw,
                                             nt <= 1, model.grid.dm)
        st = model.step(st, prm, frc, first_step=(nt <= 1),
                        with_diags=with_diags)
    return st


@pytest.fixture(scope="module")
def trajectories():
    jm, jst, jprm, jfrc = jax_start(configs(J, "fused_xla_step",
                                            **TRAP_LAND_DAMP))
    tm, tst, tprm, tfrc = port_start(configs(T, "eager_step",
                                             **TRAP_LAND_DAMP))
    return dict(jax0=jst, port0=tst, jax4=jax_run(jm, jst, jprm, jfrc, 4),
                port4=port_run(tm, tst, tprm, tfrc, 4),
                port_model=(tm, tst, tprm, tfrc))


def test_warm_start_matches_jax(trajectories):
    a, b = fields(trajectories["port0"]), fields(trajectories["jax0"])
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-14,
                                   err_msg=k)


def test_trajectory_matches_jax(trajectories):
    """4 steps with the trap firing on column 0, a land column and current
    damping, against the JAX whole-step body."""
    port, ref = trajectories["port4"], trajectories["jax4"]
    assert abs(float(ref.reset_flag[0])) == 999.0, "trap did not fire"
    assert float(ref.dampu_flag[1]) > 0.0, "damping did not act"
    assert_states_close(port, ref, rtol=1e-9)


def test_land_column_passes_through(trajectories):
    port0, port4 = fields(trajectories["port0"]), fields(trajectories["port4"])
    for k in ("x", "u", "us", "xs", "hmix", "rho", "difm"):
        np.testing.assert_array_equal(port4[k][2], port0[k][2], err_msg=k)
    assert not np.allclose(port4["x"][1], port0["x"][1])


def test_lazy_diags_same_prognostics(trajectories):
    model, st, prm, frc = trajectories["port_model"]
    full = fields(trajectories["port4"])
    lazy = fields(port_run(model, st, prm, frc, 4, with_diags=False))
    for k in ("u", "x", "us", "xs", "hmixd", "hmix", "kmix", "old", "new",
              "reset_flag", "dampu_flag", "dampv_flag"):
        np.testing.assert_array_equal(lazy[k], full[k], err_msg=k)
    # the surface rho/cp the next flux update reads are refreshed too
    np.testing.assert_array_equal(lazy["rho"][:, 0], full["rho"][:, 0])
    np.testing.assert_array_equal(lazy["cp"][:, 0], full["cp"][:, 0])


def test_per_pass_loops_equal_step_body(trajectories):
    model, st, prm, frc = port_start(configs(T, "eager", **TRAP_LAND_DAMP))
    per_pass = port_run(model, st, prm, frc, 4)
    assert_states_close(per_pass, trajectories["port4"], rtol=1e-13,
                        atol=1e-15)


def test_float32_run_stays_float32():
    """The Jerlov-table and RMSD-threshold constants must not promote a
    float32 model's fields to float64 (the twin of test_dtype_purity)."""
    model, st, prm, frc = port_start(configs(T, "eager_step", "float32"),
                                     dtype=torch.float32)
    out = port_run(model, st, prm, frc, 2)
    for name, a in fields(out).items():
        if np.issubdtype(a.dtype, np.floating):
            assert a.dtype == np.float32, name
    assert np.isfinite(fields(out)["x"]).all()


def test_convert_round_trip_is_exact(trajectories):
    st = trajectories["port4"]
    back = convert.state_from_numpy(convert.to_numpy(st))
    for k, a in convert.to_numpy(st).items():
        b = convert.to_numpy(back)[k]
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    prm = trajectories["port_model"][2]
    back = convert.params_from_numpy(convert.to_numpy(prm))
    for k, a in convert.to_numpy(prm).items():
        np.testing.assert_array_equal(a, convert.to_numpy(back)[k], err_msg=k)
    assert convert.to_numpy(back)["run_physics"].dtype == np.bool_
    assert convert.to_numpy(back)["jerlov"].dtype == np.int32


def test_model_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        T.KppModel(configs(T, "auto"))


@pytest.mark.parametrize("physics,exc", [
    ({"pass_impl": "reference"}, NotImplementedError),
    ({"solver": "thomas"}, NotImplementedError),
    ({"wscale_mode": "table"}, NotImplementedError),
    ({"pass_layout": "z_lanes"}, NotImplementedError),
    ({"pass_impl": "fused_xla"}, ValueError),
])
def test_unported_options_raise(physics, exc):
    cfg = configs(T, "eager_step")
    cfg = cfg.replace(physics=dataclasses.replace(cfg.physics, **physics))
    with pytest.raises(exc):
        T.KppModel(cfg, device="cpu")


def test_auto_resolution_on_cpu():
    cfg = configs(T, "auto")
    cfg = cfg.replace(physics=dataclasses.replace(cfg.physics,
                                                  wscale_mode="auto"))
    model = T.KppModel(cfg, device="cpu")
    assert model.pass_impl == "eager_step"
    assert model.cfg.physics.wscale_mode == "nodal"
