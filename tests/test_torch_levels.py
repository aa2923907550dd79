"""The step past 94 levels: single_column's nz = 100, which the CUDA
kernels take with four level slots a lane (``WZ = nz + 2 <= 128``), nz =
190 on a stretched grid, which they take with six (``<= 192``), nz = 300
on a stretched grid, which they take with one column over three warps
(``<= 384``), and nz = 1030, which they take with one column over a
cluster of two blocks (``<= 8192``).

On the CPU the port's plain whole-step body (pass_impl "eager_step") is
held to the JAX package's traced body ("fused_xla_step", which pads any
WZ) in float64: 3 columns at nz = 100 over 200 m on a uniform grid, and
at nz = 190 and 300 on a stretched grid (``dscale`` 5), 2 steps each from
the same warm start, with an inactive land column and the instability
trap firing on column 0, at rtol 1e-9 with the field scales of
tests/test_fused_parity.py and kmix/old/new equal.  The kernels past 94
levels are held to their plain versions on the card by the
``gpu``-marked cases of tests/test_torch_kernels.py (that file imports no
JAX, so it runs where the card is) and by ``chip_smoke.py``'s gate.
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
from mckpp_torch.ops import cuda_kernels as ck

NCOL, NZ, DMAX, DTO = 3, 100, 200.0, 1200.0
LAT = np.array([5.0, 25.0, -40.0])
RUN = np.array([True, False, True])        # column 1 is land
FIELD_SCALE = {"difm": 1e-2, "difs": 1e-2, "dift": 1e-2, "ghat": 1e2,
               "wu": 1e-3, "wx": 1e-3, "wxnt": 1e-3, "tinc_fcorr": 1e-2,
               "sinc_fcorr": 1e-3, "scorr": 1e-6}


def fields(obj):
    if isinstance(obj, (T.State, T.ColumnParams, T.Forcing)):
        return convert.to_numpy(obj)
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


# L_NO_ISOTHERM keeps check_profile from zeroing the trap's reset flag
# (as tests/test_torch_model.py's TRAP_LAND_DAMP)
NO_ISOTHERM = dict(l_no_isotherm=True, isotherm_bottom=4,
                   isotherm_threshold=1e-12, ocnt_file="clim.nc",
                   sal_file="clim.nc")


def configs(pkg, pass_impl, nz=NZ, ncol=NCOL, dtype="float64", dscale=0.0,
            dmax=DMAX):
    """``dscale`` > 0: a stretched vertical grid."""
    return pkg.KppConfig(
        domain=pkg.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=dmax,
                                l_stretchgrid=dscale > 0, dscale=dscale),
        time=pkg.TimeConfig(dtsec=2 * DTO, ndtocn=2, startt=0.0, finalt=1.0),
        physics=pkg.PhysicsFlags(pass_impl=pass_impl, wscale_mode="nodal"),
        forcing=pkg.ForcingConfig(**NO_ISOTHERM), dtype=dtype)


def profiles(zm, ncol=NCOL):
    rng = np.random.RandomState(11)
    nzp1 = zm.shape[0]
    t0 = 20.0 + 8.0 * np.exp(zm / 80.0) + 0.05 * rng.randn(ncol, nzp1)
    s0 = 35.0 - 0.4 * np.exp(zm / 120.0) + 0.01 * rng.randn(ncol, nzp1)
    u0 = 0.02 * rng.randn(ncol, nzp1, 2)
    return u0, t0, s0


def taux(ncol=NCOL):
    return np.array([400.0] + [0.05] * (ncol - 1))   # the trap on column 0


def jax_trajectory(steps, nz=NZ, dscale=0.0, dmax=DMAX):
    model = J.KppModel(configs(J, "fused_xla_step", nz, dscale=dscale,
                               dmax=dmax))
    u0, t0, s0 = profiles(np.asarray(model.grid.zm))
    prm = dataclasses.replace(jinit_params(NCOL, nz + 1),
                              f=jcoriolis(jnp.asarray(LAT)),
                              run_physics=jnp.asarray(RUN))
    st, prm, frc = model.warm_start(jnp.asarray(u0), jnp.asarray(t0),
                                    jnp.asarray(s0), prm)
    for nt in range(1, steps + 1):
        if (nt - 1) % model.cfg.time.ndtocn == 0:
            raw = jforcing.constant_test_fluxes(NCOL)._replace(
                taux=jnp.asarray(taux()))
            st, frc = jforcing.update_fluxes(model.cfg, st, prm, frc, raw,
                                             jnp.asarray(nt <= 1),
                                             model.grid.dm)
        st = model.step(st, prm, frc, first_step=(nt <= 1))
    return st


def port_start(pass_impl, device="cpu", dtype="float64", nz=NZ, ncol=NCOL,
               dscale=0.0, dmax=DMAX):
    model = T.KppModel(configs(T, pass_impl, nz, ncol, dtype, dscale, dmax),
                       device=device)
    dt, dev = model.dtype, model.device
    u0, t0, s0 = profiles(model.grid.zm.double().cpu().numpy(), ncol)
    prm = convert.params_from_numpy(fields(jinit_params(ncol, nz + 1)),
                                    dtype=dt, device=dev)
    lat = np.resize(LAT, ncol)
    prm = prm.replace(f=tcoriolis(torch.tensor(lat, dtype=dt, device=dev)),
                      run_physics=torch.tensor(np.resize(RUN, ncol),
                                               device=dev))
    return (model,) + model.warm_start(u0, t0, s0, prm)


def port_trajectory(model, st, prm, frc, steps):
    ncol = st.u.shape[0]
    for nt in range(1, steps + 1):
        if (nt - 1) % model.cfg.time.ndtocn == 0:
            raw = tforcing.constant_test_fluxes(
                ncol, model.dtype, model.device)._replace(
                    taux=torch.tensor(taux(ncol), dtype=model.dtype,
                                      device=model.device))
            st, frc = tforcing.update_fluxes(model.cfg, st, prm, frc, raw,
                                             nt <= 1, model.grid.dm)
        st = model.step(st, prm, frc, first_step=(nt <= 1))
    return st


FIELDS = ("u", "x", "us", "xs", "hmix", "rho", "cp", "difm", "difs", "dift",
          "ghat", "wu", "wx", "wxnt", "swdk_opt", "hmixd", "reset_flag")


def rounding_spread(model, st, prm, frc, got, steps):
    """Per field, the largest change of the port's own ``steps``-step
    trajectory when its initial T is perturbed by 1e-15 relative (seeded):
    how far two faithful implementations that round differently can part
    after those steps."""
    rng = np.random.default_rng(0)
    x = st.x.clone()
    x[..., 0] *= 1.0 + 1e-15 * torch.as_tensor(
        rng.standard_normal(tuple(x.shape[:2])), dtype=x.dtype)
    hist = x[..., None].expand(*x.shape, 2).clone()
    other = fields(port_trajectory(model, st.replace(x=x, xs=hist), prm,
                                   frc, steps))
    return {n: float(np.abs(got[n] - other[n]).max()) for n in FIELDS}


def hold_to_jax(nz, dscale, calibrate=False, dmax=DMAX):
    """2 steps at ``nz`` levels over ``dmax`` m with land and the trap:
    the port's plain step body against the JAX package's at rtol 1e-9,
    each field with the atol of its FIELD_SCALE; ``calibrate``: or within
    ten times the field's :func:`rounding_spread`, where that is the
    larger."""
    ref = jax_trajectory(2, nz, dscale, dmax)
    model, st, prm, frc = port_start("eager_step", nz=nz, dscale=dscale,
                                     dmax=dmax)
    got = port_trajectory(model, st, prm, frc, 2)
    assert abs(float(ref.reset_flag[0])) == 999.0, "trap did not fire"
    a, b = fields(got), fields(ref)
    assert np.array_equal(a["x"][1], fields(st)["x"][1]), "land changed"
    spread = (rounding_spread(model, st, prm, frc, a, 2) if calibrate
              else dict.fromkeys(FIELDS, 0.0))
    for name in FIELDS:
        atol = max(1e-12, 1e-9 * FIELD_SCALE.get(name, 0.0),
                   10.0 * spread[name])
        np.testing.assert_allclose(a[name], b[name], rtol=1e-9, atol=atol,
                                   err_msg=name)
    for name in ("kmix", "old", "new"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    return spread


def test_eager_step_at_nz100_matches_jax():
    hold_to_jax(NZ, 0.0)


def test_eager_step_at_nz190_stretched_matches_jax():
    """Six level slots' worth of levels on a stretched grid (0.21 m at
    the surface, thickening with depth), where the reference-average
    prefix is widest (float64 past 217 levels on such a grid is where the
    kernels read aref from device memory).  The profiles' seeded noise
    outweighs the stratification there, so the deep interfaces are close
    to neutral and dbloc is a difference of nearly equal buoyancies: the
    few ulp by which XLA's and torch's EOS round apart grow to ~1e-10 of
    u in two steps, as much as the port's own trajectory moves when its
    initial T is perturbed by 1e-15 relative.  So each field is held
    within the larger of the bar and ten times that spread; the spread
    itself stays tiny, which a semantic difference would not."""
    spread = hold_to_jax(190, 5.0, calibrate=True)
    assert max(spread.values()) < 1e-8, spread


def test_eager_step_at_nz300_stretched_matches_jax():
    """Past 254 levels, where the kernels spread a column over several
    warps (three at nz = 300), on the stretched grid of the nz = 190 case
    (0.13 m at the surface, 15.8 m at the bottom): held as that case is,
    within the larger of the bar and ten times the port's own rounding
    spread."""
    spread = hold_to_jax(300, 5.0, calibrate=True)
    assert max(spread.values()) < 1e-8, spread


def test_eager_step_at_nz1030_matches_jax():
    """Past 1022 levels, where the kernels spread a column over a cluster
    of 2 blocks: nz = 1030 on a uniform grid over 500 m (0.49 m levels;
    over 1000 m and deeper the trap no longer fires on column 0), held as
    the nz = 190 and 300 cases are, within the larger of the bar and ten
    times the port's own rounding spread (the few ulp by which XLA's and
    torch's EOS round apart reach ~5e-11 of u here)."""
    spread = hold_to_jax(1030, 0.0, calibrate=True, dmax=500.0)
    assert max(spread.values()) < 1e-8, spread


def test_cpu_model_steps_past_the_kernel_limit():
    """The plain body takes any nz; what limits the kernels is their
    geometry, which only a launch on the card reaches: a CPU model at
    nz = 1030, past one block's 1024 levels (on the card a column over a
    cluster of 2 blocks), steps; launch_geometry takes the cluster there,
    and raises at nz = 8191 naming the kernels' limit of 8192 levels."""
    model, st, prm, frc = port_start("cuda_step", nz=1030, ncol=2)
    assert model.pass_impl == "cuda_step"
    out = port_trajectory(model, st, prm, frc, 1)
    assert torch.isfinite(out.x).all()
    g = ck.launch_geometry(1030, torch.float64, 2)
    assert (g.lib, g.cb, g.cw, g.blocks) == (ck.CL, 2, 5, 4)
    with pytest.raises(ValueError, match="8192 levels"):
        ck.launch_geometry(8191, torch.float64, 2)
