"""The initial mixing pass: mckpp_torch's batched rimix/z121, ddmix,
bldepth, blmix/enhance and vmix against mckpp_tpu's per-column functions
under ``jax.vmap``, and ``KppModel.initial_state`` against the JAX
model's, in float64 on the CPU with the same numpy inputs.

Tolerance rtol 1e-12, scale-aware: each field's absolute tolerance is
rtol times its largest magnitude, since diffusivities and fluxes sit far
below O(1).  The two packages evaluate the same expressions; they differ
in the order of a few sums (the Rib scan, the reference-average prefix
sums) and in libm by an ulp.  Integer outputs (kbl, kmix, old, new) are
equal.  The JAX functions take no "analytic" velocity scale, so those
cases patch the JAX modules' ``wscale`` with its own ``wscale_analytic``
for the call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mckpp_tpu as J
from mckpp_tpu.grid import make_vertical_grid as jgrid
from mckpp_tpu.ops import bldepth as jbldepth
from mckpp_tpu.ops import blmix as jblmix
from mckpp_tpu.ops import ddmix as jddmix
from mckpp_tpu.ops import rimix as jrimix
from mckpp_tpu.ops import vmix as jvmix
from mckpp_tpu.ops import wscale as jwscale
from mckpp_tpu.ops.swfrac import swdk as jswdk
from mckpp_tpu.ops.swfrac import swfrac_levels as jswfrac_levels
from mckpp_tpu.state import init_params as jinit_params

import mckpp_torch as T
from mckpp_torch import convert
from mckpp_torch.grid import make_vertical_grid as tgrid
from mckpp_torch.ops import bldepth as tbldepth
from mckpp_torch.ops import blmix as tblmix
from mckpp_torch.ops import ddmix as tddmix
from mckpp_torch.ops import rimix as trimix
from mckpp_torch.ops import vmix as tvmix
from mckpp_torch.ops import wscale as twscale
from mckpp_torch.ops.swfrac import swdk as tswdk
from mckpp_torch.ops.swfrac import swfrac_levels as tswfrac_levels

NCOL, NZ = 6, 12
DMAX, DTO = 120.0, 1200.0
RTOL = 1e-12
LAT = np.array([5.0, 25.0, 45.0, -15.0, 60.0, -2.0])


def close(port, ref, msg=""):
    """rtol 1e-12 with an absolute floor of rtol times the field's scale."""
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    b = np.asarray(ref)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale + 1e-300,
                               err_msg=msg)


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def grids():
    return jgrid(NZ, DMAX, DTO), tgrid(NZ, DMAX, DTO)


def column_inputs(zm, seed=3):
    """Profiles and packed fluxes for NCOL columns: heating and cooling,
    calm and windy, shallow and deep ocean, all five water types."""
    rng = np.random.default_rng(seed)
    nzp1 = NZ + 1
    t = 20.0 + 5.0 * np.exp(zm / 40.0) + 0.05 * rng.standard_normal((NCOL, nzp1))
    s = 35.0 - 0.3 * np.exp(zm / 60.0) + 0.01 * rng.standard_normal((NCOL, nzp1))
    # a fresh, cold surface layer on column 4 (diffusive convection) and
    # warm salty water over cold fresh water on column 5 (salt fingering)
    t[4, :3] -= 2.0
    s[4, :3] -= 0.5
    t[5, :4] += 1.0
    s[5, :4] += 0.4
    u = 0.05 * rng.standard_normal((NCOL, nzp1, 2))
    sref = 0.5 * (s[:, 0] + s[:, -1])
    x = np.stack([t, s - sref[:, None]], axis=-1)
    sflux = np.zeros((NCOL, 6))
    sflux[:, 0] = [0.01, 0.2, 0.05, 1.0, 0.1, 1e-10]
    sflux[:, 1] = [0.0, 0.05, -0.02, 0.3, 0.0, 0.0]
    sflux[:, 2] = [300.0, 0.0, 150.0, 500.0, 50.0, 0.0]
    sflux[:, 3] = [-300.0, 100.0, -50.0, -800.0, 20.0, -10.0]
    sflux[:, 4] = 1e-20
    sflux[:, 5] = [5e-5, 0.0, -2e-5, 1e-4, 0.0, 3e-5]
    jerlov = np.array([0, 1, 2, 3, 4, 2], np.int32)
    ocdepth = np.array([-1000.0, -40.0, -1000.0, -90.0, -1000.0, -15.0])
    f = 2 * 7.292e-5 * np.sin(np.deg2rad(LAT))
    return dict(u=u, x=x, sflux=sflux, ssurf=s[:, 0].copy(), sref=sref,
                jerlov=jerlov, f=f, ocdepth=ocdepth)


def patched_analytic(monkeypatch):
    """Point the JAX modules' velocity scale at its analytic form."""
    def ws(sigma, hbl, ustar, bfsfc, wmt, wst, *, vonk=jwscale.c.VONK):
        return jwscale.wscale_analytic(sigma, hbl, ustar, bfsfc, vonk=vonk)
    monkeypatch.setattr(jbldepth, "wscale", ws)
    monkeypatch.setattr(jblmix, "wscale", ws)


def port_ws(mode):
    return {"nodal": twscale.wscale_nodal,
            "analytic": twscale.wscale_analytic}[mode]


def test_z121_and_rimix_match(grids):
    jg, tg = grids
    rng = np.random.default_rng(11)
    dbloc = np.zeros((NCOL, NZ + 1))
    shsq = np.zeros((NCOL, NZ + 1))
    dbloc[:, 1:] = 2e-4 * rng.standard_normal((NCOL, NZ))   # both signs
    shsq[:, 1:] = 1e-4 * rng.random((NCOL, NZ)) ** 3
    shsq[0, 3] = 0.0                                        # Ri -> huge
    ref = jax.vmap(jrimix.rimix, in_axes=(0, 0, None))(
        jnp.asarray(dbloc), jnp.asarray(shsq), jg.zm)
    got = trimix.rimix(t64(dbloc), t64(shsq), tg.zm)
    for name, a, b in zip(("difm", "difs", "dift", "rig"), got, ref):
        close(a, b, name)
    v = rng.standard_normal((NCOL, NZ + 2))
    close(trimix.z121(t64(v), -0.5, 0.8),
          jax.vmap(lambda r: jrimix.z121(r, -0.5, 0.8))(jnp.asarray(v)),
          "z121")


def test_ddmix_matches():
    rng = np.random.default_rng(12)
    adt = np.zeros((NCOL, NZ + 1))
    bds = np.zeros((NCOL, NZ + 1))
    adt[:, 1:] = 1e-4 * rng.standard_normal((NCOL, NZ))
    bds[:, 1:] = 1e-4 * rng.standard_normal((NCOL, NZ))
    # both regimes present: fingering (adt > bds > 0) and convection
    adt[0, 1:4], bds[0, 1:4] = [3e-4, 2e-4, 1.2e-4], [1e-4, 1.5e-4, 1e-4]
    adt[1, 1:4], bds[1, 1:4] = [-3e-4, -1e-4, -4e-4], [-1e-4, -0.8e-4, -1e-4]
    difs = 1e-5 + 1e-4 * rng.random((NCOL, NZ + 2))
    dift = 1e-5 + 1e-4 * rng.random((NCOL, NZ + 2))
    ref = jax.vmap(jddmix.ddmix)(*map(jnp.asarray, (adt, bds, difs, dift)))
    got = tddmix.ddmix(*map(t64, (adt, bds, difs, dift)))
    close(got[0], ref[0], "difs")
    close(got[1], ref[1], "dift")
    assert not np.allclose(got[1].numpy(), dift)            # non-vacuous


def _vmix_pair(grids, flags, mode, first_step=True, l_initflag=True,
               update_wxnt=True, seed=3):
    jg, tg = grids
    inp = column_inputs(np.asarray(jg.zm), seed)
    swdk_c = np.asarray(jax.vmap(lambda j: jswdk(-jg.dm, j))(inp["jerlov"]))
    swf = np.asarray(jax.vmap(lambda j: jswfrac_levels(1.0, jg.zm, j))(
        inp["jerlov"]))
    wxnt = 1e-6 * np.ones((NCOL, NZ + 1, 2))

    def per_col(u, x, sflux, ssurf, sref, jerlov, f, ocd, swdk_, swf_, wx_):
        return jvmix.vmix(u, x, sflux, ssurf, sref, jerlov, f, ocd,
                          jnp.asarray(l_initflag), swdk_, swf_, wx_,
                          jnp.asarray(first_step), jg, None, None,
                          update_wxnt=update_wxnt, **flags)
    args = [inp[k] for k in ("u", "x", "sflux", "ssurf", "sref", "jerlov",
                             "f", "ocdepth")] + [swdk_c, swf, wxnt]
    ref = jax.vmap(per_col)(*map(jnp.asarray, args))
    targs = [t64(a) if a.dtype != np.int32 else torch.tensor(a)
             for a in args]
    got = tvmix.vmix(*targs[:8], l_initflag, targs[8], targs[9], targs[10],
                     first_step, tg, update_wxnt=update_wxnt,
                     wscale_mode=mode, **flags)
    return got, ref


FLAG_SETS = {"default": dict(lri=True, ldd=False, lkpp=True),
             "ldd": dict(lri=True, ldd=True, lkpp=True),
             "lri_off": dict(lri=False, ldd=False, lkpp=True),
             "lkpp_off": dict(lri=True, ldd=True, lkpp=False)}


@pytest.mark.parametrize("mode", ["nodal", "analytic"])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_vmix_matches(grids, flags, mode, monkeypatch):
    if mode == "analytic":
        patched_analytic(monkeypatch)
    got, ref = _vmix_pair(grids, FLAG_SETS[flags], mode)
    for name in jvmix.VmixResult._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if name == "kbl":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close(a, b, name)


@pytest.mark.parametrize("l_initflag", [True, False])
def test_bldepth_blmix_enhance_match(grids, l_initflag):
    """bldepth on vmix's own inputs (a wide spread of forcing), with the
    init flag on and off, then blmix + enhance on its outputs."""
    jg, tg = grids
    inp = column_inputs(np.asarray(jg.zm), seed=5)
    got, _ = _vmix_pair(grids, FLAG_SETS["default"], "nodal", seed=5)
    rng = np.random.default_rng(21)
    nz = NZ
    dvsq = 1e-4 * rng.random((NCOL, nz))
    ritop = (-0.9 * np.asarray(jg.zm)[:nz]) * 2e-4 * (
        1.0 - np.exp(np.asarray(jg.zm)[:nz] / 30.0)) * rng.random((NCOL, 1))
    ritop[1] *= -1.0                                    # convective column
    dbloc = np.asarray(got.dbloc)
    ustar = np.asarray(got.ustar)
    bo = np.array([-3e-7, 2e-7, 1e-8, -1e-6, 4e-7, 0.0])
    bosol = np.array([1e-7, 0.0, 5e-8, 2e-7, 1e-8, 0.0])
    swf = np.asarray(jax.vmap(lambda j: jswfrac_levels(1.0, jg.zm, j))(
        inp["jerlov"]))

    def jbl(dv, ri, db, us, b0, bs, sw, je, f, ocd):
        return jbldepth.bldepth(dv, ri, db, us, b0, bs, sw, je, f, ocd,
                                jnp.asarray(l_initflag), jg.zm, jg.hm,
                                None, None)
    args = (dvsq, ritop, dbloc, ustar, bo, bosol, swf, inp["jerlov"],
            inp["f"], inp["ocdepth"])
    ref = jax.vmap(jbl)(*map(jnp.asarray, args))
    targs = [t64(a) if a.dtype != np.int32 else torch.tensor(a)
             for a in args]
    res = tbldepth.bldepth(*targs, l_initflag, tg.zm, tg.hm,
                           wscale=twscale.wscale_nodal)
    for name, a, b in zip(("hbl", "bfsfc", "stable", "case_a"), res[:4],
                          ref[:4]):
        close(a, b, name)
    np.testing.assert_array_equal(res[4].numpy(), np.asarray(ref[4]))

    # blmix + enhance on those outputs and rimix diffusivities
    difm, difs, dift = (getattr(got, k) for k in ("difm", "difs", "dift"))
    hbl, bfsfc, stable, case_a, kbl = res
    bl = tblmix.blmix(difm, difs, dift, got.ustar, bfsfc, hbl, stable,
                      case_a, kbl, tg.zm, tg.hm, wscale=twscale.wscale_nodal)
    en = tblmix.enhance(difm, difs, dift, bl[2], hbl, kbl, case_a, bl[0],
                        bl[1], tg.zm)

    def jbm(dm_, ds_, dt_, us, bf, hb, stb, ca, kb):
        blmc, ghat, dkm1 = jblmix.blmix(dm_, ds_, dt_, us, bf, hb, stb, ca,
                                        kb, jg.zm, jg.hm, None, None)
        blmc2, ghat2 = jblmix.enhance(dm_, ds_, dt_, dkm1, hb, kb, ca, blmc,
                                      ghat, jg.zm)
        return blmc, ghat, dkm1, blmc2, ghat2
    jref = jax.vmap(jbm)(*[jnp.asarray(a.numpy()) for a in (
        difm, difs, dift, got.ustar, bfsfc, hbl, stable, case_a, kbl)])
    for name, a, b in zip(("blmc", "ghat", "dkm1", "blmc_enh", "ghat_enh"),
                          bl + en, jref):
        close(a, b, name)


# ---------------------------------------------------------------------------
# KppModel.initial_state
# ---------------------------------------------------------------------------

RUN = np.array([True, True, False, True, True, True])   # column 2: land


def _cfg(pkg, dtype="float64", **physics):
    return pkg.KppConfig(
        domain=pkg.DomainConfig(nx=NCOL, ny=1, nz=NZ, dmax=DMAX),
        time=pkg.TimeConfig(dtsec=2 * DTO, ndtocn=2, startt=0.0, finalt=1.0),
        physics=pkg.PhysicsFlags(wscale_mode="nodal", **physics),
        dtype=dtype)


def _profiles(zm):
    inp = column_inputs(zm, seed=9)
    t0 = inp["x"][..., 0]
    s0 = inp["x"][..., 1] + inp["sref"][:, None]
    return inp["u"], t0, s0, inp


@pytest.mark.parametrize("physics", [{}, {"ldd": True, "l_ssref": False}],
                         ids=["default", "ldd_no_ssref"])
def test_initial_state_matches_jax(physics):
    jm = J.KppModel(_cfg(J, **physics))
    u0, t0, s0, inp = _profiles(np.asarray(jm.grid.zm))
    jprm = dataclasses.replace(
        jinit_params(NCOL, NZ + 1), f=jnp.asarray(inp["f"]),
        jerlov=jnp.asarray(inp["jerlov"]),
        ocdepth=jnp.asarray(inp["ocdepth"]),
        run_physics=jnp.asarray(RUN), l_ocean=jnp.asarray(RUN))
    jst, jprm2, _ = jm.initial_state(u0, t0, s0, jprm)

    tm = T.KppModel(_cfg(T, **physics), device="cpu")
    tprm = convert.params_from_numpy(
        {f.name: np.asarray(getattr(jprm, f.name))
         for f in dataclasses.fields(jprm)})
    tst, tprm2, _ = tm.initial_state(u0, t0, s0, tprm)
    got = convert.to_numpy(tst)
    for f in dataclasses.fields(jst):
        ref = np.asarray(getattr(jst, f.name))
        if ref.dtype.kind in "iub":
            np.testing.assert_array_equal(got[f.name], ref, err_msg=f.name)
        else:
            close(got[f.name], ref, f.name)
    for name in ("sref", "ssref", "u_init"):
        close(getattr(tprm2, name), getattr(jprm2, name), name)
    # the land column keeps its pre-pass state: no mixing layer, no fluxes
    assert got["hmix"][2] == 0.0 and not np.any(got["difm"][2])
    assert np.all(got["kmix"][RUN] >= 2)


def test_initial_state_float32_stays_float32():
    tm = T.KppModel(_cfg(T, dtype="float32"), device="cpu")
    u0, t0, s0, inp = _profiles(tm.grid.zm.double().numpy())
    prm = T.state.init_params(NCOL, NZ + 1, dtype=torch.float32)
    prm = prm.replace(f=torch.tensor(inp["f"], dtype=torch.float32),
                      jerlov=torch.tensor(inp["jerlov"]))
    st, prm, frc = tm.initial_state(u0, t0, s0, prm)
    for obj in (st, prm, frc):
        for name, a in convert.to_numpy(obj).items():
            if a.dtype.kind == "f":
                assert a.dtype == np.float32, name
    assert st.kmix.dtype == torch.int32 and st.old.dtype == torch.int32
    assert np.isfinite(convert.to_numpy(st)["difm"]).all()
