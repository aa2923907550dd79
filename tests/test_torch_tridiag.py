"""The reference step's modules: mckpp_torch's batched ``ops/tridiag.py``
(tridcof, tridrhs, the Thomas and PCR solves, rhsmod over every mode),
``ops/ocnint.py`` over its feature flags and both solvers, the resident
wscale table (``build_tables``, ``wscale_table``) and ``vmix`` with the
table, against mckpp_tpu's per-column functions under ``jax.vmap``, in
float64 on the CPU with the same numpy inputs.

Tolerance rtol 1e-12, scale-aware as in tests/test_torch_vmix.py: each
field's absolute tolerance is rtol times its largest magnitude.  The two
packages evaluate the same expressions in the same order; they differ in
the order of a few sums (rhsmod's layer sums, the bands' cumulative
depth) and in libm by an ulp.  ``build_tables`` is equal bit for bit, and
so is the port's PCR solve to the fused pass's ``_pcr_solve`` (same
association order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mckpp_tpu.grid import make_vertical_grid as jgrid
from mckpp_tpu.ops import ocnint as jocnint
from mckpp_tpu.ops import tridiag as jtri
from mckpp_tpu.ops import vmix as jvmix
from mckpp_tpu.ops import wscale as jwscale

from mckpp_torch.grid import make_vertical_grid as tgrid
from mckpp_torch.ops import fused_pass as fp
from mckpp_torch.ops import ocnint as tocnint
from mckpp_torch.ops import tridiag as ttri
from mckpp_torch.ops import vmix as tvmix
from mckpp_torch.ops import wscale as twscale

from test_torch_vmix import FLAG_SETS, column_inputs
from test_torch_vmix import close as close_vmix

NCOL, NZ = 5, 14
DMAX, DTO = 200.0, 1800.0          # levels below 100 m for rhsmod mode 4
RTOL = 1e-12


def close(port, ref, msg=""):
    """rtol 1e-12 with an absolute floor of rtol times the field's scale."""
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale + 1e-300,
                               err_msg=msg)


def t(a):
    a = np.asarray(a)
    return torch.tensor(a if a.dtype.kind in "iub" else a.astype(np.float64))


@pytest.fixture(scope="module")
def grids():
    return jgrid(NZ, DMAX, DTO), tgrid(NZ, DMAX, DTO)


def diffusivities(rng, n=NCOL):
    """Interface diffusivities spanning interior to boundary-layer values."""
    d = 10.0 ** rng.uniform(-5.0, -1.0, (n, NZ + 2))
    d[:, 0] = 0.0
    return d


def test_tridcof_matches(grids):
    jg, tg = grids
    diff = diffusivities(np.random.default_rng(1))
    ref = jax.vmap(lambda d: jtri.tridcof(d, jg.tri_dn, jg.tri_up, NZ))(
        jnp.asarray(diff))
    got = ttri.tridcof(t(diff), tg.tri_dn, tg.tri_up, NZ)
    for name, a, b in zip(("cu", "cc", "cl"), got, ref):
        close(a, b, name)


def scalar_inputs(rng):
    return dict(yo=20.0 + rng.standard_normal((NCOL, NZ + 1)),
                ntflux=1e-5 * rng.standard_normal((NCOL, NZ + 1)),
                diff=diffusivities(rng),
                ghat=np.concatenate([np.zeros((NCOL, 1)), 10.0 ** rng.uniform(
                    -1, 2, (NCOL, NZ))], axis=1),
                sturflux=1e-5 * rng.standard_normal(NCOL),
                ghatflux=1e-5 * rng.standard_normal(NCOL))


def test_tridrhs_matches(grids):
    jg, tg = grids
    inp = scalar_inputs(np.random.default_rng(2))
    keys = ("yo", "ntflux", "diff", "ghat", "sturflux", "ghatflux")

    def jf(yo, nt, d, g, s, gf):
        return jtri.tridrhs(jg.hm, yo, nt, d, g, s, gf, DTO, jg.tri_dn, NZ)
    ref = jax.vmap(jf)(*(jnp.asarray(inp[k]) for k in keys))
    yo, nt, d, g, s, gf = (t(inp[k]) for k in keys)
    got = ttri.tridrhs(tg.hm, yo, nt, d, g, s, gf, DTO, tg.tri_dn, NZ)
    close(got, ref)


def system(grids, seed):
    """A batch of the implicit systems tridcof/tridrhs assemble."""
    _, tg = grids
    inp = scalar_inputs(np.random.default_rng(seed))
    cu, cc, cl = ttri.tridcof(t(inp["diff"]), tg.tri_dn, tg.tri_up, NZ)
    rhs = ttri.tridrhs(tg.hm, t(inp["yo"]), t(inp["ntflux"]), t(inp["diff"]),
                       t(inp["ghat"]), t(inp["sturflux"]),
                       t(inp["ghatflux"]), DTO, tg.tri_dn, NZ)
    return cu, cc, cl, rhs, t(inp["yo"])


@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_solve_matches(grids, solver):
    cu, cc, cl, rhs, yo = system(grids, 3)
    jfn = jtri.tridmat if solver == "thomas" else jtri.tridmat_pcr
    ref = jax.vmap(jfn)(*(jnp.asarray(a.numpy())
                          for a in (cu, cc, cl, rhs, yo)))
    got = tocnint.SOLVERS[solver](cu, cc, cl, rhs, yo)
    close(got, ref)
    # the solution solves the system; the bottom layer is held
    y = got[:, :NZ]
    lhs = cc * y
    lhs[:, 1:] += cu[:, 1:] * y[:, :-1]
    lhs[:, :-1] += cl[:, :-1] * y[:, 1:]
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-12)
    assert torch.equal(got[:, NZ], yo[:, NZ])


def test_pcr_equals_fused_pcr(grids):
    """The batched PCR solve and the fused pass's (in its (WZ, ncol)
    layout, padding rows included) agree bit for bit."""
    cu, cc, cl, rhs, yo = system(grids, 4)
    wz = NZ + 2
    pad = lambda a: torch.nn.functional.pad(a, (0, wz - NZ)).T.contiguous()
    row = torch.arange(wz)[:, None]
    fused = fp._pcr_solve(pad(cu), pad(cc), pad(cl), pad(rhs), NZ, row)
    got = ttri.tridmat_pcr(cu, cc, cl, rhs, yo)
    assert torch.equal(got[:, :NZ], fused[:NZ].T)


@pytest.fixture(scope="module")
def rhsmod_fns(grids):
    """One jitted, vmapped JAX rhsmod per scalar."""
    jg, _ = grids

    def make(jsclr):
        def f(mode, a_mag, km, dm_km, rhs, rho, cp):
            return jtri.rhsmod(jsclr, mode, a_mag, DTO, km, dm_km, rhs, rho,
                               cp, jg.hm, jg.zm, NZ)
        return jax.jit(jax.vmap(f))
    return {1: make(1), 2: make(2)}


def rhsmod_case(grids, mode, km, seed):
    _, tg = grids
    rng = np.random.default_rng(seed)
    mode = np.broadcast_to(np.asarray(mode, np.int32), (NCOL,)).copy()
    km = np.broadcast_to(np.asarray(km, np.int32), (NCOL,)).copy()
    dm = tg.dm.numpy()
    return dict(mode=mode, a_mag=1e-6 * rng.standard_normal(NCOL), km=km,
                dm_km=dm[km], rhs=rng.standard_normal((NCOL, NZ)),
                rho=1025.0 + rng.standard_normal((NCOL, NZ + 1)),
                cp=3990.0 + rng.standard_normal((NCOL, NZ + 1)))


def check_rhsmod(grids, fns, jsclr, case):
    _, tg = grids
    keys = ("mode", "a_mag", "km", "dm_km", "rhs", "rho", "cp")
    ref = fns[jsclr](*(jnp.asarray(case[k]) for k in keys))
    mode, a_mag, km, dm_km, rhs, rho, cp = (t(case[k]) for k in keys)
    got = ttri.rhsmod(jsclr, mode, a_mag, DTO, km, dm_km, rhs, rho, cp,
                      tg.hm, tg.zm, NZ)
    close(got, ref)
    return got, rhs


@pytest.mark.parametrize("km", [2, 5, 13])
@pytest.mark.parametrize("jsclr", [1, 2])
@pytest.mark.parametrize("mode", range(8))
def test_rhsmod_matches(grids, rhsmod_fns, mode, jsclr, km):
    got, rhs = check_rhsmod(grids, rhsmod_fns, jsclr,
                            rhsmod_case(grids, mode, km, seed=10 + mode))
    changed = bool((got != rhs).any())
    assert changed == (mode > 0), "mode 0 is a no-op; the others act"


def test_rhsmod_mixed_columns(grids, rhsmod_fns):
    """Per-column modes and mixed-layer levels in one batch, out-of-range
    modes clipped."""
    case = rhsmod_case(grids, [9, 6, 7, 2, -1], [3, 7, 12, 4, 2], seed=30)
    for jsclr in (1, 2):
        check_rhsmod(grids, rhsmod_fns, jsclr, case)


# ---------------------------------------------------------------------------
# ocnint
# ---------------------------------------------------------------------------

OCNINT_FLAGS = {
    "plain": {},
    "relax_sst": dict(l_relax_sst=True),
    "relax_sst_calconly": dict(l_relax_sst=True, l_relax_calconly=True),
    "fcorr": dict(l_fcorr=True),
    "withz": dict(l_fcorr_withz=True, l_sfcorr_withz=True),
    "relax_3d": dict(l_relax_ocnt=True, l_relax_sal=True),
    "advect": dict(l_advect=True),
}

OCNINT_ARGS = ("u", "x", "uo", "xo", "f", "kmixe", "difm", "difs", "dift",
               "ghat", "wxnt", "wu0", "wx0", "rho", "cp", "sst0",
               "fcorr_twod", "fcorr_withz", "sfcorr_withz", "ocnt_clim",
               "sal_clim", "relax_sst", "relax_ocnt", "relax_sal",
               "fcorr_prev", "nmodeadv", "modeadv", "advection")


def ocnint_inputs(seed):
    rng = np.random.default_rng(seed)
    n1 = NZ + 1
    prof = lambda base, sc: base + sc * rng.standard_normal((NCOL, n1))
    xo = np.stack([prof(20.0, 1.0), prof(0.1, 0.05)], axis=-1)
    uo = 0.05 * rng.standard_normal((NCOL, n1, 2))
    nm = np.zeros((NCOL, 2), np.int32)
    md = np.zeros((NCOL, 6, 2), np.int32)
    mg = np.zeros((NCOL, 6, 2))
    nm[:, 1] = [0, 1, 2, 3, 6]
    md[:, :, 1] = (np.arange(NCOL)[:, None] + np.arange(6)[None, :]) % 8
    mg[:, :, 1] = 1e-6 * rng.standard_normal((NCOL, 6))
    nm[:, 0], md[:, 0, 0], mg[:, 0, 0] = 1, 3, 50.0      # ignored
    ghat = 10.0 ** rng.uniform(-1, 2, (NCOL, NZ + 1))
    ghat[:, 0] = 0.0
    return dict(
        u=uo + 0.01 * rng.standard_normal(uo.shape),
        x=xo + 0.01 * rng.standard_normal(xo.shape), uo=uo, xo=xo,
        f=1e-4 * rng.standard_normal(NCOL),
        kmixe=rng.integers(2, NZ + 1, NCOL).astype(np.int32),
        difm=diffusivities(rng), difs=diffusivities(rng),
        dift=diffusivities(rng), ghat=ghat,
        wxnt=1e-5 * rng.standard_normal((NCOL, NZ + 1, 2)),
        wu0=1e-4 * rng.standard_normal((NCOL, 2)),
        wx0=1e-5 * rng.standard_normal((NCOL, 3)),
        rho=prof(1025.0, 1.0), cp=prof(3990.0, 5.0),
        sst0=20.0 + rng.standard_normal(NCOL),
        fcorr_twod=10.0 * rng.standard_normal(NCOL),
        fcorr_withz=prof(0.0, 1e-3), sfcorr_withz=prof(0.0, 1e-8),
        ocnt_clim=prof(19.0, 1.0), sal_clim=prof(0.05, 0.02),
        relax_sst=np.array([0.0, 1e-12, 1 / 86400.0, 1 / 5e5, 1 / 1e6]),
        relax_ocnt=np.full(NCOL, 1 / 3e5), relax_sal=np.full(NCOL, 1 / 4e5),
        fcorr_prev=rng.standard_normal(NCOL),
        nmodeadv=nm, modeadv=md, advection=mg)


@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("flags", sorted(OCNINT_FLAGS))
def test_ocnint_matches(grids, flags, solver):
    jg, tg = grids
    inp = ocnint_inputs(seed=40)
    kw = dict(OCNINT_FLAGS[flags], solver=solver)
    ref = jax.jit(jax.vmap(lambda *a: jocnint.ocnint(*a, jg, DTO, **kw)))(
        *(jnp.asarray(inp[k]) for k in OCNINT_ARGS))
    got = tocnint.ocnint(*(t(inp[k]) for k in OCNINT_ARGS), tg, DTO, **kw)
    for name in tocnint.OcnintResult._fields:
        close(getattr(got, name), getattr(ref, name), name)
    plain = tocnint.ocnint(*(t(inp[k]) for k in OCNINT_ARGS), tg, DTO,
                           solver=solver)
    if flags != "plain":                     # the flags act
        assert any(not torch.equal(getattr(got, n), getattr(plain, n))
                   for n in tocnint.OcnintResult._fields), flags


# ---------------------------------------------------------------------------
# the resident wscale table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_tables_bitwise(dtype):
    jwmt, jwst = jwscale.build_tables(dtype)
    wmt, wst = twscale.build_tables(dtype)
    assert wmt.shape == wst.shape == (892, 50)
    assert wmt.dtype == (torch.float64 if dtype == np.float64
                         else torch.float32)
    np.testing.assert_array_equal(wmt.numpy(), np.asarray(jwmt))
    np.testing.assert_array_equal(wst.numpy(), np.asarray(jwst))


def test_wscale_table_matches():
    """Stable, unstable and convective queries, inside the table and
    beyond both edges (linear extrapolation, the analytic branch above
    zmax), with the arguments broadcast as blmix passes them."""
    rng = np.random.default_rng(50)
    n = 400
    sigma = rng.uniform(0.0, 1.0, (n, 1))
    hbl = rng.uniform(1.0, 300.0, (n, 1))
    ustar = np.concatenate([rng.uniform(0.0, 0.05, n - 2), [0.0, 0.06]])
    bfsfc = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-10, -6, n)
    sigma_row = np.linspace(0.0, 1.0, 7)[None, :]
    jwmt, jwst = jwscale.build_tables(np.float64)
    wmt, wst = twscale.build_tables()
    ref = jwscale.wscale(jnp.asarray(sigma * sigma_row), jnp.asarray(hbl),
                         jnp.asarray(ustar[:, None]),
                         jnp.asarray(bfsfc[:, None]), jwmt, jwst)
    got = twscale.wscale_table(t(sigma * sigma_row), t(hbl),
                               t(ustar[:, None]), t(bfsfc[:, None]), wmt, wst)
    close(got[0], ref[0], "wm")
    close(got[1], ref[1], "ws")
    # the table interpolates what the nodal form reconstructs on the fly
    nod = twscale.wscale_nodal(t(sigma * sigma_row), t(hbl),
                               t(ustar[:, None]), t(bfsfc[:, None]))
    np.testing.assert_allclose(got[0].numpy(), nod[0].numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.fixture(scope="module")
def vmix_grids():
    """The grid of tests/test_torch_vmix.py, whose inputs these reuse."""
    from test_torch_vmix import DMAX as VDMAX, DTO as VDTO, NZ as VNZ
    return jgrid(VNZ, VDMAX, VDTO), tgrid(VNZ, VDMAX, VDTO)


VMIX_ARGS = ("u", "x", "sflux", "ssurf", "sref", "jerlov", "f", "ocdepth")


@pytest.mark.parametrize("l_initflag", [True, False])
@pytest.mark.parametrize("flags", ["default", "ldd", "lri_off"])
def test_vmix_table_matches(vmix_grids, flags, l_initflag):
    """vmix with wscale_mode="table" against the JAX vmix given the same
    tables (the inputs of tests/test_torch_vmix.py)."""
    from mckpp_tpu.ops.swfrac import swdk as jswdk
    from mckpp_tpu.ops.swfrac import swfrac_levels as jswfrac_levels
    jg, tg = vmix_grids
    inp = column_inputs(np.asarray(jg.zm), seed=7)
    swdk_c = np.asarray(jax.vmap(lambda j: jswdk(-jg.dm, j))(inp["jerlov"]))
    swf = np.asarray(jax.vmap(lambda j: jswfrac_levels(1.0, jg.zm, j))(
        inp["jerlov"]))
    wxnt = 1e-6 * np.ones(swdk_c.shape + (2,))
    jwmt, jwst = jwscale.build_tables(np.float64)
    fl = FLAG_SETS[flags]

    def per_col(u, x, sflux, ssurf, sref, jerlov, f, ocd, swdk_, swf_, wx_):
        return jvmix.vmix(u, x, sflux, ssurf, sref, jerlov, f, ocd,
                          jnp.asarray(l_initflag), swdk_, swf_, wx_,
                          jnp.asarray(False), jg, jwmt, jwst, **fl)
    args = [inp[k] for k in VMIX_ARGS] + [swdk_c, swf, wxnt]
    ref = jax.vmap(per_col)(*map(jnp.asarray, args))
    ta = [t(a) for a in args]
    got = tvmix.vmix(*ta[:8], l_initflag, ta[8], ta[9], ta[10], False, tg,
                     wscale_mode="table", tables=twscale.build_tables(),
                     **fl)
    for name in jvmix.VmixResult._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if name == "kbl":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close_vmix(a, b, name)


@pytest.mark.parametrize("mode,tables", [("table", False), ("nodal", True),
                                         ("lookup", False)])
def test_vmix_wscale_arguments_checked(vmix_grids, mode, tables):
    """The tables go with "table" and only with it; no other mode."""
    _, tg = vmix_grids
    inp = column_inputs(tg.zm.numpy())
    with pytest.raises(ValueError):
        tvmix.vmix(*(t(inp[k]) for k in VMIX_ARGS), True, None, None, None,
                   True, tg, wscale_mode=mode,
                   tables=twscale.build_tables() if tables else None)
