"""mckpp_torch's pointwise physics, grid and flux packing against
mckpp_tpu's, on the same float64 inputs made with numpy.

The port's functions are batched where the JAX package vmaps a per-column
function (swfrac_levels, swdk), so the JAX side is vmapped here.  The
tolerance is rtol 1e-13: the two packages evaluate the same expressions
in the same order, and only the libm of XLA-CPU and of torch-CPU differ
(exp, pow, sin) by an ulp.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mckpp_tpu import forcing as jforcing
from mckpp_tpu import grid as jgrid
from mckpp_tpu import state as jstate
from mckpp_tpu.config import KppConfig as JKppConfig
from mckpp_tpu.config import ForcingConfig as JForcingConfig
from mckpp_tpu.ops import eos as jeos
from mckpp_tpu.ops import swfrac as jswfrac
from mckpp_tpu.ops import wscale as jwscale

from mckpp_torch import convert
from mckpp_torch import forcing as tforcing
from mckpp_torch import grid as tgrid
from mckpp_torch import state as tstate
from mckpp_torch.config import KppConfig as TKppConfig
from mckpp_torch.config import ForcingConfig as TForcingConfig
from mckpp_torch.ops import eos as teos
from mckpp_torch.ops import swfrac as tswfrac
from mckpp_torch.ops import wscale as twscale

RTOL = 1e-13
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(port, ref, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=msg)


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def jax_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


def eos_inputs(rng, n=400):
    s = rng.uniform(0.0, 40.0, n)
    t = rng.uniform(-3.0, 35.0, n)
    p = rng.uniform(0.0, 5000.0, n)
    p[::7] = 0.0                      # the P=0 branches
    return s, t, p


def test_abk80_cpsw_sig80(rng):
    s, t, p = eos_inputs(rng)
    ref = jeos.abk80(jnp.asarray(s), jnp.asarray(t), jnp.asarray(p))
    got = teos.abk80(t64(s), t64(t), t64(p))
    for name, a, b in zip(("alpha", "beta", "kappa", "sig0", "sig"),
                          got, ref):
        close(a, b, msg=name)
    close(teos.cpsw(t64(s), t64(t), t64(p)),
          jeos.cpsw(jnp.asarray(s), jnp.asarray(t), jnp.asarray(p)))
    for a, b in zip(teos.sig80(t64(s), t64(t), t64(p)),
                    jeos.sig80(jnp.asarray(s), jnp.asarray(t),
                               jnp.asarray(p))):
        close(a, b)


def test_eos_check_values():
    """The reference's published check values (state_equations.F90)."""
    a, b, k, _, _ = teos.abk80(t64([35.0, 40.0]), t64([15.0, 0.0]),
                               t64([0.0, 10000.0]))
    close(a, [2.14136e-4, 2.69822e-4], rtol=1e-5)
    close(b, [7.51638e-4, 6.88317e-4], rtol=1e-5)
    close(k, [4.32576e-5, 3.55271e-5], rtol=1e-5)
    close(teos.cpsw(t64([40.0]), t64([40.0]), t64([10000.0])), [3849.500],
          rtol=1e-6)


@pytest.mark.parametrize("fact", [1.0, 0.7])
def test_swfrac_levels_and_swdk(rng, fact):
    zm = -np.sort(rng.uniform(0.5, 900.0, 30))
    jer = np.array([0, 1, 2, 3, 4, 2, 0], np.int32)
    ref = jax.vmap(lambda j: jswfrac.swfrac_levels(
        fact, jnp.asarray(zm), j))(jnp.asarray(jer))
    got = tswfrac.swfrac_levels(fact, t64(zm), torch.as_tensor(jer))
    close(got, ref)
    dm = np.concatenate([[0.0], -zm[:-1]])
    ref = jax.vmap(lambda j: jswfrac.swdk(-jnp.asarray(dm), j))(
        jnp.asarray(jer))
    close(tswfrac.swdk(-t64(dm), torch.as_tensor(jer)), ref)


def wscale_inputs(rng, n=600):
    """zehat = vonk*sigma*hbl*bfsfc drawn where the model puts it: inside
    the table (WS_ZMIN=-4e-7 .. 0), up to 40 cells below it (zdiff < 0,
    where astype(int32) truncates toward zero, wscale.py:136-140) and
    stable (> 0).  Far below the table the bilinear extrapolation
    amplifies one ulp of libm pow by the cell count, beyond rtol 1e-13."""
    sigma = rng.uniform(0.01, 1.0, n)
    hbl = rng.uniform(1.0, 300.0, n)
    ustar = rng.uniform(0.0, 0.05, n)
    ustar[:10] = 0.0
    zehat = np.concatenate([rng.uniform(-4e-7, 0.0, n // 2),
                            rng.uniform(-4.2e-7, -4e-7, n // 4),
                            rng.uniform(0.0, 1e-6, n - n // 2 - n // 4)])
    bfsfc = zehat / (0.4 * sigma * hbl)
    return sigma, hbl, ustar, bfsfc


@pytest.mark.parametrize("form", ["analytic", "nodal"])
def test_wscale(rng, form):
    sigma, hbl, ustar, bfsfc = wscale_inputs(rng)
    zdiff = 0.4 * sigma * hbl * bfsfc - (-4.0e-7)
    assert (zdiff < 0).any() and (zdiff > 0).any()
    jfn = getattr(jwscale, f"wscale_{form}")
    tfn = getattr(twscale, f"wscale_{form}")
    ref = jfn(*(jnp.asarray(a) for a in (sigma, hbl, ustar, bfsfc)), vonk=0.4)
    got = tfn(*(t64(a) for a in (sigma, hbl, ustar, bfsfc)), vonk=0.4)
    for a, b, name in zip(got, ref, ("wm", "ws")):
        close(a, b, msg=name)


def test_cbrt_and_quartic_root(rng):
    x = rng.normal(0.0, 5.0, 200)
    close(twscale._cbrt(t64(x)), jwscale._cbrt(jnp.asarray(x)))
    y = np.abs(x)
    close(twscale._quartic_root(t64(y)), jwscale._quartic_root(jnp.asarray(y)))


@pytest.mark.parametrize("stretch,dscale", [(False, 0.0), (True, 2.5)])
def test_make_vertical_grid(stretch, dscale):
    ref = jgrid.make_vertical_grid(40, 700.0, 1200.0, stretch=stretch,
                                   dscale=dscale, dtype=jnp.float64)
    got = tgrid.make_vertical_grid(40, 700.0, 1200.0, stretch=stretch,
                                   dscale=dscale, dtype=torch.float64)
    for name in ("zm", "hm", "dm", "tri_dn", "tri_up"):
        close(getattr(got, name), getattr(ref, name), msg=name)
    assert got.nz == ref.nz == 40


def test_vertical_grid_from_arrays():
    z = -np.array([1.0, 3.5, 7.0, 12.0, 20.0])
    h = np.array([2.0, 3.0, 4.0, 6.0, 10.0])
    d = np.cumsum(h)
    ref = jgrid.vertical_grid_from_arrays(z, h, d, 900.0)
    got = tgrid.vertical_grid_from_arrays(z, h, d, 900.0)
    for name in ("zm", "hm", "dm", "tri_dn", "tri_up"):
        close(getattr(got, name), getattr(ref, name), msg=name)


def test_coriolis():
    lat = np.array([-60.0, -2.5, -2.4, -1.0, 0.0, 1.0, 2.4999, 2.5, 30.0])
    close(tgrid.coriolis(t64(lat)), jgrid.coriolis(jnp.asarray(lat)))


def raw_fluxes(rng, ncol):
    vals = dict(taux=rng.normal(0.0, 0.1, ncol), tauy=rng.normal(0.0, 0.1, ncol),
                swf=rng.uniform(0.0, 300.0, ncol),
                lwf=rng.normal(-50.0, 10.0, ncol),
                lhf=rng.normal(-100.0, 20.0, ncol),
                shf=rng.normal(-10.0, 5.0, ncol),
                rain=rng.uniform(0.0, 1e-4, ncol),
                snow=rng.uniform(0.0, 1e-5, ncol))
    vals["taux"][:2] = 0.0                    # calm columns
    vals["tauy"][:2] = 0.0
    return (jforcing.RawFluxes(**{k: jnp.asarray(v) for k, v in vals.items()}),
            tforcing.RawFluxes(**{k: t64(v) for k, v in vals.items()}))


@pytest.mark.parametrize("l_rest", [False, True])
def test_pack_sflux(rng, l_rest):
    ncol = 6
    rj, rt = raw_fluxes(rng, ncol)
    ocean = np.array([True, True, False, True, True, False])
    prev = rng.normal(size=(ncol, 6))
    ref = jforcing.pack_sflux(rj, jnp.asarray(ocean), jnp.asarray(prev), l_rest)
    got = tforcing.pack_sflux(rt, torch.as_tensor(ocean), t64(prev), l_rest)
    close(got, ref)


def flux_state(rng, ncol, nzp1):
    st = jstate.init_state(ncol, nzp1)
    st = dataclasses.replace(
        st, rho=jnp.asarray(1025.0 + rng.normal(size=(ncol, nzp1))),
        cp=jnp.asarray(3990.0 + rng.normal(size=(ncol, nzp1))),
        swdk_opt=jnp.asarray(rng.uniform(size=(ncol, nzp1))),
        wxnt=jnp.asarray(rng.normal(size=(ncol, nzp1, 2))))
    prm = dataclasses.replace(
        jstate.init_params(ncol, nzp1),
        jerlov=jnp.asarray(np.arange(ncol) % 5, jnp.int32),
        l_ocean=jnp.asarray(np.arange(ncol) != 2))
    frc = jstate.init_forcing(ncol, nzp1)
    frc = dataclasses.replace(frc, sflux=jnp.asarray(rng.normal(size=(ncol, 6))))
    return st, prm, frc


def to_port(st, prm, frc):
    return (convert.state_from_numpy(jax_fields(st)),
            convert.params_from_numpy(jax_fields(prm)),
            convert.forcing_from_numpy(jax_fields(frc)))


@pytest.mark.parametrize("first_step", [True, False])
def test_ntflux_and_update_fluxes(rng, first_step):
    ncol, nz = 5, 12
    g = jgrid.make_vertical_grid(nz, 120.0, 1200.0)
    st, prm, frc = flux_state(rng, ncol, nz + 1)
    tst, tprm, tfrc = to_port(st, prm, frc)
    ref = jforcing.ntflux(st, frc, prm, g.dm, jnp.asarray(first_step))
    got = tforcing.ntflux(tst, tfrc, tprm, t64(g.dm), first_step)
    close(got.wxnt, ref.wxnt)
    close(got.swdk_opt, ref.swdk_opt)
    rj, rt = raw_fluxes(rng, ncol)
    cfg_j = JKppConfig(forcing=JForcingConfig())
    cfg_t = TKppConfig(forcing=TForcingConfig())
    sj, fj = jforcing.update_fluxes(cfg_j, st, prm, frc, rj,
                                    jnp.asarray(first_step), g.dm)
    stt, ft = tforcing.update_fluxes(cfg_t, tst, tprm, tfrc, rt, first_step,
                                     t64(g.dm))
    close(ft.sflux, fj.sflux)
    close(stt.wxnt, sj.wxnt)
    close(stt.swdk_opt, sj.swdk_opt)


def test_state_initializers_match():
    ncol, nzp1 = 3, 9
    for jfn, tfn in ((jstate.init_state, tstate.init_state),
                     (jstate.init_forcing, tstate.init_forcing),
                     (jstate.init_params, tstate.init_params)):
        ref = jax_fields(jfn(ncol, nzp1))
        got = convert.to_numpy(tfn(ncol, nzp1))
        assert set(ref) == set(got)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_import_loads_no_jax():
    """Importing the port, its CLI included, pulls in neither jax nor the
    JAX package."""
    code = ("import sys, mckpp_torch, mckpp_torch.ops.cuda_kernels, "
            "mckpp_torch.convert, mckpp_torch.cli, mckpp_torch.setup, "
            "mckpp_torch.models.chain, mckpp_torch.io.restart, "
            "mckpp_torch.io.ancillaries, mckpp_torch.io.streams, "
            "mckpp_torch.io.benchmark_inputs, mckpp_torch.ops.vmix\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'mckpp_tpu'})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_sources_name_no_jax():
    """No source of the port, nor chip_smoke.py, imports jax or the JAX
    package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mckpp_tpu)\b|"
                     r"import_module\(['\"](jax|mckpp_tpu)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mckpp_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), path
