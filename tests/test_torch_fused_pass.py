"""One fused pass: mckpp_torch's plain pass body (the CUDA kernels' plain
version) against mckpp_tpu's traced XLA body, in float64 on the CPU.

The same numpy inputs, in the columns-on-lanes layout ((WZ, ncol)
profiles, WZ = nz + 2), go through ``make_fused_pass(..., impl="xla",
zaxis=0)`` and the port's ``make_fused_pass(..., impl="eager")``.  The
bar is rtol 1e-12, the interpreter-vs-xla bar of
tests/test_fused_parity.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mckpp_tpu import grid as jgrid
from mckpp_tpu.ops import fused_pass as jfp
from mckpp_tpu.ops import swfrac as jswfrac

from mckpp_torch import grid as tgrid
from mckpp_torch.ops import fused_pass as tfp

NCOL, NZ, DMAX, DTO = 5, 12, 120.0, 1200.0
WZ = NZ + 2
RTOL = 1e-12

CASES = {
    "default_nodal": {},
    "analytic": {"wscale": "analytic"},
    "ldd": {"ldd": True},
    "lkpp_off": {"lkpp": False},
    "lri_off": {"lri": False},
    "relax_sst": {"l_relax_sst": True},
    "relax_sst_calconly": {"l_relax_sst": True, "l_relax_calconly": True},
    "fcorr": {"l_fcorr": True},
    "fcorr_withz": {"l_fcorr_withz": True},
    "sfcorr_withz": {"l_sfcorr_withz": True},
    "relax_ocnt_sal": {"l_relax_ocnt": True, "l_relax_sal": True},
    "advect": {"l_advect": True},
}


def advection_coefs():
    """Mixed rhsmod modes 1-7 over the columns, grouped by mode the way
    ocnstep_fused packs colscal rows CS_ADV1..7 (the construction of
    tests/test_fused_parity.py _advection_params, on five columns)."""
    coef = np.zeros((7, NCOL))
    entries = [[(1, 2.0e-6), (3, -1.0e-6)], [(2, 1.5e-6), (4, 1.0e-6)],
               [(5, 1.0e-6), (6, 2.0e-6), (7, -5.0e-7)], [(6, -1.0e-6)],
               [(7, 3.0e-6), (2, 5.0e-7)]]
    for col, ents in enumerate(entries):
        for mode, mag in ents:
            coef[mode - 1, col] += mag
    return coef


def pass_inputs(seed, flags):
    """The 25 pass inputs as numpy float64, from a seed."""
    rng = np.random.default_rng(seed)
    g = jgrid.make_vertical_grid(NZ, DMAX, DTO)
    zm = np.pad(np.asarray(g.zm), (0, 1))
    hm = np.pad(np.asarray(g.hm), (0, 1), constant_values=1.0)
    dm = np.pad(np.asarray(g.dm), (0, 1))
    tdn = np.pad(np.asarray(g.tri_dn), (0, 1))
    tup = np.pad(np.asarray(g.tri_up), (0, 1))
    lvl = np.arange(WZ)[:, None] <= NZ            # rows of real levels

    def prof(base, noise):
        p = base[:, None] + noise * rng.standard_normal((WZ, NCOL))
        return np.where(lvl, p, 0.0)

    t = prof(20.0 + 5.0 * np.exp(zm / 40.0), 0.05)
    # warm salty water over cold fresh water: salt fingers for ddmix
    s = prof(0.3 * np.exp(zm / 60.0), 0.01)
    u = prof(np.zeros(WZ), 0.02)
    v = prof(np.zeros(WZ), 0.02)
    near = lambda a, e: np.where(lvl, a + e * rng.standard_normal(a.shape), 0.0)
    ux, vx, tx, sx = near(u, 0.005), near(v, 0.005), near(t, 0.01), near(s, 0.002)
    uo, vo, to, so = near(u, 0.005), near(v, 0.005), near(t, 0.01), near(s, 0.002)
    jer = np.full(NCOL, 2, np.int32)
    swdk = np.where(lvl, np.asarray(jswfrac.swdk(-jnp.asarray(dm), 2))[:, None]
                    * np.ones((1, NCOL)), 0.0)
    swfrac = np.where(lvl, np.asarray(jswfrac.swfrac_levels(
        1.0, jnp.asarray(zm), 2))[:, None] * np.ones((1, NCOL)), 0.0)
    dummy = np.zeros((WZ, 1))
    ocnt = prof(np.linspace(22.0, 10.0, WZ), 0.1) if flags.l_relax_ocnt else dummy
    sal = prof(np.full(WZ, 0.1), 0.01) if flags.l_relax_sal else dummy
    fcz = prof(np.linspace(30.0, 0.0, WZ), 1.0) if flags.l_fcorr_withz else dummy
    sfcz = prof(np.full(WZ, 1e-7), 1e-8) if flags.l_sfcorr_withz else dummy
    cs = np.zeros((jfp.NSC, NCOL))
    cs[jfp.CS_TAUX] = rng.uniform(0.02, 0.3, NCOL)
    cs[jfp.CS_TAUY] = rng.normal(0.0, 0.05, NCOL)
    cs[jfp.CS_SWF] = rng.uniform(0.0, 300.0, NCOL)
    cs[jfp.CS_NSOL] = rng.uniform(-250.0, 50.0, NCOL)
    cs[jfp.CS_ICE] = 1e-10
    cs[jfp.CS_RAIN] = rng.uniform(0.0, 1e-4, NCOL)
    cs[jfp.CS_SSURF] = 35.0 + s[0]
    cs[jfp.CS_SREF] = 35.0
    cs[jfp.CS_F] = 2 * 7.29e-5 * np.sin(np.radians([5.0, -20.0, 35.0, 50.0, 10.0]))
    cs[jfp.CS_OCDEPTH] = -10000.0
    cs[jfp.CS_RFAC], cs[jfp.CS_A1], cs[jfp.CS_A2] = 0.67, 1.0, 17.0
    cs[jfp.CS_FIRST] = 1.0 if seed % 2 else 0.0
    cs[jfp.CS_RELAX_SST] = [1 / (5 * 86400.0)] * 3 + [0.0, 1 / 86400.0]
    cs[jfp.CS_SST0] = 24.0
    cs[jfp.CS_FCORR2D] = rng.uniform(-20.0, 20.0, NCOL)
    cs[jfp.CS_RELAX_OCNT] = 1 / (3 * 86400.0)
    cs[jfp.CS_RELAX_SAL] = 1 / (4 * 86400.0)
    cs[jfp.CS_FCORRP] = rng.uniform(-5.0, 5.0, NCOL)
    if flags.l_advect:
        cs[jfp.CS_ADV1:jfp.CS_ADV1 + 7] = advection_coefs()
    cs[jfp.CS_ACTIVE] = 1.0
    aref = jfp.build_ref_matrix(np.asarray(g.zm), WZ).T
    col = lambda a: a[:, None]
    return (u, v, t, s, ux, vx, tx, sx, uo, vo, to, so, swdk, swfrac,
            ocnt, sal, fcz, sfcz, cs, col(zm), col(hm), col(dm), col(tdn),
            col(tup), np.ascontiguousarray(aref)), g


def run_both(case, full, seed):
    kw = CASES[case]
    jflags = jfp.PassFlags(**kw)
    tflags = tfp.PassFlags(**kw)
    arrays, g = pass_inputs(seed, tflags)
    jbody = jfp.make_fused_pass(g, NCOL, jnp.float64, jflags, DTO, full=full,
                                impl="xla", zaxis=0)
    tg = tgrid.make_vertical_grid(NZ, DMAX, DTO)
    tbody = tfp.make_fused_pass(tg, torch.float64, tflags, DTO, full=full,
                                impl="eager")
    ref = jbody(*(jnp.asarray(a) for a in arrays))
    got = tbody(*(torch.tensor(a) for a in arrays))
    assert len(got) == len(ref) == (23 if full else 9)
    return got, ref


def assert_outputs_close(got, ref):
    """rtol 1e-12 per element; entries near zero are held to rtol times
    the output's scale (its max magnitude), as tests/test_fused_parity.py
    holds fields by FIELD_SCALE: sums of many terms (the rhsmod band
    depths) round in another order in torch than in XLA."""
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()),
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_pass_matches_jax(case):
    got, ref = run_both(case, full=True, seed=1)
    assert_outputs_close(got, ref)


@pytest.mark.parametrize("case", ["default_nodal", "advect"])
def test_fast_pass_matches_jax(case):
    got, ref = run_both(case, full=False, seed=2)
    assert_outputs_close(got, ref)


def test_pass_crosses_inside_column():
    """The inputs are not vacuous: the boundary layer ends above the
    bottom (kbl < nz) in some column, and ddmix changes the diffusivities."""
    got, _ = run_both("default_nodal", full=True, seed=1)
    kbl = got[4][1]
    assert bool((kbl < NZ).any()) and bool((kbl >= 2).all())
    got_dd, _ = run_both("ldd", full=True, seed=1)
    assert not torch.equal(got_dd[7], got[7])


def test_build_ref_matrix_matches_jax():
    g = jgrid.make_vertical_grid(NZ, DMAX, DTO, stretch=True, dscale=2.0)
    zm = np.asarray(g.zm)
    np.testing.assert_array_equal(tfp.build_ref_matrix(zm, WZ),
                                  jfp.build_ref_matrix(zm, WZ))


def test_flags_cover_every_jax_field():
    """The port's PassFlags carries every field of the JAX PassFlags."""
    jf = {f.name: f.default for f in dataclasses.fields(jfp.PassFlags)}
    tf = {f.name: f.default for f in dataclasses.fields(tfp.PassFlags)}
    assert jf == tf
