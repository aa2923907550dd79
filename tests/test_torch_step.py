"""One call of the whole-step body: mckpp_torch's plain step body (the
CUDA step kernel's plain version) against mckpp_tpu's
``make_fused_step(impl="xla", zaxis=0)``, in float64 on the CPU: the 3
compulsory passes, the per-column convergence loop and the instability
trap with its Coriolis retries, at rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mckpp_tpu as J
from mckpp_tpu.ops import fused_pass as jfp
from mckpp_tpu.ops import swfrac as jswfrac

from mckpp_torch import grid as tgrid
from mckpp_torch.ops import fused_pass as tfp

NCOL, NZ = 5, 12
LAT = np.array([5.0, 25.0, 45.0, -15.0, 60.0])
DMAX, DTO = 120.0, 1200.0
WZ = NZ + 2


def step_inputs(case):
    """The 21 step inputs as numpy float64 ((WZ, ncol) layout)."""
    rng = np.random.default_rng({"default": 3, "advect": 4, "trap": 5}[case])
    g = J.make_vertical_grid(NZ, DMAX, DTO)
    zm = np.pad(np.asarray(g.zm), (0, 1))
    hm = np.pad(np.asarray(g.hm), (0, 1), constant_values=1.0)
    dm = np.pad(np.asarray(g.dm), (0, 1))
    lvl = np.arange(WZ)[:, None] <= NZ

    def prof(base, noise):
        return np.where(lvl, base[:, None]
                        + noise * rng.standard_normal((WZ, NCOL)), 0.0)

    t0 = prof(20.0 + 5.0 * np.exp(zm / 40.0), 0.05)
    s0 = prof(-0.3 * np.exp(zm / 60.0), 0.01)
    u0, v0 = prof(np.zeros(WZ), 0.02), prof(np.zeros(WZ), 0.02)
    near = lambda a: np.where(lvl, a + 0.005 * rng.standard_normal(a.shape), 0.0)
    uo, vo, to, so = near(u0), near(v0), near(t0), near(s0)
    swdk = np.where(lvl, np.asarray(jswfrac.swdk(-jnp.asarray(dm), 2))[:, None]
                    * np.ones((1, NCOL)), 0.0)
    swfrac = np.where(lvl, np.asarray(jswfrac.swfrac_levels(
        1.0, jnp.asarray(zm), 2))[:, None] * np.ones((1, NCOL)), 0.0)
    dummy = np.zeros((WZ, 1))
    cs = np.zeros((jfp.NSC, NCOL))
    cs[jfp.CS_TAUX] = rng.uniform(0.02, 0.2, NCOL)
    if case == "trap":
        cs[jfp.CS_TAUX, 0] = 400.0
    cs[jfp.CS_SWF] = 200.0
    cs[jfp.CS_NSOL] = -150.0
    cs[jfp.CS_ICE] = 1e-10
    cs[jfp.CS_RAIN] = 6e-5
    cs[jfp.CS_SSURF] = 35.0 + s0[0]
    cs[jfp.CS_SREF] = 35.0
    cs[jfp.CS_F] = 2 * 7.29e-5 * np.sin(np.radians(LAT))
    cs[jfp.CS_OCDEPTH] = -10000.0
    cs[jfp.CS_RFAC], cs[jfp.CS_A1], cs[jfp.CS_A2] = 0.67, 1.0, 17.0
    if case == "advect":
        cs[jfp.CS_ADV1:jfp.CS_ADV1 + 7] = rng.uniform(-2e-6, 2e-6, (7, NCOL))
    cs[jfp.CS_ACTIVE] = [1.0, 1.0, 0.0, 1.0, 1.0]
    cs[jfp.CS_RHO0_IN] = 1024.0
    cs[jfp.CS_CP0_IN] = 3990.0
    aref = np.ascontiguousarray(jfp.build_ref_matrix(np.asarray(g.zm), WZ).T)
    col = lambda a: a[:, None]
    tdn = np.pad(np.asarray(g.tri_dn), (0, 1))
    tup = np.pad(np.asarray(g.tri_up), (0, 1))
    return (u0, v0, t0, s0, uo, vo, to, so, swdk, swfrac, dummy, dummy, dummy,
            dummy, cs, col(zm), col(hm), col(dm), col(tdn), col(tup), aref), g


@pytest.fixture(scope="module")
def step_bodies():
    """One JAX step body for all cases: its XLA compile dominates the cost
    of this file.  The advection corrections are on in every case, with
    zero coefficients outside the "advect" case; the default flags' step
    body is held to the JAX one by tests/test_torch_model.py."""
    g = J.make_vertical_grid(NZ, DMAX, DTO)
    flags = dict(l_advect=True)
    jbody = jfp.make_fused_step(g, NCOL, jnp.float64, jfp.PassFlags(**flags),
                                DTO, itermax=200, hmixtolfrac=0.1,
                                extra_iters=40, impl="xla", zaxis=0)
    tbody = tfp.make_fused_step(tgrid.make_vertical_grid(NZ, DMAX, DTO),
                                torch.float64, tfp.PassFlags(**flags), DTO,
                                itermax=200, hmixtolfrac=0.1, extra_iters=40,
                                impl="eager")
    return jbody, tbody


@pytest.mark.parametrize("case", ["default", "advect", "trap"])
def test_step_body_matches_jax(case, step_bodies):
    arrays, _ = step_inputs(case)
    jbody, tbody = step_bodies
    ref = [np.asarray(a) for a in jbody(*(jnp.asarray(a) for a in arrays))]
    got = [a.numpy() for a in tbody(*(torch.tensor(a) for a in arrays))]
    for i in range(8):
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-12,
                                   atol=1e-12 * np.abs(ref[i]).max(),
                                   err_msg=f"profile {i}")
    # colstep rows 0-6; row 7 is the port's pass count (zero in JAX)
    np.testing.assert_allclose(got[8][:7], ref[8][:7], rtol=1e-12,
                               atol=1e-14, err_msg="colstep")
    npass = got[8][7]
    assert npass[2] == 0 and (npass[[0, 1, 3, 4]] >= 4).all()
    if case == "trap":
        assert got[8][4, 0] == 1.0 and got[8][5, 0] == 11.0, got[8][:, 0]
        assert (got[8][4, [1, 3, 4]] == 0.0).all()
