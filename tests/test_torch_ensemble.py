"""The port's ensembles (``mckpp_torch/ensemble.py``) against the JAX
package's ``mckpp_tpu/ensemble.py`` on the same numpy inputs, and a
stepped ensemble against the single run.

* ``replicate``, ``member_slice``, ``make_ensemble`` without a
  perturbation and ``ensemble_mean_spread`` equal the JAX functions
  (spread is the population standard deviation in both);
* the perturbation callback gets a ``torch.Generator`` seeded with
  ``seed + m``: the same seed gives the same ensemble, member 0 stays
  unperturbed, torch's global generator is not touched;
* member 0 of a 4-member ensemble stepped 3 times (float64, the plain
  step on the CPU) equals the single run bit for bit.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mckpp_tpu import ensemble as jens
from mckpp_tpu import state as jstate

from mckpp_torch import convert
from mckpp_torch import ensemble as tens
from mckpp_torch.state import tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import run_steps, small_model  # noqa: E402

NCOL, NZP1 = 6, 5


def _fields(init, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f, a in vars(init).items():
        a = np.asarray(a)
        if a.dtype == np.bool_:
            out[f] = rng.uniform(size=a.shape) > 0.3
        elif np.issubdtype(a.dtype, np.integer):
            out[f] = rng.integers(0, 5, a.shape).astype(np.int32)
        else:
            out[f] = rng.standard_normal(a.shape)
    return out


def _pair(seed):
    """The same numpy trees as (jax, port) State/ColumnParams/Forcing."""
    j, t = [], []
    for init, cls, conv in (
            (jstate.init_state, jstate.State, convert.state_from_numpy),
            (jstate.init_params, jstate.ColumnParams,
             convert.params_from_numpy),
            (jstate.init_forcing, jstate.Forcing,
             convert.forcing_from_numpy)):
        f = _fields(init(NCOL, NZP1), seed)
        seed += 1
        j.append(cls(**{k: jnp.asarray(v) for k, v in f.items()}))
        t.append(conv(f))
    return j, t


def _same(jtree, ttree):
    for f, a in vars(jtree).items():
        np.testing.assert_array_equal(getattr(ttree, f).numpy(),
                                      np.asarray(a), err_msg=f)


@pytest.mark.parametrize("n", [1, 3])
def test_replicate_and_member_slice_match_jax(n):
    (js, _, _), (ts, _, _) = _pair(0)
    jr, tr = jens.replicate(js, n), tens.replicate(ts, n)
    _same(jr, tr)
    for m in range(n):
        _same(jens.member_slice(jr, m, NCOL), tens.member_slice(tr, m, NCOL))
        _same(js, tens.member_slice(tr, m, NCOL))


def test_make_ensemble_matches_jax():
    (js, jp, jf), (ts, tp, tf) = _pair(10)
    jout = jens.make_ensemble(js, jp, jf, 3)
    tout = tens.make_ensemble(ts, tp, tf, 3)
    for a, b in zip(jout, tout):
        _same(a, b)

    # the same perturbation on both sides
    jout = jens.make_ensemble(
        js, jp, jf, 3, lambda m, k, s, p, f: (
            jstate.State(**dict(vars(s), x=s.x + m)), p, f))
    tout = tens.make_ensemble(
        ts, tp, tf, 3, lambda m, g, s, p, f: (s.replace(x=s.x + m), p, f))
    for a, b in zip(jout, tout):
        _same(a, b)


@pytest.mark.parametrize("shape", [(4 * NCOL,), (4 * NCOL, NZP1),
                                   (4 * NCOL, NZP1, 2)])
def test_mean_spread_matches_jax(shape):
    a = np.random.default_rng(3).standard_normal(shape)
    jm, js = jens.ensemble_mean_spread(jnp.asarray(a), 4)
    tm, ts = tens.ensemble_mean_spread(torch.as_tensor(a), 4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-13,
                               atol=1e-15)


def _noise(m, gen, st, prm, frc):
    dt = torch.randn(st.x.shape[:-1], generator=gen, dtype=st.x.dtype)
    x = st.x.clone()
    x[..., 0] += 0.1 * dt
    return st.replace(x=x), prm, frc


def test_perturbation_generator_is_seeded_per_member():
    _, (ts, tp, tf) = _pair(20)
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    a = tens.make_ensemble(ts, tp, tf, 3, _noise, seed=7)
    assert torch.equal(torch.random.get_rng_state(), before)
    b = tens.make_ensemble(ts, tp, tf, 3, _noise, seed=7)
    c = tens.make_ensemble(ts, tp, tf, 3, _noise, seed=8)
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0),
             a[0], b[0])
    x = a[0].x.reshape(3, NCOL, NZP1, 2)
    assert torch.equal(x[0], ts.x)                     # member 0 as given
    assert not torch.equal(x[1], ts.x) and not torch.equal(x[1], x[2])
    # member m's draw is the generator seeded with seed + m
    g = torch.Generator().manual_seed(7 + 2)
    want = ts.x[..., 0] + 0.1 * torch.randn(ts.x.shape[:-1], generator=g,
                                            dtype=ts.x.dtype)
    assert torch.equal(x[2][..., 0], want)
    assert not torch.equal(c[0].x, a[0].x)


def test_stepped_ensemble_member0_equals_single_run():
    model, st, prm, frc = small_model(9)
    single = run_steps(model, st, prm, frc, 3)
    est, eprm, efrc = tens.make_ensemble(st, prm, frc, 4, _noise, seed=0)
    assert est.u.shape[0] == 36
    stepped = run_steps(model, est, eprm, efrc, 3)
    tree_map(lambda a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy()), tens.member_slice(stepped, 0, 9), single)
    # the perturbed members went their own way
    assert not torch.equal(tens.member_slice(stepped, 1, 9).x, single.x)
