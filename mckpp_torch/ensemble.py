"""Perturbed-physics ensembles as column-batch replication (counterpart of
``mckpp_tpu/ensemble.py``).

Columns are independent (SURVEY.md §2.6), so an N-member ensemble is N
copies of the column set stacked along the batch axis: the members ride
the same kernels, the same column layout over processes and the same
diagnostics, with no parallel code of their own.  A user callback
perturbs each member's (State, ColumnParams, Forcing) — initial-condition
noise, Jerlov types, forcing scalings.  Random numbers come from a
``torch.Generator`` seeded per member (``seed + m``), never from torch's
global generator.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .parallel.sharding import leaves, map_leaves


def replicate(tree, n_members: int):
    """Stack ``n_members`` copies of a column-batched tree along the
    column axis: (ncol, ...) -> (n_members * ncol, ...).  Member m owns
    rows [m*ncol, (m+1)*ncol)."""
    return map_leaves(lambda a: torch.cat([a] * n_members, dim=0), tree)


def member_slice(tree, member: int, ncol: int):
    """One member's columns of a replicated tree (views)."""
    return map_leaves(lambda a: a[member * ncol:(member + 1) * ncol], tree)


def _concat(trees):
    """The trees' leaves joined along the column axis."""
    cols = zip(*(leaves(t) for t in trees))
    return map_leaves(lambda _: torch.cat(next(cols), dim=0), trees[0])


def make_ensemble(st, prm, frc, n_members: int,
                  perturb: Optional[Callable] = None,
                  seed: Optional[int] = None):
    """The stacked (st, prm, frc) of ``n_members * ncol`` columns built
    from one member's.

    ``perturb(m, gen, st_m, prm_m, frc_m) -> (st_m, prm_m, frc_m)``
    customizes member m > 0 (member 0 stays unperturbed); ``gen`` is a
    ``torch.Generator`` on the state's device seeded with ``seed + m``
    (None without a seed), where the JAX package passes
    ``jax.random.fold_in(key, m)``."""
    dev = leaves(st)[0].device
    members = []
    for m in range(n_members):
        sm, pm, fm = st, prm, frc
        if perturb is not None and m > 0:
            gen = None
            if seed is not None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed + m)
            sm, pm, fm = perturb(m, gen, sm, pm, fm)
        members.append((sm, pm, fm))
    return tuple(_concat([mem[i] for mem in members]) for i in range(3))


def ensemble_mean_spread(arr, n_members: int):
    """(n_members * ncol, ...) -> (mean, spread) over the member axis; the
    spread is the population standard deviation, as ``jnp.std``."""
    per = arr.reshape((n_members, -1) + tuple(arr.shape[1:]))
    return per.mean(dim=0), per.std(dim=0, correction=0)
