"""Padding of the column axis (counterpart of
``mckpp_tpu/parallel/sharding.py``).

The reference's one parallel axis is data parallelism over independent
columns (OpenMP today, MPI over columns intended; SURVEY.md §2.6).  The
port splits the column axis into one contiguous slab per process
(``parallel/distributed.py``); the column count is padded up to a
multiple of the process count, and the padded columns are marked
inactive (``l_ocean`` and ``run_physics`` false) so the physics leaves
them alone.  The kernels take any column count (a ragged last block is
masked inside them), so no other multiple is needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def map_leaves(fn, tree):
    """Apply ``fn`` to every array of a column-batched tree: a tensor or
    numpy array, a state dataclass or a NamedTuple (``RawFluxes``)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_leaves(fn, v) for v in tree])
    raise TypeError(f"not a column-batched tree: {type(tree).__name__}")


def leaves(tree) -> list:
    """The arrays of a tree, in :func:`map_leaves` order."""
    out = []
    map_leaves(lambda a: out.append(a) or a, tree)
    return out


def pad_rows(a, n: int):
    """``a`` with zero rows appended up to ``n`` leading rows."""
    npad = n - a.shape[0]
    if npad <= 0:
        return a
    if isinstance(a, np.ndarray):
        return np.pad(a, [(0, npad)] + [(0, 0)] * (a.ndim - 1))
    return torch.cat([a, a.new_zeros((npad,) + tuple(a.shape[1:]))])


def mark_inactive(tree, ncol: int, first_row: int = 0):
    """Columns whose global index (``first_row`` + row) is ``ncol`` or
    beyond get ``l_ocean`` and ``run_physics`` false, where the tree has
    them."""
    if not hasattr(tree, "run_physics"):
        return tree
    rows = tree.run_physics.shape[0]
    mask = torch.arange(first_row, first_row + rows,
                        device=tree.run_physics.device) < ncol
    return dataclasses.replace(tree, l_ocean=tree.l_ocean & mask,
                               run_physics=tree.run_physics & mask)


def pad_columns(tree, multiple: int):
    """Pad every leaf's leading axis up to a multiple of ``multiple``;
    padded columns are marked inactive when the tree has
    l_ocean/run_physics.  Returns (padded_tree, original_ncol)."""
    ncol = leaves(tree)[0].shape[0]
    npad = (-ncol) % multiple
    if npad == 0:
        return tree, ncol
    padded = map_leaves(lambda a: pad_rows(a, ncol + npad), tree)
    return mark_inactive(padded, ncol), ncol


def unpad_columns(tree, ncol: int):
    return map_leaves(lambda a: a[:ncol], tree)
