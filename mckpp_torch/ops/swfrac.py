"""Penetrating shortwave absorption: Simpson & Paulson (1977) two-band model
(counterpart of ``mckpp_tpu/ops/swfrac.py``; reference:
mckpp_physics_swfrac_mod.F90:14-79, mckpp_fluxes_mod.F90:121-137).

``jerlov`` is a 0-based water-type index 0..4 = I, IA, IB, II, III.  The
functions are batched: a ``jerlov`` tensor of shape ``S`` and depths of
shape ``Z`` give a result of shape ``S + Z``.

The per-level cached version (:func:`swfrac_levels`) clips the exponent at
rmin=-80, while :func:`swdk` (the non-turbulent flux profile) does not.
"""

from __future__ import annotations

import torch

from .. import constants as c


def jerlov_coeffs(jerlov: torch.Tensor, like: torch.Tensor):
    """Jerlov band coefficients (rfac, a1, a2) per column, in the dtype and
    on the device of ``like``.  The tables become tensors of the model
    dtype here: float64 tables would promote a float32 model's math."""
    idx = jerlov.long()
    tab = lambda t: torch.tensor(t, dtype=like.dtype, device=like.device)[idx]
    return tab(c.JERLOV_RFAC), tab(c.JERLOV_A1), tab(c.JERLOV_A2)


def _bcast(jerlov, z):
    rfac, a1, a2 = jerlov_coeffs(jerlov, z)
    ex = (...,) + (None,) * z.dim()
    return rfac[ex], a1[ex], a2[ex]


def swfrac_levels(fact, zm: torch.Tensor, jerlov: torch.Tensor):
    """Cached per-level sw fraction with rmin clipping
    (reference: MCKPP_PHYSICS_SWFRAC_OPT, mckpp_physics_swfrac_mod.F90:14-43).
    """
    rfac, a1, a2 = _bcast(jerlov, zm)
    r1 = torch.clamp_min(zm * fact / a1, c.SWFRAC_RMIN)
    r2 = torch.clamp_min(zm * fact / a2, c.SWFRAC_RMIN)
    return rfac * torch.exp(r1) + (1.0 - rfac) * torch.exp(r2)


def swdk(z: torch.Tensor, jerlov: torch.Tensor):
    """Unclipped sw decay used for the solar-heating profile
    (reference: mckpp_fluxes_swdk, mckpp_fluxes_mod.F90:121-137)."""
    rfac, a1, a2 = _bcast(jerlov, z)
    return rfac * torch.exp(z / a1) + (1.0 - rfac) * torch.exp(z / a2)
