"""Turbulent velocity scales wm/ws on torch tensors (counterpart of
``mckpp_tpu/ops/wscale.py``; reference: mckpp_physics_lookup_mod.F90:11-66,
mckpp_physics_verticalmixing_wscale_mod.F90).

Two gather-free forms are carried: :func:`wscale_nodal`, the reference's
bilinear table interpolation computed from the four surrounding table nodes
on the fly, and :func:`wscale_analytic`, the exact LMD stability functions
the table discretizes.  The resident-table form is not carried yet.  The
CUDA kernels hold the same formulas as device functions
(``csrc/physics.cuh``).
"""

from __future__ import annotations

import torch

from .. import constants as c

_DELTAZ = (c.WS_ZMAX - c.WS_ZMIN) / (c.WS_NI + 1)
_DELTAU = (c.WS_UMAX - c.WS_UMIN) / (c.WS_NJ + 1)


def _cbrt(x):
    """Signed cube root through pow, as the JAX package computes it (the
    kernels use pow too, not cbrt, so kernel and plain body agree)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _quartic_root(x):
    """x**0.25 as two square roots."""
    return torch.sqrt(torch.sqrt(x))


def _cube(x):
    return x * x * x


def wscale_analytic(sigma, hbl, ustar, bfsfc, *, vonk=c.VONK):
    """Closed-form LMD turbulent velocity scales — the exact stability
    functions the reference's lookup table discretizes
    (mckpp_physics_lookup_mod.F90:42-64), evaluated at the query point."""
    zehat = vonk * sigma * hbl * bfsfc
    ucube = _cube(ustar)
    zeta = zehat / (ucube + 1.0e-30)
    # stable branch, in the division-safe rearrangement the reference
    # itself uses for zehat > zmax (wscale_mod.F90:57-95)
    w_stab = vonk * ustar * ucube / (ucube + c.C1_WS * zehat + 1.0e-30)
    wm_unst = torch.where(
        zeta > c.ZETAM,
        vonk * ustar * _quartic_root(torch.abs(1.0 - c.C2_WS * zeta)),
        vonk * _cbrt(c.AM * ucube - c.CM * zehat))
    ws_unst = torch.where(
        zeta > c.ZETAS,
        vonk * ustar * torch.sqrt(torch.abs(1.0 - c.C3_WS * zeta)),
        vonk * _cbrt(c.AS_WS * ucube - c.CS * zehat))
    stable = zehat >= 0.0
    return (torch.where(stable, w_stab, wm_unst),
            torch.where(stable, w_stab, ws_unst))


def _node_wmws(zehat_n, usta_n, vonk=c.VONK):
    """The table-build formula (mckpp_physics_lookup_mod.F90:47-62)
    evaluated at a grid node."""
    ucube = _cube(usta_n)
    zeta = zehat_n / (ucube + 1.0e-20)
    w_st = vonk * usta_n / (1.0 + c.C1_WS * zeta)
    wm_un = torch.where(
        zeta > c.ZETAM,
        vonk * usta_n * _quartic_root(torch.abs(1.0 - c.C2_WS * zeta)),
        vonk * _cbrt(c.AM * ucube - c.CM * zehat_n))
    ws_un = torch.where(
        zeta > c.ZETAS,
        vonk * usta_n * torch.sqrt(torch.abs(1.0 - c.C3_WS * zeta)),
        vonk * _cbrt(c.AS_WS * ucube - c.CS * zehat_n))
    stable = zehat_n >= 0.0
    return torch.where(stable, w_st, wm_un), torch.where(stable, w_st, ws_un)


def _cell(diff, delta, n):
    """Table cell index: truncation toward zero, clipped to 0..n (the
    quotient is clamped first so the integer conversion cannot overflow;
    the clipped index is the same)."""
    q = torch.clamp(diff / delta, -1.0, n + 1.0)
    return torch.clamp(q.to(torch.int32), 0, n)


def wscale_nodal(sigma, hbl, ustar, bfsfc, *, vonk=c.VONK):
    """The reference's bilinear table interpolation — including its linear
    extrapolation outside the (zehat, ustar) table domain — computed
    gather-free by evaluating the table-build formula at the four
    surrounding grid nodes (mckpp_physics_verticalmixing_wscale_mod.F90:63-95).
    """
    zehat = vonk * sigma * hbl * bfsfc
    dtype = zehat.dtype
    zdiff = zehat - c.WS_ZMIN
    iz = _cell(zdiff, _DELTAZ, c.WS_NI).to(dtype)
    udiff = ustar - c.WS_UMIN
    ju = _cell(udiff, _DELTAU, c.WS_NJ).to(dtype)
    zfrac = zdiff / _DELTAZ - iz
    ufrac = udiff / _DELTAU - ju
    fzfrac = 1.0 - zfrac

    z_lo = c.WS_ZMIN + _DELTAZ * iz
    z_hi = z_lo + _DELTAZ
    u_lo = c.WS_UMIN + _DELTAU * ju
    u_hi = u_lo + _DELTAU
    wm_ll, ws_ll = _node_wmws(z_lo, u_lo, vonk)
    wm_hl, ws_hl = _node_wmws(z_hi, u_lo, vonk)
    wm_lh, ws_lh = _node_wmws(z_lo, u_hi, vonk)
    wm_hh, ws_hh = _node_wmws(z_hi, u_hi, vonk)

    wam = fzfrac * wm_lh + zfrac * wm_hh
    wbm = fzfrac * wm_ll + zfrac * wm_hl
    wm_tab = (1.0 - ufrac) * wbm + ufrac * wam
    was = fzfrac * ws_lh + zfrac * ws_hh
    wbs = fzfrac * ws_ll + zfrac * ws_hl
    ws_tab = (1.0 - ufrac) * wbs + ufrac * was

    ucube = _cube(ustar)
    wm_ana = vonk * ustar * ucube / (ucube + c.C1_WS * zehat)
    use_table = zehat <= c.WS_ZMAX
    return (torch.where(use_table, wm_tab, wm_ana),
            torch.where(use_table, ws_tab, wm_ana))
