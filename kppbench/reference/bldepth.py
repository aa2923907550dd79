# Frozen copy of mckpp_torch/ops/bldepth.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Oceanic planetary boundary-layer depth (counterpart of
``mckpp_tpu/ops/bldepth.py``; reference:
mckpp_physics_verticalmixing_bldepth_mod.F90:32-203).

hbl is the shallowest depth where the bulk Richardson number reaches
Ricr = 0.30 (linear interpolation between levels), limited under stable
forcing by the Monin-Obukhov and Ekman depths and by the ocean depth.
Batched over a leading column axis: ``dvsq``/``ritop`` are (ncol, nz)
0-based level arrays, ``dbloc`` is Fortran-aligned (ncol, nz+1),
``swfrac_cached`` the (ncol, nzp1) per-level shortwave fraction.  The
returned ``kbl`` is the Fortran level index (2..nz) of the first grid
level below hbl.
"""

from __future__ import annotations

import math

import torch

from . import constants as c
from .swfrac import swfrac

_EPSLN = 1.0e-16


def _rib_scan(raw, eps):
    """Rib(k) = max(raw_k, Rib(k-1) + eps) along the last axis, from
    Rib = 0 (:136-137): the maps f_k(x) = max(raw_k, x + eps) compose
    associatively as (m, c) -> max(m, x + c), so a log-depth doubling scan
    replaces the sequential loop, as the JAX package's associative scan
    does."""
    m, cc = raw, torch.full_like(raw, eps)
    n = raw.shape[-1]
    step = 1
    while step < n:
        m_s, c_s = m[..., :-step], cc[..., :-step]
        m = torch.cat([m[..., :step],
                       torch.maximum(m[..., step:], m_s + cc[..., step:])],
                      dim=-1)
        cc = torch.cat([cc[..., :step], c_s + cc[..., step:]], dim=-1)
        step *= 2
    return torch.maximum(m, cc)


def bldepth(dvsq, ritop, dbloc, ustar, bo, bosol, swfrac_cached, jerlov,
            f, ocdepth, l_initflag: bool, zm, hm, *, wscale, vonk=c.VONK):
    """(hbl, bfsfc, stable, caseA, kbl) per column.  ``wscale(sigma, hbl,
    ustar, bfsfc) -> (wm, ws)`` is one of the forms of ``ops/wscale.py``."""
    nz = zm.shape[0] - 1
    dtype = zm.dtype
    fl = lambda b: b.to(dtype)

    vtc = c.CV * math.sqrt(0.2 / c.CS / c.EPSILON_KPP) / vonk ** 2 / c.RICR
    hek = c.CEKMAN * ustar / (torch.abs(f) + _EPSLN)
    zbot = zm[nz]                       # zm(kmp1) Fortran = -dmax

    # ---- per-level quantities for Fortran kl = 2..km (columns 0..nz-2) ----
    ust = ustar[:, None]
    z_kl = zm[1:nz]                     # zm(kl)
    z_klm1 = zm[0:nz - 1]               # zm(kl-1)
    bfsfc_l = bo[:, None] + bosol[:, None] * (1.0 - swfrac_cached[:, 1:nz])
    stable_l = fl(bfsfc_l + _EPSLN >= 0.0)
    sigma_l = stable_l + (1.0 - stable_l) * c.EPSILON_KPP
    _, ws_l = wscale(sigma_l, -z_kl, ust, bfsfc_l)
    dz_up = z_klm1 - z_kl
    dz_dn = z_kl - zm[2:nz + 1]
    bvsq = 0.5 * (dbloc[:, 1:nz] / dz_up + dbloc[:, 2:nz + 1] / dz_dn)
    vtsq = -z_kl * ws_l * torch.sqrt(torch.abs(bvsq)) * vtc
    # Monin-Obukhov depth candidate at each level
    dmo_raw = c.CMONOB * (ust * (ust * ust)) / vonk / (torch.abs(bfsfc_l)
                                                      + _EPSLN)
    dmo_l = stable_l * dmo_raw - (1.0 - stable_l) * zbot
    hekman_l = stable_l * hek[:, None] - (1.0 - stable_l) * zbot
    raw = ritop[:, 1:nz] / (dvsq[:, 1:nz] + vtsq + _EPSLN)
    rib = _rib_scan(raw, _EPSLN)
    rib_prev = torch.cat([torch.zeros_like(rib[:, :1]), rib[:, :-1]], dim=1)
    dmo_prev = torch.cat([(-zbot).expand(rib.shape[0], 1), dmo_l[:, :-1]],
                         dim=1)

    # ---- per-level hbl candidates + first crossing ----------------------
    hri = -z_klm1 + (z_klm1 - z_kl) * (c.RICR - rib_prev) / (rib - rib_prev)
    slope = (dmo_l - dmo_prev) / (z_klm1 - z_kl)
    hmonob = torch.where(dmo_l <= -z_kl, (dmo_l + slope * z_kl) / (1.0 - slope),
                         -zbot)
    ocd = -ocdepth[:, None]
    hmin = torch.minimum(torch.minimum(hri, hmonob),
                         torch.minimum(hekman_l, ocd))
    # SJW/NPK fix: skip the Ekman/MO limits when they would put hbl above
    # the previous level, outside initialization (:161-184)
    if not l_initflag:
        hmin2 = torch.minimum(torch.minimum(hri, hmonob), ocd)
        use_fix = (hmin < -z_klm1) & (hmin2 < -z_kl)
        hmin = torch.where(use_fix, hmin2, hmin)
    crossing = hmin < -z_kl
    found = crossing.any(dim=1)
    first = torch.argmax(crossing.to(torch.uint8), dim=1)
    hbl = torch.where(found, hmin.gather(1, first[:, None])[:, 0], -zm[nz - 1])
    kbl = torch.where(found, first + 2, nz).to(torch.int32)

    # ---- final surface forcing at hbl -----------------------------------
    swdk_hbl = swfrac(-1.0, hbl, jerlov)
    bfsfc = bo + bosol * (1.0 - swdk_hbl)
    stable = fl(bfsfc >= 0.0)
    bfsfc = bfsfc + stable * _EPSLN
    k = kbl.long() - 1
    case_a = fl(-zm[k] - 0.5 * hm[k] - hbl >= 0.0)
    return hbl, bfsfc, stable, case_a, kbl
