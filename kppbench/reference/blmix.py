# Frozen copy of mckpp_torch/ops/blmix.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Boundary-layer diffusivities (shape-function matching) + interface
enhancement (counterpart of ``mckpp_tpu/ops/blmix.py``; reference:
mckpp_physics_verticalmixing_blmix_mod.F90:13-151,
mckpp_physics_verticalmixing_enhance_mod.F90:10-51).

Batched over a leading column axis.  Interface arrays (difm/difs/dift) are
Fortran-aligned (ncol, nz+2); ``kbl`` is the Fortran level index from
bldepth.  ``blmc`` is a Fortran-aligned (ncol, nz+1, 3) array (index
1..nz; [..., 0] momentum, 1 scalar, 2 temperature), ``ghat`` (ncol, nz+1)
and ``dkm1`` (ncol, 3).
"""

from __future__ import annotations

import torch

from . import constants as c

_EPSLN = 1.0e-20


def _shape_coeffs(sig, gat1, dat1):
    a1 = sig - 2.0
    a2 = 3.0 - 2.0 * sig
    a3 = sig - 1.0
    return a1 + a2 * gat1 + a3 * dat1


def _at(a, idx):
    """a[col, idx[col]] for a (ncol, n) tensor and (ncol,) indices."""
    return a.gather(1, idx[:, None])[:, 0]


def blmix(difm, difs, dift, ustar, bfsfc, hbl, stable, case_a, kbl, zm, hm,
          *, wscale, vonk=c.VONK):
    """Boundary-layer mixing coefficients (blmc, ghat, dkm1)."""
    nz = zm.shape[0] - 1
    cg = c.CSTAR * vonk * (c.CS * vonk * c.EPSILON_KPP) ** (1.0 / 3.0)

    # velocity scales at hbl
    sigma = stable * 1.0 + (1.0 - stable) * c.EPSILON_KPP
    wm, ws = wscale(sigma, hbl, ustar, bfsfc)

    # interior diffusivity and derivative at hbl, from level kn
    # kn = kbl-1 in case A, kbl in case B (Fortran level index)
    kb = kbl.long()
    kn = torch.where(case_a + _EPSLN >= 1.0, kb - 1, kb)
    hm_kn = hm[kn - 1]
    hm_knp1 = hm[kn]                      # hm(kn+1) Fortran
    delhat = 0.5 * hm_kn - zm[kn - 1] - hbl
    r = 1.0 - delhat / hm_kn

    def match(dif):
        d_km1, d_k, d_kp1 = _at(dif, kn - 1), _at(dif, kn), _at(dif, kn + 1)
        dvdzup = (d_km1 - d_k) / hm_kn
        dvdzdn = (d_k - d_kp1) / hm_knp1
        dp = 0.5 * ((1.0 - r) * (dvdzup + torch.abs(dvdzup))
                    + r * (dvdzdn + torch.abs(dvdzdn)))
        dh = d_k + dp * delhat
        return dp, dh

    viscp, visch = match(difm)
    difsp, difsh = match(difs)
    diftp, difth = match(dift)

    u2 = ustar * ustar
    f1 = stable * c.C1_WS * bfsfc / (u2 * u2 + _EPSLN)
    gat1 = (visch / hbl / (wm + _EPSLN), difsh / hbl / (ws + _EPSLN),
            difth / hbl / (ws + _EPSLN))
    dat1 = (torch.clamp_max(-viscp / (wm + _EPSLN) + f1 * visch, 0.0),
            torch.clamp_max(-difsp / (ws + _EPSLN) + f1 * difsh, 0.0),
            torch.clamp_max(-diftp / (ws + _EPSLN) + f1 * difth, 0.0))

    # interface loop ki = 1..km
    col = lambda a: a[:, None]
    sig = (-zm[:nz] + 0.5 * hm[:nz]) / col(hbl)
    st_ = col(stable)
    sigma_i = st_ * sig + (1.0 - st_) * torch.clamp_max(sig, c.EPSILON_KPP)
    wm_i, ws_i = wscale(sigma_i, col(hbl), col(ustar), col(bfsfc))
    g = [_shape_coeffs(sig, col(gat1[i]), col(dat1[i])) for i in range(3)]
    ncol = hbl.shape[0]
    blmc = torch.zeros((ncol, nz + 1, 3), dtype=hbl.dtype, device=hbl.device)
    blmc[:, 1:, 0] = col(hbl) * wm_i * sig * (1.0 + sig * g[0])
    blmc[:, 1:, 1] = col(hbl) * ws_i * sig * (1.0 + sig * g[1])
    blmc[:, 1:, 2] = col(hbl) * ws_i * sig * (1.0 + sig * g[2])
    ghat = torch.zeros((ncol, nz + 1), dtype=hbl.dtype, device=hbl.device)
    ghat[:, 1:] = (1.0 - st_) * cg / (ws_i * col(hbl) + _EPSLN)

    # diffusivities at the kbl-1 grid level
    sig_k = -zm[kb - 2] / hbl
    sigma_k = stable * sig_k + (1.0 - stable) * torch.clamp_max(
        sig_k, c.EPSILON_KPP)
    wm_k, ws_k = wscale(sigma_k, hbl, ustar, bfsfc)
    gk = [_shape_coeffs(sig_k, gat1[i], dat1[i]) for i in range(3)]
    dkm1 = torch.stack([hbl * wm_k * sig_k * (1.0 + sig_k * gk[0]),
                        hbl * ws_k * sig_k * (1.0 + sig_k * gk[1]),
                        hbl * ws_k * sig_k * (1.0 + sig_k * gk[2])], dim=-1)
    return blmc, ghat, dkm1


def enhance(difm, difs, dift, dkm1, hbl, kbl, case_a, blmc, ghat, zm):
    """Quadratic enhancement of blmc at interface kbl-1 (:31-49); returns
    new (blmc, ghat)."""
    nz = zm.shape[0] - 1
    ki = kbl.long() - 1                           # Fortran interface index
    delta = (hbl + zm[ki - 1]) / (zm[ki - 1] - zm[ki])

    def enh(dif, j):
        d = _at(dif, ki)
        dkmp5 = case_a * d + (1.0 - case_a) * _at(blmc[..., j], ki)
        dstar = (1.0 - delta) ** 2 * dkm1[:, j] + delta ** 2 * dkmp5
        return (1.0 - delta) * d + delta * dstar

    # only interfaces 1..km-1 are candidates (reference loop bound)
    apply = (ki >= 1) & (ki <= nz - 1)
    idx = torch.arange(blmc.shape[1], device=ki.device)
    sel = apply[:, None] & (idx[None, :] == ki[:, None])
    out = torch.stack([torch.where(sel, enh(dif, j)[:, None], blmc[..., j])
                       for j, dif in enumerate((difm, difs, dift))], dim=-1)
    ghat = torch.where(sel, (1.0 - case_a)[:, None] * ghat, ghat)
    return out, ghat
