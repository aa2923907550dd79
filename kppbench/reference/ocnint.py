# Frozen copy of mckpp_torch/ops/ocnint.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Backward-Euler implicit integration of the columns (ocnint; counterpart
of ``mckpp_tpu/ops/ocnint.py``; reference:
mckpp_physics_ocnint_mod.F90:19-221).

The U then V solves with semi-implicit Coriolis cross-coupling (V's
Coriolis term uses the updated U), then the T solve with the ghat
nonlocal and penetrating-solar RHS plus SST relaxation, flux corrections
and 3-D relaxation increments, then the S solve with salt corrections,
relaxation and the advection RHS modifications.  Batched over a leading
column axis; the feature flags are Python booleans.

``wu0``/``wx0`` are the kinematic surface fluxes (Fortran wU(0,:),
wX(0,:)); ``kmixe`` is the Fortran mixed-layer level index that picks
dm(kmixe).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tridiag import rhsmod, tridcof, tridmat, tridmat_pcr, tridrhs

SOLVERS = {"pcr": tridmat_pcr, "thomas": tridmat}


class OcnintResult(NamedTuple):
    u: torch.Tensor           # (ncol, nzp1, 2)
    x: torch.Tensor           # (ncol, nzp1, 2)
    tinc_fcorr: torch.Tensor  # (ncol, nzp1)
    sinc_fcorr: torch.Tensor  # (ncol, nzp1)
    ocntcorr: torch.Tensor    # (ncol, nzp1)
    scorr: torch.Tensor       # (ncol, nzp1)
    fcorr: torch.Tensor       # (ncol,) surface heat correction diagnostic


def ocnint(u, x, uo, xo, f, kmixe,
           difm, difs, dift, ghat, wxnt, wu0, wx0, rho, cp,
           sst0, fcorr_twod, fcorr_withz, sfcorr_withz, ocnt_clim, sal_clim,
           relax_sst, relax_ocnt, relax_sal, fcorr_prev,
           nmodeadv, modeadv, advection,
           grid, dto, *, l_relax_sst=False, l_relax_calconly=False,
           l_fcorr=False, l_fcorr_withz=False, l_sfcorr_withz=False,
           l_relax_sal=False, l_relax_ocnt=False, l_advect=False,
           solver="pcr"):
    """One implicit integration of every column.  u/x: the current
    iterate (ncol, nzp1, 2); uo/xo: the previous step's profiles; f,
    kmixe and the relaxation rates, targets and corrections per column;
    nmodeadv (ncol, 2), modeadv/advection (ncol, maxmodeadv, 2)."""
    tridsolve = SOLVERS[solver]
    zm, hm, dm = grid.zm, grid.hm, grid.dm
    tri_dn, tri_up = grid.tri_dn, grid.tri_up
    nz = zm.shape[0] - 1
    col = lambda a: a[:, None]
    dm_k = dm[kmixe.long()]

    # ---- U and V (reference :44-72) --------------------------------------
    cu_m, cc_m, cl_m = tridcof(difm, tri_dn, tri_up, nz)
    bot_m = tri_dn[nz] * difm[:, nz]
    rhs_u = uo[:, :nz, 0] + dto * col(f) * 0.5 * (uo[:, :nz, 1]
                                                  + u[:, :nz, 1])
    rhs_u[:, 0] = rhs_u[:, 0] + -dto * wu0[:, 0] / hm[0]
    rhs_u[:, nz - 1] = rhs_u[:, nz - 1] + bot_m * uo[:, nz, 0]
    u_new0 = tridsolve(cu_m, cc_m, cl_m, rhs_u, uo[:, :, 0])
    # V uses the *updated* U in its Coriolis term (sequential in the
    # reference)
    rhs_v = uo[:, :nz, 1] - dto * col(f) * 0.5 * (uo[:, :nz, 0]
                                                  + u_new0[:, :nz])
    rhs_v[:, 0] = rhs_v[:, 0] + -dto * wu0[:, 1] / hm[0]
    rhs_v[:, nz - 1] = rhs_v[:, nz - 1] + bot_m * uo[:, nz, 1]
    u_new1 = tridsolve(cu_m, cc_m, cl_m, rhs_v, uo[:, :, 1])
    u_new = torch.stack([u_new0, u_new1], dim=-1)

    # ---- Temperature (reference :82-162) ---------------------------------
    cu_t, cc_t, cl_t = tridcof(dift, tri_dn, tri_up, nz)
    rhs_t = tridrhs(hm, xo[:, :, 0], wxnt[:, :, 0], dift, ghat, wx0[:, 0],
                    wx0[:, 0], dto, tri_dn, nz)
    rho0, cp0 = rho[:, 0], cp[:, 0]
    fcorr = fcorr_prev
    if l_relax_sst and not l_fcorr_withz and not l_fcorr:
        do_rlx = relax_sst > 1.0e-10
        incr = dto * relax_sst * (sst0 - xo[:, 0, 0]) * dm_k / hm[0]
        if not l_relax_calconly:
            rhs_t[:, 0] = rhs_t[:, 0] + torch.where(do_rlx, incr, 0.0)
        fcorr = torch.where(
            do_rlx, relax_sst * (sst0 - xo[:, 0, 0]) * dm_k * rho0 * cp0,
            0.0)
    if l_fcorr and not l_relax_sst and not l_fcorr_withz:
        rhs_t[:, 0] = rhs_t[:, 0] + dto * fcorr_twod / (rho0 * cp0 * hm[0])

    tinc = torch.zeros_like(xo[:, :, 0])
    if l_fcorr_withz and not l_fcorr:
        tinc = tinc + dto * fcorr_withz / (rho * cp)
    if l_relax_ocnt:
        tinc = tinc + dto * col(relax_ocnt) * (ocnt_clim - xo[:, :, 0])
    rhs_t = rhs_t + tinc[:, :nz]
    ocntcorr = tinc * rho * cp / dto
    x_new0 = tridsolve(cu_t, cc_t, cl_t, rhs_t, xo[:, :, 0])

    # ---- Salinity (reference :164-219) -----------------------------------
    cu_s, cc_s, cl_s = tridcof(difs, tri_dn, tri_up, nz)
    rhs_s = tridrhs(hm, xo[:, :, 1], wxnt[:, :, 1], difs, ghat, wx0[:, 1],
                    wx0[:, 1], dto, tri_dn, nz)
    if l_advect:
        # up to maxmodeadv steady advection corrections, for the salinity
        # scalar only (reference ocnint :179-184)
        for im in range(modeadv.shape[1]):
            mode = torch.where(im < nmodeadv[:, 1], modeadv[:, im, 1], 0)
            rhs_s = rhsmod(2, mode, advection[:, im, 1], dto, kmixe, dm_k,
                           rhs_s, rho, cp, hm, zm, nz)
    sinc = torch.zeros_like(xo[:, :, 1])
    if l_sfcorr_withz:
        sinc = sinc + dto * sfcorr_withz
    if l_relax_sal:
        sinc = sinc + dto * col(relax_sal) * (sal_clim - xo[:, :, 1])
    rhs_s = rhs_s + sinc[:, :nz]
    scorr = sinc / dto
    x_new1 = tridsolve(cu_s, cc_s, cl_s, rhs_s, xo[:, :, 1])
    x_new = torch.stack([x_new0, x_new1], dim=-1)

    return OcnintResult(u=u_new, x=x_new, tinc_fcorr=tinc, sinc_fcorr=sinc,
                        ocntcorr=ocntcorr, scorr=scorr, fcorr=fcorr)
