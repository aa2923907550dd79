# Frozen copy of mckpp_torch/ops/vmix.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Vertical-mixing interface: EOS profiles, kinematic surface fluxes,
bulk-Richardson inputs and the kppmix scheme driver (counterpart of
``mckpp_tpu/ops/vmix.py``; reference:
mckpp_physics_verticalmixing_mod.F90:14-161,
mckpp_physics_verticalmixing_kppmix_mod.F90:25-126).

Batched over a leading column axis where the JAX package vmaps a
per-column function.  It runs for the initial mixing pass
(``KppModel.initial_state``) and for every pass of the reference step
(``ops/ocnstep.py``), as plain torch on the model's device: in the JAX
package too it is XLA, not a Pallas kernel.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from . import constants as c
from .bldepth import bldepth
from .blmix import blmix, enhance
from .ddmix import ddmix
from .eos import abk80, cpsw, sig80
from .rimix import rimix
from .swfrac import swdk
from .wscale import wscale_analytic, wscale_nodal, wscale_table

_WSCALE = {"nodal": wscale_nodal, "analytic": wscale_analytic,
           "table": wscale_table}


class VmixResult(NamedTuple):
    hbl: torch.Tensor
    kbl: torch.Tensor           # int32, Fortran level index
    rho: torch.Tensor           # (ncol, nzp1)
    cp: torch.Tensor
    talpha: torch.Tensor
    sbeta: torch.Tensor
    buoy: torch.Tensor
    rhoh2o: torch.Tensor
    difm: torch.Tensor          # (ncol, nz+2)
    difs: torch.Tensor
    dift: torch.Tensor
    ghat: torch.Tensor          # (ncol, nz+1)
    rig: torch.Tensor
    dbloc: torch.Tensor
    shsq: torch.Tensor
    wu0: torch.Tensor           # (ncol, 2) kinematic surface momentum flux
    wx0: torch.Tensor           # (ncol, 3) kinematic surface T, S, B fluxes
    wxnt: torch.Tensor          # (ncol, nz+1, 2)
    swdk_opt: torch.Tensor      # (ncol, nz+1)
    ustar: torch.Tensor
    uref: torch.Tensor          # reference velocities at the last level
    vref: torch.Tensor


def vmix(u, x, sflux, ssurf, sref, jerlov, f, ocdepth, l_initflag: bool,
         swdk_opt_cached, swfrac_cached, wxnt_prev, first_step: bool, grid,
         *, lri=True, ldd=False, lkpp=True, update_wxnt=True,
         cst=c.Constants(), wscale_mode="nodal", tables=None):
    """One vertical-mixing evaluation for every column.

    u: (ncol, nzp1, 2); x: (ncol, nzp1, 2) with x[..., 0] = T,
    x[..., 1] = S - Sref; sflux: (ncol, 6) packed surface fluxes.  The
    flags lri/ldd/lkpp are the reference's LRI/LDD/LKPP switches;
    ``wscale_mode`` picks the velocity-scale form ("nodal", "analytic",
    or "table" with ``tables=(wmt, wst)`` from ``wscale.build_tables``).
    """
    if wscale_mode not in _WSCALE:
        raise ValueError(f"unknown wscale_mode {wscale_mode!r}")
    if (wscale_mode == "table") != (tables is not None):
        raise ValueError("tables=(wmt, wst) go with wscale_mode='table' "
                         "and only with it")
    extra = dict(zip(("wmt", "wst"), tables)) if tables is not None else {}
    ws_fn = partial(_WSCALE[wscale_mode], vonk=cst.vonk, **extra)
    zm, hm, dm = grid.zm, grid.hm, grid.dm
    nz = zm.shape[0] - 1
    ncol = u.shape[0]
    col = lambda a: a[:, None]

    # fresh-water and brine densities in the surface layer
    t_sfc = x[:, 0, 0]
    s0t, _ = sig80(torch.zeros_like(t_sfc), t_sfc, -zm[0])
    rhoh2o = 1000.0 + s0t
    s0b, _ = sig80(torch.full_like(t_sfc, cst.sice), t_sfc, -zm[0])
    rhob = 1000.0 + s0b

    # EOS on every level (reference :59-73); pressure = -zm (dbar)
    s_abs = x[..., 1] + col(sref)
    alpha, beta, _, sig0, _ = abk80(s_abs, x[..., 0], -zm)
    rho = 1000.0 + sig0
    cp = cpsw(s_abs, x[..., 0], -zm)
    talpha, sbeta = alpha, beta
    buoy = -cst.grav * sig0 / 1000.0
    rho0, cp0 = rho[:, 0], cp[:, 0]

    # non-turbulent solar flux profile (ntflux); swdk cache at interfaces
    swdk_opt = swdk(-dm, jerlov) if first_step else swdk_opt_cached
    if update_wxnt:   # False only for the pre-run initial vmix
        wxnt = wxnt_prev.clone()
        wxnt[..., 0] = -col(sflux[:, 2]) * swdk_opt / col(rho0 * cp0)
    else:
        wxnt = wxnt_prev

    # kinematic surface fluxes (reference :81-100)
    wu0 = torch.stack([-sflux[:, 0] / rho0, -sflux[:, 1] / rho0], dim=-1)
    tau = torch.sqrt(sflux[:, 0] ** 2 + sflux[:, 1] ** 2) + 1.0e-16
    ustar = torch.sqrt(tau / rho0)
    wx0_t = -sflux[:, 3] / rho0 / cp0
    wx0_s = (ssurf * sflux[:, 5] / rhoh2o
             + (ssurf - cst.sice) * sflux[:, 4] / rhob)
    b0 = -cst.grav * (talpha[:, 0] * wx0_t - sbeta[:, 0] * wx0_s)
    wx0 = torch.stack([wx0_t, wx0_s, -b0], dim=-1)
    b0sol = cst.grav * talpha[:, 0] * sflux[:, 2] / (rho0 * cp0)

    # buoyancy-gradient contributions on interfaces (for ddmix)
    alpha_dt = torch.zeros((ncol, nz + 1), dtype=u.dtype, device=u.device)
    beta_ds = torch.zeros_like(alpha_dt)
    alpha_dt[:, 1:] = (0.5 * (talpha[:, :-1] + talpha[:, 1:])
                       * (x[:, :-1, 0] - x[:, 1:, 0]))
    beta_ds[:, 1:] = (0.5 * (sbeta[:, :-1] + sbeta[:, 1:])
                      * (x[:, :-1, 1] - x[:, 1:, 1]))

    # reference velocity/buoyancy and bulk-Richardson inputs (:110-137):
    # each level's trapezoid average from the surface down to
    # zref = epsilon*zm(n) is a prefix sum over full layers plus one
    # partial layer located by searchsorted
    zref = c.EPSILON_KPP * zm[:nz]                     # (nz,)
    wz0 = torch.maximum(zm[0], zref)
    dz_lay = zm[:nz] - zm[1:nz + 1]                    # layer extents
    # k* = largest python k with zm[k] > zref (the partial layer); -1 if none
    kstar = torch.searchsorted(-zm, -zref, side="left") - 1
    has = kstar >= 0
    ks = torch.clamp(kstar, 0, nz - 1)
    wz_p = zm[ks] - zref
    del_p = 0.5 * wz_p / dz_lay[ks]

    def ref_avg(prof):
        top = col(prof[:, 0]) * wz0 / zref
        tfull = dz_lay * 0.5 * (prof[:, :nz] + prof[:, 1:nz + 1])
        csum = torch.cat([torch.zeros_like(tfull[:, :1]),
                          torch.cumsum(tfull, dim=1)], dim=1)
        partial_ = wz_p * (prof[:, ks] + del_p * (prof[:, ks + 1]
                                                  - prof[:, ks]))
        contrib = torch.where(has, csum[:, ks] + partial_, 0.0)
        return top - contrib / zref

    uref = ref_avg(u[..., 0])
    vref = ref_avg(u[..., 1])
    bref = ref_avg(buoy)

    ritop = (zref - zm[:nz]) * (bref - buoy[:, :nz])  # (ncol, nz)
    dbloc = torch.zeros_like(alpha_dt)
    dbloc[:, 1:] = buoy[:, :-1] - buoy[:, 1:]
    dvsq_lvl = (uref - u[:, :nz, 0]) ** 2 + (vref - u[:, :nz, 1]) ** 2
    shsq = torch.zeros_like(alpha_dt)
    shsq[:, 1:] = ((u[:, :-1, 0] - u[:, 1:, 0]) ** 2
                   + (u[:, :-1, 1] - u[:, 1:, 1]) ** 2)

    # ---- kppmix (reference kppmix_mod.F90:64-124) ------------------------
    if lri:
        difm, difs, dift, rig = rimix(dbloc, shsq, zm)
    else:
        difm = torch.zeros((ncol, nz + 2), dtype=u.dtype, device=u.device)
        difs, dift = torch.zeros_like(difm), torch.zeros_like(difm)
        rig = torch.zeros_like(alpha_dt)
    if ldd:
        difs, dift = ddmix(alpha_dt, beta_ds, difs, dift)
    # fill the bottom kmp1 coefficients for blmix
    for dif in (difm, difs, dift):
        dif[:, nz + 1] = dif[:, nz]

    if lkpp:
        hbl, bfsfc, stable, case_a, kbl = bldepth(
            dvsq_lvl, ritop, dbloc, ustar, b0, b0sol, swfrac_cached, jerlov,
            f, ocdepth, l_initflag, zm, hm, wscale=ws_fn, vonk=cst.vonk)
        blmc, ghat, dkm1 = blmix(difm, difs, dift, ustar, bfsfc, hbl,
                                 stable, case_a, kbl, zm, hm, wscale=ws_fn,
                                 vonk=cst.vonk)
        blmc, ghat = enhance(difm, difs, dift, dkm1, hbl, kbl, case_a,
                             blmc, ghat, zm)
        # merge boundary-layer and interior coefficients
        ki = torch.arange(nz + 2, device=u.device)
        inside = (ki >= 1) & (ki < col(kbl)) & (ki <= nz)
        pad = lambda a: torch.nn.functional.pad(a, (0, 1))
        difm = torch.where(inside, pad(blmc[..., 0]), difm)
        difs = torch.where(inside, pad(blmc[..., 1]), difs)
        dift = torch.where(inside, pad(blmc[..., 2]), dift)
        kg = torch.arange(nz + 1, device=u.device)
        ghat = torch.where((kg >= col(kbl)) & (kg <= nz), 0.0, ghat)
    else:
        hbl = (-zm[nz - 1]).expand(ncol).clone()
        kbl = torch.full((ncol,), nz, dtype=torch.int32, device=u.device)
        ghat = torch.zeros_like(alpha_dt)

    # bottom diffusivity limits + no ghat through the bottom (:151-159)
    difm[:, nz:] = c.VLIMIT_BOTTOM
    difs[:, nz:] = c.DLIMIT_BOTTOM
    dift[:, nz:] = c.DLIMIT_BOTTOM
    ghat[:, nz] = 0.0

    return VmixResult(
        hbl=hbl, kbl=kbl, rho=rho, cp=cp, talpha=talpha, sbeta=sbeta,
        buoy=buoy, rhoh2o=rhoh2o, difm=difm, difs=difs, dift=dift,
        ghat=ghat, rig=rig, dbloc=dbloc, shsq=shsq, wu0=wu0, wx0=wx0,
        wxnt=wxnt, swdk_opt=swdk_opt, ustar=ustar,
        uref=uref[:, nz - 1], vref=vref[:, nz - 1])
