# Frozen copy of mckpp_torch/forcing.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Surface-flux computation & packing (counterpart of
``mckpp_tpu/forcing.py``; reference: mckpp_fluxes_mod.F90:35-118).

Every ``ndtocn`` steps the raw fluxes (taux, tauy, swf, lwf, lhf, shf,
rain, snow) are packed per wet column into the sflux vector, and the
non-turbulent (penetrating solar) flux profile is refreshed from the
currently stored rho/cp.

sflux packing (Fortran sflux(ipt,1:6,5,0) -> python (ncol, 6)):
0=taux (floored at 1e-10 if calm), 1=tauy, 2=swf,
3=lwf+lhf+shf-snow*FLSN, 4=ice melt (1e-10), 5=rain+snow+lhf/EL.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as c
from .config import KppConfig
from .swfrac import swdk
from .state import ColumnParams, Forcing, State


class RawFluxes(NamedTuple):
    taux: torch.Tensor
    tauy: torch.Tensor
    swf: torch.Tensor
    lwf: torch.Tensor
    lhf: torch.Tensor
    shf: torch.Tensor
    rain: torch.Tensor
    snow: torch.Tensor


def constant_test_fluxes(ncol: int, dtype=torch.float64,
                         device="cpu") -> RawFluxes:
    """The l_fluxdata=.FALSE. constant test forcing
    (reference: mckpp_fluxes_mod.F90:41-49)."""
    full = lambda v: torch.full((ncol,), v, dtype=dtype, device=device)
    return RawFluxes(taux=full(0.01), tauy=full(0.0), swf=full(200.0),
                     lwf=full(0.0), lhf=full(-150.0), shf=full(0.0),
                     rain=full(6e-5), snow=full(0.0))


def pack_sflux(raw: RawFluxes, l_ocean, sflux_prev, l_rest: bool,
               flsn: float = c.FLSN, el: float = c.EL):
    """Pack raw fluxes into the sflux vector for wet columns
    (reference: mckpp_fluxes_mod.F90:56-85)."""
    calm = (raw.taux == 0.0) & (raw.tauy == 0.0)
    taux = torch.where(calm, 1e-10, raw.taux)
    if not l_rest:
        packed = torch.stack([
            taux, raw.tauy, raw.swf,
            raw.lwf + raw.lhf + raw.shf - raw.snow * flsn,
            torch.full_like(taux, 1e-10),
            raw.rain + raw.snow + raw.lhf / el,
        ], dim=-1)
    else:
        z = torch.zeros_like(taux)
        packed = torch.stack([torch.full_like(taux, 1e-10), z,
                              torch.full_like(taux, 300.0),
                              torch.full_like(taux, -300.0), z, z], dim=-1)
    return torch.where(l_ocean[:, None], packed.to(sflux_prev.dtype),
                       sflux_prev)


def ntflux(st: State, frc: Forcing, prm: ColumnParams, dm,
           first_step: bool) -> State:
    """Refresh the non-turbulent solar flux profile from current rho/cp
    (reference: mckpp_fluxes_ntflux, mckpp_fluxes_mod.F90:93-118).
    Batched over columns; only wet columns are updated."""
    swdk_opt = (swdk(-dm.to(st.swdk_opt.dtype), prm.jerlov) if first_step
                else st.swdk_opt)
    wxnt0 = (-frc.sflux[:, 2:3] * swdk_opt
             / (st.rho[:, 0:1] * st.cp[:, 0:1]))
    wet = prm.l_ocean[:, None]
    wxnt = st.wxnt.clone()
    wxnt[:, :, 0] = torch.where(wet, wxnt0, st.wxnt[:, :, 0])
    swdk_opt = torch.where(wet, swdk_opt, st.swdk_opt)
    return st.replace(wxnt=wxnt, swdk_opt=swdk_opt)


def update_fluxes(cfg: KppConfig, st: State, prm: ColumnParams,
                  frc: Forcing, raw: RawFluxes, first_step: bool, dm):
    """The per-ndtocn flux update: pack sflux + refresh wXNT."""
    sflux = pack_sflux(raw, prm.l_ocean, frc.sflux, cfg.forcing.l_rest,
                       flsn=cfg.constants.flsn, el=cfg.constants.el)
    frc = frc.replace(sflux=sflux)
    st = ntflux(st, frc, prm, dm, first_step)
    return st, frc
