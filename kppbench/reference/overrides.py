# Frozen copy of mckpp_torch/ops/overrides.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Physics overrides & resilience semantics: reset-to-climatology, freezing
floor, isothermal-column detection, bottom-temperature pinning
(counterpart of ``mckpp_tpu/ops/overrides.py``; reference:
mckpp_physics_overrides.F90).  Batched over the leading column axis.
"""

from __future__ import annotations

import torch

from .config import KppConfig
from .state import ColumnParams, Forcing, State


def check_profile(st: State, prm: ColumnParams, frc: Forcing, comp_flag,
                  grid, cfg: KppConfig) -> State:
    """Per-column repair after the ocean step
    (reference: mckpp_physics_overrides.F90:42-125).

    Whether T/S climatologies exist decides the reset target (the
    reference checks ocnT_file/sal_file != 'none').
    """
    f = cfg.forcing
    have_clim = (f.ocnt_file not in ("", "none")
                 and f.sal_file not in ("", "none"))
    nzp1 = grid.nzp1
    x, u, reset_flag = st.x, st.u, st.reset_flag
    comp3 = comp_flag[:, None, None]
    clim = torch.stack([frc.ocnt_clim, frc.sal_clim], dim=-1)

    # reset failed columns (comp_flag) to climatology / initial currents
    if have_clim:
        x = torch.where(comp3, clim, x)
    u = torch.where(comp3, prm.u_init, u)
    reset_flag = torch.where(comp_flag, 999.0, reset_flag)

    # freezing floor at -1.8 C (reference :85-94)
    freeze_flag = st.freeze_flag
    tinc = st.tinc_fcorr
    if f.l_no_freeze:
        frozen = prm.l_ocean[:, None] & (x[..., 0] < -1.8)
        tinc = tinc + torch.where(frozen, -1.8 - x[..., 0], 0.0)
        freeze_flag = (freeze_flag
                       + frozen.sum(dim=1).to(x.dtype) / float(nzp1))
        x = torch.stack([torch.where(frozen, -1.8, x[..., 0]), x[..., 1]],
                        dim=-1)

    # isothermal-column detection (reference :102-123)
    if f.l_no_isotherm:
        zm = grid.zm
        j = torch.arange(1, nzp1, device=zm.device)   # Fortran levels 2..nzp1
        in_range = j + 1 <= f.isotherm_bottom          # Fortran j <= iso_bot
        dz = zm[1:] - zm[:-1]
        dtdz = torch.where(in_range,
                           torch.abs(x[:, 1:, 0] - x[:, :-1, 0]) * dz,
                           0.0).sum(dim=1)
        dz_total = torch.where(in_range, dz, 0.0).sum()
        iso = prm.l_ocean & (torch.abs(dtdz / dz_total)
                             < f.isotherm_threshold)
        x = torch.where(iso[:, None, None], clim, x)
        reset_flag = torch.where(iso, -reset_flag, reset_flag)
        # the reference's ELSE zeroes reset_flag for non-ocean columns too
        reset_flag = torch.where(prm.l_ocean, reset_flag, 0.0)
    else:
        # reference zeroes reset_flag whenever the isotherm check is off
        # (mckpp_physics_overrides.F90:121-123)
        reset_flag = torch.zeros_like(reset_flag)

    return st.replace(x=x, u=u, reset_flag=reset_flag,
                      freeze_flag=freeze_flag, tinc_fcorr=tinc)


def bottomtemp(st: State, frc: Forcing, grid, dto) -> State:
    """Pin the bottom-level temperature to the prescribed value, logging the
    increment as a heat correction (reference :12-24)."""
    nz = grid.nz
    tinc_bot = frc.bottom_temp - st.x[:, nz, 0]
    tinc = st.tinc_fcorr.clone()
    tinc[:, nz] = tinc_bot
    ocntcorr = st.ocntcorr.clone()
    ocntcorr[:, nz] = tinc_bot * st.rho[:, nz] * st.cp[:, nz] / dto
    x = st.x.clone()
    x[:, nz, 0] = frc.bottom_temp
    return st.replace(x=x, tinc_fcorr=tinc, ocntcorr=ocntcorr)
