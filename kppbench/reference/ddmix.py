# Frozen copy of mckpp_torch/ops/ddmix.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Double diffusion: salt fingering and diffusive convection (counterpart
of ``mckpp_tpu/ops/ddmix.py``; reference:
mckpp_physics_verticalmixing_ddmix_mod.F90:12-52).  Batched over a
leading column axis.
"""

from __future__ import annotations

import torch

from . import constants as c


def ddmix(alpha_dt, beta_ds, difs, dift):
    """Add double-diffusive diffusivities on interfaces 1..nz.

    alpha_dt, beta_ds: (ncol, nz+1) interface arrays (alpha*dT, beta*dS
    across interfaces); difs, dift: (ncol, nz+2).  Returns new
    (difs, dift).
    """
    nz1 = alpha_dt.shape[1]          # nz+1
    adt = alpha_dt[:, 1:]
    bds = beta_ds[:, 1:]

    # salt fingering: alpha*dT > beta*dS > 0
    finger = (adt > bds) & (bds > 0.0)
    safe_bds = torch.where(finger, bds, 1.0)
    rrho_f = torch.clamp_max(adt / safe_bds, c.RRHO0)
    dd = 1.0 - ((rrho_f - 1.0) / (c.RRHO0 - 1.0)) ** 2
    diff_f = c.DSFMAX * dd * dd * dd
    dift_add_f = torch.where(finger, diff_f * 0.8 / rrho_f, 0.0)
    difs_add_f = torch.where(finger, diff_f, 0.0)

    # diffusive convection: alpha*dT < 0, beta*dS < 0, alpha*dT < beta*dS
    conv = (adt < 0.0) & (bds < 0.0) & (adt < bds)
    safe_bds2 = torch.where(conv, bds, -1.0)
    rrho_c = adt / safe_bds2
    safe_rrho = torch.where(conv, rrho_c, 1.0)
    diff_c = 1.5e-6 * 9.0 * 0.101 * torch.exp(
        4.6 * torch.exp(-0.54 * (1.0 / safe_rrho - 1.0)))
    prandtl = torch.where(rrho_c > 0.5, (1.85 - 0.85 / safe_rrho) * rrho_c,
                          0.15 * rrho_c)
    dift_add_c = torch.where(conv, diff_c, 0.0)
    difs_add_c = torch.where(conv, prandtl * diff_c, 0.0)

    dift = dift.clone()
    difs = difs.clone()
    dift[:, 1:nz1] += dift_add_f + dift_add_c
    difs[:, 1:nz1] += difs_add_f + difs_add_c
    return difs, dift
