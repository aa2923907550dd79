# Frozen copy of mckpp_torch/ops/rimix.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Interior mixing: shear instability (local Richardson number) + background
internal waves, with one pass of clipped 1-2-1 vertical smoothing
(counterpart of ``mckpp_tpu/ops/rimix.py``; reference:
mckpp_physics_verticalmixing_rimix_mod.F90,
mckpp_physics_verticalmixing_z121_mod.F90).

Batched over a leading column axis.  Interface arrays are Fortran-aligned:
index ``j`` (1..nz) is the interface below python level ``j-1``; index 0
is the surface.
"""

from __future__ import annotations

import torch

from . import constants as c

_EPS = 1.0e-16


def z121(v, vlo, vhi):
    """Clipped 1-2-1 smoothing of v[..., 1..km] in a length-(km+2) last
    axis: weights are 0 outside [vlo, vhi]; neighbours always use the
    pre-smoothing values.  Entries 0 and km+1 are zeroed."""
    v = v.clone()
    v[..., 0] = 0.0
    v[..., -1] = 0.0
    w = (~((v < vlo) | (v > vhi))).to(v.dtype)
    w[..., 0] = 0.0
    w[..., -1] = 0.0
    num = torch.zeros_like(v)
    den = torch.zeros_like(v)
    num[..., 1:-1] = (w[..., :-2] * v[..., :-2] + 2.0 * v[..., 1:-1]
                      + w[..., 2:] * v[..., 2:])
    den[..., 1:-1] = w[..., :-2] + 2.0 + w[..., 2:]
    pos = den > 0.0
    out = torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)
    out[..., 0] = 0.0
    out[..., -1] = 0.0
    return out


def rimix(dbloc, shsq, zm):
    """Interior diffusivities from the gradient Richardson number.

    dbloc, shsq: (ncol, nz+1) interface arrays (index 1..nz used); zm:
    (nzp1,) level depths.  Returns (difm, difs, dift, rig): difm/difs/dift
    are (ncol, nz+2) with [:, 0] = 0 and [:, nz+1] = 0 (filled by the
    kppmix driver); rig is the raw (unsmoothed) Richardson number,
    (ncol, nz+1).
    """
    nz = zm.shape[0] - 1
    ncol = dbloc.shape[0]
    dz = zm[:-1] - zm[1:]                   # zm(ki)-zm(ki+1), Fortran ki
    rig = torch.zeros_like(dbloc)
    rig[:, 1:] = dbloc[:, 1:] * dz / (shsq[:, 1:] + _EPS)

    # one pass of clipped 1-2-1 smoothing (mRi=1) over a 0..nzp1 buffer
    buf = torch.zeros((ncol, nz + 2), dtype=dbloc.dtype, device=dbloc.device)
    buf[:, 1:nz + 1] = rig[:, 1:]
    smooth = z121(buf, 0.0, c.RIINFTY)[:, 1:nz + 1]

    raw = rig[:, 1:]
    # static-instability (convection) factor from the unsmoothed Ri
    rigg = torch.clamp_min(raw, c.RICON)
    ratio = torch.clamp_max((c.RICON - rigg) / c.RICON, 1.0)
    fcon = (1.0 - ratio * ratio) ** 3
    # shear-instability factor from the smoothed Ri
    rigg = torch.clamp_min(smooth, 0.0)
    ratio = torch.clamp_max(rigg / c.RIINFTY, 1.0)
    fri = (1.0 - ratio * ratio) ** 3

    difm = torch.zeros_like(buf)
    difs = torch.zeros_like(buf)
    difm[:, 1:nz + 1] = c.DIFMIW + fcon * c.DIFMCON + fri * c.DIFM0
    difs[:, 1:nz + 1] = c.DIFSIW + fcon * c.DIFSCON + fri * c.DIFS0
    return difm, difs, difs.clone(), rig
