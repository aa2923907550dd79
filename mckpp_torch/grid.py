"""Vertical grid construction (counterpart of ``mckpp_tpu/grid.py``).

Index conventions are those of the JAX package:

* **Level arrays** (cell centres) are 0-based, length ``nzp1``:
  python ``k`` == Fortran ``k+1``.  ``zm[k] < 0`` is the level depth,
  ``hm[k]`` the layer thickness, with ``hm[nz] = 1e-10`` and
  ``zm[nz] = -dmax`` for the fictitious bottom layer
  (reference: mckpp_initialize_geography_mod.F90:72-74).
* **Interface arrays** are Fortran-aligned, index ``j`` == Fortran ``j``;
  ``dm[j]`` is interface depth (``dm[0] = 0``).

The grid is built on the host in numpy, in the model dtype, and then moved
to ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as c


@dataclasses.dataclass(frozen=True)
class VerticalGrid:
    zm: torch.Tensor       # (nzp1,) level depths, negative
    hm: torch.Tensor       # (nzp1,) layer thicknesses
    dm: torch.Tensor       # (nz+1,) interface depths, positive; dm[0]=0
    tri_dn: torch.Tensor   # (nz+1,) dto/hm(k)/dzb(k);  tri_dn[0] = dto/hm(1)
    tri_up: torch.Tensor   # (nz+1,) dto/hm(k)/dzb(k-1); [0:2] unused (=0)

    @property
    def nz(self) -> int:
        return self.zm.shape[0] - 1

    @property
    def nzp1(self) -> int:
        return self.zm.shape[0]

    @property
    def dmax(self) -> torch.Tensor:
        return -self.zm[-1]


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _tri_factors(zm: np.ndarray, hm: np.ndarray, dto: float):
    nz = zm.shape[0] - 1
    dzb = np.zeros(nz + 1, dtype=zm.dtype)           # dzb[j] = zm(j) - zm(j+1)
    dzb[1:] = zm[:-1] - zm[1:]
    tri_dn = np.zeros(nz + 1, dtype=zm.dtype)
    tri_up = np.zeros(nz + 1, dtype=zm.dtype)
    tri_dn[0] = dto / hm[0]
    tri_dn[1:] = dto / hm[:nz] / dzb[1:]
    tri_up[2:] = dto / hm[1:nz] / dzb[1:nz]
    return tri_dn, tri_up


def _to_grid(zm, hm, dm, dto, device) -> VerticalGrid:
    tri_dn, tri_up = _tri_factors(zm, hm, dto)
    t = lambda a: torch.as_tensor(a, device=device)
    return VerticalGrid(zm=t(zm), hm=t(hm), dm=t(dm), tri_dn=t(tri_dn),
                        tri_up=t(tri_up))


def make_vertical_grid(nz: int, dmax: float, dto: float, *,
                       stretch: bool = False, dscale: float = 0.0,
                       dtype=torch.float64, device="cpu") -> VerticalGrid:
    """Uniform or exponentially-stretched vertical grid
    (reference: mckpp_initialize_geography_mod.F90:43-74)."""
    npdtype = _np_dtype(dtype)
    hm = np.zeros(nz + 1, dtype=npdtype)
    if stretch:
        if dscale == 0.0:
            raise ValueError("dscale must be nonzero for stretched grids")
        dfac = 1.0 - np.exp(-dscale)
        i = np.arange(1, nz + 1, dtype=npdtype)
        sk = -(i - 0.5) / nz
        h = dmax * dfac / nz / dscale / (1.0 + sk * dfac)
        hm[:nz] = h * dmax / h.sum()
    else:
        hm[:nz] = dmax / nz
    zm = np.zeros(nz + 1, dtype=npdtype)
    dm = np.zeros(nz + 1, dtype=npdtype)
    hsum = 0.0
    for k in range(nz):
        zm[k] = -(hsum + 0.5 * hm[k])
        hsum += hm[k]
        dm[k + 1] = hsum
    hm[nz] = 1.0e-10
    zm[nz] = -dmax
    return _to_grid(zm, hm, dm, dto, device)


def vertical_grid_from_arrays(z: np.ndarray, h: np.ndarray, d: np.ndarray,
                              dto: float, dtype=torch.float64,
                              device="cpu") -> VerticalGrid:
    """Vertical grid from file-supplied d, h, z over levels 1..nz
    (reference: mckpp_initialize_geography_mod.F90:25-41, 72-74).

    ``d`` are interface depths after each layer (Fortran dm(1:nz));
    dmax is derived as ``-(z[nz-1] - h[nz-1])``.
    """
    npdtype = _np_dtype(dtype)
    nz = len(z)
    zm = np.zeros(nz + 1, dtype=npdtype)
    hm = np.zeros(nz + 1, dtype=npdtype)
    dm = np.zeros(nz + 1, dtype=npdtype)
    zm[:nz] = z
    hm[:nz] = h
    dm[1:] = d
    dmax = -1.0 * (z[nz - 1] - h[nz - 1])
    hm[nz] = 1.0e-10
    zm[nz] = -dmax
    return _to_grid(zm, hm, dm, dto, device)


def coriolis(dlat: torch.Tensor, twopi: float = c.TWOPI) -> torch.Tensor:
    """Coriolis parameter with a floor at 2.5 degrees latitude
    (reference: mckpp_initialize_geography_mod.F90:78-88)."""
    omega2 = 2.0 * (twopi / c.SIDEREAL_DAY)
    sin_floor = torch.sin(torch.tensor(2.5 * twopi / 360.0, dtype=dlat.dtype,
                                       device=dlat.device))
    floor = omega2 * sin_floor * torch.sign(dlat)
    full = omega2 * torch.sin(dlat * twopi / 360.0)
    # sign(0) = 0 in torch but the reference's SIGN(1., 0.0) = +1
    floor = torch.where(dlat == 0.0, omega2 * sin_floor, floor)
    return torch.where(torch.abs(dlat) < 2.5, floor, full)
