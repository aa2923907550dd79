# Frozen copy of mckpp_torch/ops/tridiag.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""Tridiagonal system assembly and solution for the implicit vertical
diffusion solve (counterpart of ``mckpp_tpu/ops/tridiag.py``; reference:
mckpp_physics_solvers.F90: tridcof :14-44, tridrhs :53-107, tridmat
:112-161, rhsmod :176-335).

Batched over a leading column axis where the JAX package vmaps a
per-column function: ``diff`` is a Fortran-aligned interface array
(ncol, nz+2), ``ghat`` (ncol, nz+1), ``yo`` a 0-based level array
(ncol, nzp1); ``hm``, ``zm``, ``tri_dn`` and ``tri_up`` are the grid's
vectors.  Rows are 0-based (row i == Fortran row i+1) and solutions are
(ncol, nzp1) with ``yn[:, nz] = yo[:, nz]`` (the fictitious bottom layer
is held fixed).  Each expression keeps the JAX package's operation order,
so float64 results agree to the last bits.
"""

from __future__ import annotations

import torch


def tridcof(diff, tri_dn, tri_up, nz):
    """Matrix coefficients cu (lower neighbour), cc (diagonal), cl (upper
    neighbour), each (ncol, nz)."""
    i = torch.arange(1, nz + 1, device=diff.device)     # Fortran rows
    d_i, d_im1 = diff[:, 1:nz + 1], diff[:, :nz]
    cu = torch.where(i == 1, 0.0, -tri_up[i] * d_im1)
    cc = torch.where(i == 1, 1.0 + tri_dn[1] * diff[:, 1:2],
                     1.0 + tri_dn[i] * d_i + tri_up[i] * d_im1)
    cl = torch.where(i == nz, 0.0, -tri_dn[i] * d_i)
    return cu, cc, cl


def tridrhs(hm, yo, ntflux, diff, ghat, sturflux, ghatflux, dto, tri_dn,
            nz):
    """Scalar-equation right-hand side (the npd=1 path of the reference),
    (ncol, nz).  ntflux: (ncol, nz+1) non-turbulent flux on interfaces;
    sturflux/ghatflux: (ncol,) surface fluxes."""
    i = torch.arange(1, nz + 1, device=yo.device)
    col = lambda a: a[:, None]
    ghterm = col(ghatflux) * (diff[:, 1:nz + 1] * ghat[:, 1:nz + 1]
                              - diff[:, :nz] * ghat[:, :nz])
    ntterm = ntflux[:, 1:nz + 1] - ntflux[:, :nz]
    rhs = yo[:, :nz] + dto / hm[:nz] * (ghterm + ntterm)
    # surface row: ghat has no (i-1) term; subtract the surface flux
    rhs_sfc = yo[:, 0] + dto / hm[0] * (ghatflux * diff[:, 1] * ghat[:, 1]
                                        - sturflux + ntflux[:, 1]
                                        - ntflux[:, 0])
    rhs = torch.where(i == 1, col(rhs_sfc), rhs)
    # bottom row: diffusive inflow from the fixed fictitious layer
    bot = yo[:, nz] * tri_dn[nz] * diff[:, nz]
    return torch.where(i == nz, rhs + col(bot), rhs)


def tridmat(cu, cc, cl, rhs, yo):
    """Thomas solve (reference tridmat :134-159): a forward and a backward
    sweep over z, one level at a time, each vectorised over columns."""
    nz = rhs.shape[1]
    bet = cc[:, 0]
    yn = [rhs[:, 0] / bet]
    gam = [None]
    for i in range(1, nz):
        g = cl[:, i - 1] / bet
        bet = cc[:, i] - cu[:, i] * g
        yn.append((rhs[:, i] - cu[:, i] * yn[i - 1]) / bet)
        gam.append(g)
    for i in range(nz - 2, -1, -1):
        yn[i] = yn[i] - gam[i + 1] * yn[i + 1]
    return torch.stack(yn + [yo[:, -1]], dim=1)


def _up(v, s, fill=0.0):
    """v[:, i-s], filled outside the system."""
    return torch.nn.functional.pad(v[:, :-s], (s, 0), value=fill)


def _dn(v, s, fill=0.0):
    """v[:, i+s], filled outside the system."""
    return torch.nn.functional.pad(v[:, s:], (0, s), value=fill)


def tridmat_pcr(cu, cc, cl, rhs, yo):
    """Parallel-cyclic-reduction solve of the system of :func:`tridmat` in
    ceil(log2 nz) elimination sweeps over whole profiles.  The matrix is
    strictly diagonally dominant (tridcof), for which cyclic reduction is
    stable.  Same association order as ``fused_pass._pcr_solve``: one
    reciprocal of b per level, shifted both ways (a zero b, which only
    the shifted-in fill could hold, counts as 1)."""
    nz = rhs.shape[1]
    a, b, c_, r = cu, cc, cl, rhs
    s = 1
    while s < nz:
        rb = 1.0 / torch.where(b == 0.0, 1.0, b)
        alpha = -a * _up(rb, s, fill=1.0)
        beta = -c_ * _dn(rb, s, fill=1.0)
        b = b + alpha * _up(c_, s) + beta * _dn(a, s)
        r = r + alpha * _up(r, s) + beta * _dn(r, s)
        a = alpha * _up(a, s)
        c_ = beta * _dn(c_, s)
        s *= 2
    return torch.cat([r / b, yo[:, -1:]], dim=1)


def _first(mask):
    """0-based index of the first True along the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def rhsmod(jsclr, mode, a_mag, dto, km, dm_km, rhs, rho, cp, hm, zm, nz):
    """Advection correction of the scalar RHS (steady branch of the
    reference, modes 1-7; mode <= 0 leaves the row unchanged).

    jsclr: 1 (heat, W/m^2) or 2 (salt, PSU m/s times 0.033); mode, a_mag,
    km (the Fortran mixed-layer level index) and dm_km = dm[km] are
    per-column (ncol,) tensors; rhs (ncol, nz).  Returns the modified rhs.
    """
    dtype, dev = rhs.dtype, rhs.device
    ncol = rhs.shape[0]
    col = lambda a: a[:, None]
    lvl = torch.arange(1, nz + 1, device=dev)            # Fortran levels
    if jsclr == 1:
        fact = col(dto * a_mag) / (rho[:, :nz] * cp[:, :nz])
    else:
        fact = col(dto * a_mag * 0.033).expand(ncol, nz)
    safe = lambda d: torch.where(d > 0, d, 1.0)
    hm_n = hm[:nz]

    # mode 1: upper layer only
    add1 = torch.where(lvl == 1, fact / hm[0], 0.0)
    # mode 2: mixed layer (levels 1..km-1), divided by its thickness
    m2 = lvl <= col(km) - 1
    delta2 = torch.where(m2, hm_n, 0.0).sum(dim=1)
    add2 = torch.where(m2, fact / col(safe(delta2)), 0.0)
    # mode 3: whole column
    add3 = fact / hm_n.sum()
    # mode 4: from the first level below 100 m to nz-1 (grid only)
    below = zm[:nz] < -100.0
    m4 = (lvl >= _first(below) + 1) & (lvl <= nz - 1) & below.any()
    delta4 = torch.where(m4, hm_n, 0.0).sum()
    add4 = torch.where(m4, fact / safe(delta4), 0.0)
    # mode 5: bottom layer diffusion
    add5 = torch.where(lvl == nz, fact / hm[nz - 1], 0.0)

    # modes 6/7: seasonal mixed-layer / thermocline bands found by a
    # cumulative-depth walk (reference :292-331): walk n = n1..nz
    # accumulating delta += hm(n), depth += hm(n+1), stopping at the first
    # n with depth >= target
    def band(n1, depth0, target):
        in_walk = lvl >= col(n1)
        depth = col(depth0) + torch.where(in_walk, hm[1:nz + 1],
                                          0.0).cumsum(dim=1)
        hit = in_walk & (depth >= col(target))
        n2 = torch.where(hit.any(dim=1), _first(hit) + 1, nz)
        m = in_walk & (lvl <= col(n2))
        delta = torch.where(m, hm_n, 0.0).sum(dim=1)
        return torch.where(m, fact / col(safe(delta)), 0.0)

    km_l = km.long()
    hm_km, hm_km1 = hm[km_l - 1], hm[km_l - 2]
    dmax6 = dm_km - 0.5 * (hm_km + hm_km1)
    add6 = band(torch.ones_like(km_l), hm[0].expand(ncol), dmax6)
    add7 = band(km_l - 1, dm_km - 0.5 * hm_km,
                torch.full((ncol,), 100.0, dtype=dtype, device=dev))

    adds = torch.stack([torch.zeros_like(add1), add1, add2, add3, add4,
                        add5, add6, add7], dim=1)         # (ncol, 8, nz)
    idx = torch.clamp(mode.long(), 0, 7)
    return rhs + adds[torch.arange(ncol, device=dev), idx]
