"""Fused one-pass body {under-relax -> vertical mixing -> implicit solve}
and the whole-step body around it, as plain torch functions (counterpart
of ``mckpp_tpu/ops/fused_pass.py``).

One "pass" is the body of the reference's semi-implicit iteration
(mckpp_physics_ocnstep_mod.F90:122-135): under-relaxation, the vertical
mixing coefficient pipeline (EOS -> rimix/ddmix -> bldepth -> blmix ->
enhance) and the backward-Euler tridiagonal solves.  :func:`_pass_body`
and :func:`_step_body` are the plain versions of the three CUDA kernels in
``csrc/``: the CPU path and the tests run them, and ``chip_smoke.py``
holds each kernel against them on the card.

Layout (``zaxis``, the JAX package's argument of the same name):

* ``zaxis=0`` ("col_lanes"): profiles are ``(WZ, ncol)`` with ``WZ = nz +
  2`` (z on rows, columns along the fast axis); ``colscal`` is ``(NSC,
  ncol)``; grid rows are ``(WZ, 1)``; ``aref`` is the pre-transposed
  ``(WZ, WZ)`` matrix with ``ref_avg(prof) = aref @ prof``; the column
  outputs are ``(8 or 16, ncol)``;
* ``zaxis=1`` ("z_lanes"): profiles ``(ncol, WZ)``, ``colscal`` ``(ncol,
  NSC)``, grid rows and forcing dummies ``(1, WZ)``, ``aref`` as
  :func:`build_ref_matrix` returns it (``ref_avg(prof) = prof @ aref``),
  column outputs ``(ncol, 8 or 16)``.

The bodies below are written over ``zaxis=0``; with ``zaxis=1`` they run
on their arguments transposed and transpose their outputs back
(:func:`_either_layout`), so the two layouts' plain results are equal bit
for bit.

Index conventions (row ``j`` of a profile):

* level arrays (u, x, rho, zm, hm, swfrac): row ``j`` = python level ``j``
  = Fortran level ``j+1``; rows ``> nz`` are padding.
* Fortran-aligned interface arrays (difm/difs/dift 0:nzp1, ghat/dbloc/shsq/
  rig/wxnt/swdk_opt/dm/tri 0:nz): row ``j`` = Fortran interface ``j``.
* tridiagonal row arrays (cu/cc/cl/rhs/solution): row ``j`` = Fortran row
  ``j+1``; valid rows ``0..nz-1``.
* bldepth per-level arrays: row ``j`` = the Fortran ``kl`` loop index
  directly (valid ``2..nz``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import constants as c
from .eos import abk80, cpsw
from .wscale import wscale_analytic, wscale_nodal

_EPS16 = 1.0e-16
_EPS20 = 1.0e-20
_BIG = 1.0e30


@dataclasses.dataclass(frozen=True)
class PassFlags:
    """Feature flags specializing the pass (the reference's L_* switches
    that reach the pass)."""
    lri: bool = True
    ldd: bool = False
    lkpp: bool = True
    l_relax_sst: bool = False
    l_relax_calconly: bool = False
    l_fcorr: bool = False
    l_fcorr_withz: bool = False
    l_sfcorr_withz: bool = False
    l_relax_sal: bool = False
    l_relax_ocnt: bool = False
    # steady advection corrections of the salinity RHS (rhsmod modes 1-7,
    # solvers.F90:176-335); per-column magnitudes arrive pre-grouped by
    # mode in colscal rows CS_ADV1..CS_ADV7
    l_advect: bool = False
    # "nodal" = the reference's bilinear table interpolation computed
    # gather-free; "analytic" = the exact LMD stability functions
    wscale: str = "nodal"
    # NAME_CONSTANTS-overridable physical constants reaching the pass
    grav: float = c.GRAV
    vonk: float = c.VONK
    sice: float = c.SICE


# colscal row indices (packed per-column scalars)
CS_TAUX, CS_TAUY, CS_SWF, CS_NSOL, CS_ICE, CS_RAIN = 0, 1, 2, 3, 4, 5
CS_SSURF, CS_SREF, CS_F, CS_OCDEPTH = 6, 7, 8, 9
CS_RFAC, CS_A1, CS_A2, CS_FIRST = 10, 11, 12, 13
CS_RELAX_SST, CS_SST0, CS_FCORR2D, CS_RELAX_OCNT, CS_RELAX_SAL, CS_FCORRP = \
    14, 15, 16, 17, 18, 19
# advection-correction magnitudes grouped by rhsmod mode: row CS_ADV1+m-1
# holds coef_m = sum of advection(im, 2) over entries with modeadv(im, 2)==m
CS_ADV1 = 20
# step extras: per-column active mask (run_physics) and the previous
# step's surface rho/cp (carried for the lazy-diagnostics ntflux)
CS_ACTIVE, CS_RHO0_IN, CS_CP0_IN = 27, 28, 29
NSC = 32  # padded row count

N_IN_TOTAL = 25        # pass inputs
N_STEP_IN = 21         # step inputs: the pass inputs without ux..sx


def _shr(v, s, fill=0.0, dim=0):
    """z shift down the rows (or along ``dim``): out[j] = v[j-s] (fill
    for j < s)."""
    if s == 0:
        return v
    shape = list(v.shape)
    shape[dim] = s
    z = v.new_full(shape, fill)
    return torch.cat([z, v.narrow(dim, 0, v.shape[dim] - s)], dim=dim)


def _shl(v, s, fill=0.0, dim=0):
    """z shift up the rows (or along ``dim``): out[j] = v[j+s] (fill for
    j >= WZ-s)."""
    if s == 0:
        return v
    shape = list(v.shape)
    shape[dim] = s
    z = v.new_full(shape, fill)
    return torch.cat([v.narrow(dim, s, v.shape[dim] - s), z], dim=dim)


def build_ref_matrix(zm: np.ndarray, wz: int) -> np.ndarray:
    """Precompute the (WZ, WZ) matrix A with ``ref_avg(prof) = prof @ A``
    (host numpy; the pass takes its transpose).

    Column n (0-based level, n < nz) reproduces the reference's trapezoid
    average from the surface to ``zref = epsilon*zm(n+1)``
    (mckpp_physics_verticalmixing_mod.F90:110-137).  Grid-only.
    """
    zm = np.asarray(zm, np.float64)
    nz = zm.shape[0] - 1
    A = np.zeros((wz, wz), np.float64)
    zref = c.EPSILON_KPP * zm[:nz]
    wz0 = np.maximum(zm[0], zref)
    dz_lay = zm[:nz] - zm[1:nz + 1]
    kstar = np.searchsorted(-zm, -zref, side="left") - 1
    for n in range(nz):
        A[0, n] += wz0[n] / zref[n]
        if kstar[n] >= 0:
            ks = min(int(kstar[n]), nz - 1)
            for k in range(ks):
                tf = 0.5 * dz_lay[k] / zref[n]
                A[k, n] -= tf
                A[k + 1, n] -= tf
            wzp = zm[ks] - zref[n]
            delp = 0.5 * wzp / dz_lay[ks]
            A[ks, n] -= wzp * (1.0 - delp) / zref[n]
            A[ks + 1, n] -= wzp * delp / zref[n]
    return A


def advection_statics(zm: np.ndarray, hm: np.ndarray) -> dict:
    """Grid scalars of the rhsmod bases (solvers.F90:195-331)."""
    hm_np = np.asarray(hm, np.float64)
    zm_np = np.asarray(zm, np.float64)
    nz = zm_np.shape[0] - 1
    below = zm_np[:nz] < -100.0
    n1_4 = int(np.argmax(below)) + 1 if below.any() else 0
    m4 = np.zeros(nz, bool)
    if n1_4 > 0:
        m4[n1_4 - 1:nz - 1] = True
    return dict(hm1=float(hm_np[0]),
                inv_delta3=float(1.0 / hm_np[:nz].sum()),
                n1_4=n1_4,
                delta4=float(hm_np[:nz][m4].sum()),
                hm_nz=float(hm_np[nz - 1]))


def _ext(v, idx, li):
    """Per-column z-gather: out[0, b] = v[idx[b], b], as a one-hot masked
    sum (an index outside 0..WZ-1 gives 0)."""
    return torch.where(li == idx, v, 0.0).sum(dim=0, keepdim=True)


def _pcr_solve(cu, cc, cl, rhs, nz, row):
    """Parallel cyclic reduction of the batch of tridiagonal systems.
    Rows 0..nz-1 hold the systems; padding rows are (a=0, b=1, c=0, r=0)
    no-op rows.  One reciprocal of b per level, shifted both ways."""
    a = torch.where(row < nz, cu, 0.0)
    b = torch.where(row < nz, cc, 1.0)
    c_ = torch.where(row < nz, cl, 0.0)
    r = torch.where(row < nz, rhs, 0.0)
    s = 1
    while s < nz:
        # b==0 only on shifted-in fill (padding rows carry b=1), where
        # alpha/beta multiply a zero anyway
        rb = 1.0 / torch.where(b == 0.0, 1.0, b)
        alpha = -a * _shr(rb, s, fill=1.0)
        beta = -c_ * _shl(rb, s, fill=1.0)
        b = b + alpha * _shr(c_, s) + beta * _shl(a, s)
        r = r + alpha * _shr(r, s) + beta * _shl(r, s)
        a = alpha * _shr(a, s)
        c_ = beta * _shl(c_, s)
        s *= 2
    return r / b


def _tridcof(diff, tdn, tup, nz, row):
    """Matrix coefficients on z rows (reference solvers.F90:14-44)."""
    diff1 = _shl(diff, 1)                # diff[i] at row i-1
    tdn1 = _shl(tdn, 1)
    tup1 = _shl(tup, 1)
    cu = torch.where(row == 0, 0.0, -tup1 * diff)
    cc = 1.0 + tdn1 * diff1 + torch.where(row == 0, 0.0, tup1 * diff)
    cl = torch.where(row == nz - 1, 0.0, -tdn1 * diff1)
    return cu, cc, cl


def _tridrhs(hm, yo, ntflux, diff, ghat, sturflux, ghatflux, dto, tdn,
             nz, row):
    """Scalar RHS on z rows (reference solvers.F90:53-107).  ghat/diff
    row 0 are zero by construction, so the surface row needs only the
    explicit -sturflux term."""
    ghterm = ghatflux * (_shl(diff, 1) * _shl(ghat, 1) - diff * ghat)
    ntterm = _shl(ntflux, 1) - ntflux
    rhs = yo + dto / hm * (ghterm + ntterm)
    rhs = rhs + torch.where(row == 0, -dto / hm * sturflux, 0.0)
    bot = yo[nz:nz + 1] * tdn[nz:nz + 1] * diff[nz:nz + 1]
    return rhs + torch.where(row == nz - 1, bot, 0.0)


def _either_layout(body):
    """``body``, written over ``zaxis=0`` arguments, taking ``zaxis``: with
    ``zaxis=1`` every argument (all are 2-D) is transposed to the
    ``zaxis=0`` layout and every output transposed back, each as a
    contiguous copy, so the arithmetic is the ``zaxis=0`` call's."""
    @functools.wraps(body)
    def run(*arrays, zaxis=0, **kw):
        if zaxis == 0:
            return body(*arrays, **kw)
        if zaxis != 1:
            raise ValueError(f"zaxis={zaxis!r}: 0 or 1")
        outs = body(*(a.T.contiguous() for a in arrays), **kw)
        return tuple(o.T.contiguous() for o in outs)
    return run


def _ws_fn(flags: PassFlags):
    fn = wscale_analytic if flags.wscale == "analytic" else wscale_nodal
    return lambda sig, h, us, bf: fn(sig, h, us, bf, vonk=flags.vonk)


@_either_layout
def _pass_body(u, v, t, s, ux, vx, tx, sx, uo, vo, to, so,
               swdk_c, swfrac_c, ocnt_clim, sal_clim, fcorr_z, sfcorr_z,
               colscal, zm, hm, dm, tdn, tup, aref,
               *, nz, flags: PassFlags, dto, full, zbot, adv_st=None,
               f_row=None):
    """One fused pass over a batch of columns (layout in the module
    docstring).

    Returns a tuple:
    fast: (u', v', t', s', ux', vx', tx', sx', colout8)
    full: (u', v', t', s', colout16, difm, difs, dift, ghat, rho, cp,
           talpha, sbeta, buoy, rig, dbloc, shsq, wxnt_t, swdk_opt,
           tinc, sinc, ocntcorr, scorr)
    """
    wz = u.shape[0]
    dt = u.dtype
    li = torch.arange(wz, device=u.device)[:, None]
    lam = c.LAMBDA_SMOOTH
    shr, shl = _shr, _shl
    zs = lambda v_, a, b: v_[a:b]
    # the trapezoid reference averages, in full precision (never TF32)
    refdot = lambda prof: torch.matmul(aref, prof)
    cs = lambda k: colscal[k:k + 1, :]
    ext = lambda v_, idx: _ext(v_, idx, li)
    ws_fn = _ws_fn(flags)
    fl = lambda m: m.to(dt)

    # ---- under-relaxation (ocnstep :122-129) -----------------------------
    u = lam * ux + (1.0 - lam) * u
    v = lam * vx + (1.0 - lam) * v
    t = lam * tx + (1.0 - lam) * t
    s = lam * sx + (1.0 - lam) * s

    # ---- EOS on every level (verticalmixing :59-73) ----------------------
    sref = cs(CS_SREF)
    s_abs = s + sref
    pr = -zm                              # dbar, grid-row broadcast
    alpha, beta, _, sig0, _ = abk80(s_abs, t, pr)
    rho = 1000.0 + sig0
    cp = cpsw(s_abs, t, pr)
    buoy = -flags.grav * sig0 / 1000.0
    rho0, cp0 = zs(rho, 0, 1), zs(cp, 0, 1)
    ta0, sb0 = zs(alpha, 0, 1), zs(beta, 0, 1)
    # fresh-water / brine surface densities (verticalmixing :44-50)
    t_sfc = zs(t, 0, 1)
    zm_sfc = zs(zm, 0, 1)
    _, _, _, s0t, _ = abk80(torch.zeros_like(t_sfc), t_sfc, -zm_sfc)
    rhoh2o = 1000.0 + s0t
    _, _, _, s0b, _ = abk80(torch.full_like(t_sfc, flags.sice), t_sfc,
                            -zm_sfc)
    rhob = 1000.0 + s0b

    # ---- solar decay cache + non-turbulent flux (fluxes :93-137) ---------
    first = cs(CS_FIRST)
    rfac, a1j, a2j = cs(CS_RFAC), cs(CS_A1), cs(CS_A2)
    swdk_new = (rfac * torch.exp(-dm / a1j)
                + (1.0 - rfac) * torch.exp(-dm / a2j))
    swdk_opt = first * swdk_new + (1.0 - first) * swdk_c
    swf = cs(CS_SWF)
    wxnt_t = -swf * swdk_opt / (rho0 * cp0)

    # ---- kinematic surface fluxes (verticalmixing :81-100) ---------------
    taux, tauy = cs(CS_TAUX), cs(CS_TAUY)
    wu0x, wu0y = -taux / rho0, -tauy / rho0
    tau = torch.sqrt(taux * taux + tauy * tauy) + _EPS16
    ustar = torch.sqrt(tau / rho0)
    ssurf = cs(CS_SSURF)
    wx0t = -cs(CS_NSOL) / rho0 / cp0
    wx0s = (ssurf * cs(CS_RAIN) / rhoh2o
            + (ssurf - flags.sice) * cs(CS_ICE) / rhob)
    b0 = -flags.grav * (ta0 * wx0t - sb0 * wx0s)
    wx0b = -b0
    b0sol = flags.grav * ta0 * swf / (rho0 * cp0)

    # ---- interface buoyancy-gradient terms for ddmix ---------------------
    imask = (li >= 1) & (li <= nz)
    if flags.ldd:
        adt = torch.where(imask,
                          0.5 * (shr(alpha, 1) + alpha) * (shr(t, 1) - t), 0.0)
        bds = torch.where(imask,
                          0.5 * (shr(beta, 1) + beta) * (shr(s, 1) - s), 0.0)

    # ---- reference profiles & bulk-Richardson inputs (:110-137) ----------
    uref = refdot(u)
    vref = refdot(v)
    bref = refdot(buoy)
    zref = c.EPSILON_KPP * zm
    ritop = (zref - zm) * (bref - buoy)            # level rows 0..nz-1
    dbloc = torch.where(imask, shr(buoy, 1) - buoy, 0.0)
    du, dv = shr(u, 1) - u, shr(v, 1) - v
    shsq = torch.where(imask, du * du + dv * dv, 0.0)
    eu, ev = uref - u, vref - v
    dvsq = eu * eu + ev * ev                       # level rows 0..nz-1

    # ---- rimix + z121 (rimix_mod, z121_mod) ------------------------------
    if flags.lri:
        dz_int = shr(zm, 1) - zm
        rig = torch.where(imask, dbloc * dz_int / (shsq + _EPS16), 0.0)
        w = torch.where((rig < 0.0) | (rig > c.RIINFTY), 0.0, 1.0).to(dt)
        w = torch.where(imask, w, 0.0)
        vz = torch.where(imask, rig, 0.0)
        num = shr(w * vz, 1) + 2.0 * vz + shl(w * vz, 1)
        den = shr(w, 1) + 2.0 + shl(w, 1)
        smooth = torch.where(imask, num / den, 0.0)
        rigg = torch.clamp_min(rig, c.RICON)
        ratio = torch.clamp_max((c.RICON - rigg) / c.RICON, 1.0)
        fcon = (1.0 - ratio * ratio) ** 3
        rigg = torch.clamp_min(smooth, 0.0)
        ratio = torch.clamp_max(rigg / c.RIINFTY, 1.0)
        fri = (1.0 - ratio * ratio) ** 3
        difm = torch.where(imask, c.DIFMIW + fcon * c.DIFMCON + fri * c.DIFM0,
                           0.0)
        difs = torch.where(imask, c.DIFSIW + fcon * c.DIFSCON + fri * c.DIFS0,
                           0.0)
        dift = difs
    else:
        rig = torch.zeros_like(u)
        difm = torch.zeros_like(u)
        difs = torch.zeros_like(u)
        dift = torch.zeros_like(u)

    if flags.ldd:
        # double diffusion (ddmix_mod :12-52)
        finger = (adt > bds) & (bds > 0.0)
        safe_bds = torch.where(finger, bds, 1.0)
        rrho_f = torch.clamp_max(adt / safe_bds, c.RRHO0)
        dd = 1.0 - ((rrho_f - 1.0) / (c.RRHO0 - 1.0)) ** 2
        diff_f = c.DSFMAX * dd * dd * dd
        dift = dift + torch.where(finger, diff_f * 0.8 / rrho_f, 0.0)
        difs = difs + torch.where(finger, diff_f, 0.0)
        conv = (adt < 0.0) & (bds < 0.0) & (adt < bds)
        safe_bds2 = torch.where(conv, bds, -1.0)
        rrho_c = adt / safe_bds2
        safe_rrho = torch.where(conv, rrho_c, 1.0)
        diff_c = 1.5e-6 * 9.0 * 0.101 * torch.exp(
            4.6 * torch.exp(-0.54 * (1.0 / safe_rrho - 1.0)))
        prandtl = torch.where(rrho_c > 0.5,
                              (1.85 - 0.85 / safe_rrho) * rrho_c,
                              0.15 * rrho_c)
        dift = dift + torch.where(conv, diff_c, 0.0)
        difs = difs + torch.where(conv, prandtl * diff_c, 0.0)

    # fill the bottom kmp1 coefficient for blmix matching (kppmix :58-62)
    difm = torch.where(li == nz + 1, shr(difm, 1), difm)
    difs = torch.where(li == nz + 1, shr(difs, 1), difs)
    dift = torch.where(li == nz + 1, shr(dift, 1), dift)

    f_cor = cs(CS_F) if f_row is None else f_row
    if flags.lkpp:
        # ---- bldepth (bldepth_mod :32-203); row j = Fortran kl -----------
        vtc = (c.CV * math.sqrt(0.2 / c.CS / c.EPSILON_KPP)
               / flags.vonk ** 2 / c.RICR)
        ocdepth = cs(CS_OCDEPTH)
        hek = c.CEKMAN * ustar / (torch.abs(f_cor) + _EPS16)
        z_kl = shr(zm, 1)                    # zm(kl)
        z_klm1 = shr(zm, 2)                  # zm(kl-1)
        valid = (li >= 2) & (li <= nz)
        bfsfc_l = b0 + b0sol * (1.0 - shr(swfrac_c, 1))
        stable_l = fl(bfsfc_l + _EPS16 >= 0.0)
        sigma_l = stable_l + (1.0 - stable_l) * c.EPSILON_KPP
        _, ws_l = ws_fn(sigma_l, -z_kl, ustar, bfsfc_l)
        dz_up = z_klm1 - z_kl
        dz_dn = z_kl - zm
        bvsq = 0.5 * (shr(dbloc, 1) / torch.where(valid, dz_up, 1.0)
                      + dbloc / torch.where(valid, dz_dn, 1.0))
        vtsq = -z_kl * ws_l * torch.sqrt(torch.abs(bvsq)) * vtc
        dmo_raw = (c.CMONOB * (ustar * ustar * ustar) / flags.vonk
                   / (torch.abs(bfsfc_l) + _EPS16))
        dmo_l = stable_l * dmo_raw - (1.0 - stable_l) * zbot
        hekman_l = stable_l * hek - (1.0 - stable_l) * zbot
        raw = shr(ritop, 1) / (shr(dvsq, 1) + vtsq + _EPS16)
        # log-depth scan of Rib(k) = max(raw_k, Rib(k-1) + eps) (:136-137)
        m_acc = torch.where(valid, raw, -_BIG)
        c_acc = fl(valid) * _EPS16
        step = 1
        while step < wz:
            m_s = shr(m_acc, step, fill=-_BIG)
            c_s = shr(c_acc, step, fill=0.0)
            m_acc, c_acc = torch.maximum(m_acc, m_s + c_acc), c_s + c_acc
            step *= 2
        rib = torch.maximum(m_acc, c_acc)
        rib_prev = shr(rib, 1)
        dmo_prev = torch.where(li == 2, -zbot, shr(dmo_l, 1))
        hri = -z_klm1 + (z_klm1 - z_kl) * (c.RICR - rib_prev) / \
            torch.where(valid, rib - rib_prev, 1.0)
        slope = (dmo_l - dmo_prev) / torch.where(valid, z_klm1 - z_kl, 1.0)
        hmonob = torch.where(dmo_l <= -z_kl,
                             (dmo_l + slope * z_kl) / (1.0 - slope), -zbot)
        hmin = torch.minimum(torch.minimum(hri, hmonob),
                             torch.minimum(hekman_l, -ocdepth))
        # SJW/NPK fix (:161-184); the pass never runs at init
        hmin2 = torch.minimum(torch.minimum(hri, hmonob), -ocdepth)
        use_fix = (hmin < -z_klm1) & (hmin2 < -z_kl)
        hmin = torch.where(use_fix, hmin2, hmin)
        crossing = valid & (hmin < -z_kl)
        bigi = wz + 100
        firstx = torch.where(crossing, li, bigi).amin(dim=0, keepdim=True)
        found = firstx < bigi
        kbl = torch.where(found, firstx, nz)
        hbl = torch.where(found, ext(hmin, firstx), -zs(zm, nz - 1, nz))
        # final surface forcing at hbl (:187-201)
        swdk_hbl = (rfac * torch.exp(torch.clamp_min(-hbl / a1j,
                                                     c.SWFRAC_RMIN))
                    + (1.0 - rfac) * torch.exp(torch.clamp_min(
                        -hbl / a2j, c.SWFRAC_RMIN)))
        bfsfc = b0 + b0sol * (1.0 - swdk_hbl)
        stable = fl(bfsfc >= 0.0)
        bfsfc = bfsfc + stable * _EPS16
        zm_kbl = ext(zm, kbl - 1)
        hm_kbl = ext(hm, kbl - 1)
        case_a = fl(-zm_kbl - 0.5 * hm_kbl - hbl >= 0.0)

        # ---- blmix (blmix_mod :13-151) -----------------------------------
        cg = (c.CSTAR * flags.vonk
              * (c.CS * flags.vonk * c.EPSILON_KPP) ** (1.0 / 3.0))
        sigma_bl = stable * 1.0 + (1.0 - stable) * c.EPSILON_KPP
        wm_h, ws_h = ws_fn(sigma_bl, hbl, ustar, bfsfc)
        kn = torch.where(case_a + _EPS20 >= 1.0, kbl - 1, kbl)
        hm_kn = ext(hm, kn - 1)
        hm_knp1 = ext(hm, kn)
        delhat = 0.5 * hm_kn - ext(zm, kn - 1) - hbl
        r_frac = 1.0 - delhat / hm_kn

        def match(dif):
            d_m1 = ext(dif, kn - 1)
            d_0 = ext(dif, kn)
            d_p1 = ext(dif, kn + 1)
            dvdzup = (d_m1 - d_0) / hm_kn
            dvdzdn = (d_0 - d_p1) / hm_knp1
            dp = 0.5 * ((1.0 - r_frac) * (dvdzup + torch.abs(dvdzup))
                        + r_frac * (dvdzdn + torch.abs(dvdzdn)))
            return dp, d_0 + dp * delhat

        viscp, visch = match(difm)
        difsp, difsh = match(difs)
        diftp, difth = match(dift)
        u2 = ustar * ustar
        f1 = stable * c.C1_WS * bfsfc / (u2 * u2 + _EPS20)
        gat1m = visch / hbl / (wm_h + _EPS20)
        gat1s = difsh / hbl / (ws_h + _EPS20)
        gat1t = difth / hbl / (ws_h + _EPS20)
        dat1m = torch.clamp_max(-viscp / (wm_h + _EPS20) + f1 * visch, 0.0)
        dat1s = torch.clamp_max(-difsp / (ws_h + _EPS20) + f1 * difsh, 0.0)
        dat1t = torch.clamp_max(-diftp / (ws_h + _EPS20) + f1 * difth, 0.0)

        def shape(sig, gat1, dat1):
            return (sig - 2.0) + (3.0 - 2.0 * sig) * gat1 + (sig - 1.0) * dat1

        sig_i = (-shr(zm, 1) + 0.5 * shr(hm, 1)) / hbl     # row j = ki = j
        sigma_i = stable * sig_i + (1.0 - stable) * torch.clamp_max(
            sig_i, c.EPSILON_KPP)
        wm_i, ws_i = ws_fn(sigma_i, hbl, ustar, bfsfc)
        blmc_m = torch.where(imask, hbl * wm_i * sig_i *
                             (1.0 + sig_i * shape(sig_i, gat1m, dat1m)), 0.0)
        blmc_s = torch.where(imask, hbl * ws_i * sig_i *
                             (1.0 + sig_i * shape(sig_i, gat1s, dat1s)), 0.0)
        blmc_t = torch.where(imask, hbl * ws_i * sig_i *
                             (1.0 + sig_i * shape(sig_i, gat1t, dat1t)), 0.0)
        ghat = torch.where(imask,
                           (1.0 - stable) * cg / (ws_i * hbl + _EPS20), 0.0)
        # diffusivities at grid level kbl-1 (blmix :86-95)
        sig_k = -ext(zm, kbl - 2) / hbl
        sigma_k = stable * sig_k + (1.0 - stable) * torch.clamp_max(
            sig_k, c.EPSILON_KPP)
        wm_k, ws_k = ws_fn(sigma_k, hbl, ustar, bfsfc)
        dkm1_m = hbl * wm_k * sig_k * (1.0 + sig_k * shape(sig_k, gat1m, dat1m))
        dkm1_s = hbl * ws_k * sig_k * (1.0 + sig_k * shape(sig_k, gat1s, dat1s))
        dkm1_t = hbl * ws_k * sig_k * (1.0 + sig_k * shape(sig_k, gat1t, dat1t))

        # ---- enhance at interface kbl-1 (enhance_mod :10-51) -------------
        ki_e = kbl - 1
        zm_em1 = ext(zm, ki_e - 1)
        zm_e = ext(zm, ki_e)
        delta = (hbl + zm_em1) / (zm_em1 - zm_e)
        sel = (ki_e >= 1) & (ki_e <= nz - 1) & (li == ki_e)

        def enh(dif, blmc_x, dkm1_x):
            dif_e = ext(dif, ki_e)
            dkmp5 = case_a * dif_e + (1.0 - case_a) * ext(blmc_x, ki_e)
            om = 1.0 - delta
            dstar = om * om * dkm1_x + delta * delta * dkmp5
            return om * dif_e + delta * dstar

        blmc_m = torch.where(sel, enh(difm, blmc_m, dkm1_m), blmc_m)
        blmc_s = torch.where(sel, enh(difs, blmc_s, dkm1_s), blmc_s)
        blmc_t = torch.where(sel, enh(dift, blmc_t, dkm1_t), blmc_t)
        ghat = torch.where(sel, (1.0 - case_a) * ghat, ghat)

        # ---- merge boundary-layer and interior (kppmix :100-124) ---------
        inside = (li >= 1) & (li < kbl) & (li <= nz)
        difm = torch.where(inside, blmc_m, difm)
        difs = torch.where(inside, blmc_s, difs)
        dift = torch.where(inside, blmc_t, dift)
        ghat = torch.where((li >= kbl) & (li <= nz), 0.0, ghat)
    else:
        hbl = -zs(zm, nz - 1, nz) * torch.ones_like(rho0)
        kbl = torch.full(rho0.shape, nz, dtype=torch.int64, device=u.device)
        ghat = torch.zeros_like(u)

    # bottom diffusivity limits + no bottom ghat (verticalmixing :151-159)
    botm = li >= nz
    difm = torch.where(botm, c.VLIMIT_BOTTOM, difm)
    difs = torch.where(botm, c.DLIMIT_BOTTOM, difs)
    dift = torch.where(botm, c.DLIMIT_BOTTOM, dift)
    ghat = torch.where(li == nz, 0.0, ghat)

    # ---- ocnint: backward-Euler solves (ocnint_mod :19-221) --------------
    row = li                               # row r = Fortran row r+1
    hm_sfc = zs(hm, 0, 1)
    # U / V with semi-implicit Coriolis (:44-72)
    cu_m, cc_m, cl_m = _tridcof(difm, tdn, tup, nz, row)
    rhs_u = uo + dto * f_cor * 0.5 * (vo + v)
    rhs_u = rhs_u + torch.where(row == 0, -dto * wu0x / hm_sfc, 0.0)
    difm_nz = zs(difm, nz, nz + 1)
    tdn_nz = zs(tdn, nz, nz + 1)
    rhs_u = rhs_u + torch.where(row == nz - 1,
                                tdn_nz * difm_nz * zs(uo, nz, nz + 1), 0.0)
    u_sol = _pcr_solve(cu_m, cc_m, cl_m, rhs_u, nz, row)
    rhs_v = vo - dto * f_cor * 0.5 * (uo + u_sol)
    rhs_v = rhs_v + torch.where(row == 0, -dto * wu0y / hm_sfc, 0.0)
    rhs_v = rhs_v + torch.where(row == nz - 1,
                                tdn_nz * difm_nz * zs(vo, nz, nz + 1), 0.0)
    v_sol = _pcr_solve(cu_m, cc_m, cl_m, rhs_v, nz, row)

    # temperature (:82-162)
    kmixe = kbl
    cu_t, cc_t, cl_t = _tridcof(dift, tdn, tup, nz, row)
    rhs_t = _tridrhs(hm, to, wxnt_t, dift, ghat, wx0t, wx0t, dto, tdn,
                     nz, row)
    fcorr = cs(CS_FCORRP)
    if flags.l_relax_sst and not flags.l_fcorr_withz and not flags.l_fcorr:
        relax_sst = cs(CS_RELAX_SST)
        sst0 = cs(CS_SST0)
        do_rlx = relax_sst > 1.0e-10
        dm_kmixe = ext(dm, kmixe)
        to_sfc = zs(to, 0, 1)
        incr = dto * relax_sst * (sst0 - to_sfc) * dm_kmixe / hm_sfc
        if not flags.l_relax_calconly:
            rhs_t = rhs_t + torch.where((row == 0) & do_rlx, incr, 0.0)
        fcorr = torch.where(do_rlx,
                            relax_sst * (sst0 - to_sfc) * dm_kmixe
                            * rho0 * cp0, 0.0)
    if flags.l_fcorr and not flags.l_relax_sst and not flags.l_fcorr_withz:
        rhs_t = rhs_t + torch.where(
            row == 0, dto * cs(CS_FCORR2D) / (rho0 * cp0 * hm_sfc), 0.0)
    tinc = torch.zeros_like(u)
    if flags.l_fcorr_withz and not flags.l_fcorr:
        tinc = tinc + dto * fcorr_z / (rho * cp)
    if flags.l_relax_ocnt:
        tinc = tinc + dto * cs(CS_RELAX_OCNT) * (ocnt_clim - to)
    rhs_t = rhs_t + torch.where(li <= nz - 1, tinc, 0.0)
    ocntcorr = tinc * rho * cp / dto
    t_sol = _pcr_solve(cu_t, cc_t, cl_t, rhs_t, nz, row)

    # salinity (:164-219); wXNT(:,2) is identically zero in the reference
    cu_s, cc_s, cl_s = _tridcof(difs, tdn, tup, nz, row)
    rhs_s = _tridrhs(hm, so, torch.zeros_like(u), difs, ghat, wx0s, wx0s,
                     dto, tdn, nz, row)
    if flags.l_advect:
        rhs_s = rhs_s + (dto * 0.033) * _advect_total(
            colscal, dm, hm, kbl, li, nz, wz, adv_st)
    sinc = torch.zeros_like(u)
    if flags.l_sfcorr_withz:
        sinc = sinc + dto * sfcorr_z
    if flags.l_relax_sal:
        sinc = sinc + dto * cs(CS_RELAX_SAL) * (sal_clim - so)
    rhs_s = rhs_s + torch.where(li <= nz - 1, sinc, 0.0)
    scorr = sinc / dto
    s_sol = _pcr_solve(cu_s, cc_s, cl_s, rhs_s, nz, row)

    # compose solutions: level nz held at the old value (tridmat :134-159)
    def compose(sol, old):
        return torch.where(li < nz, sol, torch.where(li == nz, old, 0.0))

    u_n = compose(u_sol, uo)
    v_n = compose(v_sol, vo)
    t_n = compose(t_sol, to)
    s_n = compose(s_sol, so)
    kbl_f = kbl.to(dt)
    zcol = torch.zeros_like(hbl)

    if not full:
        # colout rows: 0=hmix, 1=kmix, 2=surface rho, 3=surface cp
        colout = torch.cat([hbl, kbl_f, rho0, cp0] + [zcol] * 4, dim=0)
        return (u_n, v_n, t_n, s_n, u, v, t, s, colout)

    uref_b = zs(uref, nz - 1, nz)
    vref_b = zs(vref, nz - 1, nz)
    colout = torch.cat(
        [hbl, kbl_f, rhoh2o, fcorr, wu0x, wu0y, wx0t, wx0s, wx0b,
         uref_b, vref_b, ustar] + [zcol] * 4, dim=0)
    return (u_n, v_n, t_n, s_n, colout, difm, difs, dift, ghat, rho, cp,
            alpha, beta, buoy, rig, dbloc, shsq, wxnt_t, swdk_opt,
            tinc, sinc, ocntcorr, scorr)


def _depth_prefix(hm, nz):
    """Inclusive prefix sum over rows of hm(r+1), the depth accumulator of
    the rhsmod mode-6/7 band walks (solvers.F90:292-331), in log-depth
    doubling order.  Grid-only; the CUDA kernels take it as an input so
    that its rounding, which decides band edges, is the same."""
    wz = hm.shape[0]
    li = torch.arange(wz, device=hm.device)[:, None]
    pfx = torch.where(li < nz, _shl(hm, 1), 0.0)
    stp = 1
    while stp < wz:
        pfx = pfx + _shr(pfx, stp)
        stp *= 2
    return pfx


def _advect_total(colscal, dm, hm, kbl, li, nz, wz, adv_st):
    """Steady advection corrections of the salinity RHS, summed over
    rhsmod modes 1-7 (solvers.F90:176-335; ocnint applies them only to
    the salinity scalar, mckpp_physics_ocnint_mod.F90:179-184).  km is this
    pass's kbl.  Each mode's level basis is a row-masked profile;
    per-column magnitudes arrive pre-grouped by mode in colscal rows
    CS_ADV1..7."""
    row = li
    rows_nz = row < nz
    km = kbl
    ext = lambda v_, idx: _ext(v_, idx, li)
    dm_km = ext(dm, km)
    hm_km = ext(hm, km - 1)
    hm_km1 = ext(hm, km - 2)
    pfx = _depth_prefix(hm, nz)
    bigr = wz + 100

    def band_basis(in_walk, depth, target):
        hit = in_walk & rows_nz & (depth >= target)
        fx = torch.where(hit, li, bigr).amin(dim=0, keepdim=True)
        n2r = torch.where(fx < bigr, fx, nz - 1)
        m = in_walk & rows_nz & (li <= n2r)
        delta = torch.where(m, hm, 0.0).sum(dim=0, keepdim=True)
        return torch.where(m, 1.0 / torch.where(delta > 0.0, delta, 1.0), 0.0)

    total = None
    for mode in range(1, 8):
        coef = colscal[CS_ADV1 + mode - 1:CS_ADV1 + mode]
        if mode == 1:                 # upper layer only
            basis = torch.where(row == 0, 1.0 / adv_st["hm1"], 0.0).to(hm.dtype)
        elif mode == 2:               # mixed layer 1..km-1
            m2 = rows_nz & (li <= km - 2)
            d2 = torch.where(m2, hm, 0.0).sum(dim=0, keepdim=True)
            basis = torch.where(m2, 1.0 / torch.where(d2 > 0.0, d2, 1.0), 0.0)
        elif mode == 3:               # whole column
            basis = torch.where(rows_nz, adv_st["inv_delta3"], 0.0).to(hm.dtype)
        elif mode == 4:               # below 100 m to nz-1 (static band)
            if adv_st["n1_4"] <= 0 or adv_st["delta4"] <= 0.0:
                continue
            m4 = (row >= adv_st["n1_4"] - 1) & (row <= nz - 2)
            basis = torch.where(m4, 1.0 / adv_st["delta4"], 0.0).to(hm.dtype)
        elif mode == 5:               # bottom-layer diffusion
            basis = torch.where(row == nz - 1, 1.0 / adv_st["hm_nz"],
                                0.0).to(hm.dtype)
        elif mode == 6:               # seasonal mixed layer
            depth6 = adv_st["hm1"] + pfx
            dmax6 = dm_km - 0.5 * (hm_km + hm_km1)
            basis = band_basis(rows_nz, depth6, dmax6)
        else:                         # mode 7: seasonal thermocline
            # km (=kbl) is always >= 2 here (the bldepth crossing search
            # starts at row 2), so clamp explicitly: at km==2 the walk
            # starts at the surface row with pfx_lo=0.  km<=2 is
            # ill-defined in the reference as well.
            km7 = torch.clamp_min(km, 2)
            in7 = li >= km7 - 2
            pfx_lo = torch.where(km7 >= 3, ext(pfx, km7 - 3), 0.0)
            depth7 = (dm_km - 0.5 * hm_km) + (pfx - pfx_lo)
            basis = band_basis(in7, depth7, 100.0)
        term = coef * basis
        total = term if total is None else total + term
    return total


@_either_layout
def _step_body(u0, v0, t0, s0, uo, vo, to, so, swdk_c, swfrac_c,
               ocnt_clim, sal_clim, fcorr_z, sfcorr_z, colscal,
               zm, hm, dm, tdn, tup, aref,
               *, nz, flags: PassFlags, dto, zbot, adv_st,
               itermax, hmixtolfrac, extra_iters, comp_iter_max,
               rmsd_thr, hm_bot, dm_nz):
    """The ocean step's whole iteration around the pass body: 3 compulsory
    passes, the per-column-masked hmix-convergence loop and the
    instability-trap outer loop (reference:
    mckpp_physics_ocnstep_mod.F90:122-236).  The loops run batch-wide with
    per-column masked updates, so each column's result equals a loop run
    for that column alone (what the CUDA step kernel does per thread).

    ``u0..s0`` are the extrapolated profiles.  colscal carries the
    per-column scalars incl. CS_ACTIVE (run_physics), CS_RHO0_IN/CS_CP0_IN
    (previous surface rho/cp) and CS_F (initial Coriolis; the trap's retry
    multiplies it per column).

    Returns (u, v, t, s, ux, vx, tx, sx, colstep) with colstep rows
    0=hmix, 1=kmix, 2=rho0, 3=cp0, 4=comp_flag, 5=reset_flag, 6=f_used,
    7=npass, the number of passes the column ran (the JAX body leaves
    row 7 zero; it measures the data-dependent work of the step).
    """
    wz = u0.shape[0]
    dt = u0.dtype
    li = torch.arange(wz, device=u0.device)[:, None]
    cs = lambda k: colscal[k:k + 1, :]

    def pass_(u, v, t, s, ux, vx, tx, sx, f_row):
        # f is threaded as an explicit override (the trap's retry
        # multiplies it per column), not by rewriting the colscal row
        return _pass_body(u, v, t, s, ux, vx, tx, sx, uo, vo, to, so,
                          swdk_c, swfrac_c, ocnt_clim, sal_clim, fcorr_z,
                          sfcorr_z, colscal, zm, hm, dm, tdn, tup, aref,
                          nz=nz, flags=flags, dto=dto, full=False,
                          zbot=zbot, adv_st=adv_st, f_row=f_row)

    active = cs(CS_ACTIVE) > 0.5
    m = lambda mask, a, b: torch.where(mask, a, b)

    def integrate(f_local):
        """One full semi-implicit integration attempt (ocnstep:103-192)."""
        u, v, t, s = u0, v0, t0, s0
        ux, vx, tx, sx = u0, v0, t0, s0
        for _ in range(3):            # compulsory passes (:122-135)
            u, v, t, s, ux, vx, tx, sx, colout = pass_(
                u, v, t, s, ux, vx, tx, sx, f_local)
        hmixn, kmixn = colout[0:1], colout[1:2]
        rho0, cp0 = colout[2:3], colout[3:4]
        npass = torch.full_like(hmixn, 3.0)
        if not flags.lkpp:
            return (u, v, t, s, ux, vx, tx, sx, hmixn, kmixn, rho0, cp0,
                    npass)
        hmixe, kmixe = hmixn, kmixn
        it = torch.full_like(hmixn, 3.0)
        iconv = torch.zeros_like(hmixn)
        cont = active.clone()
        while bool(cont.any()):
            (u_n, v_n, t_n, s_n, ux_n, vx_n, tx_n, sx_n,
             colout) = pass_(u, v, t, s, ux, vx, tx, sx, f_local)
            hmix_p, kmix_p = colout[0:1], colout[1:2]
            rho0_p, cp0_p = colout[2:3], colout[3:4]
            it_n = it + 1.0
            kidx = kmix_p.to(torch.int64)
            tol = hmixtolfrac * torch.where(
                kidx == nz + 1, hm_bot,
                _ext(hm, torch.clamp(kidx - 1, 0, nz), li))
            iconv_n = torch.where(torch.abs(hmix_p - hmixe) > tol,
                                  0.0, iconv + 1.0)
            cont_n = ((iconv_n < 3.0)
                      & ((it_n < itermax) | (hmix_p > hmixe))
                      & (it_n < itermax + extra_iters) & active)
            hmixe_n = m(cont_n, hmix_p, hmixe)
            kmixe_n = m(cont_n, kmix_p, kmixe)
            u, v = m(cont, u_n, u), m(cont, v_n, v)
            t, s = m(cont, t_n, t), m(cont, s_n, s)
            ux, vx = m(cont, ux_n, ux), m(cont, vx_n, vx)
            tx, sx = m(cont, tx_n, tx), m(cont, sx_n, sx)
            hmixe, kmixe = m(cont, hmixe_n, hmixe), m(cont, kmixe_n, kmixe)
            hmixn, kmixn = m(cont, hmix_p, hmixn), m(cont, kmix_p, kmixn)
            rho0, cp0 = m(cont, rho0_p, rho0), m(cont, cp0_p, cp0)
            it, iconv = m(cont, it_n, it), m(cont, iconv_n, iconv)
            npass = npass + cont.to(dt)
            cont = cont & cont_n
        return u, v, t, s, ux, vx, tx, sx, hmixn, kmixn, rho0, cp0, npass

    # ---- instability trap (ocnstep:89, :194-236) -------------------------
    w_rms = torch.where(li <= nz, hm / dm_nz, 0.0)

    def instability(u, v, t, s):
        lvl = li < nz                     # levels 1..nz
        dxv = torch.abs(t - _shl(t, 1))
        bad = lvl & ((torch.abs(u) >= 10.0) | (torch.abs(v) >= 10.0)
                     | (dxv >= 10.0))
        nbad = bad.to(dt).sum(dim=0, keepdim=True)
        blown = nbad > 0.5

        def rmsd(q, qo):
            d = q - qo
            return torch.sqrt((d * d * w_rms).sum(dim=0, keepdim=True))

        ex = [rmsd(u, uo) >= rmsd_thr[0], rmsd(v, vo) >= rmsd_thr[1],
              rmsd(t, to) >= rmsd_thr[2], rmsd(s, so) >= rmsd_thr[3]]
        exf = sum(e.to(dt) for e in ex)
        nexceed = torch.where(blown, 0.0, exf)
        comp = blown | ex[0] | ex[1] | ex[2] | ex[3]
        fmul = torch.pow(torch.tensor(1.01, dtype=dt, device=u.device),
                         nbad + nexceed)
        return comp, fmul

    f0 = cs(CS_F)
    zer = torch.zeros_like(f0)
    u, v, t, s = u0, v0, t0, s0
    ux, vx, tx, sx = u0, v0, t0, s0
    comp = torch.ones_like(f0, dtype=torch.bool)
    reset, f_local = zer, f0
    hmixn, kmixn = zer, torch.full_like(f0, float(nz))
    f_used, rho0, cp0 = f0, cs(CS_RHO0_IN), cs(CS_CP0_IN)
    npass = zer
    while True:
        pred = comp & (reset <= float(comp_iter_max)) & active
        if not bool(pred.any()):
            break
        res = integrate(f_local)
        (u_i, v_i, t_i, s_i, ux_i, vx_i, tx_i, sx_i,
         hmix_i, kmix_i, rho0_i, cp0_i, npass_i) = res
        comp_n, fmul = instability(u_i, v_i, t_i, s_i)
        f_n = f_local * torch.where(comp_n, fmul, 1.0)
        # f_used records the f the surviving attempt actually used (the
        # reference multiplies f AFTER integration, ocnstep:205,224)
        u, v = m(pred, u_i, u), m(pred, v_i, v)
        t, s = m(pred, t_i, t), m(pred, s_i, s)
        ux, vx = m(pred, ux_i, ux), m(pred, vx_i, vx)
        tx, sx = m(pred, tx_i, tx), m(pred, sx_i, sx)
        comp = m(pred, comp_n, comp)
        f_used = m(pred, f_local, f_used)
        reset = m(pred, reset + 1.0, reset)
        f_local = m(pred, f_n, f_local)
        hmixn, kmixn = m(pred, hmix_i, hmixn), m(pred, kmix_i, kmixn)
        rho0, cp0 = m(pred, rho0_i, rho0), m(pred, cp0_i, cp0)
        npass = m(pred, npass + npass_i, npass)
    colstep = torch.cat([hmixn, kmixn, rho0, cp0, comp.to(dt), reset,
                         f_used, npass], dim=0)
    return u, v, t, s, ux, vx, tx, sx, colstep


def _statics(grid, flags: PassFlags):
    zm_np = grid.zm.detach().cpu().numpy()
    adv_st = (advection_statics(zm_np, grid.hm.detach().cpu().numpy())
              if flags.l_advect else None)
    return adv_st, float(zm_np[grid.nz])


def make_fused_pass(grid, dtype, flags: PassFlags, dto: float, *,
                    full: bool, impl: str = "eager", zaxis: int = 0):
    """Build the pass callable fn(*25 inputs) -> tuple of outputs; the
    inputs are (u, v, t, s, ux, vx, tx, sx, uo, vo, to, so, swdk, swfrac,
    ocnt_clim, sal_clim, fcorr_z, sfcorr_z, colscal, zm, hm, dm, tdn, tup,
    aref) in the layout ``zaxis`` of the module docstring.  Forcing
    profiles may be ``(WZ, 1)`` (``zaxis=1``: ``(1, WZ)``) dummies when
    their flag is off.  The default ``zaxis=0`` differs from the JAX
    package's default of 1: it is the layout of the port's default
    ``pass_layout``, "col_lanes", as of the JAX package's config.

    impl: "eager" (the plain body) | "cuda" (the CUDA kernel for CUDA
    tensors, the plain body for CPU tensors).
    """
    adv_st, zbot = _statics(grid, flags)
    kw = dict(nz=grid.nz, flags=flags, dto=dto, full=full, zbot=zbot,
              adv_st=adv_st, zaxis=zaxis)
    if impl == "eager":
        return lambda *a: _pass_body(*a, **kw)
    if impl == "cuda":
        from . import cuda_kernels
        return cuda_kernels.FusedPass(kw)
    raise ValueError(f"unknown pass impl {impl!r}")


def make_fused_step(grid, dtype, flags: PassFlags, dto: float, *,
                    itermax: int, hmixtolfrac: float, extra_iters: int,
                    impl: str = "eager", zaxis: int = 0):
    """Build the whole-step callable (see :func:`_step_body`):
    fn(*21 inputs) -> (u, v, t, s, ux, vx, tx, sx, colstep); the inputs are
    (u0, v0, t0, s0, uo, vo, to, so, swdk, swfrac, ocnt_clim, sal_clim,
    fcorr_z, sfcorr_z, colscal, zm, hm, dm, tdn, tup, aref); the keyword
    ``mask``, the columns' active flags, lets the kernel's blocks take the
    ocean columns first (``cuda_kernels.FusedStep``; the plain body
    ignores it).

    impl, zaxis: as in :func:`make_fused_pass`.
    """
    adv_st, zbot = _statics(grid, flags)
    nz = grid.nz
    kw = dict(nz=nz, flags=flags, dto=dto, zbot=zbot, adv_st=adv_st,
              itermax=itermax, hmixtolfrac=hmixtolfrac,
              extra_iters=extra_iters, comp_iter_max=int(c.COMP_ITER_MAX),
              rmsd_thr=tuple(float(x) for x in c.RMSD_THRESHOLD),
              hm_bot=float(grid.hm[nz - 1]), dm_nz=float(grid.dm[nz]),
              zaxis=zaxis)
    if impl == "eager":
        return lambda *a, mask=None: _step_body(*a, **kw)
    if impl == "cuda":
        from . import cuda_kernels
        return cuda_kernels.FusedStep(kw)
    raise ValueError(f"unknown step impl {impl!r}")
