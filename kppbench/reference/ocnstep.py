# Frozen copy of mckpp_torch/ops/ocnstep.py at commit a49d027: part of the
# benchmark's plain reference, which imports nothing of the program.
"""The reference ocean step: semi-implicit iteration with under-relaxation,
mixed-layer-depth convergence and the computational-instability trap
(counterpart of ``mckpp_tpu/ops/ocnstep.py``; reference:
mckpp_physics_ocnstep_mod.F90:43-357):

* extrapolate the new profiles from the two-level history (:91-112);
* 3 compulsory smoothed iterations (lambda = 0.5) of
  {vertical mixing -> implicit integration} (:122-135);
* iterate until the boundary-layer depth converges within
  ``hmixtolfrac * hm(kmix)`` on 3 consecutive passes (iconv >= 3), up to
  itermax, continuing past itermax only while hmix deepens, at most
  ``extra_iters`` more passes (:140-192);
* instability trap: if any |U| >= 10, |dT| >= 10 or the depth-weighted RMS
  difference from the old profiles reaches its threshold, perturb the
  Coriolis term by 1.01 per offending check and retry (<= COMP_ITER_MAX
  times) (:200-236);
* diagnostic fluxes, optional current damping and the old/new history
  ping-pong (:242-353).

The JAX package vmaps a per-column ``lax.while_loop``; here the columns
are a batch axis and each loop runs while any column's predicate holds,
keeping the carry of every column whose own predicate was already false
(a masked select decided before the body).  Every operation is per
column, so a column's result does not depend on its neighbours.  The
loops read their predicates on the host, once per iteration.  It runs on
the model's device as plain torch and launches no CUDA kernel of this
package.
"""

from __future__ import annotations

import torch

from . import constants as c
from .config import KppConfig
from .state import ColumnParams, Forcing, State, select
from .ocnint import ocnint
from .vmix import vmix


def apply_vmix(st: State, vm) -> State:
    """The state with a vmix result's fields, the surface fluxes in row 0
    of wu/wx."""
    wu, wx = st.wu.clone(), st.wx.clone()
    wu[:, 0] = vm.wu0
    wx[:, 0] = vm.wx0
    return st.replace(
        rho=vm.rho, cp=vm.cp, talpha=vm.talpha, sbeta=vm.sbeta,
        buoy=vm.buoy, rhoh2o=vm.rhoh2o, difm=vm.difm, difs=vm.difs,
        dift=vm.dift, ghat=vm.ghat, rig=vm.rig, dbloc=vm.dbloc,
        shsq=vm.shsq, wu=wu, wx=wx, wxnt=vm.wxnt, swdk_opt=vm.swdk_opt,
        uref=vm.uref, vref=vm.vref)


def interior_fluxes(st: State, grid, ldd: bool, grav: float):
    """The diagnostic turbulent fluxes on the interior interfaces
    (reference ocnstep :242-256, initialize_ocean :66-81): (wu, wx) with
    rows 1..nz from the state's profiles and coefficients, row 0 (the
    surface fluxes) as the state holds it."""
    nz = grid.nz
    hm = grid.hm
    u, x = st.u, st.x
    deltaz = 0.5 * (hm[:nz] + hm[1:])
    dif_x = st.dift if ldd else st.difs
    wx0 = st.wx[:, 0]
    wx1 = -dif_x[:, 1:nz + 1] * ((x[:, :nz, 0] - x[:, 1:, 0]) / deltaz
                                 - st.ghat[:, 1:] * wx0[:, 0:1])
    wx2 = -st.difs[:, 1:nz + 1] * ((x[:, :nz, 1] - x[:, 1:, 1]) / deltaz
                                   - st.ghat[:, 1:] * wx0[:, 1:2])
    wxb = grav * (st.talpha[:, :nz] * wx1 - st.sbeta[:, :nz] * wx2)
    wu1 = -st.difm[:, 1:nz + 1] * (u[:, :nz, 0] - u[:, 1:, 0]) / deltaz
    wu2 = -st.difm[:, 1:nz + 1] * (u[:, :nz, 1] - u[:, 1:, 1]) / deltaz
    wx, wu = st.wx.clone(), st.wu.clone()
    wx[:, 1:, 0], wx[:, 1:, 1], wx[:, 1:, 2] = wx1, wx2, wxb
    wu[:, 1:, 0], wu[:, 1:, 1] = wu1, wu2
    return wu, wx


def _phase(a, ph):
    """a[..., ph[col]] of a (ncol, ..., 2) history tensor."""
    m = (ph == 1).reshape(ph.shape + (1,) * (a.dim() - 2))
    return torch.where(m, a[..., 1], a[..., 0])


def ocnstep(stt: State, prm: ColumnParams, frc: Forcing, grid,
            cfg: KppConfig, first_step: bool, active, *, tables=None,
            wscale_mode=None):
    """Advance every column by one ocean timestep.

    ``active`` (ncol,) bool gates the loops so that land columns cannot
    spin; ``tables=(wmt, wst)`` selects the resident-table velocity scale,
    ``None`` the nodal form.  Returns (new_state, comp_flag): comp_flag
    True means the integration failed to stabilise and check_profile
    should reset the column.

    Benchmark copy: ``wscale_mode`` names the velocity-scale form of the
    step's passes (None: the port's choice, "nodal" or "table"), and the
    result carries a third value, the passes each column ran, summed over
    its integration attempts as the kernels' ``colstep`` row 7 counts
    them.
    """
    ph = cfg.physics
    b, fo = cfg.boundary, cfg.forcing
    dto = cfg.time.dto
    nz = grid.nz
    nzp1 = nz + 1
    dtype, dev = grid.zm.dtype, grid.zm.device
    ncol = stt.u.shape[0]
    lam = c.LAMBDA_SMOOTH
    if wscale_mode is None:
        wscale_mode = "nodal" if tables is None else "table"
    hm = grid.hm

    uo, xo = stt.u, stt.x

    # repair out-of-range history phase (reference :93-102)
    old = torch.where((stt.old < 0) | (stt.old > 1), stt.new, stt.old)
    new = torch.where((stt.new < 0) | (stt.new > 1), old, stt.new)
    zero = torch.zeros((ncol,), dtype=dtype, device=dev)
    stt = stt.replace(old=old, new=new, reset_flag=zero, dampu_flag=zero,
                      dampv_flag=zero)

    def run_vmix(st: State):
        return vmix(st.u, st.x, frc.sflux, st.ssurf, prm.sref, prm.jerlov,
                    prm.f, prm.ocdepth, False, st.swdk_opt, st.swfrac,
                    st.wxnt, first_step, grid, lri=ph.lri, ldd=ph.ldd,
                    lkpp=ph.lkpp, cst=cfg.constants,
                    wscale_mode=wscale_mode, tables=tables)

    def run_ocnint(st: State, f_local, kmixe):
        oi = ocnint(st.u, st.x, uo, xo, f_local, kmixe,
                    st.difm, st.difs, st.dift, st.ghat, st.wxnt,
                    st.wu[:, 0], st.wx[:, 0], st.rho, st.cp,
                    frc.sst0, frc.fcorr_twod, frc.fcorr_withz,
                    frc.sfcorr_withz, frc.ocnt_clim, frc.sal_clim,
                    prm.relax_sst, prm.relax_ocnt, prm.relax_sal, st.fcorr,
                    prm.nmodeadv, prm.modeadv, prm.advection, grid, dto,
                    l_relax_sst=b.l_relax_sst,
                    l_relax_calconly=b.l_relax_calconly,
                    l_fcorr=fo.l_fcorr, l_fcorr_withz=fo.l_fcorr_withz,
                    l_sfcorr_withz=fo.l_sfcorr_withz,
                    l_relax_sal=b.l_relax_sal, l_relax_ocnt=b.l_relax_ocnt,
                    l_advect=b.l_advect, solver=ph.solver)
        return st.replace(u=oi.u, x=oi.x, tinc_fcorr=oi.tinc_fcorr,
                          sinc_fcorr=oi.sinc_fcorr, ocntcorr=oi.ocntcorr,
                          scorr=oi.scorr, fcorr=oi.fcorr)

    def one_pass(st, ux, xx, f_local):
        """Under-relax, then vmix + ocnint (reference :122-135 body)."""
        u = lam * ux + (1.0 - lam) * st.u
        x = lam * xx + (1.0 - lam) * st.x
        st = st.replace(u=u, x=x)
        vm = run_vmix(st)
        st = apply_vmix(st, vm)
        st = run_ocnint(st, f_local, vm.kbl)
        return st, u, x, vm.hbl, vm.kbl

    # extrapolation from the two-level history (:103-111)
    u_ex = 2.0 * _phase(stt.us, new) - _phase(stt.us, old)
    x_ex = 2.0 * _phase(stt.xs, new) - _phase(stt.xs, old)

    def integrate(st0: State, f_local):
        """One full semi-implicit integration attempt."""
        st = st0.replace(u=u_ex, x=x_ex)
        ux, xx = u_ex, x_ex
        for _ in range(3):              # compulsory iterations (:122-135)
            st, ux, xx, hmixe, kmixe = one_pass(st, ux, xx, f_local)
        hmixn, kmixn = hmixe, kmixe
        npass = torch.full((ncol,), 3.0, dtype=dtype, device=dev)
        if not ph.lkpp:
            return st, hmixn, kmixn, npass
        # hmix convergence loop (:140-192)
        it = torch.full((ncol,), 3, dtype=torch.int32, device=dev)
        iconv = torch.zeros((ncol,), dtype=torch.int32, device=dev)
        cont = active.clone()
        while bool(cont.any()):
            st_n, ux_n, xx_n, hmix_p, kmix_p = one_pass(st, ux, xx, f_local)
            it_n = it + 1
            tol = ph.hmixtolfrac * torch.where(
                kmix_p == nzp1, hm[nz - 1], hm[kmix_p.long() - 1])
            iconv_n = torch.where(torch.abs(hmix_p - hmixe) > tol, 0,
                                  iconv + 1).to(torch.int32)
            cont_n = ((iconv_n < 3)
                      & ((it_n < ph.itermax) | (hmix_p > hmixe))
                      & (it_n < ph.itermax + ph.extra_iters) & active)
            m = lambda a, b: select(cont, a, b)
            st, ux, xx = m(st_n, st), m(ux_n, ux), m(xx_n, xx)
            hmixe = m(torch.where(cont_n, hmix_p, hmixe), hmixe)
            kmixe = m(torch.where(cont_n, kmix_p, kmixe), kmixe)
            hmixn, kmixn = m(hmix_p, hmixn), m(kmix_p, kmixn)
            it, iconv = m(it_n, it), m(iconv_n, iconv)
            npass = npass + cont.to(dtype)
            cont = cont & cont_n
        return st, hmixn, kmixn, npass

    # ---- instability trap (outer retry loop, :89 & :194-236) -------------
    w = hm / grid.dm[nz]                        # hm(k)/dm(NZ)
    thr = torch.tensor(c.RMSD_THRESHOLD, dtype=dtype, device=dev)

    def instability(st):
        du = torch.abs(st.u[:, :nz, :])         # levels 1..nz
        dx = torch.abs(st.x[:, :nz, 0] - st.x[:, 1:, 0])
        bad = (du[..., 0] >= 10.0) | (du[..., 1] >= 10.0) | (dx >= 10.0)
        nbad = bad.sum(dim=1)
        blown = bad.any(dim=1)
        rmsd = torch.sqrt(torch.stack([
            ((st.u[..., 0] - uo[..., 0]) ** 2 * w).sum(dim=1),
            ((st.u[..., 1] - uo[..., 1]) ** 2 * w).sum(dim=1),
            ((st.x[..., 0] - xo[..., 0]) ** 2 * w).sum(dim=1),
            ((st.x[..., 1] - xo[..., 1]) ** 2 * w).sum(dim=1)], dim=1))
        exceed = rmsd >= thr
        nexceed = torch.where(blown, 0, exceed.sum(dim=1))
        comp = blown | (~blown & exceed.any(dim=1))
        # f is multiplied by 1.01 once per offending level/metric
        fmul = 1.01 ** (nbad + nexceed).to(dtype)
        return comp, fmul

    st, f_local = stt, prm.f
    comp = torch.ones((ncol,), dtype=torch.bool, device=dev)
    reset, hmixn = zero, zero
    kmixn = torch.full((ncol,), nz, dtype=torch.int32, device=dev)
    npass = zero
    while True:
        pred = comp & (reset <= float(c.COMP_ITER_MAX)) & active
        if not bool(pred.any()):
            break
        st_i, hmix_i, kmix_i, npass_i = integrate(st, f_local)
        comp_i, fmul = instability(st_i)
        m = lambda a, b: select(pred, a, b)
        st = m(st_i, st)
        f_local = m(f_local * torch.where(comp_i, fmul, 1.0), f_local)
        comp = m(comp_i, comp)
        reset = m(reset + 1.0, reset)
        hmixn, kmixn = m(hmix_i, hmixn), m(kmix_i, kmixn)
        npass = m(npass + npass_i, npass)

    # ---- diagnostic fluxes (:242-256) ------------------------------------
    u, x = st.u, st.x
    wu, wx = interior_fluxes(st, grid, ph.ldd, cfg.constants.grav)

    # ---- surface references (:305-314) -----------------------------------
    ssurf = prm.ssref if ph.l_ssref else x[:, 0, 1] + prm.sref
    dampu_flag, dampv_flag = st.dampu_flag, st.dampv_flag

    # ---- current damping (:317-340) --------------------------------------
    if fo.l_damp_curr:
        r = fo.dtuvdamp * (86400.0 / dto)
        a = 0.99 * torch.abs(u)
        bb = u * u / r
        ui = torch.minimum(a, bb)
        frac = (bb < a).to(dtype).sum(dim=1) / float(nzp1)
        u = u - torch.sign(u) * ui
        dampu_flag, dampv_flag = frac[:, 0], frac[:, 1]

    # ---- history ping-pong (:343-353) ------------------------------------
    old2 = new
    new2 = 1 - old2
    at1 = (new2 == 1)

    def put(hist, val):
        m = at1.reshape(at1.shape + (1,) * (val.dim() - 1))
        return torch.stack([torch.where(m, hist[..., 0], val),
                            torch.where(m, val, hist[..., 1])], dim=-1)

    st = st.replace(
        u=u, x=x, us=put(st.us, u), xs=put(st.xs, x),
        hmixd=put(st.hmixd, hmixn), old=old2, new=new2,
        hmix=hmixn, kmix=kmixn, wu=wu, wx=wx,
        uref=u[:, 0, 0], vref=u[:, 0, 1], tref=x[:, 0, 0],
        ssurf=ssurf.to(dtype), reset_flag=reset,
        dampu_flag=dampu_flag, dampv_flag=dampv_flag)
    return st, comp, npass
