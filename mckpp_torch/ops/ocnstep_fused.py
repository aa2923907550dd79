"""Batched ocean step built on the fused pass (counterpart of
``mckpp_tpu/ops/ocnstep_fused.py``; reference:
mckpp_physics_ocnstep_mod.F90:43-357).

Loop structure (mirroring the reference):

* extrapolate from the two-level history (:91-112);
* 3 compulsory smoothed passes (:122-135);
* hmix convergence loop, per-column masked (:140-192);
* instability-trap outer loop, per-column masked (:200-236);
* one extra *full* pass re-running each column's final pass from its saved
  inputs to materialize the diagnostic fields (difm/dift/difs, ghat, rho,
  cp, Rig, corrections, ...);
* diagnostic fluxes, damping, history ping-pong (:242-353).

``impl`` ending in "_step" runs the whole iteration in one call of the
step body (``fused_pass.make_fused_step``); the other impls run the
batch-level loops here around one pass call per iteration.  Both give the
same per-column results.  The state stays ``(ncol, ...)`` outside the
pass.  ``pass_layout`` picks the kernels' layout (``zaxis``, as the JAX
glue does): "col_lanes" transposes the profiles to ``(WZ, ncol)`` once
per step and the outputs back; "z_lanes" hands the kernels the state's
own ``(ncol, WZ)`` order, padded, and transposes nothing.  Both give the
same results bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as c
from ..config import KppConfig
from ..state import ColumnParams, Forcing, State, select
from . import fused_pass as fp
from . import step_glue as sg
from .overrides import finish_step
from .swfrac import jerlov_coeffs


def pass_flags(cfg: KppConfig) -> fp.PassFlags:
    ph, b, f, cst = cfg.physics, cfg.boundary, cfg.forcing, cfg.constants
    return fp.PassFlags(
        lri=ph.lri, ldd=ph.ldd, lkpp=ph.lkpp,
        l_relax_sst=b.l_relax_sst, l_relax_calconly=b.l_relax_calconly,
        l_fcorr=f.l_fcorr, l_fcorr_withz=f.l_fcorr_withz,
        l_sfcorr_withz=f.l_sfcorr_withz, l_relax_sal=b.l_relax_sal,
        l_relax_ocnt=b.l_relax_ocnt, l_advect=b.l_advect,
        wscale=ph.wscale_mode,
        grav=cst.grav, vonk=cst.vonk, sice=cst.sice)


def make_ocnstep_fused(grid, cfg: KppConfig, dtype, *, impl="eager_step"):
    """Build step_fn(st, prm, frc, first_step, with_diags, passes) -> the
    next State, ``overrides.finish_step`` included.  impl: "eager" |
    "eager_step" | "cuda" | "cuda_step".  ``passes``, where given, is a
    ``(ncol,)`` tensor to which a whole-step impl adds the passes each
    column ran (the step's colstep row 7) in place, on the device."""
    whole_step = impl.endswith("_step")
    base_impl = impl[:-len("_step")] if whole_step else impl
    if base_impl not in ("eager", "cuda"):
        raise ValueError(f"unknown step impl {impl!r}")
    ph = cfg.physics
    nz = grid.nz
    nzp1 = nz + 1
    wz = nz + 2
    dto = cfg.time.dto
    flags = pass_flags(cfg)
    dev = grid.zm.device
    # the kernels' layout (mckpp_tpu/ops/ocnstep_fused.py:87)
    zaxis = 0 if ph.pass_layout == "col_lanes" else 1

    # grid rows: hm padding row set to 1 to keep divisions finite
    zm_np = np.pad(grid.zm.cpu().numpy(), (0, 1))
    hm_np = np.pad(grid.hm.cpu().numpy(), (0, 1), constant_values=1.0)
    dm_np = np.pad(grid.dm.cpu().numpy(), (0, 1))
    tdn_np = np.pad(grid.tri_dn.cpu().numpy(), (0, 1))
    tup_np = np.pad(grid.tri_up.cpu().numpy(), (0, 1))
    # kernel-layout grid rows: (WZ, 1), or (1, WZ) for zaxis 1
    orient = (lambda a: a[None, :]) if zaxis else (lambda a: a[:, None])
    col = lambda a: orient(torch.as_tensor(a, dtype=dtype, device=dev))
    zm_r, hm_r, dm_r = col(zm_np), col(hm_np), col(dm_np)
    tdn_r, tup_r = col(tdn_np), col(tup_np)
    hm_row = hm_r if zaxis else hm_r.T               # (1, WZ) batch layout
    aref_np = fp.build_ref_matrix(zm_np[:nzp1], wz)
    aref = torch.as_tensor(aref_np if zaxis else aref_np.T, dtype=dtype,
                           device=dev).contiguous()
    hm_lvl = grid.hm.to(dtype)
    thr = torch.tensor(c.RMSD_THRESHOLD, dtype=dtype, device=dev)

    fast = (fp.make_fused_pass(grid, dtype, flags, dto, full=False,
                               impl=base_impl, zaxis=zaxis)
            if not whole_step else None)
    fullp = fp.make_fused_pass(grid, dtype, flags, dto, full=True,
                               impl=base_impl, zaxis=zaxis)
    fstep = (fp.make_fused_step(
        grid, dtype, flags, dto, itermax=ph.itermax,
        hmixtolfrac=ph.hmixtolfrac, extra_iters=ph.extra_iters,
        impl=base_impl, zaxis=zaxis) if whole_step else None)
    glue_in, glue_out = sg.make_glue(grid, cfg, impl=base_impl, zaxis=zaxis)

    def tok(a):
        """(ncol, nzp1) batch profile -> the kernel layout: (WZ, ncol) for
        zaxis 0, (ncol, WZ), padded only, for 1."""
        p = torch.nn.functional.pad(a, (0, wz - a.shape[1]))
        return p if zaxis else p.T.contiguous()

    # kernel layout -> batch (ncol, WZ), a column output's row k, and the
    # z shift of the kernel layout
    tob = (lambda a: a) if zaxis else (lambda a: a.T)
    co = (lambda c_, k: c_[:, k]) if zaxis else (lambda c_, k: c_[k])
    kshl = lambda a, s: fp._shl(a, s, dim=zaxis)

    def step_fn(st: State, prm: ColumnParams, frc: Forcing, first_step,
                with_diags: bool = True, passes=None):
        """``with_diags=False`` skips the final materialization pass: the
        prognostic trajectory (u, x, history, hmix, surface rho/cp for the
        next ntflux) is the same, but the wide diagnostic fields keep
        their previous values."""
        ncol = st.u.shape[0]
        active = prm.run_physics
        mcol = lambda mask, a, b: torch.where(
            mask if a.dim() == 1 else
            (mask[:, None] if zaxis else mask[None, :]), a, b)

        # ---- history-phase repair + extrapolation (:91-112) --------------
        (u_e, v_e, t_e, s_e, uo, vo, to, so, swdk_c, swfrac_c) = glue_in(
            st.us, st.xs, st.u, st.x, st.swdk_opt, st.swfrac, st.old,
            st.new)

        one = torch.ones((ncol,), dtype=dtype, device=dev)
        zero = torch.zeros((ncol,), dtype=dtype, device=dev)
        first_v = one if first_step else zero
        rfac, a1j, a2j = jerlov_coeffs(prm.jerlov, zero)

        if flags.l_advect:
            # group per-column advection magnitudes by rhsmod mode (the
            # salinity scalar's entries only, ocnint_mod.F90:179-184):
            # coef_m = sum over active entries im with modeadv(im,2)==m
            nm_s = prm.nmodeadv[:, 1]
            adv_coef = []
            for mode in range(1, 8):
                cm = torch.zeros((ncol,), dtype=dtype, device=dev)
                for im in range(prm.modeadv.shape[1]):
                    act = (im < nm_s) & (prm.modeadv[:, im, 1] == mode)
                    cm = cm + torch.where(
                        act, prm.advection[:, im, 1].to(dtype), 0.0)
                adv_coef.append(cm)
        else:
            adv_coef = [zero] * 7

        def colscal_of(f_local):
            cols = [frc.sflux[:, k] for k in range(6)]
            cols += [st.ssurf, prm.sref, f_local, prm.ocdepth,
                     rfac, a1j, a2j, first_v,
                     prm.relax_sst, frc.sst0, frc.fcorr_twod,
                     prm.relax_ocnt, prm.relax_sal, st.fcorr]
            cols += adv_coef
            # step rows (27-29): active mask + previous surface rho/cp
            cols += [prm.run_physics, st.rho[:, 0], st.cp[:, 0]]
            cols += [zero] * (fp.NSC - len(cols))
            return torch.stack([cc.to(dtype) for cc in cols], dim=zaxis)

        dummy = torch.zeros((1, wz) if zaxis else (wz, 1), dtype=dtype,
                            device=dev)
        ocnt_p = tok(frc.ocnt_clim) if flags.l_relax_ocnt else dummy
        sal_p = tok(frc.sal_clim) if flags.l_relax_sal else dummy
        fcz_p = tok(frc.fcorr_withz) if flags.l_fcorr_withz else dummy
        sfcz_p = tok(frc.sfcorr_withz) if flags.l_sfcorr_withz else dummy

        def run_pass(fn, u, v, t, s, ux, vx, tx, sx, csc):
            return fn(u, v, t, s, ux, vx, tx, sx, uo, vo, to, so,
                      swdk_c, swfrac_c, ocnt_p, sal_p, fcz_p, sfcz_p,
                      csc, zm_r, hm_r, dm_r, tdn_r, tup_r, aref)

        def integrate(f_local):
            """One full semi-implicit integration attempt (:103-192)."""
            csc = colscal_of(f_local)
            u, v, t, s = u_e, v_e, t_e, s_e
            ux, vx, tx, sx = u_e, v_e, t_e, s_e
            for _ in range(3):            # compulsory passes (:122-135)
                u, v, t, s, ux, vx, tx, sx, colout = run_pass(
                    fast, u, v, t, s, ux, vx, tx, sx, csc)
            hmixn = co(colout, 0)
            kmixn = co(colout, 1).to(torch.int32)
            rho0n, cp0n = co(colout, 2), co(colout, 3)
            if not ph.lkpp:
                return u, v, t, s, ux, vx, tx, sx, hmixn, kmixn, rho0n, cp0n
            hmixe, kmixe = hmixn, kmixn
            it = torch.full((ncol,), 3, dtype=torch.int32, device=dev)
            iconv = torch.zeros((ncol,), dtype=torch.int32, device=dev)
            cont = active.clone()
            while bool(cont.any()):
                (u_n, v_n, t_n, s_n, ux_n, vx_n, tx_n, sx_n,
                 colout) = run_pass(fast, u, v, t, s, ux, vx, tx, sx, csc)
                hmix_p = co(colout, 0)
                kmix_p = co(colout, 1).to(torch.int32)
                rho0_p, cp0_p = co(colout, 2), co(colout, 3)
                it_n = it + 1
                tol = ph.hmixtolfrac * torch.where(
                    kmix_p == nzp1, hm_lvl[nz - 1],
                    hm_lvl[torch.clamp(kmix_p - 1, 0, nz).long()])
                iconv_n = torch.where(torch.abs(hmix_p - hmixe) > tol,
                                      0, iconv + 1).to(torch.int32)
                cont_n = ((iconv_n < 3)
                          & ((it_n < ph.itermax) | (hmix_p > hmixe))
                          & (it_n < ph.itermax + ph.extra_iters) & active)
                hmixe_n = torch.where(cont_n, hmix_p, hmixe)
                kmixe_n = torch.where(cont_n, kmix_p, kmixe)
                m = lambda a, b: mcol(cont, a, b)
                u, v, t, s = m(u_n, u), m(v_n, v), m(t_n, t), m(s_n, s)
                ux, vx = m(ux_n, ux), m(vx_n, vx)
                tx, sx = m(tx_n, tx), m(sx_n, sx)
                hmixe, kmixe = m(hmixe_n, hmixe), m(kmixe_n, kmixe)
                hmixn, kmixn = m(hmix_p, hmixn), m(kmix_p, kmixn)
                rho0n, cp0n = m(rho0_p, rho0n), m(cp0_p, cp0n)
                it, iconv = m(it_n, it), m(iconv_n, iconv)
                cont = cont & cont_n
            return u, v, t, s, ux, vx, tx, sx, hmixn, kmixn, rho0n, cp0n

        # ---- instability trap (:89, :194-236) -----------------------------
        li_k = orient(torch.arange(wz, device=dev))
        w_rms = torch.where(li_k <= nz, hm_r / grid.dm[nz].to(dtype), 0.0)

        def instability(u, v, t, s):
            lvl = li_k < nz                     # levels 1..nz
            dxv = torch.abs(t - kshl(t, 1))
            bad = lvl & ((torch.abs(u) >= 10.0) | (torch.abs(v) >= 10.0)
                         | (dxv >= 10.0))
            nbad = bad.sum(dim=zaxis)
            blown = bad.any(dim=zaxis)

            def rmsd(q, qo):
                d = q - qo
                return torch.sqrt((d * d * w_rms).sum(dim=zaxis))

            exceed = torch.stack([rmsd(u, uo) >= thr[0],
                                  rmsd(v, vo) >= thr[1],
                                  rmsd(t, to) >= thr[2],
                                  rmsd(s, so) >= thr[3]], dim=1)
            nexceed = torch.where(blown, 0, exceed.sum(dim=1))
            comp = blown | exceed.any(dim=1)
            fmul = torch.pow(torch.tensor(1.01, dtype=dtype, device=dev),
                             (nbad + nexceed).to(dtype))
            return comp, fmul

        if whole_step:
            # one call runs the compulsory passes + both masked loops
            outs = fstep(u_e, v_e, t_e, s_e, uo, vo, to, so,
                         swdk_c, swfrac_c, ocnt_p, sal_p, fcz_p, sfcz_p,
                         colscal_of(prm.f), zm_r, hm_r, dm_r, tdn_r, tup_r,
                         aref, mask=prm.run_physics)
            u_fin_k, v_fin_k, t_fin_k, s_fin_k = outs[:4]
            ux_f, vx_f, tx_f, sx_f = outs[4:8]
            colstep = outs[8]
            hmixn = co(colstep, 0)
            kmixn = co(colstep, 1).to(torch.int32)
            rho0_fin, cp0_fin = co(colstep, 2), co(colstep, 3)
            comp_flag = co(colstep, 4) > 0.5
            reset_flag = co(colstep, 5)
            f_used = co(colstep, 6)
            if passes is not None:
                passes.add_(co(colstep, 7))
        else:
            u_fin_k, v_fin_k, t_fin_k, s_fin_k = u_e, v_e, t_e, s_e
            ux_f, vx_f, tx_f, sx_f = u_e, v_e, t_e, s_e
            comp_flag = torch.ones((ncol,), dtype=torch.bool, device=dev)
            reset_flag = zero
            f_local = prm.f
            hmixn = zero
            kmixn = torch.full((ncol,), nz, dtype=torch.int32, device=dev)
            f_used = prm.f
            rho0_fin, cp0_fin = st.rho[:, 0], st.cp[:, 0]
            while True:
                pred = (comp_flag & (reset_flag <= float(c.COMP_ITER_MAX))
                        & active)
                if not bool(pred.any()):
                    break
                res = integrate(f_local)
                u, v, t, s, ux, vx, tx, sx, hmix_i, kmix_i, rho0, cp0 = res
                comp_n, fmul = instability(u, v, t, s)
                f_n = f_local * torch.where(comp_n, fmul, 1.0)
                m = lambda a, b: mcol(pred, a, b)
                u_fin_k, v_fin_k = m(u, u_fin_k), m(v, v_fin_k)
                t_fin_k, s_fin_k = m(t, t_fin_k), m(s, s_fin_k)
                ux_f, vx_f = m(ux, ux_f), m(vx, vx_f)
                tx_f, sx_f = m(tx, tx_f), m(sx, sx_f)
                comp_flag = m(comp_n, comp_flag)
                # the reference multiplies f AFTER the integration
                # (ocnstep:205,224): the state kept was computed with the
                # pre-multiplication value, which the final full pass uses
                f_used = m(f_local, f_used)
                reset_flag = m(reset_flag + 1.0, reset_flag)
                f_local = m(f_n, f_local)
                hmixn, kmixn = m(hmix_i, hmixn), m(kmix_i, kmixn)
                rho0_fin, cp0_fin = m(rho0, rho0_fin), m(cp0, cp0_fin)

        if with_diags:
            # ---- final full pass: last pass + diagnostics ------------------
            outs = run_pass(fullp, ux_f, vx_f, tx_f, sx_f,
                            ux_f, vx_f, tx_f, sx_f, colscal_of(f_used))
            colout = outs[4]
            (u_p, v_p, t_p, s_p, difm, difs, dift, ghat, rho, cp,
             talpha, sbeta, buoy, rig, dbloc, shsq, wxnt_t, swdk_opt,
             tinc, sinc, ocntcorr, scorr) = [
                tob(a) for a in outs[:4] + outs[5:]]
            rhoh2o, fcorr = co(colout, 2), co(colout, 3)
            wu0x, wu0y = co(colout, 4), co(colout, 5)
            wx0t, wx0s, wx0b = co(colout, 6), co(colout, 7), co(colout, 8)

            # ---- diagnostic fluxes (:242-256); batch layout (ncol, wz) -----
            li = torch.arange(wz, device=dev)[None, :]
            intm = (li >= 1) & (li <= nz)
            # a shift down the levels of a (ncol, WZ) array: col_lanes'
            # outputs are transposed views, z_lanes' the arrays themselves
            shr1 = ((lambda a: fp._shr(a, 1, dim=1)) if zaxis
                    else (lambda a: fp._shr(a.T, 1).T))
            deltaz = 0.5 * (shr1(hm_row) + hm_row)       # interface i
            dz_safe = torch.where(intm, deltaz, 1.0)
            dif_x = dift if ph.ldd else difs
            wx1 = -dif_x * ((shr1(t_p) - t_p) / dz_safe
                            - ghat * wx0t[:, None])
            wx2 = -difs * ((shr1(s_p) - s_p) / dz_safe
                           - ghat * wx0s[:, None])
            wxb = flags.grav * (shr1(talpha) * wx1 - shr1(sbeta) * wx2)
            wu1 = -difm * (shr1(u_p) - u_p) / dz_safe
            wu2 = -difm * (shr1(v_p) - v_p) / dz_safe

            def iface(surface, interior):
                prof = torch.where(li == 0, surface[:, None],
                                   torch.where(intm, interior, 0.0))
                return prof[:, :nz + 1]

            wu = torch.stack([iface(wu0x, wu1), iface(wu0y, wu2)], dim=-1)
            wx = torch.stack([iface(wx0t, wx1), iface(wx0s, wx2),
                              iface(wx0b, wxb)], dim=-1)
            wxnt = st.wxnt.clone()
            wxnt[:, :, 0] = wxnt_t[:, :nz + 1]
            wide = dict(
                rho=rho[:, :nzp1], cp=cp[:, :nzp1], buoy=buoy[:, :nzp1],
                talpha=talpha[:, :nzp1], sbeta=sbeta[:, :nzp1],
                rhoh2o=rhoh2o,
                difm=difm[:, :nz + 2], difs=difs[:, :nz + 2],
                dift=dift[:, :nz + 2], ghat=ghat[:, :nz + 1],
                rig=rig[:, :nz + 1], dbloc=dbloc[:, :nz + 1],
                shsq=shsq[:, :nz + 1], wu=wu, wx=wx, wxnt=wxnt,
                swdk_opt=swdk_opt[:, :nz + 1],
                tinc_fcorr=tinc[:, :nzp1], sinc_fcorr=sinc[:, :nzp1],
                ocntcorr=ocntcorr[:, :nzp1], scorr=scorr[:, :nzp1],
                fcorr=fcorr)
            return epilogue(st, prm, frc, outs[:4], comp_flag, hmixn, kmixn,
                            reset_flag, None, wide, glue_out, grid=grid,
                            cfg=cfg, zaxis=zaxis)
        # prognostic-only: the loop's merged solve outputs ARE the final
        # state (the materialization pass reproduces them — the
        # under-relaxation is idempotent at its fixed point); the wide
        # diagnostic fields keep their previous values and the surface
        # rho/cp rows are refreshed from the loop, so the next flux
        # update's ntflux sees what the materialization pass would have
        # produced
        return epilogue(st, prm, frc, (u_fin_k, v_fin_k, t_fin_k, s_fin_k),
                        comp_flag, hmixn, kmixn, reset_flag,
                        (rho0_fin, cp0_fin), {}, glue_out, grid=grid,
                        cfg=cfg, zaxis=zaxis)

    return step_fn


def epilogue(st: State, prm: ColumnParams, frc: Forcing, q, comp_flag,
             hmixn, kmixn, reset_flag, row0, wide, glue_out, *, grid,
             cfg: KppConfig, zaxis):
    """The next State from the step's results (:242-353, then
    ``overrides.finish_step``): ``q`` the final u, v, T, S in the kernels'
    layout; ``row0`` a lazy step's new surface rows (rho0, cp0), or None
    in a full step, whose diagnostic fields at levels ``wide`` holds.
    ``glue_out`` (``step_glue``) takes the profiles; the per-column values
    and the wide fields go through their land select here.  Without it
    (``l_no_isotherm``) the epilogue runs in torch whole."""
    tob = (lambda a: a) if zaxis else (lambda a: a.T)
    new = sg.repair_phase(st.old, st.new)[1]
    old2 = new
    new2 = 1 - old2
    selh = new2 == 1
    hmixd = torch.stack([torch.where(selh, st.hmixd[:, 0], hmixn),
                         torch.where(selh, hmixn, st.hmixd[:, 1])], dim=-1)
    ssurf = (prm.ssref if cfg.physics.l_ssref
             else tob(q[3])[:, 0] + prm.sref)
    small = dict(hmixd=hmixd, old=old2, new=new2, hmix=hmixn, kmix=kmixn,
                 ssurf=ssurf.to(st.u.dtype), reset_flag=reset_flag)
    wide = dict(wide)
    src = tuple(wide.pop(n, getattr(st, n))
                for n in ("rho", "cp", "tinc_fcorr", "ocntcorr"))
    if glue_out is None:
        new_st = st.replace(**sg.levels_state(q, st, row0, src, cfg=cfg,
                                              zaxis=zaxis),
                            **small, **wide)
        return finish_step(new_st, st, prm, frc, comp_flag, grid, cfg)
    # check_profile zeroes reset_flag where the isotherm test is off
    small["reset_flag"] = torch.zeros_like(reset_flag)
    rest = {k: select(prm.run_physics, v, getattr(st, k))
            for k, v in {**small, **wide}.items()}
    return st.replace(**rest, **glue_out(q, st, prm, frc, comp_flag, row0,
                                         src))
