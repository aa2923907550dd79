"""The fused step's glue around the whole-step kernel, as two kernels and
their plain versions (reference: mckpp_physics_ocnstep_mod.F90:91-112 and
:343-353, mckpp_physics_overrides.F90).

* ``glue_in`` (before the step): the history-phase repair, the selects of
  the two history levels, the extrapolation ``2 * new - old``, the pad to
  ``WZ = nz + 2`` rows and the change to the kernels' layout, writing the
  step's ten profile inputs (u, v, T, S extrapolated; u, v, T, S of the
  state; swdk_opt, swfrac).
* ``glue_out`` (after it): the levels back to the state's layout, the
  current damping, the history ping-pong, ``check_profile``'s reset to the
  initial currents (and to the T/S climatology where its files exist),
  the freezing floor, the land select and ``bottomtemp``'s pin, for the
  fields these touch: u, x, us, xs, rho, cp (the surface rows of a lazy
  step, or the full pass's), the surface values uref, vref, tref, the
  damping and freeze flags, and tinc_fcorr / ocntcorr where the freezing
  floor, the bottom pin or a full step change them.

Neither replaces a TPU kernel: the JAX package leaves this glue to XLA,
which fuses it.  In plain torch it is ~40 separate elementwise, stack and
transpose kernels moving ~4x the bytes the step needs.  Both kernels are
bound by bytes (at the TerraMaris width, nz = 69, float32: 0.98 GB for
glue_in, 1.16 GB for glue_out in a lazy step); each reads its inputs and
writes its outputs once, through a shared-memory tile of 32 consecutive
columns where the layouts differ (col_lanes), so both sides move whole
sectors.

A configuration with ``l_no_isotherm`` keeps the torch epilogue whole
(``overrides.finish_step``): the isotherm test sums a profile in floats,
in torch's reduction order, which a kernel cannot match bit for bit.  The
damping and freeze fractions sum 0/1 values, exact in any order.

A wrapper given CPU tensors runs the plain body; given CUDA tensors it
launches its kernel (``csrc/step_glue.cu``) or raises, and counts the
launch in ``cuda_kernels.LAUNCHES``.  The plain bodies are the epilogue
and prologue the port ran before the kernels, and give the same bits on
either device as the kernels on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import KppConfig
from ..state import ColumnParams, Forcing, State
from . import cuda_kernels as ck
from .overrides import finish_step

# the fields glue_out writes, beside the four it may add
OUT_FIELDS = ("u", "x", "us", "xs", "rho", "cp", "uref", "vref", "tref",
              "dampu_flag", "dampv_flag")


def repair_phase(old, new):
    """The history phases, repaired (ocnstep:91-112): an old phase out of
    0..1 takes new, then a new phase out of 0..1 takes the old one."""
    old = torch.where((old < 0) | (old > 1), new, old)
    new = torch.where((new < 0) | (new > 1), old, new)
    return old, new


def fusable(cfg: KppConfig) -> bool:
    """Whether the epilogue runs in ``glue_out``: every configuration but
    one with the isotherm test (a float sum over levels)."""
    return not cfg.forcing.l_no_isotherm


def out_fields(cfg: KppConfig, wide: bool):
    """The State fields ``glue_out`` returns in a lazy step (``wide``
    False) or a full one."""
    f = cfg.forcing
    names = list(OUT_FIELDS)
    if f.l_no_freeze:
        names.append("freeze_flag")
    if wide or f.l_no_freeze or f.l_vary_bottom_temp:
        names.append("tinc_fcorr")
    if wide or f.l_vary_bottom_temp:
        names.append("ocntcorr")
    return tuple(names)


# ---- plain versions ----------------------------------------------------------

def glue_in_body(us, xs, u, x, swdk_opt, swfrac, old, new, *, wz, zaxis):
    """The step's ten profile inputs in the kernels' layout: (WZ, ncol)
    for zaxis 0, (ncol, WZ) for 1, each padded with zeros past its nz + 1
    levels."""
    old, new = repair_phase(old, new)
    sel_new = (new == 1)[:, None, None]
    sel_old = (old == 1)[:, None, None]
    us_new = torch.where(sel_new, us[..., 1], us[..., 0])
    us_old = torch.where(sel_old, us[..., 1], us[..., 0])
    xs_new = torch.where(sel_new, xs[..., 1], xs[..., 0])
    xs_old = torch.where(sel_old, xs[..., 1], xs[..., 0])
    u_ex3 = 2.0 * us_new - us_old                  # (ncol, nzp1, 2)
    x_ex3 = 2.0 * xs_new - xs_old

    def tok(a):
        p = torch.nn.functional.pad(a, (0, wz - a.shape[1]))
        return p if zaxis else p.T.contiguous()

    return (tok(u_ex3[:, :, 0]), tok(u_ex3[:, :, 1]),
            tok(x_ex3[:, :, 0]), tok(x_ex3[:, :, 1]),
            tok(u[:, :, 0]), tok(u[:, :, 1]), tok(x[:, :, 0]),
            tok(x[:, :, 1]), tok(swdk_opt), tok(swfrac))


def damp_currents(u_lvl, v_lvl, cfg: KppConfig, zero):
    """The current damping (ocnstep:326-341) where ``l_damp_curr`` is set:
    the damped levels and each column's share of damped levels; else the
    levels and ``zero``."""
    if not cfg.forcing.l_damp_curr:
        return u_lvl, v_lvl, zero, zero
    r = cfg.forcing.dtuvdamp * (86400.0 / cfg.time.dto)
    nzp1 = u_lvl.shape[1]

    def damp(q):
        a = 0.99 * torch.abs(q)
        b = q * q / r
        qi = torch.minimum(a, b)
        frac = (b < a).to(q.dtype).sum(dim=1) / float(nzp1)
        return q - torch.sign(q) * qi, frac

    u_lvl, dampu = damp(u_lvl)
    v_lvl, dampv = damp(v_lvl)
    return u_lvl, v_lvl, dampu, dampv


def ping_pong(st: State, new, u3, x3):
    """The two-level history after the step (ocnstep:343-353): the new
    levels go to the slot the repaired ``new`` phase does not name."""
    sel2 = (1 - new == 1)[:, None, None]
    us = torch.stack([torch.where(sel2, st.us[..., 0], u3),
                      torch.where(sel2, u3, st.us[..., 1])], dim=-1)
    xs = torch.stack([torch.where(sel2, st.xs[..., 0], x3),
                      torch.where(sel2, x3, st.xs[..., 1])], dim=-1)
    return us, xs


def levels_state(q, st: State, row0, src, *, cfg: KppConfig, zaxis):
    """The profile fields of the step's new State before ``check_profile``
    (ocnstep:242-353): ``q`` the final u, v, T, S in the kernels' layout;
    ``row0`` a lazy step's new surface rows (rho0, cp0), or None in a full
    step; ``src`` rho, cp, tinc_fcorr, ocntcorr at levels, ``(ncol, nz +
    1)`` (the state's own in a lazy step, the full pass's in a full one)."""
    nzp1 = st.u.shape[1]
    tob = (lambda a: a) if zaxis else (lambda a: a.T)
    u_lvl, v_lvl, t_lvl, s_lvl = (tob(a)[:, :nzp1] for a in q)
    zero = torch.zeros_like(st.dampu_flag)
    u_lvl, v_lvl, dampu, dampv = damp_currents(u_lvl, v_lvl, cfg, zero)
    u3 = torch.stack([u_lvl, v_lvl], dim=-1)
    x3 = torch.stack([t_lvl, s_lvl], dim=-1)
    us, xs = ping_pong(st, repair_phase(st.old, st.new)[1], u3, x3)
    rho, cp, tinc, ocntcorr = src
    if row0 is not None:
        rho, cp = rho.clone(), cp.clone()
        rho[:, 0] = row0[0]
        cp[:, 0] = row0[1]
    return dict(u=u3, x=x3, us=us, xs=xs, rho=rho, cp=cp,
                uref=u_lvl[:, 0], vref=v_lvl[:, 0], tref=t_lvl[:, 0],
                dampu_flag=dampu, dampv_flag=dampv, tinc_fcorr=tinc,
                ocntcorr=ocntcorr)


def glue_out_body(q, st: State, prm: ColumnParams, frc: Forcing, comp_flag,
                  row0, src, *, grid, cfg: KppConfig, zaxis):
    """:func:`levels_state`, then ``finish_step`` (check_profile, the land
    select, bottomtemp); returns {field: tensor} for :func:`out_fields`."""
    new_st = st.replace(**levels_state(q, st, row0, src, cfg=cfg,
                                       zaxis=zaxis))
    out = finish_step(new_st, st, prm, frc, comp_flag, grid, cfg)
    return {n: getattr(out, n) for n in out_fields(cfg, row0 is None)}


# ---- the kernels' wrappers ---------------------------------------------------

def _contig(a):
    """``a`` contiguous and 16-byte aligned, as the kernels read rows of
    values in 16-byte accesses (a copy where it is not)."""
    if a.is_contiguous() and a.data_ptr() % 16 == 0:
        return a
    return a.contiguous() if not a.is_contiguous() else a.clone()


def _same(ref, arrays, what):
    for a in arrays:
        if a.device != ref.device or a.dtype != ref.dtype:
            raise TypeError(f"{what}: {a.device}/{a.dtype}, expected "
                            f"{ref.device}/{ref.dtype}")


def _check_cols(ncol, cols, what):
    for a in cols:
        if tuple(a.shape) != (ncol,):
            raise ValueError(f"{what}: per-column rows must be ({ncol},), "
                             f"got {tuple(a.shape)}")


class GlueIn:
    """The prologue: the kernel for CUDA tensors, the plain body for CPU
    tensors."""

    name = "step_glue_in"

    def __init__(self, wz: int, zaxis: int):
        self.wz, self.zaxis = wz, zaxis

    def __call__(self, us, xs, u, x, swdk_opt, swfrac, old, new):
        if us.device.type == "cpu":
            return glue_in_body(us, xs, u, x, swdk_opt, swfrac, old, new,
                                wz=self.wz, zaxis=self.zaxis)
        return self.launch(us, xs, u, x, swdk_opt, swfrac, old, new)

    def launch(self, us, xs, u, x, swdk_opt, swfrac, old, new):
        ncol, nzp1 = u.shape[:2]
        if nzp1 + 1 != self.wz or tuple(us.shape) != (ncol, nzp1, 2, 2) \
                or tuple(xs.shape) != (ncol, nzp1, 2, 2) \
                or tuple(x.shape) != (ncol, nzp1, 2) \
                or tuple(u.shape) != (ncol, nzp1, 2) \
                or tuple(swdk_opt.shape) != (ncol, nzp1) \
                or tuple(swfrac.shape) != (ncol, nzp1):
            raise ValueError(f"{self.name}: state shapes do not fit "
                             f"{self.wz} rows")
        _same(u, (us, xs, x, swdk_opt, swfrac), self.name)
        _check_cols(ncol, (old, new), self.name)
        if old.dtype != torch.int32 or new.dtype != torch.int32:
            raise TypeError(f"{self.name}: phases must be int32")
        mk = (lambda: torch.empty((ncol, self.wz) if self.zaxis
                                  else (self.wz, ncol), dtype=u.dtype,
                                  device=u.device))
        outs = [mk() for _ in range(10)]
        keep = [_contig(a) for a in (us, xs, u, x, old, new)]
        a = ck.GlueInArgs()
        (a.us, a.xs, a.u, a.x, a.old, a.new) = [t.data_ptr() for t in keep]
        a.swdk, a.swfrac = swdk_opt.data_ptr(), swfrac.data_ptr()
        for i, t in enumerate((swdk_opt, swfrac)):
            a.sw_sc[i], a.sw_sl[i] = t.stride(0), t.stride(1)
        for i, o in enumerate(outs):
            a.out[i] = o.data_ptr()
        a.ncol, a.nzp1, a.wz = ncol, nzp1, self.wz
        rc = ck._lib(None, ck.GLUE).kpp_glue_in(
            u.element_size(), self.zaxis, ctypes.byref(a),
            torch.cuda.current_stream(u.device).cuda_stream)
        ck._raise_on(rc, self.name)
        ck.LAUNCHES[self.name] += 1
        return tuple(outs)


class GlueOut:
    """The epilogue: the kernel for CUDA tensors, the plain body for CPU
    tensors."""

    name = "step_glue_out"

    def __init__(self, grid, cfg: KppConfig, zaxis: int):
        if not fusable(cfg):
            raise ValueError("l_no_isotherm: the epilogue stays in torch")
        self.grid, self.cfg, self.zaxis = grid, cfg, zaxis

    def __call__(self, q, st, prm, frc, comp_flag, row0, src):
        if st.u.device.type == "cpu":
            return glue_out_body(q, st, prm, frc, comp_flag, row0, src,
                                 grid=self.grid, cfg=self.cfg,
                                 zaxis=self.zaxis)
        return self.launch(q, st, prm, frc, comp_flag, row0, src)

    def launch(self, q, st, prm, frc, comp_flag, row0, src):
        f, nz = self.cfg.forcing, self.grid.nz
        ncol, nzp1, wz = st.u.shape[0], nz + 1, nz + 2
        kshape = (ncol, wz) if self.zaxis else (wz, ncol)
        ref = st.u
        for a in q:
            if tuple(a.shape) != kshape or not a.is_contiguous():
                raise ValueError(f"{self.name}: step outputs must be "
                                 f"contiguous {kshape}")
        for a in src:
            if tuple(a.shape) != (ncol, nzp1):
                raise ValueError(f"{self.name}: level profiles must be "
                                 f"({ncol}, {nzp1})")
        # the C struct's inputs by field name
        prof = dict(st_u=st.u, st_x=st.x, st_us=st.us, st_xs=st.xs,
                    u_init=prm.u_init, ocnt_clim=frc.ocnt_clim,
                    sal_clim=frc.sal_clim, st_rho=st.rho, st_cp=st.cp,
                    st_tinc=st.tinc_fcorr, st_ocnt=st.ocntcorr)
        cols = dict(st_uref=st.uref, st_vref=st.vref, st_tref=st.tref,
                    st_dampu=st.dampu_flag, st_dampv=st.dampv_flag,
                    st_ff=st.freeze_flag, bottom_temp=frc.bottom_temp,
                    **({} if row0 is None else dict(rho0=row0[0],
                                                    cp0=row0[1])))
        flags = dict(comp=comp_flag, rp=prm.run_physics, ocean=prm.l_ocean)
        _same(ref, (*q, *src, *prof.values(), *cols.values()), self.name)
        _check_cols(ncol, (*cols.values(), *flags.values(), st.old,
                           st.new), self.name)
        if any(a.dtype != torch.bool for a in flags.values()):
            raise TypeError(f"{self.name}: comp_flag, run_physics and "
                            "l_ocean must be bool")
        out = {n: torch.empty(getattr(st, n).shape, dtype=ref.dtype,
                              device=ref.device)
               for n in out_fields(self.cfg, row0 is None)}
        ins = {k: _contig(v) for k, v in {**prof, **cols, **flags,
                                           "old": st.old,
                                           "new": st.new}.items()}
        a = ck.GlueOutArgs()
        for i in range(4):
            a.q[i] = q[i].data_ptr()
            a.src[i] = src[i].data_ptr()
            a.src_sc[i], a.src_sl[i] = src[i].stride(0), src[i].stride(1)
        for k, v in ins.items():
            setattr(a, k, v.data_ptr())
        for k, n in (("u", "u"), ("x", "x"), ("us", "us"), ("xs", "xs"),
                     ("rho", "rho"), ("cp", "cp"), ("tinc", "tinc_fcorr"),
                     ("ocnt", "ocntcorr"), ("uref", "uref"),
                     ("vref", "vref"), ("tref", "tref"),
                     ("dampu", "dampu_flag"), ("dampv", "dampv_flag"),
                     ("ff", "freeze_flag")):
            setattr(a, k, out[n].data_ptr() if n in out else None)
        a.ncol, a.nzp1, a.wz, a.nz = ncol, nzp1, wz, nz
        a.damp, a.no_freeze = int(f.l_damp_curr), int(f.l_no_freeze)
        a.have_clim = int(f.ocnt_file not in ("", "none")
                          and f.sal_file not in ("", "none"))
        a.bottom = int(f.l_vary_bottom_temp)
        a.damp_r = f.dtuvdamp * (86400.0 / self.cfg.time.dto)
        a.dto = self.cfg.time.dto
        rc = ck._lib(None, ck.GLUE).kpp_glue_out(
            ref.element_size(), self.zaxis, ctypes.byref(a),
            torch.cuda.current_stream(ref.device).cuda_stream)
        ck._raise_on(rc, self.name)
        ck.LAUNCHES[self.name] += 1
        return out


def make_glue(grid, cfg: KppConfig, *, impl: str, zaxis: int):
    """(glue_in, glue_out) of the fused step: the plain bodies ("eager"),
    or the wrappers ("cuda"); glue_out is None where the epilogue stays in
    torch (:func:`fusable`)."""
    wz = grid.nz + 2
    if impl not in ("eager", "cuda"):
        raise ValueError(f"unknown glue impl {impl!r}")
    if impl == "cuda":
        return (GlueIn(wz, zaxis),
                GlueOut(grid, cfg, zaxis) if fusable(cfg) else None)
    return (lambda *a: glue_in_body(*a, wz=wz, zaxis=zaxis),
            (lambda *a: glue_out_body(*a, grid=grid, cfg=cfg, zaxis=zaxis))
            if fusable(cfg) else None)
