"""The multi-column KPP ocean mixed-layer model: warm start, step, run
(counterpart of ``mckpp_tpu/models/column_model.py``).

Columns are a batch axis; land columns are masked with ``torch.where``.
The model runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card the ocean step goes through the CUDA kernels (``pass_impl``
"cuda_step"), on the CPU through their plain torch bodies.  The reference
step (``pass_impl`` "reference", ``ops/ocnstep.py``) is plain torch on
either device; "auto" falls back to it for the options the fused step
does not cover (the Thomas solver, the resident wscale table).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from .. import forcing as forcing_mod
from ..config import KppConfig
from ..grid import VerticalGrid, make_vertical_grid
from ..ops import cuda_kernels as ck
from ..ops import wscale as wscale_mod
from ..ops.eos import abk80, cpsw
from ..ops.ocnstep import apply_vmix, interior_fluxes, ocnstep
from ..ops.ocnstep_fused import make_ocnstep_fused
from ..ops.overrides import finish_step
from ..ops.swfrac import swdk, swfrac_levels
from ..ops.vmix import vmix
from ..state import (ColumnParams, Forcing, State, init_forcing,
                     init_state, select, tree_map)

_PASS_IMPLS = ("eager", "eager_step", "cuda", "cuda_step")


def resolve_device(device=None) -> torch.device:
    """The model's device: CUDA unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "KppModel runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain bodies")
        device = "cuda"
    return torch.device(device)


def model_dtype(cfg: KppConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype == "float64" else torch.float32


class KppModel:
    """Holds the configuration and the vertical grid; exposes functions over
    (State, ColumnParams, Forcing)."""

    def __init__(self, cfg: KppConfig, vgrid: Optional[VerticalGrid] = None,
                 device=None):
        cfg.validate()
        self.device = resolve_device(device)
        self.dtype = model_dtype(cfg)
        ph = cfg.physics
        if ph.pass_layout not in ("col_lanes", "z_lanes"):
            raise ValueError(f"pass_layout={ph.pass_layout!r}: "
                             "'col_lanes' or 'z_lanes'")
        on_cuda = self.device.type == "cuda"
        self.pass_impl = self._resolve_pass_impl(ph, on_cuda)
        if ph.wscale_mode == "auto":
            # exact LMD stability functions on the card in float32 on the
            # fused path; the reference's interpolation semantics ("nodal")
            # elsewhere, and always on the reference path
            mode = ("analytic" if on_cuda and self.dtype == torch.float32
                    and self.pass_impl != "reference" else "nodal")
            cfg = cfg.replace(physics=dataclasses.replace(ph,
                                                          wscale_mode=mode))
        self.cfg = cfg
        d = cfg.domain
        if vgrid is None:
            vgrid = make_vertical_grid(
                d.nz, d.dmax, cfg.time.dto, stretch=d.l_stretchgrid,
                dscale=d.dscale, dtype=self.dtype, device=self.device)
        self.grid = vgrid
        # the resident (zehat, ustar) tables: built in float64, then cast
        # to the model dtype on the model's device
        self.tables = None
        if cfg.physics.wscale_mode == "table":
            self.tables = tuple(
                t.to(dtype=self.dtype, device=self.device)
                for t in wscale_mod.build_tables(vonk=cfg.constants.vonk))
        self._fused_step = (None if self.pass_impl == "reference" else
                            make_ocnstep_fused(self.grid, cfg, self.dtype,
                                               impl=self.pass_impl))
        # the passes each column ran in the whole steps taken so far (the
        # step's colstep row 7), float64 on the model's device, added up
        # there; None until the first whole step, and under the per-pass
        # and reference impls
        self.passes: Optional[torch.Tensor] = None
        self._counting = True

    @staticmethod
    def _resolve_pass_impl(ph, on_cuda: bool) -> str:
        """The fused step where it covers the configuration; the reference
        step for the Thomas solver or the resident wscale table (what
        ``supports_fused`` decides in the JAX package)."""
        choice = ph.pass_impl
        supported = ph.solver == "pcr" and ph.wscale_mode != "table"
        if choice == "reference":
            return choice
        if choice == "auto":
            if not supported:
                return "reference"
            return "cuda_step" if on_cuda else "eager_step"
        if choice not in _PASS_IMPLS:
            raise ValueError(f"pass_impl={choice!r}; mckpp_torch takes "
                             f"'auto', 'reference' or one of {_PASS_IMPLS}")
        if not supported:
            raise ValueError(
                f"pass_impl={choice!r} requested but the configuration "
                "uses features the fused step does not cover (wscale "
                "table / thomas solver); use 'reference' or 'auto'")
        return choice

    @contextlib.contextmanager
    def uncounted(self):
        """Steps inside the block add nothing to :attr:`passes`: a CUDA
        graph's eager warm-up, whose steps the replays run again."""
        was, self._counting = self._counting, False
        try:
            yield
        finally:
            self._counting = was

    def _passes_of(self, st: State):
        """The pass counter a whole step adds to, or None; allocated at
        the first whole step (a graph's eager warm-up, outside any
        capture)."""
        if not self.pass_impl.endswith("_step"):
            return None
        ncol = st.u.shape[0]
        if self.passes is None or self.passes.shape[0] != ncol:
            self.passes = torch.zeros((ncol,), dtype=torch.float64,
                                      device=self.device)
        return self.passes if self._counting else None

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def load_library(self) -> None:
        """Load (build where missing) the kernel library that the step
        launches, ahead of its first launch; nothing off the card's
        kernels."""
        if self.pass_impl in ("cuda", "cuda_step"):
            zaxis = 0 if self.cfg.physics.pass_layout == "col_lanes" else 1
            ck.preload(self.grid.nz, self.dtype, zaxis)

    # ------------------------------------------------------------------
    # Initialization (reference: mckpp_initialize_ocean.F90:18-111)
    # ------------------------------------------------------------------
    def initial_state(self, u0, t0, s0, prm: ColumnParams):
        """Build the initial State from interpolated profiles.

        u0: (ncol, nzp1, 2) currents; t0: (ncol, nzp1) temperature (degC);
        s0: (ncol, nzp1) *absolute* salinity (psu); numpy arrays or
        tensors.  The reference salinity Sref = (S_top + S_bot)/2 is
        removed here (reference:
        mckpp_initialize_ocean_profiles_mod.F90:103-117) and the initial
        vertical-mixing pass seeds hmix and the two-level history.
        """
        u0, t0, s0 = self._tensor(u0), self._tensor(t0), self._tensor(s0)
        dt = self.dtype
        ncol, nzp1 = t0.shape
        # the model dtype up front: float64 inputs must not leak into a
        # float32 model's sref/ssurf
        sref = ((s0[:, 0] + s0[:, -1]) / 2.0).to(dt)
        prm = prm.replace(sref=sref, ssref=sref, u_init=u0.to(dt))
        st = init_state(ncol, nzp1, dt, self.device)
        x = torch.stack([t0.to(dt), s0.to(dt) - sref[:, None]], dim=-1)
        st = st.replace(u=u0.to(dt), x=x, tref=t0[:, 0].to(dt))
        if self.cfg.physics.l_ssref:
            st = st.replace(ssurf=prm.ssref)
        else:
            st = st.replace(ssurf=x[:, 0, 1] + prm.sref)
        frc = init_forcing(ncol, nzp1, dt, self.device)
        st = self._init_columns(st, prm, frc)
        return st, prm, frc

    def _init_columns(self, st: State, prm: ColumnParams, frc: Forcing):
        """The initial vmix pass (init flag on, no wXNT update), the
        initial diagnostic fluxes and the history seed."""
        grid, cfg = self.grid, self.cfg
        ph = cfg.physics
        # cached shortwave fraction at levels (swfrac_opt with fact=1)
        st = st.replace(swfrac=swfrac_levels(1.0, grid.zm,
                                             prm.jerlov).to(grid.zm.dtype))
        # as in the JAX package, the initial pass looks the velocity
        # scales up in the table under "table" and evaluates the nodal
        # form under every other mode
        vm = vmix(st.u, st.x, frc.sflux, st.ssurf, prm.sref, prm.jerlov,
                  prm.f, prm.ocdepth, True, st.swdk_opt, st.swfrac, st.wxnt,
                  True, grid, lri=ph.lri, ldd=ph.ldd, lkpp=ph.lkpp,
                  update_wxnt=False, cst=cfg.constants,
                  wscale_mode="nodal" if self.tables is None else "table",
                  tables=self.tables)
        st_vm = apply_vmix(st, vm)
        # initial diagnostic fluxes (reference :66-81)
        wu, wx = interior_fluxes(st_vm, grid, ph.ldd, cfg.constants.grav)
        x, u = st.x, st.u
        ncol = x.shape[0]
        new_st = st_vm.replace(
            wu=wu, wx=wx, hmix=vm.hbl, kmix=vm.kbl, tref=x[:, 0, 0],
            # two-level history seed (reference :83-100)
            us=torch.stack([u, u], dim=-1), xs=torch.stack([x, x], dim=-1),
            hmixd=torch.stack([vm.hbl, vm.hbl], dim=-1),
            old=torch.zeros((ncol,), dtype=torch.int32, device=self.device),
            new=torch.ones((ncol,), dtype=torch.int32, device=self.device))
        # pin the declared dtypes (float64 constants must not promote a
        # float32 model's fields)
        new_st = tree_map(lambda a, b: a.to(b.dtype), new_st, st)
        return select(prm.run_physics, new_st, st)

    def warm_start(self, u0, t0, s0, prm: ColumnParams):
        """Fast initialization: seed the two-level history and the
        shortwave caches without the initial per-column vertical-mixing
        pass.  u0: (ncol, nzp1, 2) currents; t0: (ncol, nzp1) temperature
        (degC); s0: (ncol, nzp1) absolute salinity (psu); numpy arrays or
        tensors."""
        u0, t0, s0 = self._tensor(u0), self._tensor(t0), self._tensor(s0)
        dt, grid = self.dtype, self.grid
        ncol, nzp1 = t0.shape
        sref = (s0[:, 0] + s0[:, -1]) / 2.0
        prm = prm.replace(sref=sref.to(dt), ssref=sref.to(dt),
                          u_init=u0.to(dt))
        st = init_state(ncol, nzp1, dt, self.device)
        x = torch.stack([t0, s0 - sref[:, None]], dim=-1).to(dt)
        u = u0.to(dt)
        s_abs = x[..., 1] + prm.sref[:, None]
        alpha, beta, _, sig0, _ = abk80(s_abs, x[..., 0], -grid.zm)
        st = st.replace(
            u=u, x=x,
            us=torch.stack([u, u], dim=-1), xs=torch.stack([x, x], dim=-1),
            hmixd=torch.stack([st.hmix, st.hmix], dim=-1),
            swfrac=swfrac_levels(1.0, grid.zm, prm.jerlov).to(dt),
            swdk_opt=swdk(-grid.dm, prm.jerlov).to(dt),
            rho=1000.0 + sig0, cp=cpsw(s_abs, x[..., 0], -grid.zm),
            talpha=alpha, sbeta=beta,
            tref=x[:, 0, 0], ssurf=prm.ssref,
            old=torch.zeros((ncol,), dtype=torch.int32, device=self.device),
            new=torch.ones((ncol,), dtype=torch.int32, device=self.device))
        frc = init_forcing(ncol, nzp1, dt, self.device)
        return st, prm, frc

    # ------------------------------------------------------------------
    # One ocean timestep (physics driver + overrides)
    # ------------------------------------------------------------------
    def _step(self, st: State, prm: ColumnParams, frc: Forcing, first_step,
              with_diags: bool = True):
        """One ocean timestep.  ``with_diags=False`` (fused path only)
        skips the diagnostic materialization pass: same prognostic
        trajectory, stale wide diagnostic fields.  The reference path
        always materializes."""
        grid, cfg = self.grid, self.cfg
        if self.pass_impl != "reference":
            return self._fused_step(st, prm, frc, first_step,
                                    with_diags=with_diags,
                                    passes=self._passes_of(st))
        new_st, comp = ocnstep(st, prm, frc, grid, cfg, first_step,
                               prm.run_physics, tables=self.tables)
        return finish_step(new_st, st, prm, frc, comp, grid, cfg)

    def step(self, st, prm, frc, first_step=False, with_diags=True):
        return self._step(st, prm, frc, bool(first_step),
                          with_diags=with_diags)

    # ------------------------------------------------------------------
    # Time loop (reference: mckpp_ocean_model_3D.F90:38-70)
    # ------------------------------------------------------------------
    def run(self, st: State, prm: ColumnParams, frc: Forcing,
            num_steps: Optional[int] = None,
            flux_provider: Optional[Callable[[int], forcing_mod.RawFluxes]] = None,
            boundary_update: Optional[Callable[[int, Forcing], Forcing]] = None,
            step_callback: Optional[Callable] = None):
        """Run the main loop on the host.

        flux_provider(nt) -> RawFluxes on the ndtocn cadence;
        boundary_update(nt, frc) -> frc for ancillary refreshes;
        step_callback(nt, st) for diagnostics/restart hooks.
        """
        cfg = self.cfg
        n = num_steps if num_steps is not None else cfg.time.num_timesteps
        ncol = st.u.shape[0]
        for nt in range(1, n + 1):
            if (nt - 1) % cfg.time.ndtocn == 0:
                raw = (flux_provider(nt) if flux_provider is not None
                       else forcing_mod.constant_test_fluxes(
                           ncol, self.dtype, self.device))
                st, frc = forcing_mod.update_fluxes(
                    cfg, st, prm, frc, raw, nt <= 1, self.grid.dm)
            if nt != 1 and boundary_update is not None:
                frc = boundary_update(nt, frc)
            st = self.step(st, prm, frc, first_step=(nt <= 1))
            if step_callback is not None:
                step_callback(nt, st)
        return st, frc
