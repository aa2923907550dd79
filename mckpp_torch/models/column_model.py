"""The multi-column KPP ocean mixed-layer model: warm start, step, run
(counterpart of ``mckpp_tpu/models/column_model.py``).

Columns are a batch axis; land columns are masked with ``torch.where``.
The model runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card the ocean step goes through the CUDA kernels (``pass_impl``
"cuda_step"), on the CPU through their plain torch bodies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import forcing as forcing_mod
from ..config import KppConfig
from ..grid import VerticalGrid, make_vertical_grid
from ..ops.eos import abk80, cpsw
from ..ops.ocnstep_fused import make_ocnstep_fused
from ..ops.overrides import bottomtemp, check_profile
from ..ops.swfrac import swdk, swfrac_levels
from ..state import ColumnParams, Forcing, State, init_forcing, init_state, tree_map

_PASS_IMPLS = ("eager", "eager_step", "cuda", "cuda_step")


def _select(mask, new, old):
    """Per-column select over a state dataclass (mask: (ncol,) bool)."""
    def sel(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return tree_map(sel, new, old)


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not implemented in mckpp_torch yet (ROADMAP A14)")


class KppModel:
    """Holds the configuration and the vertical grid; exposes functions over
    (State, ColumnParams, Forcing)."""

    def __init__(self, cfg: KppConfig, vgrid: Optional[VerticalGrid] = None,
                 device=None):
        cfg.validate()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "KppModel runs on CUDA by default and no CUDA device is "
                    "available; pass device='cpu' to run the plain bodies")
            device = "cuda"
        self.device = torch.device(device)
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        ph = cfg.physics
        if ph.pass_layout != "col_lanes":
            raise NotImplementedError(
                f"pass_layout={ph.pass_layout!r}: only 'col_lanes' is "
                "carried over to mckpp_torch")
        if ph.solver != "pcr":
            raise _not_ported(f"solver={ph.solver!r}")
        if ph.wscale_mode == "table":
            raise _not_ported("wscale_mode='table'")
        on_cuda = self.device.type == "cuda"
        if ph.wscale_mode == "auto":
            # exact LMD stability functions on the card in float32; the
            # reference's interpolation semantics ("nodal") elsewhere
            mode = ("analytic" if on_cuda and self.dtype == torch.float32
                    else "nodal")
            cfg = cfg.replace(physics=dataclasses.replace(ph,
                                                          wscale_mode=mode))
        self.cfg = cfg
        self.pass_impl = self._resolve_pass_impl(on_cuda)
        d = cfg.domain
        if vgrid is None:
            vgrid = make_vertical_grid(
                d.nz, d.dmax, cfg.time.dto, stretch=d.l_stretchgrid,
                dscale=d.dscale, dtype=self.dtype, device=self.device)
        self.grid = vgrid
        self._fused_step = make_ocnstep_fused(self.grid, cfg, self.dtype,
                                              impl=self.pass_impl)

    def _resolve_pass_impl(self, on_cuda: bool) -> str:
        choice = self.cfg.physics.pass_impl
        if choice == "reference":
            raise _not_ported("pass_impl='reference'")
        if choice == "auto":
            return "cuda_step" if on_cuda else "eager_step"
        if choice not in _PASS_IMPLS:
            raise ValueError(f"pass_impl={choice!r}; mckpp_torch takes "
                             f"'auto' or one of {_PASS_IMPLS}")
        return choice

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
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
        """One ocean timestep.  ``with_diags=False`` skips the diagnostic
        materialization pass: same prognostic trajectory, stale wide
        diagnostic fields."""
        grid, cfg = self.grid, self.cfg
        new_st, comp = self._fused_step(st, prm, frc, first_step,
                                        with_diags=with_diags)
        new_st = check_profile(new_st, prm, frc, comp, grid, cfg)
        out = _select(prm.run_physics, new_st, st)
        if cfg.forcing.l_vary_bottom_temp:
            out = bottomtemp(out, frc, grid, cfg.time.dto)
        return out

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
