"""State containers: frozen dataclasses of batched column tensors
(counterpart of ``mckpp_tpu/state.py``; field names, shapes and dtypes are
identical).

Array index conventions:

* level arrays are 0-based ``(..., nzp1)``, python ``k`` == Fortran ``k+1``;
* interface arrays are Fortran-aligned: ``difm/difs/dift`` have length
  ``nz+2`` (Fortran ``0:nzp1``), ``ghat/dbloc/shsq/rig`` length ``nz+1``
  with index 0 unused/zero, ``wu/wx/wxnt/swdk_opt`` length ``nz+1``
  (Fortran ``0:nz``).

The two-level time history (``us``, ``xs``, ``hmixd`` with integer phase
``old``/``new``) is kept explicitly (reference:
mckpp_physics_ocnstep_mod.F90:343-353).

* :class:`State` — everything the physics updates per step.
* :class:`ColumnParams` — per-column quantities physics never updates.
* :class:`Forcing` — surface fluxes + boundary/climatology fields.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` field by field over dataclasses of one type, returning
    a new instance (the stand-in for ``jax.tree_util.tree_map``)."""
    cls = type(trees[0])
    return cls(**{f.name: fn(*(getattr(t, f.name) for t in trees))
                  for f in dataclasses.fields(cls)})


def select(mask, new, old):
    """Per-column select (mask: (ncol,) bool) between two tensors, or two
    dataclasses of tensors, with a leading column axis.  A field that is
    the same tensor on both sides passes through as it is (the select
    would copy it bit for bit), so a step's unchanged fields stay the
    caller's tensors."""
    if new is old:
        return new
    if isinstance(new, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                           new, old)
    return tree_map(lambda a, b: select(mask, a, b), new, old)


class _Tree:
    def to(self, device):
        return tree_map(lambda a: a.to(device), self)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class State(_Tree):
    # prognostics: u[(ncol,) nzp1, 2] velocities; x[..., 0]=T (degC),
    # x[..., 1]=S - Sref (psu)
    u: torch.Tensor
    x: torch.Tensor
    # two-level time history + phase
    us: torch.Tensor          # (..., nzp1, 2, 2)
    xs: torch.Tensor          # (..., nzp1, 2, 2)
    hmixd: torch.Tensor       # (..., 2)
    old: torch.Tensor         # (...,) int32
    new: torch.Tensor         # (...,) int32
    # mixed layer
    hmix: torch.Tensor        # (...,)
    kmix: torch.Tensor        # (...,) int32
    # diagnostics / work fields persisted across steps
    rho: torch.Tensor         # (..., nzp1) level densities (index 0 doubles as sfc)
    cp: torch.Tensor          # (..., nzp1)
    buoy: torch.Tensor        # (..., nzp1)
    talpha: torch.Tensor      # (..., nzp1)
    sbeta: torch.Tensor       # (..., nzp1)
    rhoh2o: torch.Tensor      # (...,) fresh-water density in surface layer
    difm: torch.Tensor        # (..., nz+2) interface viscosity, Fortran-aligned
    difs: torch.Tensor        # (..., nz+2)
    dift: torch.Tensor        # (..., nz+2)
    ghat: torch.Tensor        # (..., nz+1) nonlocal transport, index 1..nz
    rig: torch.Tensor         # (..., nz+1) gradient Richardson number
    dbloc: torch.Tensor       # (..., nz+1)
    shsq: torch.Tensor        # (..., nz+1)
    wu: torch.Tensor          # (..., nz+1, 2) momentum flux profiles
    wx: torch.Tensor          # (..., nz+1, 3) scalar + buoyancy flux profiles
    wxnt: torch.Tensor        # (..., nz+1, 2) non-turbulent (solar) flux
    swfrac: torch.Tensor      # (..., nzp1) cached sw fraction at levels
    swdk_opt: torch.Tensor    # (..., nz+1) cached sw decay at interfaces
    # correction/relaxation increments (diagnosed every step)
    tinc_fcorr: torch.Tensor  # (..., nzp1)
    sinc_fcorr: torch.Tensor  # (..., nzp1)
    ocntcorr: torch.Tensor    # (..., nzp1)
    scorr: torch.Tensor       # (..., nzp1)
    fcorr: torch.Tensor       # (...,) surface heat-flux correction diagnostic
    # reference/surface values
    tref: torch.Tensor        # (...,)
    uref: torch.Tensor
    vref: torch.Tensor
    ssurf: torch.Tensor
    # resilience flags (output as diagnostics every step)
    freeze_flag: torch.Tensor
    reset_flag: torch.Tensor
    dampu_flag: torch.Tensor
    dampv_flag: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ColumnParams(_Tree):
    """Per-column constants (not updated by physics)."""
    f: torch.Tensor           # (...,) Coriolis
    ocdepth: torch.Tensor     # (...,) (negative) ocean depth
    jerlov: torch.Tensor      # (...,) int32, 0-based water type 0..4
    l_ocean: torch.Tensor     # (...,) bool
    run_physics: torch.Tensor # (...,) bool
    dlat: torch.Tensor
    dlon: torch.Tensor
    sref: torch.Tensor        # reference salinity (psu)
    ssref: torch.Tensor
    u_init: torch.Tensor      # (..., nzp1, 2) initial currents for resets
    relax_sst: torch.Tensor   # (...,) relaxation rates (1/s)
    relax_sal: torch.Tensor
    relax_ocnt: torch.Tensor
    cplwght: torch.Tensor
    # advection corrections (reference: mckpp_initialize_advection_mod.F90)
    nmodeadv: torch.Tensor    # (..., 2) int32
    modeadv: torch.Tensor     # (..., maxmodeadv, 2) int32
    advection: torch.Tensor   # (..., maxmodeadv, 2)


@dataclasses.dataclass(frozen=True)
class Forcing(_Tree):
    """Surface fluxes + boundary fields, refreshed on their cadences.

    ``sflux`` packs the reference's sflux(ipt,1:6,5,0)
    (mckpp_fluxes_mod.F90:59-78): 0=taux, 1=tauy, 2=swf, 3=non-solar
    (lwf+lhf+shf-snow*FLSN), 4=ice melt, 5=freshwater (rain+snow+lhf/EL).
    """
    sflux: torch.Tensor         # (..., 6)
    sst0: torch.Tensor          # (...,) SST relaxation target
    fcorr_twod: torch.Tensor    # (...,) 2-D heat correction (W/m^2)
    sfcorr_twod: torch.Tensor   # (...,)
    fcorr_withz: torch.Tensor   # (..., nzp1) 3-D heat correction (W/m^3)
    sfcorr_withz: torch.Tensor  # (..., nzp1)
    sal_clim: torch.Tensor      # (..., nzp1) salinity climatology (Sref removed)
    ocnt_clim: torch.Tensor     # (..., nzp1) temperature climatology
    bottom_temp: torch.Tensor   # (...,)
    iceconc: torch.Tensor       # (...,) sea-ice concentration
    icedepth: torch.Tensor      # (...,)
    snowdepth: torch.Tensor     # (...,)
    usf: torch.Tensor           # (...,) climatological surface currents
    vsf: torch.Tensor


def init_state(ncol: int, nzp1: int, dtype=torch.float64,
               device="cpu") -> State:
    nz = nzp1 - 1
    zf = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return State(
        u=zf(ncol, nzp1, 2), x=zf(ncol, nzp1, 2),
        us=zf(ncol, nzp1, 2, 2), xs=zf(ncol, nzp1, 2, 2),
        hmixd=zf(ncol, 2), old=zi(ncol),
        new=torch.ones((ncol,), dtype=torch.int32, device=device),
        hmix=zf(ncol), kmix=zi(ncol),
        rho=zf(ncol, nzp1), cp=zf(ncol, nzp1), buoy=zf(ncol, nzp1),
        talpha=zf(ncol, nzp1), sbeta=zf(ncol, nzp1), rhoh2o=zf(ncol),
        difm=zf(ncol, nz + 2), difs=zf(ncol, nz + 2), dift=zf(ncol, nz + 2),
        ghat=zf(ncol, nz + 1), rig=zf(ncol, nz + 1),
        dbloc=zf(ncol, nz + 1), shsq=zf(ncol, nz + 1),
        wu=zf(ncol, nz + 1, 2), wx=zf(ncol, nz + 1, 3),
        wxnt=zf(ncol, nz + 1, 2),
        swfrac=zf(ncol, nzp1), swdk_opt=zf(ncol, nz + 1),
        tinc_fcorr=zf(ncol, nzp1), sinc_fcorr=zf(ncol, nzp1),
        ocntcorr=zf(ncol, nzp1), scorr=zf(ncol, nzp1), fcorr=zf(ncol),
        tref=zf(ncol), uref=zf(ncol), vref=zf(ncol), ssurf=zf(ncol),
        freeze_flag=zf(ncol), reset_flag=zf(ncol),
        dampu_flag=zf(ncol), dampv_flag=zf(ncol),
    )


def init_forcing(ncol: int, nzp1: int, dtype=torch.float64,
                 device="cpu") -> Forcing:
    zf = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    sflux = zf(ncol, 6)
    # reference seeds ice-melt with 1e-20 (mckpp_fluxes_mod.F90:27)
    sflux[:, 4] = 1e-20
    return Forcing(
        sflux=sflux, sst0=zf(ncol), fcorr_twod=zf(ncol), sfcorr_twod=zf(ncol),
        fcorr_withz=zf(ncol, nzp1), sfcorr_withz=zf(ncol, nzp1),
        sal_clim=zf(ncol, nzp1), ocnt_clim=zf(ncol, nzp1),
        bottom_temp=zf(ncol),
        iceconc=zf(ncol), icedepth=zf(ncol), snowdepth=zf(ncol),
        usf=zf(ncol), vsf=zf(ncol),
    )


def init_params(ncol: int, nzp1: int, maxmodeadv: int = 6,
                dtype=torch.float64, device="cpu") -> ColumnParams:
    zf = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return ColumnParams(
        f=zf(ncol),
        ocdepth=torch.full((ncol,), -10000.0, dtype=dtype, device=device),
        jerlov=torch.full((ncol,), 2, dtype=torch.int32, device=device),
        l_ocean=torch.ones((ncol,), dtype=torch.bool, device=device),
        run_physics=torch.ones((ncol,), dtype=torch.bool, device=device),
        dlat=zf(ncol), dlon=zf(ncol), sref=zf(ncol), ssref=zf(ncol),
        u_init=zf(ncol, nzp1, 2),
        relax_sst=zf(ncol), relax_sal=zf(ncol), relax_ocnt=zf(ncol),
        cplwght=zf(ncol),
        nmodeadv=zi(ncol, 2), modeadv=zi(ncol, maxmodeadv, 2),
        advection=zf(ncol, maxmodeadv, 2),
    )
