"""Typed configuration for the PyTorch/CUDA KPP framework.

Mirrors the reference's 12 Fortran namelist groups and ~60 ``L_*`` feature
flags (reference: mckpp_namelists.F90:12-129, mckpp_data_fields.F90:263-324)
as frozen dataclasses.  Static booleans specialize the jitted step the way the
reference's compile-time/namelist flags pick code paths.

Derived time quantities follow mckpp_initialize_namelist_mod.F90:172-190:
``dto = dtsec / ndtocn``, ``num_timesteps = nend * ndtocn`` with
``nend = (finalt - startt) / dtsec`` (times in days, converted internally).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from . import constants as c


@dataclass(frozen=True)
class DomainConfig:
    """NAME_DOMAIN + NAME_PARAMETERS grid sizes."""
    nx: int = 1
    ny: int = 1
    nz: int = 40
    dmax: float = 0.0                 # domain depth (m); must be > 0
    # regular-grid generation (when no land-sea file supplies lon/lat)
    alon: float = 0.0
    alat: float = 0.0
    delta_lon: float = 3.75
    delta_lat: float = 2.5
    l_stretchgrid: bool = False
    dscale: float = 0.0               # stretching factor (!=0 when stretched)
    l_reggrid: bool = True
    l_vgrid_file: bool = False
    vgrid_file: str = ""
    l_landsea: bool = False
    landsea_file: str = ""

    @property
    def npts(self) -> int:
        return self.nx * self.ny

    @property
    def nzp1(self) -> int:
        return self.nz + 1


@dataclass(frozen=True)
class TimeConfig:
    """NAME_TIMES (reference: mckpp_initialize_namelist_mod.F90:162-191)."""
    dtsec: float = 3600.0             # atmosphere/forcing step (s)
    ndtocn: int = 1                   # ocean substeps per dtsec
    startt: float = 0.0               # start time (days)
    finalt: float = 1.0               # end time (days)
    spd: float = c.SPD                # seconds per day — participates in the
                                      # reference's derived-time arithmetic
                                      # and is NAME_CONSTANTS-overridable

    @property
    def dto(self) -> float:
        return self.dtsec / float(self.ndtocn)

    @property
    def nend(self) -> int:
        return int(round((self.finalt - self.startt) * self.spd / self.dtsec))

    @property
    def num_timesteps(self) -> int:
        return self.nend * self.ndtocn


@dataclass(frozen=True)
class PhysicsFlags:
    """NAME_PROCSWIT + solver controls (reference defaults at
    mckpp_initialize_namelist_mod.F90:111-119, 27-41)."""
    lkpp: bool = True                 # KPP boundary-layer mixing
    lri: bool = True                  # interior shear-instability mixing
    ldd: bool = False                 # double diffusion
    lice: bool = False
    lbio: bool = False
    lnbflx: bool = False
    l_ssref: bool = True
    itermax: int = 200                # hmix convergence iteration cap
    hmixtolfrac: float = 0.1          # hmix convergence tolerance fraction
    extra_iters: int = 40             # cap on post-itermax "shallower hmix" passes
                                      # (reference loops unboundedly at
                                      # mckpp_physics_ocnstep_mod.F90:176-181)
    solver: str = "pcr"               # tridiagonal solve: "pcr" (parallel
                                      # cyclic reduction); "thomas" is not
                                      # implemented in this package yet
                                      # and raises NotImplementedError
    wscale_mode: str = "auto"         # turbulent velocity scales:
                                      # "auto" -> "analytic" on CUDA
                                      # float32 (exact LMD stability
                                      # functions), "nodal" elsewhere;
                                      # "nodal" = the reference's bilinear
                                      # (zehat, ustar) interpolation
                                      # computed gather-free from node
                                      # formula evaluations; "table" is
                                      # not implemented here and raises
                                      # NotImplementedError
    pass_impl: str = "auto"           # per-pass implementation:
                                      # "eager" (plain torch pass body,
                                      # batch-level loops) | "eager_step"
                                      # (plain torch whole-step body) |
                                      # "cuda" (CUDA pass kernel,
                                      # batch-level loops) | "cuda_step"
                                      # (CUDA whole-step kernel);
                                      # "auto" -> "cuda_step" on a CUDA
                                      # device, "eager_step" on the CPU;
                                      # "reference" raises
                                      # NotImplementedError
    pass_block: int = 256             # the JAX package's Pallas column
                                      # tile, kept so configs carry over;
                                      # the CUDA kernels do not read it
                                      # (one thread per column, 128 per
                                      # block)
    pass_layout: str = "col_lanes"    # fused-kernel data layout: only
                                      # "col_lanes" (profiles (nz+2, ncol)
                                      # inside the kernels); "z_lanes"
                                      # raises


@dataclass(frozen=True)
class ForcingConfig:
    """NAME_FORCING (reference: mckpp_initialize_namelist_mod.F90:232-279)."""
    l_fluxdata: bool = False          # read fluxes from file (else constant test fluxes)
    forcing_file: str = "1D_ocean_forcing.nc"
    l_rest: bool = False              # rest-state test fluxes
    # heat corrections
    l_fcorr: bool = False
    l_fcorr_withz: bool = False
    l_upd_fcorr: bool = False
    l_periodic_fcorr: bool = False
    fcorr_file: str = ""
    ndtupdfcorr: int = 24
    fcorr_period: int = 360
    # salt corrections
    l_sfcorr: bool = False
    l_sfcorr_withz: bool = False
    l_upd_sfcorr: bool = False
    l_periodic_sfcorr: bool = False
    sfcorr_file: str = ""
    ndtupdsfcorr: int = 24
    sfcorr_period: int = 360
    # bottom temperature
    l_vary_bottom_temp: bool = False
    l_upd_bottom_temp: bool = False
    l_periodic_bottom_temp: bool = False
    bottom_file: str = ""
    ndtupdbottom: int = 24
    bottom_temp_period: int = 360
    # 3-D temperature / salinity climatologies
    l_upd_ocnt: bool = False
    l_periodic_ocnt: bool = False
    l_interp_ocnt: bool = False
    ocnt_file: str = "none"
    ndtupdocnt: int = 24
    ocnt_period: int = 360
    ndt_interp_ocnt: int = 1
    l_upd_sal: bool = False
    l_periodic_sal: bool = False
    l_interp_sal: bool = False
    sal_file: str = "none"
    ndtupdsal: int = 24
    sal_period: int = 360
    ndt_interp_sal: int = 1
    # resilience / overrides
    l_no_freeze: bool = False
    l_no_isotherm: bool = False
    isotherm_bottom: int = 0          # iso_bot: deepest level of dT/dz average
    isotherm_threshold: float = 0.002
    l_damp_curr: bool = False
    dtuvdamp: int = 360


@dataclass(frozen=True)
class BoundaryConfig:
    """NAME_COUPLE-ish SST/ice boundary updates + NAME_ADVEC relaxation."""
    # coupling weight (reference: mckpp_initialize_coupling_weight_mod.F90;
    # uncoupled builds read alpha over the KPP domain when l_cplwght is set,
    # and coupled runs gate run_physics on cplwght > 0,
    # mckpp_initialize_fields_mod.F90:146-153)
    l_couple: bool = False
    l_cplwght: bool = False
    cplwght_file: str = ""
    l_climsst: bool = False
    l_upd_climsst: bool = False
    l_periodic_climsst: bool = False
    sst_file: str = ""
    ndtupdsst: int = 24
    climsst_period: int = 360
    l_climice: bool = False
    l_upd_climice: bool = False
    l_periodic_climice: bool = False
    ice_file: str = ""
    ndtupdice: int = 24
    climice_period: int = 360
    l_clim_ice_depth: bool = False
    l_clim_snow_on_ice: bool = False
    l_climcurr: bool = False          # climatological surface currents (the
                                      # reference has no reader for them; the
                                      # SST read zeroes usf/vsf when off,
                                      # mckpp_read_sst_mod.F90:92-96)
    # relaxation (NAME_ADVEC; reference: mckpp_initialize_relaxation_mod.F90)
    l_relax_sst: bool = False
    l_relax_calconly: bool = False
    l_relax_sal: bool = False
    l_relax_ocnt: bool = False
    relax_sst_in: Tuple[float, ...] = ()    # per-latitude-row timescales (days)
    relax_sal_in: Tuple[float, ...] = ()
    relax_ocnt_in: Tuple[float, ...] = ()
    # advection corrections
    l_advect: bool = False
    advect_file: str = ""


@dataclass(frozen=True)
class InitConfig:
    """NAME_START + NAME_PARAS (optics)."""
    l_initdata: bool = True
    initdata_file: str = ""
    l_interpinit: bool = True
    l_restart: bool = False
    restart_infile: str = ""
    l_jerlov: bool = True             # read per-column Jerlov type from paras file
    paras_file: str = "3D_ocnparas.nc"
    jerlov_default: int = 3           # water type IB (reference: mckpp_initialize_optics_mod.F90)


@dataclass(frozen=True)
class OutputConfig:
    """NAME_OUTPUT + diagnostics streams (XIOS iodef.xml equivalent)."""
    l_restartw: bool = True
    restart_outfile: str = "restart"
    ndt_per_restart: int = 0          # 0 -> only at end of run
    # additionally write each restart in the reference's NetCDF format
    # (mckpp_xios_io.F90:406-433) for MC-KPP tooling interop
    l_restart_netcdf: bool = False
    output_dir: str = "."
    # list of (name, reduction, frequency-in-steps); reduction in
    # {"instant", "average", "minimum", "maximum"}
    streams: Tuple[Tuple[str, str, int], ...] = ()
    # file-splitting window in days (iodef.xml split_freq="1d" equivalent);
    # None -> one file per stream
    split_freq_days: Optional[float] = None
    # path to an iodef.xml-style stream-config file (io/streams.py);
    # overrides default_streams when `streams` is empty
    iodef_file: str = ""


@dataclass(frozen=True)
class KppConfig:
    """Top-level configuration: the union of all namelist groups."""
    domain: DomainConfig = field(default_factory=DomainConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    physics: PhysicsFlags = field(default_factory=PhysicsFlags)
    forcing: ForcingConfig = field(default_factory=ForcingConfig)
    boundary: BoundaryConfig = field(default_factory=BoundaryConfig)
    init: InitConfig = field(default_factory=InitConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    # NAME_CONSTANTS: run-overridable physical constants
    # (mckpp_initialize_namelist_mod.F90:92-107); trace-time floats
    # threaded into the kernels
    constants: c.Constants = field(default_factory=c.Constants)
    dtype: str = "float64"            # "float64" (parity) | "float32" (perf)

    def validate(self) -> "KppConfig":
        """Cross-field checks mirroring the reference's namelist aborts
        (mckpp_initialize_namelist_mod.F90:53-68,134-141,168-188,251-279)."""
        d, t, f = self.domain, self.time, self.forcing
        if d.nx <= 0 or d.ny <= 0 or d.nz <= 0:
            raise ValueError("nx, ny and nz must be positive")
        if d.dmax <= 0.0 and not d.l_vgrid_file:
            raise ValueError("You must specify a depth (dmax) for the domain")
        if d.l_stretchgrid and d.dscale == 0.0:
            raise ValueError("You cannot have dscale=0 for stretched grids")
        if t.dtsec <= 0.0 or t.startt < 0.0 or t.finalt < 0.0:
            raise ValueError("dtsec, startt and finalt must be specified")
        span = (t.finalt - t.startt) * t.spd
        if abs(t.num_timesteps * t.dto - span) > 1e-6 * max(1.0, span):
            raise ValueError("The integration length is not a multiple of the ocean timestep")
        if f.l_fcorr and f.l_fcorr_withz:
            raise ValueError("L_FCORR and L_FCORR_WITHZ are mutually exclusive")
        if f.l_sfcorr and f.l_sfcorr_withz:
            raise ValueError("L_SFCORR and L_SFCORR_WITHZ are mutually exclusive")
        if f.l_fcorr_withz and self.boundary.l_relax_sst:
            raise ValueError("L_FCORR_WITHZ and L_RELAX_SST are mutually exclusive")
        if f.l_no_isotherm and (f.ocnt_file in ("", "none") or f.sal_file in ("", "none")):
            raise ValueError("L_NO_ISOTHERM requires ocnT_file and sal_file")
        return self

    def replace(self, **kw) -> "KppConfig":
        return dataclasses.replace(self, **kw)
