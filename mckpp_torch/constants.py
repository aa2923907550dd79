"""Physical constants for the KPP ocean mixed-layer model (a copy of
``mckpp_tpu/constants.py``, which the port may not import).

Values mirror the reference defaults set before the constants namelist read
(reference: mckpp_initialize_namelist_mod.F90:92-106) and the physics-internal
parameter blocks.  All are plain Python floats; arrays are built at trace time
in the dtype of the surrounding computation.

The 15 NAME_CONSTANTS values the reference reads from the namelist
(mckpp_initialize_namelist_mod.F90:92-107, copied into the model at
mckpp_initialize_constants_mod.F90:5-153) are overridable per run through
:class:`Constants` (attached as ``KppConfig.constants`` and threaded into
the kernels as trace-time floats).  The module-level names below remain the
reference defaults, used by the non-overridable parameter blocks and as the
``Constants`` field defaults.
"""

import dataclasses
import math

SPD = 86400.0          # seconds per day
DPY = 360.0            # days per year
TWOPI = 8.0 * math.atan(1.0)
ONEPI = TWOPI / 2.0
GRAV = 9.816           # gravity (m/s^2)
VONK = 0.4             # von Karman constant
TK0 = 273.15           # 0 degC in Kelvin
SBC = 5.67e-8          # Stefan-Boltzmann
EPSW = 1.0             # emissivity correction for water
ALBOCN = 0.06          # seawater albedo
SICE = 4.0             # salinity of sea ice (psu)
EL = 2.50e6            # latent heat of evaporation at 0C (J/kg)
SL = 2512200.0         # latent heat of evaporation for ice
FL = 334000.0          # latent heat of fusion for ice
FLSN = FL              # latent heat of fusion for snow

# Sidereal-day-based planetary rotation used in Coriolis
# (reference: mckpp_initialize_geography_mod.F90:80-87)
SIDEREAL_DAY = 86164.0


@dataclasses.dataclass(frozen=True)
class Constants:
    """The NAME_CONSTANTS namelist group: the 15 physical constants the
    reference lets a run override (mckpp_initialize_namelist_mod.F90:92-107;
    field names follow the Fortran variables, lower-cased).

    Of these, the reference's own downstream code consumes only
    ``grav``/``vonk`` (physics kernels), ``spd`` (time control, boundary
    interpolation, relaxation) and ``twopi`` (Coriolis) — plus ``sice``,
    ``el``/``flsn`` and ``tk0`` in the flux/ancillary conversions this
    framework also performs.  ``dpy``, ``onepi``, ``sbc``, ``epsw``,
    ``albocn``, ``sl`` and ``fl`` are copied into the reference's constants
    struct but never read by any reference routine (verified by grep over
    the reference's src/), so accepting-and-storing them without further
    effect is exact parity.  Note the reference assigns ``FLSN=FL`` BEFORE
    the namelist read, so overriding ``fl`` alone does NOT change ``flsn``
    — the independent defaults here reproduce that.
    """
    spd: float = SPD
    dpy: float = DPY
    twopi: float = TWOPI
    onepi: float = ONEPI
    grav: float = GRAV
    vonk: float = VONK
    tk0: float = TK0
    sbc: float = SBC
    epsw: float = EPSW
    albocn: float = ALBOCN
    sice: float = SICE
    el: float = EL
    sl: float = SL
    fl: float = FL
    flsn: float = FLSN

# KPP scheme parameters (reference: bldepth/blmix/wscale/rimix parameter blocks)
RICR = 0.30            # critical bulk Richardson number
EPSILON_KPP = 0.1      # nondimensional extent of the surface layer
CEKMAN = 0.7           # Ekman-depth coefficient
CMONOB = 1.0           # Monin-Obukhov depth coefficient
CS = 98.96             # unstable scalar-profile constant
CV = 1.6               # turbulent-shear coefficient in Vt^2
AM = 1.257
CM = 8.380
AS_WS = -28.86
C1_WS = 5.0
C2_WS = 16.0
C3_WS = 16.0
ZETAM = -0.2
ZETAS = -1.0
CSTAR = 5.0            # nonlocal-transport proportionality

# wscale lookup-table geometry (reference: mckpp_physics_lookup_mod.F90:21-40)
WS_NI = 890            # zehat samples
WS_NJ = 48             # ustar samples
WS_ZMIN = -4.0e-7
WS_ZMAX = 0.0
WS_UMIN = 0.0
WS_UMAX = 0.04

# rimix parameters (reference: mckpp_physics_verticalmixing_rimix_mod.F90:27-38)
RIINFTY = 0.8
RICON = -0.2
DIFM0 = 0.005
DIFS0 = 0.005
DIFMIW = 1.0e-4
DIFSIW = 1.0e-5
DIFMCON = 0.0
DIFSCON = 0.0

# ddmix parameters (reference: mckpp_physics_verticalmixing_ddmix_mod.F90:27-28)
RRHO0 = 1.9
DSFMAX = 1.0e-4

# bottom diffusivity limits (reference: mckpp_physics_verticalmixing_mod.F90:151-152)
DLIMIT_BOTTOM = 1.0e-5
VLIMIT_BOTTOM = 1.0e-4

# ocnstep iteration control (reference: mckpp_physics_ocnstep_mod.F90:71-78)
COMP_ITER_MAX = 10
RMSD_THRESHOLD = (1.0, 1.0, 1.0, 1.0)
LAMBDA_SMOOTH = 0.5
RHONOT = 1026.0

# Jerlov water-type two-band solar absorption table
# (reference: mckpp_physics_swfrac_mod.F90:31-33); index 0..4 = types I,IA,IB,II,III
JERLOV_RFAC = (0.58, 0.62, 0.67, 0.77, 0.78)
JERLOV_A1 = (0.35, 0.6, 1.0, 1.5, 1.4)
JERLOV_A2 = (23.0, 20.0, 17.0, 14.0, 7.9)
SWFRAC_RMIN = -80.0
