"""Fortran-namelist ingestion: parse the reference's ``3D_ocn.nml`` format
and map the 12 groups onto :class:`~mckpp_torch.config.KppConfig` (a copy
of ``mckpp_tpu/utils/namelist.py``, which the port may not import).

Group/variable names follow mckpp_namelists.F90:12-129; defaults and
derived-quantity semantics follow mckpp_initialize_namelist_mod.F90.
Declared-but-inert variables (Fortran sizing parameters; flags the
reference stores but never reads) are collected into ``extras`` so
reference namelists run unchanged; variables OUTSIDE a group's reference
declaration abort like the Fortran READ would, and non-default values of
the unimplemented coupled-grid index window refuse loudly (no silent
drops — see _DECLARED).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

from ..config import (KppConfig, DomainConfig, TimeConfig, PhysicsFlags,
                      ForcingConfig, BoundaryConfig, InitConfig, OutputConfig)
from ..constants import Constants

_GROUP_RE = re.compile(r"&(\w+)(.*?)(?:&END|/)\s*", re.S | re.I)


def _parse_value(tok: str) -> Any:
    t = tok.strip()
    if not t:
        return None
    up = t.upper().rstrip(".").lstrip(".")
    if t.upper() in (".T.", ".TRUE.", "T", "TRUE"):
        return True
    if t.upper() in (".F.", ".FALSE.", "F", "FALSE"):
        return False
    if (t.startswith("'") and t.endswith("'")) or (t.startswith('"') and t.endswith('"')):
        return t[1:-1]
    # repeat syntax n*value
    m = re.fullmatch(r"(\d+)\*(.+)", t)
    if m:
        return [_parse_value(m.group(2))] * int(m.group(1))
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t.replace("d", "e").replace("D", "E"))
    except ValueError:
        return t


def _split_values(raw: str):
    """Split a namelist RHS on commas not inside quotes."""
    out, buf, q = [], "", None
    for ch in raw:
        if q:
            buf += ch
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            buf += ch
        elif ch == ",":
            out.append(buf)
            buf = ""
        else:
            buf += ch
    if buf.strip():
        out.append(buf)
    return [b for b in (s.strip() for s in out) if b]


def parse_namelist(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse namelist text into {GROUP: {var: value}} (names upper-cased)."""
    groups: Dict[str, Dict[str, Any]] = {}
    for m in _GROUP_RE.finditer(text):
        gname = m.group(1).upper()
        body = m.group(2)
        entries: Dict[str, Any] = {}
        # tokenize assignments: var = v1, v2, ...  var2 = ...
        assigns = re.split(r"(\w+(?:\([^)]*\))?)\s*=", body)
        # assigns[0] is leading junk; pairs follow
        for i in range(1, len(assigns) - 1, 2):
            var = assigns[i].strip().upper()
            raw = assigns[i + 1].strip().rstrip(",").strip()
            vals = [_parse_value(v) for v in _split_values(raw)]
            flat = []
            for v in vals:
                flat.extend(v if isinstance(v, list) else [v])
            entries[var] = flat[0] if len(flat) == 1 else flat
        groups[gname] = entries
    return groups


def _get(groups, gname, var, default=None):
    return groups.get(gname, {}).get(var.upper(), default)


# Every variable DECLARED in the reference's namelist groups
# (mckpp_namelists.F90:12-129).  A variable outside its group's declaration
# would make the Fortran READ error out, so the ingester refuses it too;
# a declared variable the config does not model is either dead in the
# reference as well (stored by mckpp_initialize_constants_mod.F90 and never
# used, or only used in commented-out code) — accepted and returned in
# ``extras`` — or live-but-unsupported (the coupled-grid index window
# ifirst/ilast/jfirst/jlast, README "Intentional deviations"), which aborts
# on any non-default value rather than silently shifting nothing.
_DECLARED = {
    "NAME_ADVEC": {"L_ADVECT", "ADVECT_FILE", "L_RELAX_SST", "RELAX_SST_IN",
                   "RELAX_SAL_IN", "L_RELAX_CALCONLY", "L_RELAX_SAL",
                   "L_RELAX_OCNT", "RELAX_OCNT_IN"},
    "NAME_CONSTANTS": {"GRAV", "VONK", "SBC", "TWOPI", "ONEPI", "TK0", "SPD",
                       "DPY", "EPSW", "ALBOCN", "SICE", "EL", "SL", "FL",
                       "FLSN"},
    "NAME_COUPLE": {"L_COUPLE", "IFIRST", "ILAST", "JFIRST", "JLAST",
                    "L_CLIMSST", "SSTIN_FILE", "L_UPD_CLIMSST", "NDTUPDSST",
                    "L_CPLWGHT", "CPLWGHT_FILE", "ICEIN_FILE", "L_CLIMICE",
                    "L_UPD_CLIMICE", "NDTUPDICE", "L_CLIM_ICE_DEPTH",
                    "L_CLIM_SNOW_ON_ICE", "L_OUTKELVIN", "L_COUPLE_CURRENTS",
                    "CURRIN_FILE", "L_CLIMCURR", "L_UPD_CLIMCURR",
                    "NDTUPDCURR", "L_PERIODIC_CLIMICE", "L_PERIODIC_CLIMSST",
                    "CLIMSST_PERIOD", "CLIMICE_PERIOD", "L_BAD_ICE_DEPTH"},
    "NAME_DOMAIN": {"DMAX", "ALON", "ALAT", "DELTA_LAT", "DELTA_LON",
                    "L_STRETCHGRID", "DSCALE", "L_REGGRID", "L_VGRID_FILE",
                    "VGRID_FILE"},
    "NAME_FORCING": {"L_FLUXDATA", "FORCING_FILE", "L_FCORR_WITHZ",
                     "FCORRIN_FILE", "NDTUPDFCORR", "L_VARY_BOTTOM_TEMP",
                     "NDTUPDBOTTOM", "BOTTOMIN_FILE", "L_FCORR",
                     "L_UPD_FCORR", "L_UPD_BOTTOM_TEMP", "L_REST",
                     "L_PERIODIC_FCORR", "L_PERIODIC_BOTTOM_TEMP",
                     "FCORR_PERIOD", "L_SFCORR_WITHZ", "SFCORRIN_FILE",
                     "NDTUPDSFCORR", "L_SFCORR", "L_UPD_SFCORR",
                     "L_PERIODIC_SFCORR", "SFCORR_PERIOD",
                     "BOTTOM_TEMP_PERIOD", "SAL_FILE", "L_UPD_SAL",
                     "L_PERIODIC_SAL", "SAL_PERIOD", "NDTUPDSAL",
                     "OCNT_FILE", "L_UPD_OCNT", "L_PERIODIC_OCNT",
                     "OCNT_PERIOD", "NDTUPDOCNT", "L_NO_FREEZE",
                     "L_NO_ISOTHERM", "ISOTHERM_BOTTOM",
                     "ISOTHERM_THRESHOLD", "L_DAMP_CURR", "DTUVDAMP",
                     "L_INTERP_OCNT", "NDT_INTERP_OCNT", "L_INTERP_SAL",
                     "NDT_INTERP_SAL"},
    "NAME_LANDSEA": {"L_LANDSEA", "LANDSEA_FILE"},
    # IODEF_FILE / L_RESTART_NETCDF are this framework's extensions
    "NAME_OUTPUT": {"L_RESTARTW", "RESTART_OUTFILE", "NDT_PER_RESTART",
                    "IODEF_FILE", "L_RESTART_NETCDF"},
    "NAME_PARAMETERS": {"NZ", "NDIM", "NX", "NY", "NVEL", "NSCLR", "NSB",
                        "ITERMAX", "HMIXTOLFRAC", "NGRID", "NZL", "NZU",
                        "NZDIVMAX", "NZTMAX", "IGRIDMAX", "NSFLXS", "NJDT",
                        "NDHARM", "MAXMODEADV", "MR", "NX_GLOBE",
                        "NY_GLOBE"},
    "NAME_PARAS": {"PARAS_FILE", "L_JERLOV"},
    "NAME_PROCSWIT": {"LKPP", "LRI", "LDD", "LICE", "LBIO", "LNBFLX",
                      "LTGRID", "LRHS", "L_SSREF"},
    "NAME_START": {"L_INITDATA", "INITDATA_FILE", "L_INTERPINIT",
                   "L_RESTART", "RESTART_INFILE"},
    "NAME_TIMES": {"DTSEC", "STARTT", "FINALT", "NDTOCN", "NYEAR"},
}


def config_from_namelist(text: str) -> Tuple[KppConfig, Dict[str, Any]]:
    """Build a KppConfig from reference namelist text.

    Returns (config, extras) where extras holds declared-but-inert values
    the config does not model: Fortran array-sizing parameters
    (NAME_PARAMETERS nztmax/ngrid/... — shapes derive from data here) and
    flags that are dead in the reference too (LBIO, L_OUTKELVIN, the
    commented-out current-climatology controls, nyear).  An UNDECLARED
    variable raises, as the Fortran READ would; a non-default coupled-grid
    index window (ifirst/ilast/jfirst/jlast) raises because index-wired
    subdomain addressing is an intentional deviation (README).
    """
    g = parse_namelist(text)
    consumed = set()

    def get(grp, var, d=None):
        consumed.add((grp.upper(), var.upper()))
        return _get(g, grp, var, d)

    # NAME_CONSTANTS: the 15 overridable physical constants
    # (mckpp_initialize_namelist_mod.F90:92-107).  Unknown variable names
    # in the group abort, like the Fortran READ would.
    cvars = dict(g.get("NAME_CONSTANTS", {}))
    ckw = {}
    for name in ("SPD", "DPY", "TWOPI", "ONEPI", "GRAV", "VONK", "TK0",
                 "SBC", "EPSW", "ALBOCN", "SICE", "EL", "SL", "FL", "FLSN"):
        if name in cvars:
            ckw[name.lower()] = float(cvars.pop(name))
    if cvars:
        raise ValueError(
            f"unknown NAME_CONSTANTS variables {sorted(cvars)} — the "
            "reference namelist group holds only spd/dpy/twopi/onepi/grav/"
            "vonk/TK0/sbc/epsw/albocn/sice/EL/SL/FL/FLSN")
    constants = Constants(**ckw)

    domain = DomainConfig(
        nx=int(get("NAME_PARAMETERS", "NX", 1)),
        ny=int(get("NAME_PARAMETERS", "NY", 1)),
        nz=int(get("NAME_PARAMETERS", "NZ", 40)),
        dmax=float(get("NAME_DOMAIN", "DMAX", 0.0)),
        alon=float(get("NAME_DOMAIN", "ALON", 0.0)),
        alat=float(get("NAME_DOMAIN", "ALAT", 0.0)),
        delta_lon=float(get("NAME_DOMAIN", "DELTA_LON", 3.75)),
        delta_lat=float(get("NAME_DOMAIN", "DELTA_LAT", 2.5)),
        l_stretchgrid=bool(get("NAME_DOMAIN", "L_STRETCHGRID", False)),
        dscale=float(get("NAME_DOMAIN", "DSCALE", 0.0)),
        l_reggrid=bool(get("NAME_DOMAIN", "L_REGGRID", True)),
        l_vgrid_file=bool(get("NAME_DOMAIN", "L_VGRID_FILE", False)),
        vgrid_file=str(get("NAME_DOMAIN", "VGRID_FILE", "")),
        l_landsea=bool(get("NAME_LANDSEA", "L_LANDSEA", False)),
        landsea_file=str(get("NAME_LANDSEA", "LANDSEA_FILE", "")),
    )
    time = TimeConfig(
        dtsec=float(get("NAME_TIMES", "DTSEC", 0.0)),
        ndtocn=int(get("NAME_TIMES", "NDTOCN", 1)),
        startt=float(get("NAME_TIMES", "STARTT", -999.999)),
        finalt=float(get("NAME_TIMES", "FINALT", -999.999)),
        spd=constants.spd,
    )
    physics = PhysicsFlags(
        lkpp=bool(get("NAME_PROCSWIT", "LKPP", True)),
        lri=bool(get("NAME_PROCSWIT", "LRI", True)),
        ldd=bool(get("NAME_PROCSWIT", "LDD", False)),
        lice=bool(get("NAME_PROCSWIT", "LICE", False)),
        l_ssref=bool(get("NAME_PROCSWIT", "L_SSREF", True)),
        itermax=int(get("NAME_PARAMETERS", "ITERMAX", 200)),
        hmixtolfrac=float(get("NAME_PARAMETERS", "HMIXTOLFRAC", 0.1)),
    )
    fg = "NAME_FORCING"
    forcing = ForcingConfig(
        l_fluxdata=bool(get(fg, "L_FLUXDATA", False)),
        forcing_file=str(get(fg, "FORCING_FILE", "1D_ocean_forcing.nc")),
        l_rest=bool(get(fg, "L_REST", False)),
        l_fcorr=bool(get(fg, "L_FCORR", False)),
        l_fcorr_withz=bool(get(fg, "L_FCORR_WITHZ", False)),
        l_upd_fcorr=bool(get(fg, "L_UPD_FCORR", False)),
        l_periodic_fcorr=bool(get(fg, "L_PERIODIC_FCORR", False)),
        fcorr_file=str(get(fg, "FCORRIN_FILE", "")),
        ndtupdfcorr=int(get(fg, "NDTUPDFCORR", 24)),
        fcorr_period=int(get(fg, "FCORR_PERIOD", 360)),
        l_sfcorr=bool(get(fg, "L_SFCORR", False)),
        l_sfcorr_withz=bool(get(fg, "L_SFCORR_WITHZ", False)),
        l_upd_sfcorr=bool(get(fg, "L_UPD_SFCORR", False)),
        l_periodic_sfcorr=bool(get(fg, "L_PERIODIC_SFCORR", False)),
        sfcorr_file=str(get(fg, "SFCORRIN_FILE", "")),
        ndtupdsfcorr=int(get(fg, "NDTUPDSFCORR", 24)),
        sfcorr_period=int(get(fg, "SFCORR_PERIOD", 360)),
        l_vary_bottom_temp=bool(get(fg, "L_VARY_BOTTOM_TEMP", False)),
        l_upd_bottom_temp=bool(get(fg, "L_UPD_BOTTOM_TEMP", False)),
        l_periodic_bottom_temp=bool(get(fg, "L_PERIODIC_BOTTOM_TEMP", False)),
        bottom_file=str(get(fg, "BOTTOMIN_FILE", "")),
        ndtupdbottom=int(get(fg, "NDTUPDBOTTOM", 24)),
        bottom_temp_period=int(get(fg, "BOTTOM_TEMP_PERIOD", 360)),
        l_upd_ocnt=bool(get(fg, "L_UPD_OCNT", False)),
        l_periodic_ocnt=bool(get(fg, "L_PERIODIC_OCNT", False)),
        l_interp_ocnt=bool(get(fg, "L_INTERP_OCNT", False)),
        ocnt_file=str(get(fg, "OCNT_FILE", "none")),
        ndtupdocnt=int(get(fg, "NDTUPDOCNT", 24)),
        ocnt_period=int(get(fg, "OCNT_PERIOD", 360)),
        ndt_interp_ocnt=int(get(fg, "NDT_INTERP_OCNT", 1)),
        l_upd_sal=bool(get(fg, "L_UPD_SAL", False)),
        l_periodic_sal=bool(get(fg, "L_PERIODIC_SAL", False)),
        l_interp_sal=bool(get(fg, "L_INTERP_SAL", False)),
        sal_file=str(get(fg, "SAL_FILE", "none")),
        ndtupdsal=int(get(fg, "NDTUPDSAL", 24)),
        sal_period=int(get(fg, "SAL_PERIOD", 360)),
        ndt_interp_sal=int(get(fg, "NDT_INTERP_SAL", 1)),
        l_no_freeze=bool(get(fg, "L_NO_FREEZE", False)),
        l_no_isotherm=bool(get(fg, "L_NO_ISOTHERM", False)),
        isotherm_bottom=int(get(fg, "ISOTHERM_BOTTOM", 0)),
        isotherm_threshold=float(get(fg, "ISOTHERM_THRESHOLD", 0.002)),
        l_damp_curr=bool(get(fg, "L_DAMP_CURR", False)),
        dtuvdamp=int(get(fg, "DTUVDAMP", 360)),
    )
    boundary = BoundaryConfig(
        l_climsst=bool(get("NAME_COUPLE", "L_CLIMSST", False)),
        l_upd_climsst=bool(get("NAME_COUPLE", "L_UPD_CLIMSST", False)),
        l_periodic_climsst=bool(get("NAME_COUPLE", "L_PERIODIC_CLIMSST", False)),
        sst_file=str(get("NAME_COUPLE", "SSTIN_FILE", "")),
        ndtupdsst=int(get("NAME_COUPLE", "NDTUPDSST", 24)),
        climsst_period=int(get("NAME_COUPLE", "CLIMSST_PERIOD", 360)),
        l_climice=bool(get("NAME_COUPLE", "L_CLIMICE", False)),
        l_upd_climice=bool(get("NAME_COUPLE", "L_UPD_CLIMICE", False)),
        l_periodic_climice=bool(get("NAME_COUPLE", "L_PERIODIC_CLIMICE", False)),
        ice_file=str(get("NAME_COUPLE", "ICEIN_FILE", "")),
        ndtupdice=int(get("NAME_COUPLE", "NDTUPDICE", 24)),
        climice_period=int(get("NAME_COUPLE", "CLIMICE_PERIOD", 360)),
        l_clim_ice_depth=bool(get("NAME_COUPLE", "L_CLIM_ICE_DEPTH", False)),
        l_clim_snow_on_ice=bool(get("NAME_COUPLE", "L_CLIM_SNOW_ON_ICE", False)),
        l_climcurr=bool(get("NAME_COUPLE", "L_CLIMCURR", False)),
        l_couple=bool(get("NAME_COUPLE", "L_COUPLE", False)),
        l_cplwght=bool(get("NAME_COUPLE", "L_CPLWGHT", False)),
        cplwght_file=str(get("NAME_COUPLE", "CPLWGHT_FILE", "")),
        l_relax_sst=bool(get("NAME_ADVEC", "L_RELAX_SST", False)),
        l_relax_calconly=bool(get("NAME_ADVEC", "L_RELAX_CALCONLY", False)),
        l_relax_sal=bool(get("NAME_ADVEC", "L_RELAX_SAL", False)),
        l_relax_ocnt=bool(get("NAME_ADVEC", "L_RELAX_OCNT", False)),
        relax_sst_in=tuple(_aslist(get("NAME_ADVEC", "RELAX_SST_IN", []))),
        relax_sal_in=tuple(_aslist(get("NAME_ADVEC", "RELAX_SAL_IN", []))),
        relax_ocnt_in=tuple(_aslist(get("NAME_ADVEC", "RELAX_OCNT_IN", []))),
        l_advect=bool(get("NAME_ADVEC", "L_ADVECT", False)),
        advect_file=str(get("NAME_ADVEC", "ADVECT_FILE", "")),
    )
    init = InitConfig(
        l_initdata=bool(get("NAME_START", "L_INITDATA", True)),
        initdata_file=str(get("NAME_START", "INITDATA_FILE", "")),
        l_interpinit=bool(get("NAME_START", "L_INTERPINIT", True)),
        l_restart=bool(get("NAME_START", "L_RESTART", False)),
        restart_infile=str(get("NAME_START", "RESTART_INFILE", "")),
        l_jerlov=bool(get("NAME_PARAS", "L_JERLOV", True)),
        paras_file=str(get("NAME_PARAS", "PARAS_FILE", "3D_ocnparas.nc")),
    )
    output = OutputConfig(
        l_restartw=bool(get("NAME_OUTPUT", "L_RESTARTW", True)),
        restart_outfile=str(get("NAME_OUTPUT", "RESTART_OUTFILE", "restart")),
        ndt_per_restart=int(get("NAME_OUTPUT", "NDT_PER_RESTART", 0)),
        iodef_file=str(get("NAME_OUTPUT", "IODEF_FILE", "")),
        l_restart_netcdf=bool(get("NAME_OUTPUT", "L_RESTART_NETCDF", False)),
    )
    cfg = KppConfig(domain=domain, time=time, physics=physics,
                    forcing=forcing, boundary=boundary, init=init,
                    output=output, constants=constants)
    # Unknown GROUPS pass through to extras: the Fortran READs seek each
    # named group and skip everything else in the file.  Within a known
    # group, every unconsumed variable is checked against the reference's
    # declaration (see _DECLARED).
    extras: Dict[str, Any] = {k: dict(v) for k, v in g.items()
                              if k not in _DECLARED}
    couple_defaults = {"IFIRST": 1, "ILAST": domain.nx,
                       "JFIRST": 1, "JLAST": domain.ny}
    for grp, declared in _DECLARED.items():
        if grp == "NAME_CONSTANTS":
            continue                     # fully validated above
        for var, val in g.get(grp, {}).items():
            if (grp, var) in consumed:
                continue
            base = re.sub(r"\([^)]*\)$", "", var)
            if base not in declared:
                raise ValueError(
                    f"unknown namelist variable {var} in {grp} — the "
                    "reference's READ rejects variables outside the "
                    "group declaration (mckpp_namelists.F90:12-129)")
            if base != var:
                raise ValueError(
                    f"indexed namelist assignment {grp}%{var} is not "
                    f"supported — write the whole {base} array instead")
            if base in couple_defaults:
                try:
                    window = int(val) == couple_defaults[base]
                except (TypeError, ValueError):   # a list or a string
                    window = False
                if not window:
                    raise ValueError(
                        f"{grp}%{base}={val}: coupled-grid index "
                        "addressing (ifirst/ilast/jfirst/jlast != domain "
                        "window) is not implemented — subdomains are "
                        "selected by lon/lat coordinate match (README "
                        "'Intentional deviations'; "
                        "mckpp_physics_overrides.F90:28-39)")
            # declared but inert (dead in the reference too, or Fortran
            # array sizing): accept and surface in extras
            extras.setdefault(grp, {})[var] = val
    return cfg, extras


def _aslist(v):
    if v is None or v == []:
        return []
    return v if isinstance(v, list) else [v]


def load_config(path: str) -> Tuple[KppConfig, Dict[str, Any]]:
    with open(path) as f:
        return config_from_namelist(f.read())
