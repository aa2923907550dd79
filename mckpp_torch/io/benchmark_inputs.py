"""Input sets for the five BASELINE.json benchmark configurations,
written through the port's own NetCDF writer (a copy of
``tools/make_benchmark_configs.py``, whose module imports the JAX package
and so cannot run where the port runs alone).

Synthetic data on the reference's file formats, since the TerraMaris
ancillaries are not redistributable:

1. ``single_column``: 1 column x 100 levels over 2000 m, constant
   analytic fluxes (``L_FLUXDATA=.F.``);
2. ``regional_64x64``: 64 x 64 columns, nz = 40 over 500 m, a flux file
   and SST relaxation to ``sst.nc``;
3. ``terramaris``: 453 x 319 columns, nz = 69 over 1000 m, 12% islands
   drawn from ``numpy.random.default_rng(0)``, a flux file, the SST
   climatology with relaxation and a restart every 72 steps (the
   reference test job's shape);
4. ``global_1deg``: 360 x 180 columns, nz = 40 over 1000 m, a land-sea
   mask from ``default_rng(1)`` (about 70% wet), a flux file;
5. ``ensemble10_dd``: the global set with ``LKPP/LRI/LDD=.T.`` (the
   members are replicated columns, made by the runner).

``generate`` also writes ``goml2_n216``, which ``CONFIGS`` leaves out
(the JAX tool has no such set to match): MetUM-GOML2's N216 grid, 432 x
324 columns from 0.4167 E, 89.7222 S at 0.8333 x 0.5556 degrees, with
MetUM-GOML1's column, 100 uniform levels over 1000 m; exactly 40% land
and sea ice drawn from ``default_rng(2)``, analytic fluxes, the SST
climatology (40 records) with relaxation on every row, the 4-slot
one-warp kernels' deployment.

Every set has the five-stream iodef.  ``--toy`` (``toy=True``) shrinks
the horizontal grid by 8 (the regional grid to ``max(8, 64 // 8)``, the
global grid to 45 x 22 from 45 S in 2-degree rows).

    python -m mckpp_torch.tools.make_benchmark_configs CONFIG OUTDIR [--toy]
"""

from __future__ import annotations

import os

import numpy as np

from . import ncio

SPD = 86400.0


def _grids(nx, ny, nz, dmax, lon0, lat0, dlon, dlat):
    lons = lon0 + dlon * np.arange(nx)
    lats = lat0 + dlat * np.arange(ny)
    h = np.full(nz, dmax / nz)
    zf = -(np.cumsum(h) - 0.5 * h)
    dd = np.cumsum(h)
    return lons, lats, h, zf, dd


def _write_common(d, lons, lats, h, zf, dd, lsm, depth):
    nx, ny, nz = len(lons), len(lats), len(h)
    ncio.write_fields(
        f"{d}/lsm.nc", {"longitude": nx, "latitude": ny},
        {"longitude": ("longitude", lons), "latitude": ("latitude", lats)},
        {"lsm": (("latitude", "longitude"), lsm),
         "max_depth": (("latitude", "longitude"), depth)})
    ncio.write_fields(f"{d}/vgrid.nc", {"z": nz}, {"z": ("z", zf)},
                      {"d": (("z",), dd), "h": (("z",), h)})
    zin = -np.asarray([1.0, 30.0, 100.0, 400.0, 1500.0])
    zin = zin[zin > zf[-1] * 1.5] if len(zin[zin > zf[-1] * 1.5]) >= 2 \
        else zin[:2]
    t_in = 24.0 - 14.0 * (1.0 - np.exp(zin / 250.0))
    t_prof = np.tile(t_in[:, None, None], (1, ny, nx))
    s_prof = np.tile((35.2 + 0.004 * np.abs(zin))[:, None, None], (1, ny, nx))
    uv = np.zeros((len(zin), ny, nx))
    ncio.write_fields(
        f"{d}/init.nc",
        {"zvel": len(zin), "ztemp": len(zin), "zsal": len(zin),
         "longitude": nx, "latitude": ny},
        {"zvel": ("zvel", zin), "ztemp": ("ztemp", zin), "zsal": ("zsal", zin),
         "longitude": ("longitude", lons), "latitude": ("latitude", lats)},
        {"u": (("zvel", "latitude", "longitude"), uv),
         "v": (("zvel", "latitude", "longitude"), uv),
         "temp": (("ztemp", "latitude", "longitude"), t_prof),
         "sal": (("zsal", "latitude", "longitude"), s_prof)})
    ncio.write_fields(
        f"{d}/paras.nc", {"longitude": nx, "latitude": ny},
        {"longitude": ("longitude", lons), "latitude": ("latitude", lats)},
        {"jerlov": (("latitude", "longitude"), np.full((ny, nx), 3.0))})



def _write_fluxes(d, lons, lats, ntimes, dtsec):
    nx, ny = len(lons), len(lats)
    ftimes = (np.arange(ntimes) + 0.5) * dtsec / SPD
    rng = np.random.default_rng(7)
    lat2 = np.tile(lats[:, None], (1, nx))
    shp = (ntimes, ny, nx)
    diurnal = np.maximum(0.0, np.sin(2 * np.pi * ftimes))[:, None, None]
    ncio.write_fields(
        f"{d}/fluxes.nc", {"time": ntimes, "longitude": nx, "latitude": ny},
        {"time": ("time", ftimes),
         "longitude": ("longitude", lons), "latitude": ("latitude", lats)},
        {"taux": (("time", "latitude", "longitude"),
                  0.05 + 0.02 * rng.standard_normal(shp)),
         "tauy": (("time", "latitude", "longitude"),
                  0.01 * rng.standard_normal(shp)),
         "swf": (("time", "latitude", "longitude"),
                 480.0 * diurnal * np.cos(np.deg2rad(lat2))[None]),
         "lwf": (("time", "latitude", "longitude"), np.full(shp, -60.0)),
         "lhf": (("time", "latitude", "longitude"), np.full(shp, -120.0)),
         "shf": (("time", "latitude", "longitude"), np.full(shp, -12.0)),
         "precip": (("time", "latitude", "longitude"), np.full(shp, 5e-5))})


def _write_sst_sal(d, lons, lats, ndt, dto, ntimes=400):
    """The SST climatology (the tool's ``_write_sst_sal`` without its 3-D
    variant, which no configuration writes), ``ntimes`` records."""
    nx, ny = len(lons), len(lats)
    period = ndt * dto / SPD
    times = (np.arange(ntimes) + 0.5) * period
    lat2 = np.tile(lats[:, None], (1, nx))
    sst = 28.0 - 18.0 * (np.abs(lat2) / 90.0)[None] \
        + 0.0 * times[:, None, None]
    ncio.write_fields(
        f"{d}/sst.nc", {"t": len(times), "longitude": nx, "latitude": ny},
        {"t": ("t", times),
         "longitude": ("longitude", lons), "latitude": ("latitude", lats)},
        {"sst": (("t", "latitude", "longitude"), sst + 273.15)})


IODEF = """<?xml version="1.0"?>
<simulation>
  <context id="kpp">
    <file_definition type="one_file" enabled=".TRUE.">
      <file id="output_kpp" name="output_kpp" output_freq="1h" split_freq="1d">
        <field field_ref="T" name="T_inst" operation="instant"/>
        <field field_ref="S" name="S_inst" operation="instant"/>
        <field field_ref="hmix" name="hmix_inst" operation="instant"/>
      </file>
      <file id="output_kpp_means" name="output_kpp_means" output_freq="3h" split_freq="1d">
        <field field_ref="T" name="T_mean" operation="average"/>
        <field field_ref="S" name="S_mean" operation="average"/>
        <field field_ref="hmix" name="hmix_mean" operation="average"/>
      </file>
      <file id="output_kpp_min" name="output_kpp_min" output_freq="3h" split_freq="1d">
        <field field_ref="T" name="T_min" operation="minimum"/>
        <field field_ref="S" name="S_min" operation="minimum"/>
        <field field_ref="hmix" name="hmix_min" operation="minimum"/>
      </file>
      <file id="output_kpp_max" name="output_kpp_max" output_freq="3h" split_freq="1d">
        <field field_ref="T" name="T_max" operation="maximum"/>
        <field field_ref="S" name="S_max" operation="maximum"/>
        <field field_ref="hmix" name="hmix_max" operation="maximum"/>
      </file>
      <file id="output_kpp_all" name="output_kpp_all" output_freq="3h" split_freq="1d">
        <field field_ref="T" operation="instant"/>
        <field field_ref="S" operation="instant"/>
        <field field_ref="u" operation="instant"/>
        <field field_ref="v" operation="instant"/>
        <field field_ref="B" operation="instant"/>
        <field field_ref="wu" operation="instant"/>
        <field field_ref="wv" operation="instant"/>
        <field field_ref="wT" operation="instant"/>
        <field field_ref="wS" operation="instant"/>
        <field field_ref="wB" operation="instant"/>
        <field field_ref="wTnt" operation="instant"/>
        <field field_ref="difm" operation="instant"/>
        <field field_ref="dift" operation="instant"/>
        <field field_ref="difs" operation="instant"/>
        <field field_ref="rho" operation="instant"/>
        <field field_ref="cp" operation="instant"/>
        <field field_ref="scorr" operation="instant"/>
        <field field_ref="Rig" operation="instant"/>
        <field field_ref="dbloc" operation="instant"/>
        <field field_ref="Shsq" operation="instant"/>
        <field field_ref="tinc_fcorr" operation="instant"/>
        <field field_ref="fcorr_z" operation="instant"/>
        <field field_ref="sinc_fcorr" operation="instant"/>
        <field field_ref="hmix" operation="instant"/>
        <field field_ref="fcorr" operation="instant"/>
        <field field_ref="taux_in" operation="instant"/>
        <field field_ref="tauy_in" operation="instant"/>
        <field field_ref="solar_in" operation="instant"/>
        <field field_ref="nsolar_in" operation="instant"/>
        <field field_ref="PminusE_in" operation="instant"/>
        <field field_ref="cplwght" operation="instant"/>
        <field field_ref="freeze_flag" operation="instant"/>
        <field field_ref="comp_flag" operation="instant"/>
        <field field_ref="dampu_flag" operation="instant"/>
        <field field_ref="dampv_flag" operation="instant"/>
      </file>
    </file_definition>
  </context>
</simulation>
"""


def _namelist(d, nx, ny, nz, dmax, lon0, lat0, dtsec=3600.0, ndtocn=3,
              finalt=1.0, fluxdata=True, relax=False, ldd=False,
              restart_every=0):
    """``3D_ocn.nml`` and ``iodef.xml``: hourly flux records (or analytic
    fluxes without ``fluxdata``), the ocean step every dtsec / ndtocn
    seconds, ``finalt`` model days; ``relax``: the SST climatology with a
    5-day relaxation on every row; ``ldd``: KPP, the Richardson-number
    mixing and double diffusion on; ``restart_every``: steps between
    restarts (0: at the end only)."""
    couple = ""
    advec = " L_ADVECT=.F.,"
    if relax:
        couple = (" L_CLIMSST=.T., L_UPD_CLIMSST=.T., sstin_file='sst.nc',"
                  " ndtupdsst=3,")
        advec = (" L_ADVECT=.F., L_RELAX_SST=.T., relax_sst_in="
                 + ",".join(["5.0"] * ny) + ",")
    procswit = " LKPP=.T., LRI=.T., LDD=.T." if ldd else ""
    forcing = ("L_FLUXDATA=.T., forcing_file='fluxes.nc'" if fluxdata
               else "L_FLUXDATA=.F.")
    text = f"""
 &NAME_PARAMETERS
 nz={nz}, nx={nx}, ny={ny}, ngrid={nz}, nztmax={nz + 15}
 &END
 &NAME_CONSTANTS &END
 &NAME_PROCSWIT{procswit} &END
 &NAME_DOMAIN
 dmax={dmax}, L_REGGRID=.F., L_VGRID_FILE=.T., vgrid_file='vgrid.nc',
 alon={lon0}, alat={lat0}
 &END
 &NAME_LANDSEA
 L_LANDSEA=.T., landsea_file='lsm.nc'
 &END
 &NAME_START
 L_INITDATA=.T., initdata_file='init.nc', L_RESTART=.F., L_INTERPINIT=.T.
 &END
 &NAME_TIMES
 dtsec={dtsec}, startt=0.0, finalt={finalt}, ndtocn={ndtocn}
 &END
 &NAME_COUPLE L_COUPLE=.F.,{couple} &END
 &NAME_ADVEC{advec} &END
 &NAME_PARAS
 paras_file='paras.nc', L_JERLOV=.T.
 &END
 &NAME_FORCING
 {forcing}
 &END
 &NAME_OUTPUT
 L_RESTARTW=.T., restart_outfile='restart_out', ndt_per_restart={restart_every},
 IODEF_FILE='iodef.xml'
 &END
"""
    with open(f"{d}/3D_ocn.nml", "w") as f:
        f.write(text)
    with open(f"{d}/iodef.xml", "w") as f:
        f.write(IODEF)


CONFIGS = ("single_column", "regional_64x64", "terramaris", "global_1deg",
           "ensemble10_dd")


def generate(config: str, outdir: str, toy: bool = False,
             shrink: int | None = None) -> dict:
    """Write the inputs of ``config`` (one of ``CONFIGS``) into
    ``outdir``: ``3D_ocn.nml``, ``iodef.xml`` and the NetCDF files they
    name.  ``toy`` shrinks the horizontal grid as the tool's ``--toy``
    does; ``shrink`` sets the divisor alone (default 8 with ``toy``, else
    1).  Returns the grid sizes and the land share."""
    os.makedirs(outdir, exist_ok=True)
    if shrink is None:
        shrink = 8 if toy else 1
    if config == "single_column":
        return write_single_column(outdir)
    if config == "regional_64x64":
        nx = ny = max(8, 64 // shrink)
        nz, dmax = 40, 500.0
        lons, lats, h, zf, dd = _grids(nx, ny, nz, dmax, 90.0, -20.0,
                                       0.5, 0.25)
        lsm = np.zeros((ny, nx))
        _write_common(outdir, lons, lats, h, zf, dd, lsm,
                      np.full((ny, nx), -dmax))
        _write_fluxes(outdir, lons, lats, 30, 3600.0)
        _write_sst_sal(outdir, lons, lats, 3, 1200.0)
        _namelist(outdir, nx, ny, nz, dmax, lons[0], lats[0],
                  relax=True, finalt=1.0)
    elif config == "terramaris":
        nx, ny = 453 // shrink, 319 // shrink
        nz, dmax = 69, 1000.0
        lons, lats, h, zf, dd = _grids(nx, ny, nz, dmax, lon0=90.0,
                                       lat0=-15.0, dlon=0.066, dlat=0.066)
        rng = np.random.default_rng(0)
        lsm = (rng.uniform(size=(ny, nx)) < 0.12).astype(float)  # islands
        _write_common(outdir, lons, lats, h, zf, dd, lsm,
                      np.full((ny, nx), -dmax))
        _write_fluxes(outdir, lons, lats, 30, 3600.0)
        _write_sst_sal(outdir, lons, lats, 3, 1200.0)
        _namelist(outdir, nx, ny, nz, dmax, lons[0], lats[0],
                  relax=True, finalt=1.0, restart_every=72)
    elif config in ("global_1deg", "ensemble10_dd"):
        nx, ny = 360 // shrink, 180 // shrink
        nz, dmax = 40, 1000.0
        lons, lats, h, zf, dd = _grids(nx, ny, nz, dmax, lon0=0.0,
                                       lat0=-89.5 if not toy else -45.0,
                                       dlon=360.0 / nx, dlat=180.0 / ny
                                       if not toy else 2.0)
        rng = np.random.default_rng(1)
        lsm = (rng.uniform(size=(ny, nx)) < 0.3).astype(float)  # ~70% wet
        _write_common(outdir, lons, lats, h, zf, dd, lsm,
                      np.full((ny, nx), -dmax))
        _write_fluxes(outdir, lons, lats, 30, 3600.0)
        _namelist(outdir, nx, ny, nz, dmax, lons[0], lats[0],
                  ldd=(config == "ensemble10_dd"), finalt=1.0)
    elif config == "goml2_n216":
        nx, ny = 432 // shrink, 324 // shrink
        nz, dmax = 100, 1000.0
        lons, lats, h, zf, dd = _grids(nx, ny, nz, dmax, lon0=0.41667,
                                       lat0=-89.72222, dlon=0.83333 * shrink,
                                       dlat=0.55556 * shrink)
        rng = np.random.default_rng(2)
        lsm = np.zeros(nx * ny)
        lsm[rng.permutation(nx * ny)[:round(0.4 * nx * ny)]] = 1.0
        lsm = lsm.reshape(ny, nx)
        _write_common(outdir, lons, lats, h, zf, dd, lsm,
                      np.full((ny, nx), -dmax))
        _write_sst_sal(outdir, lons, lats, 3, 1200.0, ntimes=40)
        _namelist(outdir, nx, ny, nz, dmax, lons[0], lats[0],
                  fluxdata=False, relax=True, finalt=1.0)
    else:
        raise ValueError(f"unknown config {config!r}; one of "
                         f"{CONFIGS + ('goml2_n216',)}")
    return {"config": config, "nx": nx, "ny": ny, "nz": nz, "dmax": dmax,
            "land_share": float(lsm.mean())}


def write_single_column(outdir: str, nz: int = 100,
                        dmax: float = 2000.0) -> dict:
    """The ``single_column`` inputs with ``nz`` uniform levels over
    ``dmax`` m (the configuration's own: 100 over 2000 m; 250 over 250 m
    is a 1 m column as KPP single-column studies run at a station, 2000
    over 4000 m a full-depth open-ocean column at 2 m):
    one column at 90 E, 20 S, constant analytic fluxes, one model day."""
    os.makedirs(outdir, exist_ok=True)
    nx = ny = 1
    lons, lats, h, zf, dd = _grids(nx, ny, nz, dmax, 90.0, -20.0, 0.5, 0.25)
    lsm = np.zeros((ny, nx))
    _write_common(outdir, lons, lats, h, zf, dd, lsm,
                  np.full((ny, nx), -dmax))
    _namelist(outdir, nx, ny, nz, dmax, lons[0], lats[0], fluxdata=False,
              finalt=1.0)
    return {"config": "single_column", "nx": nx, "ny": ny, "nz": nz,
            "dmax": dmax, "land_share": 0.0}


def write_terramaris(outdir: str, shrink: int = 1) -> dict:
    """Write the TerraMaris inputs into ``outdir`` with the horizontal
    grid divided by ``shrink``; returns the grid sizes."""
    return generate("terramaris", outdir, shrink=shrink)
