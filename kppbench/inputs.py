"""The cells' input files, written from a configuration file, a traffic
file and the seed: a frozen copy of the recipes of
``mckpp_torch/io/benchmark_inputs.py`` at commit a49d027, written through
scipy's NetCDF writer so that nothing of the program is imported.

Changes from the recipe, each listed under ``assumed`` in the
configuration files: the seed draws the land columns (an exact share of
the grid) and a small perturbation of every column's initial profile
(an offset of T and S and a stretch of the thermocline's depth scale);
the SST climatology is one periodic day of hourly records with a diurnal
cycle; the surface fluxes are the reference's analytic ones
(``L_FLUXDATA=.F.``), so no flux file is written.

Files that do not depend on the seed (``vgrid.nc``, ``paras.nc``,
``sst.nc``) are written once per checkout into a fixed directory and
linked into each run's input directory; ``lsm.nc`` and ``init.nc`` are
written for each run.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import netcdf_file

SPD = 86400.0
SEED_SALT = 0x5EED       # keeps the streams apart from other users of a seed


def write_nc(path: str, dims: dict, variables: dict) -> None:
    """A CDF-2 file with ``dims`` {name: size} and ``variables`` {name:
    (dims tuple, array)}, written to a temporary name and renamed."""
    tmp = f"{path}.part"
    with netcdf_file(tmp, "w", version=2) as nc:
        for name, size in dims.items():
            nc.createDimension(name, size)
        for name, (vdims, arr) in variables.items():
            arr = np.asarray(arr, np.float64)
            var = nc.createVariable(name, "d", vdims)
            var[...] = arr
    os.replace(tmp, path)


def grids(cfg: dict):
    """(lons, lats, h, zf, dd): the horizontal axes and the uniform
    vertical grid of the recipe's ``_grids``."""
    nx, ny, nz, dmax = cfg["nx"], cfg["ny"], cfg["nz"], cfg["dmax"]
    lons = cfg["lon0"] + cfg["dlon"] * np.arange(nx)
    lats = cfg["lat0"] + cfg["dlat"] * np.arange(ny)
    h = np.full(nz, dmax / nz)
    zf = -(np.cumsum(h) - 0.5 * h)
    dd = np.cumsum(h)
    return lons, lats, h, zf, dd


def rng_of(seed: int) -> np.random.Generator:
    """The run's generator: any whole number (negative or past 64 bits
    too) is a valid seed."""
    return np.random.default_rng([abs(int(seed)) & (2**64 - 1),
                                  int(seed < 0), SEED_SALT])


def land_mask(cfg: dict, seed: int) -> np.ndarray:
    """(ny, nx) 1.0 on land: exactly ``round(land_share * npts)`` columns
    drawn from the seed, so every seed has the same number of ocean
    columns."""
    ny, nx = cfg["ny"], cfg["nx"]
    npts = nx * ny
    nland = int(round(cfg["land_share"] * npts))
    lsm = np.zeros(npts)
    lsm[rng_of(seed).permutation(npts)[:nland]] = 1.0
    return lsm.reshape(ny, nx)


def init_profiles(cfg: dict, seed: int, zin: np.ndarray):
    """(t, s) on the source levels ``zin``, (len(zin), ny, nx): the
    recipe's exponential thermocline and linear halocline, each column
    shifted and stretched by draws from the seed (uniform in the
    configuration's ranges)."""
    ini = cfg["init"]
    ny, nx = cfg["ny"], cfg["nx"]
    rng = rng_of(seed + 1)
    jit = ini["jitter"]
    dt = rng.uniform(-1.0, 1.0, (ny, nx)) * jit["t_offset_c"]
    scale = ini["t_scale_m"] * (
        1.0 + rng.uniform(-1.0, 1.0, (ny, nx)) * jit["t_scale_frac"])
    ds = rng.uniform(-1.0, 1.0, (ny, nx)) * jit["s_offset"]
    z = zin[:, None, None]
    t = (ini["t_top_c"] + dt[None]
         - ini["t_drop_c"] * (1.0 - np.exp(z / scale[None])))
    s = ini["s_base"] + ini["s_slope"] * np.abs(z) + ds[None]
    return t, s


def source_levels(cfg: dict, zf: np.ndarray) -> np.ndarray:
    """The recipe's initial-condition levels: those above 1.5 x the
    deepest model level (at least two)."""
    zin = -np.asarray(cfg["init"]["z_m"], np.float64)
    keep = zin[zin > zf[-1] * 1.5]
    return keep if len(keep) >= 2 else zin[:2]


def write_static(cfg: dict, d: str) -> None:
    """The seed-independent files: ``vgrid.nc``, ``paras.nc``, ``sst.nc``
    (the last only with SST relaxation)."""
    os.makedirs(d, exist_ok=True)
    lons, lats, h, zf, dd = grids(cfg)
    nx, ny, nz = len(lons), len(lats), len(h)
    write_nc(f"{d}/vgrid.nc", {"z": nz},
             {"z": (("z",), zf), "d": (("z",), dd), "h": (("z",), h)})
    write_nc(f"{d}/paras.nc", {"longitude": nx, "latitude": ny},
             {"longitude": (("longitude",), lons),
              "latitude": (("latitude",), lats),
              "jerlov": (("latitude", "longitude"),
                         np.full((ny, nx), float(cfg["jerlov"])))})
    sst = cfg.get("sst")
    if sst:
        nrec = sst["records"]
        period = sst["period_days"]
        times = (np.arange(nrec) + 0.5) * period / nrec
        lat2 = np.tile(lats[:, None], (1, nx))
        field = (sst["base_c"] - sst["lat_slope_c"] * np.abs(lat2) / 90.0)[None] \
            + sst["diurnal_c"] * np.sin(2.0 * np.pi * times / period)[:, None, None]
        write_nc(f"{d}/sst.nc", {"t": nrec, "longitude": nx, "latitude": ny},
                 {"t": (("t",), times), "longitude": (("longitude",), lons),
                  "latitude": (("latitude",), lats),
                  "sst": (("t", "latitude", "longitude"), field + 273.15)})


def write_seeded(cfg: dict, d: str, seed: int) -> dict:
    """``lsm.nc`` and ``init.nc`` of ``seed``; returns the land share."""
    lons, lats, h, zf, dd = grids(cfg)
    nx, ny = len(lons), len(lats)
    lsm = land_mask(cfg, seed)
    write_nc(f"{d}/lsm.nc", {"longitude": nx, "latitude": ny},
             {"longitude": (("longitude",), lons),
              "latitude": (("latitude",), lats),
              "lsm": (("latitude", "longitude"), lsm),
              "max_depth": (("latitude", "longitude"),
                            np.full((ny, nx), -cfg["dmax"]))})
    zin = source_levels(cfg, zf)
    t, s = init_profiles(cfg, seed, zin)
    uv = np.zeros((len(zin), ny, nx))
    n = len(zin)
    yx = ("latitude", "longitude")
    write_nc(f"{d}/init.nc",
             {"zvel": n, "ztemp": n, "zsal": n, "longitude": nx,
              "latitude": ny},
             {"zvel": (("zvel",), zin), "ztemp": (("ztemp",), zin),
              "zsal": (("zsal",), zin), "longitude": (("longitude",), lons),
              "latitude": (("latitude",), lats),
              "u": (("zvel",) + yx, uv), "v": (("zvel",) + yx, uv),
              "temp": (("ztemp",) + yx, t), "sal": (("zsal",) + yx, s)})
    return {"land_share": float(lsm.mean())}


def iodef(traffic: dict) -> str:
    """The iodef.xml of a traffic mix's streams."""
    out = ['<?xml version="1.0"?>', "<simulation>", '  <context id="kpp">',
           '    <file_definition type="one_file" enabled=".TRUE.">']
    for s in traffic["streams"]:
        split = (f' split_freq="{s["split_freq"]}"' if s.get("split_freq")
                 else "")
        out.append(f'      <file id="{s["name"]}" name="{s["name"]}" '
                   f'output_freq="{s["output_freq"]}"{split}>')
        for f in s["fields"]:
            out.append(f'        <field field_ref="{f["ref"]}" '
                       f'name="{f["name"]}" operation="{f["op"]}"/>')
        out.append("      </file>")
    out += ["    </file_definition>", "  </context>", "</simulation>", ""]
    return "\n".join(out)


def namelist(cfg: dict, steps: int, restart_every: int,
             restart: bool = True) -> str:
    """The ``3D_ocn.nml`` of a run of ``steps`` ocean steps (finalt is
    the whole steps' span, so the CLI's last step is ``steps``), writing
    a restart every ``restart_every`` steps (0: only at the end) unless
    ``restart`` is off."""
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    dtsec, ndtocn = cfg["dtsec"], cfg["ndtocn"]
    if steps % ndtocn:
        raise ValueError(f"{steps} steps: not a multiple of ndtocn={ndtocn}")
    finalt = repr(steps * dtsec / ndtocn / SPD)
    couple, advec = "", " L_ADVECT=.F.,"
    sst = cfg.get("sst")
    if sst:
        couple = (" L_CLIMSST=.T., L_UPD_CLIMSST=.T., sstin_file='sst.nc',"
                  f" ndtupdsst={sst['update_steps']},"
                  " L_PERIODIC_CLIMSST=.T.,"
                  f" CLIMSST_PERIOD={int(sst['period_days'])},")
    if cfg.get("relax_sst_days"):
        advec = (" L_ADVECT=.F., L_RELAX_SST=.T., relax_sst_in="
                 + ",".join([repr(float(cfg["relax_sst_days"]))] * ny) + ",")
    ph = cfg["physics"]
    flag = lambda b: ".T." if b else ".F."
    procswit = (f" LKPP={flag(ph['lkpp'])}, LRI={flag(ph['lri'])},"
                f" LDD={flag(ph['ldd'])}")
    lons, lats, _, _, _ = grids(cfg)
    return f"""
 &NAME_PARAMETERS
 nz={nz}, nx={nx}, ny={ny}, ngrid={nz}, nztmax={nz + 15}
 &END
 &NAME_CONSTANTS &END
 &NAME_PROCSWIT{procswit} &END
 &NAME_DOMAIN
 dmax={cfg['dmax']}, L_REGGRID=.F., L_VGRID_FILE=.T., vgrid_file='vgrid.nc',
 alon={lons[0]}, alat={lats[0]}
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
 L_FLUXDATA=.F.
 &END
 &NAME_OUTPUT
 L_RESTARTW={flag(restart)}, restart_outfile='restart_out', ndt_per_restart={restart_every},
 IODEF_FILE='iodef.xml'
 &END
"""


def prepare(cfg: dict, traffic: dict, static_dir: str, run_dir: str,
            seed: int) -> dict:
    """Write the run's inputs into ``run_dir`` (the static files once
    into ``static_dir``, linked); returns the land share.  The namelist
    is written per run by :func:`namelist`."""
    stamp = os.path.join(static_dir, "complete")
    if not os.path.exists(stamp):
        write_static(cfg, static_dir)
        with open(stamp, "w") as f:
            f.write("ok\n")
    os.makedirs(run_dir, exist_ok=True)
    for name in ("vgrid.nc", "paras.nc", "sst.nc"):
        src = os.path.join(static_dir, name)
        dst = os.path.join(run_dir, name)
        if os.path.exists(src) and not os.path.exists(dst):
            os.symlink(os.path.abspath(src), dst)
    with open(os.path.join(run_dir, "iodef.xml"), "w") as f:
        f.write(iodef(traffic))
    return write_seeded(cfg, run_dir, seed)
