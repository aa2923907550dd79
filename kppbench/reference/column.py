"""The reference's driver: the initial state worked out again from the
run's input files, and the CLI's time loop (flux and SST updates, the
step, the diagnostic samples) over a stretch of steps, on a sample of
columns.  Frozen copies, at commit a49d027, of ``setup.vinterp``,
``setup.relaxation_rates``, ``KppModel.initial_state`` /
``_init_columns`` (``models/column_model.py``), ``get_update_time`` and
``BoundaryManager.read_sst`` (``io/ancillaries.py``) and the order of
``cli.run``'s ``pre_step``, arranged as plain functions.  Columns are
independent, so a sample of them gives the same values as the whole
grid."""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
from scipy.io import netcdf_file

from . import constants as c
from .config import (BoundaryConfig, DomainConfig, ForcingConfig, KppConfig,
                     PhysicsFlags, TimeConfig)
from .forcing import constant_test_fluxes, update_fluxes
from .grid import coriolis, vertical_grid_from_arrays
from .ocnstep import apply_vmix, interior_fluxes, ocnstep
from .overrides import check_profile
from .state import (ColumnParams, Forcing, State, init_forcing, init_params,
                    init_state, select, tree_map)
from .swfrac import swfrac_levels
from .vmix import vmix

def make_config(cfg: dict) -> KppConfig:
    """The KppConfig that the harness's namelist for ``cfg`` states (the
    options it leaves out keep the port's defaults, copied here)."""
    sst = cfg.get("sst")
    relax = cfg.get("relax_sst_days")
    ph = cfg["physics"]
    return KppConfig(
        domain=DomainConfig(nx=cfg["nx"], ny=cfg["ny"], nz=cfg["nz"],
                            dmax=cfg["dmax"], l_reggrid=False,
                            l_vgrid_file=True, l_landsea=True),
        time=TimeConfig(dtsec=cfg["dtsec"], ndtocn=cfg["ndtocn"]),
        physics=PhysicsFlags(lkpp=ph["lkpp"], lri=ph["lri"], ldd=ph["ldd"]),
        forcing=ForcingConfig(l_fluxdata=False),
        boundary=BoundaryConfig(
            l_climsst=bool(sst), l_upd_climsst=bool(sst),
            l_periodic_climsst=bool(sst),
            ndtupdsst=sst["update_steps"] if sst else 24,
            climsst_period=int(sst["period_days"]) if sst else 360,
            l_relax_sst=bool(relax),
            relax_sst_in=(float(relax),) * cfg["ny"] if relax else ()),
        dtype="float64")


def read_nc(path: str, names) -> dict:
    with netcdf_file(path, "r", mmap=False) as nc:
        return {n: np.array(nc.variables[n][:], dtype=np.float64)
                for n in names}


def vinterp(var_in: np.ndarray, var_z: np.ndarray,
            model_z: np.ndarray) -> np.ndarray:
    """Linear interpolation from source levels to model levels, clamped
    to the end values (``setup.vinterp``)."""
    npts, nz_in = var_in.shape
    out = np.empty((npts, len(model_z)), dtype=var_in.dtype)
    for k, zk in enumerate(model_z):
        if zk > var_z[0]:
            out[:, k] = var_in[:, 0]
        elif zk < var_z[-1]:
            out[:, k] = var_in[:, -1]
        else:
            kin = int(np.searchsorted(-var_z, -zk, side="right") - 1)
            kin = min(kin, nz_in - 2)
            dz = var_z[kin] - var_z[kin + 1]
            dv = var_in[:, kin] - var_in[:, kin + 1]
            out[:, k] = var_in[:, kin] + dv * (zk - var_z[kin]) / dz
    return out


def get_update_time(time: float, ndt_update: int, file_times: np.ndarray,
                    periodic: bool, period: int, dto: float, dtsec: float,
                    spd: float = c.SPD) -> int:
    """The 0-based record of an ancillary read at ``time`` (method 1:
    time + half the update period; a periodic file wraps by whole
    periods), ``io/ancillaries.get_update_time``."""
    upd_days = ndt_update * dto / spd
    update_time = time + 0.5 * upd_days
    tol = 0.01 * dtsec / spd
    if update_time > file_times[-1] + tol:
        if not periodic:
            raise ValueError(f"time {update_time} past the file's end")
        while update_time > file_times[-1] + tol:
            update_time -= period
    x = (update_time - file_times[0]) / upd_days
    pos = int(math.floor(abs(x) + 0.5)) * (1 if x >= 0 else -1)
    if not (0 <= pos < len(file_times)
            and abs(file_times[pos] - update_time) <= tol):
        near = int(np.argmin(np.abs(file_times - update_time)))
        if abs(file_times[near] - update_time) > tol:
            raise ValueError(f"no record at {update_time}")
        pos = near
    return pos


class SST:
    """The SST climatology of the sampled columns (Kelvin converted as
    the reference does, over the whole file)."""

    def __init__(self, path: str, cols: np.ndarray, kcfg: KppConfig):
        d = read_nc(path, ("t", "sst"))
        self.times = d["t"]
        sst = d["sst"].reshape(len(self.times), -1)
        if np.any((sst > 200.0) & (sst < 400.0)):
            sst = sst - kcfg.constants.tk0
        self.values = sst[:, cols]
        self.kcfg = kcfg

    def at(self, time_days: float) -> np.ndarray:
        b, t = self.kcfg.boundary, self.kcfg.time
        pos = get_update_time(time_days, b.ndtupdsst, self.times,
                              b.l_periodic_climsst, b.climsst_period, t.dto,
                              t.dtsec, spd=self.kcfg.constants.spd)
        return self.values[pos]


@dataclasses.dataclass
class Columns:
    """The sampled columns' grid, parameters and SST reader."""
    kcfg: KppConfig
    grid: object
    prm: ColumnParams
    sst: object
    dtype: torch.dtype
    wscale: str


def load_columns(cfg: dict, data_dir: str, cols, dtype=torch.float64,
                 wscale: str = "analytic") -> Columns:
    """Grid and parameters of the columns ``cols`` (flat ``j * nx + i``
    indices) from the run's files (``setup.build``'s reads)."""
    cols = np.asarray(cols, np.int64)
    kcfg = make_config(cfg)
    d = kcfg.domain
    v = read_nc(os.path.join(data_dir, "vgrid.nc"), ("z", "h", "d"))
    grid = vertical_grid_from_arrays(v["z"], v["h"], v["d"], kcfg.time.dto,
                                     torch.float64)
    lsm = read_nc(os.path.join(data_dir, "lsm.nc"),
                  ("longitude", "latitude", "lsm", "max_depth"))
    lon2, lat2 = np.meshgrid(lsm["longitude"][:d.nx], lsm["latitude"][:d.ny])
    dlon, dlat = lon2.reshape(-1)[cols], lat2.reshape(-1)[cols]
    l_ocean = lsm["lsm"].reshape(-1)[cols] != 1.0
    ocdepth = lsm["max_depth"].reshape(-1)[cols]
    jer = read_nc(os.path.join(data_dir, "paras.nc"), ("jerlov",))["jerlov"]
    jerlov = jer.reshape(-1)[cols].astype(np.int32) - 1
    b = kcfg.boundary
    r_sst = np.zeros(len(cols))
    if b.l_relax_sst and b.relax_sst_in:
        rows = np.asarray(b.relax_sst_in, float)[cols // d.nx]
        r_sst = np.where(rows == 0.0, 0.0, 1.0 / np.where(
            rows == 0.0, 1.0, rows * kcfg.constants.spd))
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    prm = init_params(len(cols), d.nzp1, dtype=torch.float64)
    prm = prm.replace(
        f=coriolis(f64(dlat), twopi=kcfg.constants.twopi), dlat=f64(dlat),
        dlon=f64(dlon), ocdepth=f64(ocdepth),
        jerlov=torch.as_tensor(jerlov), l_ocean=torch.as_tensor(l_ocean),
        run_physics=torch.as_tensor(l_ocean), relax_sst=f64(r_sst))
    sst = (SST(os.path.join(data_dir, "sst.nc"), cols, kcfg)
           if b.l_climsst else None)
    cast = lambda a: a.to(dtype) if a.is_floating_point() else a
    grid = dataclasses.replace(grid, **{
        f.name: cast(getattr(grid, f.name))
        for f in dataclasses.fields(grid)})
    return Columns(kcfg=kcfg.replace(dtype="float64"), grid=grid,
                   prm=tree_map(cast, prm), sst=sst, dtype=dtype,
                   wscale=wscale)


def initial_state(cfg: dict, data_dir: str, col: Columns, cols):
    """(State, ColumnParams, Forcing) at the start: the initial profiles
    interpolated to the model levels, Sref removed, the initial mixing
    pass (nodal velocity scales, as the port's), the history seed and the
    initial SST read."""
    cols = np.asarray(cols, np.int64)
    kcfg, grid, dt = col.kcfg, col.grid, col.dtype
    ini = read_nc(os.path.join(data_dir, "init.nc"),
                  ("zvel", "ztemp", "zsal", "u", "v", "temp", "sal"))
    model_z = grid.zm.double().numpy()

    def prof(zname, vname):
        a = ini[vname]
        flat = np.moveaxis(a, 0, -1).reshape(-1, a.shape[0])[cols]
        return vinterp(flat, ini[zname], model_z)

    u0 = np.stack([prof("zvel", "u"), prof("zvel", "v")], axis=-1)
    t0, s0 = prof("ztemp", "temp"), prof("zsal", "sal")
    if np.any((t0 > 200.0) & (t0 < 400.0)):
        t0 = t0 - kcfg.constants.tk0
    u0, t0, s0 = (torch.as_tensor(a, dtype=torch.float64)
                  for a in (u0, t0, s0))
    prm = col.prm
    sref = ((s0[:, 0] + s0[:, -1]) / 2.0).to(dt)
    prm = prm.replace(sref=sref, ssref=sref, u_init=u0.to(dt))
    ncol, nzp1 = t0.shape
    st = init_state(ncol, nzp1, dt)
    x = torch.stack([t0.to(dt), s0.to(dt) - sref[:, None]], dim=-1)
    st = st.replace(u=u0.to(dt), x=x, tref=t0[:, 0].to(dt))
    st = st.replace(ssurf=prm.ssref if kcfg.physics.l_ssref
                    else x[:, 0, 1] + prm.sref)
    frc = init_forcing(ncol, nzp1, dt)
    st = _init_columns(st, prm, frc, grid, kcfg)
    if col.sst is not None:
        frc = frc.replace(sst0=torch.as_tensor(
            col.sst.at(kcfg.time.startt), dtype=dt))
    return st, prm, frc


def _init_columns(st: State, prm: ColumnParams, frc: Forcing, grid,
                  kcfg: KppConfig) -> State:
    ph = kcfg.physics
    st = st.replace(swfrac=swfrac_levels(1.0, grid.zm,
                                         prm.jerlov).to(grid.zm.dtype))
    vm = vmix(st.u, st.x, frc.sflux, st.ssurf, prm.sref, prm.jerlov,
              prm.f, prm.ocdepth, True, st.swdk_opt, st.swfrac, st.wxnt,
              True, grid, lri=ph.lri, ldd=ph.ldd, lkpp=ph.lkpp,
              update_wxnt=False, cst=kcfg.constants, wscale_mode="nodal")
    st_vm = apply_vmix(st, vm)
    wu, wx = interior_fluxes(st_vm, grid, ph.ldd, kcfg.constants.grav)
    x, u = st.x, st.u
    ncol = x.shape[0]
    new_st = st_vm.replace(
        wu=wu, wx=wx, hmix=vm.hbl, kmix=vm.kbl, tref=x[:, 0, 0],
        us=torch.stack([u, u], dim=-1), xs=torch.stack([x, x], dim=-1),
        hmixd=torch.stack([vm.hbl, vm.hbl], dim=-1),
        old=torch.zeros((ncol,), dtype=torch.int32),
        new=torch.ones((ncol,), dtype=torch.int32))
    new_st = tree_map(lambda a, b: a.to(b.dtype), new_st, st)
    return select(prm.run_physics, new_st, st)


def from_checkpoint(blob: dict, col: Columns):
    """(State, ColumnParams, Forcing) from a restart's arrays of the
    sampled columns (``st_<field>``, ``pr_<field>``, ``fr_<field>``),
    floating fields in the reference's dtype."""

    def build(cls, prefix):
        kw = {}
        for f in dataclasses.fields(cls):
            a = torch.as_tensor(np.asarray(blob[prefix + f.name]))
            kw[f.name] = a.to(col.dtype) if a.is_floating_point() else a
        return cls(**kw)
    return (build(State, "st_"), build(ColumnParams, "pr_"),
            build(Forcing, "fr_"))


FIELDS = {
    "T": lambda st, prm, frc: st.x[..., 0],
    "S": lambda st, prm, frc: st.x[..., 1] + prm.sref[:, None],
    "u": lambda st, prm, frc: st.u[..., 0],
    "v": lambda st, prm, frc: st.u[..., 1],
    "hmix": lambda st, prm, frc: st.hmix,
    "taux_in": lambda st, prm, frc: frc.sflux[:, 0],
    "tauy_in": lambda st, prm, frc: frc.sflux[:, 1],
    "solar_in": lambda st, prm, frc: frc.sflux[:, 2],
    "nsolar_in": lambda st, prm, frc: frc.sflux[:, 3],
    "PminusE_in": lambda st, prm, frc: frc.sflux[:, 5],
}
REDUCE = {"average": torch.add, "minimum": torch.minimum,
          "maximum": torch.maximum}


def run(col: Columns, st, prm, frc, nt0: int, nt1: int, streams):
    """Steps ``nt0 + 1`` to ``nt1`` of the CLI's loop.  ``streams``:
    (name, freq in steps, ((out, src, op), ...)) as an iodef states them.
    Returns the final (State, Forcing), the records the streams emit
    whose whole window lies inside the stretch ({stream: {time in days,
    rounded to 1e-6: {out: values}}}, float64) and, per step, each
    column's passes and kmix."""
    kcfg, grid = col.kcfg, col.grid
    t, b = kcfg.time, kcfg.boundary
    ncol = st.u.shape[0]
    dt = col.dtype
    records = {name: {} for name, _, _ in streams}
    acc = {name: None for name, _, _ in streams}
    work = []
    for nt in range(nt0 + 1, nt1 + 1):
        time_days = t.startt + (nt - 1) * t.dto / 86400.0
        if (nt - 1) % t.ndtocn == 0:
            raw = constant_test_fluxes(ncol, dt)
            st, frc = update_fluxes(kcfg, st, prm, frc, raw, nt <= 1,
                                    grid.dm)
        if nt != 1 and b.l_upd_climsst and (nt - 1) % b.ndtupdsst == 0:
            frc = frc.replace(sst0=torch.as_tensor(col.sst.at(time_days),
                                                   dtype=dt))
        new_st, comp, npass = ocnstep(st, prm, frc, grid, kcfg, nt <= 1,
                                      prm.run_physics,
                                      wscale_mode=col.wscale)
        new_st = check_profile(new_st, prm, frc, comp, grid, kcfg)
        st = select(prm.run_physics, new_st, st)
        work.append((npass.double().numpy().copy(),
                     st.kmix.double().numpy().copy()))
        for name, freq, ents in streams:
            red = [e for e in ents if e[2] != "instant"]
            if red:
                vals = {out: FIELDS[src](st, prm, frc).double()
                        for out, src, _ in red}
                if (nt - 1) % freq == 0:
                    acc[name] = (vals, 1)
                elif acc[name] is not None:
                    a, n = acc[name]
                    acc[name] = ({out: REDUCE[op](a[out], vals[out])
                                  for out, _, op in red}, n + 1)
            if nt % freq:
                continue
            rec = {}
            if red and acc[name] is not None and acc[name][1] == freq:
                a, n = acc[name]
                for out, _, op in red:
                    rec[out] = (a[out] / n if op == "average"
                                else a[out]).numpy()
            elif red:
                continue
            for out, src, op in ents:
                if op == "instant":
                    rec[out] = FIELDS[src](st, prm, frc).double().numpy()
            acc[name] = None
            records[name][round(nt * t.dto / 86400.0, 6)] = rec
    return st, frc, records, work
