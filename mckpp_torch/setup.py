"""Field-initialization orchestrator: assemble a runnable model from a
KppConfig + input files (counterpart of ``mckpp_tpu/setup.py``; reference:
mckpp_initialize_fields_mod.F90:34-135 and its callees).

Land/sea + horizontal grid (mckpp_initialize_landsea_mod.F90), vertical
grid from file (mckpp_initialize_geography_mod.F90:25-41), optics
(mckpp_initialize_optics_mod.F90), advection
(mckpp_initialize_advection_mod.F90), relaxation rates
(mckpp_initialize_relaxation_mod.F90), initial profiles with vertical
interpolation and Kelvin autoconversion
(mckpp_initialize_ocean_profiles_mod.F90), restart resume, and the initial
ancillary reads.  The files are read on the host in numpy; the model and
its state live on ``device``.

Under a column layout (``parallel/distributed.py``) every process builds
the whole domain, as the JAX package does before ``layout.shard_tree``,
runs the initial mixing pass over it (a per-column pass, so the result
is the single-process one), keeps its own slab, and from then on reads
the forcing and ancillaries host-locally.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .config import KppConfig
from .grid import VerticalGrid, coriolis, regular_lonlat, vertical_grid_from_arrays
from .io import ncio
from .io import restart as restart_io
from .io.ancillaries import BoundaryManager, FluxFileReader
from .models.column_model import KppModel, model_dtype, resolve_device
from .state import init_forcing, init_params, init_state
from .utils.timer import NO_TIMERS


def vinterp(var_in: np.ndarray, var_z: np.ndarray, model_z: np.ndarray) -> np.ndarray:
    """Linear interpolation from source levels var_z to model levels,
    clamped to end values (reference:
    mckpp_initialize_ocean_profiles_vinterp, :122-159).

    var_in: (npts, nz_in); var_z, model_z: descending negative depths.
    """
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


def load_landsea(cfg: KppConfig, data_dir: str):
    """(dlon, dlat, l_ocean, ocdepth) from the land-sea file or the regular
    grid (reference: mckpp_initialize_landsea_mod.F90:15-97)."""
    d = cfg.domain
    if d.l_landsea:
        path = os.path.join(data_dir, d.landsea_file)
        with ncio.open_nc(path) as nc:
            olon, olat = ncio.determine_boundaries(nc, d.alon, d.alat)
            lons = ncio.get_var(nc, "longitude")[olon:olon + d.nx]
            lats = ncio.get_var(nc, "latitude")[olat:olat + d.ny]
            lsm = ncio.get_var(nc, "lsm")[olat:olat + d.ny, olon:olon + d.nx]
            ocd = ncio.get_var(nc, "max_depth")[olat:olat + d.ny,
                                                olon:olon + d.nx]
        lon2, lat2 = np.meshgrid(lons, lats)
        return (lon2.reshape(-1), lat2.reshape(-1),
                lsm.reshape(-1) != 1.0, ocd.reshape(-1))
    if d.l_reggrid:
        dlon, dlat = regular_lonlat(d.nx, d.ny, d.alon, d.alat,
                                    d.delta_lon, d.delta_lat)
        npts = d.npts
        return (dlon.numpy(), dlat.numpy(),
                np.ones(npts, bool), np.full(npts, -10000.0))
    raise ValueError("l_reggrid=False requires a land-sea mask file")


def load_vgrid(cfg: KppConfig, data_dir: str, dtype,
               device="cpu") -> Optional[VerticalGrid]:
    d = cfg.domain
    if not d.l_vgrid_file:
        return None
    path = os.path.join(data_dir, d.vgrid_file)
    with ncio.open_nc(path) as nc:
        dd = ncio.get_var(nc, "d")
        hh = ncio.get_var(nc, "h")
        zz = ncio.get_var(nc, "z")
    return vertical_grid_from_arrays(zz, hh, dd, cfg.time.dto, dtype, device)


def load_initial_profiles(cfg: KppConfig, data_dir: str, model_z: np.ndarray,
                          lon0: float, lat0: float, nx: int, ny: int):
    """(u0, t0, s0_absolute): initial currents/temperature/salinity
    interpolated to model levels, with Kelvin autoconversion
    (reference: mckpp_initialize_ocean_profiles_mod.F90:15-119)."""
    path = os.path.join(data_dir, cfg.init.initdata_file)
    if not cfg.init.l_initdata:
        raise ValueError("No code for l_initdata=.FALSE. (as the reference)")
    with ncio.open_nc(path) as nc:
        olon, olat = ncio.determine_boundaries(nc, lon0, lat0)

        def read(zname, vname):
            z = ncio.get_var(nc, zname)
            v = ncio.get_var(nc, vname)          # (z, y, x) or (t?, z, y, x)
            if v.ndim == 4:
                v = v[0]
            v = v[:, olat:olat + ny, olon:olon + nx]
            flat = np.moveaxis(v, 0, -1).reshape(-1, len(z))
            return vinterp(flat, z, model_z), z

        u, _ = read("zvel", "u")
        v, _ = read("zvel", "v")
        t, _ = read("ztemp", "temp")
        s, _ = read("zsal", "sal")
    if np.any((t > 200.0) & (t < 400.0)):
        t = t - cfg.constants.tk0
    u0 = np.stack([u, v], axis=-1)
    return u0, t, s


def load_optics(cfg: KppConfig, data_dir: str, lon0, lat0, nx, ny) -> np.ndarray:
    """0-based per-column Jerlov water type."""
    if cfg.init.l_jerlov:
        path = os.path.join(data_dir, cfg.init.paras_file)
        with ncio.open_nc(path) as nc:
            olon, olat = ncio.determine_boundaries(nc, lon0, lat0)
            j = ncio.get_var(nc, "jerlov")[olat:olat + ny, olon:olon + nx]
        return j.reshape(-1).astype(np.int32) - 1      # Fortran 1..5 -> 0..4
    return np.full(nx * ny, cfg.init.jerlov_default - 1, np.int32)


def load_advection(cfg: KppConfig, data_dir: str, lon0, lat0, nx, ny,
                   maxmodeadv=6):
    if not cfg.boundary.l_advect:
        z = np.zeros((nx * ny, 2), np.int32)
        return z, np.zeros((nx * ny, maxmodeadv, 2), np.int32), \
            np.zeros((nx * ny, maxmodeadv, 2))
    path = os.path.join(data_dir, cfg.boundary.advect_file)
    with ncio.open_nc(path) as nc:
        olon, olat = ncio.determine_boundaries(nc, lon0, lat0)
        sl2 = (slice(olat, olat + ny), slice(olon, olon + nx))

        def g2(v):
            return ncio.get_var(nc, v)[sl2].reshape(-1)

        def g3(v):
            a = ncio.get_var(nc, v)[:, sl2[0], sl2[1]]
            return np.moveaxis(a, 0, -1).reshape(-1, a.shape[0])

        nmode = np.stack([g2("nmode_tadv"), g2("nmode_sadv")], -1).astype(np.int32)
        mode = np.stack([g3("mode_tadv"), g3("mode_sadv")], -1).astype(np.int32)
        adv = np.stack([g3("tadv"), g3("sadv")], -1)
    return nmode, mode, adv


def load_cplwght(cfg: KppConfig, data_dir: str, lon0, lat0, nx, ny) -> np.ndarray:
    """Coupling weight alpha (reference:
    mckpp_initialize_coupling_weight_mod.F90:22-55): read over the KPP
    domain when l_couple/l_cplwght, else zeros."""
    b = cfg.boundary
    if not (b.l_couple or b.l_cplwght):
        return np.zeros(nx * ny)
    path = os.path.join(data_dir, b.cplwght_file)
    with ncio.open_nc(path) as nc:
        olon, olat = ncio.determine_boundaries(nc, lon0, lat0)
        alpha = ncio.get_var(nc, "alpha")[olat:olat + ny, olon:olon + nx]
    return alpha.reshape(-1)


def relaxation_rates(cfg: KppConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column relaxation rates 1/(tau_days * spd) from per-latitude-row
    timescales (reference: mckpp_initialize_relaxation_mod.F90)."""
    d, b = cfg.domain, cfg.boundary

    def expand(rows, on):
        out = np.zeros(d.npts)
        if not on or not rows:
            return out
        r = np.asarray(rows, dtype=float)
        if len(r) < d.ny:
            r = np.pad(r, (0, d.ny - len(r)))
        per_row = np.where(
            r[:d.ny] == 0.0, 0.0,
            1.0 / np.where(r[:d.ny] == 0.0, 1.0,
                           r[:d.ny] * cfg.constants.spd))
        return np.repeat(per_row, d.nx)

    return (expand(b.relax_sst_in, b.l_relax_sst),
            expand(b.relax_sal_in, b.l_relax_sal),
            expand(b.relax_ocnt_in, b.l_relax_ocnt))


def build(cfg: KppConfig, data_dir: str = ".", device=None, layout=None,
          timers=None):
    """Assemble (model, state, params, forcing, flux_provider,
    boundary_mgr) ready to run — the reference's initialization call stack
    (SURVEY.md section 3.1).  ``device``: as for :class:`KppModel` (the
    card unless the caller asks for the CPU).  ``layout``: a
    ``ColumnLayout``; the state, parameters and forcing come back as this
    process's slab (padding columns inactive), a restart is sliced to it
    on the host, and the readers are set to read its rows only.
    ``timers``: a ``utils.timer.Timers`` that takes the spans
    ``setup.inputs`` (the input files and the ancillaries' opens and first
    reads), ``setup.library`` (the kernel library's load, or build) and
    ``setup.initial_pass`` (the initial mixing pass, or the restart's
    read), and the ancillary and flux readers' copy counts."""
    timers = NO_TIMERS if timers is None else timers
    cfg.validate()
    d = cfg.domain
    dt, dev = model_dtype(cfg), resolve_device(device)
    if layout is not None and layout.device != dev:
        raise ValueError(f"the layout's slabs are on {layout.device} and the "
                         f"model on {dev}: make both on one device")
    with timers.span("setup.inputs"):
        dlon, dlat, l_ocean, ocdepth = load_landsea(cfg, data_dir)
        vgrid = load_vgrid(cfg, data_dir, dt, dev)
    model = KppModel(cfg, vgrid=vgrid, device=dev)
    with timers.span("setup.library"):
        model.load_library()
    nzp1 = model.grid.nzp1
    model_z = model.grid.zm.double().cpu().numpy()

    with timers.span("setup.inputs"):
        jerlov = load_optics(cfg, data_dir, dlon[0], dlat[0], d.nx, d.ny)
        nmode, mode, adv = load_advection(cfg, data_dir, dlon[0], dlat[0],
                                          d.nx, d.ny)
        r_sst, r_sal, r_ocnt = relaxation_rates(cfg)
        cplwght = load_cplwght(cfg, data_dir, dlon[0], dlat[0], d.nx, d.ny)
        # run_physics gating (mckpp_initialize_fields_mod.F90:146-153)
        if cfg.boundary.l_couple:
            run_physics = l_ocean & (cplwght > 0.0)
        else:
            run_physics = l_ocean

        fl = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        it = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        prm = init_params(d.npts, nzp1, dtype=dt, device=dev)
        prm = prm.replace(
            f=coriolis(fl(dlat), twopi=cfg.constants.twopi),
            dlat=fl(dlat), dlon=fl(dlon), ocdepth=fl(ocdepth),
            jerlov=it(jerlov), l_ocean=it(l_ocean),
            run_physics=it(run_physics), cplwght=fl(cplwght),
            relax_sst=fl(r_sst), relax_sal=fl(r_sal), relax_ocnt=fl(r_ocnt),
            nmodeadv=it(nmode), modeadv=it(mode), advection=fl(adv))

    with timers.span("setup.initial_pass"):
        if cfg.init.l_restart:
            rpath = os.path.join(data_dir, cfg.init.restart_infile)
            if rpath.endswith(".npz"):
                # native bit-exact checkpoint (either package's); under a
                # layout it stays on the host until sliced to the slab
                st, prm, frc, _, _ = restart_io.load_restart(
                    rpath, device="cpu" if layout is not None else dev)
            else:
                # reference-format NetCDF restart
                # (mckpp_xios_io.F90:436-465)
                st = init_state(d.npts, nzp1, dt, dev)
                frc = init_forcing(d.npts, nzp1, dt, dev)
                st, prm, _ = restart_io.import_reference_restart(
                    rpath, st, prm, grid=model.grid)
        else:
            with timers.span("setup.inputs"):
                u0, t0, s0 = load_initial_profiles(
                    cfg, data_dir, model_z, dlon[0], dlat[0], d.nx, d.ny)
            st, prm, frc = model.initial_state(u0, t0, s0, prm)

    # ancillary file paths are namelist-relative: prefix the data dir
    join = lambda p: os.path.join(data_dir, p) if p not in ("", "none") else p
    cfg_anc = dataclasses.replace(
        cfg,
        boundary=dataclasses.replace(
            cfg.boundary, sst_file=join(cfg.boundary.sst_file),
            ice_file=join(cfg.boundary.ice_file)),
        forcing=dataclasses.replace(
            cfg.forcing, fcorr_file=join(cfg.forcing.fcorr_file),
            sfcorr_file=join(cfg.forcing.sfcorr_file),
            bottom_file=join(cfg.forcing.bottom_file),
            ocnt_file=join(cfg.forcing.ocnt_file),
            sal_file=join(cfg.forcing.sal_file)))
    with timers.span("setup.inputs"):
        mgr = BoundaryManager(cfg_anc, dlon[0], dlat[0], nzp1,
                              prm.sref.cpu().numpy(), timers=timers)
        frc = mgr.initial_reads(cfg.time.startt, frc)

    flux_provider = None
    if cfg.forcing.l_fluxdata:
        cfg2 = dataclasses.replace(
            cfg, forcing=dataclasses.replace(
                cfg.forcing,
                forcing_file=os.path.join(data_dir, cfg.forcing.forcing_file)))
        flux_provider = FluxFileReader(cfg2, dlon[0], dlat[0], dtype=dt,
                                       device=dev, timers=timers)

    if layout is not None:
        st, prm, frc = (layout.shard_tree(t) for t in (st, prm, frc))
        mgr.set_layout(layout)
        if flux_provider is not None:
            flux_provider.set_layout(layout)
    return model, st, prm, frc, flux_provider, mgr
