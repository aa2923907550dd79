"""Ancillary/forcing file readers + boundary-condition update manager
(counterpart of ``mckpp_tpu/io/ancillaries.py``; reference: the
mckpp_read_*.F90 readers and mckpp_boundary_update_mod.F90:24-124).

The reads are host-side numpy, as in the JAX package; each field lands on
the model's device in the dtype of the Forcing field it replaces.  Update
times follow mckpp_time_control.F90:71-167:

* method 1: read-time = time + half the update period;
* method 2: floor-quantized read-time (the 3-D T/S climatologies and the
  2-D corrections);
* periodic climatology wrap (subtract the period until within the file);
* abort unless the record exists within 0.01*dtsec.

Each reader resolves the model domain's (lon, lat) offsets in the
ancillary grid on first use and caches the file's time axis.  Fields are
flattened ``(npts,)`` / ``(npts, nzp1)`` in the model layout
(``ipt = (j-1)*nx + i``).  Per-reader quirks kept: SST/bottom-temperature
Kelvin autoconversion; the salinity climatology has Sref removed; the 3-D
readers validate the file's level count.

With a column layout attached (``set_layout``; ``parallel/distributed.py``)
every reader fetches only this process's rows ``(lo, hi)`` of the flat
domain and pads them to its slab, and the Kelvin autoconversion decides
over the whole domain through ``any_across_processes`` (a collective, on
the loop thread; the prefetch thread only reads).
"""

from __future__ import annotations

import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import constants as c
from .. import forcing as forcing_mod
from ..config import KppConfig
from ..parallel.distributed import any_across_processes
from ..parallel.sharding import pad_rows
from ..state import Forcing
from ..utils.timer import NO_TIMERS
from . import ncio


def _nint(x: float) -> int:
    """Fortran NINT: round half away from zero (Python's round() banks)."""
    return int(math.floor(abs(x) + 0.5)) * (1 if x >= 0 else -1)


def get_update_time(time: float, ndt_update: int, file_times: np.ndarray,
                    periodic: bool, period: int, dto: float, dtsec: float,
                    method: int = 1, spd: float = c.SPD):
    """(update_time, 0-based record index); abort if absent.

    Mirrors mckpp_get_update_time (mckpp_time_control.F90:71-167): method
    1 reads at time + half the update period (:131-140), method 2 at the
    floor-quantized time (:142-154); a periodic file wraps by subtracting
    the period while past the last record (:96-103), with no low-side
    wrap; the record index is NINT((t - first)/upd) on the wrapped time
    (:157-167), falling back to the nearest record, which must match
    within 0.01*dtsec (:115-122).
    """
    upd_days = ndt_update * dto / spd
    if method == 2:
        q = (math.floor(time) * round(spd)) // (ndt_update * round(dto))
        update_time = upd_days * q + 0.5 * dto / spd * ndt_update
    else:
        update_time = time + 0.5 * upd_days

    tol = 0.01 * dtsec / spd
    # the wrap compare carries the validity tolerance: a read-time one ulp
    # above the last record must not wrap a whole period
    if update_time > file_times[-1] + tol:
        if not periodic:
            raise ncio.NetCDFError(
                f"time to read {update_time} exceeds the last time in the "
                "file and periodic reads have not been specified")
        while update_time > file_times[-1] + tol:
            update_time -= period
    pos = _nint((update_time - file_times[0]) / upd_days)
    if not (0 <= pos < len(file_times)
            and abs(file_times[pos] - update_time) <= tol):
        near = int(np.argmin(np.abs(file_times - update_time)))
        if abs(file_times[near] - update_time) > tol:
            raise ncio.NetCDFError(
                f"cannot find time {update_time} in ancillary file "
                f"(closest {file_times[near]})")
        pos = near
    return update_time, pos


class AncillaryReader:
    """Lazily initialized reader for one ancillary file, with a one-entry
    prefetch cache per (kind, variable) filled by a background thread."""

    def __init__(self, path: str, lon0: float, lat0: float,
                 nx: int, ny: int, time_name: str = "t"):
        self.path = path
        self.lon0, self.lat0 = lon0, lat0
        self.nx, self.ny = nx, ny
        self.time_name = time_name
        self._init = False
        self.offsets = (0, 0)
        self.file_times: Optional[np.ndarray] = None
        self._cache: dict = {}
        self._cache_lock = threading.Lock()
        self.cache_hits = 0

    def _initialize(self, nc):
        self.offsets = ncio.determine_boundaries(nc, self.lon0, self.lat0)
        self.file_times = ncio.get_time_axis(nc, (self.time_name, "time", "t"))
        self._init = True

    def _yspan(self, rows):
        """Flat rows [lo, hi) -> (y0, y1, trim): the covering domain rows
        y0..y1 and the slice of their flattened cells that is [lo, hi)."""
        if rows is None:
            return 0, self.ny, slice(None)
        lo, hi = rows
        if hi <= lo:
            return 0, 0, slice(0, 0)
        y0, y1 = lo // self.nx, (hi - 1) // self.nx + 1
        return y0, y1, slice(lo - y0 * self.nx, hi - y0 * self.nx)

    def _read_uncached(self, kind: str, var: str, pos: int,
                       nzp1: Optional[int] = None, rows=None) -> np.ndarray:
        y0, y1, trim = self._yspan(rows)
        with ncio.open_nc(self.path) as nc:
            if not self._init:
                self._initialize(nc)
            olon, olat = self.offsets
            yx = (slice(olat + y0, olat + y1), slice(olon, olon + self.nx))
            if kind == "2d":      # file layout (t, y, x)
                return ncio.get_var(nc, var,
                                    index=(pos,) + yx).reshape(-1)[trim]
            data = ncio.get_var(nc, var, index=(pos, slice(None)) + yx)
        if data.shape[0] != nzp1:   # file layout (t, z, y, x)
            raise ncio.NetCDFError(
                f"{self.path}:{var} has {data.shape[0]} levels, expected "
                f"{nzp1}")
        return np.moveaxis(data, 0, -1).reshape(-1, nzp1)[trim]

    def _read(self, kind, var, pos, nzp1=None, rows=None):
        with self._cache_lock:
            hit = self._cache.pop((kind, var, pos, nzp1, rows), None)
        if hit is not None:
            self.cache_hits += 1
            return hit
        return self._read_uncached(kind, var, pos, nzp1, rows)

    def read2d(self, var: str, pos: int, rows=None) -> np.ndarray:
        """(npts,) slab at time index pos; ``rows=(lo, hi)`` reads only
        that flat-index range."""
        return self._read("2d", var, pos, None, rows)

    def read3d(self, var: str, pos: int, nzp1: int, rows=None) -> np.ndarray:
        """(npts, nzp1) slab at time index pos; ``rows=(lo, hi)`` reads
        only that flat-index range."""
        return self._read("3d", var, pos, nzp1, rows)

    def prefetch(self, kind: str, var: str, pos: int,
                 nzp1: Optional[int] = None, rows=None) -> None:
        """Read a slab into the cache (on the prefetcher thread): the
        bytes the synchronous read would produce."""
        key = (kind, var, pos, nzp1 if kind == "3d" else None, rows)
        with self._cache_lock:
            if key in self._cache:
                return
        data = self._read_uncached(kind, var, pos, key[3], rows)
        with self._cache_lock:
            # one (newest) entry per (kind, var): a prefetch that lost the
            # race with the synchronous read must not pile up
            for k in [k for k in self._cache if k[:2] == (kind, var)]:
                del self._cache[k]
            self._cache[key] = data

    def times(self) -> np.ndarray:
        if not self._init:
            with ncio.open_nc(self.path) as nc:
                self._initialize(nc)
        return self.file_times


class FluxFileReader:
    """Forcing-file reader (mckpp_read_fluxes_mod.F90): taux, tauy, swf,
    lwf, lhf, shf, precip at the ndtocn cadence; snow = 0.  The fields
    come back as tensors of ``dtype`` on ``device``: the whole domain, or
    with a layout attached (``set_layout``) this process's slab, read
    host-locally (the fluxes are the most frequent read)."""

    def __init__(self, cfg: KppConfig, lon0: float, lat0: float,
                 dtype=torch.float64, device="cpu", timers=None):
        d = cfg.domain
        self.cfg = cfg
        self.npts = d.nx * d.ny
        self.dtype, self.device = dtype, device
        self.layout = None
        # counts the bytes each read copies to the device
        self.timers = NO_TIMERS if timers is None else timers
        self.rd = AncillaryReader(cfg.forcing.forcing_file, lon0, lat0,
                                  d.nx, d.ny, time_name="time")

    def set_layout(self, layout) -> None:
        self.layout = layout

    def __call__(self, time_days: float) -> forcing_mod.RawFluxes:
        t = self.cfg.time
        _, pos = get_update_time(time_days, t.ndtocn, self.rd.times(),
                                 False, 0, t.dto, t.dtsec, method=1)
        lay = self.layout
        rows = None if lay is None else lay.local_rows(self.npts)

        def g(v):
            a = self.rd.read2d(v, pos, rows)
            if lay is not None:
                a = pad_rows(a, lay.hi - lay.lo)
            t = torch.as_tensor(a, dtype=self.dtype, device=self.device)
            self.timers.count("forcing.h2d_bytes", t.nbytes)
            return t
        taux = g("taux")
        return forcing_mod.RawFluxes(
            taux=taux, tauy=g("tauy"), swf=g("swf"), lwf=g("lwf"),
            lhf=g("lhf"), shf=g("shf"), rain=g("precip"),
            snow=torch.zeros_like(taux))


class BoundaryManager:
    """Applies the per-field ancillary cadences each step
    (mckpp_boundary_update_mod.F90) and the initial reads
    (mckpp_initialize_fields_mod.F90:70-118)."""

    def __init__(self, cfg: KppConfig, lon0: float, lat0: float,
                 nzp1: int, sref: np.ndarray, timers=None):
        self.cfg = cfg
        # the SST update's spans and the bytes each read copies to the
        # device
        self.timers = NO_TIMERS if timers is None else timers
        self.nzp1 = nzp1
        self.sref = np.asarray(sref)
        # with a column layout (set_layout) every read fetches this
        # process's rows only, padded to its slab
        self.layout = None
        d, f, b = cfg.domain, cfg.forcing, cfg.boundary
        mk = lambda path: AncillaryReader(path, lon0, lat0, d.nx, d.ny)
        self.sst = mk(b.sst_file) if b.l_climsst or b.l_upd_climsst else None
        self.ice = mk(b.ice_file) if b.l_climice or b.l_upd_climice else None
        self.fcorr = mk(f.fcorr_file) if (f.l_fcorr or f.l_fcorr_withz) else None
        self.sfcorr = mk(f.sfcorr_file) if (f.l_sfcorr or f.l_sfcorr_withz) else None
        self.bottom = mk(f.bottom_file) if f.l_vary_bottom_temp else None
        need_ocnt = (b.l_relax_ocnt or f.l_upd_ocnt or f.l_no_isotherm)
        need_sal = (b.l_relax_sal or f.l_upd_sal or f.l_no_isotherm)
        self.ocnt = mk(f.ocnt_file) if need_ocnt else None
        self.sal = mk(f.sal_file) if need_sal else None
        # after each dispatcher pass the next record due on every active
        # cadence is read ahead on a background thread, so the loop's
        # synchronous read is a cache hit; the cache is keyed by (var,
        # record) and holds exactly the bytes the synchronous read makes
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None
        self._prefetch_futs: list = []

    def set_layout(self, layout) -> None:
        """Attach a ``parallel.distributed.ColumnLayout`` (or None): reads
        then fetch this process's rows only (host-local reads, the
        per-rank block of an MPI decomposition, SURVEY §2.6)."""
        self.layout = layout

    @property
    def npts(self) -> int:
        return self.cfg.domain.nx * self.cfg.domain.ny

    def _rows(self):
        """This process's flat rows [lo, hi) clamped to the domain; None
        (the whole domain) without a layout."""
        if self.layout is None:
            return None
        return self.layout.local_rows(self.npts)

    def _local(self, arr: np.ndarray) -> np.ndarray:
        """A read padded up to the layout's slab (rows beyond the domain
        are padding columns)."""
        if self.layout is None:
            return arr
        return pad_rows(arr, self.layout.hi - self.layout.lo)

    def _get2d(self, reader, var, pos):
        return self._local(reader.read2d(var, pos, self._rows()))

    def _get3d(self, reader, var, pos):
        return self._local(reader.read3d(var, pos, self.nzp1, self._rows()))

    def _local_sref(self) -> np.ndarray:
        """Sref rows matching what _get3d returns."""
        rows = self._rows()
        if rows is None:
            return self.sref
        return self._local(self.sref[rows[0]:rows[1]])

    def _kelvin(self, a: np.ndarray) -> np.ndarray:
        """Kelvin autoconversion, decided over the whole domain as the
        reference does (ANY() over the domain, mckpp_read_sst_mod.F90:84-88):
        a rank's slab must not decide differently from its peers."""
        if any_across_processes(bool(np.any((a > 200.0) & (a < 400.0)))):
            return a - self.cfg.constants.tk0
        return a

    def _dev(self, arr, like: torch.Tensor) -> torch.Tensor:
        """Host array -> tensor of ``like``'s dtype and device."""
        t = torch.as_tensor(np.asarray(arr), dtype=like.dtype,
                            device=like.device)
        self.timers.count("ancillary.h2d_bytes", t.nbytes)
        return t

    # ---- individual reads -------------------------------------------------
    def _upd(self, reader, ndt, periodic, period, method):
        t = self.cfg.time
        return get_update_time(self._time, ndt, reader.times(), periodic,
                               period, t.dto, t.dtsec, method=method,
                               spd=self.cfg.constants.spd)

    def read_sst(self, frc: Forcing) -> Forcing:
        b = self.cfg.boundary
        _, pos = self._upd(self.sst, b.ndtupdsst, b.l_periodic_climsst,
                           b.climsst_period, 1)
        with self.timers.span("ancillary.sst.read",
                                  device=False):
            sst = self._kelvin(self._get2d(self.sst, "sst", pos))
        # uncoupled: SST0 is the whole domain (mckpp_physics_overrides_sst0)
        with self.timers.span("ancillary.sst.h2d"):
            frc = frc.replace(sst0=self._dev(sst, frc.sst0))
        # the SST read zeroes the ice/surface-current climatologies when
        # their own readers are off (mckpp_read_sst_mod.F90:88-96)
        if not b.l_climice:
            frc = frc.replace(iceconc=torch.zeros_like(frc.iceconc))
        if not b.l_climcurr:
            frc = frc.replace(usf=torch.zeros_like(frc.usf),
                              vsf=torch.zeros_like(frc.vsf))
        return frc

    def read_ice(self, frc: Forcing) -> Forcing:
        """Sea-ice concentration (+ optional depth/snow) on the ndtupdice
        cadence (mckpp_read_ice_mod.F90:57-118)."""
        b = self.cfg.boundary
        _, pos = self._upd(self.ice, b.ndtupdice, b.l_periodic_climice,
                           b.climice_period, 1)
        frc = frc.replace(iceconc=self._dev(
            self._get2d(self.ice, "iceconc", pos), frc.iceconc))
        if b.l_clim_ice_depth:
            frc = frc.replace(icedepth=self._dev(
                self._get2d(self.ice, "icedepth", pos), frc.icedepth))
        if b.l_clim_snow_on_ice:
            frc = frc.replace(snowdepth=self._dev(
                self._get2d(self.ice, "snowdepth", pos), frc.snowdepth))
        return frc

    def read_fcorr(self, frc: Forcing) -> Forcing:
        f = self.cfg.forcing
        if f.l_fcorr_withz:
            _, pos = self._upd(self.fcorr, f.ndtupdfcorr, f.l_periodic_fcorr,
                               f.fcorr_period, 1)
            fz = self._get3d(self.fcorr, "fcorr", pos)
            return frc.replace(fcorr_withz=self._dev(fz, frc.fcorr_withz))
        _, pos = self._upd(self.fcorr, f.ndtupdfcorr, f.l_periodic_fcorr,
                           f.fcorr_period, 2)
        f2 = self._get2d(self.fcorr, "fcorr", pos)
        return frc.replace(fcorr_twod=self._dev(f2, frc.fcorr_twod))

    def read_sfcorr(self, frc: Forcing) -> Forcing:
        f = self.cfg.forcing
        if f.l_sfcorr_withz:
            _, pos = self._upd(self.sfcorr, f.ndtupdsfcorr,
                               f.l_periodic_sfcorr, f.sfcorr_period, 1)
            sz = self._get3d(self.sfcorr, "sfcorr", pos)
            return frc.replace(sfcorr_withz=self._dev(sz, frc.sfcorr_withz))
        _, pos = self._upd(self.sfcorr, f.ndtupdsfcorr, f.l_periodic_sfcorr,
                           f.sfcorr_period, 2)
        s2 = self._get2d(self.sfcorr, "sfcorr", pos)
        return frc.replace(sfcorr_twod=self._dev(s2, frc.sfcorr_twod))

    def read_bottom(self, frc: Forcing) -> Forcing:
        f = self.cfg.forcing
        _, pos = self._upd(self.bottom, f.ndtupdbottom,
                           f.l_periodic_bottom_temp, f.bottom_temp_period, 1)
        bt = self._kelvin(self._get2d(self.bottom, "T", pos))
        return frc.replace(bottom_temp=self._dev(bt, frc.bottom_temp))

    def read_ocnt(self, frc: Forcing, at_time: Optional[float] = None) -> Forcing:
        f = self.cfg.forcing
        saved = self._time
        if at_time is not None:
            self._time = at_time
        try:
            _, pos = self._upd(self.ocnt, f.ndtupdocnt, f.l_periodic_ocnt,
                               f.ocnt_period, 2)
        finally:
            self._time = saved
        t3 = self._get3d(self.ocnt, "temperature", pos)
        return frc.replace(ocnt_clim=self._dev(t3, frc.ocnt_clim))

    def read_sal(self, frc: Forcing, at_time: Optional[float] = None) -> Forcing:
        f = self.cfg.forcing
        saved = self._time
        if at_time is not None:
            self._time = at_time
        try:
            _, pos = self._upd(self.sal, f.ndtupdsal, f.l_periodic_sal,
                               f.sal_period, 2)
        finally:
            self._time = saved
        s3 = self._get3d(self.sal, "salinity", pos) \
            - self._local_sref()[:, None]
        return frc.replace(sal_clim=self._dev(s3, frc.sal_clim))

    # ---- time interpolation (mckpp_boundary_interpolate.F90) -------------
    def _interp(self, frc, read_fn, ndt_upd, period, field):
        true_time = int(self._time)
        nd = ndt_upd * self.cfg.time.dto / self.cfg.constants.spd
        prev_time = int(math.floor((true_time + nd / 2) / nd) * nd - nd * 0.5)
        if prev_time < 0:
            prev_weight = (nd - abs(true_time - prev_time)) / nd
            prev_time = prev_time + period
        else:
            prev_weight = (nd - (true_time - prev_time)) / nd
        next_time = prev_time + nd
        next_weight = 1.0 - prev_weight
        prev = getattr(read_fn(frc, at_time=prev_time), field)
        nxt = getattr(read_fn(frc, at_time=next_time), field)
        return frc.replace(**{field: nxt * next_weight + prev * prev_weight})

    def interp_ocnt(self, frc: Forcing) -> Forcing:
        f = self.cfg.forcing
        return self._interp(frc, self.read_ocnt, f.ndtupdocnt,
                            f.ocnt_period, "ocnt_clim")

    def interp_sal(self, frc: Forcing) -> Forcing:
        f = self.cfg.forcing
        return self._interp(frc, self.read_sal, f.ndtupdsal,
                            f.sal_period, "sal_clim")

    # ---- initialization-time reads (initialize_fields) -------------------
    def initial_reads(self, time_days: float, frc: Forcing) -> Forcing:
        self._time = time_days
        f, b = self.cfg.forcing, self.cfg.boundary
        if b.l_climsst:
            frc = self.read_sst(frc)
        if b.l_climice:
            frc = self.read_ice(frc)
        if f.l_fcorr_withz or f.l_fcorr:
            frc = self.read_fcorr(frc)
        if f.l_sfcorr_withz or f.l_sfcorr:
            frc = self.read_sfcorr(frc)
        if f.l_vary_bottom_temp:
            frc = self.read_bottom(frc)
        if b.l_relax_ocnt:
            frc = self.interp_ocnt(frc) if f.l_interp_ocnt else self.read_ocnt(frc)
        if b.l_relax_sal:
            frc = self.interp_sal(frc) if f.l_interp_sal else self.read_sal(frc)
        if f.l_no_isotherm and not b.l_relax_sal and not b.l_relax_ocnt:
            frc = self.read_ocnt(frc)
            frc = self.read_sal(frc)
        self.schedule_prefetch(1, time_days)
        return frc

    def due_any(self, ntime: int) -> bool:
        """Whether :meth:`update` would refresh any field at step ntime —
        the chain's segment-start predicate (models/chain.py)."""
        f, b = self.cfg.forcing, self.cfg.boundary

        def due(ndt):
            return (ntime - 1) % ndt == 0

        return bool(
            (b.l_upd_climsst and due(b.ndtupdsst))
            or (b.l_upd_climice and due(b.ndtupdice))
            or (f.l_upd_fcorr and due(f.ndtupdfcorr)
                and (f.l_fcorr_withz or f.l_fcorr))
            or (f.l_upd_sfcorr and due(f.ndtupdsfcorr)
                and (f.l_sfcorr_withz or f.l_sfcorr))
            or (f.l_upd_bottom_temp and due(f.ndtupdbottom))
            or (f.l_upd_sal and not f.l_interp_sal and due(f.ndtupdsal))
            or (f.l_upd_sal and f.l_interp_sal and due(f.ndt_interp_sal))
            or (f.l_upd_ocnt and not f.l_interp_ocnt and due(f.ndtupdocnt))
            or (f.l_upd_ocnt and f.l_interp_ocnt
                and due(f.ndt_interp_ocnt)))

    # ---- per-step dispatcher (mckpp_boundary_update_mod.F90:24-124) ------
    def update(self, ntime: int, time_days: float, frc: Forcing) -> Forcing:
        f, b = self.cfg.forcing, self.cfg.boundary
        self._time = time_days

        def due(ndt):
            return (ntime - 1) % ndt == 0

        if b.l_upd_climsst and due(b.ndtupdsst):
            frc = self.read_sst(frc)
        if b.l_upd_climice and due(b.ndtupdice):
            frc = self.read_ice(frc)
        if f.l_upd_fcorr and due(f.ndtupdfcorr) and (f.l_fcorr_withz or f.l_fcorr):
            frc = self.read_fcorr(frc)
        if f.l_upd_sfcorr and due(f.ndtupdsfcorr) and (f.l_sfcorr_withz or f.l_sfcorr):
            frc = self.read_sfcorr(frc)
        if f.l_upd_bottom_temp and due(f.ndtupdbottom):
            frc = self.read_bottom(frc)
        if f.l_upd_sal and not f.l_interp_sal and due(f.ndtupdsal):
            frc = self.read_sal(frc)
        elif f.l_upd_sal and f.l_interp_sal and due(f.ndt_interp_sal):
            frc = self.interp_sal(frc)
        if f.l_upd_ocnt and not f.l_interp_ocnt and due(f.ndtupdocnt):
            frc = self.read_ocnt(frc)
        elif f.l_upd_ocnt and f.l_interp_ocnt and due(f.ndt_interp_ocnt):
            frc = self.interp_ocnt(frc)
        self.schedule_prefetch(ntime, time_days)
        return frc

    # ---- cadence-ahead prefetch ------------------------------------------
    def _prefetch_jobs(self, ntime: int, time_days: float):
        """(reader, kind, var, ndt, periodic, period, method, time') for
        every ancillary whose next cadence firing can be read ahead (the
        time-interpolated fields are not: their bracketing records are
        cheap repeat reads)."""
        f, b, t = self.cfg.forcing, self.cfg.boundary, self.cfg.time
        table = []
        if b.l_upd_climsst:
            table.append((self.sst, "2d", "sst", b.ndtupdsst,
                          b.l_periodic_climsst, b.climsst_period, 1))
        if b.l_upd_climice:
            vars_ = ["iceconc"]
            if b.l_clim_ice_depth:
                vars_.append("icedepth")
            if b.l_clim_snow_on_ice:
                vars_.append("snowdepth")
            for v in vars_:
                table.append((self.ice, "2d", v, b.ndtupdice,
                              b.l_periodic_climice, b.climice_period, 1))
        if f.l_upd_fcorr and f.l_fcorr_withz:
            table.append((self.fcorr, "3d", "fcorr", f.ndtupdfcorr,
                          f.l_periodic_fcorr, f.fcorr_period, 1))
        elif f.l_upd_fcorr and f.l_fcorr:
            table.append((self.fcorr, "2d", "fcorr", f.ndtupdfcorr,
                          f.l_periodic_fcorr, f.fcorr_period, 2))
        if f.l_upd_sfcorr and f.l_sfcorr_withz:
            table.append((self.sfcorr, "3d", "sfcorr", f.ndtupdsfcorr,
                          f.l_periodic_sfcorr, f.sfcorr_period, 1))
        elif f.l_upd_sfcorr and f.l_sfcorr:
            table.append((self.sfcorr, "2d", "sfcorr", f.ndtupdsfcorr,
                          f.l_periodic_sfcorr, f.sfcorr_period, 2))
        if f.l_upd_bottom_temp:
            table.append((self.bottom, "2d", "T", f.ndtupdbottom,
                          f.l_periodic_bottom_temp, f.bottom_temp_period, 1))
        if f.l_upd_sal and not f.l_interp_sal:
            table.append((self.sal, "3d", "salinity", f.ndtupdsal,
                          f.l_periodic_sal, f.sal_period, 2))
        if f.l_upd_ocnt and not f.l_interp_ocnt:
            table.append((self.ocnt, "3d", "temperature", f.ndtupdocnt,
                          f.l_periodic_ocnt, f.ocnt_period, 2))
        jobs = []
        for reader, kind, var, ndt, periodic, period, method in table:
            # next step n' > ntime with (n'-1) % ndt == 0
            n_next = ((ntime - 1) // ndt + 1) * ndt + 1
            t_next = time_days + (n_next - ntime) * t.dto \
                / self.cfg.constants.spd
            jobs.append((reader, kind, var, ndt, periodic, period,
                         method, t_next))
        return jobs

    def schedule_prefetch(self, ntime: int, time_days: float) -> None:
        """Queue background reads of each active ancillary's next record."""
        jobs = self._prefetch_jobs(ntime, time_days)
        if not jobs:
            return
        if self._prefetch_pool is None:
            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ancprefetch")
        t = self.cfg.time
        rows = self._rows()

        def run(reader, kind, var, ndt, periodic, period, method, when):
            try:
                _, pos = get_update_time(when, ndt, reader.times(), periodic,
                                         period, t.dto, t.dtsec, method=method)
                reader.prefetch(kind, var, pos,
                                self.nzp1 if kind == "3d" else None, rows)
            except ncio.NetCDFError:
                # a record past the file's end: the synchronous read, if
                # it ever comes, raises the real, contextful error
                pass

        for f in self._prefetch_futs:
            if f.done():
                f.result()          # raises what a prefetch hit, if any
        self._prefetch_futs = [f for f in self._prefetch_futs if not f.done()]
        for job in jobs:
            self._prefetch_futs.append(self._prefetch_pool.submit(run, *job))

    def drain_prefetch(self) -> None:
        """Wait for queued prefetch reads (test/shutdown hook)."""
        for f in self._prefetch_futs:
            f.result()
        self._prefetch_futs = []
