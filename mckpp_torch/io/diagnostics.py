"""XIOS-equivalent diagnostics engine: per-step field extraction, temporal
reductions on the device (instant / average / minimum / maximum) and
NetCDF files written by a background thread (counterpart of
``mckpp_tpu/io/diagnostics.py``; reference: mckpp_xios_io.F90:74-210 and
run/iodef.xml:88-157).

The 35 diagnostic fields (23 depth-varying + 12 single-level) keep the
reference's staggering: salinity gets Sref added back; difm/dift/difs/
dbloc are shifted one level down with a zero surface value.  Reductions
accumulate on the model's device with ``torch.add``/``minimum``/
``maximum`` in the JAX package's order; an emitted window is fetched to
the host and encoded on the writer thread while the model steps on.
Files are split daily where the stream asks for it, land columns carry
the fill value, and every file carries the lon/lat axes and the time
metadata.

In a run over several processes (``set_layout``) the accumulators hold
each rank's slab.  ``write_mode="single"`` (XIOS one_file) gathers each
emitted window to rank 0, the one writer, synchronously on the loop
thread (the gather is a collective, which must not run on the writer
thread); ``write_mode="shard"`` (XIOS multiple_file) has every rank write
its own rows to ``<stream>[_<split>]_p<rank>.nc`` with no collective,
and :func:`merge_shard_files` reassembles them offline.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..state import ColumnParams, Forcing, State
from ..utils.timer import NO_TIMERS
from . import ncio

DEPTH_FIELDS = ("u", "v", "T", "S", "B", "wu", "wv", "wT", "wS", "wB",
                "wTnt", "difm", "dift", "difs", "rho", "cp", "scorr", "Rig",
                "dbloc", "Shsq", "tinc_fcorr", "fcorr_z", "sinc_fcorr")
SURFACE_FIELDS = ("hmix", "fcorr", "taux_in", "tauy_in", "solar_in",
                  "nsolar_in", "PminusE_in", "cplwght", "freeze_flag",
                  "comp_flag", "dampu_flag", "dampv_flag")

FILL_VALUE = 1.0e20          # XIOS/netCDF default fill for masked points

# fields that need the step's diagnostic-materialization pass (the wide
# outputs of ops/ocnstep_fused.py's final full pass); everything else is
# prognostic or refreshed every step and is valid after a with_diags=False
# step too
WIDE_FIELDS = frozenset({
    "B", "wu", "wv", "wT", "wS", "wB", "wTnt", "difm", "dift", "difs",
    "rho", "cp", "scorr", "Rig", "dbloc", "Shsq", "tinc_fcorr", "fcorr_z",
    "sinc_fcorr", "fcorr"})

_OPS = {"average": torch.add, "minimum": torch.minimum,
        "maximum": torch.maximum}


def extract_fields(st: State, prm: ColumnParams, frc: Forcing,
                   names=None) -> Dict[str, torch.Tensor]:
    """The diagnostic field dict of the model state (reference:
    mckpp_xios_diagnostic_output, mckpp_xios_io.F90:86-208), all fields or
    only ``names``.  Depth-varying fields are (ncol, nzp1); single-level
    ones (ncol,)."""
    nz = st.u.shape[-2] - 1

    def zero_col():
        return torch.zeros(st.hmix.shape + (1,), dtype=st.u.dtype,
                           device=st.u.device)

    def shift_down(interface_arr):
        # reference: level 1 = 0, levels 2..NZP1 = dif(1..NZ)
        return torch.cat([zero_col(), interface_arr[..., 1:nz + 1]], dim=-1)

    get = {
        "u": lambda: st.u[..., 0], "v": lambda: st.u[..., 1],
        "T": lambda: st.x[..., 0],
        "S": lambda: st.x[..., 1] + prm.sref[..., None],
        "B": lambda: st.buoy,
        "wu": lambda: st.wu[..., 0], "wv": lambda: st.wu[..., 1],
        "wT": lambda: st.wx[..., 0], "wS": lambda: st.wx[..., 1],
        "wB": lambda: st.wx[..., 2],
        "wTnt": lambda: st.wxnt[..., 0],
        "difm": lambda: shift_down(st.difm),
        "dift": lambda: shift_down(st.dift),
        "difs": lambda: shift_down(st.difs),
        "rho": lambda: st.rho, "cp": lambda: st.cp,
        "scorr": lambda: st.scorr,
        "Rig": lambda: torch.cat([st.rig[..., 1:], zero_col()], dim=-1),
        "dbloc": lambda: torch.cat([zero_col(), st.dbloc[..., 1:]], dim=-1),
        "Shsq": lambda: torch.cat([st.shsq[..., 1:], zero_col()], dim=-1),
        "tinc_fcorr": lambda: st.tinc_fcorr,
        "fcorr_z": lambda: st.ocntcorr,
        "sinc_fcorr": lambda: st.sinc_fcorr,
        "hmix": lambda: st.hmix, "fcorr": lambda: st.fcorr,
        "taux_in": lambda: frc.sflux[..., 0],
        "tauy_in": lambda: frc.sflux[..., 1],
        "solar_in": lambda: frc.sflux[..., 2],
        "nsolar_in": lambda: frc.sflux[..., 3],
        "PminusE_in": lambda: frc.sflux[..., 5],
        "cplwght": lambda: prm.cplwght,
        "freeze_flag": lambda: st.freeze_flag,
        "comp_flag": lambda: st.reset_flag,   # the reference outputs reset_flag
        "dampu_flag": lambda: st.dampu_flag,
        "dampv_flag": lambda: st.dampv_flag,
    }
    return {k: get[k]() for k in (get if names is None else names)}


@dataclasses.dataclass
class Stream:
    """One output stream: fields x reduction x frequency (an iodef.xml
    <file> element).  ``split_freq_days`` reproduces XIOS's split_freq
    (run/iodef.xml:88): each split window goes to its own
    ``<name>_<start-day>.nc`` as soon as the window closes.  ``entries``
    holds (output name, source field, operation) triples, so one file can
    mix operations and rename fields; when unset, ``fields`` x
    ``reduction`` applies to every field."""
    name: str
    reduction: str                    # instant | average | minimum | maximum
    freq: int                         # output every `freq` ocean steps
    fields: Tuple[str, ...] = DEPTH_FIELDS + SURFACE_FIELDS
    split_freq_days: Optional[float] = None
    entries: Optional[Tuple[Tuple[str, str, str], ...]] = None

    def resolved_entries(self) -> Tuple[Tuple[str, str, str], ...]:
        if self.entries is not None:
            return self.entries
        return tuple((f, f, self.reduction) for f in self.fields)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(getattr(v, "nbytes", 0))


class DiagnosticsManager:
    """Accumulates temporal reductions on the device; emitted records
    stream to per-split NetCDF files as each split window closes
    (mckpp_xios_io.F90:35-210 + run/iodef.xml:88-157)."""

    def __init__(self, streams: List[Stream], nx: int, ny: int, zm,
                 outdir: str = ".", start_time_days: float = 0.0,
                 dto_seconds: float = 0.0, l_ocean=None,
                 async_write: bool = True, write_mode: str = "single",
                 lons=None, lats=None, timers=None):
        """``write_mode``: "single" writes each stream from rank 0 (XIOS
        one_file); "shard" has every rank write its own rows (XIOS
        multiple_file).  ``l_ocean`` is the whole domain's mask.
        ``timers``: a ``utils.timer.Timers`` that takes the emit's spans
        (``diag.emit``, ``diag.cap_wait`` on the loop thread; ``diag.d2h``,
        ``diag.fill``, ``diag.pack``, ``diag.write`` on the writer's, each
        with the hour of the emit that queued it) and the fetch's
        bytes."""
        if write_mode not in ("single", "shard"):
            raise ValueError(f"write_mode {write_mode!r}")
        self.write_mode = write_mode
        self.timers = NO_TIMERS if timers is None else timers
        # windows gathered across processes on emit (stays 0 in shard
        # mode; the CLI reports it)
        self.emit_gathers = 0
        self.layout = None
        self.streams = streams
        self.nx, self.ny = nx, ny
        self.zm = _host(zm)
        # rectilinear domain axes (the XIOS domain lon/lat,
        # mckpp_xios_io.F90:48-57), written as coordinate variables
        self.lons = None if lons is None else np.asarray(lons, np.float64)
        self.lats = None if lats is None else np.asarray(lats, np.float64)
        self.outdir = outdir
        self.start = start_time_days
        self.dto_days = dto_seconds / 86400.0
        # output-domain land mask (reference mask_1d, mckpp_xios_io.F90:58):
        # land columns are written as FILL_VALUE
        self.mask = None if l_ocean is None else ~_host(l_ocean)
        self._accum: Dict[str, Optional[Dict[str, torch.Tensor]]] = {
            s.name: None for s in streams}
        self._count: Dict[str, int] = {s.name: 0 for s in streams}
        self._records: Dict[str, list] = {s.name: [] for s in streams}
        self._split_idx: Dict[str, int] = {s.name: 0 for s in streams}
        self.paths: Dict[str, str] = {}
        self.bytes_written = 0
        # async writer: the device->host fetch + NetCDF encode of a closed
        # window runs on a background thread (XIOS's detached server)
        self._writer = (ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="diag-writer")
                        if async_write else None)
        self._pending = []
        self._plock = threading.Lock()
        # bound on emitted-but-unfetched window BYTES (device-buffer
        # lifetime): a 144k-column all-diags window is ~0.9 GB in float32
        self._inflight = collections.deque()     # (future, nbytes)
        self._inflight_bytes = 0
        self._max_pending_mb = float(
            os.environ.get("MCKPP_DIAG_MAX_PENDING_MB", "512"))

    def set_layout(self, layout) -> None:
        """Attach a ``parallel.distributed.ColumnLayout``: ``step`` is then
        fed this rank's slab (padding columns included)."""
        self.layout = layout

    @property
    def _multi(self) -> bool:
        return self.layout is not None and self.layout.world > 1

    @property
    def _sharded(self) -> bool:
        return self.write_mode == "shard" and self._multi

    def needs_full(self, nt: int) -> bool:
        """Whether step ``nt`` must run with full diagnostic
        materialization: some stream samples a WIDE field this step —
        reducing entries every step, instant entries on their emit step."""
        for s in self.streams:
            emit = nt % s.freq == 0
            for _, src, op in s.resolved_entries():
                if src in WIDE_FIELDS and (op != "instant" or emit):
                    return True
        return False

    def step(self, nt: int, st: State, prm: ColumnParams, frc: Forcing):
        # union of source fields any stream samples THIS step: reducing
        # entries every step, instant entries only on their emit step
        needed = set()
        for s in self.streams:
            emit = nt % s.freq == 0
            for _, src, op in s.resolved_entries():
                if op != "instant" or emit:
                    needed.add(src)
        if not needed:
            return
        fields = extract_fields(st, prm, frc, sorted(needed))
        for s in self.streams:
            ents = s.resolved_entries()
            red = tuple(e for e in ents if e[2] != "instant")
            inst = tuple(e for e in ents if e[2] == "instant")
            emit = nt % s.freq == 0
            if not red and not emit:
                continue
            if red:
                sub = {out: fields[src] for out, src, _ in red}
                if self._accum[s.name] is None:
                    self._accum[s.name] = sub
                    self._count[s.name] = 1
                else:
                    acc = self._accum[s.name]
                    self._accum[s.name] = {
                        out: _OPS[op](acc[out], sub[out])
                        for out, _, op in red}
                    self._count[s.name] += 1
            if emit:
                self._emit(s, nt,
                           {out: fields[src] for out, src, _ in inst})

    def _emit(self, s: Stream, nt: int, instant_fields=None):
        with self.timers.span("diag.emit"):
            self._emit_window(s, nt, instant_fields)

    def _emit_window(self, s: Stream, nt: int, instant_fields):
        acc = dict(self._accum[s.name] or {})
        if instant_fields:
            acc.update(instant_fields)
        cnt = self._count[s.name]
        self._accum[s.name] = None
        self._count[s.name] = 0
        if self._multi and self.write_mode == "single":
            # the single writer: gather the window to rank 0 here, on the
            # loop thread, once per emitted window
            acc = {k: self.layout.gather(v, dst=0) for k, v in acc.items()}
            self.emit_gathers += len(acc)
            if self.layout.rank != 0:
                return
        t = self.start + nt * self.dto_days
        # close the current split window first if this record starts a new
        # one (a record stamps the END of its window, so the window index
        # takes a small backward nudge)
        if s.split_freq_days:
            k = int((t - self.start - 1e-9) // s.split_freq_days)
            if self._records[s.name] and k != self._split_idx[s.name]:
                self._write_split(s)
            self._split_idx[s.name] = k
        ops = {out: op for out, _, op in s.resolved_entries()}
        packed = (acc, cnt, ops, self.timers.hour)
        if self._writer is not None:
            # fetch on the writer thread now, so the device buffers free
            # as soon as the copy lands; block here when the emitted but
            # unfetched bytes pass the cap (the XIOS client does the same
            # when its server buffer fills)
            nbytes = sum(_nbytes(v) for v in acc.values())
            cap = self._max_pending_mb * 1e6
            if self._inflight and self._inflight_bytes + nbytes > cap:
                with self.timers.span("diag.cap_wait",
                                      device=False):
                    while self._inflight and \
                            self._inflight_bytes + nbytes > cap:
                        fut0, nb0 = self._inflight.popleft()
                        fut0.result()
                        self._inflight_bytes -= nb0
            packed = self._writer.submit(self._materialize, packed)
            self._inflight.append((packed, nbytes))
            self._inflight_bytes += nbytes
        self._records[s.name].append((t, packed))

    def _shard_rows(self):
        """This rank's [lo, hi) of the unpadded domain (shard mode)."""
        return self.layout.local_rows(self.nx * self.ny)

    def _materialize(self, packed):
        acc, cnt, ops, hour = packed
        timers = self.timers
        mask = self.mask
        if self._sharded and mask is not None:
            lo, hi = self._shard_rows()
            mask = mask[lo:hi]
        rec = {}
        for k, v in acc.items():
            with timers.span("diag.d2h", hour):
                if self._sharded:
                    a = self.layout.local_shard(v)  # own rows, no collective
                else:
                    a = _host(v)[: self.nx * self.ny]     # unpadded
            timers.count("diag.d2h_bytes", _nbytes(v))
            with timers.span("diag.fill", hour, device=False):
                if ops[k] == "average":
                    a = a / cnt
                if mask is not None:
                    a = a.copy()
                    a[mask, ...] = FILL_VALUE
            rec[k] = a
        return rec

    def _write_split(self, s: Stream):
        """Hand the stream's buffered records to the writer and drop them
        from the buffer."""
        recs = self._records[s.name]
        if not recs:
            return
        self._records[s.name] = []
        split_idx = self._split_idx[s.name]
        if self._multi and self.write_mode == "single" \
                and self.layout.rank != 0:
            return                 # the single writer is rank 0
        hour = self.timers.hour
        if self._writer is not None:
            self._pending.append(
                self._writer.submit(self._encode, s, recs, split_idx, hour))
        else:
            self._encode(s, recs, split_idx, hour)

    def _encode(self, s: Stream, recs, split_idx, hour=None):
        # windows materialized on this same single writer thread before
        # this job are complete already (FIFO)
        recs = [(t, p.result() if isinstance(p, Future)
                 else self._materialize(p)) for t, p in recs]
        with self.timers.span("diag.pack", hour, device=False):
            dims, coords, fields, attrs, var_attrs, fname = self._pack(
                s, recs, split_idx)
        path = os.path.join(self.outdir, fname)
        os.makedirs(self.outdir, exist_ok=True)
        with self.timers.span("diag.write", hour, device=False):
            ncio.write_fields(path, dims, coords, fields, attrs=attrs,
                              var_attrs=var_attrs)
        with self._plock:
            self.paths[fname if s.split_freq_days else s.name] = path
            self.bytes_written += os.path.getsize(path)
        return path

    def _pack(self, s: Stream, recs, split_idx):
        """The file's dimensions, coordinates, fields (the records
        stacked), attributes and name."""
        times = [t for t, _ in recs]
        nt = len(recs)
        nzp1 = len(self.zm)
        attrs = {"reduction": s.reduction.encode(),
                 "fill_value": FILL_VALUE}
        suffix = ""
        if self._sharded:
            # this rank's rows [lo, hi) of the flattened (y, x) domain on a
            # flat "points" dimension, recorded for merge_shard_files
            lo, hi = self._shard_rows()
            rank = self.layout.rank
            suffix = f"_p{rank}"
            dims = {"time": nt, "z": nzp1, "points": hi - lo}
            attrs.update(shard_lo=lo, shard_hi=hi, shard_nx=self.nx,
                         shard_ny=self.ny, shard_rank=rank,
                         shard_count=self.layout.world)
        else:
            dims = {"time": nt, "z": nzp1, "y": self.ny, "x": self.nx}
        coords = {"time": ("time", times), "z": ("z", self.zm)}
        if self.lons is not None and self.lats is not None:
            # shard files carry the whole (small) axes too, so each file
            # describes itself and the merge passes them through
            dims["x"], dims["y"] = self.nx, self.ny
            coords["longitude"] = ("x", self.lons)
            coords["latitude"] = ("y", self.lats)
        fields = {}
        for name in recs[0][1]:
            sample = recs[0][1][name]
            arr = np.stack([r[name] for _, r in recs])
            if self._sharded:
                fields[name] = ((("time", "z", "points"),
                                 np.moveaxis(arr, -1, 1))
                                if sample.ndim == 2
                                else (("time", "points"), arr))
            elif sample.ndim == 2:        # (ncol, nzp1)
                arr = arr.reshape(nt, self.ny, self.nx, nzp1)
                fields[name] = (("time", "z", "y", "x"),
                                np.moveaxis(arr, -1, 1))
            else:
                fields[name] = (("time", "y", "x"),
                                arr.reshape(nt, self.ny, self.nx))
        if s.split_freq_days:
            split_start = self.start + split_idx * s.split_freq_days
            fname = f"{s.name}_{split_start:09.3f}{suffix}.nc"
        else:
            fname = f"{s.name}{suffix}.nc"
        # self-describing time metadata: XIOS stamps a Gregorian calendar
        # with origin 0000-01-01 + (day-counter + 1) days
        # (mckpp_xios_io.F90:41,63); "days since 0000-01-02" makes a CF
        # decode of the raw day-counter values land on the same dates
        var_attrs = {
            "time": {"units": "days since 0000-01-02 00:00:00",
                     "calendar": "gregorian", "axis": "T",
                     "standard_name": "time"},
            "z": {"units": "m", "positive": "up", "axis": "Z",
                  "long_name": "depth of model levels"},
        }
        if "longitude" in coords:
            var_attrs["longitude"] = {"units": "degrees_east", "axis": "X",
                                      "standard_name": "longitude"}
            var_attrs["latitude"] = {"units": "degrees_north", "axis": "Y",
                                     "standard_name": "latitude"}
        if self.mask is not None:
            for name in fields:
                var_attrs[name] = {"_FillValue": FILL_VALUE}
        return dims, coords, fields, attrs, var_attrs, fname

    def flush(self):
        """Write any remaining buffered records, wait for the writer to
        drain; returns all paths written over the run."""
        for s in self.streams:
            self._write_split(s)
        for fut in self._pending:
            fut.result()
        self._pending = []
        return self.paths


def merge_shard_files(shard_paths, out_path: str) -> str:
    """Reassemble the shard files of one stream window
    (``<stream>[_<split>]_p<rank>.nc``, written by ``write_mode="shard"``)
    into the single writer's ``(time, z, y, x)`` file, the offline half of
    the XIOS multiple_file workflow.  The values are those the single
    writer would write: the reductions are per column, so joining the
    row slabs loses nothing."""
    from scipy.io import netcdf_file

    def iattr(nc, name):        # attrs may read back as float or array
        return int(np.asarray(getattr(nc, name)).ravel()[0])

    def attrs_of(obj):
        return dict(obj._attributes)

    ncs = [netcdf_file(str(p), "r", mmap=False) for p in shard_paths]
    try:
        ncs.sort(key=lambda nc: iattr(nc, "shard_lo"))
        head = ncs[0]
        nx, ny = iattr(head, "shard_nx"), iattr(head, "shard_ny")
        npts = nx * ny
        pos = 0
        for nc in ncs:
            lo, hi = iattr(nc, "shard_lo"), iattr(nc, "shard_hi")
            if lo != pos:
                raise ValueError(f"shard files do not tile the domain: gap "
                                 f"at rows [{pos}, {lo})")
            pos = hi
        if pos != npts:
            raise ValueError(f"shard files cover rows [0, {pos}) of {npts}")
        # coordinates keep their on-disk precision (a float32 run writes
        # z as float32), so the merge equals the single writer's file
        coord = lambda v: np.array(v[:], v.data.dtype.newbyteorder("="))
        times, zvals = coord(head.variables["time"]), coord(head.variables["z"])
        nt, nzp1 = len(times), len(zvals)
        dims = {"time": nt, "z": nzp1, "y": ny, "x": nx}
        coords = {"time": ("time", times), "z": ("z", zvals)}
        var_attrs = {"time": attrs_of(head.variables["time"]),
                     "z": attrs_of(head.variables["z"])}
        # the domain axes (whole in every shard) pass straight through
        for axis, dim in (("longitude", "x"), ("latitude", "y")):
            if axis in head.variables:
                v = head.variables[axis]
                coords[axis] = (dim, coord(v))
                var_attrs[axis] = attrs_of(v)
        fields = {}
        for name, v in head.variables.items():
            if name in ("time", "z", "longitude", "latitude"):
                continue
            depth = v.data.ndim == 3
            # the shards' precision is kept: float32 stays float32 (the
            # on-disk dtype is big-endian ">f4", which is not np.float32)
            dt = v.data.dtype.newbyteorder("=")
            full = np.empty((nt, nzp1, npts) if depth else (nt, npts), dt)
            for nc in ncs:
                lo, hi = iattr(nc, "shard_lo"), iattr(nc, "shard_hi")
                full[..., lo:hi] = nc.variables[name][:]
            fields[name] = ((("time", "z", "y", "x"),
                             full.reshape(nt, nzp1, ny, nx)) if depth
                            else (("time", "y", "x"),
                                  full.reshape(nt, ny, nx)))
            if v._attributes:
                var_attrs[name] = attrs_of(v)
        attrs = {k: val for k, val in attrs_of(head).items()
                 if not k.startswith("shard_")}
    finally:
        for nc in ncs:
            nc.close()
    ncio.write_fields(out_path, dims, coords, fields, attrs=attrs,
                      var_attrs=var_attrs)
    return out_path


def default_streams(dto_seconds: float = 1200.0,
                    split_freq_days: Optional[float] = None) -> List[Stream]:
    """The reference test job's four streams (run/iodef.xml:88-157): 1h
    instant, 3h mean, 3h min, 3h max, the wall-clock cadences converted to
    ocean steps for the run's dto."""
    per_hour = max(1, int(round(3600.0 / dto_seconds)))
    return [
        Stream("kpp_1h_inst", "instant", per_hour,
               split_freq_days=split_freq_days),
        Stream("kpp_3h_mean", "average", 3 * per_hour,
               split_freq_days=split_freq_days),
        Stream("kpp_3h_min", "minimum", 3 * per_hour,
               split_freq_days=split_freq_days),
        Stream("kpp_3h_max", "maximum", 3 * per_hour,
               split_freq_days=split_freq_days),
    ]
