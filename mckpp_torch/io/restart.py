"""Checkpoint / resume (counterpart of ``mckpp_tpu/io/restart.py``).

The reference writes XIOS netCDF restarts holding the full two-level time
history (Us, Vs, Ts, Ss, hmixd) plus the integration counters old/new and
the surface reference fields (mckpp_xios_io.F90:364-433).  Here the
native checkpoint is the complete (State, ColumnParams, Forcing) written
bit-exactly to an ``.npz`` under the JAX package's key names
(``st_<field>``, ``pr_<field>``, ``fr_<field>``, ``meta_ntime``,
``meta_time_days``), so a restart written by either package resumes in
the other.  :func:`export_reference_restart` also writes the reference's
NetCDF field list.  Filenames carry the validity time of the next step
(mckpp_xios_control.F90:61-83).  In a run over several processes rank 0
writes from the gathered state and the other ranks write nothing; a run
resuming under a column layout slices each rank's rows from the file
(``setup.build``).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..convert import to_numpy
from ..state import ColumnParams, Forcing, State, tree_map
from ..utils.timer import NO_TIMERS
from . import ncio


def _flatten(prefix: str, obj) -> dict:
    return {f"{prefix}{k}": v for k, v in to_numpy(obj).items()}


def _unflatten(cls, prefix: str, data: dict, device):
    """Each field at the dtype it was saved with (float64 and float32
    alike), on ``device``."""
    kw = {f.name: torch.as_tensor(data[f"{prefix}{f.name}"], device=device)
          for f in dataclasses.fields(cls)}
    return cls(**kw)


def save_restart(path: str, st: State, prm: ColumnParams, frc: Forcing,
                 ntime: int, time_days: float, dto: float):
    """Write an exact checkpoint; the filename is suffixed with the
    validity time of the next step."""
    valid = time_days + dto / 86400.0
    full = f"{path}_{valid:012.5f}.npz"
    blob = {}
    blob.update(_flatten("st_", st))
    blob.update(_flatten("pr_", prm))
    blob.update(_flatten("fr_", frc))
    blob["meta_ntime"] = np.asarray(ntime)
    blob["meta_time_days"] = np.asarray(valid)
    os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
    np.savez(full, **blob)
    return full


def load_restart(path: str, device="cpu"
                 ) -> Tuple[State, ColumnParams, Forcing, int, float]:
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    st = _unflatten(State, "st_", data, device)
    prm = _unflatten(ColumnParams, "pr_", data, device)
    frc = _unflatten(Forcing, "fr_", data, device)
    return st, prm, frc, int(data["meta_ntime"]), float(data["meta_time_days"])


def export_reference_restart(path: str, st: State, prm: ColumnParams,
                             nx: int, ny: int, time_days: float, dto: float):
    """Reference-compatible NetCDF restart (field list of
    mckpp_xios_io.F90:406-433: time, uvel, vvel, T, S, CP, rho, hmix, kmix,
    Sref, SSref, Ssurf, Tref, old, new, Us, Vs, Ts, Ss, hmixd)."""
    s, p = to_numpy(st), to_numpy(prm)
    nzp1 = s["u"].shape[-2]

    def grid3(a):    # (ncol, nzp1) -> (z, y, x); restarts stay float64
        return np.moveaxis(
            np.asarray(a, np.float64).reshape(ny, nx, nzp1), -1, 0)

    def grid2(a):
        return np.asarray(a, np.float64).reshape(ny, nx)

    dims = {"z": nzp1, "y": ny, "x": nx, "two": 2, "t": 1}
    fields = {
        "time": (("t",), np.asarray([time_days + dto / 86400.0])),
        "uvel": (("z", "y", "x"), grid3(s["u"][..., 0])),
        "vvel": (("z", "y", "x"), grid3(s["u"][..., 1])),
        "T": (("z", "y", "x"), grid3(s["x"][..., 0])),
        "S": (("z", "y", "x"), grid3(s["x"][..., 1])),
        "CP": (("z", "y", "x"), grid3(s["cp"])),
        "rho": (("z", "y", "x"), grid3(s["rho"])),
        "hmix": (("y", "x"), grid2(s["hmix"])),
        "kmix": (("y", "x"), grid2(s["kmix"])),
        "Sref": (("y", "x"), grid2(p["sref"])),
        "SSref": (("y", "x"), grid2(p["ssref"])),
        "Ssurf": (("y", "x"), grid2(s["ssurf"])),
        "Tref": (("y", "x"), grid2(s["tref"])),
        "old": (("y", "x"), grid2(s["old"])),
        "new": (("y", "x"), grid2(s["new"])),
        "Us": (("two", "z", "y", "x"),
               np.stack([grid3(s["us"][..., 0, k]) for k in range(2)])),
        "Vs": (("two", "z", "y", "x"),
               np.stack([grid3(s["us"][..., 1, k]) for k in range(2)])),
        "Ts": (("two", "z", "y", "x"),
               np.stack([grid3(s["xs"][..., 0, k]) for k in range(2)])),
        "Ss": (("two", "z", "y", "x"),
               np.stack([grid3(s["xs"][..., 1, k]) for k in range(2)])),
        "hmixd": (("two", "y", "x"),
                  np.stack([grid2(s["hmixd"][:, k]) for k in range(2)])),
    }
    ncio.write_fields(path, dims, {}, fields)
    return path


def import_reference_restart(path: str, st: State, prm: ColumnParams,
                             grid=None):
    """Read a reference-format NetCDF restart (mckpp_xios_io.F90:436-465)
    into (State, ColumnParams, time_days).

    Work arrays not in the reference restart keep their initial values,
    the reference's resume semantics (ntime restarts at 1 and the first
    vertical-mixing call rebuilds them).  The swfrac/swdk_opt caches are
    reseeded when ``grid`` is given (mckpp_fluxes_mod.F90:101-106).
    """
    dtype, dev = st.u.dtype, st.u.device
    with ncio.open_nc(path) as nc:
        def f3(name):                     # (z, y, x) -> (ncol, nzp1)
            a = ncio.get_var(nc, name)
            return np.moveaxis(a, 0, -1).reshape(-1, a.shape[0])

        def f2(name):                     # (y, x) -> (ncol,)
            return ncio.get_var(nc, name).reshape(-1)

        def f4(name):                     # (two, z, y, x) -> (ncol, nzp1, 2)
            a = ncio.get_var(nc, name)
            return np.transpose(a.reshape(a.shape[0], a.shape[1], -1),
                                (2, 1, 0))

        fl = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        it = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32),
                                       device=dev)
        st = st.replace(
            u=fl(np.stack([f3("uvel"), f3("vvel")], axis=-1)),
            x=fl(np.stack([f3("T"), f3("S")], axis=-1)),
            us=fl(np.stack([f4("Us"), f4("Vs")], axis=-2)),
            xs=fl(np.stack([f4("Ts"), f4("Ss")], axis=-2)),
            hmixd=fl(ncio.get_var(nc, "hmixd").reshape(2, -1).T),
            cp=fl(f3("CP")), rho=fl(f3("rho")), hmix=fl(f2("hmix")),
            kmix=it(f2("kmix")), ssurf=fl(f2("Ssurf")), tref=fl(f2("Tref")),
            old=it(f2("old")), new=it(f2("new")))
        prm = prm.replace(sref=fl(f2("Sref")), ssref=fl(f2("SSref")))
        time_days = float(ncio.get_var(nc, "time").reshape(-1)[0])

    if grid is not None:
        from ..ops.swfrac import swdk, swfrac_levels
        st = st.replace(
            swfrac=swfrac_levels(1.0, grid.zm, prm.jerlov).to(dtype),
            swdk_opt=swdk(-grid.dm, prm.jerlov).to(dtype))
    return st, prm, time_days


class RestartControl:
    """Restart-write cadence (reference: mckpp_restart_control,
    mckpp_xios_control.F90:61-83): every ndt_per_restart steps and at the
    final step.

    Writes are detached from the step loop (``async_write``, the default):
    ``maybe_write`` hands the state to a background thread, which fetches
    it to the host and encodes the .npz (and NetCDF) file.  The caller
    passes state that nothing overwrites afterwards (the model's steps and
    the chain return fresh tensors).  With ``async_write=False`` the write
    runs on the caller's thread and ``maybe_write`` returns the .npz path.
    With a ``layout`` over several processes the state is gathered to rank
    0 first, synchronously on the calling (loop) thread, since the gather
    is a collective; only rank 0 writes.  ``timers``: a
    ``utils.timer.Timers`` that takes the spans ``restart.d2h`` (the
    fetch to the host) and ``restart.save`` (the files), with the hour of
    the loop's call, ``restart.wait`` (:meth:`flush`'s wait) and the
    fetch's bytes."""

    def __init__(self, outfile: str, ndt_per_restart: int, num_timesteps: int,
                 dto: float, start_days: float,
                 netcdf_grid: Optional[Tuple[int, int]] = None,
                 layout=None, async_write: bool = True, timers=None):
        self.outfile = outfile
        self.cadence = ndt_per_restart
        self.last = num_timesteps
        self.dto = dto
        self.start = start_days
        self.netcdf_grid = netcdf_grid
        self.layout = layout
        self.written = []
        self.timers = NO_TIMERS if timers is None else timers
        self._writer = (ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="restart-writer")
                        if async_write else None)
        self._pending = []

    def due(self, nt: int) -> bool:
        return bool(self.cadence and nt % self.cadence == 0) or nt == self.last

    def _write(self, nt, st, prm, frc, hour=None):
        timers = self.timers
        with timers.span("restart.d2h", hour):
            st, prm, frc = (tree_map(lambda a: a.cpu(), x)
                            for x in (st, prm, frc))
        timers.count("restart.d2h_bytes", sum(
            getattr(x, n).nbytes for x in (st, prm, frc)
            for n in x.__dataclass_fields__))
        with timers.span("restart.save", hour, device=False):
            t = self.start + (nt - 1) * self.dto / 86400.0
            p = save_restart(self.outfile, st, prm, frc, nt, t, self.dto)
            self.written.append(p)
            if self.netcdf_grid is not None:
                nx, ny = self.netcdf_grid
                valid = t + self.dto / 86400.0
                pn = export_reference_restart(
                    f"{self.outfile}_{valid:012.5f}.nc", st, prm,
                    nx, ny, t, self.dto)
                self.written.append(pn)
        return p

    def maybe_write(self, nt: int, st, prm, frc):
        if not self.due(nt):
            return
        if self.layout is not None and self.layout.world > 1:
            st, prm, frc = (self.layout.gather_tree(t, dst=0)
                            for t in (st, prm, frc))
            if self.layout.rank != 0:
                return
        if self._writer is None:
            return self._write(nt, st, prm, frc, self.timers.hour)
        # fail fast: surface an already-failed detached write now
        still = []
        for fut in self._pending:
            if fut.done():
                fut.result()
            else:
                still.append(fut)
        self._pending = still + [
            self._writer.submit(self._write, nt, st, prm, frc,
                                self.timers.hour)]
        return None

    def flush(self):
        """Wait for queued restart writes; returns the paths written."""
        with self.timers.span("restart.wait", device=False):
            for fut in self._pending:
                fut.result()
        self._pending = []
        return self.written
