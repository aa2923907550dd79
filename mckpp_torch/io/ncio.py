"""NetCDF read/write wrapper (the reference's mckpp_netcdf_read.F90 layer;
counterpart of ``mckpp_tpu/io/ncio.py``).  Files are written by the C++
encoder of ``mckpp_torch/native`` unless ``MCKPP_NO_NATIVE=1`` chooses
scipy's ``netcdf_file`` or the payload is one the encoder cannot express
(an unlimited record dimension, an array-valued attribute); ``WRITES``
counts the files each writer wrote.

Reading is hyperslab-first, like the reference
(mckpp_netcdf_read.F90:120-432): :func:`get_var` takes an ``index`` applied
*before* materialization, so reading one record of a large climatology
touches O(record) bytes, not the whole variable.  Two backends, chosen by
file magic:

* NetCDF3 ("CDF\\x01/\\x02"): scipy's reader, opened with ``mmap=True`` so
  variable data is a lazy memory map (slices copy out only what they touch);
* netCDF4/HDF5 ("\\x89HDF"): h5py (netCDF4 files ARE HDF5 files) — the
  format real MC-KPP inputs use (reference README.md:14).

Semantics preserved from the reference:

* :func:`determine_boundaries` locates the (lon, lat) start offsets of the
  model domain inside a larger ancillary grid, aborting unless a match is
  found within 1e-3 degrees (mckpp_netcdf_read.F90:68-118);
* every failure raises with file/variable context (the reference's
  ``check()`` + abort, :421-432).

``READ_BYTES`` counts the bytes materialized by :func:`get_var`, so a
caller can check that a record read stays O(record).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
from scipy.io import netcdf_file

from .. import native

# files written by each writer in this process (the writer threads of the
# diagnostics and restarts add to it; callers read differences)
WRITES = {"native": 0, "scipy": 0}
_writes_lock = threading.Lock()
READ_BYTES = 0          # bytes materialized by get_var since process start
_reads_lock = threading.Lock()


class NetCDFError(RuntimeError):
    pass


class _H5File:
    """Minimal netCDF4/HDF5 read adapter: duck-types the subset of
    scipy's netcdf_file interface this module's helpers use (``variables``
    mapping of lazily sliceable arrays)."""

    def __init__(self, path: str):
        import h5py
        self._f = h5py.File(path, "r")
        self.variables = {}
        depth = {}

        def visit(name, obj):
            # flat name map; on collision the SHALLOWEST dataset wins
            # (netCDF4 classic-model files — what MC-KPP inputs are — keep
            # all variables at the root; group-nested duplicates must not
            # shadow them).  Dimension-scale coordinate variables are
            # plain datasets here, which is exactly how the helpers use
            # them (get_coord reads values, not scale attachments).
            if isinstance(obj, h5py.Dataset):
                key = name.rsplit("/", 1)[-1]
                d = name.count("/")
                if key not in self.variables or d < depth[key]:
                    self.variables[key] = obj
                    depth[key] = d
        self._f.visititems(visit)

    def close(self):
        self._f.close()


def _is_hdf5(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"\x89HDF"


@contextlib.contextmanager
def open_nc(path: str, mode: str = "r"):
    try:
        if mode == "r" and _is_hdf5(path):
            f = _H5File(path)
        else:
            # mmap for reads: variable data stays a lazy memory map, so
            # hyperslab access copies out only the touched bytes.  All
            # helpers below copy before the file closes.
            f = netcdf_file(path, mode, mmap=(mode == "r"))
    except OSError as e:
        raise NetCDFError(f"cannot open {path}: {e}") from e
    try:
        yield f
    finally:
        f.close()


def get_coord(nc, name: str):
    """Coordinate variable values + length."""
    if name not in nc.variables:
        raise NetCDFError(f"coordinate {name} not found")
    v = np.asarray(nc.variables[name][:], dtype=np.float64).copy()
    return v, len(v)


def get_var(nc, name: str, start: Optional[Sequence[int]] = None,
            count: Optional[Sequence[int]] = None,
            index=None) -> np.ndarray:
    """Read a variable or a hyperslab of it.

    ``index`` (a tuple of ints/slices) is applied BEFORE materialization —
    the reference's start/count hyperslab read
    (mckpp_netcdf_read.F90:120-432).  ``start``/``count`` are the older
    0-based offset form and materialize lazily too.
    """
    global READ_BYTES
    if name not in nc.variables:
        raise NetCDFError(f"variable {name} not found")
    v = nc.variables[name]
    if index is not None:
        data = v[index]
    elif start is not None:
        sl = tuple(slice(s, (s + c) if count is not None else None)
                   for s, c in zip(start, count or [None] * len(start)))
        data = v[sl]
    else:
        data = v[:]
    out = np.asarray(data, dtype=np.float64)
    out = out.copy() if not out.flags.owndata else out
    with _reads_lock:       # the prefetch threads read too
        READ_BYTES += out.nbytes
    return out


def determine_boundaries(nc, lon0: float, lat0: float,
                         lon_name: str = "longitude",
                         lat_name: str = "latitude"):
    """Find 0-based (offset_lon, offset_lat) of the model origin in the
    file's coordinate axes; abort if no match within 1e-3 degrees
    (reference: mckpp_netcdf_determine_boundaries)."""
    lons, _ = get_coord(nc, lon_name)
    lats, _ = get_coord(nc, lat_name)
    ilon = np.argmin(np.abs(lons - lon0))
    ilat = np.argmin(np.abs(lats - lat0))
    if abs(lons[ilon] - lon0) > 1e-3:
        raise NetCDFError(
            f"model origin longitude {lon0} not found (closest {lons[ilon]})")
    if abs(lats[ilat] - lat0) > 1e-3:
        raise NetCDFError(
            f"model origin latitude {lat0} not found (closest {lats[ilat]})")
    return int(ilon), int(ilat)


def get_time_axis(nc, names=("time", "t")) -> np.ndarray:
    for n in names:
        if n in nc.variables:
            return np.asarray(nc.variables[n][:], dtype=np.float64).copy()
    raise NetCDFError("no time axis found")


def write_fields(path: str, dims: dict, coords: dict, fields: dict,
                 attrs: Optional[dict] = None,
                 var_attrs: Optional[dict] = None):
    """Write a NetCDF3 file: dims {name: size or None (unlimited)},
    coords {name: (dimname, values)}, fields {name: (dims-tuple, array)},
    var_attrs {varname: {attname: str|float}} per-variable attributes
    (e.g. time units/calendar, the XIOS calendar metadata analog of
    mckpp_xios_io.F90:40-46).  Both writers write CDF-2 (64-bit offsets):
    a full-width day of diagnostics passes 2 GiB."""
    if native.enabled() and native.expressible(dims, coords, fields, attrs,
                                               var_attrs):
        native.write_fields_native(path, dims, coords, fields, attrs,
                                   var_attrs)
        writer = "native"
    else:
        _write_scipy(path, dims, coords, fields, attrs, var_attrs)
        writer = "scipy"
    with _writes_lock:
        WRITES[writer] += 1


def _write_scipy(path, dims, coords, fields, attrs, var_attrs):
    """The native encoder's types, so that ``MCKPP_NO_NATIVE=1`` changes
    the encoder and not the file: a float32 variable (coordinate or field)
    is NC_FLOAT and every other one NC_DOUBLE; a scalar numeric attribute
    is NC_DOUBLE (scipy would store an int as NC_INT and a Python float as
    NC_FLOAT); text stays text and an array-valued attribute keeps its
    type."""
    def att(val):
        if isinstance(val, str):
            return val.encode()
        if native.scalar_attr(val) and not isinstance(val, bytes):
            return np.float64(np.asarray(val).reshape(-1)[0])
        return val

    with netcdf_file(path, "w", mmap=False, version=2) as nc:
        def put(name, fdims, arr):
            f32 = getattr(arr, "dtype", None) == np.float32
            v = nc.createVariable(name, "f" if f32 else "d", tuple(fdims))
            v[:] = np.asarray(arr, dtype=np.float32 if f32 else np.float64)
            for k, val in ((var_attrs or {}).get(name) or {}).items():
                setattr(v, k, att(val))

        for name, size in dims.items():
            nc.createDimension(name, size)
        for name, (dim, vals) in coords.items():
            put(name, (dim,), vals)
        for name, (fdims, arr) in fields.items():
            put(name, fdims, arr)
        if attrs:
            for k, val in attrs.items():
                setattr(nc, k, att(val))
