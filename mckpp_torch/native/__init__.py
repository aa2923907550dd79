"""The C++ NetCDF encoder (``ncwriter.cc``) and its ctypes bindings
(counterpart of ``mckpp_tpu/native/__init__.py``).

``ncwriter.cc`` is this package's own copy of the JAX package's encoder:
it streams host arrays through a 1 MiB byte-swap buffer into a CDF-2
file (64-bit offsets), so a window of diagnostics is encoded at memory
speed without the byteswapped copy scipy's writer makes.  It is built
with ``g++ -O3 -std=c++17 -shared -fPIC`` on first use into
``mckpp_torch/_build/``, under a name that carries the hash of the source
and flags, so a stale library is never loaded; importing this module
builds nothing.

Unlike the JAX package, a failed build raises with the compiler's
output: nothing falls back to scipy silently.  ``MCKPP_NO_NATIVE=1`` is
the one switch that chooses scipy's writer (``io/ncio.py``), which also
takes the payloads this encoder cannot express (:func:`expressible`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils.files import tmp_name

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ncwriter.cc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """False when ``MCKPP_NO_NATIVE`` is set (to anything but 0)."""
    return os.environ.get("MCKPP_NO_NATIVE", "") in ("", "0")


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libmckpp_ncwriter_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the encoder unless an up-to-date library exists; returns
    its path.  Raises with the compiler's output when the build fails."""
    out = _lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = tmp_name(out)
    try:
        r = subprocess.run([CXX, *CXX_FLAGS, _SRC, "-o", tmp],
                           capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the NetCDF encoder did not build: {CXX}: {e}"
                           ) from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"the NetCDF encoder did not build ({CXX} exit "
                           f"{r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The encoder library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, cp, ci = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
            lib.ncw_create.restype = vp
            lib.ncw_create.argtypes = [cp]
            lib.ncw_def_dim.restype = ci
            lib.ncw_def_dim.argtypes = [vp, cp, ctypes.c_longlong]
            lib.ncw_att_text.argtypes = [vp, cp, cp]
            lib.ncw_att_double.argtypes = [vp, cp, ctypes.c_double]
            for fn in (lib.ncw_def_var_f64, lib.ncw_def_var_f32):
                fn.restype = ci
                fn.argtypes = [vp, cp, ci, ctypes.POINTER(ci), vp]
            lib.ncw_var_att_text.argtypes = [vp, ci, cp, cp]
            lib.ncw_var_att_double.argtypes = [vp, ci, cp, ctypes.c_double]
            lib.ncw_close.restype = ctypes.c_longlong
            lib.ncw_close.argtypes = [vp]
            _lib = lib
        return _lib


def scalar_attr(val) -> bool:
    """Whether an attribute is one the encoder holds: text or one number
    (which it stores as NC_DOUBLE)."""
    if isinstance(val, (str, bytes, int, float, np.number)):
        return True
    return isinstance(val, np.ndarray) and val.size == 1 \
        and val.dtype.kind in "biuf"


def expressible(dims: dict, coords: dict, fields: dict,
                attrs: Optional[dict] = None,
                var_attrs: Optional[dict] = None) -> bool:
    """Whether the encoder's subset holds the payload: fixed-size
    dimensions only (no unlimited record dimension), text or scalar
    numeric attributes (no array-valued one), numeric data on declared
    dimensions."""
    if any(size is None for size in dims.values()):
        return False
    all_attrs = list((attrs or {}).values())
    for va in (var_attrs or {}).values():
        all_attrs += list((va or {}).values())
    if not all(scalar_attr(v) for v in all_attrs):
        return False
    shapes = [((dim,), vals) for dim, vals in coords.values()]
    shapes += list(fields.values())
    return all(all(d in dims for d in fdims)
               and np.asarray(arr).dtype.kind in "biuf"
               for fdims, arr in shapes)


def write_fields_native(path: str, dims: dict, coords: dict, fields: dict,
                        attrs: Optional[dict] = None,
                        var_attrs: Optional[dict] = None) -> None:
    """Encode a ``write_fields``-shaped payload (one that
    :func:`expressible` accepts) with the C++ encoder; raises OSError when
    the file cannot be written."""
    lib = get_lib()
    h = lib.ncw_create(path.encode())
    dim_ids = {}
    keep = []                 # the arrays stay alive until ncw_close
    ok = True

    def att_args(val):
        if isinstance(val, (bytes, str)):
            return True, val if isinstance(val, bytes) else val.encode()
        return False, float(np.asarray(val).reshape(-1)[0])

    try:
        for name, size in dims.items():
            dim_ids[name] = lib.ncw_def_dim(h, name.encode(), int(size))
            ok &= dim_ids[name] >= 0
        for k, val in (attrs or {}).items():
            text, v = att_args(val)
            (lib.ncw_att_text if text else lib.ncw_att_double)(
                h, k.encode(), v)

        def def_var(name, fdims, arr):
            # float32 payloads (the diagnostic windows) encode as NC_FLOAT,
            # everything else as NC_DOUBLE
            f32 = getattr(arr, "dtype", None) == np.float32
            a = np.ascontiguousarray(arr, dtype="<f4" if f32 else "<f8")
            keep.append(a)
            ids = (ctypes.c_int * len(fdims))(*[dim_ids[d] for d in fdims])
            defv = lib.ncw_def_var_f32 if f32 else lib.ncw_def_var_f64
            vid = defv(h, name.encode(), len(fdims), ids,
                       a.ctypes.data_as(ctypes.c_void_p))
            for k, val in ((var_attrs or {}).get(name) or {}).items():
                text, v = att_args(val)
                (lib.ncw_var_att_text if text else lib.ncw_var_att_double)(
                    h, vid, k.encode(), v)
            return vid >= 0

        for name, (dim, vals) in coords.items():
            ok &= def_var(name, (dim,), vals)
        for name, (fdims, arr) in fields.items():
            ok &= def_var(name, fdims, arr)
    finally:
        nbytes = lib.ncw_close(h)
    if not ok or nbytes <= 0:
        raise OSError(f"the NetCDF encoder could not write {path}")
