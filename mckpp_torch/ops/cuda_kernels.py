"""Launch wrappers for the CUDA kernels of the fused ocean pass and step.

Kernels (``mckpp_torch/csrc/fused_kernels.cu``, device code in
``csrc/fused_pass.cuh`` and ``csrc/physics.cuh``):

* ``fused_pass_fast`` replaces the Pallas kernel of
  ``mckpp_tpu/ops/fused_pass.py`` ``make_fused_pass(full=False)``
  (``pallas_call`` at fused_pass.py:1031);
* ``fused_pass_full`` replaces ``make_fused_pass(full=True)`` (the same
  ``pallas_call``, with the diagnostic outputs);
* ``fused_step`` replaces ``make_fused_step`` (``pallas_call`` at
  fused_pass.py:1149).

What bounds them on the H100: at nz=69 a pass moves ~6.4 KB per column
(14 profiles in, 8 out; ~10.4 KB for the full pass) against ~49,600
floating-point operations (the EOS polynomials at every level, four PCR
solves of log2(nz) stages on two distinct matrices, the reference
averages over ``aref``'s nonzeros; :func:`pass_ops`), so one pass is
bound by bytes on paper; the
step kernel runs ~6 passes per active column on data that stays on chip
and is bound by operations.  The design (``csrc/fused_pass.cuh``): one
warp per column with its levels on the lanes, so the live profiles sit in
registers and a small per-warp shared-memory area instead of per-thread
local memory; each warp runs its own column's convergence and trap loops,
so no warp waits for a slower column and a land column's warp skips them;
a block of ``WARPS`` warps takes that many consecutive columns and stages
their inputs and outputs through shared memory, so global traffic moves
whole 32-byte sectors; the reference averages run over each ``aref`` row's
nonzero prefix (:func:`row_extents`, computed once per ``aref`` tensor).
:func:`launch_geometry` computes the launch geometry the C side is given,
with the number of level slots a lane carries: each kernel is a template
on it, built for ``SLOTS`` = 3 (``nz + 2 <= 96``) and 4 (``<= 128``), and
a launch takes the smaller that covers its levels.  The transposed
``aref`` sits in shared memory beside the warps' areas.

Past 128 levels (``nz + 2 <= PAIR_WZ`` = 256) a column spreads over a
pair of warps (``PW_CW``) of 3 (``nz + 2 <= 192``) or 4 slots a lane, the
libraries ``PAIRS`` ("pw3", "pw4"), ``PW_COLS`` columns a block (8 in
float32, 4 in float64): the column's rows in shared memory are shared by
its two warps, which meet at a barrier of their own (a named barrier per
column), so a thread holds 3 or 4 slots where one warp a column would
hold 6 or 8, and an SM holds more warps; ``aref`` is read from a tile in
device memory (:func:`_ref_tile`).

Past 256 levels (``nz + 2 <= ONE_BLOCK_WZ`` = 1024) one column spreads
over the ``cw`` = ceil((nz + 2) / 128) warps of one block, each with
``MW_NS`` = 4 slots a lane (the library ``MW``, "cw", one per dtype): the
column's rows in shared memory are shared by its warps, which meet at
block barriers wherever levels exchange; ``aref`` is always read from
device memory, and the grid rows too where the column leaves no room
(float64 at ``cw`` = 8, :func:`_grid_tile`).

Past 1024 levels (``nz + 2 <= MAXWZ`` = 8192) one column spreads over a
thread-block cluster of ``cb`` = ceil((nz + 2) / 1024) blocks, each of
``cw`` = ceil((nz + 2) / (128 cb)) warps of 4 slots holding its own
slice of the column's rows (the library ``CL``, "cl", one per dtype):
where levels meet, the blocks read each other's slices through
distributed shared memory between cluster barriers; ``aref`` and the grid
rows are always read from device memory.  A geometry of which the card
cannot hold one cluster raises; nothing falls back.

Both layouts of the JAX package (``kw["zaxis"]``, ``pass_layout``): 0
("col_lanes"), profiles ``(nz + 2, ncol)``, and 1 ("z_lanes"), profiles
``(ncol, nz + 2)`` as the state holds them.  Each has its own build of
every library (``-DKPP_ZL``): only the staging between device and shared
memory differs (``csrc/fused_pass.cuh``), so the bytes, the operations
and the bounds are the same; the z_lanes ``aref`` reaches the kernels
transposed into the col_lanes form, once per tensor (:func:`_kernel_aref`).
:func:`_check` takes the layout from the wrapper, never from a shape, and
raises on arrays of the other layout.

A wrapper called with CPU tensors runs the plain torch body
(``ops/fused_pass.py``); with CUDA tensors it launches its kernel or
raises.  The kernels are built by ``nvcc`` from the sources in ``csrc/``
on first use, into ``mckpp_torch/_build/``: one library for each dtype,
layout and number of level slots, and one for each dtype and layout of
the pair kernels at 3 and 4 slots, of the multi-warp and of the cluster
kernels (``LIBS``).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import weakref

import numpy as np
import torch

from .. import constants as c
from ..utils.files import tmp_name
from . import fused_pass as fp

# launches of each kernel since the last reset_counts(); a wrapper adds
# one where it launches its kernel and nowhere else
LAUNCHES = {"fused_pass_fast": 0, "fused_pass_full": 0, "fused_step": 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_SOURCES = ("fused_kernels.cu", "fused_pass.cuh", "physics.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
_REALS = {torch.float32: "float", torch.float64: "double"}
_libs: dict = {}
_lock = threading.Lock()

# launch geometry (the constants of csrc/fused_pass.cuh and fused_kernels.cu)
WARPS = 8              # warps per block at most (MAX_WARPS): columns of
                       # one warp each, or the warps of one column (CW_MAX)
SLOTS = (3, 4)         # level slots per lane of the one-warp kernels (NS)
PW_CW = 2              # the warps of a column over a pair of warps
PAIRS = ("pw3", "pw4")  # ... its libraries, 3 and 4 slots a lane
# ... its columns a block, by element size: one block an SM, as many warps
# as the kernels' registers let it hold (float32: 128 a thread, 16 warps;
# float64: 255, 8 warps)
PW_COLS = {4: 8, 8: 4}
MW = "cw"              # the library of a column over several warps
MW_NS = 4              # ... its level slots a lane: 128 levels a warp
CL = "cl"              # the library of a column over a cluster of blocks
CB_MAX = 8             # ... its blocks at most (the portable cluster size)
LIBS = SLOTS + PAIRS + (MW, CL)   # the libraries of one dtype and layout
ONE_WARP_WZ = 32 * SLOTS[-1]      # the most levels one warp takes (128)
PAIR_WZ = 32 * PW_CW * 4          # ... a pair of warps takes (256)
ONE_BLOCK_WZ = 32 * MW_NS * WARPS  # ... one block takes (1024)
MAXWZ = ONE_BLOCK_WZ * CB_MAX     # the most levels (nz + 2) a kernel takes
N_SLOTS = 23           # per-column profile rows (NB)
N_SLOTS_MW = N_SLOTS + 1  # ... of a column over warps or a cluster (NB_MW)
N_COLV = 48            # per-column values: colscal rows + 16 outputs
N_BC = 43              # MW: broadcast cells after the column values (NBC)
N_BC_CL = N_BC + 2     # CL: and a block's column AND and count (NBC_CL)
NO_CLUSTER = -2        # the launcher's code for a cluster the card cannot
                       # hold (KPP_NO_CLUSTER)
SMEM_MAX = 232_448     # dynamic shared memory one block may use (H100)


def reset_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _lib_tag(lib, zaxis=0) -> str:
    """"ns3", "ns4", "pw3", "pw4", "cw" or "cl", then "_zl" for the
    z_lanes build."""
    tag = lib if isinstance(lib, str) else f"ns{lib}"
    return tag + ("_zl" if zaxis else "")


def _lib_path(dtype, lib, phases=False, zaxis=0) -> str:
    tag = "_phases" if phases else ""
    return os.path.join(_BUILD, f"libkpp_{_REALS[dtype]}_"
                                f"{_lib_tag(lib, zaxis)}{tag}_"
                                f"{_source_hash()}.so")


def build(dtypes=(torch.float32, torch.float64), phases=False,
          slots=LIBS, zaxes=(0,), nice=0) -> dict:
    """Compile the kernels for ``dtypes``, the libraries ``slots`` (level
    slots of the one-warp kernels, or one of ``PAIRS``, ``MW`` or ``CL``)
    and the layouts
    ``zaxes`` (0 col_lanes, the default, or 1 z_lanes; one nvcc process
    per library, all run together) unless an up-to-date library exists.
    Returns {(dtype, lib, zaxis): ptxas report} for the libraries built
    by this call.  ``phases`` builds the library with the stage clocks of
    ``csrc/fused_pass.cuh`` on (``-DKPP_PHASES``, for chip_phases.py)
    under its own name; the port itself always loads the one without.
    The pair, multi-warp and cluster libraries, whose ptxas work is the
    longest, start first; ``nice`` raises the nvcc processes' niceness (a build
    that runs beside other work).  Several processes (the ranks of a
    distributed run) may build into one directory at once."""
    os.makedirs(_BUILD, exist_ok=True)
    procs = {}
    jobs = [(dt, ns, zaxis) for dt in dtypes for zaxis in zaxes
            for ns in slots]
    nice_cmd = shutil.which("nice") if nice else None
    for dt, ns, zaxis in sorted(jobs, key=lambda j: isinstance(j[1], int)):
        out = _lib_path(dt, ns, phases, zaxis)
        if os.path.exists(out):
            continue
        tmp = tmp_name(out)
        spread = {MW: 1, CL: 2}.get(ns)
        lib_flags = ([f"-DKPP_NS={MW_NS}", f"-DKPP_MW={spread}"]
                     if spread else [f"-DKPP_NS={ns[2:]}", "-DKPP_MW=3"]
                     if ns in PAIRS else [f"-DKPP_NS={ns}"])
        cmd = [*([nice_cmd, "-n", str(nice)] if nice_cmd else []), _nvcc(),
               *NVCC_FLAGS, f"-DKPP_REAL={_REALS[dt]}", *lib_flags,
               f"-DKPP_ZL={zaxis}", *(["-DKPP_PHASES"] if phases else []),
               "-o", tmp, os.path.join(_CSRC, "fused_kernels.cu")]
        procs[dt, ns, zaxis] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for key, (out, tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"nvcc failed for {_REALS[key[0]]}, "
                          f"{_lib_tag(key[1], key[2])}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[key] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def _lib(dtype, ns, zaxis=0):
    with _lock:
        lib = _libs.get((dtype, ns, zaxis))
        if lib is None:
            lib = load(dtype, ns, zaxis=zaxis)
            _libs[dtype, ns, zaxis] = lib
        return lib


def preload(nz: int, dtype, zaxis=0) -> None:
    """Load (build where missing) the library whose kernels run ``nz``
    levels in ``dtype`` and layout ``zaxis``, ahead of their first
    launch."""
    _lib(dtype, launch_geometry(nz, dtype, 1).lib, zaxis)


def load(dtype, ns, phases=False, zaxis=0):
    """The kernel library for ``dtype`` at ``ns`` level slots (or one of
    ``PAIRS``, ``MW`` or ``CL``) in layout ``zaxis``, built if missing
    (``phases``: see :func:`build`)."""
    path = _lib_path(dtype, ns, phases, zaxis)
    if not os.path.exists(path):
        build((dtype,), phases, slots=(ns,), zaxes=(zaxis,))
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kpp_fused_pass.argtypes = [ci, vp, vp, vp, vp, vp]
    lib.kpp_fused_pass.restype = ci
    lib.kpp_fused_step.argtypes = [vp, vp, vp, vp, vp]
    lib.kpp_fused_step.restype = ci
    lib.kpp_real_bytes.restype = ci
    lib.kpp_max_wz.restype = ci
    lib.kpp_zaxis.restype = ci
    if ns == CL:
        lib.kpp_max_clusters.argtypes = [ci, vp]
        lib.kpp_max_clusters.restype = ci
    if phases:
        lib.kpp_phase_read.argtypes = [vp]
        lib.kpp_phase_read.restype = ci
        lib.kpp_phase_zero.restype = ci
    if lib.kpp_real_bytes() != torch.empty((), dtype=dtype).element_size():
        raise RuntimeError(f"{path} was built for another dtype")
    want = {MW: ONE_BLOCK_WZ, CL: MAXWZ}.get(ns) or (
        32 * PW_CW * int(ns[2:]) if ns in PAIRS else 32 * ns)
    if lib.kpp_max_wz() != want:
        raise RuntimeError(f"{path}: {lib.kpp_max_wz()} levels, expected "
                           f"{want}")
    if lib.kpp_zaxis() != zaxis:
        raise RuntimeError(f"{path} was built for zaxis={lib.kpp_zaxis()}")
    return lib


class PassParams(ctypes.Structure):
    """Field for field the C struct kpp::PassParams (csrc/fused_pass.cuh)."""
    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "nz", "wz", "ncol", "lri", "ldd", "lkpp", "l_relax_sst",
            "l_relax_calconly", "l_fcorr", "l_fcorr_withz", "l_sfcorr_withz",
            "l_relax_sal", "l_relax_ocnt", "l_advect", "wscale_analytic",
            "adv_n1_4", "itermax", "extra_iters", "comp_iter_max")]
        + [(n, ctypes.c_double) for n in (
            "grav", "vonk", "sice", "dto", "zbot", "vtc", "cg", "adv_hm1",
            "adv_inv_delta3", "adv_delta4", "adv_hm_nz", "hmixtolfrac",
            "hm_bot", "dm_nz")]
        + [("rmsd_thr", ctypes.c_double * 4)])


def _params(kw: dict, ncol: int) -> PassParams:
    flags: fp.PassFlags = kw["flags"]
    if flags.wscale not in ("nodal", "analytic"):
        raise NotImplementedError(
            f"wscale={flags.wscale!r} has no CUDA kernel; the resident "
            "table runs on the reference step (pass_impl='reference')")
    nz = kw["nz"]
    p = PassParams()
    p.nz, p.wz, p.ncol = nz, nz + 2, ncol
    for name in ("lri", "ldd", "lkpp", "l_relax_sst", "l_relax_calconly",
                 "l_fcorr", "l_fcorr_withz", "l_sfcorr_withz", "l_relax_sal",
                 "l_relax_ocnt", "l_advect"):
        setattr(p, name, int(getattr(flags, name)))
    p.wscale_analytic = int(flags.wscale == "analytic")
    p.grav, p.vonk, p.sice = flags.grav, flags.vonk, flags.sice
    p.dto, p.zbot = kw["dto"], kw["zbot"]
    # the same Python-float constants the plain body folds
    p.vtc = (c.CV * math.sqrt(0.2 / c.CS / c.EPSILON_KPP)
             / flags.vonk ** 2 / c.RICR)
    p.cg = (c.CSTAR * flags.vonk
            * (c.CS * flags.vonk * c.EPSILON_KPP) ** (1.0 / 3.0))
    adv = kw.get("adv_st")
    if adv is not None:
        p.adv_hm1, p.adv_inv_delta3 = adv["hm1"], adv["inv_delta3"]
        p.adv_n1_4, p.adv_delta4 = adv["n1_4"], adv["delta4"]
        p.adv_hm_nz = adv["hm_nz"]
    if "itermax" in kw:
        p.itermax, p.extra_iters = kw["itermax"], kw["extra_iters"]
        p.comp_iter_max = kw["comp_iter_max"]
        p.hmixtolfrac, p.hm_bot, p.dm_nz = (kw["hmixtolfrac"], kw["hm_bot"],
                                            kw["dm_nz"])
        for i, x in enumerate(kw["rmsd_thr"]):
            p.rmsd_thr[i] = x
    return p


def _check(arrays, kw, n_prof):
    """Device, dtype, shape and contiguity of the inputs; returns
    (ncol, dtype).  ``n_prof`` leading arrays are profiles, (WZ, ncol)
    with ``kw["zaxis"]`` 0 and (ncol, WZ) with 1: the layout is the
    wrapper's, never inferred from a shape (ncol may equal WZ), and the
    grid rows, (WZ, 1) or (1, WZ), tell the layouts apart at any ncol."""
    nz = kw["nz"]
    wz = nz + 2
    zaxis = kw.get("zaxis", 0)
    if zaxis not in (0, 1):
        raise ValueError(f"zaxis={zaxis!r}: 0 or 1")
    # the shape of a (rows x columns) array in this layout
    shape = (lambda rows, n: (n, rows)) if zaxis else (lambda rows, n:
                                                       (rows, n))
    u = arrays[0]
    dtype, dev = u.dtype, u.device
    if dtype not in _REALS:
        raise TypeError(f"fused kernels take float32 or float64, not {dtype}")
    if u.dim() != 2 or u.shape[zaxis] != wz:
        raise ValueError(f"zaxis={zaxis}: profiles must be "
                         f"{shape(f'nz+2={wz}', 'ncol')}, got "
                         f"{tuple(u.shape)}")
    ncol = u.shape[1 - zaxis]
    for i, a in enumerate(arrays):
        if a.device != dev or a.dtype != dtype:
            raise TypeError(f"input {i}: {a.device}/{a.dtype}, expected "
                            f"{dev}/{dtype}")
        if not a.is_contiguous():
            raise ValueError(f"input {i} is not contiguous")
    flags = kw["flags"]
    sw = n_prof              # index of swdk; then swfrac, the 4 forcing
    on = [True, True, flags.l_relax_ocnt, flags.l_relax_sal,
          flags.l_fcorr_withz, flags.l_sfcorr_withz]
    # forcing profiles are profiles when their flag is on, else dummies
    # (one grid row's shape, or a whole profile's)
    for i in list(range(n_prof)) + [sw + j for j in range(6)]:
        ok = [shape(wz, ncol)] + ([] if i < sw or on[i - sw]
                                  else [shape(wz, 1)])
        if tuple(arrays[i].shape) not in ok:
            raise ValueError(f"zaxis={zaxis}: input {i} has shape "
                             f"{tuple(arrays[i].shape)}, expected "
                             f"{' or '.join(map(str, ok))}")
    if tuple(arrays[sw + 6].shape) != shape(fp.NSC, ncol):
        raise ValueError(f"zaxis={zaxis}: colscal must be "
                         f"{shape(fp.NSC, ncol)}")
    for i in range(sw + 7, sw + 12):
        if tuple(arrays[i].shape) != shape(wz, 1):
            raise ValueError(f"zaxis={zaxis}: grid row {i} must be "
                             f"{shape(wz, 1)}")
    if tuple(arrays[sw + 12].shape) != (wz, wz):
        raise ValueError(f"aref must be ({wz}, {wz})")
    return ncol, dtype


class Geometry(ctypes.Structure):
    """Field for field the C struct kpp::Geometry (csrc/fused_pass.cuh);
    ``aref_dev`` is 1 where the kernels read aref from device memory,
    ``cw`` the warps of one column in a block (1; 2 for the ``PAIRS``
    libraries, whose block is ``warps / 2`` columns; 3..8 for the ``MW``
    library, whose block is one column; or 1..8 for the ``CL`` library),
    ``grid_dev`` 1 where the ``MW`` or ``CL`` kernels read the grid rows
    from device memory and ``cb`` the blocks of a column's cluster (1, or
    2..8 for the ``CL`` library)."""
    _fields_ = [("warps", ctypes.c_int), ("blocks", ctypes.c_int),
                ("kref", ctypes.c_int), ("smem", ctypes.c_int),
                ("ns", ctypes.c_int), ("aref_dev", ctypes.c_int),
                ("cw", ctypes.c_int), ("grid_dev", ctypes.c_int),
                ("cb", ctypes.c_int)]

    @property
    def cols_per_block(self) -> int:
        return self.warps // self.cw

    @property
    def lib(self):
        """The library whose kernels take this geometry."""
        return (CL if self.cb > 1 else MW if self.cw > PW_CW
                else f"pw{self.ns}" if self.cw == PW_CW else self.ns)

    @property
    def levels(self) -> int:
        """The levels of a column's rows (LZ; in a cluster, its blocks'
        slices together)."""
        return 32 * self.ns * self.cw * self.cb


def _warp_stride(ns: int) -> int:
    """Elements of one warp's shared-memory area at ``ns`` level slots,
    padded to 4 (mod 32) (csrc/fused_pass.cuh warp_stride)."""
    pw = N_SLOTS * 32 * ns + N_COLV
    return pw + (4 - pw % 32) % 32


def smem_bytes(ns: int, kref: int, warps: int, esize: int) -> int:
    """Dynamic shared memory of one block (csrc/fused_pass.cuh
    smem_bytes): the grid rows, aref's ``kref`` kept columns (0 where aref
    is read from device memory), the warps' areas and the row extents, at
    ``32 * ns`` levels a row."""
    lz = 32 * ns
    return ((6 + kref) * lz + warps * _warp_stride(ns)) * esize + lz * 4


def smem_bytes_mw(cw: int, grid_dev: int, esize: int) -> int:
    """Dynamic shared memory of one block of the ``MW`` kernels, one
    column over ``cw`` warps (csrc/fused_pass.cuh smem_bytes_mw): the grid
    rows (none where they are read from device memory), the column's
    rows, values and broadcast cells, and the row extents, at ``128 * cw``
    levels a row; aref is read from device memory."""
    lz = 32 * MW_NS * cw
    ng = 0 if grid_dev else 6
    return (ng * lz + N_SLOTS_MW * lz + N_COLV + N_BC) * esize + lz * 4


def smem_bytes_cl(cw: int, esize: int) -> int:
    """Dynamic shared memory of one block of the ``CL`` kernels, ``cw``
    warps of a column over a cluster (csrc/fused_pass.cuh smem_bytes_cl):
    the block's slice of the column's rows, the column values and
    broadcast cells, and its levels' row extents, at ``128 * cw`` levels;
    aref and the grid rows are read from device memory."""
    lb = 32 * MW_NS * cw
    return (N_SLOTS_MW * lb + N_COLV + N_BC_CL) * esize + lb * 4


def smem_bytes_pw(ns: int, cols: int, esize: int) -> int:
    """Dynamic shared memory of one block of the pair kernels, ``cols``
    columns over a pair of warps of ``ns`` slots each (csrc/fused_pass.cuh
    smem_bytes_pw): the grid rows, the columns' rows, values and broadcast
    cells, and the row extents, at ``64 * ns`` levels a row; aref is read
    from device memory."""
    lz = 32 * PW_CW * ns
    col = N_SLOTS_MW * lz + N_COLV + N_BC
    return (6 * lz + cols * col) * esize + lz * 4


def launch_geometry(nz: int, dtype, ncol: int,
                    kref: int | None = None) -> Geometry:
    """Warps per block, blocks, aref columns the reference averages read,
    dynamic shared-memory bytes, level slots, aref's placement, warps a
    column and the grid rows' placement of one launch at ``nz`` levels
    over ``ncol`` columns.  ``kref`` is the number of ``aref`` columns the
    reference averages read (:func:`row_extents`); the default is the
    worst case, all ``nz + 2``.  Up to 128 levels a column is one warp:
    the level slots are the fewer of ``SLOTS`` that cover ``nz + 2``; a
    block takes ``WARPS`` warps (columns), or half as many until its
    shared memory fits (float64 at 4 slots with a deep aref prefix), aref
    in shared memory.  Up to 256 a column is a pair of warps of 3 or 4
    slots, ``PW_COLS`` columns a block, aref read from device memory
    (``aref_dev``).  Past 256 levels a block is one
    column over ``cw`` = ceil((nz + 2) / 128) warps of ``MW_NS`` slots,
    aref read from device memory, the grid rows too where they leave the
    column no room (``grid_dev``: float64 at 8 warps).  Past 1024 levels a column
    spreads over a cluster of ``cb`` = ceil((nz + 2) / 1024) blocks of
    ``cw`` = ceil((nz + 2) / (128 cb)) warps each, ``ncol * cb`` blocks,
    aref and the grid rows read from device memory (a block holds only its
    own levels of the column's rows)."""
    wz = nz + 2
    if wz > MAXWZ:
        raise ValueError(f"nz+2={wz} exceeds the kernels' limit of "
                         f"{MAXWZ} levels (nz <= {MAXWZ - 2})")
    kref = wz if kref is None else kref
    if not 0 <= kref <= wz:
        raise ValueError(f"kref={kref} outside 0..{wz}")
    esize = torch.empty((), dtype=dtype).element_size()
    if wz > ONE_BLOCK_WZ:
        cb = -(-wz // ONE_BLOCK_WZ)
        cw = -(-wz // (32 * MW_NS * cb))
        return Geometry(warps=cw, blocks=ncol * cb, kref=kref,
                        smem=smem_bytes_cl(cw, esize), ns=MW_NS, aref_dev=1,
                        cw=cw, grid_dev=1, cb=cb)
    if wz > PAIR_WZ:
        cw = -(-wz // (32 * MW_NS))
        for grid_dev in (0, 1):
            smem = smem_bytes_mw(cw, grid_dev, esize)
            if smem <= SMEM_MAX:
                return Geometry(warps=cw, blocks=ncol, kref=kref, smem=smem,
                                ns=MW_NS, aref_dev=1, cw=cw,
                                grid_dev=grid_dev, cb=1)
        raise ValueError(f"{smem} bytes of shared memory exceed {SMEM_MAX}")
    if wz > ONE_WARP_WZ:
        ns = 3 if wz <= 32 * PW_CW * 3 else 4
        cols = PW_COLS[esize]
        return Geometry(warps=PW_CW * cols, blocks=-(-ncol // cols),
                        kref=kref, smem=smem_bytes_pw(ns, cols, esize),
                        ns=ns, aref_dev=1, cw=PW_CW, grid_dev=0, cb=1)
    ns = next(n for n in SLOTS if 32 * n >= wz)
    warps = WARPS
    while warps > 1 and smem_bytes(ns, kref, warps, esize) > SMEM_MAX:
        warps //= 2
    return Geometry(warps=warps, blocks=-(-ncol // warps), kref=kref,
                    smem=smem_bytes(ns, kref, warps, esize), ns=ns,
                    aref_dev=0, cw=1, grid_dev=0, cb=1)


def max_clusters(dtype, geom: Geometry, kernel: str, zaxis=0) -> int:
    """cudaOccupancyMaxActiveClusters of ``kernel`` ("fused_pass_fast",
    "fused_pass_full" or "fused_step") in layout ``zaxis`` at a cluster
    geometry: the clusters the card holds at once."""
    kind = ("fused_pass_fast", "fused_pass_full", "fused_step").index(kernel)
    n = _lib(dtype, CL, zaxis).kpp_max_clusters(kind,
                                                ctypes.addressof(geom))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {-n}")
    return n


def row_extents(aref) -> np.ndarray:
    """Last nonzero column of each row of ``aref`` (-1 for a zero row), as
    int32: the reference averages sum ``aref[n, 0..hi[n]]`` only."""
    a = (aref.detach().cpu().numpy() if isinstance(aref, torch.Tensor)
         else np.asarray(aref))
    cols = np.arange(a.shape[1])
    return np.where(a != 0, cols, -1).max(axis=1).astype(np.int32)


# id(aref) -> [weak reference, its _version, row extents on its device,
# kref, {levels: its device tile}]; the grid is static, so each aref is
# read back to the host once
_extents: dict = {}


def _ref_entry(aref: torch.Tensor) -> list:
    hit = _extents.get(id(aref))
    if hit is not None and hit[0]() is aref and hit[1] == aref._version:
        return hit
    hi = row_extents(aref)
    dev = torch.as_tensor(hi, device=aref.device)
    kref = int(hi.max()) + 1 if hi.size else 0
    if len(_extents) > 64:                   # drop entries of dead tensors
        for key in [k for k, v in _extents.items() if v[0]() is None]:
            del _extents[key]
    entry = [weakref.ref(aref), aref._version, dev, kref, {}]
    _extents[id(aref)] = entry
    return entry


# id(aref) -> [weak reference, its _version, its transpose]: a z_lanes
# aref in the col_lanes form the kernels read, made once per tensor
_kernel_arefs: dict = {}


def _kernel_aref(aref: torch.Tensor, zaxis: int) -> torch.Tensor:
    """The ``aref`` memory the kernels read in either layout: the col_lanes
    one as given, the z_lanes one (``ref_avg(prof) = prof @ aref``)
    transposed into that form, contiguous, once per tensor, so that both
    layouts' kernels see the same memory and sum in the same k order (and
    the caches keyed on it, :func:`_ref_entry`, hit on every launch)."""
    if not zaxis:
        return aref
    hit = _kernel_arefs.get(id(aref))
    if hit is None or hit[0]() is not aref or hit[1] != aref._version:
        if len(_kernel_arefs) > 64:            # drop entries of dead tensors
            for key in [k for k, v in _kernel_arefs.items()
                        if v[0]() is None]:
                del _kernel_arefs[key]
        hit = [weakref.ref(aref), aref._version, aref.t().contiguous()]
        _kernel_arefs[id(aref)] = hit
    return hit[2]


def _ref_extents(aref: torch.Tensor):
    """(row extents on aref's device, kref) of ``aref``, once per tensor."""
    return tuple(_ref_entry(aref)[2:4])


def _ref_tile(aref: torch.Tensor, ns: int, cw: int, cb: int) -> torch.Tensor:
    """``aref`` transposed into a (kref, 32 ns cw cb) tile on its device,
    zero past its ``nz + 2`` columns: ``tile[k, n] = aref[n, k]``, the
    layout of the one-warp kernels' shared copy, read from device memory
    where the column spreads over ``cw`` warps (of ``cb`` blocks)
    (``Geometry.aref_dev``).  Made once per aref tensor and width."""
    entry = _ref_entry(aref)
    lz = 32 * ns * cw * cb
    if lz not in entry[4]:
        kref, wz = entry[3], aref.shape[0]
        tile = aref.new_zeros((kref, lz))
        tile[:, :wz] = aref[:, :kref].t()
        entry[4][lz] = tile
    return entry[4][lz]


# id(hm) -> [weak references to the five grid rows, their _version,
# {(levels, advection): the padded tile}]; the grid is static, so each
# launch reuses its tile (inside a captured CUDA graph too)
_grid_tiles: dict = {}


def _grid_tile(arrays, pfx, l_advect: bool, lz: int) -> torch.Tensor:
    """The grid rows zm, hm, dm, tdn, tup (the (nz + 2, 1) or (1, nz + 2)
    inputs before aref) and the depth prefix, padded to ``lz`` levels as
    the kernels' shared copy pads them (hm with 1, the others with 0, the
    prefix 0 without advection): the ``MW`` kernels read them from device
    memory where their shared memory leaves no room (``Geometry.grid_dev``).
    Made once per set of row tensors (the prefix is a function of hm),
    width and advection flag."""
    rows = arrays[-6:-1]
    hit = _grid_tiles.get(id(rows[1]))
    if hit is None or any(r() is not x for r, x in zip(hit[0], rows)) \
            or hit[1] != [x._version for x in rows]:
        if len(_grid_tiles) > 64:            # drop entries of dead tensors
            for key in [k for k, v in _grid_tiles.items()
                        if v[0][1]() is None]:
                del _grid_tiles[key]
        hit = [[weakref.ref(x) for x in rows], [x._version for x in rows],
               {}]
        _grid_tiles[id(rows[1])] = hit
    key = (lz, bool(l_advect))
    if key not in hit[2]:
        wz = rows[0].numel()
        tile = rows[0].new_zeros((6, lz))
        tile[1] = 1.0
        for i, r in enumerate(rows):
            tile[i, :wz] = r.reshape(-1)
        if l_advect:
            tile[5, :wz] = pfx[:, 0]
        hit[2][key] = tile
    return hit[2][key]


def pass_ops(nz: int, aref, kbl, ldd: bool = False):
    """Floating-point operations of one pass of one column, counted from
    csrc/fused_pass.cuh (each add, mul, div, sqrt, exp, pow is one): per
    level 12 relax + 270 EOS (abk80 ~190, cpsw ~70, rho/buoy) + 11 solar +
    14 shear/dbloc + 30 rimix + 3 x 8 tridcof + 2 x 12 tridrhs + 8 U/V RHS
    + 8 T/S increments; per level and PCR stage (ceil(log2 nz) of them) 11
    for each distinct matrix (U and V share one, T and S another unless
    double diffusion (``ldd``) makes difs differ from dift) and 4 for each
    of the four right-hand sides; 6 per entry of each ``aref`` row's
    nonzero prefix (3 profiles, a multiply and an add); ~120 per column of
    surface terms; per level above ``kbl`` 110 bldepth and 150 blmix (each
    with one ~45-op wscale).  ``kbl`` is a number or a tensor of
    per-column values (then the result is a tensor)."""
    wz = nz + 2
    stages = math.ceil(math.log2(nz)) if nz > 1 else 0
    pcr = stages * (11 * (3 if ldd else 2) + 4 * 4)
    per_level = 12 + 270 + 11 + 14 + 30 + pcr + 24 + 24 + 8 + 8
    n_ref = int((row_extents(aref).astype(np.int64) + 1).sum())
    base = wz * per_level + 6 * n_ref + 120
    if isinstance(kbl, torch.Tensor):
        return base + (kbl - 1).clamp_min(0) * 260
    return base + max(kbl - 1, 0) * 260


def _raise_on(rc: int, name: str, geom=None):
    if rc == 1:       # cudaErrorInvalidValue: the launcher's own checks
        raise RuntimeError(f"{name}: launch geometry refused (the shared-"
                           "memory layout of launch_geometry and csrc differ?)")
    if rc == NO_CLUSTER:
        raise RuntimeError(
            f"{name}: the card cannot hold one cluster of {geom.cb} blocks "
            f"of {32 * geom.warps} threads and {geom.smem} bytes of shared "
            "memory (cudaOccupancyMaxActiveClusters is 0)")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _out_maker(kw, ncol, like):
    """An output of ``rows`` values a column in the wrapper's layout:
    (rows, ncol) for zaxis 0, (ncol, rows) for 1."""
    zaxis = kw.get("zaxis", 0)
    return lambda rows: torch.empty((ncol, rows) if zaxis else (rows, ncol),
                                    dtype=like.dtype, device=like.device)


def _ptrs(tensors):
    """The tensors' device pointers (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _launch_args(arrays, kw, ncol, dtype):
    """The library, the inputs in the kernels' order (``arrays`` with
    aref in its col_lanes form, then the depth prefix, aref row extents,
    aref's device tile or None, the grid rows' tile or None) and the
    launch geometry."""
    nz = kw["nz"]
    zaxis = kw.get("zaxis", 0)
    aref = _kernel_aref(arrays[-1], zaxis)
    hi, kref = _ref_extents(aref)
    geom = launch_geometry(nz, dtype, ncol, kref)
    lib = _lib(dtype, geom.lib, zaxis)
    # a grid row is the same memory in both layouts: (WZ, 1) or (1, WZ)
    hm = arrays[-5].reshape(-1, 1)
    advect = kw["flags"].l_advect
    pfx = fp._depth_prefix(hm, nz).contiguous() if advect else hm
    tile = (_ref_tile(aref, geom.ns, geom.cw, geom.cb) if geom.aref_dev
            else None)
    grid = (_grid_tile(arrays, pfx, advect, geom.levels) if geom.grid_dev
            else None)
    return lib, list(arrays[:-1]) + [aref, pfx, hi, tile, grid], geom


class FusedPass:
    """make_fused_pass(impl="cuda"): the pass kernel (fast or full)."""

    def __init__(self, kw: dict):
        self.kw = kw
        self.full = kw["full"]
        self.name = "fused_pass_full" if self.full else "fused_pass_fast"

    def __call__(self, *arrays):
        if len(arrays) != fp.N_IN_TOTAL:
            raise ValueError(f"expected {fp.N_IN_TOTAL} inputs")
        if arrays[0].device.type == "cpu":
            return fp._pass_body(*arrays, **self.kw)
        return self.launch(*arrays)

    def launch(self, *arrays):
        """Launch the kernel."""
        ncol, dtype = _check(arrays, self.kw, 12)
        lib, ins, geom = _launch_args(arrays, self.kw, ncol, dtype)
        wz = self.kw["nz"] + 2
        mk = _out_maker(self.kw, ncol, arrays[0])
        if self.full:
            outs = [mk(wz) for _ in range(4)] + [mk(16)] + \
                   [mk(wz) for _ in range(18)]
        else:
            outs = [mk(wz) for _ in range(8)] + [mk(8)]
        params = _params(self.kw, ncol)
        dev = arrays[0].device
        pin, pout = _ptrs(ins), _ptrs(outs)   # alive across the call
        rc = lib.kpp_fused_pass(int(self.full), ctypes.addressof(pin),
                                ctypes.addressof(pout),
                                ctypes.addressof(params),
                                ctypes.addressof(geom),
                                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, self.name, geom)
        LAUNCHES[self.name] += 1
        return tuple(outs)


class FusedStep:
    """make_fused_step(impl="cuda"): the whole-step kernel."""

    name = "fused_step"

    def __init__(self, kw: dict):
        self.kw = kw

    def __call__(self, *arrays):
        if len(arrays) != fp.N_STEP_IN:
            raise ValueError(f"expected {fp.N_STEP_IN} inputs")
        if arrays[0].device.type == "cpu":
            return fp._step_body(*arrays, **self.kw)
        return self.launch(*arrays)

    def launch(self, *arrays):
        """Launch the kernel."""
        ncol, dtype = _check(arrays, self.kw, 8)
        lib, ins, geom = _launch_args(arrays, self.kw, ncol, dtype)
        wz = self.kw["nz"] + 2
        mk = _out_maker(self.kw, ncol, arrays[0])
        outs = [mk(wz) for _ in range(8)] + [mk(8)]
        # the pass slots: u0..s0 stand in for ux..sx (unused by the step)
        ins = ins[:4] + ins
        params = _params(self.kw, ncol)
        dev = arrays[0].device
        pin, pout = _ptrs(ins), _ptrs(outs)   # alive across the call
        rc = lib.kpp_fused_step(ctypes.addressof(pin),
                                ctypes.addressof(pout),
                                ctypes.addressof(params),
                                ctypes.addressof(geom),
                                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, self.name, geom)
        LAUNCHES[self.name] += 1
        return tuple(outs)
