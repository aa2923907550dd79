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
:func:`launch_geometry` computes the launch geometry the C side is given.

A wrapper called with CPU tensors runs the plain torch body
(``ops/fused_pass.py``); with CUDA tensors it launches its kernel or
raises.  The kernels are built by ``nvcc`` from the sources in ``csrc/``
on first use, into ``mckpp_torch/_build/``.
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
WARPS = 8              # columns per block, one warp each
LZ = 96                # levels per profile row in shared memory (KPP_MAXWZ)
N_SLOTS = 23           # per-warp profile slots (NB)
N_COLV = 48            # per-warp column values: colscal rows + 16 outputs
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


def _lib_path(dtype, phases=False) -> str:
    tag = "_phases" if phases else ""
    return os.path.join(_BUILD,
                        f"libkpp_{_REALS[dtype]}{tag}_{_source_hash()}.so")


def build(dtypes=(torch.float32, torch.float64), phases=False) -> dict:
    """Compile the kernels for ``dtypes`` (one nvcc process per dtype, run
    together) unless an up-to-date library exists.  Returns {dtype: ptxas
    report} for the libraries built by this call.  ``phases`` builds the
    library with the stage clocks of ``csrc/fused_pass.cuh`` on
    (``-DKPP_PHASES``, for chip_phases.py) under its own name; the port
    itself always loads the one without."""
    os.makedirs(_BUILD, exist_ok=True)
    procs = {}
    for dt in dtypes:
        out = _lib_path(dt, phases)
        if os.path.exists(out):
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, f"-DKPP_REAL={_REALS[dt]}",
               *(["-DKPP_PHASES"] if phases else []),
               "-o", out + ".tmp", os.path.join(_CSRC, "fused_kernels.cu")]
        procs[dt] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    for dt, (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_REALS[dt]}:\n{log}")
        os.replace(out + ".tmp", out)
        reports[dt] = log
    return reports


def _lib(dtype):
    with _lock:
        lib = _libs.get(dtype)
        if lib is None:
            lib = load(dtype)
            _libs[dtype] = lib
        return lib


def load(dtype, phases=False):
    """The kernel library for ``dtype``, built if missing (``phases``: see
    :func:`build`)."""
    path = _lib_path(dtype, phases)
    if not os.path.exists(path):
        build((dtype,), phases)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kpp_fused_pass.argtypes = [ci, vp, vp, vp, vp, vp]
    lib.kpp_fused_pass.restype = ci
    lib.kpp_fused_step.argtypes = [vp, vp, vp, vp, vp]
    lib.kpp_fused_step.restype = ci
    lib.kpp_real_bytes.restype = ci
    lib.kpp_max_wz.restype = ci
    if phases:
        lib.kpp_phase_read.argtypes = [vp]
        lib.kpp_phase_read.restype = ci
        lib.kpp_phase_zero.restype = ci
    if lib.kpp_real_bytes() != torch.empty((), dtype=dtype).element_size():
        raise RuntimeError(f"{path} was built for another dtype")
    if lib.kpp_max_wz() != LZ:
        raise RuntimeError(f"{path}: MAXWZ {lib.kpp_max_wz()} != {LZ}")
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
            f"wscale={flags.wscale!r} has no CUDA kernel (ROADMAP A14)")
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
    (ncol, dtype).  ``n_prof`` leading arrays are (WZ, ncol) profiles."""
    nz = kw["nz"]
    wz = nz + 2
    u = arrays[0]
    dtype, dev = u.dtype, u.device
    if dtype not in _REALS:
        raise TypeError(f"fused kernels take float32 or float64, not {dtype}")
    if u.dim() != 2 or u.shape[0] != wz:
        raise ValueError(f"profiles must be (nz+2={wz}, ncol), got "
                         f"{tuple(u.shape)}")
    ncol = u.shape[1]
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
    # forcing profiles are (WZ, ncol) when their flag is on, else dummies
    for i in list(range(n_prof)) + [sw + j for j in range(6) if on[j]]:
        if tuple(arrays[i].shape) != (wz, ncol):
            raise ValueError(f"input {i}: shape {tuple(arrays[i].shape)}, "
                             f"expected {(wz, ncol)}")
    if tuple(arrays[sw + 6].shape) != (fp.NSC, ncol):
        raise ValueError(f"colscal must be ({fp.NSC}, ncol)")
    for i in range(sw + 7, sw + 12):
        if tuple(arrays[i].shape) != (wz, 1):
            raise ValueError(f"grid row {i} must be ({wz}, 1)")
    if tuple(arrays[sw + 12].shape) != (wz, wz):
        raise ValueError(f"aref must be ({wz}, {wz})")
    return ncol, dtype


class Geometry(ctypes.Structure):
    """Field for field the C struct kpp::Geometry (csrc/fused_pass.cuh)."""
    _fields_ = [("warps", ctypes.c_int), ("blocks", ctypes.c_int),
                ("kref", ctypes.c_int), ("smem", ctypes.c_int)]

    @property
    def cols_per_block(self) -> int:
        return self.warps            # one warp per column


def _warp_stride() -> int:
    """Elements of one warp's shared-memory area, padded to 4 (mod 32)
    (csrc/fused_pass.cuh warp_stride)."""
    pw = N_SLOTS * LZ + N_COLV
    return pw + (4 - pw % 32) % 32


def launch_geometry(nz: int, dtype, ncol: int, kref: int | None = None
                    ) -> Geometry:
    """Warps (= columns) per block, blocks, aref columns kept in shared
    memory and dynamic shared-memory bytes of one launch at ``nz`` levels
    over ``ncol`` columns.  ``kref`` is the number of ``aref`` columns the
    reference averages read (:func:`row_extents`); the default is the
    worst case, all ``nz + 2``."""
    wz = nz + 2
    if wz > LZ:
        raise ValueError(f"nz+2={wz} exceeds the kernels' MAXWZ={LZ}")
    kref = wz if kref is None else kref
    if not 0 <= kref <= wz:
        raise ValueError(f"kref={kref} outside 0..{wz}")
    esize = torch.empty((), dtype=dtype).element_size()
    smem = ((6 + kref) * LZ + WARPS * _warp_stride()) * esize + LZ * 4
    if smem > SMEM_MAX:
        raise ValueError(f"{smem} bytes of shared memory exceed {SMEM_MAX}")
    return Geometry(warps=WARPS, blocks=-(-ncol // WARPS), kref=kref,
                    smem=smem)


def row_extents(aref) -> np.ndarray:
    """Last nonzero column of each row of ``aref`` (-1 for a zero row), as
    int32: the reference averages sum ``aref[n, 0..hi[n]]`` only."""
    a = (aref.detach().cpu().numpy() if isinstance(aref, torch.Tensor)
         else np.asarray(aref))
    cols = np.arange(a.shape[1])
    return np.where(a != 0, cols, -1).max(axis=1).astype(np.int32)


# id(aref) -> (weak reference, its _version, row extents on its device,
# kref); the grid is static, so each aref is read back to the host once
_extents: dict = {}


def _ref_extents(aref: torch.Tensor):
    hit = _extents.get(id(aref))
    if hit is not None and hit[0]() is aref and hit[1] == aref._version:
        return hit[2], hit[3]
    hi = row_extents(aref)
    dev = torch.as_tensor(hi, device=aref.device)
    kref = int(hi.max()) + 1 if hi.size else 0
    if len(_extents) > 64:                   # drop entries of dead tensors
        for key in [k for k, v in _extents.items() if v[0]() is None]:
            del _extents[key]
    _extents[id(aref)] = (weakref.ref(aref), aref._version, dev, kref)
    return dev, kref


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


def _raise_on(rc: int, name: str):
    if rc == 1:       # cudaErrorInvalidValue: the launcher's own checks
        raise RuntimeError(f"{name}: launch geometry refused (the shared-"
                           "memory layout of launch_geometry and csrc differ?)")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch_args(arrays, kw, ncol, dtype):
    """The library, the extra inputs (depth prefix, aref row extents) and
    the launch geometry."""
    nz = kw["nz"]
    hi, kref = _ref_extents(arrays[-1])
    geom = launch_geometry(nz, dtype, ncol, kref)
    lib = _lib(dtype)
    hm = arrays[-5]
    pfx = (fp._depth_prefix(hm, nz).contiguous()
           if kw["flags"].l_advect else hm)
    return lib, [pfx, hi], geom


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
        ncol, dtype = _check(arrays, self.kw, 12)
        lib, extra, geom = _launch_args(arrays, self.kw, ncol, dtype)
        wz = self.kw["nz"] + 2
        dev = arrays[0].device
        mk = lambda rows: torch.empty((rows, ncol), dtype=dtype, device=dev)
        if self.full:
            outs = [mk(wz) for _ in range(4)] + [mk(16)] + \
                   [mk(wz) for _ in range(18)]
        else:
            outs = [mk(wz) for _ in range(8)] + [mk(8)]
        ins = list(arrays) + extra
        params = _params(self.kw, ncol)
        pin, pout = _ptrs(ins), _ptrs(outs)   # alive across the call
        rc = lib.kpp_fused_pass(int(self.full), ctypes.addressof(pin),
                                ctypes.addressof(pout),
                                ctypes.addressof(params),
                                ctypes.addressof(geom),
                                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, self.name)
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
        ncol, dtype = _check(arrays, self.kw, 8)
        lib, extra, geom = _launch_args(arrays, self.kw, ncol, dtype)
        wz = self.kw["nz"] + 2
        dev = arrays[0].device
        outs = [torch.empty((wz, ncol), dtype=dtype, device=dev)
                for _ in range(8)]
        outs.append(torch.empty((8, ncol), dtype=dtype, device=dev))
        # the pass slots: u0..s0 stand in for ux..sx (unused by the step)
        ins = list(arrays[:4]) + list(arrays[:4]) + list(arrays[4:]) + extra
        params = _params(self.kw, ncol)
        pin, pout = _ptrs(ins), _ptrs(outs)   # alive across the call
        rc = lib.kpp_fused_step(ctypes.addressof(pin),
                                ctypes.addressof(pout),
                                ctypes.addressof(params),
                                ctypes.addressof(geom),
                                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, self.name)
        LAUNCHES[self.name] += 1
        return tuple(outs)
