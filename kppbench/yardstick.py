"""The yardstick: the H100's peaks, the card's name and power limit, and
the operations and bytes of the whole-step kernel.  ``pass_ops`` and
``row_extents`` are frozen copies of ``mckpp_torch/ops/cuda_kernels.py``,
``kernel_bytes`` and ``card_peaks`` of ``chip_smoke.py``, and
``build_ref_matrix`` of ``mckpp_torch/ops/fused_pass.py``, all at commit
a49d027; the kernel's argument list is that of
``fused_pass.make_fused_step`` (21 inputs) and
``cuda_kernels.FusedStep.launch`` (9 outputs) there."""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch

EPSILON_KPP = 0.1      # reference/constants.EPSILON_KPP
NSC = 32               # colscal rows (fused_pass.NSC)
COLSTEP_ROWS = 8       # the step's per-column outputs
FP32_PEAK = 67.0e12    # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_PEAK = 3.35e12     # H100 SXM HBM3, bytes/s


def card_peaks(name: str):
    """(FP32 CUDA-core FLOP/s, memory bytes/s) of the H100 SKU by name
    (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12
    if "NVL" in name:
        return 60.0e12, 3.9e12
    return FP32_PEAK, HBM_PEAK


def smi_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them
    ("" where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""


def build_ref_matrix(zm: np.ndarray, wz: int) -> np.ndarray:
    """The (WZ, WZ) matrix A with ``ref_avg(prof) = prof @ A``: column n
    the trapezoid average from the surface to ``epsilon * zm(n+1)``."""
    zm = np.asarray(zm, np.float64)
    nz = zm.shape[0] - 1
    A = np.zeros((wz, wz), np.float64)
    zref = EPSILON_KPP * zm[:nz]
    wz0 = np.maximum(zm[0], zref)
    dz_lay = zm[:nz] - zm[1:nz + 1]
    kstar = np.searchsorted(-zm, -zref, side="left") - 1
    for n in range(nz):
        A[0, n] += wz0[n] / zref[n]
        if kstar[n] >= 0:
            ks = min(int(kstar[n]), nz - 1)
            for k in range(ks):
                tf = 0.5 * dz_lay[k] / zref[n]
                A[k, n] -= tf
                A[k + 1, n] -= tf
            wzp = zm[ks] - zref[n]
            delp = 0.5 * wzp / dz_lay[ks]
            A[ks, n] -= wzp * (1.0 - delp) / zref[n]
            A[ks + 1, n] -= wzp * delp / zref[n]
    return A


def row_extents(aref) -> np.ndarray:
    """Last nonzero column of each row of ``aref`` (-1 for a zero row), as
    int32: the reference averages sum ``aref[n, 0..hi[n]]`` only."""
    a = (aref.detach().cpu().numpy() if isinstance(aref, torch.Tensor)
         else np.asarray(aref))
    cols = np.arange(a.shape[1])
    return np.where(a != 0, cols, -1).max(axis=1).astype(np.int32)


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


def kernel_bytes(a, got, aref):
    """The bytes a kernel must move: every input read once, every output
    written once, but of aref (``a[-1]``, ``aref`` its col_lanes form) only
    the nonzero prefix of each row, the entries the reference averages
    read, with the row extents (int32, one a level) that bound them: a
    kernel never reads the rest of the (nz + 2)^2 matrix."""
    n_ref = int((row_extents(aref).astype("int64") + 1).sum())
    return sum(x.numel() * x.element_size() for x in a[:-1]) + \
        (n_ref * aref.element_size() + aref.shape[0] * 4) + \
        sum(x.numel() * x.element_size() for x in got)


def kernel_aref(zm: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """The col_lanes ``aref`` the step kernel reads for level depths
    ``zm`` (nz + 1 of them, rounded to the run's dtype first, as the
    program builds it from its grid)."""
    zm = np.asarray(torch.as_tensor(zm).to(dtype).double().numpy())
    wz = len(zm) + 1
    return torch.as_tensor(build_ref_matrix(zm, wz).T, dtype=dtype)


def step_bytes(ncol: int, nz: int, aref: torch.Tensor) -> int:
    """Bytes of one launch of the whole-step kernel in col_lanes on
    ``ncol`` columns: its 21 inputs (u0..so, swdk, swfrac: (WZ, ncol);
    the four switched-off forcing profiles and the five grid rows:
    (WZ, 1); colscal (NSC, ncol); aref) and 9 outputs (eight (WZ, ncol)
    profiles, the (8, ncol) column values), by :func:`kernel_bytes`."""
    wz = nz + 2
    meta = lambda *s: torch.empty(s, dtype=aref.dtype, device="meta")
    a = ([meta(wz, ncol) for _ in range(10)]
         + [meta(wz, 1) for _ in range(4)] + [meta(NSC, ncol)]
         + [meta(wz, 1) for _ in range(5)] + [aref])
    got = [meta(wz, ncol) for _ in range(8)] + [meta(COLSTEP_ROWS, ncol)]
    return kernel_bytes(a, got, aref)


def step_ops(nz: int, aref, npass: np.ndarray, kmix: np.ndarray,
             ldd: bool = False) -> float:
    """Operations of one step over columns whose passes and kmix are
    ``npass`` and ``kmix`` (arrays of one value a column)."""
    per = pass_ops(nz, aref, torch.as_tensor(np.asarray(kmix, np.float64)),
                   ldd)
    return float((torch.as_tensor(np.asarray(npass, np.float64)) * per)
                 .sum())
