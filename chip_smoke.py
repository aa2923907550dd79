#!/usr/bin/env python3
"""Drive mckpp_torch's main path on one CUDA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py

Phases, each printing JSON lines; any breach raises, so the script exits
0 only when every phase passed:

1. device: card name, power limit, versions; build the CUDA kernels;
2. kernel gate: each kernel against its plain torch version on the same
   float32 inputs at several (ncol, nz) shapes and flag sets (ragged last
   blocks, and one block mixing a land column, a column the instability
   trap retries and columns whose pass counts differ; columns mixing
   below level 32), plus one float64 instantiation;
3. main path: the production ocean step (``KppModel.step``, pass_impl
   "cuda_step", with the full diagnostics pass on with_diags steps) at the
   TerraMaris width, ncol = 144,507 (453 x 319), nz = 69, ~12% land, with
   the flux update on its cadence, timed; then a few steps of the per-pass
   path ("cuda"), so every kernel runs in this phase;
4. full-width comparisons, one step from the same state (the main path's,
   with seeded noise on T, S and u): "cuda_step" vs "eager_step" and
   "cuda" vs "cuda_step";
5. each kernel at the main-path shape, on the inputs the main path gave
   it: held to its plain version (the phase-2 bar), timed beside it and
   beside the card's bound;
6. a device trace (``torch.profiler``) of one full step and one
   prognostic step at the main-path width: device time by kernel name and
   the device-idle share.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the mckpp_torch package beside it, the script exits non-zero.
"""

import json
import re
import statistics
import subprocess
import sys
import time

TOL_F32 = 1e-5        # max |a-b| / max(|b|, 1e-6) per float output (bench.py:75)
TOL_F64 = 1e-10
KMIX_AGREE = 0.9999   # share of active columns whose kmix must agree
NCOL_MAIN, NZ_MAIN = 453 * 319, 69
LAND_SHARE = 0.12

# the TPU kernels these replace (mckpp_tpu/ops/fused_pass.py)
REPLACES = {"fused_pass_fast": "mckpp_tpu/ops/fused_pass.py:1031",
            "fused_pass_full": "mckpp_tpu/ops/fused_pass.py:1031",
            "fused_step": "mckpp_tpu/ops/fused_pass.py:1149"}
SOURCE = "mckpp_torch/csrc/fused_kernels.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def warps_per_sm(regs, warps, smem):
    """Warps of a kernel resident on one H100 SM, from its registers per
    thread (ptxas) and a block's warps and dynamic shared memory: each of
    the 4 SM quarters holds 16,384 registers, given out per warp in units
    of 256; 233,472 B of shared memory with 1 KB reserved per block; at
    most 64 warps and 32 blocks."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(4 * (16384 // per_warp) // warps, 233_472 // (smem + 1024),
                 64 // warps, 32)
    return blocks * warps


def card_peaks(name):
    """(FP32 CUDA-core FLOP/s, memory bytes/s) of the H100 SKU by name
    (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12
    if "NVL" in name:
        return 60.0e12, 3.9e12
    return 67.0e12, 3.35e12


# ---------------------------------------------------------------------------
# model set-up (as __graft_entry__._build builds the JAX bench model)
# ---------------------------------------------------------------------------

def build(ncol, nz, dtype="float32", pass_impl="cuda_step", physics=None,
          boundary=None, noise=0.0, seed=0, land=0.0, big=(), dmax=1000.0):
    """``land``: a share of land columns drawn at random, or a tuple of
    land column indices; ``big``: columns given large T and u noise."""
    import numpy as np
    import torch
    import mckpp_torch as T
    from mckpp_torch import forcing as forcing_mod
    from mckpp_torch.grid import coriolis
    from mckpp_torch.state import init_params

    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=dmax),
        time=T.TimeConfig(dtsec=3600.0, ndtocn=3, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(pass_impl=pass_impl, **(physics or {})),
        boundary=T.BoundaryConfig(**(boundary or {})),
        dtype=dtype)
    model = T.KppModel(cfg)                    # cuda
    dev, dt = model.device, model.dtype
    nzp1 = nz + 1
    zm = model.grid.zm.double().cpu().numpy()
    rng = np.random.default_rng(seed)
    t0 = np.tile(20.0 + 8.0 * np.exp(zm / 80.0), (ncol, 1))
    s0 = np.tile(35.0 - 0.4 * np.exp(zm / 120.0), (ncol, 1))
    u0 = np.zeros((ncol, nzp1, 2))
    if noise:
        t0 = t0 + noise * rng.standard_normal(t0.shape)
        s0 = s0 + 0.2 * noise * rng.standard_normal(s0.shape)
        u0 = u0 + 0.4 * noise * rng.standard_normal(u0.shape)
    for col in big:
        t0[col] += 3.0 * rng.standard_normal(nzp1)
        u0[col] += 2.0 * rng.standard_normal((nzp1, 2))
    prm = init_params(ncol, nzp1, dtype=dt, device=dev)
    lat = torch.linspace(-30.0, 30.0, ncol, dtype=dt, device=dev)
    prm = prm.replace(f=coriolis(lat), dlat=lat)
    if isinstance(land, tuple):
        wet = torch.ones(ncol, dtype=torch.bool, device=dev)
        wet[list(land)] = False
        prm = prm.replace(l_ocean=wet, run_physics=wet)
    elif land:
        # islands as in tools/make_benchmark_configs.py (terramaris)
        wet = torch.as_tensor(
            np.random.default_rng(0).uniform(size=ncol) >= land, device=dev)
        prm = prm.replace(l_ocean=wet, run_physics=wet)
    full = lambda v: torch.full((ncol,), v, dtype=dt, device=dev)
    prm = prm.replace(relax_sst=full(1 / (5 * 86400.0)),
                      relax_ocnt=full(1 / (3 * 86400.0)),
                      relax_sal=full(1 / (4 * 86400.0)))
    if (boundary or {}).get("l_advect"):
        nm = torch.zeros((ncol, 2), dtype=torch.int32)
        md = torch.zeros((ncol, 6, 2), dtype=torch.int32)
        mg = torch.zeros((ncol, 6, 2), dtype=torch.float64)
        j = torch.arange(ncol)
        nm[:, 1] = 3
        for i, (off, mag) in enumerate(((0, 2e-6), (2, -1e-6), (4, 1.5e-6))):
            md[:, i, 1] = 1 + (j + off) % 7
            mg[:, i, 1] = mag
        prm = prm.replace(nmodeadv=nm.to(dev), modeadv=md.to(dev),
                          advection=mg.to(dt).to(dev))
    st, prm, frc = model.warm_start(u0, t0, s0, prm)
    prof = lambda a: torch.as_tensor(np.tile(a, (ncol, 1)), dtype=dt,
                                     device=dev)
    frc = frc.replace(sst0=full(24.0), fcorr_twod=full(15.0),
                      ocnt_clim=prof(np.linspace(22.0, 10.0, nzp1)),
                      sal_clim=prof(np.full(nzp1, 0.1)),
                      fcorr_withz=prof(np.linspace(30.0, 0.0, nzp1)),
                      sfcorr_withz=prof(np.full(nzp1, 1e-7)))
    raw = forcing_mod.constant_test_fluxes(ncol, dt, dev)
    st, frc = forcing_mod.update_fluxes(cfg, st, prm, frc, raw, True,
                                        model.grid.dm)
    return model, st, prm, frc


def run_steps(model, st, prm, frc, nt0, n, with_diags=True):
    """Steps nt0 .. nt0+n-1 with the flux update on its ndtocn cadence."""
    from mckpp_torch import forcing as forcing_mod
    cfg = model.cfg
    ncol = st.u.shape[0]
    raw = forcing_mod.constant_test_fluxes(ncol, model.dtype, model.device)
    for nt in range(nt0, nt0 + n):
        if nt > 1 and (nt - 1) % cfg.time.ndtocn == 0:
            st, frc = forcing_mod.update_fluxes(cfg, st, prm, frc, raw,
                                                False, model.grid.dm)
        st = model.step(st, prm, frc, first_step=(nt <= 1),
                        with_diags=with_diags)
    return st, frc


class Capture:
    """Records the arguments of the first launch of each kernel while
    active (the inputs the main path gives each kernel)."""

    def __init__(self):
        from mckpp_torch.ops import cuda_kernels as ck
        self.ck = ck
        self.calls = []

    def __enter__(self):
        ck = self.ck
        self.orig = (ck.FusedPass.launch, ck.FusedStep.launch)
        calls = self.calls

        def wrap(fn):
            def launch(w, *a):
                if all(c[0].name != w.name for c in calls):
                    calls.append((w, tuple(x.clone() for x in a)))
                return fn(w, *a)
            return launch
        ck.FusedPass.launch = wrap(self.orig[0])
        ck.FusedStep.launch = wrap(self.orig[1])
        return self

    def __exit__(self, *exc):
        self.ck.FusedPass.launch, self.ck.FusedStep.launch = self.orig

    def first(self, name):
        for w, a in self.calls:
            if w.name == name:
                return w, a
        raise AssertionError(f"kernel {name} was not launched")


def plain_of(w, args):
    from mckpp_torch.ops import cuda_kernels as ck
    from mckpp_torch.ops import fused_pass as fp
    body = fp._pass_body if isinstance(w, ck.FusedPass) else fp._step_body
    return body(*args, **w.kw)


# integer-valued rows of each kernel's per-column output, compared exactly
INT_ROWS = {"fused_pass_fast": (8, (1,)), "fused_pass_full": (4, (1,)),
            "fused_step": (8, (1, 4, 5, 7))}


def compare(w, got, ref, tol):
    """Max relative difference over the float outputs; the integer rows
    must be equal."""
    worst = 0.0
    pos, rows = INT_ROWS[w.name]
    for i, (a, b) in enumerate(zip(got, ref)):
        d = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
        worst = max(worst, d)
        if d > tol:
            raise AssertionError(f"{w.name} output {i}: max rel {d:.3e} > {tol}")
    for r in rows:
        n_bad = int((got[pos][r] != ref[pos][r]).sum())
        if n_bad:
            raise AssertionError(f"{w.name} integer row {r}: {n_bad} columns "
                                 "differ")
    return worst


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

KERNEL_OF = (("fused_step_kernel", "fused_step"),
             ("fused_pass_kernelIfLb0", "fused_pass_fast"),
             ("fused_pass_kernelIdLb0", "fused_pass_fast"),
             ("fused_pass_kernelIfLb1", "fused_pass_full"),
             ("fused_pass_kernelIdLb1", "fused_pass_full"))


def ptxas_table(log):
    """{kernel: {registers, stack, spill_stores, spill_loads}} from one
    nvcc -Xptxas -v report."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next(k for m, k in KERNEL_OF if m in ln)
            out[cur] = {}
        elif cur and "bytes stack frame" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[cur].update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif cur and "Used" in ln and "registers" in ln:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  ln).group(1))
    return out


def phase_device():
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    reports = ck.build()
    build_s = time.perf_counter() - t0
    ptxas = {str(dt).replace("torch.", ""): ptxas_table(log)
             for dt, log in reports.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    return name, smi, ptxas


GATE_FLAGS = {
    "default_analytic": dict(physics=dict(wscale_mode="analytic")),
    "nodal": dict(physics=dict(wscale_mode="nodal")),
    "ldd": dict(physics=dict(ldd=True)),
    "advect": dict(boundary=dict(l_advect=True)),
    "relax_ocnt_sal": dict(boundary=dict(l_relax_ocnt=True, l_relax_sal=True)),
    "lkpp_off": dict(physics=dict(lkpp=False)),
}
# (ncol, nz): two widths, an odd ncol, an ncol below one block, nz=65 (nz
# just over 64: one more PCR and scan stage, WZ=67 reaches the third lane
# slot) and nz=94 (WZ=96, the kernels' MAXWZ); 300, 37, 129 and 61 leave
# a ragged last block of the 8-column blocks
GATE_SHAPES = [(512, 69), (256, 40), (300, 33), (37, 69), (129, 65), (64, 94),
               (61, 69)]


def gate_case(ncol, nz, dtype, flags, tol, seed, land=0.1, big=(), warm=2):
    """Each kernel against its plain version on the inputs of step
    warm+1; returns ({kernel: max rel}, the plain step's colstep)."""
    out, colstep = {}, None
    for impl in ("cuda", "cuda_step"):
        model, st, prm, frc = build(ncol, nz, dtype, impl, noise=0.05,
                                    seed=seed, land=land, big=big, **flags)
        st, frc = run_steps(model, st, prm, frc, 1, warm)
        with Capture() as cap:
            run_steps(model, st, prm, frc, warm + 1, 1)
        names = (("fused_pass_fast", "fused_pass_full") if impl == "cuda"
                 else ("fused_step",))
        for name in names:
            w, a = cap.first(name)
            got = w.launch(*a)
            ref = plain_of(w, a)
            sync()
            out[name] = compare(w, got, ref, tol)
            if name == "fused_step":
                colstep = ref[8]
    return out, colstep


def gate_mixed_block():
    """One 8-column block (one launch block) that mixes a land column, a
    column the instability trap retries (comp_flag = 1 after 11 attempts)
    and columns whose pass counts differ by >= 3 (large T and u noise on
    columns 1 and 6)."""
    import torch
    res, cs = gate_case(8, 69, "float32", GATE_FLAGS["default_analytic"],
                        TOL_F32, 0, land=(3,), big=(1, 6), warm=0)
    active = torch.ones(8, dtype=torch.bool, device=cs.device)
    active[3] = False
    npass = cs[7][active]
    trapped = int(((cs[4] > 0.5) & (cs[5] >= 2) & active).sum())
    spread = float(npass.max() - npass.min())
    if cs[7][3] != 0 or trapped == 0 or spread < 3:
        raise AssertionError(f"mixed block lacks its cases: npass "
                             f"{cs[7].tolist()}, comp {cs[4].tolist()}, "
                             f"reset {cs[5].tolist()}")
    emit({"phase": "gate", "ncol": 8, "nz": 69, "flags": "mixed_block",
          "dtype": "float32", "max_rel": res, "npass": cs[7].tolist(),
          "comp_flag": cs[4].tolist(), "reset": cs[5].tolist()})
    return res


def plain_serial(w, args):
    """The plain version with its one matmul, the reference averages
    ``aref @ prof``, summed as the kernels sum them: term by term in k
    order, each product and each sum rounded on its own.  (cuBLAS fuses
    and orders them its own way.)"""
    import torch
    matmul = torch.matmul

    def serial(a, b):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=b.dtype,
                          device=b.device)
        for k in range(a.shape[1]):
            acc = acc + a[:, k:k + 1] * b[k:k + 1]
        return acc
    torch.matmul = serial
    try:
        return plain_of(w, args)
    finally:
        torch.matmul = matmul


def deepened(w, a, stratified):
    """The captured inputs made to mix deep: wind stress 0.05..2 N/m2 and
    cooling 0..900 W/m2 across the columns, no S anomaly, and either a
    weak stable stratification (T = 20 + 0.005 zm) under a surface current
    (u = 0.3 exp(zm / 100)), or (``stratified`` false) a uniform, still
    column (T = 20, u = 0), where the bulk Richardson number is rounding
    noise."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    a = [x.clone() for x in a]
    step = isinstance(w, ck.FusedStep)
    cs = a[14 if step else 18]
    zm = a[-6]                                        # (WZ, 1) grid row
    ncol = cs.shape[1]
    cs[0] = torch.linspace(0.05, 2.0, ncol, dtype=cs.dtype, device=cs.device)
    cs[3] = torch.linspace(0.0, 900.0, ncol, dtype=cs.dtype, device=cs.device)
    dtdz, u0 = (0.005, 0.3) if stratified else (0.0, 0.0)
    for i in ((0, 4) if step else (0, 4, 8)):
        a[i].copy_((u0 * torch.exp(zm / 100.0)).expand_as(a[i]))    # u
    for i in ((1, 5) if step else (1, 5, 9)):
        a[i].zero_()                                  # v
    for i in ((2, 6) if step else (2, 6, 10)):
        a[i].copy_((20.0 + dtdz * zm).expand_as(a[i]))              # T
    for i in ((3, 7) if step else (3, 7, 11)):
        a[i].zero_()                                  # S anomaly
    return tuple(a)


def gate_deep():
    """Columns whose boundary layer reaches below level 32, so bldepth
    searches past the first lane slot (nz = 94 over 120 m), on the first
    step's inputs made to mix deep (:func:`deepened`), stratified and
    neutral.  On both, each kernel is held to the plain version with
    serially summed reference averages (:func:`plain_serial`); on the
    stratified one, to the plain version itself too.  Rib at the neutral
    columns turns on the last ulp of the reference averages, which cuBLAS
    rounds otherwise, so there the distance to the plain version is
    reported, not held."""
    out, kmix = {}, {}
    for impl in ("cuda", "cuda_step"):
        model, st, prm, frc = build(16, 94, "float32", impl, dmax=120.0)
        with Capture() as cap:
            run_steps(model, st, prm, frc, 1, 1)
        names = (("fused_pass_fast", "fused_pass_full") if impl == "cuda"
                 else ("fused_step",))
        for name in names:
            w, a = cap.first(name)
            for case in ("neutral", "stratified"):
                x = deepened(w, a, case == "stratified")
                got = w.launch(*x)
                ref, ser = plain_of(w, x), plain_serial(w, x)
                sync()
                res = {}
                for key, r in (("plain", ref), ("plain_serial", ser)):
                    try:
                        res[key] = compare(w, got, r, TOL_F32)
                    except AssertionError as e:
                        res[key] = str(e)
                out[(name, case)] = res
                if name == "fused_step":
                    kmix[case] = ser[8][1].tolist()
    emit({"phase": "gate", "ncol": 16, "nz": 94, "flags": "deep_mixing",
          "dtype": "float32", "kmix": kmix,
          "max_rel": {f"{n}/{c}": r for (n, c), r in out.items()}})
    for (name, case), r in out.items():
        for key in (("plain", "plain_serial") if case == "stratified"
                    else ("plain_serial",)):
            if isinstance(r[key], str):
                raise AssertionError(f"deep {case}: {r[key]} against {key}")
    if not any(k > 32 for k in kmix["stratified"]):
        raise AssertionError("deep case: no kmix below level 32")
    return {n: max(r["plain"], r["plain_serial"])
            for (n, c), r in out.items() if c == "stratified"}


def phase_gate():
    worst = {}
    n = 0
    for si, (ncol, nz) in enumerate(GATE_SHAPES):
        for fi, (fname, flags) in enumerate(GATE_FLAGS.items()):
            # every flag set at the first shape, the default at the others
            if si > 0 and fname not in ("default_analytic", "advect"):
                continue
            res = gate_case(ncol, nz, "float32", flags, TOL_F32,
                            10 * si + fi)[0]
            emit({"phase": "gate", "ncol": ncol, "nz": nz, "flags": fname,
                  "dtype": "float32", "max_rel": res})
            for k, v in res.items():
                worst[k] = max(worst.get(k, 0.0), v)
            n += 1
    for res in (gate_mixed_block(), gate_deep()):
        for k, v in res.items():
            worst[k] = max(worst.get(k, 0.0), v)
    res = gate_case(300, 33, "float64", GATE_FLAGS["nodal"], TOL_F64, 99)[0]
    emit({"phase": "gate", "ncol": 300, "nz": 33, "flags": "nodal",
          "dtype": "float64", "max_rel": res})
    emit({"phase": "gate_ok", "cases": n + 3, "worst_f32": worst})
    return worst


def phase_main(name, smi):
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    torch.cuda.reset_peak_memory_stats()
    model, st, prm, frc = build(NCOL_MAIN, NZ_MAIN, land=LAND_SHARE)
    assert model.pass_impl == "cuda_step", model.pass_impl
    st, frc = run_steps(model, st, prm, frc, 1, 2)          # warm-up
    sync()
    steps, blocks = 4, 3
    ck.reset_counts()                     # the main path's run starts here
    nt = 3
    times = {}
    for with_diags in (True, False):
        ts = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            st, frc = run_steps(model, st, prm, frc, nt, steps, with_diags)
            sync()
            ts.append((time.perf_counter() - t0) / steps * 1e3)
            nt += steps
        times[with_diags] = ts
    step_counts = dict(ck.LAUNCHES)
    # the per-pass path ("cuda"): same state, a few steps
    model_p = build(NCOL_MAIN, NZ_MAIN, pass_impl="cuda",
                    land=LAND_SHARE)[0]
    st_p, frc_p = run_steps(model_p, st, prm, frc, nt, 2)
    sync()
    counts = dict(ck.LAUNCHES)            # ... and is read here
    pass_counts = {k: counts[k] - step_counts[k] for k in counts}
    zero = [k for k, v in counts.items() if v == 0]
    if zero:
        raise AssertionError(f"kernels not launched on the main path: {zero}")
    wet = prm.run_physics
    for fld in ("x", "u"):
        a = getattr(st, fld)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {fld}")
    hm = st.hmix[wet]
    if not bool(((hm > 0) & (hm <= 1000.0)).all()):
        raise AssertionError("hmix outside (0, dmax] on active columns")
    full_ms = statistics.median(times[True])
    prog_ms = statistics.median(times[False])
    emit({"phase": "main_path", "card": name, "nvidia_smi": smi,
          "ncol": NCOL_MAIN, "nz": NZ_MAIN, "active_columns": int(wet.sum()),
          "dtype": "float32", "pass_impl": model.pass_impl,
          "wscale": model.cfg.physics.wscale_mode,
          "full_step_ms": full_ms, "prognostic_step_ms": prog_ms,
          "full_step_ms_blocks": times[True],
          "prognostic_step_ms_blocks": times[False],
          "column_steps_per_s_full": NCOL_MAIN / (full_ms / 1e3),
          "column_steps_per_s_prognostic": NCOL_MAIN / (prog_ms / 1e3),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": counts, "launches_cuda_step_path": step_counts,
          "launches_cuda_path": pass_counts,
          "hmix_median_active": float(hm.median())})
    return model, st, prm, frc, nt, counts


def field_rel(a, b, mask):
    a, b = a[mask], b[mask]
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


def perturbed(st, seed=1):
    """The state with seeded noise on T, S and u (history levels too), so
    that the columns differ by more than their latitude."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    like = lambda shape, scale: torch.as_tensor(
        scale * rng.standard_normal(shape), dtype=st.x.dtype,
        device=st.x.device)
    dx = torch.stack([like(st.x.shape[:2], 0.05),
                      like(st.x.shape[:2], 0.01)], dim=-1)
    du = like(st.u.shape, 0.01)
    return st.replace(x=st.x + dx, u=st.u + du,
                      xs=st.xs + dx[..., None], us=st.us + du[..., None])


def phase_compare(st, prm, frc, nt):
    """One step from the same (perturbed) state through three paths;
    returns the captured kernel inputs at the main-path shapes."""
    import torch
    st = perturbed(st)
    outs, caps = {}, {}
    for impl in ("cuda_step", "eager_step", "cuda"):
        model = build(NCOL_MAIN, NZ_MAIN, pass_impl=impl,
                      land=LAND_SHARE)[0]
        with Capture() as cap:
            outs[impl] = run_steps(model, st, prm, frc, nt, 1)[0]
            sync()
        caps[impl] = cap
    wet = prm.run_physics
    res = {}
    for a_impl, b_impl in (("cuda_step", "eager_step"),
                           ("cuda", "cuda_step")):
        a, b = outs[a_impl], outs[b_impl]
        kdiff = wet & (a.kmix != b.kmix)
        nd = int(kdiff.sum())
        agree = 1.0 - nd / int(wet.sum())
        same = wet & ~kdiff
        rel = {f: field_rel(getattr(a, f), getattr(b, f), same)
               for f in ("x", "u", "difm", "dift")}
        res[f"{a_impl}_vs_{b_impl}"] = dict(
            max_rel=rel, kmix_agree=agree, kmix_differ=nd,
            kmix_differ_cols=torch.nonzero(kdiff).flatten()[:20].tolist())
        if agree < KMIX_AGREE:
            raise AssertionError(f"kmix agrees on {agree:.6f} of active "
                                 f"columns ({a_impl} vs {b_impl})")
        bad = {f: v for f, v in rel.items() if v > TOL_F32}
        if bad:
            raise AssertionError(f"{a_impl} vs {b_impl}: {bad}")
    emit({"phase": "compare", **res})
    return caps


def time_cuda(fn, reps):
    import torch
    fn()
    sync()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    sync()
    return e0.elapsed_time(e1) / reps


def phase_times(caps, counts, name, ptxas):
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    flops_peak, bytes_peak = card_peaks(name)
    sources = {"fused_pass_fast": caps["cuda"], "fused_pass_full":
               caps["cuda_step"], "fused_step": caps["cuda_step"]}
    rows = []
    for kname in ("fused_pass_fast", "fused_pass_full", "fused_step"):
        w, a = sources[kname].first(kname)
        got = w.launch(*a)
        ref = plain_of(w, a)
        sync()
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        rel = compare(w, got, ref, TOL_F32)
        ms = time_cuda(lambda: w.launch(*a), 5 if kname != "fused_step" else 3)
        plain_ms = time_cuda(lambda: plain_of(w, a), 2)
        nz = w.kw["nz"]
        ncol = a[0].shape[1]
        aref, ldd = a[-1], w.kw["flags"].ldd
        # bytes: every input read once, every output written once
        nbytes = sum(x.numel() * x.element_size() for x in a) + \
            sum(x.numel() * x.element_size() for x in got)
        # operations over aref's nonzeros (ck.pass_ops); the step counts
        # this run's passes per column (colstep row 7), each with the
        # bldepth/blmix levels above the column's kmix
        extra = {}
        if kname == "fused_step":
            kmix, npass = got[8][1].double(), got[8][7].double()
            ops = float((npass * ck.pass_ops(nz, aref, kmix, ldd)).sum())
            # a block holds its SM share until its slowest column is done:
            # passes run over passes the blocks' warps were held for
            w8 = ck.WARPS
            pad = torch.nn.functional.pad(npass, (0, (-ncol) % w8))
            held = float(pad.view(-1, w8).amax(dim=1).sum()) * w8
            extra = {"npass_mean_active": float(npass[npass > 0].mean()),
                     "npass_max": float(npass.max()),
                     "warp_pass_share_of_block_hold": float(npass.sum())
                     / held}
        else:
            kbl = got[8 if kname == "fused_pass_fast" else 4][1].double()
            ops = float(ck.pass_ops(nz, aref, kbl, ldd).sum())
        geom = ck.launch_geometry(nz, a[0].dtype, ncol,
                                  ck._ref_extents(aref)[1])
        regs = ptxas.get("float32", {}).get(kname, {}).get("registers")
        bound_bytes_ms = nbytes / bytes_peak * 1e3
        bound_ops_ms = ops / flops_peak * 1e3
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms > bound_ops_ms
            else "operations",
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms,
            "shape": [nz + 2, ncol], "warps_per_block": geom.warps,
            "smem_bytes": geom.smem, "kref": geom.kref, "registers": regs,
            "warps_per_sm": (None if regs is None
                             else warps_per_sm(regs, geom.warps, geom.smem)),
            **extra})
    emit({"phase": "kernel_times", "card": name, "rows": rows})
    return rows


def phase_trace(model, st, prm, frc, nt, name):
    """torch.profiler over one full step and one prognostic step at the
    main-path width: device time by kernel name and the share of the
    window (first host event to last device event) the device was idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, frc = run_steps(model, st, prm, frc, nt, 1, True)
        st, frc = run_steps(model, st, prm, frc, nt + 1, 1, False)
        sync()
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in evs
           if e.device_type == cuda]
    if not dev:
        raise AssertionError("the profiler recorded no device time")
    host = [e.time_range.start for e in evs if e.device_type != cuda]
    t0 = min(host + [d[0] for d in dev])
    t1 = max(d[1] for d in dev)
    busy, end = 0.0, t0
    for a, b, _ in sorted(dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for a, b, n in dev:
        n = n[:120]
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    kpp_ms = sum(v for k, v in by_name.items() if "kpp::" in k)
    emit({"phase": "trace", "card": name, "steps": ["full", "prognostic"],
          "window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
          "device_idle_share": 1.0 - busy / (t1 - t0),
          "kernel_ms_kpp": kpp_ms,
          "kernel_ms_other": sum(by_name.values()) - kpp_ms,
          "device_launches": len(dev), "device_ms_by_kernel": top})


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import mckpp_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (mckpp_torch not "
              "found)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    name, smi, ptxas = phase_device()
    phase_gate()
    model, st, prm, frc, nt, counts = phase_main(name, smi)
    del model
    caps = phase_compare(st, prm, frc, nt)
    rows = phase_times(caps, counts, name, ptxas)
    phase_trace(build(NCOL_MAIN, NZ_MAIN, land=LAND_SHARE)[0], st, prm, frc,
                nt, name)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
