#!/usr/bin/env python3
"""Drive mckpp_torch's main path on one CUDA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py

Phases, each printing JSON lines; any breach raises, so the script exits
0 only when every phase passed:

1. device: card name, power limit, versions; build the CUDA kernels in
   the col_lanes layout (one library per dtype and number of level
   slots a lane carries: 3 for nz + 2 <= 96, 4 for <= 128, 6 for <= 192,
   8 for <= 256; one per dtype of a column over several warps, "cw", for
   <= 1024; and one per dtype of a column over a cluster of blocks,
   "cl", for <= 8192; twelve nvcc processes at once) and print each
   one's ptxas table; then the clusters the card holds at once
   (cudaOccupancyMaxActiveClusters) at each cluster geometry of nz =
   1023, 2046, 3070 and 8190; then start the same twelve libraries'
   z_lanes build (``pass_layout="z_lanes"``, profiles (ncol, nz + 2))
   on a thread, so that nvcc runs while the card runs the gate;
2. kernel gate: each kernel against its plain torch version on the same
   float32 inputs at several (ncol, nz) shapes and flag sets (ragged last
   blocks, and one block mixing a land column, a column the instability
   trap retries and columns whose pass counts differ; columns mixing
   below level 32), plus one float64 instantiation; then the 4-slot
   kernels: nz = 100 in float32 and float64 at 37 columns with the
   default flags and with double diffusion, nz = 126 (WZ = 128) in
   float32, a deep-mixing case at nz = 100 whose kmix reaches below
   level 64, float64 at nz = 100 with aref kept whole (a block of 4
   warps), each at the same bar; then past 126 levels (6 and 8 slots):
   nz = 127, 190 and 254 in float32 and float64 on a uniform and a
   stretched grid (dscale 5) at 37 columns with land, double diffusion
   in one case, float64 at 254 stretched with aref read from device
   memory, a mixed block at nz = 127 (land, a trap column, uneven pass
   counts), a deep-mixing case at nz = 254 whose kmix reaches below level
   128, each at the same bar; then past 254 levels (a column over 3 to 8
   warps): nz = 255, 383 and 1022 in float32 and float64 on a uniform
   and a stretched grid at 37 columns with land, double diffusion in one
   case, a mixed block at nz = 300 (9 columns: land, a trap column,
   uneven pass counts), a deep-mixing case at nz = 1022 whose kmix
   reaches below level 128 (past the first warp), each at the same bar;
   nz = 511 under pass_impl "auto" runs the step kernel; then past 1022
   levels (a column over a cluster of 2 to 8 blocks): nz = 1023, 2046
   and 3070 in float32 and float64 on a uniform and a stretched grid at
   2 m levels (dmax = 2 nz) at 37 columns with land, double diffusion in
   one case, and nz = 8190 (8 blocks) in float32 on a uniform grid over
   8000 m; a mixed block at nz = 1100 (9 columns over 2200 m: land, a
   trap column, uneven pass counts); a deep-mixing case at nz = 1100 over
   80 m whose kmix crosses from block 0 into block 1 (past level 640),
   each at the same bar; nz = 8191 raises ValueError naming the 8192
   limit, and nz = 2046 under "auto" runs the cluster step kernel; then
   the z_lanes build joined, its ptxas tables and clusters printed, and
   in each spread (3, 4, 6 and 8 slots at nz = 69, 100, 190 and 254, a
   column over 4 and 8 warps at 510 and 1022, a cluster of 2 blocks at
   2046) and dtype the z_lanes kernels on a col_lanes launch's inputs
   transposed, every output equal to the col_lanes one transposed bit
   for bit, and at nz = 69 held to the z_lanes plain version at the
   same bar; "auto" in z_lanes at nz = 69 launches the step kernel once
   a step;
3. main path: the production ocean step (``KppModel.step``, pass_impl
   "cuda_step", with the full diagnostics pass on with_diags steps) at the
   TerraMaris width, ncol = 144,507 (453 x 319), nz = 69, ~12% land, with
   the flux update on its cadence, timed in both layouts in turns; then
   a few steps of the per-pass path ("cuda") in each, so every kernel
   runs in this phase in both layouts (each layout's counts set to 0
   before each of its runs and read after);
4. full-width comparisons, one step from the same state (the main path's,
   with seeded noise on T, S and u): "cuda_step" vs "eager_step" and
   "cuda" vs "cuda_step"; "cuda_step" and "cuda" in z_lanes equal to
   col_lanes in every state field, bit for bit;
5. each kernel at the main-path shape in both layouts, on the inputs the
   main path gave it: held to its plain version (the phase-2 bar), timed
   beside it and beside the card's bound;
6. a device trace (``torch.profiler``) of one full step and of one
   prognostic step at the main-path width in each layout: device time by
   kernel name, the device-idle share, the glue's device ms and
   launches, and the transposing host ops (z_lanes has none); then the
   CLI's chained run (``models/chain.py``, spans captured as CUDA graphs
   and replayed) at that width for 9 steps in each layout, every state
   field and written variable equal bit for bit;
7. the reference step (pass_impl "reference", plain torch, no kernel
   launched): float64 at 2,048 columns, Thomas + wscale table on the card
   against the CPU and PCR + nodal against "cuda_step", both within rtol
   1e-9 with the integer fields equal; float32 at the main-path width,
   Thomas + table against "cuda_step" with the nodal form, within
   BASELINE.md's float32 budget with kmix differing in at most 0.1% of
   the ocean columns; its ms per step beside "cuda_step"'s;
8. the CLI (``mckpp_torch.cli``) on the TerraMaris configuration at full
   width (inputs written by ``mckpp_torch.io.benchmark_inputs``): 24 steps
   chained through CUDA graphs, timed, its outputs held (finite over
   ocean, land at the fill value, hmix in [0, dmax]); the same steps
   through the per-step loop (``MCKPP_CHAIN=0``), equal bit for bit
   (every file and the restart written at the last step), and both again
   in the other order for the spread of the rates; 2k steps straight
   against k steps, a restart and k more, equal bit for bit; a trace of
   one replayed segment against the same steps run per step; every file
   written by the C++ encoder;
9. distributed: the same 24 steps as two ``--distributed`` processes
   sharing the card (``KPP_*`` rendezvous, gloo), single writer and shard
   mode (merged by ``python -m mckpp_torch.tools.merge_shards``), each
   equal bit for bit to phase 8's graph-chained run, every rank launching
   the step kernel and the full pass, gathers counted; ``--multi-device``
   (one worker a card) on the resume check's 12-step straight run, equal
   bit for bit to it; a 4-member ensemble (578,028 columns) stepped 3
   times, member 0 equal bit for bit to the single run; one full-width
   ``output_kpp_all`` window encoded by the C++ encoder and by scipy,
   timed;
10. configs: the other four BASELINE.json configurations at full width
   in float32, 9 steps each (one 3-h ``output_kpp_all`` window), through
   the runner ``mckpp_torch.tools.run_baseline_benchmarks``:
   single_column (nz = 100, the 4-slot kernels), regional_64x64 and
   global_1deg through the CLI, ensemble10_dd as 10 members (648,000
   columns); each with its five stream files, outputs held as in phase
   8, the step kernel launched, rates, timers and peak memory printed,
   and each kernel the run launched held to its plain version on the
   inputs of its first launch in that run (the phase-2 bar), timed
   beside it and its bound, with that run's launch counts;
   global_1deg once more under ``--profile``, its trace digested by
   ``mckpp_torch.tools.summarize_trace`` (idle share, kpp ms, the step
   kernel named); ``mckpp_torch.tools.bench_scaling`` at 1 and 2 ranks
   of 64,800 columns on the card (labelled time-shared); then the 4-slot
   kernels timed at nz = 100 on 16,384 columns against their plain
   versions and bounds;
11. deep main path: the step alone at the TerraMaris width at nz = 150
   (6 slots), 254 (8 slots) and 510 (a column over 4 warps), at nz = 1022
   (8 warps) on 16,384 columns over 2000 m and at nz = 2046 (a cluster
   of 2 blocks of 8 warps) on 16,384 columns over 4000 m, then in
   z_lanes at nz = 510 and 2046, float32, counts from 0 over a few steps
   of both
   paths, each kernel held to its plain version and timed beside its
   bound, the phase's peak device memory;
   then three deep single columns (250 levels of 1 m, 1000 levels of 2 m
   over 2000 m and 2000 levels of 2 m over 4000 m) through the CLI for a
   model day each in float32, outputs held, and a few steps in float64
   with the kernels against the plain step body on the same card (1e-10
   of each field's scale, kmix equal), the CPU's run reported beside (the
   1000- and 2000-level columns' only);
12. one model day (72 steps) of the CLI when the script has used less
   than ``CLI_DAY_BEFORE_S``.

Every phase line carries ``t_s``, the seconds since the script started.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the mckpp_torch package beside it, the script exits non-zero.
"""

import contextlib
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


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase line also carries ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def sync():
    import torch
    if torch.cuda.is_available():
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
          boundary=None, noise=0.0, seed=0, land=0.0, big=(), dmax=1000.0,
          device=None, dscale=0.0, cold=(), layout="col_lanes"):
    """``land``: a share of land columns drawn at random, or a tuple of
    land column indices; ``big``: columns given large T and u noise;
    ``cold``: columns 15 C colder below level nz // 2, a jump the
    instability trap flags on every attempt (a stable one, so each
    attempt's passes converge); ``device``: the model's (default cuda);
    ``dscale`` > 0: a stretched vertical grid; ``layout``: the kernels'
    ``pass_layout``, "col_lanes" or "z_lanes"."""
    import numpy as np
    import torch
    import mckpp_torch as T
    from mckpp_torch import forcing as forcing_mod
    from mckpp_torch.grid import coriolis
    from mckpp_torch.state import init_params

    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=dmax,
                              l_stretchgrid=dscale > 0, dscale=dscale),
        time=T.TimeConfig(dtsec=3600.0, ndtocn=3, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(pass_impl=pass_impl, pass_layout=layout,
                               **(physics or {})),
        boundary=T.BoundaryConfig(**(boundary or {})),
        dtype=dtype)
    model = T.KppModel(cfg, device=device)     # cuda unless told
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
    for col in cold:
        t0[col, nz // 2:] -= 15.0
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
    active (the inputs the main path gives each kernel); a launch inside
    a CUDA graph capture is passed over (its inputs are not yet
    written), as is any later launch of a kernel already recorded."""

    def __init__(self):
        from mckpp_torch.ops import cuda_kernels as ck
        self.ck = ck
        self.calls = []

    def __enter__(self):
        ck = self.ck
        self.orig = (ck.FusedPass.launch, ck.FusedStep.launch)
        calls = self.calls
        import torch

        def wrap(fn):
            def launch(w, *a, **kw):
                if all(c[0].name != w.name for c in calls) and \
                        not torch.cuda.is_current_stream_capturing():
                    calls.append((w, tuple(x.clone() for x in a)))
                return fn(w, *a, **kw)
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
# the kernels' layouts (pass_layout), by zaxis
LAYOUTS = ("col_lanes", "z_lanes")


def zaxis_of(w):
    """The layout of wrapper ``w``: 0 col_lanes, 1 z_lanes."""
    return w.kw.get("zaxis", 0)


def col_major(w, outs):
    """``w``'s outputs in the col_lanes orientation ((rows, ncol) views;
    z_lanes' transposed)."""
    return [o.T for o in outs] if zaxis_of(w) else list(outs)


def z_lanes_of(w, a):
    """The z_lanes twin of col_lanes wrapper ``w`` and its inputs ``a``
    as the twin takes them (every array transposed: aref then as
    build_ref_matrix makes it, ``prof @ aref``)."""
    return type(w)(dict(w.kw, zaxis=1)), tuple(x.T.contiguous() for x in a)


def compare(w, got, ref, tol):
    """Max relative difference over the float outputs; the integer rows
    must be equal."""
    got, ref = col_major(w, got), col_major(w, ref)
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


def distance(w, got, ref):
    """The distance of two results, reported and not held: the max
    relative difference over the float outputs and the columns whose
    integer rows differ."""
    got, ref = col_major(w, got), col_major(w, ref)
    pos, rows = INT_ROWS[w.name]
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
              for a, b in zip(got, ref))
    cols = int((got[pos][list(rows)] != ref[pos][list(rows)]).any(0).sum())
    return {"max_rel": rel, "int_columns_differ": cols}


def ulp_shifted(w, a):
    """A kernel's inputs with T (the profile and its iterate) scaled by
    1 + 4.5 eps of its dtype (1e-15 in float64, 5.4e-7 in float32), as
    the port's tests calibrate the rounding spread."""
    from mckpp_torch.ops import cuda_kernels as ck
    import torch
    a = list(a)
    rel = 4.5 * torch.finfo(a[0].dtype).eps
    for i in ((2, 6) if isinstance(w, ck.FusedStep) else (2, 6, 10)):
        a[i] = a[i] * (1.0 + rel)
    return tuple(a)


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


# the cluster geometries whose occupancy phase 1 prints: 2 blocks of 5
# and of 8 warps, 3 and 8 blocks of 8
CL_OCCUPANCY_NZ = (1023, 2046, 3070, 8190)


def ptxas_tables(reports):
    """{"float32/ns3": table, ..., "float64/cl_zl": table} of a build's
    reports: one library per dtype, layout and level slots: "ns3" (nz + 2
    <= 96), "ns4" (<= 128), ..., "cw" (a column over several warps, <=
    1024), "cl" (a cluster, <= 8192), "_zl" for the z_lanes build."""
    from mckpp_torch.ops import cuda_kernels as ck
    return {f"{str(dt).replace('torch.', '')}/{ck._lib_tag(lib, z)}":
            ptxas_table(log) for (dt, lib, z), log in reports.items()}


def cluster_rows(zaxis):
    """The clusters of each cluster geometry the card holds at once
    (cudaOccupancyMaxActiveClusters; 0 would refuse every launch), in
    layout ``zaxis``."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    rows = []
    for dt in (torch.float32, torch.float64):
        for nz in CL_OCCUPANCY_NZ:
            g = ck.launch_geometry(nz, dt, 16_384)
            held = {k: ck.max_clusters(dt, g, k, zaxis) for k in REPLACES}
            rows.append({"nz": nz, "dtype": str(dt).replace("torch.", ""),
                         "layout": LAYOUTS[zaxis],
                         "blocks_per_cluster": g.cb,
                         "warps_per_block": g.cw, "smem_bytes": g.smem,
                         "max_active_clusters": held})
            if min(held.values()) < 1:
                raise AssertionError(f"the card holds no cluster: {rows[-1]}")
    return rows


class Background:
    """``fn()`` run on a thread (a build, whose nvcc processes run while
    the card runs the gate); :meth:`result` joins it and returns its
    value, or raises what it raised, with its seconds."""

    def __init__(self, fn):
        import threading
        self.out, self.t0 = {}, time.perf_counter()

        def run():
            try:
                self.out["value"] = fn()
            except Exception as e:              # raised again by result()
                self.out["error"] = e
            self.out["seconds"] = time.perf_counter() - self.t0
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self):
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["value"], self.out["seconds"]


def phase_device():
    """Build the col_lanes libraries (twelve nvcc processes at once),
    print their ptxas tables and the clusters the card holds; then start
    the z_lanes build (twelve more) on a thread: :func:`gate_zlanes`
    joins it and prints its tables."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    ptxas = ptxas_tables(ck.build(zaxes=(0,)))
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "layout": "col_lanes", "seconds": build_s,
          "ptxas": ptxas})
    zl_build = Background(lambda: ck.build(zaxes=(1,)))
    emit({"phase": "clusters", "rows": cluster_rows(0)})
    return name, smi, ptxas, zl_build


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


def gate_case(ncol, nz, dtype, flags, tol, seed, land=0.1, big=(), warm=2,
              cold=(), serial_above=None, report=True):
    """Each kernel against its plain version on the inputs of step
    warm+1 (``cold``: see :func:`build`); returns ({kernel: max rel}, the
    plain step's colstep, the step launch's geometry).  Where aref's rows
    reach past ``serial_above`` entries, the kernels are held to the plain
    version with the reference averages summed in their order
    (:func:`plain_serial`) and the distance to the plain version itself
    (cuBLAS's order) is reported as ``<kernel>/plain``, beside the
    plain version's own distance from itself on inputs perturbed by a few
    ulp (:func:`ulp_shifted`), ``<kernel>/plain_spread``: the model's own
    sensitivity to rounding at those inputs (:func:`distance`); those two
    reports only with ``report`` (one case a family: they cost two more
    plain steps)."""
    from mckpp_torch.ops import cuda_kernels as ck
    out, colstep, geom = {}, None, None
    for impl in ("cuda", "cuda_step"):
        model, st, prm, frc = build(ncol, nz, dtype, impl, noise=0.05,
                                    seed=seed, land=land, big=big, cold=cold,
                                    **flags)
        st, frc = run_steps(model, st, prm, frc, 1, warm)
        with Capture() as cap:
            run_steps(model, st, prm, frc, warm + 1, 1)
        names = (("fused_pass_fast", "fused_pass_full") if impl == "cuda"
                 else ("fused_step",))
        for name in names:
            w, a = cap.first(name)
            got = w.launch(*a)
            kref = ck._ref_extents(a[-1])[1]
            serial = serial_above is not None and kref > serial_above
            if serial and not report:
                ref = plain_serial(w, a)
            else:
                ref = plain_of(w, a)
            if serial and report:
                out[name + "/plain"] = distance(w, got, ref)
                out[name + "/plain_spread"] = distance(
                    w, plain_of(w, ulp_shifted(w, a)), ref)
                ref = plain_serial(w, a)
            sync()
            out[name] = compare(w, got, ref, tol)
            if name == "fused_step":
                colstep = ref[8]
                geom = ck.launch_geometry(nz, a[0].dtype, ncol,
                                          ck._ref_extents(a[-1])[1])
    return out, colstep, geom


def gate_mixed_block():
    """One 8-column block (one launch block) that mixes a land column, a
    column the instability trap retries (comp_flag = 1 after 11 attempts)
    and columns whose pass counts differ by >= 3 (large T and u noise on
    columns 1 and 6)."""
    import torch
    res, cs, _ = gate_case(8, 69, "float32", GATE_FLAGS["default_analytic"],
                           TOL_F32, 0, land=(3,), big=(1, 6), warm=0)
    hold_mixed_block(cs)
    emit({"phase": "gate", "ncol": 8, "nz": 69, "flags": "mixed_block",
          "dtype": "float32", "max_rel": res, "npass": cs[7].tolist(),
          "comp_flag": cs[4].tolist(), "reset": cs[5].tolist()})
    return res


def hold_mixed_block(cs):
    """The mixed block's plain colstep has its cases: column 3 land (no
    pass), a column the trap retried, pass counts apart by >= 3."""
    import torch
    active = torch.ones(cs.shape[1], dtype=torch.bool, device=cs.device)
    active[3] = False
    npass = cs[7][active]
    trapped = int(((cs[4] > 0.5) & (cs[5] >= 2) & active).sum())
    spread = float(npass.max() - npass.min())
    if cs[7][3] != 0 or trapped == 0 or spread < 3:
        raise AssertionError(f"mixed block lacks its cases: npass "
                             f"{cs[7].tolist()}, comp {cs[4].tolist()}, "
                             f"reset {cs[5].tolist()}")


class serial_matmul:
    """Within it, ``torch.matmul`` (the plain versions' one matmul, the
    reference averages ``aref @ prof``) sums as the kernels sum: term by
    term in k order, each product and each sum rounded on its own
    (cuBLAS fuses and orders them its own way).  The terms past aref's
    last nonzero column are exact zeros and are skipped, as the kernels
    skip them.  The products of ``chunk`` terms come from one launch (each
    still rounded once), and the sums from one launch a term.  On the
    card the launches of each (shapes, dtype, number of terms) are
    captured once as a CUDA graph and replayed on copies of the inputs:
    the same kernels in the same order, so the same bits, without the
    host's dispatch of one launch a term (where the gate's deep cases
    spent most of their time)."""

    chunk = 64
    # (a's shape, b's shape, dtype, device, terms) -> (graph, a, b, sum)
    graphs = {}

    @classmethod
    def terms_sum(cls, a, b, kref):
        import torch
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=b.dtype,
                          device=b.device)
        for k0 in range(0, kref, cls.chunk):
            k1 = min(k0 + cls.chunk, kref)
            terms = a[:, k0:k1, None] * b[None, k0:k1]
            for k in range(k1 - k0):
                acc = acc + terms[:, k]
        return acc

    @classmethod
    def replayed(cls, a, b, kref):
        import torch
        key = (tuple(a.shape), tuple(b.shape), b.dtype, b.device, kref)
        hit = cls.graphs.get(key)
        if hit is None:
            sa, sb = a.clone(), b.clone()
            cls.terms_sum(sa, sb, kref)            # warm-up, outside
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = cls.terms_sum(sa, sb, kref)
            hit = cls.graphs[key] = (graph, sa, sb, out)
        graph, sa, sb, out = hit
        sa.copy_(a)
        sb.copy_(b)
        graph.replay()
        return out.clone()

    def __enter__(self):
        import torch
        self.matmul = torch.matmul

        def serial(a, b):
            nonzero = (a != 0).any(dim=0).nonzero()
            kref = int(nonzero.max()) + 1 if len(nonzero) else 0
            if b.device.type != "cuda" or \
                    torch.cuda.is_current_stream_capturing():
                return self.terms_sum(a, b, kref)
            return self.replayed(a, b, kref)
        torch.matmul = serial
        return self

    def __exit__(self, *exc):
        import torch
        torch.matmul = self.matmul


def plain_serial(w, args):
    """The plain version with the reference averages summed as the
    kernels sum them (:class:`serial_matmul`)."""
    with serial_matmul():
        return plain_of(w, args)


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


def gate_deep(nz=94, dmax=120.0, below=32, plain_cases=("stratified",)):
    """Columns whose boundary layer reaches below level ``below``, so
    bldepth searches past the first lane slot (nz = 94 over 120 m: kmix
    past 32; nz = 100 over 60 m, the 4-slot kernels: kmix past 64), on
    the first step's inputs made to mix deep (:func:`deepened`),
    stratified and neutral.  On both, each kernel is held to the plain version with
    serially summed reference averages (:func:`plain_serial`); on the
    ``plain_cases``, to the plain version itself too.  Rib at the neutral
    columns turns on the last ulp of the reference averages, which cuBLAS
    rounds otherwise, so there the distance to the plain version is
    reported, not held; at nz = 100 over 60 m (0.6 m levels, 0.003 C a
    level) the stratified columns turn on it too.  With no
    ``plain_cases`` the plain version itself is not run."""
    out, kmix = {}, {}
    for impl in ("cuda", "cuda_step"):
        model, st, prm, frc = build(16, nz, "float32", impl, dmax=dmax)
        with Capture() as cap:
            run_steps(model, st, prm, frc, 1, 1)
        names = (("fused_pass_fast", "fused_pass_full") if impl == "cuda"
                 else ("fused_step",))
        for name in names:
            w, a = cap.first(name)
            for case in ("neutral", "stratified"):
                x = deepened(w, a, case == "stratified")
                got = w.launch(*x)
                ser = plain_serial(w, x)
                refs = [("plain_serial", ser)]
                if plain_cases:
                    refs.insert(0, ("plain", plain_of(w, x)))
                sync()
                res = {}
                for key, r in refs:
                    try:
                        res[key] = compare(w, got, r, TOL_F32)
                    except AssertionError as e:
                        res[key] = str(e)
                out[(name, case)] = res
                if name == "fused_step":
                    kmix[case] = ser[8][1].tolist()
    emit({"phase": "gate", "ncol": 16, "nz": nz, "flags": "deep_mixing",
          "dtype": "float32", "kmix": kmix,
          "max_rel": {f"{n}/{c}": r for (n, c), r in out.items()}})
    for (name, case), r in out.items():
        for key in (("plain", "plain_serial") if case in plain_cases
                    else ("plain_serial",)):
            if isinstance(r[key], str):
                raise AssertionError(f"deep {case}: {r[key]} against {key}")
    if not any(k > below for k in kmix["stratified"]):
        raise AssertionError(f"deep case: no kmix below level {below}")
    return {n: max(v for v in r.values() if not isinstance(v, str))
            for (n, c), r in out.items() if c == "stratified"}


# the 4-slot kernels (nz + 2 > 96): single_column's nz = 100 at a ragged
# column count, default flags and double diffusion, both dtypes; and the
# most levels they take, nz = 126 (WZ = 128)
GATE_NS4 = [(37, 100, "float32", "default_analytic"), (37, 100, "float32", "ldd"),
            (37, 100, "float64", "default_analytic"), (37, 100, "float64", "ldd"),
            (37, 126, "float32", "default_analytic")]


def dense_aref(a):
    """A step's or pass's inputs with aref made a running mean over every
    level above (row n averages levels 0..n, rows from nz on zero), so
    the reference averages keep aref's widest prefix in shared memory."""
    import torch
    a = list(a)
    wz = a[-1].shape[0]
    nz = wz - 2
    n = torch.arange(wz, dtype=a[-1].dtype, device=a[-1].device)
    rows = torch.tril(torch.ones_like(a[-1])) / (n[:, None] + 1.0)
    rows[nz:] = 0.0
    a[-1] = rows.contiguous()
    return tuple(a)


def gate_wide_aref():
    """float64 at nz = 100 with aref kept whole (:func:`dense_aref`): the
    shared memory of 8 warps does not fit, so the launch takes a block of
    4; each kernel held to the plain version with the reference averages
    summed serially (:func:`plain_serial`: a dense aref is where cuBLAS's
    order of the sums shows), and the distance to the plain version
    reported."""
    from mckpp_torch.ops import cuda_kernels as ck
    out, warps = {}, None
    for impl in ("cuda", "cuda_step"):
        model, st, prm, frc = build(37, 100, "float64", impl, noise=0.05,
                                    seed=7, land=0.1)
        with Capture() as cap:
            run_steps(model, st, prm, frc, 1, 1)
        names = (("fused_pass_fast", "fused_pass_full") if impl == "cuda"
                 else ("fused_step",))
        for kname in names:
            w, a = cap.first(kname)
            x = dense_aref(a)
            warps = ck.launch_geometry(100, x[0].dtype, 37,
                                       ck._ref_extents(x[-1])[1]).warps
            got = w.launch(*x)
            ser, ref = plain_serial(w, x), plain_of(w, x)
            sync()
            out[kname] = compare(w, got, ser, TOL_F64)
            try:
                out[kname + "/plain"] = compare(w, got, ref, TOL_F64)
            except AssertionError as e:
                out[kname + "/plain"] = str(e)
    if warps != 4:
        raise AssertionError(f"the wide-aref case launched {warps} warps a "
                             "block, not 4")
    emit({"phase": "gate", "ncol": 37, "nz": 100, "flags": "wide_aref",
          "dtype": "float64", "warps_per_block": warps, "max_rel": out})
    return {k: v for k, v in out.items() if "/" not in k}


# past 126 levels, the 6- and 8-slot kernels: nz = 127, 190 and 254 in
# float32 and float64 on a uniform grid and a stretched one (dscale 5), 37
# columns with ~10% land; double diffusion at (190, float64, stretched);
# float64 at 254 on the stretched grid reads aref from device memory
DEEP_DSCALE = 5.0
GATE_DEEP = [(nz, dt, ds) for nz in (127, 190, 254)
             for dt in ("float32", "float64") for ds in (0.0, DEEP_DSCALE)]
ONE_WARP_NZ = 254       # the most levels one warp a column takes (WZ = 256)
# past 254 levels, a column over several warps: the first nz of 3 and of 4
# warps and the last of 8 (WZ = 1024), both dtypes, both grids; double
# diffusion at (383, float64, stretched)
GATE_MW = [(nz, dt, ds) for nz in (255, 383, 1022)
           for dt in ("float32", "float64") for ds in (0.0, DEEP_DSCALE)]
MW_MAXNZ = 1022         # the most levels one block takes (WZ = 1024)
# aref rows longer than this (the stretched grid at nz = 383 and 1022:
# kref 149 and 402) are summed by cuBLAS in its own order, which moves the
# reference averages by an ulp and, through the hmix loop, kmix: there
# the kernels are held to the serial-sum plain version, and (at one case
# a family: nz = 1022 float32 and, past it, 2046 float64, both stretched)
# the distance to the plain version itself is reported beside the plain
# version's own spread under a few ulp of T
SERIAL_ABOVE = 128


def take_worst(worst, dtype, res):
    """Fold one case's {kernel: max rel} into ``worst[dtype]`` (the
    reported distances, keyed ``<kernel>/plain``, are not held)."""
    for k, v in res.items():
        if "/" not in k:
            worst[dtype][k] = max(worst[dtype].get(k, 0.0), v)


def gate_levels():
    """The kernels past 126 levels, each case held at the phase-2 bar on
    the first step's inputs, with the level slots, warps and aref
    placement its step launch took; the mixed block (a land column, a
    column the trap retries and uneven pass counts) at nz = 127; the
    deep-mixing inputs at nz = 254 over 100 m (kmix past level 128)
    against the serial-sum plain version.  Returns ({kernel: worst f32},
    {kernel: worst f64}, the number of cases)."""
    worst = {"float32": {}, "float64": {}}

    for i, (nz, dtype, dscale) in enumerate(GATE_DEEP):
        fname = "ldd" if (nz, dtype, dscale) == (190, "float64",
                                                 DEEP_DSCALE) \
            else "default_analytic"
        flags = dict(GATE_FLAGS[fname], dscale=dscale)
        tol = TOL_F32 if dtype == "float32" else TOL_F64
        res, _, g = gate_case(37, nz, dtype, flags, tol, 70 + i, warm=0)
        want_dev = int(dtype == "float64" and nz == 254 and dscale > 0)
        if g.ns != (6 if nz <= 190 else 8) or g.aref_dev != want_dev:
            raise AssertionError(f"nz = {nz} {dtype} dscale {dscale}: "
                                 f"{g.ns} slots, aref_dev {g.aref_dev}")
        emit({"phase": "gate", "ncol": 37, "nz": nz, "flags": fname,
              "dtype": dtype, "dscale": dscale, "level_slots": g.ns,
              "warps_per_block": g.warps, "kref": g.kref,
              "aref": "device" if g.aref_dev else "shared",
              "max_rel": res})
        take_worst(worst, dtype, res)
    res, cs, g = gate_case(8, 127, "float32", GATE_FLAGS["default_analytic"],
                           TOL_F32, 1, land=(3,), big=(6,), cold=(1,),
                           warm=0)
    hold_mixed_block(cs)
    emit({"phase": "gate", "ncol": 8, "nz": 127, "flags": "mixed_block",
          "dtype": "float32", "level_slots": g.ns, "max_rel": res,
          "npass": cs[7].tolist(), "comp_flag": cs[4].tolist(),
          "reset": cs[5].tolist()})
    take_worst(worst, "float32", res)
    take_worst(worst, "float32",
               gate_deep(ONE_WARP_NZ, 100.0, 128, plain_cases=()))
    return worst["float32"], worst["float64"], len(GATE_DEEP) + 2


def gate_multiwarp():
    """The kernels past 254 levels, a column over ceil((nz + 2) / 128)
    warps: each case of ``GATE_MW`` held at the phase-2 bar on the first
    step's inputs (to the serial-sum plain version where aref's rows pass
    ``SERIAL_ABOVE`` entries; the distance to cuBLAS's order reported at
    nz = 1022 float32 stretched), with the warps, grid-row and aref
    placement its step launch took; the mixed block at nz = 300 (9
    columns: land, a column the trap retries, uneven pass counts); the
    deep-mixing inputs at
    nz = 1022 over 250 m (kmix past level 128, the first warp's last)
    against the serial-sum plain version; then ``auto`` at nz = 511
    running the step kernel once.  Returns ({kernel: worst f32},
    {kernel: worst f64}, the number of cases)."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    worst = {"float32": {}, "float64": {}}

    for i, (nz, dtype, dscale) in enumerate(GATE_MW):
        fname = "ldd" if (nz, dtype, dscale) == (383, "float64",
                                                 DEEP_DSCALE) \
            else "default_analytic"
        flags = dict(GATE_FLAGS[fname], dscale=dscale)
        tol = TOL_F32 if dtype == "float32" else TOL_F64
        res, _, g = gate_case(37, nz, dtype, flags, tol, 90 + i, warm=0,
                              serial_above=SERIAL_ABOVE,
                              report=(nz, dtype, dscale) == (
                                  MW_MAXNZ, "float32", DEEP_DSCALE))
        cw = -(-(nz + 2) // 128)
        want_grid = int(dtype == "float64" and cw == 8)
        if (g.cw, g.ns, g.aref_dev, g.grid_dev) != (cw, 4, 1, want_grid):
            raise AssertionError(f"nz = {nz} {dtype} dscale {dscale}: "
                                 f"{g.cw} warps, {g.ns} slots, aref_dev "
                                 f"{g.aref_dev}, grid_dev {g.grid_dev}")
        emit({"phase": "gate", "ncol": 37, "nz": nz, "flags": fname,
              "dtype": dtype, "dscale": dscale, "warps_per_column": g.cw,
              "level_slots": g.ns, "kref": g.kref, "smem_bytes": g.smem,
              "grid_rows": "device" if g.grid_dev else "shared",
              "max_rel": res})
        take_worst(worst, dtype, res)
    res, cs, g = gate_case(9, 300, "float32", GATE_FLAGS["default_analytic"],
                           TOL_F32, 2, land=(3,), big=(6,), cold=(1,),
                           warm=0)
    hold_mixed_block(cs)
    emit({"phase": "gate", "ncol": 9, "nz": 300, "flags": "mixed_block",
          "dtype": "float32", "warps_per_column": g.cw, "max_rel": res,
          "npass": cs[7].tolist(), "comp_flag": cs[4].tolist(),
          "reset": cs[5].tolist()})
    take_worst(worst, "float32", res)
    take_worst(worst, "float32",
               gate_deep(MW_MAXNZ, 250.0, 128, plain_cases=()))
    # nz = 511 under pass_impl "auto": the whole-step kernel, 5 warps
    model, st, prm, frc = build(37, 511, "float32", "auto")
    ck.reset_counts()
    st, frc = run_steps(model, st, prm, frc, 1, 1, with_diags=False)
    sync()
    if model.pass_impl != "cuda_step" or ck.LAUNCHES["fused_step"] != 1 \
            or not torch_all_finite(st):
        raise AssertionError(f"nz = 511, auto: {model.pass_impl}, "
                             f"{ck.LAUNCHES}")
    emit({"phase": "gate", "nz": 511, "nz511_auto": model.pass_impl,
          "nz511_auto_launches": dict(ck.LAUNCHES)})
    return worst["float32"], worst["float64"], len(GATE_MW) + 2


# past 1022 levels, a column over a cluster of blocks: the first nz of 2
# blocks (5 warps each), 2 and 3 blocks of 8 warps, both dtypes, both
# grids, at 2 m levels on the uniform grid (dmax = 2 nz, where the hmix
# loop converges, as at the 1000-level column) and as deep on the
# stretched one; double diffusion at (2046, float64, stretched); and the
# most levels, nz = 8190 (8 blocks of 8 warps), in float32 on a uniform
# grid over 8000 m: (nz, dtype, dscale, dmax)
GATE_CL = [(nz, dt, ds, 2.0 * nz) for nz in (1023, 2046, 3070)
           for dt in ("float32", "float64") for ds in (0.0, DEEP_DSCALE)] \
    + [(8190, "float32", 0.0, 8000.0)]
MAXNZ = 8190            # the most levels the kernels take (WZ = 8192)
# the cluster's mixed block and deep-mixing case: 2 blocks of 5 warps,
# 640 levels each
CL_MIXED_NZ = 1100


def gate_cluster():
    """The kernels past 1022 levels, a column over a cluster of
    ceil((nz + 2) / 1024) blocks: each case of ``GATE_CL`` held at the
    phase-2 bar on the first step's inputs (to the serial-sum plain
    version where aref's rows pass ``SERIAL_ABOVE`` entries; the distance
    to cuBLAS's order reported at nz = 2046 float64 stretched), with the
    blocks, warps and shared memory its step launch took; the mixed block
    at nz = 1100 over 2200 m (9 columns: land, a column the trap retries,
    uneven pass counts); the deep-mixing inputs at nz = 1100 over 80 m
    (kmix past level 640, block 0's last) against the serial-sum plain
    version; then nz = 8191 raising ValueError naming 8192 from the
    geometry, the pass wrapper and a model step, and ``auto`` at nz =
    2046 running the cluster step kernel once.  Returns ({kernel: worst
    f32}, {kernel: worst f64}, the number of cases)."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    worst = {"float32": {}, "float64": {}}

    for i, (nz, dtype, dscale, dmax) in enumerate(GATE_CL):
        fname = "ldd" if (nz, dtype, dscale) == (2046, "float64",
                                                 DEEP_DSCALE) \
            else "default_analytic"
        flags = dict(GATE_FLAGS[fname], dscale=dscale, dmax=dmax)
        tol = TOL_F32 if dtype == "float32" else TOL_F64
        res, _, g = gate_case(37, nz, dtype, flags, tol, 110 + i, warm=0,
                              serial_above=SERIAL_ABOVE,
                              report=(nz, dtype, dscale) == (
                                  2046, "float64", DEEP_DSCALE))
        cb = -(-(nz + 2) // 1024)
        cw = -(-(nz + 2) // (128 * cb))
        if (g.cb, g.cw, g.ns, g.aref_dev, g.grid_dev) != (cb, cw, 4, 1, 1):
            raise AssertionError(f"nz = {nz} {dtype} dscale {dscale}: "
                                 f"{g.cb} blocks of {g.cw} warps, {g.ns} "
                                 f"slots, aref_dev {g.aref_dev}, grid_dev "
                                 f"{g.grid_dev}")
        emit({"phase": "gate", "ncol": 37, "nz": nz, "flags": fname,
              "dtype": dtype, "dscale": dscale, "dmax": dmax,
              "blocks_per_cluster": g.cb, "warps_per_block": g.cw,
              "level_slots": g.ns, "kref": g.kref, "smem_bytes": g.smem,
              "max_rel": res})
        take_worst(worst, dtype, res)
    res, cs, g = gate_case(9, CL_MIXED_NZ, "float32",
                           dict(GATE_FLAGS["default_analytic"], dmax=2200.0),
                           TOL_F32, 3, land=(3,), big=(6,), cold=(1,),
                           warm=0)
    hold_mixed_block(cs)
    emit({"phase": "gate", "ncol": 9, "nz": CL_MIXED_NZ,
          "flags": "mixed_block", "dtype": "float32",
          "blocks_per_cluster": g.cb, "warps_per_block": g.cw,
          "max_rel": res, "npass": cs[7].tolist(),
          "comp_flag": cs[4].tolist(), "reset": cs[5].tolist()})
    take_worst(worst, "float32", res)
    take_worst(worst, "float32",
               gate_deep(CL_MIXED_NZ, 80.0, 640, plain_cases=()))
    raised = []
    try:
        ck.launch_geometry(MAXNZ + 1, torch.float32, 37)
    except ValueError as e:
        raised.append(str(e))
    for impl in ("cuda", "cuda_step"):      # the pass wrapper, the step
        model, st, prm, frc = build(37, MAXNZ + 1, "float32", impl,
                                    dmax=8000.0)
        try:
            run_steps(model, st, prm, frc, 1, 1)
        except ValueError as e:
            raised.append(str(e))
        del model, st, prm, frc
    if len(raised) != 3 or not all("8192" in r for r in raised):
        raise AssertionError(f"nz = 8191 did not raise naming 8192: {raised}")
    # nz = 2046 under pass_impl "auto": the whole-step kernel, 2 blocks
    model, st, prm, frc = build(37, 2046, "float32", "auto", dmax=4092.0)
    ck.reset_counts()
    st, frc = run_steps(model, st, prm, frc, 1, 1, with_diags=False)
    sync()
    g = ck.launch_geometry(2046, torch.float32, 37)
    if model.pass_impl != "cuda_step" or ck.LAUNCHES["fused_step"] != 1 \
            or g.lib != ck.CL or not torch_all_finite(st):
        raise AssertionError(f"nz = 2046, auto: {model.pass_impl}, "
                             f"{ck.LAUNCHES}, library {g.lib}")
    emit({"phase": "gate", "nz": MAXNZ + 1, "raises": raised,
          "nz2046_auto": model.pass_impl, "nz2046_auto_library": g.lib,
          "nz2046_auto_launches": dict(ck.LAUNCHES)})
    return worst["float32"], worst["float64"], len(GATE_CL) + 2


# the z_lanes gate, (nz, dscale, dmax): each spread of the kernels in both
# dtypes, one warp a column at 3, 4, 6 and 8 slots (float64 at 254 on the
# stretched grid reads aref from device memory), a column over 4 and over
# 8 warps (float64 at 8 reads the grid rows from device memory) and over a
# cluster of 2 blocks of 8 warps (2 m levels, as GATE_CL)
GATE_ZL = [(69, 0.0, 1000.0), (100, 0.0, 1000.0), (190, 0.0, 1000.0),
           (ONE_WARP_NZ, DEEP_DSCALE, 1000.0), (510, 0.0, 1000.0),
           (MW_MAXNZ, 0.0, 2044.0), (2046, 0.0, 4092.0)]
ZL_PLAIN_NZ = 69        # the case of each dtype also held to the plain


def gate_zlanes(ptxas, zl_build):
    """The z_lanes kernels: join the z_lanes build of phase 1, print its
    ptxas tables (added to ``ptxas``) and the clusters the card holds;
    then at each of ``GATE_ZL`` in float32 and float64, 37 columns (a
    ragged last block) with ~10% land, each kernel's first launch of a
    step in col_lanes (the fast and full pass from "cuda", the step from
    "cuda_step") launched again in z_lanes on its inputs transposed:
    every output equal to the col_lanes one transposed, bit for bit (the
    integer rows with them); at nz = ``ZL_PLAIN_NZ`` also held to the
    z_lanes plain version at the phase-2 bar.  Then "auto" in z_lanes at
    nz = 69 launches the step kernel once a step.  Returns ({kernel: worst
    f32}, {kernel: worst f64}, the number of cases)."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    reports, build_s = zl_build.result()
    tables = ptxas_tables(reports)
    ptxas.update(tables)
    emit({"phase": "build", "layout": "z_lanes", "seconds": build_s,
          "ptxas": tables})
    emit({"phase": "clusters", "rows": cluster_rows(1)})
    worst = {"float32": {}, "float64": {}}
    for dtype in ("float32", "float64"):
        tol = TOL_F32 if dtype == "float32" else TOL_F64
        for i, (nz, dscale, dmax) in enumerate(GATE_ZL):
            res, geoms = {}, {}
            for impl in ("cuda", "cuda_step"):
                model, st, prm, frc = build(37, nz, dtype, impl, noise=0.05,
                                            seed=130 + i, land=0.1,
                                            dscale=dscale, dmax=dmax)
                with Capture() as cap:
                    run_steps(model, st, prm, frc, 1, 1)
                for w, a in cap.calls:
                    wz, az = z_lanes_of(w, a)
                    got, ref = wz.launch(*az), w.launch(*a)
                    sync()
                    differ = [j for j, (x, y) in enumerate(zip(got, ref))
                              if not torch.equal(x, y.T)]
                    if differ:
                        raise AssertionError(
                            f"z_lanes {w.name} at nz = {nz} {dtype}: "
                            f"outputs {differ} differ from col_lanes")
                    res[w.name] = "equal"
                    if nz == ZL_PLAIN_NZ:
                        res[w.name + "/plain"] = compare(
                            wz, got, plain_of(wz, az), tol)
                        worst[dtype][w.name] = max(
                            worst[dtype].get(w.name, 0.0),
                            res[w.name + "/plain"])
                    g = ck.launch_geometry(nz, a[0].dtype, 37,
                                           ck._ref_extents(a[-1])[1])
                    geoms[w.name] = ck._lib_tag(g.lib, 1) + (
                        "/aref_dev" if g.aref_dev and g.cw == 1 else "") + (
                        "/grid_dev" if g.grid_dev and g.cb == 1 else "")
                del model, st, prm, frc, cap
            if set(res) & set(REPLACES) != set(REPLACES):
                raise AssertionError(f"z_lanes gate at nz = {nz}: {res}")
            emit({"phase": "gate", "layout": "z_lanes", "ncol": 37,
                  "nz": nz, "dtype": dtype, "dscale": dscale, "dmax": dmax,
                  "libraries": geoms, "vs_col_lanes_and_plain": res})
    model, st, prm, frc = build(37, NZ_MAIN, "float32", "auto",
                                layout="z_lanes")
    ck.reset_counts()
    st, frc = run_steps(model, st, prm, frc, 1, 2, with_diags=False)
    sync()
    if model.pass_impl != "cuda_step" or ck.LAUNCHES != {
            "fused_pass_fast": 0, "fused_pass_full": 0, "fused_step": 2} \
            or not torch_all_finite(st):
        raise AssertionError(f"z_lanes nz = 69, auto: {model.pass_impl}, "
                             f"{ck.LAUNCHES}")
    emit({"phase": "gate", "layout": "z_lanes", "nz": NZ_MAIN,
          "auto": model.pass_impl, "auto_launches_2_steps": dict(
              ck.LAUNCHES)})
    return worst["float32"], worst["float64"], 2 * len(GATE_ZL) + 1


def phase_gate(ptxas, zl_build):
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
    for res in (gate_mixed_block(), gate_deep(),
                gate_deep(100, 60.0, 64, plain_cases=())):
        for k, v in res.items():
            worst[k] = max(worst.get(k, 0.0), v)
    res = gate_case(300, 33, "float64", GATE_FLAGS["nodal"], TOL_F64, 99)[0]
    emit({"phase": "gate", "ncol": 300, "nz": 33, "flags": "nodal",
          "dtype": "float64", "max_rel": res})
    worst64 = dict(res)
    for i, (ncol, nz, dtype, fname) in enumerate(GATE_NS4):
        tol = TOL_F32 if dtype == "float32" else TOL_F64
        res = gate_case(ncol, nz, dtype, GATE_FLAGS[fname], tol, 50 + i)[0]
        emit({"phase": "gate", "ncol": ncol, "nz": nz, "flags": fname,
              "dtype": dtype, "max_rel": res})
        tgt = worst if dtype == "float32" else worst64
        for k, v in res.items():
            tgt[k] = max(tgt.get(k, 0.0), v)
    for k, v in gate_wide_aref().items():
        worst64[k] = max(worst64.get(k, 0.0), v)
    n_deep = 0
    for gate in (gate_levels, gate_multiwarp, gate_cluster,
                 lambda: gate_zlanes(ptxas, zl_build)):
        deep32, deep64, n_cases = gate()
        n_deep += n_cases
        for tgt, res in ((worst, deep32), (worst64, deep64)):
            for k, v in res.items():
                tgt[k] = max(tgt.get(k, 0.0), v)
    emit({"phase": "gate_ok", "cases": n + 5 + len(GATE_NS4) + n_deep,
          "worst_f32": worst, "worst_f64": worst64})
    return worst


def phase_main(name, smi):
    """The main path in both layouts, on one state: ``KppModel.step``
    ("cuda_step") timed in blocks of 4 steps, full then prognostic, the
    two layouts in turns (col_lanes first in even blocks, z_lanes in odd
    ones); then 2 steps of the per-pass path ("cuda") in each.  Each
    layout's kernel counts are set to 0 just before each of its runs and
    read just after.  Returns (the col_lanes model, the state, params,
    forcing, the next step, {layout: {kernel: launches}})."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    torch.cuda.reset_peak_memory_stats()
    model, st, prm, frc = build(NCOL_MAIN, NZ_MAIN, land=LAND_SHARE)
    models = {"col_lanes": model,
              "z_lanes": build(NCOL_MAIN, NZ_MAIN, land=LAND_SHARE,
                               layout="z_lanes")[0]}
    for m in models.values():
        assert m.pass_impl == "cuda_step", m.pass_impl
    st, frc = run_steps(model, st, prm, frc, 1, 2)          # warm-up
    st, frc = run_steps(models["z_lanes"], st, prm, frc, 3, 1)
    sync()
    steps, blocks = 4, 3
    nt = 4
    counts = {lay: dict.fromkeys(ck.LAUNCHES, 0) for lay in LAYOUTS}

    def counted(layout, fn):
        ck.reset_counts()                 # this layout's run starts here
        out = fn()
        sync()
        for k, v in ck.LAUNCHES.items():  # ... and is read here
            counts[layout][k] += v
        return out
    times = {}
    for with_diags in (True, False):
        for b in range(blocks):
            for layout in LAYOUTS[::1 if b % 2 == 0 else -1]:
                t0 = time.perf_counter()
                st, frc = counted(layout, lambda: run_steps(
                    models[layout], st, prm, frc, nt, steps, with_diags))
                times.setdefault((layout, with_diags), []).append(
                    (time.perf_counter() - t0) / steps * 1e3)
                nt += steps
    step_counts = {lay: dict(c) for lay, c in counts.items()}
    # the per-pass path ("cuda"): same state, a few steps
    for layout in LAYOUTS:
        model_p = build(NCOL_MAIN, NZ_MAIN, pass_impl="cuda",
                        land=LAND_SHARE, layout=layout)[0]
        counted(layout, lambda: run_steps(model_p, st, prm, frc, nt, 2))
        del model_p
    for layout, c in counts.items():
        zero = [k for k, v in c.items() if v == 0]
        if zero:
            raise AssertionError(f"{layout}: kernels not launched on the "
                                 f"main path: {zero}")
    wet = prm.run_physics
    for fld in ("x", "u"):
        a = getattr(st, fld)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {fld}")
    hm = st.hmix[wet]
    if not bool(((hm > 0) & (hm <= 1000.0)).all()):
        raise AssertionError("hmix outside (0, dmax] on active columns")
    out = {}
    for layout in LAYOUTS:
        full_ms = statistics.median(times[layout, True])
        prog_ms = statistics.median(times[layout, False])
        out[layout] = {
            "full_step_ms": full_ms, "prognostic_step_ms": prog_ms,
            "full_step_ms_blocks": times[layout, True],
            "prognostic_step_ms_blocks": times[layout, False],
            "column_steps_per_s_full": NCOL_MAIN / (full_ms / 1e3),
            "column_steps_per_s_prognostic": NCOL_MAIN / (prog_ms / 1e3),
            "launches": counts[layout],
            "launches_cuda_step_path": step_counts[layout],
            "launches_cuda_path": {
                k: counts[layout][k] - step_counts[layout][k]
                for k in counts[layout]}}
    emit({"phase": "main_path", "card": name, "nvidia_smi": smi,
          "ncol": NCOL_MAIN, "nz": NZ_MAIN, "active_columns": int(wet.sum()),
          "dtype": "float32", "pass_impl": model.pass_impl,
          "wscale": model.cfg.physics.wscale_mode,
          "full_step_ms": out["col_lanes"]["full_step_ms"],
          "prognostic_step_ms": out["col_lanes"]["prognostic_step_ms"],
          "layouts": out,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
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
    """One step from the same (perturbed) state through three paths, and
    the two kernel paths again in z_lanes, every state field equal to
    col_lanes' bit for bit; returns the captured kernel inputs at the
    main-path shapes ({"cuda_step": ..., "cuda/z_lanes": ...})."""
    import torch
    st = perturbed(st)
    outs, caps = {}, {}
    for impl in ("cuda_step", "eager_step", "cuda", "cuda_step/z_lanes",
                 "cuda/z_lanes"):
        p_impl, _, layout = impl.partition("/")
        model = build(NCOL_MAIN, NZ_MAIN, pass_impl=p_impl,
                      land=LAND_SHARE, layout=layout or "col_lanes")[0]
        with Capture() as cap:
            outs[impl] = run_steps(model, st, prm, frc, nt, 1)[0]
            sync()
        caps[impl] = cap
        del model
    layouts_equal = {}
    for impl in ("cuda_step", "cuda"):
        a, b = outs[impl + "/z_lanes"], outs[impl]
        differ = [f for f in a.__dataclass_fields__
                  if not torch.equal(getattr(a, f), getattr(b, f))]
        if differ:
            raise AssertionError(f"{impl}: z_lanes differs from col_lanes "
                                 f"in {differ}")
        layouts_equal[impl] = len(a.__dataclass_fields__)
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
    emit({"phase": "compare", **res,
          "z_lanes_vs_col_lanes_fields_equal": layouts_equal})
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


def kernel_row(kname, w, a, name, ptxas, launches, plain_reps=2):
    """One kernel at one shape, on the inputs ``a`` the path gave it: held
    to its plain version (the phase-2 bar), timed beside it and beside
    the card's bound; ``ptxas``: every library's table, by dtype and
    library ({"float32/ns3": {kernel: registers, spills}, ...,
    "float32/cw": ..., "float32/cl": ...}).  ``plain_reps`` 0: the plain
    version's time is that of the one call the comparison makes (the deep
    shapes, where a call takes seconds)."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    flops_peak, bytes_peak = card_peaks(name)
    got = w.launch(*a)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    ref = plain_of(w, a)
    e1.record()
    sync()
    err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
    rel = compare(w, got, ref, TOL_F32)
    ms = time_cuda(lambda: w.launch(*a),
                   5 if kname != "fused_step" else 3)
    plain_ms = (time_cuda(lambda: plain_of(w, a), plain_reps) if plain_reps
                else e0.elapsed_time(e1))
    nz, zaxis = w.kw["nz"], zaxis_of(w)
    ncol = a[0].shape[1 - zaxis]
    aref, ldd = ck._kernel_aref(a[-1], zaxis), w.kw["flags"].ldd
    geom = ck.launch_geometry(nz, a[0].dtype, ncol, ck._ref_extents(aref)[1])
    outs = col_major(w, got)
    # bytes: every input read once, every output written once
    nbytes = sum(x.numel() * x.element_size() for x in a) + \
        sum(x.numel() * x.element_size() for x in got)
    # operations over aref's nonzeros (ck.pass_ops); the step counts
    # this run's passes per column (colstep row 7), each with the
    # bldepth/blmix levels above the column's kmix
    extra = {}
    if kname == "fused_step":
        kmix, npass = outs[8][1].double(), outs[8][7].double()
        ops = float((npass * ck.pass_ops(nz, aref, kmix, ldd)).sum())
        # a block holds its SM share until its slowest column is done:
        # passes run over passes the blocks' columns were held for
        wb = geom.cols_per_block
        pad = torch.nn.functional.pad(npass, (0, (-ncol) % wb))
        held = float(pad.view(-1, wb).amax(dim=1).sum()) * wb
        extra = {"npass_mean_active": float(npass[npass > 0].mean()),
                 "npass_max": float(npass.max()),
                 "warp_pass_share_of_block_hold": float(npass.sum())
                 / held}
    else:
        kbl = outs[8 if kname == "fused_pass_fast" else 4][1].double()
        ops = float(ck.pass_ops(nz, aref, kbl, ldd).sum())
    dt = str(a[0].dtype).replace("torch.", "")
    table = ptxas.get(f"{dt}/{ck._lib_tag(geom.lib, zaxis)}",
                      {}).get(kname, {})
    regs = table.get("registers")
    bound_bytes_ms = nbytes / bytes_peak * 1e3
    bound_ops_ms = ops / flops_peak * 1e3
    return {
        "name": kname, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[kname], "launches": launches,
        "max_abs_err": err, "max_rel_err": rel, "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms > bound_ops_ms
        else "operations",
        "library_ms": None, "bytes": nbytes, "ops": ops,
        "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms,
        "shape": [nz + 2, ncol], "layout": LAYOUTS[zaxis],
        "level_slots": geom.ns, "library": ck._lib_tag(geom.lib),
        "warps_per_column": geom.cw * geom.cb,
        "warps_per_block": geom.warps, "blocks_per_cluster": geom.cb,
        "smem_bytes": geom.smem,
        "kref": geom.kref, "aref": "device" if geom.aref_dev else "shared",
        "grid_rows": "device" if geom.grid_dev else "shared",
        "registers": regs,
        "spill_stores": table.get("spill_stores"),
        "spill_loads": table.get("spill_loads"),
        "warps_per_sm": (None if regs is None
                         else warps_per_sm(regs, geom.warps, geom.smem)),
        **extra}


def phase_times(caps, counts, name, ptxas):
    """Each kernel at the main path's shape in both layouts (z_lanes rows
    named ``<kernel>_zl``), on the inputs phase 4 captured, with the
    launches of its layout's main-path run."""
    rows = []
    for layout in LAYOUTS:
        tag = "" if layout == "col_lanes" else "/" + layout
        sources = {"fused_pass_fast": caps["cuda" + tag],
                   "fused_pass_full": caps["cuda_step" + tag],
                   "fused_step": caps["cuda_step" + tag]}
        for kname in ("fused_pass_fast", "fused_pass_full", "fused_step"):
            w, a = sources[kname].first(kname)
            row = kernel_row(kname, w, a, name, ptxas, counts[layout][kname])
            if layout == "z_lanes":
                row["name"] = kname + "_zl"
            rows.append(row)
    emit({"phase": "kernel_times", "card": name, "rows": rows})
    return rows


NS4_SHAPES = (16_384,)     # a wide nz = 100 (single_column's one column
                           # is timed on its own inputs in phase 10)


def phase_times_ns4(name, ptxas):
    """The 4-slot kernels at nz = 100 (single_column's levels over its
    2000 m) at ``NS4_SHAPES`` columns, on the inputs of a model's third
    step: each held to its plain version and timed, as in phase 5 (no
    path's launches: these shapes are this phase's own)."""
    rows = []
    for ncol in NS4_SHAPES:
        caps = {}
        for impl in ("cuda", "cuda_step"):
            model, st, prm, frc = build(ncol, 100, dmax=2000.0,
                                        pass_impl=impl, noise=0.05)
            st, frc = run_steps(model, st, prm, frc, 1, 2)
            with Capture() as cap:
                run_steps(model, st, prm, frc, 3, 1)
            caps[impl] = cap
        for kname, impl in (("fused_pass_fast", "cuda"),
                            ("fused_pass_full", "cuda_step"),
                            ("fused_step", "cuda_step")):
            w, a = caps[impl].first(kname)
            row = kernel_row(kname, w, a, name, ptxas, None)
            if row["level_slots"] != 4:
                raise AssertionError(f"nz = 100 launched {row['level_slots']}"
                                     " level slots")
            rows.append(row)
    emit({"phase": "kernel_times_ns4", "card": name, "rows": rows})
    return rows


# the step alone past 126 levels, float32, (nz, columns, dmax): 6 slots at
# nz = 150 and 8 at 254 at the TerraMaris width, a column over 4 warps at
# 510 there too (over 1000 m), over 8 warps at 1022 on 16,384 columns
# over 2000 m, and over a cluster of 2 blocks of 8 warps at 2046 on 16,384
# columns over 4000 m (~2 m levels, where the hmix loop converges: at
# nz = 1022 over 1000 m every active column ran to the 200-pass cap)
DEEP_MAIN = ((150, NCOL_MAIN, 1000.0), (ONE_WARP_NZ, NCOL_MAIN, 1000.0),
             (510, NCOL_MAIN, 1000.0), (MW_MAXNZ, 16_384, 2000.0),
             (2046, 16_384, 4000.0))
# ... and in z_lanes: a column over 4 warps at nz = 510 and over a cluster
# at 2046, where col_lanes stages one value a level at stride ncol
DEEP_MAIN_ZL = ((510, NCOL_MAIN, 1000.0), (2046, 16_384, 4000.0))


def phase_deep_main(name, smi, ptxas, depths=DEEP_MAIN, layout="col_lanes"):
    """The main path past 126 levels: at each of ``DEEP_MAIN``, the
    production step (``KppModel.step``, "cuda_step", the full pass on
    with_diags steps) at that width with ~12% land from
    ``warm_start``, 2 steps to warm up, then the counts set to 0, 3 timed
    steps and one step of the per-pass path ("cuda"), the counts read;
    outputs finite with hmix in (0, dmax] on active columns; each kernel
    held to its plain version on the inputs of its first launch in that
    run (the phase-2 bar) and timed beside its bound (:func:`kernel_row`,
    the plain version timed once).  The peak device memory of the path's run
    and of the phase with the plain versions' temporaries.  Returns the
    rows, named by kernel and library (``_ns6``, ``_ns8``, ``_cw4``,
    ``_cw8``, ``_cl2x8``: blocks of a cluster x warps of a block; then
    ``_zl`` in z_lanes), at ``depths`` in ``layout``."""
    import torch
    from mckpp_torch.ops import cuda_kernels as ck
    rows, lines = [], []
    tag = "" if layout == "col_lanes" else "_zl"
    for nz, ncol, dmax in depths:
        torch.cuda.reset_peak_memory_stats()
        model, st, prm, frc = build(ncol, nz, land=LAND_SHARE, dmax=dmax,
                                    layout=layout)
        st, frc = run_steps(model, st, prm, frc, 1, 2)
        sync()
        ck.reset_counts()                # this depth's run starts here
        with Capture() as cap:
            t0 = time.perf_counter()
            st, frc = run_steps(model, st, prm, frc, 3, 3)
            sync()
            step_ms = (time.perf_counter() - t0) / 3 * 1e3
            model_p = build(ncol, nz, pass_impl="cuda",
                            land=LAND_SHARE, dmax=dmax, layout=layout)[0]
            st_p = run_steps(model_p, st, prm, frc, 6, 1)[0]
            sync()
        counts = dict(ck.LAUNCHES)       # ... and is read here
        del model_p, st_p
        zero = [k for k, v in counts.items() if v == 0]
        if zero:
            raise AssertionError(f"nz = {nz}: kernels not launched {zero}")
        wet = prm.run_physics
        hm = st.hmix[wet]
        if not torch_all_finite(st) or not bool(((hm > 0) & (hm <= dmax))
                                                .all()):
            raise AssertionError(f"nz = {nz}: non-finite state or hmix "
                                 "outside (0, dmax]")
        peak = torch.cuda.max_memory_allocated()
        n_wet, hm_med = int(wet.sum()), float(hm.median())
        del model, st, prm, frc, wet, hm
        for kname in ("fused_pass_fast", "fused_pass_full", "fused_step"):
            w, a = cap.first(kname)
            row = kernel_row(kname, w, a, name, ptxas, counts[kname],
                             plain_reps=0)
            row["name"] = (
                f"{kname}_cl{row['blocks_per_cluster']}x"
                f"{row['warps_per_block']}" if row["library"] == ck.CL
                else f"{kname}_cw{row['warps_per_column']}"
                if row["library"] == ck.MW
                else f"{kname}_ns{row['level_slots']}") + tag
            rows.append(row)
        del cap
        lines.append({"nz": nz, "ncol": ncol, "dmax": dmax,
                      "active_columns": n_wet,
                      "step_ms_with_diags": step_ms, "launches": counts,
                      "hmix_median_active": hm_med,
                      "peak_memory_bytes": peak,
                      "peak_memory_bytes_with_plain":
                          torch.cuda.max_memory_allocated()})
        torch.cuda.empty_cache()
    emit({"phase": "deep_main", "card": name, "nvidia_smi": smi,
          "dtype": "float32", "layout": layout, "runs": lines,
          "rows": rows})
    return rows


DEEP_COLUMN_NZ, DEEP_COLUMN_DMAX = 250, 250.0   # 1 m levels
DEEP_COLUMN_STEPS64 = 9
# single_column's 2000 m at 2 m levels, as KPP single-column studies of
# deep winter convection resolve it (a column over 8 warps)
DEEP_COLUMN_1000 = (1000, 2000.0, 6)   # levels, dmax, float64 steps
# a full-depth open-ocean column, 4000 m at 2 m levels (a column over a
# cluster of 2 blocks of 8 warps)
DEEP_COLUMN_2000 = (2000, 4000.0, 6)


class plain_step:
    """Within it, a model built with pass_impl "auto" or "cuda_step" takes
    the plain whole-step body ("eager_step") on whatever device it is
    given, with the reference averages summed as the kernels sum them
    (:class:`serial_matmul`): the kernels' own plain versions, driven by
    the CLI."""

    def __enter__(self):
        from mckpp_torch.models.column_model import KppModel
        self.cls, self.orig = KppModel, KppModel.__dict__["_resolve_pass_impl"]
        KppModel._resolve_pass_impl = staticmethod(
            lambda ph, on_cuda: "eager_step")
        self.serial = serial_matmul().__enter__()
        return self

    def __exit__(self, *exc):
        self.serial.__exit__(*exc)
        self.cls._resolve_pass_impl = self.orig


def restart_rel(a, b):
    """T, S, u, v and hmix of two restarts: max |a - b| over the field's
    max |b|; and whether kmix is equal."""
    import numpy as np
    rel = {}
    for key, field, idx in (("T", "st_x", 0), ("S", "st_x", 1),
                            ("u", "st_u", 0), ("v", "st_u", 1),
                            ("hmix", "st_hmix", None)):
        x, y = a[field], b[field]
        if idx is not None:
            x, y = x[..., idx], y[..., idx]
        rel[key] = float(np.abs(x - y).max()) / max(float(np.abs(y).max()),
                                                    1e-300)
    return rel, bool(np.array_equal(a["st_kmix"], b["st_kmix"]))


def phase_deep_column(name, smi, work, device="cuda", nz=DEEP_COLUMN_NZ,
                      dmax=DEEP_COLUMN_DMAX, steps64=DEEP_COLUMN_STEPS64,
                      cpu=True, ptxas=None):
    """A deep single column: the single_column recipe at ``nz`` levels
    over ``dmax`` m (``benchmark_inputs.write_single_column``; 250 over
    250 m, 1000 over 2000 m and 2000 over 4000 m), a model day (72 steps)
    of the CLI in float32 on ``device``, its outputs held (finite, hmix in
    [0, dmax]) and its kernels those launch_geometry takes there (8 slots
    at 250, a column over 8 warps at 1000, over a cluster of 2 blocks at
    2000); then the same inputs in float64 for
    ``steps64`` steps through the CLI three times: on ``device`` with the
    kernels, on ``device`` with the plain step body (:class:`plain_step`),
    and (``cpu``) on the CPU (the plain bodies).  The kernels' restart is
    held to the plain body's on the same card (T, S, u, v and hmix within
    1e-10 of each field's scale, kmix equal); the CPU's is reported beside
    it.  At 1 m levels the hmix loop runs to its 200-pass limit in 4 of
    the first 9 steps (hbl hops between levels), so where it stops turns
    on the last ulp of each pass, and the CPU's exp, pow and scalar
    division round apart from the card's (ROADMAP §C): the 250-level
    column's CPU run (~20 s) is left out for the script's time.  With
    ``ptxas`` (on the card), each kernel the day launched is held to its
    plain version on the inputs of its first launch and timed
    (:func:`kernel_row`, the day's launches); returns those rows."""
    import os
    import shutil
    import numpy as np
    import torch
    from mckpp_torch.io.benchmark_inputs import write_single_column
    from mckpp_torch.ops import cuda_kernels as ck
    data = os.path.join(work, f"deep_column_{nz}")
    grid = write_single_column(data, nz, dmax)
    dmax = grid["dmax"]
    with Capture() if ptxas is not None else contextlib.nullcontext() as cap:
        day = run_cli(data, os.path.join(data, "day"), CLI_DAY_STEPS,
                      device=device)
    n_held = hold_outputs(read_nc_dir(os.path.join(data, "day")),
                          np.zeros((1, 1), dtype=bool), dmax)
    on_card = device == "cuda"
    g = ck.launch_geometry(nz, torch.float32, 1)
    if on_card and not day["launches_read"]["fused_step"]:
        raise AssertionError(f"the deep column: {day['launches_read']}")
    nml = os.path.join(data, "r64.nml")
    edit_namelist(os.path.join(data, "3D_ocn.nml"), nml,
                  ndt_per_restart=steps64)
    runs, restarts = {}, {}
    for label, dev in (("kernels", device), ("plain", device),
                       ("cpu", "cpu"))[:3 if cpu else 2]:
        with plain_step() if label == "plain" else contextlib.nullcontext():
            runs[label] = run_cli(data, os.path.join(data, label),
                                  steps64, namelist=nml,
                                  device=dev, dtype="float64")
        restarts[label] = npz_arrays([p for p in runs[label]["restarts"]
                                      if p.endswith(".npz")][-1])
    rel, kmix_equal = restart_rel(restarts["kernels"], restarts["plain"])
    rows = []
    for kname, n in day["launches_read"].items():
        if ptxas is None or not n:
            continue
        w, a = cap.first(kname)
        row = kernel_row(kname, w, a, name, ptxas, n)
        row["name"] = (f"{kname}_cl{row['blocks_per_cluster']}x"
                       f"{row['warps_per_block']}_column")
        rows.append(row)
    rel_cpu, kmix_cpu = (restart_rel(restarts["kernels"], restarts["cpu"])
                         if cpu else ("not run", None))
    launched = runs["kernels"]["launches_read"]
    shutil.rmtree(data)
    emit({"phase": "deep_column", "card": name, "nvidia_smi": smi,
          "nz": nz, "dmax": dmax, "library": ck._lib_tag(g.lib),
          "level_slots": g.ns, "warps_per_column": g.cw * g.cb,
          "blocks_per_cluster": g.cb,
          "day": {k: day.get(k) for k in CLI_KEYS}, "fields_held": n_held,
          "float64_steps": steps64,
          "float64_kernels_vs_plain_max_rel": rel,
          "float64_kmix_equal": kmix_equal,
          "float64_kernels_vs_cpu_max_rel": rel_cpu,
          "float64_kmix_equal_cpu": kmix_cpu,
          "float64_hmix": {k: r["st_hmix"].tolist()
                           for k, r in restarts.items()},
          "float64_launches": {k: r["launches_read"]
                               for k, r in runs.items()},
          "float64_wall_s": {k: r["wall_s"] for k, r in runs.items()},
          "rows": rows})
    over = {k: v for k, v in rel.items() if v > TOL_F64}
    if over or not kmix_equal or (on_card and (
            not launched["fused_step"]
            or any(runs["plain"]["launches_read"].values()))):
        raise AssertionError(f"the deep column in float64, kernels vs the "
                             f"plain body: {over}, kmix equal {kmix_equal}, "
                             f"launches {launched} / "
                             f"{runs['plain']['launches_read']}")
    return rows


# the host ops that transpose (a view, or a copy through one)
TRANSPOSE_OPS = ("aten::t", "aten::transpose", "aten::permute",
                 "aten::numpy_T", "aten::mT", "aten::swapaxes")


def phase_trace(st, prm, frc, nt, name):
    """torch.profiler over one full step and, in a window of its own, one
    prognostic step at the main-path width, in each layout: device time
    by kernel name, the share of the window (first host event to last
    device event) the device was idle, the glue's device ms and launches
    (the device work other than the ``kpp::`` kernels) and the
    transposing host ops, of which z_lanes has none."""
    from torch.profiler import ProfilerActivity, profile
    for layout in LAYOUTS:
        model = build(NCOL_MAIN, NZ_MAIN, land=LAND_SHARE, layout=layout)[0]
        run_steps(model, st, prm, frc, nt, 1, True)     # lazy set-up
        sync()
        for step, with_diags in (("full", True), ("prognostic", False)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_steps(model, st, prm, frc, nt, 1, with_diags)
                sync()
            stats = trace_stats(prof, top_n=40)
            transposes = {}
            for e in prof.events():
                if e.name in TRANSPOSE_OPS:
                    transposes[e.name] = transposes.get(e.name, 0) + 1
            kpp_launches = sum(n for k, n in
                               stats["launches_by_kernel"].items()
                               if "kpp::" in k)
            emit({"phase": "trace", "card": name, "layout": layout,
                  "step": step, "glue_device_ms": stats["kernel_ms_other"],
                  "glue_launches": stats["device_launches"] - kpp_launches,
                  "transposing_host_ops": transposes, **stats})
            if layout == "z_lanes" and transposes:
                raise AssertionError(f"z_lanes step path transposes: "
                                     f"{transposes}")
        del model


def trace_stats(prof, top_n=12):
    """Device time of a torch.profiler run (``mckpp_torch.tools.
    summarize_trace.stats``): the window (first host event to last device
    event), the device's busy time and idle share, kpp kernel and other
    kernel ms, launches, and ms by kernel name."""
    from mckpp_torch.tools import summarize_trace
    st = summarize_trace.stats(summarize_trace.from_profiler(prof), top_n)
    if not st["device_events"]:
        raise AssertionError("the profiler recorded no device time")
    return st


# ---------------------------------------------------------------------------
# the reference step (pass_impl "reference": plain torch, no kernel)
# ---------------------------------------------------------------------------

REF_NCOL_F64 = 2048     # the float64 checks' width
REF_STEPS = 3
REF_TOL = 1e-9          # scale-aware rtol, float64 (tests/test_fused_parity.py)
# BASELINE.md's float32 budget after one model day (max abs over ocean
# columns, physical units), and the share of ocean columns whose kmix may
# differ
F32_BUDGET = {"T": 3.1e-4, "S": 4.8e-6, "hmix": 1.5e-3}
KMIX_MISMATCH_MAX = 1e-3
THOMAS_TABLE = dict(solver="thomas", wscale_mode="table")
PCR_NODAL = dict(solver="pcr", wscale_mode="nodal")


def timed_run(model, st, prm, frc, n):
    """Steps 1..n from the built state: step 1 warms up, each later step is
    timed on the host clock between device syncs.  Returns (state, ms of
    steps 2..n, the launch counts the run added)."""
    from mckpp_torch.ops import cuda_kernels as ck
    before = dict(ck.LAUNCHES)
    st, frc = run_steps(model, st, prm, frc, 1, 1)
    sync()
    ms = []
    for nt in range(2, n + 1):
        t0 = time.perf_counter()
        st, frc = run_steps(model, st, prm, frc, nt, 1)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    added = {k: ck.LAUNCHES[k] - before.get(k, 0) for k in ck.LAUNCHES}
    return st, ms, {k: v for k, v in added.items() if v}


def states_rel(a, b):
    """Per field of two states: the max relative difference (max |a-b| over
    max |b|) of a float field, the count of differing entries of an
    integer field."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name).cpu()
        if x.dtype.is_floating_point:
            d = float((x - y).abs().max())
            out[f.name] = d / max(float(y.abs().max()), 1e-300) if d else 0.0
        else:
            out[f.name] = int((x != y).sum())
    return out


def rel_summary(rel):
    """The largest float difference and the integer mismatches of
    :func:`states_rel`, and the fields over the float64 bar."""
    floats = {k: v for k, v in rel.items() if isinstance(v, float)}
    ints = {k: v for k, v in rel.items() if isinstance(v, int)}
    over = {k: v for k, v in floats.items() if v > REF_TOL}
    over.update({k: v for k, v in ints.items() if v})
    worst = max(floats, key=floats.get)
    return dict(max_rel=floats[worst], max_rel_field=worst,
                int_mismatch=ints), over


def phase_reference(name, smi, device="cuda", ncol64=REF_NCOL_F64,
                    ncol32=NCOL_MAIN, nz=NZ_MAIN):
    """The reference step (ops/ocnstep.py) on the card: (a) thomas + table,
    float64, against the same model on the CPU; (b) pcr + nodal, float64,
    against the whole-step kernel; (c) thomas + table, float32 at the
    TerraMaris width, against the whole-step kernel with the nodal form,
    within BASELINE.md's float32 budget, both timed.  No kernel launches
    in a reference run."""
    res = {}
    errors = []
    # (a) float64, card against CPU
    runs = {}
    for dev in (device, "cpu"):
        model, st, prm, frc = build(ncol64, nz, "float64", "reference",
                                    physics=THOMAS_TABLE, land=LAND_SHARE,
                                    device=dev)
        runs[dev] = timed_run(model, st, prm, frc, REF_STEPS)
    st_a, ms_a, launched_a = runs[device]
    sum_a, over_a = rel_summary(states_rel(st_a, runs["cpu"][0]))
    res["a_thomas_table_f64_vs_cpu"] = dict(
        ncol=ncol64, **sum_a, step_ms=ms_a, cpu_step_ms=runs["cpu"][1],
        launches=launched_a)
    # (b) float64, reference (pcr, nodal) against the step kernel
    model, st, prm, frc = build(ncol64, nz, "float64", "reference",
                                physics=PCR_NODAL, land=LAND_SHARE,
                                device=device)
    st_b, ms_b, launched_b = timed_run(model, st, prm, frc, REF_STEPS)
    model_k = build(ncol64, nz, "float64", "cuda_step", physics=PCR_NODAL,
                    land=LAND_SHARE, device=device)[0]
    st_k = timed_run(model_k, st, prm, frc, REF_STEPS)[0]
    sum_b, over_b = rel_summary(states_rel(st_b, st_k))
    res["b_pcr_nodal_f64_vs_cuda_step"] = dict(
        ncol=ncol64, **sum_b, step_ms=ms_b, launches=launched_b)
    # (c) float32 at the TerraMaris width, timed beside the step kernel
    model, st, prm, frc = build(ncol32, nz, "float32", "reference",
                                physics=THOMAS_TABLE, land=LAND_SHARE,
                                device=device)
    st_r, ms_r, launched_c = timed_run(model, st, prm, frc, REF_STEPS)
    model_k = build(ncol32, nz, "float32", "cuda_step",
                    physics=dict(wscale_mode="nodal"), land=LAND_SHARE,
                    device=device)[0]
    st_k, ms_k, _ = timed_run(model_k, st, prm, frc, REF_STEPS)
    wet = prm.run_physics
    n_wet = int(wet.sum())
    kdiff = wet & (st_r.kmix != st_k.kmix)
    n_kdiff = int(kdiff.sum())
    same = wet & ~kdiff
    fields = {"T": lambda s: s.x[..., 0], "S": lambda s: s.x[..., 1],
              "hmix": lambda s: s.hmix}

    def max_abs(mask):
        return {k: float((f(st_r)[mask] - f(st_k)[mask]).abs().max())
                for k, f in fields.items()}
    ocean, agree = max_abs(wet), max_abs(same)
    finite = bool(torch_all_finite(st_r))
    ref_ms = sum(ms_r) / len(ms_r)
    step_ms = sum(ms_k) / len(ms_k)
    res["c_thomas_table_f32_vs_cuda_step_nodal"] = dict(
        ncol=ncol32, active_columns=n_wet, max_abs_ocean=ocean,
        max_abs_kmix_agree=agree, budget=F32_BUDGET, kmix_mismatch=n_kdiff,
        kmix_mismatch_share=n_kdiff / n_wet, finite=finite,
        launches=launched_c)
    res["times"] = dict(
        ncol=ncol32, dtype="float32", steps_timed=len(ms_r),
        reference_step_ms=ms_r, cuda_step_step_ms=ms_k,
        reference_ms_per_step=ref_ms, cuda_step_ms_per_step=step_ms,
        reference_column_steps_per_s=ncol32 / (ref_ms / 1e3),
        cuda_step_column_steps_per_s=ncol32 / (step_ms / 1e3))
    emit({"phase": "reference", "card": name, "nvidia_smi": smi,
          "nz": nz, **res})
    # the gates, after the line that shows every number
    for what, launched in (("a", launched_a), ("b", launched_b),
                           ("c", launched_c)):
        if launched:
            errors.append(f"({what}) launched kernels: {launched}")
    for what, over in (("(a) card vs cpu", over_a),
                       ("(b) vs cuda_step", over_b)):
        if over:
            errors.append(f"{what} over rtol {REF_TOL}: {over}")
    over = {k: v for k, v in ocean.items() if v > F32_BUDGET[k]}
    if over:
        errors.append(f"(c) over the float32 budget: {over}")
    if n_kdiff > KMIX_MISMATCH_MAX * n_wet:
        errors.append(f"(c) kmix differs in {n_kdiff} of {n_wet} columns")
    if not finite:
        errors.append("(c) non-finite reference state")
    if errors:
        raise AssertionError("; ".join(errors))
    return res


def torch_all_finite(st):
    import dataclasses
    import torch
    return all(bool(torch.isfinite(getattr(st, f.name)).all())
               for f in dataclasses.fields(st)
               if getattr(st, f.name).dtype.is_floating_point)


# ---------------------------------------------------------------------------
# the CLI on the TerraMaris configuration
# ---------------------------------------------------------------------------

CLI_STEPS = 24          # 8 model hours: two emits of output_kpp_all
CLI_DAY_STEPS = 72      # one model day, the reference job's length
CLI_DAY_BEFORE_S = 370  # ... run when the script has used less than this
                        # (the day takes ~95 s: the script stays in 8 min)
RESUME_K = 6            # the resume check: k steps, restart, k more


def run_cli(data_dir, out_dir, steps, chain=True, namelist=None,
            iodef=None, device="cuda", dtype="float32"):
    """``mckpp_torch.cli`` in ``dtype`` on ``device``, launch counts from
    0; returns its summary with wall seconds and peak device memory."""
    import os
    import torch
    from mckpp_torch import cli
    from mckpp_torch.ops import cuda_kernels as ck
    os.environ["MCKPP_CHAIN"] = "1" if chain else "0"
    argv = ["--namelist", namelist or os.path.join(data_dir, "3D_ocn.nml"),
            "--data-dir", data_dir, "--output-dir", out_dir,
            "--steps", str(steps), "--dtype", dtype, "--device", device]
    if iodef:
        argv += ["--iodef", iodef]
    on_card = device == "cuda"
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ck.reset_counts()
    t0 = time.perf_counter()
    try:
        summary = cli.run(argv)
    finally:
        os.environ.pop("MCKPP_CHAIN", None)
    sync()
    summary["wall_s"] = time.perf_counter() - t0
    summary["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                    if on_card else None)
    summary["launches_read"] = dict(ck.LAUNCHES)
    return summary


def read_nc_dir(path):
    """{file: {variable: array}} of every .nc file in ``path``."""
    import os
    import numpy as np
    from scipy.io import netcdf_file
    out = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".nc"):
            nc = netcdf_file(os.path.join(path, fn), "r", mmap=False)
            try:
                out[fn] = {k: np.array(v[:]) for k, v in nc.variables.items()}
            finally:
                nc.close()
    return out


def hold_outputs(files, land, dmax):
    """Every field finite over ocean, land at the fill value, hmix in
    [0, dmax]; ``land`` is the (ny, nx) land mask."""
    import numpy as np
    n = 0
    for fn, vs in files.items():
        for name, a in vs.items():
            if a.ndim < 3:                      # time, z, lon, lat axes
                continue
            sea = a[..., ~land]
            if not np.isfinite(sea).all():
                raise AssertionError(f"{fn}:{name} not finite over ocean")
            fill = np.float32(1e20) if a.dtype.itemsize == 4 else 1e20
            if not (a[..., land] == fill).all():
                raise AssertionError(f"{fn}:{name} land not at fill value")
            if name.startswith("hmix") and not (
                    (sea >= 0.0) & (sea <= dmax)).all():
                raise AssertionError(f"{fn}:{name} outside [0, {dmax}]")
            n += 1
    return n


def same_bits(a_files, b_files, what):
    """Every variable of every file equal bit for bit."""
    import numpy as np
    if sorted(a_files) != sorted(b_files):
        raise AssertionError(f"{what}: files {sorted(a_files)} vs "
                             f"{sorted(b_files)}")
    n = 0
    for fn in a_files:
        a, b = a_files[fn], b_files[fn]
        if sorted(a) != sorted(b):
            raise AssertionError(f"{what}: {fn} variables differ")
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(
                    bits(a[k]), bits(b[k])):
                raise AssertionError(f"{what}: {fn}:{k} differs")
            n += 1
    return n


def bits(a):
    """The bytes of an array, so that equal means equal bit for bit."""
    import numpy as np
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def npz_arrays(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def diag_s(summary):
    """The "Diagnostic output" seconds of a CLI run's timer table."""
    import re
    m = re.search(r"^Diagnostic output\s+\d+\s+([\d.]+)$",
                  summary["timers"], re.M)
    return float(m.group(1)) if m else None


def edit_namelist(src, dst, **subs):
    """Copy a namelist, replacing ``key=value`` entries (case-insensitive
    keys, the value up to the next comma or space)."""
    import re
    with open(src) as f:
        text = f.read()
    for key, val in subs.items():
        text, n = re.subn(rf"(?i)\b{key}\s*=\s*[^,\s]+", f"{key}={val}",
                          text)
        if n != 1:
            raise AssertionError(f"namelist key {key}: {n} matches")
    with open(dst, "w") as f:
        f.write(text)


def cli_trace(data_dir, work, name, device="cuda"):
    """At the library level on the same inputs: the initial mixing pass
    timed alone; then steps 10-12 from one state as a replayed 3-step
    segment, as the same chain run eagerly and per step (model.step +
    DiagnosticsManager.step): wall ms of each, and a torch.profiler trace
    of the replay and of the per-step run."""
    import dataclasses
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mckpp_torch import forcing as forcing_mod
    from mckpp_torch import setup as setup_mod
    from mckpp_torch.io.diagnostics import DiagnosticsManager
    from mckpp_torch.io.streams import parse_iodef
    from mckpp_torch.models.chain import ChainedStepper
    from mckpp_torch.utils import namelist as nml
    from mckpp_torch.state import tree_map

    cfg, _ = nml.load_config(os.path.join(data_dir, "3D_ocn.nml"))
    cfg = dataclasses.replace(cfg, dtype="float32")
    d, t = cfg.domain, cfg.time
    sync()
    t0 = time.perf_counter()
    model, st, prm, frc, fluxes, mgr = setup_mod.build(cfg, data_dir,
                                                       device=device)
    sync()
    build_s = time.perf_counter() - t0
    zm = model.grid.zm.double().cpu().numpy()
    lon0, lat0 = float(prm.dlon[0]), float(prm.dlat[0])
    u0, t0p, s0 = setup_mod.load_initial_profiles(cfg, data_dir, zm, lon0,
                                                  lat0, d.nx, d.ny)
    init_s = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        model.initial_state(u0, t0p, s0, prm)
        sync()
        init_s.append(time.perf_counter() - t0)

    # synchronous writers: no emitted window is fetched to the host until
    # flush, so the traced windows hold device work and its host glue only
    streams = parse_iodef(os.path.join(data_dir, "iodef.xml"), t.dto)
    mk = lambda sub: DiagnosticsManager(
        streams, d.nx, d.ny, model.grid.zm, outdir=os.path.join(work, sub),
        start_time_days=t.startt, dto_seconds=t.dto, l_ocean=prm.l_ocean,
        async_write=False)
    diag_g, diag_p = mk("g"), mk("p")
    on_card = device == "cuda"
    stepper = ChainedStepper(model._step, diag_g, graphs=on_card)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])

    def pre(nt, st, frc):
        days = t.startt + (nt - 1) * t.dto / 86400.0
        st, frc = forcing_mod.update_fluxes(cfg, st, prm, frc, fluxes(days),
                                            nt <= 1, model.grid.dm)
        if nt > 1 and mgr.due_any(nt):
            frc = mgr.update(nt, days, frc)
        return st, frc

    for nt0 in (1, 4, 7):
        st, frc = pre(nt0, st, frc)
        st, acc, inst = stepper.exec(nt0, 3, st, prm, frc)
        stepper.commit(nt0 + 2, 3, acc, inst)
    st, frc = pre(10, st, frc)
    captures = stepper.captures
    eager = ChainedStepper(model._step, mk("e"), graphs=False)

    def replayed():
        return stepper.exec(10, 3, st, prm, frc)

    def eager_chain():
        return eager.exec(10, 3, st, prm, frc)

    def per_step():
        s = st
        for nt in range(10, 13):
            s = model.step(s, prm, frc, first_step=False,
                           with_diags=diag_p.needs_full(nt))
            diag_p.step(nt, s, prm, frc)
        return s, None, None

    # wall ms of the three forms of steps 10-12, no profiler, from one
    # state (the replays' inputs are in place after the first)
    wall = {}
    for label, fn in (("replayed", replayed), ("eager_chain", eager_chain),
                      ("per_step", per_step)):
        ts = []
        for _ in range(4):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        wall[label] = ts
        if label == "replayed":
            st_g = out[0]
        elif label == "per_step":
            st_p = out[0]
    if on_card and (stepper.captures != captures or not stepper.replays):
        raise AssertionError("the timed segment was captured, not replayed")
    diffs = []
    tree_map(lambda a, b: diffs.append(not torch.equal(a, b)), st_g, st_p)
    if any(diffs):
        raise AssertionError("replayed segment and per-step run differ")
    traces = {}
    if on_card:
        for label, fn in (("replayed", replayed), ("per_step", per_step)):
            sync()
            with profile(activities=acts) as prof:
                fn()
                sync()
            traces[label] = trace_stats(prof)
    for m in (diag_g, diag_p, eager.diag):
        m.flush()
    emit({"phase": "cli_trace", "card": name, "steps": [10, 12],
          "build_s": build_s, "initial_state_s": init_s, "wall_ms": wall,
          "traces": traces, "bitwise_equal": True})


def phase_cli(name, smi, work, device="cuda", shrink=1):
    """The CLI on the TerraMaris configuration at full width on the card:
    inputs, a timed graph-chained run with its outputs held, the same
    steps through the per-step loop (bit for bit), a restart resumed (bit
    for bit), a trace of a replayed segment.  The 24-step runs write a
    restart at their last step.  Leaves the inputs and the first
    graph-chained run's output in ``work`` for phases 8 and 9, and the
    resume check's straight run (``work``/a); returns (inputs dir, its
    namelist, land mask, dmax, that run's summary, (the straight run's
    namelist, iodef, summary))."""
    import os
    import shutil
    import numpy as np
    from mckpp_torch.io import ncio
    from mckpp_torch.io.benchmark_inputs import write_terramaris

    data = os.path.join(work, "in")
    t0 = time.perf_counter()
    grid = write_terramaris(data, shrink=shrink)
    inputs_s = time.perf_counter() - t0
    in_bytes = sum(os.path.getsize(os.path.join(data, f))
                   for f in os.listdir(data))
    with ncio.open_nc(os.path.join(data, "lsm.nc")) as nc:
        land = ncio.get_var(nc, "lsm") == 1.0
    dmax = grid["dmax"]
    on_card = device == "cuda"
    # a restart at the last of the CLI_STEPS, for phase 9 to compare
    nml = os.path.join(work, "cli.nml")
    edit_namelist(os.path.join(data, "3D_ocn.nml"), nml,
                  ndt_per_restart=CLI_STEPS)

    # the graph-chained run, then the per-step loop over the same steps
    g = run_cli(data, os.path.join(work, "g"), CLI_STEPS, namelist=nml,
                device=device)
    if on_card and (g["captures"] < 1 or g["replays"] < 1):
        raise AssertionError(f"no CUDA graph ran: {g['captures']} "
                             f"captures, {g['replays']} replays")
    zero = [k for k in ("fused_step", "fused_pass_full")
            if g["launches_read"][k] == 0]
    if on_card and zero:
        raise AssertionError(f"kernels not launched by the CLI: {zero}")
    native_only(g, "the graph-chained CLI run")
    g_files = read_nc_dir(os.path.join(work, "g"))
    n_held = hold_outputs(g_files, land, dmax)
    p = run_cli(data, os.path.join(work, "p"), CLI_STEPS, chain=False,
                namelist=nml, device=device)
    n_same = same_bits(g_files, read_nc_dir(os.path.join(work, "p")),
                       "graph chain vs MCKPP_CHAIN=0")
    n_same += same_restart(g, p, "graph chain vs MCKPP_CHAIN=0")
    del g_files
    shutil.rmtree(os.path.join(work, "p"))
    # the two again, in the other order, for the spread of the rates
    p2 = run_cli(data, os.path.join(work, "p2"), CLI_STEPS, chain=False,
                 namelist=nml, device=device)
    g2 = run_cli(data, os.path.join(work, "g2"), CLI_STEPS, namelist=nml,
                 device=device)
    shutil.rmtree(os.path.join(work, "p2"))
    shutil.rmtree(os.path.join(work, "g2"))

    # restart: 2k steps with a restart every k == k, restart, k more
    k = RESUME_K
    light = os.path.join(work, "iodef_light.xml")
    with open(os.path.join(data, "iodef.xml")) as f:
        text = f.read()
    cut = text.index('<file id="output_kpp_means"')
    end = text.index("</file_definition>")
    with open(light, "w") as f:
        f.write(text[:cut] + text[end:])
    nml_a = os.path.join(work, "a.nml")
    edit_namelist(os.path.join(data, "3D_ocn.nml"), nml_a,
                  ndt_per_restart=k)
    a = run_cli(data, os.path.join(work, "a"), 2 * k, namelist=nml_a,
                iodef=light, device=device)
    at_k, at_2k = sorted(p_ for p_ in a["restarts"] if p_.endswith(".npz"))
    valid_k = float(npz_arrays(at_k)["meta_time_days"])
    # the namelist names the file relative to the data directory (a '/'
    # would end the namelist group)
    os.link(at_k, os.path.join(data, "resume.npz"))
    nml_b = os.path.join(work, "b.nml")
    edit_namelist(nml_a, nml_b, startt=repr(valid_k),
                  L_RESTART=".T., restart_infile='resume.npz'")
    b = run_cli(data, os.path.join(work, "b"), k, namelist=nml_b,
                iodef=light, device=device)
    straight = npz_arrays(at_2k)
    resumed = npz_arrays([p_ for p_ in b["restarts"]
                          if p_.endswith(".npz")][-1])
    bad = [key for key in straight if not key.startswith("meta_")
           and not np.array_equal(bits(straight[key]), bits(resumed[key]))]
    if bad:
        raise AssertionError(f"resumed run differs from the straight run "
                             f"in {bad[:8]}")
    os.remove(os.path.join(data, "resume.npz"))
    shutil.rmtree(os.path.join(work, "b"))

    cli_trace(data, os.path.join(work, "t"), name, device)

    emit({"phase": "cli", "card": name, "nvidia_smi": smi,
          "ncol": g["ncol"], "nz": grid["nz"], "nx": grid["nx"],
          "ny": grid["ny"], "land_share": grid["land_share"],
          "dtype": "float32", "inputs_s": inputs_s,
          "input_bytes": in_bytes, "steps": CLI_STEPS,
          "graph": {k_: g.get(k_) for k_ in CLI_KEYS},
          "per_step": {k_: p.get(k_) for k_ in CLI_KEYS},
          "rates_in_run_order": {
              "graph_1": g.get("column_steps_per_s"),
              "per_step_1": p.get("column_steps_per_s"),
              "per_step_2": p2.get("column_steps_per_s"),
              "graph_2": g2.get("column_steps_per_s")},
          "diag_output_s_in_run_order": [diag_s(r) for r in (g, p, p2, g2)],
          "fields_held": n_held, "arrays_bitwise_equal": n_same,
          "resume": {"k": k, "arrays_equal": len(straight) - 2,
                     "from": os.path.basename(at_k)}})
    return data, nml, land, dmax, g, (nml_a, light, a)


CLI_KEYS = ("segments", "captures", "replays", "launches_read", "steady_s",
            "steady_steps", "column_steps_per_s", "bytes_written", "writes",
            "wall_s", "peak_memory_bytes", "timers")


def native_only(summary, what):
    """Every NetCDF file of a CLI run came from the native encoder."""
    w = summary["writes"]
    if w["scipy"] or not w["native"]:
        raise AssertionError(f"{what}: NetCDF writers {w}, expected the "
                             "native encoder only")


def same_restart(a, b, what):
    """The last .npz restart of two CLI runs (summaries), equal bit for
    bit in every array; returns the number of arrays."""
    import numpy as np
    ra, rb = ([p_ for p_ in s["restarts"] if p_.endswith(".npz")]
              for s in (a, b))
    if not ra or not rb:
        raise AssertionError(f"{what}: no restart ({ra}, {rb})")
    za, zb = npz_arrays(ra[-1]), npz_arrays(rb[-1])
    if sorted(za) != sorted(zb):
        raise AssertionError(f"{what}: restart arrays differ in names")
    bad = [k for k in za if za[k].dtype != zb[k].dtype
           or not np.array_equal(bits(za[k]), bits(zb[k]))]
    if bad:
        raise AssertionError(f"{what}: restart differs in {bad[:8]}")
    return len(za)


CHAIN_STEPS = 9         # three spans of ndtocn = 3 steps, fluxes between


def phase_chain_layouts(name, smi, work):
    """The chained run of the CLI (``models/chain.py``: each span of steps
    captured once as a CUDA graph and replayed) at the main path's width
    in each layout, over the same ``CHAIN_STEPS`` steps from the same
    start, the flux update between spans on its ndtocn cadence, an instant
    and an averaging stream of hmix every 3 steps and an instant stream
    of difm (a wide field) at the last: every state field and every
    written variable equal bit for bit; the graphs captured and replayed,
    the launches, and the ms of each span."""
    import os
    import torch
    from mckpp_torch import forcing as forcing_mod
    from mckpp_torch.io.diagnostics import DiagnosticsManager, Stream
    from mckpp_torch.models import chain
    from mckpp_torch.ops import cuda_kernels as ck
    res, finals, files = {}, {}, {}
    for layout in LAYOUTS:
        model, st, prm, frc = build(NCOL_MAIN, NZ_MAIN, land=LAND_SHARE,
                                    layout=layout)
        out = os.path.join(work, "chain_" + layout)
        os.makedirs(out, exist_ok=True)
        streams = [Stream("inst", "instant", 3, fields=("hmix",)),
                   Stream("mean", "average", 3, fields=("hmix",)),
                   Stream("wide", "instant", CHAIN_STEPS, fields=("difm",))]
        diag = DiagnosticsManager(streams, NCOL_MAIN, 1, model.grid.zm,
                                  outdir=out, dto_seconds=model.cfg.time.dto,
                                  async_write=False)
        stepper = chain.ChainedStepper(model._step, diag, graphs=True)
        ndtocn = model.cfg.time.ndtocn
        raw = forcing_mod.constant_test_fluxes(NCOL_MAIN, model.dtype,
                                               model.device)

        def end(nt):
            return (chain.emit_due(diag, nt)
                    or (diag.needs_full(nt) and not stepper.wide_reducing))
        ck.reset_counts()                 # this layout's run starts here
        span_ms = []
        for nt0, k in chain.plan_segments(CHAIN_STEPS, ndtocn=ndtocn,
                                          end_pred=end):
            t0 = time.perf_counter()
            if nt0 > 1 and (nt0 - 1) % ndtocn == 0:
                st, frc = forcing_mod.update_fluxes(
                    model.cfg, st, prm, frc, raw, False, model.grid.dm)
            st = stepper.run(nt0, k, st, prm, frc)
            sync()
            span_ms.append((time.perf_counter() - t0) * 1e3)
        diag.flush()
        launches = dict(ck.LAUNCHES)      # ... and is read here
        if launches["fused_step"] < CHAIN_STEPS or stepper.captures < 1 \
                or stepper.replays != len(span_ms) \
                or not torch_all_finite(st):
            raise AssertionError(f"{layout} chain: {launches}, "
                                 f"{stepper.captures} captures, "
                                 f"{stepper.replays} replays")
        finals[layout] = st
        files[layout] = read_nc_dir(out)
        res[layout] = {"span_ms": span_ms, "captures": stepper.captures,
                       "replays": stepper.replays, "launches": launches}
        del model, stepper, diag
    a, b = finals["z_lanes"], finals["col_lanes"]
    differ = [f for f in a.__dataclass_fields__
              if not torch.equal(getattr(a, f), getattr(b, f))]
    if differ:
        raise AssertionError(f"chained z_lanes differs from col_lanes in "
                             f"{differ}")
    n_vars = same_bits(files["z_lanes"], files["col_lanes"],
                       "chained z_lanes vs col_lanes")
    emit({"phase": "chain_layouts", "card": name, "nvidia_smi": smi,
          "ncol": NCOL_MAIN, "nz": NZ_MAIN, "steps": CHAIN_STEPS,
          "state_fields_equal": len(a.__dataclass_fields__),
          "variables_equal": n_vars, **res})


def phase_day(name, t_start, work, data, land, dmax, device="cuda"):
    """One model day (72 steps) of the CLI when the script has used less
    than CLI_DAY_BEFORE_S."""
    import os
    import shutil
    day = None
    if time.perf_counter() - t_start < CLI_DAY_BEFORE_S:
        day = run_cli(data, os.path.join(work, "day"), CLI_DAY_STEPS,
                      device=device)
        hold_outputs(read_nc_dir(os.path.join(work, "day")), land, dmax)
        native_only(day, "the 72-step day")
        shutil.rmtree(os.path.join(work, "day"))
    emit({"phase": "cli_day", "card": name, "steps": CLI_DAY_STEPS,
          "ran": day is not None,
          "day": None if day is None else {k_: day.get(k_)
                                           for k_ in CLI_KEYS}})


# ---------------------------------------------------------------------------
# phase 10: the other four baseline configurations, the scaling harness
# ---------------------------------------------------------------------------

CONFIG_STEPS = 9        # one 3-h output_kpp_all window: every stream emits
CONFIG_MEMBERS = 10
SCALING_COLS = 64_800   # columns a rank (the global grid's)
SCALING_STEPS = 6


def hold_dir(path, land, dmax):
    """:func:`hold_outputs` over every .nc file of ``path``, one file at a
    time (the ensemble's window is 3.7 GB); returns (files, fields
    held)."""
    import os
    from scipy.io import netcdf_file
    files = sorted(f for f in os.listdir(path) if f.endswith(".nc"))
    n = 0
    for fn in files:
        nc = netcdf_file(os.path.join(path, fn), "r", mmap=False)
        try:
            for name, v in nc.variables.items():
                if len(v.shape) >= 3:
                    n += hold_outputs({fn: {name: v[:]}}, land, dmax)
        finally:
            nc.close()
    return len(files), n


def config_land(data_dir, members=1):
    """The (ny * members, nx) land mask of a configuration's inputs."""
    import os
    import numpy as np
    from mckpp_torch.io import ncio
    with ncio.open_nc(os.path.join(data_dir, "lsm.nc")) as nc:
        land = ncio.get_var(nc, "lsm") == 1.0
    return np.tile(land, (members, 1))


def hold_config(res, work, members=1, on_card=True):
    """A runner line's outputs: the five stream files, every field finite
    over ocean, land at the fill value, hmix in [0, dmax]; the step
    kernel launched; the card's name and power limit on the line."""
    import os
    import shutil
    data = os.path.join(work, res["config"])
    dmax = {"single_column": 2000.0, "regional_64x64": 500.0}.get(
        res["config"], 1000.0)
    files, fields = hold_dir(os.path.join(data, "out"),
                             config_land(data, members), dmax)
    if files != 5:
        raise AssertionError(f"{res['config']}: {files} stream files")
    if on_card and not res["launches"].get("fused_step"):
        raise AssertionError(f"{res['config']}: no fused_step launch")
    shutil.rmtree(data)
    return fields


def config_kernel_rows(config, cap, launches, name, ptxas):
    """:func:`kernel_row` for every kernel a configuration's run launched,
    on the inputs of its first launch there, with the run's counts; every
    launched kernel must have been captured."""
    rows = [{"config": config, **kernel_row(w.name, w, a, name, ptxas,
                                            launches[w.name])}
            for w, a in cap.calls]
    if {r["name"] for r in rows} != {k for k, v in launches.items() if v}:
        raise AssertionError(f"{config}: kernels captured "
                             f"{[r['name'] for r in rows]}, launched "
                             f"{launches}")
    return rows


def phase_configs(name, smi, work, ptxas=None, device="cuda", toy=False,
                  members=CONFIG_MEMBERS, scaling_cols=SCALING_COLS):
    """single_column, regional_64x64 and global_1deg through the CLI
    (``mckpp_torch.tools.run_baseline_benchmarks.run_cli_config``) and
    ensemble10_dd (``run_ensemble``, 10 members: 648,000 columns at
    nz = 40) at full width in float32, CONFIG_STEPS steps each, their
    outputs held; on the card, each kernel a configuration launched held
    to its plain version on the inputs of its first launch in that run
    and timed (:func:`kernel_row`, with the run's own launch counts);
    global_1deg once more under ``--profile``, its trace through
    ``mckpp_torch.tools.summarize_trace``; the scaling harness at 1 and 2
    ranks on the card (``tools.bench_scaling``).  Returns the kernel
    rows.  (Rehearse on the CPU with ``device="cpu", toy=True`` and a few
    members and scaling columns.)"""
    import os
    from mckpp_torch.ops import cuda_kernels as ck
    from mckpp_torch.tools import bench_scaling, summarize_trace
    from mckpp_torch.tools import run_baseline_benchmarks as rb
    keys = ("ncol", "nz", "steps", "wall_s", "model_loop_s", "physics_s",
            "diag_s", "flux_s", "init_s", "col_steps_per_s_steady",
            "col_steps_per_s_wall", "output_bytes", "output_files",
            "members",
            "peak_memory_bytes", "launches", "timers", "inputs_s")
    lines, seconds, rows = {}, {}, []
    for config in ("single_column", "regional_64x64", "global_1deg",
                   "ensemble10_dd"):
        t0 = time.perf_counter()
        ck.reset_counts()             # this configuration's run starts here
        with Capture() as cap:
            if config == "ensemble10_dd":
                res = rb.run_ensemble(work, CONFIG_STEPS, members, device,
                                      toy)
            else:
                res = rb.run_cli_config(config, work, CONFIG_STEPS, device,
                                        toy)
        res["launches_read"] = dict(ck.LAUNCHES)      # ... and is read here
        if res["launches_read"] != res["launches"]:
            raise AssertionError(f"{config}: counts {res['launches_read']} "
                                 f"!= the run's {res['launches']}")
        res["fields_held"] = hold_config(
            res, work, members if config == "ensemble10_dd" else 1,
            device == "cuda")
        seconds[config] = time.perf_counter() - t0
        krows = (config_kernel_rows(config, cap, res["launches_read"], name,
                                    ptxas) if device == "cuda" else [])
        del cap
        rows += krows
        lines[config] = {k: res.get(k) for k in keys + ("launches_read",
                                                        "fields_held")}
        seconds[config + "_kernels"] = time.perf_counter() - t0 - \
            seconds[config]
        emit({"phase": "config", "config": config, "card": name,
              "nvidia_smi": smi, **lines[config], "kernels": krows})
    t0 = time.perf_counter()
    tdir = os.path.join(work, "trace")
    rb.run_cli_config("global_1deg", work, 4, device, toy,
                      extra=("--profile", tdir, "--profile-steps", "2"))
    digest = summarize_trace.stats(summarize_trace.load(
        os.path.join(tdir, "trace.json")))
    if device == "cuda" and not any("fused_step_kernel" in k for k in
                                    digest.get("device_ms_by_kernel", {})):
        raise AssertionError(f"the trace digest names no step kernel: "
                             f"{digest}")
    seconds["global_1deg_trace"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scaling = bench_scaling.run(
        ["--ranks", "1,2", "--cols-per-rank", str(scaling_cols),
         "--steps", str(SCALING_STEPS), "--device", device])
    if scaling[-1]["metric"] != "split_cost" or \
            not scaling[-1]["time_shared"]:
        raise AssertionError(f"scaling summary: {scaling[-1]}")
    seconds["scaling"] = time.perf_counter() - t0
    emit({"phase": "configs", "card": name, "nvidia_smi": smi,
          "steps": CONFIG_STEPS,
          "trace_global_1deg": {k: digest.get(k) for k in (
              "device_idle_share", "kernel_ms_kpp", "kernel_ms_other",
              "kpp_share", "device_launches", "window_ms",
              "device_ms_by_kernel")},
          "scaling": scaling, "seconds": seconds})
    return rows


# ---------------------------------------------------------------------------
# phase 9: the CLI over two processes on the one card, and an ensemble
# ---------------------------------------------------------------------------

RANKS = 2
ENSEMBLE_MEMBERS = 4
ENSEMBLE_STEPS = 3
RANK_TIMEOUT_S = 600

# one rank of a --distributed run: the CLI's own entry, its summary
# printed as the last line
RANK_RUNNER = r"""
import json, sys, time
from mckpp_torch import cli
t0 = time.perf_counter()
summary = cli.run(sys.argv[1:])
summary["wall_s"] = time.perf_counter() - t0
print("SUMMARY " + json.dumps(summary, default=str), flush=True)
"""


def run_ranks(data_dir, out_dir, steps, namelist, extra=(), world=RANKS,
              device="cuda"):
    """``mckpp_torch.cli --distributed`` as ``world`` processes on this
    host, joined through the KPP_* variables (each takes cuda:(rank %
    cards), so here all share the one card), float32; returns their
    summaries in rank order."""
    import os
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--namelist", namelist, "--data-dir", data_dir, "--output-dir",
            out_dir, "--steps", str(steps), "--dtype", "float32",
            "--device", device, "--distributed", *extra]
    procs = []
    for r in range(world):
        env = dict(os.environ, KPP_COORDINATOR=f"127.0.0.1:{port}",
                   KPP_NUM_PROCS=str(world), KPP_PROC_ID=str(r),
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_RUNNER, *argv], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = []
    for r, (proc, log) in enumerate(zip(procs, logs)):
        lines = [ln for ln in log.splitlines() if ln.startswith("SUMMARY ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"rank {r} exit {proc.returncode}:\n"
                                 f"{log[-6000:]}")
        out.append(json.loads(lines[-1][len("SUMMARY "):]))
    return out


def hold_ranks(summaries, what, shard, on_card=True):
    """Each rank launched the step kernel and the full pass; the single
    writer gathered (rank 0 wrote every file), shard mode gathered
    nothing (every rank wrote its own); every file native."""
    for r, s in enumerate(summaries):
        zero = [k for k in ("fused_step", "fused_pass_full")
                if on_card and s["launches"][k] == 0]
        if zero:
            raise AssertionError(f"{what}: rank {r} launched no {zero}")
        if shard and s["emit_gathers"] != 0:
            raise AssertionError(f"{what}: rank {r} made "
                                 f"{s['emit_gathers']} emit gathers")
        if not shard and s["emit_gathers"] == 0:
            raise AssertionError(f"{what}: rank {r} gathered no window")
        if shard or r == 0:
            native_only(s, f"{what}, rank {r}")
        elif s["writes"]["native"] or s["writes"]["scipy"]:
            raise AssertionError(f"{what}: rank {r} wrote {s['writes']}")


def rank_rows(summaries):
    return [{"rank": s["rank"], "world": s["world"],
             "column_steps_per_s": s.get("column_steps_per_s"),
             "steady_s": s.get("steady_s"), "diag_output_s": diag_s(s),
             "wall_s": s["wall_s"], "peak_memory_bytes":
                 s["peak_memory_bytes"], "launches": s["launches"],
             "emit_gathers": s["emit_gathers"], "writes": s["writes"],
             "captures": s["captures"], "replays": s["replays"],
             "timers": s["timers"]}
            for s in summaries]


def encode_window_s(g_dir):
    """One full-width output_kpp_all window (its first record, every
    field) encoded by the native encoder and by scipy's writer
    (MCKPP_NO_NATIVE=1), in the order native, scipy, scipy, native;
    returns the seconds of each and the bytes of the file."""
    import os
    import numpy as np
    from scipy.io import netcdf_file
    from mckpp_torch.io import ncio
    src = sorted(f for f in os.listdir(g_dir)
                 if f.startswith("output_kpp_all"))[0]
    with netcdf_file(os.path.join(g_dir, src), "r", mmap=False) as nc:
        dims = {k: (1 if k == "time" else v)
                for k, v in nc.dimensions.items()}
        coords, fields, var_attrs = {}, {}, {}
        for k, v in nc.variables.items():
            if k in ("time", "z", "longitude", "latitude"):
                vals = np.array(v[:1] if k == "time" else v[:], np.float64)
                coords[k] = (v.dimensions[0], vals)
            else:
                fields[k] = (v.dimensions,
                             np.array(v[:1], np.float32, order="C"))
            var_attrs[k] = {a: (b.item() if isinstance(b, np.ndarray)
                                else b) for a, b in v._attributes.items()}
        attrs = {a: (b.item() if isinstance(b, np.ndarray) else b)
                 for a, b in nc._attributes.items()}
    out = os.path.join(g_dir, "window.nc")
    times = []
    for writer in ("native", "scipy", "scipy", "native"):
        if writer == "scipy":
            os.environ["MCKPP_NO_NATIVE"] = "1"
        w0 = dict(ncio.WRITES)
        t0 = time.perf_counter()
        try:
            ncio.write_fields(out, dims, coords, fields, attrs, var_attrs)
        finally:
            os.environ.pop("MCKPP_NO_NATIVE", None)
        times.append((writer, time.perf_counter() - t0))
        if ncio.WRITES[writer] != w0[writer] + 1:
            raise AssertionError(f"the window was not written by {writer}")
    nbytes = os.path.getsize(out)
    os.remove(out)
    return times, nbytes


def ensemble_check(data_dir, nml, name, device="cuda"):
    """ENSEMBLE_MEMBERS perturbed copies of the TerraMaris state, stepped
    ENSEMBLE_STEPS times as one batch, against the single run: member 0
    equal bit for bit, kernels launched."""
    import dataclasses
    import torch
    from mckpp_torch import ensemble as ens
    from mckpp_torch import forcing as forcing_mod
    from mckpp_torch import setup as setup_mod
    from mckpp_torch.ops import cuda_kernels as ck
    from mckpp_torch.state import tree_map
    from mckpp_torch.utils import namelist as nmlmod

    cfg, _ = nmlmod.load_config(nml)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model, st, prm, frc, fluxes, _ = setup_mod.build(cfg, data_dir,
                                                     device=device)
    raw = fluxes(cfg.time.startt)
    ncol = st.u.shape[0]

    def noise(m, gen, s, p, f):
        x = s.x.clone()
        x[..., 0] += 0.05 * torch.randn(x.shape[:-1], generator=gen,
                                        device=x.device, dtype=x.dtype)
        return s.replace(x=x), p, f

    def steps(s, p, f, r):
        s, f = forcing_mod.update_fluxes(cfg, s, p, f, r, True,
                                         model.grid.dm)
        for nt in range(1, ENSEMBLE_STEPS + 1):
            s = model.step(s, p, f, first_step=nt == 1,
                           with_diags=nt == ENSEMBLE_STEPS)
        return s

    single = steps(st, prm, frc, raw)
    est, eprm, efrc = ens.make_ensemble(st, prm, frc, ENSEMBLE_MEMBERS,
                                        noise, seed=0)
    del st, frc
    sync()
    ck.reset_counts()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stepped = steps(est, eprm, efrc, ens.replicate(raw, ENSEMBLE_MEMBERS))
    sync()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    zero = [k for k in ("fused_step", "fused_pass_full") if not launches[k]]
    if zero and on_card:
        raise AssertionError(f"ensemble: kernels not launched: {zero}")
    diffs = []
    tree_map(lambda a, b: diffs.append(not torch.equal(a, b)),
             ens.member_slice(stepped, 0, ncol), single)
    if any(diffs):
        raise AssertionError("ensemble member 0 differs from the single run")
    if torch.equal(ens.member_slice(stepped, 1, ncol).x, single.x):
        raise AssertionError("ensemble member 1 was not perturbed")
    mean, spread = ens.ensemble_mean_spread(stepped.x[..., 0],
                                            ENSEMBLE_MEMBERS)
    return {"members": ENSEMBLE_MEMBERS, "columns": int(stepped.u.shape[0]),
            "steps": ENSEMBLE_STEPS, "wall_s": wall, "launches": launches,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                  if on_card else None),
            "member0_bitwise_equal": True,
            "sst_spread_max": float(spread[:, 0].max()),
            "sst_mean_finite": bool(torch.isfinite(mean).all())}


def phase_distributed(name, smi, work, data, nml, g, straight,
                      device="cuda"):
    """Phase 9: the CLI as RANKS processes on the one card, single and
    shard mode, merged with mckpp_torch.tools.merge_shards, each equal bit
    for bit to phase 8's one-process graph-chained run; --multi-device
    (one worker per card) on the resume check's straight run (2k steps,
    the light iodef: on a one-card host it is the plain path once more,
    so the shorter run does), equal bit for bit to it; an ensemble; one
    output window encoded by both writers."""
    import os
    import shutil
    import torch
    from mckpp_torch import cli

    seconds = {}
    t_part = time.perf_counter()

    def part(label):
        nonlocal t_part
        now = time.perf_counter()
        seconds[label] = now - t_part
        t_part = now

    g_dir = os.path.join(work, "g")
    g_files = read_nc_dir(g_dir)
    if device == "cuda":
        torch.cuda.empty_cache()        # leave the card to the ranks

    single_dir = os.path.join(work, "d_single")
    single = run_ranks(data, single_dir, CLI_STEPS, nml, device=device)
    on_card = device == "cuda"
    hold_ranks(single, "single mode", shard=False, on_card=on_card)
    n_single = same_bits(g_files, read_nc_dir(single_dir),
                         "2 ranks, single mode vs 1 process")
    n_single += same_restart(g, single[0], "2 ranks, single mode")
    shutil.rmtree(single_dir)
    part("single")

    shard_dir = os.path.join(work, "d_shard")
    merged_dir = os.path.join(work, "d_merged")
    shard = run_ranks(data, shard_dir, CLI_STEPS, nml,
                      extra=("--output-mode", "shard"), device=device)
    hold_ranks(shard, "shard mode", shard=True, on_card=on_card)
    t0 = time.perf_counter()
    merge = subprocess.run(
        [sys.executable, "-m", "mckpp_torch.tools.merge_shards", shard_dir,
         "--dest", merged_dir], capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S)
    merge_s = time.perf_counter() - t0
    part("shard_runs_and_merge")
    if merge.returncode != 0 or " 0 scipy" not in merge.stdout:
        raise AssertionError(f"merge_shards: exit {merge.returncode}\n"
                             f"{merge.stdout[-3000:]}{merge.stderr[-3000:]}")
    n_shard = same_bits(g_files, read_nc_dir(merged_dir),
                        "2 ranks, shard mode merged vs 1 process")
    n_shard += same_restart(g, shard[0], "2 ranks, shard mode")
    shutil.rmtree(shard_dir)
    shutil.rmtree(merged_dir)
    del g_files
    part("shard_compare")

    nml_a, light, a = straight
    a_dir = os.path.join(work, "a")
    multi_dir = os.path.join(work, "d_multi")
    os.environ["MCKPP_CHAIN"] = "1"
    try:
        multi = cli.run(["--namelist", nml_a, "--iodef", light,
                         "--data-dir", data, "--output-dir", multi_dir,
                         "--steps", str(2 * RESUME_K), "--dtype", "float32",
                         "--device", device, "--multi-device"])
    finally:
        os.environ.pop("MCKPP_CHAIN", None)
    cards = torch.cuda.device_count() if device == "cuda" else 1
    if multi["world"] != cards:
        raise AssertionError(f"--multi-device ran {multi['world']} workers")
    for s in multi["workers"]:
        s["wall_s"] = None
    hold_ranks(multi["workers"], "--multi-device",
               shard=multi["world"] == 1, on_card=on_card)
    n_multi = same_bits(read_nc_dir(a_dir), read_nc_dir(multi_dir),
                        "--multi-device vs the plain run")
    n_multi += same_restart(a, multi["workers"][0], "--multi-device")
    shutil.rmtree(multi_dir)
    shutil.rmtree(a_dir)
    part("multi_device")

    window, window_bytes = encode_window_s(g_dir)
    part("window_encode")
    ensemble = ensemble_check(data, nml, name, device)
    part("ensemble")
    emit({"phase": "distributed", "card": name, "nvidia_smi": smi,
          "ranks": RANKS, "steps": CLI_STEPS, "ncol": single[0]["ncol"],
          "single": rank_rows(single), "shard": rank_rows(shard),
          "multi_device": rank_rows(multi["workers"]),
          "arrays_bitwise_equal": {"single": n_single, "shard": n_shard,
                                   "multi_device": n_multi},
          "merge_s": merge_s, "multi_device_steps": 2 * RESUME_K,
          "seconds": seconds,
          "window_encode_s": window, "window_bytes": window_bytes,
          "ensemble": ensemble,
          "note": "two ranks share one card: overhead, not scaling"})


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
    import os
    import shutil
    import tempfile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = T_START
    name, smi, ptxas, zl_build = phase_device()
    try:
        phase_gate(ptxas, zl_build)
    finally:                # its nvcc processes end before the script
        zl_build.thread.join()
    model, st, prm, frc, nt, counts = phase_main(name, smi)
    del model
    caps = phase_compare(st, prm, frc, nt)
    rows = phase_times(caps, counts, name, ptxas)
    phase_trace(st, prm, frc, nt, name)
    del st, prm, frc, caps
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        phase_chain_layouts(name, smi, work)
        phase_reference(name, smi)
        data, nml, land, dmax, g, straight = phase_cli(name, smi, work)
        phase_distributed(name, smi, work, data, nml, g, straight)
        cfg_rows = phase_configs(name, smi, os.path.join(work, "cfg"), ptxas)
        phase_times_ns4(name, ptxas)
        rows += [dict(r, name=f"{r['name']}_ns4") for r in cfg_rows
                 if r["level_slots"] == 4]
        rows += phase_deep_main(name, smi, ptxas)
        rows += phase_deep_main(name, smi, ptxas, DEEP_MAIN_ZL, "z_lanes")
        phase_deep_column(name, smi, work, cpu=False)
        nz_c, dmax_c, steps_c = DEEP_COLUMN_1000
        phase_deep_column(name, smi, work, nz=nz_c, dmax=dmax_c,
                          steps64=steps_c)
        nz_c, dmax_c, steps_c = DEEP_COLUMN_2000
        rows += phase_deep_column(name, smi, work, nz=nz_c, dmax=dmax_c,
                                  steps64=steps_c, ptxas=ptxas)
        phase_day(name, t_start, work, data, land, dmax)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    # each kernel x library x layout a path launched: 3 slots on the main
    # path (phase 3, both layouts), 4 on single_column's (phase 10), 6 and
    # 8 slots, a column over 4 and 8 warps and a cluster on the deep main
    # path (phase 11; z_lanes at 4 warps and the cluster)
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
