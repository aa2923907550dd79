#!/usr/bin/env python3
"""Drive mckpp_torch's main path on one CUDA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py

Phases, each printing JSON lines; any breach raises, so the script exits
0 only when every phase passed:

1. device: card name, power limit, versions; build the CUDA kernels;
2. kernel gate: each kernel against its plain torch version on the same
   float32 inputs at several (ncol, nz) shapes and flag sets, plus one
   float64 instantiation;
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
   beside the card's bound.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the mckpp_torch package beside it, the script exits non-zero.
"""

import json
import math
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
          boundary=None, noise=0.0, seed=0, land=0.0):
    import numpy as np
    import torch
    import mckpp_torch as T
    from mckpp_torch import forcing as forcing_mod
    from mckpp_torch.grid import coriolis
    from mckpp_torch.state import init_params

    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=1000.0),
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
    prm = init_params(ncol, nzp1, dtype=dt, device=dev)
    lat = torch.linspace(-30.0, 30.0, ncol, dtype=dt, device=dev)
    prm = prm.replace(f=coriolis(lat), dlat=lat)
    if land:
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
    ptxas = {str(dt).replace("torch.", ""): [
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "stack frame" in ln or "Compiling entry" in ln]
        for dt, log in reports.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    return name, smi


GATE_FLAGS = {
    "default_analytic": dict(physics=dict(wscale_mode="analytic")),
    "nodal": dict(physics=dict(wscale_mode="nodal")),
    "ldd": dict(physics=dict(ldd=True)),
    "advect": dict(boundary=dict(l_advect=True)),
    "relax_ocnt_sal": dict(boundary=dict(l_relax_ocnt=True, l_relax_sal=True)),
    "lkpp_off": dict(physics=dict(lkpp=False)),
}
# (ncol, nz): two widths, an odd ncol, an ncol below one 128-thread
# block, nz=65 (nz just over 64: one more PCR stage, WZ=67 just over 64
# for the scans) and nz=94 (WZ=96, the kernels' MAXWZ)
GATE_SHAPES = [(512, 69), (256, 40), (300, 33), (37, 69), (129, 65), (64, 94)]


def gate_case(ncol, nz, dtype, flags, tol, seed):
    out = {}
    for impl in ("cuda", "cuda_step"):
        model, st, prm, frc = build(ncol, nz, dtype, impl, noise=0.05,
                                    seed=seed, land=0.1, **flags)
        st, frc = run_steps(model, st, prm, frc, 1, 2)
        with Capture() as cap:
            run_steps(model, st, prm, frc, 3, 1)
        names = (("fused_pass_fast", "fused_pass_full") if impl == "cuda"
                 else ("fused_step",))
        for name in names:
            w, a = cap.first(name)
            got = w.launch(*a)
            ref = plain_of(w, a)
            sync()
            out[name] = compare(w, got, ref, tol)
    return out


def phase_gate():
    worst = {}
    n = 0
    for si, (ncol, nz) in enumerate(GATE_SHAPES):
        for fi, (fname, flags) in enumerate(GATE_FLAGS.items()):
            # every flag set at the first shape, the default at the others
            if si > 0 and fname not in ("default_analytic", "advect"):
                continue
            res = gate_case(ncol, nz, "float32", flags, TOL_F32, 10 * si + fi)
            emit({"phase": "gate", "ncol": ncol, "nz": nz, "flags": fname,
                  "dtype": "float32", "max_rel": res})
            for k, v in res.items():
                worst[k] = max(worst.get(k, 0.0), v)
            n += 1
    res = gate_case(300, 33, "float64", GATE_FLAGS["nodal"], TOL_F64, 99)
    emit({"phase": "gate", "ncol": 300, "nz": 33, "flags": "nodal",
          "dtype": "float64", "max_rel": res})
    emit({"phase": "gate_ok", "cases": n + 1, "worst_f32": worst})
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


def pass_ops(nz, kbl):
    """Floating-point operations of one pass of one column, counted from
    csrc/fused_pass.cuh (each add, mul, div, sqrt, exp, pow is one):
    per level 12 relax + 270 EOS (abk80 ~190, cpsw ~70, rho/buoy) +
    11 solar + 6*WZ reference averages + 14 shear/dbloc + 30 rimix +
    4 x 15 x ceil(log2 nz) PCR + 3 x 8 tridcof + 2 x 12 tridrhs + 8 U/V
    RHS + 8 T/S increments; per level above kbl 110 bldepth and 150 blmix
    (each with one ~45-op wscale); ~120 per column of surface terms."""
    wz = nz + 2
    stages = math.ceil(math.log2(nz))
    per_level = (12 + 270 + 11 + 6 * wz + 14 + 30 + 60 * stages + 24 + 24
                 + 8 + 8)
    return wz * per_level + (kbl - 1) * (110 + 150) + 120


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


def phase_times(caps, counts, name):
    import torch
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
        # bytes: every input read once, every output written once
        nbytes = sum(x.numel() * x.element_size() for x in a) + \
            sum(x.numel() * x.element_size() for x in got)
        if kname == "fused_step":
            # this run's passes per column (colstep row 7), each with the
            # bldepth/blmix levels above the column's kmix
            kmix, npass = got[8][1].double(), got[8][7].double()
            ops = float((npass * (pass_ops(nz, 1)
                                  + (kmix - 1).clamp_min(0) * 260)).sum())
        else:
            kbl = got[8 if kname == "fused_pass_fast" else 4][1].double()
            ops = float(ncol * pass_ops(nz, 1)
                        + ((kbl - 1).clamp_min(0) * 260).sum())
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
            "shape": [nz + 2, ncol]})
    emit({"phase": "kernel_times", "card": name, "rows": rows})
    return rows


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
    name, smi = phase_device()
    phase_gate()
    model, st, prm, frc, nt, counts = phase_main(name, smi)
    del model
    caps = phase_compare(st, prm, frc, nt)
    rows = phase_times(caps, counts, name)
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
