"""One run of one cell: set-up, the measured window, the check, the
metrics and the result line.

Set-up writes the cell's inputs (``inputs.py``) and runs a short warm
``mckpp_torch.cli.run`` of one simulated day with the cell's streams and
no restart: it loads (on a checkout's first run, builds) the cell's own
kernel library and the NetCDF encoder and runs every emit path the
window runs.  The timed run's length is a fixed amount of work: N =
``--seconds`` x the cell's ``steps_per_s`` (``cells/<cell>.json``, the
rate measured when the cell was defined) in whole days, at least two,
so that every run of a cell, and the parent and the change of a later
check, run the same steps.  The timed run is ``cli.run`` with the CLI's
defaults on N steps, a restart at step N - day (the check starts its
last stretch there) and at the end.  The window runs from the end of
its ``Initialization`` timer (the CLI synchronises the card there) to
the return of ``cli.run``, after the last diagnostics flush and the
final restart.  ``--trace 1`` runs ``torch.profiler`` over the window,
with spans of the benchmark's own around the program's layers.  Then
the check (``check.py``) runs the reference over two stretches of the
window on sampled columns, and each metric's reader
(``metrics/<name>.py``) reads the run.

A traffic file gives the iodef's streams and nothing else: every run
takes the reference's analytic surface fluxes and writes restarts only at
N - day and N.  A mix of flux files, or another restart cadence, needs
an edit here (the restarts :func:`structure` expects), in ``inputs.py``
(a flux file, the namelist's flags) and in the reference's forcing."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import sys
import time

import numpy as np

from . import check, inputs, spec, tracing, yardstick

JAX_NAMES = ("jax", "jaxlib", "flax", "mckpp_tpu")
WARM_DAYS = 1
MIN_DAYS = 2


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    steps: int                 # N, the ocean steps of the window
    dto: float
    ncol: int                  # every column of the grid, land included
    setup_s: float
    window_s: float
    init_s: float
    peak_bytes: int
    summary: dict              # the CLI's summary of the timed run
    events: list = None        # the traced window's events (--trace 1)
    stats: dict = None         # tracing.stats of them
    ops_per_step: float = 0.0  # the step's operations (ocean columns)
    step_bytes: int = 0        # bytes of one whole-step kernel launch
    peaks: tuple = (yardstick.FP32_PEAK, yardstick.HBM_PEAK)


def cache_env(root: str) -> None:
    """Every compiler or kernel cache that a library of the run might
    use, at fixed paths inside the checkout (the port builds its own into
    ``mckpp_torch/_build/``)."""
    base = os.path.join(root, "kppbench", "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def _cli_argv(data: str, out: str, dtype: str, device: str) -> list:
    return ["--namelist", os.path.join(data, "3D_ocn.nml"),
            "--data-dir", data, "--output-dir", out, "--dtype", dtype,
            "--device", device]


@contextlib.contextmanager
def patched(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _span(label):
    """A wrapper that records ``label`` as a profiler span per call."""
    def wrap(fn):
        import torch

        @functools.wraps(fn)
        def inner(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return inner
    return wrap


def _spans(stack: contextlib.ExitStack) -> None:
    """Host spans around the program's layers, for the traced run."""
    from mckpp_torch import forcing
    from mckpp_torch.io import ancillaries, diagnostics, restart
    from mckpp_torch.models import chain
    for obj, name, label in (
            (chain.ChainedStepper, "exec", "chain.exec"),
            (chain.ChainedStepper, "commit", "chain.commit"),
            (forcing, "update_fluxes", "forcing.update"),
            (ancillaries.BoundaryManager, "update", "ancillary.update"),
            (diagnostics.DiagnosticsManager, "_materialize", "diag.fetch"),
            (diagnostics.DiagnosticsManager, "_encode", "diag.encode"),
            (diagnostics.DiagnosticsManager, "flush", "diag.flush"),
            (restart.RestartControl, "_write", "restart.write"),
            (restart.RestartControl, "flush", "restart.flush")):
        stack.enter_context(patched(obj, name, _span(label)))


def _run_cli(argv: list, log: str, on_init=None):
    """``cli.run(argv)`` with its stdout appended to ``log``; ``on_init``
    is called once the run's Initialization timer stops.  Returns (the
    CLI's summary, the Initialization seconds)."""
    from mckpp_torch import cli
    from mckpp_torch.utils import timer
    seen = {}

    def wrap(stop):
        def inner(self, name):
            stop(self, name)
            if name == "Initialization" and "init_s" not in seen:
                seen["init_s"] = self._elapsed[name]
                if on_init is not None:
                    on_init()
        return inner

    with open(log, "a") as f, contextlib.redirect_stdout(f), \
            patched(timer.Timers, "stop", wrap):
        summary = cli.run(argv)
    return summary, seen["init_s"]


def window_steps(seconds: float, steps_per_s: float, day: int) -> int:
    """N: ``seconds`` at ``steps_per_s``, in whole days, at least
    MIN_DAYS."""
    return max(MIN_DAYS, int(round(seconds * steps_per_s / day))) * day


def jax_loaded() -> list:
    """The JAX packages (or the JAX package of this repository) that the
    process has imported, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(JAX_NAMES))


def reference_jobs(cfg, traffic, data, out, cols, steps, day, dtype,
                   wscale) -> list:
    """The two stretches of :mod:`check` as arguments of
    ``check.segment``."""
    dto = cfg["dtsec"] / cfg["ndtocn"]
    specs = check.stream_specs(traffic, dto)
    base = {"config": cfg, "data_dir": data, "cols": [int(c) for c in cols],
            "dtype": dtype, "wscale": wscale, "streams": specs}
    c = steps - day
    blob = check.npz_columns(restart_path(out, c, dto), cols)
    return [dict(base, start="files", nt0=0, nt1=day),
            dict(base, start=blob, nt0=c, nt1=steps)]


def restart_path(out: str, nt: int, dto: float) -> str:
    """The CLI's restart after step ``nt`` (named by the next step's
    validity time)."""
    return os.path.join(out, f"restart_out_{nt * dto / 86400.0:012.5f}.npz")


def program_outputs(traffic, out, cols, dto) -> dict:
    """{stream: {time: {out: values at ``cols``}}} as the run wrote
    them."""
    return {name: check.stream_records(out, name, [o for o, _, _ in ents],
                                       cols)
            for name, _, ents in check.stream_specs(traffic, dto)}


def structure(traffic, prog: dict, out: str, n_ocean: int, steps: int,
              day: int, dto: float) -> dict:
    """The exact checks: sampled land cells not at the fill value or
    ocean cells at it or not finite (``fill_bad``), and records or
    restarts missing or extra (``records_bad``)."""
    fill_bad, records_bad = 0, 0
    for name, freq, ents in check.stream_specs(traffic, dto):
        want = {round(k * freq * dto / 86400.0, 6)
                for k in range(1, steps // freq + 1)}
        records_bad += len(want ^ set(prog[name]))
        for rec in prog[name].values():
            for out_name, _, _ in ents:
                a = np.asarray(rec[out_name], np.float32)
                fill_bad += int(np.sum(a[n_ocean:] != check.FILL_VALUE))
                ocean = a[:n_ocean]
                fill_bad += int(np.sum((ocean == check.FILL_VALUE)
                                       | ~np.isfinite(ocean)))
    for nt in (steps - day, steps):
        path = restart_path(out, nt, dto)
        if not os.path.exists(path):
            records_bad += 1
            continue
        meta = check.npz_columns(path, [0], prefixes=("meta_ntime",))
        records_bad += int(int(meta["meta_ntime"]) != nt)
    return {"fill_bad": float(fill_bad), "records_bad": float(records_bad)}


def judge(values: dict, specs, limits: dict) -> dict:
    """{name: (value, limit)} of the numbers that have a limit; a limit
    of null marks a number that no limit separates (PERF.md gives its
    readings), read but not compared."""
    checks = {k: (v, check.limit_of(k, specs, limits))
              for k, v in values.items()}
    return {k: c for k, c in checks.items() if c[1] is not None}


def verdict(checks: dict) -> tuple:
    """(correct, attempted, failed) of ``checks`` {name: (value,
    limit)}."""
    failed = sum(1 for v, lim in checks.values() if not v <= lim)
    return failed == 0, len(checks), failed


def correctness(cell, cfg, data, out, seed, steps, day, wscale,
                control=False) -> tuple:
    """(checks {name: (value, limit)}, the reference's work per step,
    the control's checks or None)."""
    dto = cfg["dtsec"] / cfg["ndtocn"]
    lsm = check.read_lsm(os.path.join(data, "lsm.nc"))
    ocean, land = check.sample(lsm, seed)
    cols = np.concatenate([ocean, land])
    n_ocean = len(ocean)
    jobs = reference_jobs(cfg, cell.traffic, data, out, cols, steps, day,
                          "float64", wscale)
    if control:
        jobs += [dict(j, dtype="bfloat16") for j in jobs]
    res = check.run_segments(jobs, workers=len(jobs))
    first, last = res[0], res[1]
    prog = program_outputs(cell.traffic, out, cols, dto)
    end = check.npz_columns(restart_path(out, steps, dto), cols,
                            prefixes=("st_", "pr_sref"))
    end_state = {"T": end["st_x"][..., 0],
                 "S": end["st_x"][..., 1] + end["pr_sref"][:, None],
                 "U": end["st_u"][..., 0], "V": end["st_u"][..., 1],
                 "hmix": end["st_hmix"], "kmix": end["st_kmix"]}
    specs = check.stream_specs(cell.traffic, dto)
    values = check.compare(specs, prog, first, last, end_state, n_ocean)
    values.update(structure(cell.traffic, prog, out, n_ocean, steps, day,
                            dto))
    checks = judge(values, specs, cell.limits)
    ctl = None
    if control:
        # the control's own records and final state in the program's
        # place, judged by the same numbers and limits
        c_first, c_last = res[2], res[3]
        c_prog = {name: {**c_first["records"].get(name, {}),
                         **c_last["records"].get(name, {})}
                  for name, _, _ in specs}
        ctl = judge(check.compare(specs, c_prog, first, last,
                                  c_last["state"], n_ocean),
                    specs, cell.limits)
    work = [w for r in (first, last) for w in r["work"]]
    npass = np.stack([w[0][:n_ocean] for w in work])
    kmix = np.stack([w[1][:n_ocean] for w in work])
    return checks, (npass, kmix), ctl


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: str = spec.ROOT, device: str = "cuda", shrink: int = 1,
             t0: float = None, control: bool = False,
             work: str = None) -> dict:
    """One run of ``workload``; returns the result line's object (and,
    with ``control``, the control's numbers under ``"control"``).
    ``work``: the run's directory (default ``kppbench/_work/<cell>``,
    the static inputs under ``kppbench/_cache``); ``device`` "cpu" and
    ``shrink`` (the grid's nx and ny divided by it) are for the tests."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.resolve(workload, root)
    cfg = dict(cell.config)
    if shrink > 1:
        cfg["nx"] = max(4, cfg["nx"] // shrink)
        cfg["ny"] = max(4, cfg["ny"] // shrink)
    dto = cfg["dtsec"] / cfg["ndtocn"]
    day = int(round(86400.0 / dto))
    cache_env(root)
    static_root = os.path.join(root, "kppbench", "_cache", "inputs")
    if work is None:
        work = os.path.join(root, "kppbench", "_work", workload)
    else:
        static_root = os.path.join(work, "static")
    shutil.rmtree(work, ignore_errors=True)
    data, out = os.path.join(work, "inputs"), os.path.join(work, "out")
    warm_out = os.path.join(work, "warm")
    log = os.path.join(work, "cli.log")
    static = os.path.join(static_root,
                          f"{cfg['name']}-{cfg['nx']}x{cfg['ny']}")
    inputs.prepare(cfg, cell.traffic, static, data, seed)

    import torch
    from mckpp_torch import cli  # noqa: F401  (imports the program)
    argv = lambda o: _cli_argv(data, o, cfg["dtype"], device)
    nml = os.path.join(data, "3D_ocn.nml")

    # warm run: one day, the cell's streams, no restart
    with open(nml, "w") as f:
        f.write(inputs.namelist(cfg, WARM_DAYS * day, 0, restart=False))
    warm, _ = _run_cli(argv(warm_out), log)
    shutil.rmtree(warm_out, ignore_errors=True)
    warm_rate = warm["column_steps_per_s"] / warm["ncol"]
    steps = window_steps(seconds, cell.steps_per_s, day)
    with open(nml, "w") as f:
        f.write(inputs.namelist(cfg, steps, steps - day))
    del warm
    gc.collect()
    on_cuda = device == "cuda"
    if on_cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    marks = {}
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            _spans(stack)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)

        def on_init():
            marks["start"] = time.perf_counter()
            if prof is not None:
                prof.__enter__()

        summary, init_s = _run_cli(argv(out), log, on_init)
        if on_cuda:
            torch.cuda.synchronize()
        marks["end"] = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    events = stats = None
    t_trace = time.perf_counter()
    if prof is not None:
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        events = tracing.load(path)
        os.remove(path)
        stats = tracing.stats(events)
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()

    wscale = ("analytic" if on_cuda and cfg["dtype"] == "float32"
              else "nodal")
    checks, (npass, kmix), ctl = correctness(
        cell, cfg, data, out, seed, steps, day, wscale, control=control)
    t_done = time.perf_counter()
    lsm = check.read_lsm(os.path.join(data, "lsm.nc"))
    n_ocean = int(np.sum(lsm != 1.0))
    zm = check.model_levels(os.path.join(data, "vgrid.nc"))
    aref = yardstick.kernel_aref(zm, getattr(torch, cfg["dtype"]))
    ops = np.mean([yardstick.step_ops(cfg["nz"], aref, p, k,
                                      cfg["physics"]["ldd"])
                   for p, k in zip(npass, kmix)]) / npass.shape[1]
    name = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    run = Run(steps=steps, dto=dto, ncol=int(summary["ncol"]),
              setup_s=marks["start"] - t0,
              window_s=marks["end"] - marks["start"], init_s=init_s,
              peak_bytes=peak, summary=summary, events=events, stats=stats,
              ops_per_step=float(ops) * n_ocean,
              step_bytes=yardstick.step_bytes(int(summary["ncol"]),
                                              cfg["nz"], aref),
              peaks=yardstick.card_peaks(name))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct, attempted, failed = verdict(checks)
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "kind": name,
                         "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if trace and stats and stats.get("device_events"):
        result["device"]["busy_s"] = stats["device_busy_ms"] / 1e3
        result["device"]["window_s"] = stats["window_ms"] / 1e3
        result["breakdown"] = tracing.breakdown(events)
    result["run"] = {"steps": steps, "window_s": run.window_s,
                     "warm_steps_per_s": warm_rate,
                     "trace_read_s": t_ref - t_trace,
                     "check_s": t_done - t_ref,
                     "bytes_written": int(summary["bytes_written"]),
                     "card": yardstick.smi_line() if on_cuda else "cpu"}
    if ctl is not None:
        c_correct, _, c_failed = verdict(ctl)
        result["control"] = {"correct": c_correct, "failed": c_failed,
                             "values": {k: v for k, (v, _) in ctl.items()}}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    # last: the metric readers are loaded above, and one of them may
    # import what the program itself did not
    found = jax_loaded()
    if found:
        raise RuntimeError(f"the process imported {found}: no result")
    return result


def report(result: dict) -> None:
    """The checks on standard error, last, then the result line last on
    standard output; nothing where the process holds JAX or the JAX
    package."""
    found = jax_loaded()
    if found:
        raise RuntimeError(f"the process imported {found}: no result")
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
