"""Run the five BASELINE.json benchmark configurations end to end with the
port (the counterpart of ``tools/run_baseline_benchmarks.py``): the CLI
with its flux files, ancillary updates, the reference-shaped iodef
streams and restarts, and the ensemble through the library, in float32.

Usage: python -m mckpp_torch.tools.run_baseline_benchmarks
       [--configs a,b,...] [--steps 72] [--workdir DIR] [--keep] [--toy]
       [--device cuda|cpu] [--members 10] [--out FILE]

Each configuration's inputs are written by
``mckpp_torch.io.benchmark_inputs``; the four CLI configurations run
through ``mckpp_torch.cli.run`` in this process, with the arguments of
``python -m mckpp_torch.cli --dtype float32 --device DEVICE``, and
``ensemble10_dd`` runs its members as replicated columns of the global
set (``mckpp_torch.ensemble.make_ensemble``).  One JSON line per
configuration goes to stdout, with the card's name and power limit
(``nvidia-smi``; "cpu" on the CPU), the steady and wall column-steps/s,
the timer table, the bytes written, the peak device memory and the kernel
launches; ``--out`` also writes the lines as one JSON list.  On every
line ``wall_s`` runs from before the inputs are written to the end of
the last flush, ``model_loop_s`` is the ``Total`` timer (initialisation,
steps and flushes) and ``col_steps_per_s_wall`` divides the column-steps
by it.  A
configuration that fails prints an ``"error"`` line, the others still
run, and the exit code is 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from ..io.benchmark_inputs import CONFIGS, generate

STEADY_RE = re.compile(r"steady-state: ([\d.]+) s for the last (\d+) steps")


def parse_timers(text: str) -> dict:
    """{timer: (calls, seconds)} from the CLI's timer table."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"^(\w[\w ]*?)\s+(\d+)\s+([\d.]+)\s*$", line)
        if m:
            out[m.group(1).strip()] = (int(m.group(2)), float(m.group(3)))
    return out


def parse_steady(text: str, ncol: int):
    """Column-steps/s of the CLI's ``steady-state:`` line (the last half
    of the run) over ``ncol`` columns; None without the line."""
    m = STEADY_RE.search(text)
    if m is None:
        return None
    return float(m.group(2)) / float(m.group(1)) * ncol


def card(device: str):
    """(name, power limit) of the card as ``nvidia-smi`` reports them, or
    ("cpu", "cpu") for a CPU run."""
    if device == "cpu":
        return "cpu", "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def _outputs(out: str):
    ncs = [f for f in os.listdir(out) if f.endswith(".nc")]
    return len(ncs), sum(os.path.getsize(os.path.join(out, f)) for f in ncs)


def _inputs(config, workdir, toy):
    d = os.path.join(workdir, config)
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    grid = generate(config, d, toy)
    return d, grid, time.perf_counter() - t0


def _line(config, grid, steps, toy, device, inputs_s, wall, ncol, timers,
          out, peak, launches, steady):
    """A result line; one definition for every configuration: ``wall_s``
    from before the inputs are written to the end of the last flush,
    ``model_loop_s`` the ``Total`` timer (initialisation, steps and
    flushes) and ``col_steps_per_s_wall`` the column-steps over it."""
    total = timers["Total"]
    n_out, out_bytes = _outputs(out)
    return {
        "config": config, "ncol": ncol, "nz": grid["nz"], "steps": steps,
        "toy": toy, "device": device, "land_share": grid["land_share"],
        "inputs_s": inputs_s, "output_bytes": out_bytes,
        "output_files": n_out, "wall_s": wall, "model_loop_s": total,
        "physics_s": timers.get("Physics", float("nan")),
        "col_steps_per_s_steady": steady,
        "col_steps_per_s_wall": ncol * steps / total,
        "diag_s": timers.get("Diagnostic output", 0.0),
        "flux_s": timers.get("Update surface fluxes", 0.0),
        "init_s": timers.get("Initialization", 0.0),
        "restart_s": timers.get("Restart output", 0.0),
        "peak_memory_bytes": peak, "launches": launches, "timers": timers,
    }


def _reset_peak(device):
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def run_cli_config(config, workdir, steps, device="cuda", toy=False,
                   extra=()):
    """Write ``config``'s inputs, run the CLI (``mckpp_torch.cli.run``, in
    this process, its output captured) on them for ``steps`` steps in
    float32 on ``device`` and return the result line; the peak memory
    counts from the run's start.  ``extra``: further CLI arguments
    (``--profile DIR``)."""
    from .. import cli
    t0 = time.perf_counter()
    d, grid, inputs_s = _inputs(config, workdir, toy)
    out = os.path.join(d, "out")
    os.makedirs(out, exist_ok=True)
    argv = ["--namelist", os.path.join(d, "3D_ocn.nml"), "--data-dir", d,
            "--output-dir", out, "--steps", str(steps), "--dtype", "float32",
            "--device", device, *extra]
    _reset_peak(device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = cli.run(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    ncol = grid["nx"] * grid["ny"]
    timers = {k: v[1] for k, v in parse_timers(text).items()}
    return _line(config, grid, steps, toy, device, inputs_s, wall, ncol,
                 timers, out, summary["peak_memory_bytes"],
                 summary["launches"], parse_steady(text, ncol))


def run_ensemble(workdir, steps, n_members=10, device="cuda", toy=False):
    """ensemble10_dd: the global set (double diffusion on) x ``n_members``
    members as replicated columns (``ensemble.make_ensemble``, member m
    with a 0.01 C T perturbation from a generator seeded m), the
    whole-step kernel, the full iodef streams over ``ny * n_members``
    rows and the detached restarts, through a ``ColumnLayout``."""
    from .. import ensemble as ens
    from .. import forcing as forcing_mod
    from .. import setup as setup_mod
    from ..io.diagnostics import DiagnosticsManager
    from ..io.restart import RestartControl
    from ..io.streams import parse_iodef
    from ..ops import cuda_kernels as ck
    from ..parallel import distributed as dist
    from ..parallel.sharding import map_leaves
    from ..utils import namelist as nml
    from ..utils.timer import Timers

    t_wall = time.perf_counter()
    d, grid, inputs_s = _inputs("ensemble10_dd", workdir, toy)
    on_card = device == "cuda"
    _reset_peak(device)
    timers = Timers()
    timers.start("Initialization")
    cfg, _ = nml.load_config(os.path.join(d, "3D_ocn.nml"))
    cfg = dataclasses.replace(cfg, dtype="float32")
    model, st, prm, frc, flux_provider, _ = setup_mod.build(
        cfg, d, device=device)

    def perturb(m, gen, sm, pm, fm):
        x = sm.x[..., 0]
        noise = 0.01 * torch.randn(x.shape, generator=gen, device=x.device,
                                   dtype=x.dtype)
        xn, xsn = sm.x.clone(), sm.xs.clone()
        xn[..., 0] += noise
        xsn[..., 0, :] += noise[..., None]
        return sm.replace(x=xn, xs=xsn), pm, fm

    st, prm, frc = ens.make_ensemble(st, prm, frc, n_members,
                                     perturb=perturb, seed=0)
    ncol = st.u.shape[0]
    l_ocean = prm.l_ocean.cpu().numpy()
    layout = dist.make_layout(ncol, world=1, rank=0, device=model.device)
    st, prm, frc = (layout.shard_tree(t) for t in (st, prm, frc))

    def fluxes(time_days):
        rep = ens.replicate(flux_provider(time_days), n_members)
        return map_leaves(lambda a: layout.global_array(a, local=False), rep)

    nx, ny = grid["nx"], grid["ny"]
    out = os.path.join(d, "out")
    os.makedirs(out, exist_ok=True)
    streams = parse_iodef(os.path.join(d, "iodef.xml"), cfg.time.dto)
    diag = DiagnosticsManager(
        streams, nx, ny * n_members, model.grid.zm, outdir=out,
        start_time_days=cfg.time.startt, dto_seconds=cfg.time.dto,
        l_ocean=l_ocean)
    diag.set_layout(layout)
    restart = RestartControl(f"{out}/restart_out",
                             cfg.output.ndt_per_restart, steps,
                             cfg.time.dto, cfg.time.startt, layout=layout)
    if on_card:
        torch.cuda.synchronize()
    timers.stop("Initialization")
    launches0 = dict(ck.LAUNCHES)
    for nt in range(1, steps + 1):
        time_days = cfg.time.startt + (nt - 1) * cfg.time.dto / 86400.0
        if (nt - 1) % cfg.time.ndtocn == 0:
            with timers.section("Update surface fluxes"):
                st, frc = forcing_mod.update_fluxes(
                    cfg, st, prm, frc, fluxes(time_days), nt <= 1,
                    model.grid.dm)
        need_full = diag.needs_full(nt) or restart.due(nt)
        with timers.section("Physics"):
            st = model.step(st, prm, frc, first_step=(nt <= 1),
                            with_diags=need_full)
        with timers.section("Diagnostic output"):
            diag.step(nt, st, prm, frc)
        with timers.section("Restart output"):
            restart.maybe_write(nt, st, prm, frc)
    if on_card:
        torch.cuda.synchronize()
    with timers.section("Diagnostic output"):
        diag.flush()
    with timers.section("Restart output"):
        written = restart.flush()
    launches = {k: ck.LAUNCHES[k] - launches0[k] for k in launches0}
    t = {k: v[1] for k, v in parse_timers(timers.report()).items()}
    wall = time.perf_counter() - t_wall
    res = _line("ensemble10_dd", grid, steps, toy, device, inputs_s, wall,
                ncol, t, out, torch.cuda.max_memory_allocated()
                if on_card else None, launches, None)
    return {**res, "members": n_members, "restarts": len(written),
            "note": "members through ensemble.make_ensemble, ddmix on, the "
                    "full iodef streams over all members, detached restarts"}


def run_config(config, workdir, steps, device="cuda", toy=False,
               members=10):
    if config == "ensemble10_dd":
        return run_ensemble(workdir, steps, members, device, toy)
    return run_cli_config(config, workdir, steps, device, toy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--steps", type=int, default=72)
    ap.add_argument("--workdir", default=None,
                    help="where inputs and outputs go (default: a new "
                         "temporary directory)")
    ap.add_argument("--keep", action="store_true",
                    help="keep each configuration's inputs and outputs")
    ap.add_argument("--toy", action="store_true",
                    help="the inputs' --toy size (horizontal grid / 8)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--members", type=int, default=10,
                    help="ensemble10_dd's members")
    ap.add_argument("--out", default=None,
                    help="also write the result lines to FILE (JSON list)")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda (the default) and no CUDA device is "
                         "available; pass --device cpu")
    name, limit = card(a.device)
    workdir = a.workdir or tempfile.mkdtemp(prefix="mckpp_torch_bench_")
    os.makedirs(workdir, exist_ok=True)
    results, failed = [], []
    for config in a.configs.split(","):
        try:
            res = run_config(config, workdir, a.steps, a.device, a.toy,
                             a.members)
        except Exception as e:       # report it, run the rest, exit 1
            res = {"config": config, "error": f"{type(e).__name__}: "
                   f"{str(e)[:2000]}"}
            failed.append(config)
        res = {**res, "card": name, "power_limit": limit}
        results.append(res)
        print(json.dumps(res), flush=True)
        if not a.keep:
            shutil.rmtree(os.path.join(workdir, config),
                          ignore_errors=True)
    if a.workdir is None and not a.keep:
        shutil.rmtree(workdir, ignore_errors=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(results, f, indent=1)
    if failed:
        print(f"failed: {','.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
