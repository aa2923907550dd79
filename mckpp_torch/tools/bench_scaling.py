"""Weak-scaling harness: a fixed number of columns a rank, a growing number
of ranks (the port's counterpart of ``bench_scaling.py``).

Columns are independent, so with one card a rank the ideal is a flat step
time as the ranks grow.  Each rank of a ``torch.distributed`` group
(``parallel/distributed.py``: the ``KPP_*`` rendezvous or torchrun's)
builds the same synthetic domain of ``cols_per_rank * ranks`` columns,
keeps its own slab (``ColumnLayout``), steps it and times its steps.

Usage:
  python -m mckpp_torch.tools.bench_scaling [--ranks 1,2,4]
      [--cols-per-rank N] [--nz N] [--steps N] [--device cuda|cpu]
  torchrun --nproc-per-node N -m mckpp_torch.tools.bench_scaling
      [same options]                      # one rank count: the group's

Without rendezvous variables it starts each rank count's processes itself
(``KPP_*``, on this host).  It prints one JSON line per rank count (step
ms of each rank, column-steps/s of each rank and in total), then a
summary line.  Where there are more ranks than devices (cards; the CPU is
one), the ranks share a device's time: the lines say ``"time_shared":
true`` and the summary is ``split_cost``, the step time of N ranks over N
times the step time of one (1: the split costs nothing), not the
``weak_scaling_efficiency`` (one rank's step time over N ranks').
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from .run_baseline_benchmarks import card

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANK_TIMEOUT_S = 900


def build(ncol, nz, dtype="float32", device="cuda"):
    """The synthetic domain of ``bench_scaling.py``'s ``build``: warm-start
    profiles with seeded noise on T, latitudes from 60 S to 60 N, the
    constant test fluxes."""
    from .. import DomainConfig, KppConfig, KppModel, TimeConfig
    from .. import forcing as forcing_mod
    from ..grid import coriolis
    from ..state import init_params

    cfg = KppConfig(domain=DomainConfig(nx=ncol, ny=1, nz=nz, dmax=1000.0),
                    time=TimeConfig(dtsec=3600.0, ndtocn=3), dtype=dtype)
    model = KppModel(cfg, device=device)
    nzp1 = nz + 1
    zm = model.grid.zm.double().cpu().numpy()
    rng = np.random.default_rng(0)
    t0 = 20.0 + 8.0 * np.exp(zm / 80.0) + 0.5 * rng.standard_normal((ncol, 1))
    s0 = np.tile(35.0 - 0.4 * np.exp(zm / 120.0), (ncol, 1))
    u0 = np.zeros((ncol, nzp1, 2))
    prm = init_params(ncol, nzp1, dtype=model.dtype, device=model.device)
    lat = torch.linspace(-60.0, 60.0, ncol, dtype=model.dtype,
                         device=model.device)
    prm = prm.replace(f=coriolis(lat), dlat=lat)
    st, prm, frc = model.warm_start(u0, t0, s0, prm)
    raw = forcing_mod.constant_test_fluxes(ncol, model.dtype, model.device)
    st, frc = forcing_mod.update_fluxes(cfg, st, prm, frc, raw, True,
                                        model.grid.dm)
    return model, st, prm, frc


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_run(args) -> dict | None:
    """One rank: join the group, build the domain, keep this rank's slab,
    one warm-up step, then ``steps`` timed steps; rank 0 returns every
    rank's numbers (the others None)."""
    import torch.distributed as tdist
    from ..ops import cuda_kernels as ck
    from ..parallel import distributed as dist

    device = dist.initialize(device=args.device)
    rank, world = dist.process_index(), dist.process_count()
    ncol = args.cols_per_rank * world
    model, st, prm, frc = build(ncol, args.nz, args.dtype, device)
    layout = dist.make_layout(ncol, device=device)
    st, prm, frc = (layout.shard_tree(t) for t in (st, prm, frc))
    st = model.step(st, prm, frc, first_step=False, with_diags=True)
    _sync(device)
    launches0 = dict(ck.LAUNCHES)
    dist.warmup_collectives()             # the ranks start together
    t0 = time.perf_counter()
    for _ in range(args.steps):
        st = model.step(st, prm, frc, first_step=False, with_diags=True)
    _sync(device)
    dt = (time.perf_counter() - t0) / args.steps
    mine = {"rank": rank, "step_s": dt, "pass_impl": model.pass_impl,
            "device": str(device),
            "finite": bool(torch.isfinite(st.x).all()),
            "launches": {k: ck.LAUNCHES[k] - launches0[k]
                         for k in launches0}}
    every = [mine]
    if world > 1:
        every = [None] * world
        tdist.all_gather_object(every, mine)
    dist.shutdown()
    return every if rank == 0 else None


def devices(device: str) -> int:
    """Devices the ranks spread over: the cards, or the CPU as one."""
    return torch.cuda.device_count() if device == "cuda" else 1


def count_line(args, ranks: int, every: list) -> dict:
    """The JSON line of one rank count from its ranks' numbers."""
    step_s = [r["step_s"] for r in every]
    if not all(r["finite"] for r in every):
        raise RuntimeError(f"{ranks} ranks: non-finite state")
    per_rank = [args.cols_per_rank / s for s in step_s]
    name, limit = card(args.device)
    return {"metric": "weak_scaling_step_time", "ranks": ranks,
            "card": name, "power_limit": limit,
            "devices": devices(args.device),
            "time_shared": ranks > devices(args.device),
            "cols_per_rank": args.cols_per_rank,
            "ncol": args.cols_per_rank * ranks, "nz": args.nz,
            "steps": args.steps, "dtype": args.dtype,
            "pass_impl": every[0]["pass_impl"],
            "step_ms_per_rank": [1e3 * s for s in step_s],
            "step_ms": 1e3 * max(step_s),
            "column_steps_per_s_per_rank": per_rank,
            "column_steps_per_s_total": sum(per_rank),
            "launches_per_rank": [r["launches"] for r in every]}


def summary_line(lines: list) -> dict:
    """``split_cost`` where any count time-shares a device, else the
    weak-scaling efficiency, between the fewest and the most ranks."""
    first, last = lines[0], lines[-1]
    n = last["ranks"] / first["ranks"]
    shared = any(ln["time_shared"] for ln in lines)
    if shared:
        return {"metric": "split_cost",
                "value": last["step_ms"] / (n * first["step_ms"]),
                "unit": f"t({last['ranks']} ranks) / ({n:g} x "
                        f"t({first['ranks']} rank(s))), "
                        f"{first['cols_per_rank']} columns a rank, ranks "
                        "sharing a device",
                "time_shared": True}
    eff = first["step_ms"] / last["step_ms"]
    return {"metric": "weak_scaling_efficiency", "value": eff,
            "unit": f"t({first['ranks']}) / t({last['ranks']} ranks), "
                    f"{first['cols_per_rank']} columns a rank",
            "vs_baseline": eff / 0.8, "time_shared": False}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(args, ranks: int) -> dict:
    """Run ``ranks`` processes of this module on this host (``KPP_*``
    rendezvous); returns the line of this rank count that rank 0
    printed."""
    port = _free_port()
    argv = [sys.executable, "-m", "mckpp_torch.tools.bench_scaling",
            "--cols-per-rank", str(args.cols_per_rank), "--nz",
            str(args.nz), "--steps", str(args.steps), "--dtype", args.dtype,
            "--device", args.device]
    procs = []
    for r in range(ranks):
        env = dict(os.environ, KPP_COORDINATOR=f"127.0.0.1:{port}",
                   KPP_NUM_PROCS=str(ranks), KPP_PROC_ID=str(r),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{ranks} ranks: rank {r} exit "
                               f"{p.returncode}:\n{log[-4000:]}")
    found = [ln for ln in logs[0].splitlines()
             if ln.startswith('{"metric": "weak_scaling_step_time"')]
    if not found:
        raise RuntimeError(f"{ranks} ranks: rank 0 printed no result:\n"
                           f"{logs[0][-4000:]}")
    return json.loads(found[0])


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="1,2",
                    help="rank counts to run, comma-separated (without a "
                         "rendezvous in the environment)")
    ap.add_argument("--cols-per-rank", type=int, default=64_800)
    ap.add_argument("--nz", type=int, default=40)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def run(argv=None) -> list:
    """The harness; returns the lines it printed (the summary last)."""
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda (the default) and no CUDA device is "
                         "available; pass --device cpu")
    in_group = any(os.environ.get(v) for v in ("KPP_NUM_PROCS",
                                               "WORLD_SIZE"))
    if in_group:
        every = rank_run(args)
        if every is None:
            return []
        lines = [count_line(args, len(every), every)]
    else:
        lines = [spawn(args, int(n)) for n in args.ranks.split(",")]
    lines.append(summary_line(lines))
    for ln in lines:
        print(json.dumps(ln), flush=True)
    return lines


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
