"""Main program: the counterpart of ``mckpp_tpu/cli.py`` and of PROGRAM
mckpp_ocean_model_3d (mckpp_ocean_model_3D.F90:22-76).

Usage:  python -m mckpp_torch.cli [--namelist 3D_ocn.nml] [--data-dir DIR]
        [--output-dir DIR] [--steps N] [--iodef FILE] [--dtype D]
        [--device cuda|cpu] [--profile DIR [--profile-steps N]]
        [--distributed | --multi-device] [--output-mode single|shard]

Reads the reference-format namelist, assembles the model (``setup.build``,
with the initial mixing pass), and runs the time loop with the flux and
boundary updates, the diagnostic streams, restart writes and the
named-timer report.  The model runs on the card unless ``--device cpu``
is given.  Every event-free span of steps runs as one chain
(``models/chain.py``), replayed as a CUDA graph on the card;
``MCKPP_CHAIN=0`` runs the per-step loop instead and ``MCKPP_CHAIN_MAX``
caps a span's length.

``--distributed`` runs one process of a group (``parallel/distributed.py``:
the ``KPP_*`` or torchrun rendezvous variables, gloo, one card each):
the columns are split into one slab per process, each reads its own rows
of the inputs, and the diagnostics and restarts are gathered to rank 0
(``--output-mode single``) or written by every rank for its own rows
(``--output-mode shard``; merge with ``python -m
mckpp_torch.tools.merge_shards``).  ``--multi-device`` starts one such
process per visible card of this host (one on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import queue
import socket
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.multiprocessing as mp

from . import forcing as forcing_mod
from . import setup as setup_mod
from .io import ncio
from .io.diagnostics import DiagnosticsManager, Stream, default_streams
from .io.restart import RestartControl
from .models.chain import ChainedStepper, emit_due, plan_segments
from .ops import cuda_kernels as ck
from .parallel import distributed as dist
from .utils import namelist as nml
from .utils.logging import mckpp_print
from .utils.timer import Timers

ROUTINE = "MCKPP_TORCH_MAIN"


def _parser():
    p = argparse.ArgumentParser(description="MC-KPP ocean model on PyTorch "
                                            "and CUDA")
    p.add_argument("--namelist", default="3D_ocn.nml")
    p.add_argument("--data-dir", default=".")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--steps", type=int, default=None,
                   help="override the number of ocean timesteps")
    p.add_argument("--iodef", default=None,
                   help="iodef.xml-style stream-config file (overrides the "
                        "namelist's IODEF_FILE)")
    p.add_argument("--dtype", choices=["float64", "float32"], default=None,
                   help="override precision: float64 = reference parity "
                        "(the namelist default), float32 = production")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs: the card (default; raises "
                        "without one) or the CPU (the kernels' plain "
                        "versions)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (trace.json) of a "
                        "few steady-state steps into DIR, every thread's "
                        "where torch's profiler can follow them")
    p.add_argument("--profile-steps", type=int, default=6,
                   help="number of steps to trace under --profile")
    p.add_argument("--multi-device", action="store_true",
                   help="start one --distributed process per visible card "
                        "of this host (one on the CPU)")
    p.add_argument("--distributed", action="store_true",
                   help="one process of a group: the rendezvous from "
                        "KPP_COORDINATOR/KPP_NUM_PROCS/KPP_PROC_ID or "
                        "torchrun's variables; the columns are split over "
                        "the processes")
    p.add_argument("--output-mode", choices=["single", "shard"],
                   default="single",
                   help="diagnostic writes: 'single' gathers each emitted "
                        "window to rank 0 (XIOS one_file); 'shard' has "
                        "every rank write its own rows with no gather (XIOS "
                        "multiple_file); merge with python -m "
                        "mckpp_torch.tools.merge_shards")
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device):
    """The ``--profile`` window's profiler: the host, the card where the
    run has one, and every thread (the writer and prefetch threads too)
    where this torch's profiler can follow them."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        every = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):        # a torch without the option
        every = None
    return profile(activities=acts, experimental_config=every)


def _steady(marks_us: dict, num_steps: int, ndtocn: int):
    """(seconds, steps) of the run's second half on the hour marks
    (:class:`~mckpp_torch.utils.timer.HourMarks`): from the first hour
    that starts at or after the midpoint step to the end of the last;
    None under 4 steps or where no hour starts there."""
    if num_steps < 4:
        return None
    h = -(-(num_steps // 2) // ndtocn)       # first hour at step >= mid
    n2 = num_steps - h * ndtocn
    end = (num_steps - 1) // ndtocn + 1
    if n2 <= 0 or h not in marks_us or end not in marks_us:
        return None
    return (marks_us[end] - marks_us[h]) / 1e6, n2


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _worker(rank: int, world: int, port: int, argv, results) -> None:
    """One process of ``--multi-device``: the ``--distributed`` run with a
    local rendezvous; its summary (or its traceback) goes to ``results``."""
    os.environ.update(KPP_COORDINATOR=f"127.0.0.1:{port}",
                      KPP_NUM_PROCS=str(world), KPP_PROC_ID=str(rank),
                      LOCAL_RANK=str(rank))
    try:
        results.put((rank, run(argv + ["--distributed"]), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise


def _multi_device(argv, device: str) -> dict:
    """Start one worker per visible card (one on the CPU), wait for them
    and return {"workers": [their summaries in rank order]}."""
    world = torch.cuda.device_count() if device == "cuda" else 1
    argv = [a for a in argv if a != "--multi-device"]
    mckpp_print(ROUTINE, f"--multi-device: {world} worker process(es)")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, argv, results))
             for r in range(world)]
    for p in procs:
        p.start()
    summaries, errors = {}, []
    try:
        # drain the queue before joining: a worker blocks on a full pipe
        while len(summaries) + len(errors) < world:
            try:
                rank, summary, err = results.get(timeout=1.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and results.empty():
                    break
                continue
            if err is None:
                summaries[rank] = summary
            else:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=None if not errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if errors or bad or len(summaries) != world:
        raise RuntimeError(f"--multi-device: worker exit codes "
                           f"{[p.exitcode for p in procs]}\n"
                           + "\n".join(errors))
    return {"workers": [summaries[r] for r in range(world)], "world": world}


def run(argv=None) -> dict:
    """The CLI's run; returns its summary (segments, graph captures and
    replays, kernel launches, the steady-state rate, bytes written and the
    files each NetCDF writer wrote, the paths written, the timer report,
    the span log and the byte counters (``utils/timer.py``), and the
    rank, world size and emit gathers of a distributed run).
    Under ``--multi-device`` it returns {"workers": [each worker's]}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.multi_device and args.distributed:
        raise ValueError("--multi-device starts --distributed processes "
                         "itself: pass one of the two")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) and no CUDA device "
                           "is available; pass --device cpu")
    if args.multi_device:
        return _multi_device(argv, args.device)
    device = torch.device(args.device)
    if args.distributed:
        device = dist.initialize(device=args.device)
    rank, world = dist.process_index(), dist.process_count()

    timers = Timers()
    timers.start("Initialization")
    with timers.span("setup.namelist", device=False):
        cfg, extras = nml.load_config(args.namelist)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    mckpp_print(ROUTINE, f"read namelist {args.namelist}")
    for grp, vals in extras.items():
        # declared-but-inert variables: surfaced, never silently dropped
        mckpp_print(ROUTINE, f"namelist {grp}: not modeled, ignored: {vals}")
    d = cfg.domain
    layout = (dist.make_layout(d.nx * d.ny, device=device) if world > 1
              else None)
    model, st, prm, frc, flux_provider, mgr = setup_mod.build(
        cfg, args.data_dir, device=device, layout=layout, timers=timers)
    ncol_local = st.u.shape[0]
    # the rate counts every process's (padded) columns
    ncol = layout.ncol if layout is not None else ncol_local
    mckpp_print(ROUTINE, f"initialized {ncol} columns x {model.grid.nz} "
                f"levels on {device} ({model.dtype}, pass_impl "
                f"{model.pass_impl})")
    # the whole domain's mask and axes for the output files (XIOS domain
    # lon/lat)
    if layout is not None:
        mckpp_print(ROUTINE, f"rank {rank} of {world}: columns "
                    f"[{layout.lo}, {layout.hi}) of {layout.ncol} padded")
        l_ocean, dlon, dlat = (layout.gather(a) for a in (
            prm.l_ocean, prm.dlon, prm.dlat))
    else:
        l_ocean, dlon, dlat = (a.cpu().numpy() for a in (
            prm.l_ocean, prm.dlon, prm.dlat))
    lons_ax = dlon.reshape(d.ny, d.nx)[0].astype("float64")
    lats_ax = dlat.reshape(d.ny, d.nx)[:, 0].astype("float64")
    iodef_path = args.iodef or cfg.output.iodef_file
    if cfg.output.streams:
        streams = [Stream(name, red, freq)
                   for (name, red, freq) in cfg.output.streams]
    elif iodef_path:
        from .io.streams import parse_iodef
        if not os.path.isabs(iodef_path):
            iodef_path = os.path.join(args.data_dir, iodef_path)
        streams = parse_iodef(iodef_path, cfg.time.dto)
        mckpp_print(ROUTINE, f"output streams from {iodef_path}: "
                    f"{[s.name for s in streams]}")
    else:
        streams = default_streams(
            cfg.time.dto, split_freq_days=cfg.output.split_freq_days)
    with timers.span("setup.output"):
        diag = DiagnosticsManager(
            streams, d.nx, d.ny, model.grid.zm, outdir=args.output_dir,
            start_time_days=cfg.time.startt, dto_seconds=cfg.time.dto,
            l_ocean=l_ocean, write_mode=args.output_mode, lons=lons_ax,
            lats=lats_ax, timers=timers)
        diag.set_layout(layout)
        restart = RestartControl(
            f"{args.output_dir}/{cfg.output.restart_outfile}",
            cfg.output.ndt_per_restart, cfg.time.num_timesteps,
            cfg.time.dto, cfg.time.startt,
            netcdf_grid=((d.nx, d.ny) if cfg.output.l_restart_netcdf
                         else None),
            layout=layout, timers=timers)
    _sync(device)
    timers.stop("Initialization")

    num_steps = args.steps or cfg.time.num_timesteps
    ndtocn = cfg.time.ndtocn

    # Flux prefetch: the next flux-cadence step's file read + host->device
    # copy runs on a background thread while the model steps; one-slot
    # lookahead keeps memory bounded
    flux_exec = ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="flux-prefetch")
    flux_next = {}                    # time_days -> Future

    def flux_at(time_days):
        fut = flux_next.pop(time_days, None)
        if fut is not None:
            with timers.span("forcing.flux_wait", device=False):
                return fut.result()
        if flux_provider is not None:
            return flux_provider(time_days)
        return forcing_mod.constant_test_fluxes(ncol_local, model.dtype,
                                                device)

    def flux_schedule(time_days):
        if flux_provider is None or time_days in flux_next:
            return
        flux_next[time_days] = flux_exec.submit(flux_provider, time_days)

    use_chain = os.environ.get("MCKPP_CHAIN", "1") != "0"
    mckpp_print(ROUTINE, f"timestepping loop: {num_steps} steps")
    # --profile: trace a window of steady-state steps from the midpoint
    prof_start = num_steps // 2 + 1 if num_steps >= 4 else 1
    prof_end = min(num_steps, prof_start + max(1, args.profile_steps) - 1)
    prof = None

    def pre_step(nt):
        """Host-side events before the physics: the profile start, the
        flux-cadence update and the ancillary refresh."""
        nonlocal prof, st, frc
        if args.profile and nt == prof_start and prof is None:
            _sync(device)
            prof = _profiler(device)
            prof.__enter__()
        time_days = cfg.time.startt + (nt - 1) * cfg.time.dto / 86400.0
        if (nt - 1) % ndtocn == 0:
            timers.start("Update surface fluxes")
            raw = flux_at(time_days)
            with timers.span("forcing.fluxes"):
                st, frc = forcing_mod.update_fluxes(
                    cfg, st, prm, frc, raw, nt <= 1, model.grid.dm)
            nt_next = nt + ndtocn
            if nt_next <= num_steps:
                flux_schedule(cfg.time.startt
                              + (nt_next - 1) * cfg.time.dto / 86400.0)
            timers.stop("Update surface fluxes")
        if nt != 1 and (not use_chain or mgr.due_any(nt)):
            timers.start("Update ancillaries")
            frc = mgr.update(nt, time_days, frc)
            timers.stop("Update ancillaries")

    def post_step(nt):
        """Restart write + profile stop after the physics of step nt."""
        nonlocal prof
        timers.start("Restart output")
        if cfg.output.l_restartw:
            # detached write: the state handed over is never overwritten
            restart.maybe_write(nt, st, prm, frc)
        timers.stop("Restart output")
        if prof is not None and nt >= prof_end:
            _sync(device)
            prof.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.profile,
                "trace.json" if world == 1 else f"trace_rank{rank}.json"))
            prof = None
            mckpp_print(ROUTINE, f"profiler trace of steps {prof_start}-"
                        f"{prof_end} written to {args.profile}")

    def hour_of(nt):
        """The coupling hour of step nt (no chain crosses an hour)."""
        return (nt - 1) // ndtocn

    summary = {"segments": num_steps, "captures": 0, "replays": 0,
               "chain": use_chain, "rank": rank, "world": world}
    launches0 = dict(ck.LAUNCHES)
    writes0 = dict(ncio.WRITES)
    marks = timers.hour_marks(device)
    if use_chain:
        # graphs where the step never waits on the host: the whole-step
        # kernel; the per-pass path ("cuda") syncs inside each step
        graphs = device.type == "cuda" and model.pass_impl == "cuda_step"
        if device.type == "cuda" and not graphs:
            mckpp_print(ROUTINE, f"pass_impl {model.pass_impl!r} waits on "
                        "the host inside each step: the chain runs its "
                        "spans without CUDA graphs")
        stepper = ChainedStepper(model._step, diag, graphs=graphs,
                                 timers=timers, uncounted=model.uncounted)

        def end_pred(nt):
            return (emit_due(diag, nt)
                    or (cfg.output.l_restartw and restart.due(nt))
                    or (diag.needs_full(nt) and not stepper.wide_reducing)
                    or (args.profile and nt == prof_end))

        def start_pred(nt):
            return mgr.due_any(nt) or (args.profile and nt == prof_start)

        max_k = int(os.environ.get("MCKPP_CHAIN_MAX", "32"))
        segments = plan_segments(num_steps, ndtocn=ndtocn,
                                 end_pred=end_pred, start_pred=start_pred,
                                 max_k=max_k)
        mckpp_print(ROUTINE, f"chained dispatch: {len(segments)} segments "
                    f"for {num_steps} steps (max k "
                    f"{max((k for _, k in segments), default=0)}, CUDA graphs "
                    f"{'on' if graphs else 'off'})")
        for h, segs in itertools.groupby(segments,
                                         key=lambda s: hour_of(s[0])):
            with timers.hour_span(h):
                for nt0, k in segs:
                    pre_step(nt0)
                    nt_end = nt0 + k - 1
                    timers.start("Physics")
                    need_full = (diag.needs_full(nt_end)
                                 or (cfg.output.l_restartw
                                     and restart.due(nt_end)))
                    st, accums, inst_fields = stepper.exec(
                        nt0, k, st, prm, frc, final_full=need_full)
                    timers.stop("Physics")
                    timers.start("Diagnostic output")
                    stepper.commit(nt_end, k, accums, inst_fields)
                    timers.stop("Diagnostic output")
                    post_step(nt_end)
        summary.update(segments=len(segments), captures=stepper.captures,
                       replays=stepper.replays)
    else:
        for h, steps in itertools.groupby(range(1, num_steps + 1),
                                          key=hour_of):
            with timers.hour_span(h):
                for nt in steps:
                    pre_step(nt)
                    timers.start("Physics")
                    # steps where no stream samples a wide field (and no
                    # restart is due) skip the diagnostic-materialization
                    # pass
                    need_full = (diag.needs_full(nt)
                                 or (cfg.output.l_restartw
                                     and restart.due(nt)))
                    st = model.step(st, prm, frc, first_step=(nt <= 1),
                                    with_diags=need_full)
                    timers.stop("Physics")
                    timers.start("Diagnostic output")
                    diag.step(nt, st, prm, frc)
                    timers.stop("Diagnostic output")
                    post_step(nt)
    marks.mark(hour_of(num_steps) + 1)          # the last hour's end

    _sync(device)
    marks.finish()
    n_ocean = int(prm.l_ocean.sum())
    if model.passes is not None:
        # the one host read of the pass counter (land columns run none)
        passes = int(model.passes[prm.l_ocean].sum())
        timers.count("step.passes", passes)
        mckpp_print(ROUTINE, f"step passes: {passes} over {n_ocean} ocean "
                    f"columns x {num_steps} steps "
                    f"({passes / max(n_ocean * num_steps, 1):.4f} a "
                    "column-step)")
    steady = _steady(marks.marks_us, num_steps, ndtocn)
    if steady is not None:
        dt2, n2 = steady
        summary.update(steady_s=dt2, steady_steps=n2,
                       column_steps_per_s=ncol * n2 / dt2)
        mckpp_print(ROUTINE, f"steady-state: {dt2:.3f} s for the last {n2} "
                    f"steps ({ncol * n2 / dt2:.1f} column-steps/s)")
    flux_exec.shutdown()
    paths = diag.flush()
    mckpp_print(ROUTINE, f"wrote diagnostics: {sorted(paths.values())}")
    mckpp_print(ROUTINE, f"diag emit gathers: {diag.emit_gathers}")
    timers.start("Restart output")
    written = restart.flush()
    timers.stop("Restart output")
    mckpp_print(ROUTINE, f"wrote restarts: {written}")
    writes = {k: ncio.WRITES[k] - writes0[k] for k in writes0}
    mckpp_print(ROUTINE, f"NetCDF files written: {writes['native']} native, "
                f"{writes['scipy']} scipy")
    launches = {k: ck.LAUNCHES[k] - launches0[k] for k in launches0}
    mckpp_print(ROUTINE, "kernel launches: " + " ".join(
        f"{k}={v}" for k, v in launches.items()))
    build = dict(ck.STEP_BUILD) if launches["fused_step"] else None
    if build:
        fill = build.get("block_fill")
        mckpp_print(ROUTINE, f"step kernel: {build['lib']}, {build['slots']}"
                    f" level slots a lane, {build['warps']} warps a block, "
                    f"{build['cols']} columns a block, block fill "
                    f"{'unknown' if fill is None else f'{fill:.6f}'}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    mckpp_print(ROUTINE, f"peak device memory: "
                f"{'none (CPU run)' if peak is None else f'{peak} bytes'}")
    report = timers.report()
    print(report)
    print(timers.span_report())
    # steps of the fused path: the whole-step kernel's launches (each
    # graph's eager warm-up included), else the run's steps (none in a
    # run of 0 steps)
    steps = launches["fused_step"] or num_steps
    if model.pass_impl != "reference" and steps:
        print(f"step glue in kernels: {launches['step_glue_out'] / steps:.3f}"
              f" of {steps} fused-path steps (step_glue_in "
              f"{launches['step_glue_in']}, step_glue_out "
              f"{launches['step_glue_out']})")
    summary.update(launches=launches, paths=dict(paths),
                   restarts=list(written), bytes_written=diag.bytes_written,
                   timers=report, ncol=ncol, num_steps=num_steps,
                   emit_gathers=diag.emit_gathers, writes=writes,
                   peak_memory_bytes=peak, spans=timers.spans(),
                   counters=dict(timers.counters), ocean_columns=n_ocean,
                   step_kernel=build)
    if args.distributed:
        dist.shutdown()
    return summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
