"""Main program: the counterpart of ``mckpp_tpu/cli.py`` and of PROGRAM
mckpp_ocean_model_3d (mckpp_ocean_model_3D.F90:22-76).

Usage:  python -m mckpp_torch.cli [--namelist 3D_ocn.nml] [--data-dir DIR]
        [--output-dir DIR] [--steps N] [--iodef FILE] [--dtype D]
        [--device cuda|cpu] [--profile DIR [--profile-steps N]]

Reads the reference-format namelist, assembles the model (``setup.build``,
with the initial mixing pass), and runs the time loop with the flux and
boundary updates, the diagnostic streams, restart writes and the
named-timer report.  The model runs on the card unless ``--device cpu``
is given.  Every event-free span of steps runs as one chain
(``models/chain.py``), replayed as a CUDA graph on the card;
``MCKPP_CHAIN=0`` runs the per-step loop instead and ``MCKPP_CHAIN_MAX``
caps a span's length.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from . import forcing as forcing_mod
from . import setup as setup_mod
from .io.diagnostics import DiagnosticsManager, Stream, default_streams
from .io.restart import RestartControl
from .models.chain import ChainedStepper, emit_due, plan_segments
from .ops import cuda_kernels as ck
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
                        "few steady-state steps into DIR")
    p.add_argument("--profile-steps", type=int, default=6,
                   help="number of steps to trace under --profile")
    p.add_argument("--multi-device", action="store_true",
                   help="not implemented in mckpp_torch yet (ROADMAP A13)")
    p.add_argument("--distributed", action="store_true",
                   help="not implemented in mckpp_torch yet (ROADMAP A13)")
    p.add_argument("--output-mode", choices=["single", "shard"],
                   default="single",
                   help="'single' writes each stream from this process; "
                        "'shard' is not implemented in mckpp_torch yet "
                        "(ROADMAP A13)")
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> dict:
    """The CLI's run; returns its summary (segments, graph captures and
    replays, kernel launches, the steady-state rate, bytes written, the
    paths written and the timer report)."""
    args = _parser().parse_args(argv)
    for flag, on in (("--multi-device", args.multi_device),
                     ("--distributed", args.distributed),
                     ("--output-mode shard", args.output_mode == "shard")):
        if on:
            raise NotImplementedError(
                f"{flag} is not implemented in mckpp_torch yet (ROADMAP A13)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) and no CUDA device "
                           "is available; pass --device cpu")
    device = torch.device(args.device)

    timers = Timers()
    timers.start("Initialization")
    cfg, extras = nml.load_config(args.namelist)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    mckpp_print(ROUTINE, f"read namelist {args.namelist}")
    for grp, vals in extras.items():
        # declared-but-inert variables: surfaced, never silently dropped
        mckpp_print(ROUTINE, f"namelist {grp}: not modeled, ignored: {vals}")
    model, st, prm, frc, flux_provider, mgr = setup_mod.build(
        cfg, args.data_dir, device=device)
    ncol = st.u.shape[0]
    mckpp_print(ROUTINE, f"initialized {ncol} columns x {model.grid.nz} "
                f"levels on {device} ({model.dtype}, pass_impl "
                f"{model.pass_impl})")

    # rectilinear domain axes for the output files (XIOS domain lon/lat)
    d = cfg.domain
    lons_ax = prm.dlon.reshape(d.ny, d.nx)[0].double().cpu().numpy()
    lats_ax = prm.dlat.reshape(d.ny, d.nx)[:, 0].double().cpu().numpy()
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
    diag = DiagnosticsManager(
        streams, d.nx, d.ny, model.grid.zm, outdir=args.output_dir,
        start_time_days=cfg.time.startt, dto_seconds=cfg.time.dto,
        l_ocean=prm.l_ocean, lons=lons_ax, lats=lats_ax)
    restart = RestartControl(
        f"{args.output_dir}/{cfg.output.restart_outfile}",
        cfg.output.ndt_per_restart, cfg.time.num_timesteps,
        cfg.time.dto, cfg.time.startt,
        netcdf_grid=((d.nx, d.ny) if cfg.output.l_restart_netcdf else None))
    _sync(device)
    timers.stop("Initialization")

    num_steps = args.steps or cfg.time.num_timesteps

    # Flux prefetch: the next flux-cadence step's file read + host->device
    # copy runs on a background thread while the model steps; one-slot
    # lookahead keeps memory bounded
    flux_exec = ThreadPoolExecutor(max_workers=1)
    flux_next = {}                    # time_days -> Future

    def flux_at(time_days):
        fut = flux_next.pop(time_days, None)
        if fut is not None:
            return fut.result()
        if flux_provider is not None:
            return flux_provider(time_days)
        return forcing_mod.constant_test_fluxes(ncol, model.dtype, device)

    def flux_schedule(time_days):
        if flux_provider is None or time_days in flux_next:
            return
        flux_next[time_days] = flux_exec.submit(flux_provider, time_days)

    use_chain = os.environ.get("MCKPP_CHAIN", "1") != "0"
    mckpp_print(ROUTINE, f"timestepping loop: {num_steps} steps")
    t_half = None
    # --profile: trace a window of steady-state steps from the midpoint
    prof_start = num_steps // 2 + 1 if num_steps >= 4 else 1
    prof_end = min(num_steps, prof_start + max(1, args.profile_steps) - 1)
    prof = None
    half_marker = num_steps // 2 + 1 if num_steps >= 4 else None

    def pre_step(nt):
        """Host-side events before the physics: steady-state / profile
        markers, the flux-cadence update and the ancillary refresh."""
        nonlocal t_half, prof, st, frc
        if nt == half_marker:
            _sync(device)
            t_half = time.perf_counter()
        if args.profile and nt == prof_start and prof is None:
            from torch.profiler import ProfilerActivity, profile
            _sync(device)
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        time_days = cfg.time.startt + (nt - 1) * cfg.time.dto / 86400.0
        if (nt - 1) % cfg.time.ndtocn == 0:
            timers.start("Update surface fluxes")
            raw = flux_at(time_days)
            st, frc = forcing_mod.update_fluxes(
                cfg, st, prm, frc, raw, nt <= 1, model.grid.dm)
            nt_next = nt + cfg.time.ndtocn
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
            prof.export_chrome_trace(os.path.join(args.profile,
                                                  "trace.json"))
            prof = None
            mckpp_print(ROUTINE, f"profiler trace of steps {prof_start}-"
                        f"{prof_end} written to {args.profile}")

    summary = {"segments": num_steps, "captures": 0, "replays": 0,
               "chain": use_chain}
    launches0 = dict(ck.LAUNCHES)
    if use_chain:
        # graphs where the step never waits on the host: the whole-step
        # kernel; the per-pass path ("cuda") syncs inside each step
        graphs = device.type == "cuda" and model.pass_impl == "cuda_step"
        if device.type == "cuda" and not graphs:
            mckpp_print(ROUTINE, f"pass_impl {model.pass_impl!r} waits on "
                        "the host inside each step: the chain runs its "
                        "spans without CUDA graphs")
        stepper = ChainedStepper(model._step, diag, graphs=graphs)

        def end_pred(nt):
            return (emit_due(diag, nt)
                    or (cfg.output.l_restartw and restart.due(nt))
                    or (diag.needs_full(nt) and not stepper.wide_reducing)
                    or (args.profile and nt == prof_end))

        def start_pred(nt):
            return (mgr.due_any(nt) or nt == half_marker
                    or (args.profile and nt == prof_start))

        max_k = int(os.environ.get("MCKPP_CHAIN_MAX", "32"))
        segments = plan_segments(num_steps, ndtocn=cfg.time.ndtocn,
                                 end_pred=end_pred, start_pred=start_pred,
                                 max_k=max_k)
        mckpp_print(ROUTINE, f"chained dispatch: {len(segments)} segments "
                    f"for {num_steps} steps (max k "
                    f"{max(k for _, k in segments)}, CUDA graphs "
                    f"{'on' if graphs else 'off'})")
        for nt0, k in segments:
            pre_step(nt0)
            nt_end = nt0 + k - 1
            timers.start("Physics")
            need_full = (diag.needs_full(nt_end)
                         or (cfg.output.l_restartw and restart.due(nt_end)))
            st, accums, inst_fields = stepper.exec(nt0, k, st, prm, frc,
                                                   final_full=need_full)
            timers.stop("Physics")
            timers.start("Diagnostic output")
            stepper.commit(nt_end, k, accums, inst_fields)
            timers.stop("Diagnostic output")
            post_step(nt_end)
        summary.update(segments=len(segments), captures=stepper.captures,
                       replays=stepper.replays)
    else:
        for nt in range(1, num_steps + 1):
            pre_step(nt)
            timers.start("Physics")
            # steps where no stream samples a wide field (and no restart
            # is due) skip the diagnostic-materialization pass
            need_full = (diag.needs_full(nt)
                         or (cfg.output.l_restartw and restart.due(nt)))
            st = model.step(st, prm, frc, first_step=(nt <= 1),
                            with_diags=need_full)
            timers.stop("Physics")
            timers.start("Diagnostic output")
            diag.step(nt, st, prm, frc)
            timers.stop("Diagnostic output")
            post_step(nt)

    _sync(device)
    if t_half is not None:
        n2 = num_steps - num_steps // 2
        dt2 = time.perf_counter() - t_half
        summary.update(steady_s=dt2, steady_steps=n2,
                       column_steps_per_s=ncol * n2 / dt2)
        mckpp_print(ROUTINE, f"steady-state: {dt2:.3f} s for the last {n2} "
                    f"steps ({ncol * n2 / dt2:.1f} column-steps/s)")
    flux_exec.shutdown()
    paths = diag.flush()
    mckpp_print(ROUTINE, f"wrote diagnostics: {sorted(paths.values())}")
    timers.start("Restart output")
    written = restart.flush()
    timers.stop("Restart output")
    mckpp_print(ROUTINE, f"wrote restarts: {written}")
    report = timers.report()
    print(report)
    summary.update(launches={k: ck.LAUNCHES[k] - launches0[k]
                             for k in launches0}, paths=dict(paths),
                   restarts=list(written), bytes_written=diag.bytes_written,
                   timers=report, ncol=ncol, num_steps=num_steps)
    return summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
