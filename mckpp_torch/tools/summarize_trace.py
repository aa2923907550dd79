"""Digest a ``torch.profiler`` trace of the port: device time by kernel,
launches, the ``kpp::`` kernels' share and the device-idle share (the
port's counterpart of ``tools/summarize_trace.py``, which reads
jax.profiler xplane files).

Usage: python -m mckpp_torch.tools.summarize_trace PATH [--top 15]

PATH is a chrome trace (``trace.json``, ``trace_rank<r>.json``, as
``python -m mckpp_torch.cli --profile DIR`` writes them) or a directory
holding such files.  The window runs from the first host event to the
last device event; the device is busy where at least one of its events
(kernels, copies, sets) runs.  A trace without device events (a CPU run)
gets a table of host-op time instead, and says that it has no device
events.  ``chip_smoke.py`` digests its own traces with :func:`stats`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

# chrome-trace categories of work on the device, and of host operators
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CAT = "cpu_op"


def load(path: str) -> list:
    """The events of one chrome trace as (start_us, end_us, name,
    on_device, is_op) tuples."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        t0 = float(e["ts"])
        out.append((t0, t0 + float(e["dur"]), e.get("name", "?"),
                    cat in DEVICE_CATS, cat == HOST_OP_CAT))
    return out


def from_profiler(prof) -> list:
    """The events of a finished ``torch.profiler.profile`` in the form of
    :func:`load` (every host event counts as an op)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end, e.name,
             e.device_type == cuda, e.device_type != cuda)
            for e in prof.events()]


def stats(events, top_n: int = 12) -> dict:
    """The digest of a list of events (:func:`load`): without device
    events, ``device_events`` 0 and the host-op table; else the window
    (first host event to last device event), the device's busy time and
    idle share, the ms of the ``kpp::`` kernels and of the others, the
    kpp kernels' share of device time, the device launches and the top
    ``top_n`` device ms by name (names cut to 120 characters)."""
    dev = [(a, b, n) for a, b, n, on_dev, _ in events if on_dev]
    if not dev:
        by_op = {}
        for a, b, n, _, op in events:
            if op:
                by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e3
        top = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:top_n])
        return {"device_events": 0, "host_ops": sum(
            1 for e in events if e[4]), "host_ms_by_op": top}
    host = [a for a, _, _, on_dev, _ in events if not on_dev]
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
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n])
    kpp_ms = sum(v for k, v in by_name.items() if "kpp::" in k)
    total = sum(by_name.values())
    return {"device_events": len(dev), "window_ms": (t1 - t0) / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0),
            "kernel_ms_kpp": kpp_ms, "kernel_ms_other": total - kpp_ms,
            "kpp_share": kpp_ms / total if total else 0.0,
            "device_launches": len(dev), "device_ms_by_kernel": top,
            "launches_by_kernel": {
                n: sum(1 for _, _, m in dev if m[:120] == n) for n in top}}


def traces(path: str) -> list:
    """The trace files at ``path``: the file itself, or a directory's
    ``trace.json`` and ``trace_rank*.json``."""
    if os.path.isfile(path):
        return [path]
    found = sorted(glob.glob(os.path.join(path, "trace.json"))
                   + glob.glob(os.path.join(path, "trace_rank*.json")))
    if not found:
        raise SystemExit(f"no trace.json or trace_rank*.json in {path}")
    return found


def report(path: str, top_n: int = 15) -> dict:
    """Print the digest of one trace file; returns :func:`stats`."""
    st = stats(load(path), top_n)
    print(f"# trace digest: {path}")
    if not st["device_events"]:
        print("the trace has no device events (a CPU run): host-op time "
              f"over {st['host_ops']} ops")
        for name, ms in st["host_ms_by_op"].items():
            print(f"  {ms:10.3f} ms  {name[:110]}")
    else:
        print(f"window {st['window_ms']:.3f} ms, device busy "
              f"{st['device_busy_ms']:.3f} ms, idle "
              f"{100 * st['device_idle_share']:.1f}%, "
              f"{st['device_launches']} device events; kpp:: kernels "
              f"{st['kernel_ms_kpp']:.3f} ms ({100 * st['kpp_share']:.1f}% "
              f"of device time), other {st['kernel_ms_other']:.3f} ms")
        for name, ms in st["device_ms_by_kernel"].items():
            print(f"  {ms:10.3f} ms  n={st['launches_by_kernel'][name]:5d}"
                  f"  {name[:110]}")
    print(json.dumps({"trace": path, **st}), flush=True)
    return st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("--top", type=int, default=15)
    a = ap.parse_args(argv)
    for path in traces(a.path):
        report(path, a.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
