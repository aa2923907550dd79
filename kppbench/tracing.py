"""The traced run's reading: ``load`` and ``stats`` are frozen copies of
``mckpp_torch/tools/summarize_trace.py`` at commit a49d027 (the window
runs from the first host event to the last device event; the device is
busy where at least one of its events runs); ``kernel_ms`` and
``breakdown`` are the benchmark's own.  Host spans that the harness
records around the program's layers (``user_annotation`` events) count
as host operations here."""

from __future__ import annotations

import bisect
import json

# chrome-trace categories of work on the device, and of host operators
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CAT = "cpu_op"
HOST_SPAN_CAT = "user_annotation"


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
                    cat in DEVICE_CATS, cat in (HOST_OP_CAT, HOST_SPAN_CAT)))
    return out


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


def kernel_ms(events, match) -> tuple:
    """(total device ms, launches) of the device events whose name
    ``match(name)`` accepts."""
    ms, n = 0.0, 0
    for a, b, name, on_dev, _ in events:
        if on_dev and match(name):
            ms += (b - a) / 1e3
            n += 1
    return ms, n


def breakdown(events, top_n: int = 10, gaps_n: int = 400) -> dict:
    """``device_ops``: the ``top_n`` device operations by total seconds;
    ``idle_gaps``: the seconds of the ``gaps_n`` longest gaps between
    device work inside the window, each put to the host operation or span
    that overlaps it most (the shortest such one on a tie), summed by its
    name, the ``top_n`` largest."""
    dev = sorted((a, b, n) for a, b, n, on_dev, _ in events if on_dev)
    if not dev:
        return {"device_ops": [], "idle_gaps": []}
    by_name = {}
    for a, b, n in dev:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    gaps, end = [], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    gaps = sorted(gaps, reverse=True)[:gaps_n]
    host = sorted((a, b, n) for a, b, n, on_dev, op in events
                  if op and not on_dev)
    starts = [h[0] for h in host]
    longest = max((b - a for a, b, _ in host), default=0.0)
    by_label = {}
    for dur, g0, g1 in gaps:
        best, key = "(no host operation)", (0.0, 0.0)
        i = bisect.bisect_left(starts, g1)
        lo = bisect.bisect_left(starts, g0 - longest)
        for a, b, n in host[lo:i]:
            over = min(b, g1) - max(a, g0)
            if over > 0 and (over, -(b - a)) > key:
                best, key = n[:120], (over, -(b - a))
        by_label[best] = by_label.get(best, 0.0) + dur / 1e6
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:top_n]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
