"""The traced window's device work split by the program's own spans.

The CLI's summary holds the run's span log (``summary["spans"]``: name,
start and end in microseconds on the host's Unix clock, parent, coupling
hour and thread of every span).  In a traced run the profiler records
the spans of the loop's thread too, each twice: on the host and projected
onto the card (``gpu_user_annotation``: from the first to the last device
operation launched inside it), which ``tracing.load`` keeps with both
flags false.  The spans of the writer and prefetch threads reach the
trace only through the log: the profiler records ranges only on the
thread that started it.

A device event goes to the shortest program range that holds it whole:
the device-side ranges of the loop's spans, and the log's spans of the
other threads, which launch nothing but copies (a pageable
device-to-host copy lies inside the host span that made it), for the
memory copies alone.  The log is moved onto the trace's clock by the
median offset between the log's and the trace's starts of the
``loop.hour`` spans, paired in order: the program opens their profiler
range on the host only and reads the log's clock beside the profiler's
stamp, where a range projected onto the card lets other threads run
between the two (for milliseconds at times, on an H100's host)."""

from __future__ import annotations

import bisect
import math
import statistics

TOL_US = 0.01          # the trace's timestamps are rounded to the ns


def log(run):
    """The run's span log, or None where the program keeps none."""
    spans = (run.summary or {}).get("spans")
    return spans or None


def loop_thread(spans):
    """The thread of the ``loop.hour`` spans, or None."""
    return next((s["thread"] for s in spans if s["name"] == "loop.hour"),
                None)


def offsets(events, spans, name="loop.hour") -> list:
    """(log start - trace start) in microseconds of the loop thread's
    ``name`` spans, paired in order; empty where the trace holds another
    number of them on the host."""
    loop = loop_thread(spans)
    logged = sorted(s["start_us"] for s in spans
                    if s["name"] == name and s["thread"] == loop)
    traced = sorted(a for a, _, n, on_dev, op in events
                    if n == name and op and not on_dev)
    if len(logged) != len(traced):
        return []
    return [x - y for x, y in zip(logged, traced)]


def ranges(events, spans) -> list:
    """(start_us, end_us, name, copies only) on the trace's clock of
    every program range a device event can lie under: the loop's spans on
    the device, the other threads' spans from the log (which hold only
    memory copies)."""
    names = {s["name"] for s in spans}
    out = [(a, b, n, False) for a, b, n, on_dev, op in events
           if not on_dev and not op and n in names]
    offs = offsets(events, spans)
    if offs:
        off = statistics.median(offs)
        loop = loop_thread(spans)
        out += [(s["start_us"] - off, s["end_us"] - off, s["name"], True)
                for s in spans if s["thread"] != loop]
    return out


def attribute(events, rngs) -> dict:
    """{range name, or None where no range holds it: device ms of the
    events that are not the port's ``kpp::`` kernels}, each event under
    the shortest of ``rngs`` (:func:`ranges`) that holds it whole and
    may hold it (a copies-only range: a ``Memcpy``)."""
    rngs = sorted(rngs)
    starts = [r[0] for r in rngs]
    dev = sorted((a, b, n.startswith("Memcpy"))
                 for a, b, n, on_dev, _ in events
                 if on_dev and "kpp::" not in n)
    out = {}
    active, i = [], 0
    for a, b, copy in dev:
        # the ranges that start by this event's start and are open there
        j = bisect.bisect_right(starts, a + TOL_US)
        active = [r for r in active + rngs[i:j] if r[1] + TOL_US >= a]
        i = j
        best = min((r for r in active
                    if r[1] + TOL_US >= b and (copy or not r[3])),
                   key=lambda r: r[1] - r[0], default=None)
        name = None if best is None else best[2]
        out[name] = out.get(name, 0.0) + (b - a) / 1e3
    return out


def split(run):
    """:func:`attribute` of the run's traced window, or None without a
    trace or a span log."""
    spans = log(run)
    if not run.events or not spans:
        return None
    return attribute(run.events, ranges(run.events, spans))


def ms_per_step(run, names):
    """Device ms a step of the non-``kpp::`` events under the spans
    ``names``; None without a trace holding device events, a span log or
    a range of those names."""
    spans = log(run)
    if not run.events or not spans or not any(e[3] for e in run.events):
        return None
    rngs = ranges(run.events, spans)
    if not {r[2] for r in rngs} & set(names):
        return None
    parts = attribute(run.events, rngs)
    return sum(parts.get(n, 0.0) for n in names) / run.steps


def hour_ms(spans) -> list:
    """The device milliseconds of each coupling hour whose ``loop.hour``
    span has both device marks."""
    return [(s["device_end_us"] - s["device_start_us"]) / 1e3
            for s in spans if s["name"] == "loop.hour"
            and s.get("device_start_us") is not None
            and s.get("device_end_us") is not None]


def p95(values) -> float:
    """The nearest-rank 95th percentile of ``values`` (not empty)."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
