"""Named wall-clock timers (the reference's mckpp_timer.F90:31-195):
start/stop/print with a self-measuring meta-timer and a stats table at exit
(as ``mckpp_tpu/utils/timer.py``), grown into the run's span log and
counters.

Every timer and every :meth:`Timers.span` is a span: its name, start and
end, the span it ran inside on the same thread (its parent), the coupling
hour it serves and its thread.  The coupling hour is the index of the
``ndtocn``-step period (``loop.hour``); a span on a writer or prefetch
thread is given the hour of the loop's call that queued it.  Closed
spans go to an in-memory log (appends are safe from any thread);
:meth:`Timers.spans` returns it, :meth:`Timers.span_report` tables it by
name (calls, total, self time, p95 and max).  Counters (:meth:`Timers.count`)
sit beside the spans: the bytes each copy point moves.  Spans and counters
hold names and numbers only.

Timestamps are microseconds on the host's Unix clock, read from
``time.perf_counter_ns`` shifted once to Unix time: the clock that
``torch.profiler``'s chrome traces put their host events on (an event's
``ts`` plus the trace's ``baseTimeNanoseconds`` / 1000).  While a
profiler is on, a span also opens a profiler range of its name: a
``record_function``, which the profiler projects onto the card's timeline
as well (``gpu_user_annotation``), or for a span with ``device=False``
the cheaper ``_RecordFunctionFast``, which it stamps on the host only;
the log's start is read after the range opens and its end after the
range closes, so the two agree.  With no profiler on, a span costs two
clock reads and a list append.

:class:`HourMarks` stamps each coupling hour's start on the card: one
CUDA timing event a boundary, resolved as the card passes it (``query``),
never by a synchronise inside the run; on the CPU the host clock."""

from __future__ import annotations

import collections
import itertools
import math
import threading
import time
from typing import Dict, List, Optional

import torch

_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def p95(values) -> float:
    """The nearest-rank 95th percentile of ``values`` (not empty)."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class _Span:
    """One open span; :meth:`Timers.span` returns it as a context
    manager."""
    __slots__ = ("timers", "name", "hour", "device", "id", "parent", "t0",
                 "range")

    def __init__(self, timers, name, hour, device):
        self.timers, self.name, self.hour = timers, name, hour
        self.device = device
        self.range = None

    def __enter__(self):
        self.timers._open(self)
        return self

    def __exit__(self, *exc):
        self.timers._close(self)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class NoTimers:
    """What a component uses when its caller gives it no :class:`Timers`:
    spans and counts that record nothing."""
    hour = None

    def span(self, name: str, hour=None, device: bool = True):
        return _NO_SPAN

    def count(self, name: str, n: int) -> None:
        pass


NO_TIMERS = NoTimers()


class HourMarks:
    """The device time of each coupling hour's start: ``mark(h)`` records
    one CUDA timing event on the current stream (on the CPU, reads the
    host clock); the marks that the card has passed resolve at each later
    mark, the rest in :meth:`finish`, after the caller has synchronised.
    ``marks_us[h]`` is on the span log's clock: the host's time at the
    first mark (the card idle there, after the set-up's synchronise) plus
    the card's elapsed time since."""

    def __init__(self, device, clock):
        self.cuda = torch.device(device).type == "cuda"
        self._clock = clock
        self._base = None                     # (event, host us)
        self._pending = collections.deque()   # (hour, event)
        self.marks_us: Dict[int, float] = {}

    def mark(self, h: int) -> None:
        if not self.cuda:
            self.marks_us[h] = self._clock()
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if self._base is None:
            self._base = (ev, self._clock())
        self._pending.append((h, ev))
        self._resolve(final=False)

    def _resolve(self, final: bool) -> None:
        base, base_us = self._base if self._base else (None, 0.0)
        while self._pending and (final or self._pending[0][1].query()):
            h, ev = self._pending.popleft()
            self.marks_us[h] = base_us + 1e3 * base.elapsed_time(ev)

    def finish(self) -> None:
        """Resolve every mark; the card must have passed them all."""
        self._resolve(final=True)


class Timers:
    def __init__(self, max_timers: int = 300):
        self.max_timers = max_timers
        self._elapsed: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._started: Dict[str, float] = {}
        self._meta = 0.0
        # the span log: (id, name, start ns, end ns, parent id, hour,
        # thread) of each closed span, perf_counter_ns; _unix_ns shifts
        # that clock to Unix time
        self._unix_ns = time.time_ns() - time.perf_counter_ns()
        self._log: List[tuple] = []
        self._ids = itertools.count()
        self._tls = threading.local()
        self._timed: Dict[str, _Span] = {}
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.hour: Optional[int] = None
        self.marks: Optional[HourMarks] = None
        self.start("Total")

    # ---- the reference's timers ------------------------------------------
    def start(self, name: str):
        t0 = time.perf_counter()
        if name not in self._elapsed:
            if len(self._elapsed) >= self.max_timers:
                raise RuntimeError("too many timers")
            self._elapsed[name] = 0.0
            self._count[name] = 0
        sp = self._timed.pop(name, None)
        if sp is not None:                    # started again while open
            sp.__exit__(None, None, None)
        self._timed[name] = self.span(name).__enter__()
        self._started[name] = time.perf_counter()
        self._meta += time.perf_counter() - t0

    def stop(self, name: str):
        t0 = time.perf_counter()
        if name in self._started:
            self._elapsed[name] += t0 - self._started.pop(name)
            self._count[name] += 1
            self._timed.pop(name).__exit__(None, None, None)
        self._meta += time.perf_counter() - t0

    def section(self, name: str):
        """A context manager that times its block under ``name``."""
        timers = self

        class _Ctx:
            def __enter__(self):
                timers.start(name)

            def __exit__(self, *a):
                timers.stop(name)
        return _Ctx()

    def report(self) -> str:
        self.stop("Total")
        lines = [f"{'Timer':<40s} {'calls':>8s} {'seconds':>12s}"]
        for name, secs in sorted(self._elapsed.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<40s} {self._count[name]:>8d} {secs:>12.3f}")
        lines.append(f"{'(timer overhead)':<40s} {'':>8s} {self._meta:>12.3f}")
        return "\n".join(lines)

    # ---- spans -------------------------------------------------------------
    def now_us(self) -> float:
        """The span log's clock, in microseconds."""
        return (time.perf_counter_ns() + self._unix_ns) / 1e3

    def span(self, name: str, hour: Optional[int] = None,
             device: bool = True) -> _Span:
        """A span of ``name`` as a context manager.  ``hour``: the
        coupling hour it serves (default: its parent's, else the loop's
        current :attr:`hour`).  ``device``: under a profiler, project the
        span onto the card's timeline too (see the module's note)."""
        return _Span(self, name, hour, device)

    def _stack(self) -> list:
        tls = self._tls
        try:
            return tls.stack
        except AttributeError:
            tls.stack = []
            tls.thread = threading.current_thread().name
            return tls.stack

    def _open(self, sp: _Span) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp.parent = None if parent is None else parent.id
        if sp.hour is None:
            sp.hour = self.hour if parent is None else parent.hour
        sp.id = next(self._ids)
        stack.append(sp)
        if _profiling():
            if sp.device or _FAST is None:
                sp.range = torch.autograd.profiler.record_function(sp.name)
            else:
                sp.range = _FAST(sp.name)
            sp.range.__enter__()
        sp.t0 = time.perf_counter_ns()

    def _close(self, sp: _Span) -> None:
        if sp.range is not None:
            sp.range.__exit__(None, None, None)
            sp.range = None
        t1 = time.perf_counter_ns()
        stack = self._stack()
        if stack[-1] is sp:
            stack.pop()
        else:                                 # closed out of order
            stack.remove(sp)
        self._log.append((sp.id, sp.name, sp.t0, t1, sp.parent, sp.hour,
                          self._tls.thread))

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    # ---- coupling hours ----------------------------------------------------
    def hour_marks(self, device) -> HourMarks:
        """Stamp each :meth:`hour_span` on ``device`` from now on."""
        self.marks = HourMarks(device, self.now_us)
        return self.marks

    def hour_span(self, h: int) -> _Span:
        """The ``loop.hour`` span of coupling hour ``h``: sets the loop's
        current hour and stamps its start (:meth:`hour_marks`)."""
        self.hour = h
        if self.marks is not None:
            self.marks.mark(h)
        return self.span("loop.hour", hour=h, device=False)

    # ---- the log -----------------------------------------------------------
    def spans(self) -> List[dict]:
        """The closed spans in the order they closed: ``name``,
        ``start_us``, ``end_us``, ``id``, ``parent`` (the id of the span it
        ran inside, or None), ``hour``, ``thread``; a ``loop.hour`` span
        also ``device_start_us`` and ``device_end_us``, its hour's start
        and the next hour's (or the end's) on the card, where resolved."""
        off = self._unix_ns
        marks = self.marks.marks_us if self.marks is not None else {}
        out = []
        for sid, name, t0, t1, parent, hour, thread in list(self._log):
            d = {"name": name, "start_us": (t0 + off) / 1e3,
                 "end_us": (t1 + off) / 1e3, "id": sid, "parent": parent,
                 "hour": hour, "thread": thread}
            if name == "loop.hour" and hour in marks:
                d["device_start_us"] = marks[hour]
                d["device_end_us"] = marks.get(hour + 1)
            out.append(d)
        return out

    def span_report(self) -> str:
        """Per span name: calls, total and self seconds (the spans less
        their children), and the p95 and max of one call in ms."""
        log = list(self._log)
        own = {sid: t1 - t0 for sid, _, t0, t1, _, _, _ in log}
        for sid, _, t0, t1, parent, _, _ in log:
            if parent in own:
                own[parent] -= t1 - t0
        by = {}
        for sid, name, t0, t1, _, _, _ in log:
            by.setdefault(name, []).append((t1 - t0, own[sid]))
        lines = [f"{'Span':<28s} {'calls':>8s} {'total s':>10s} "
                 f"{'self s':>10s} {'p95 ms':>10s} {'max ms':>10s}"]
        for name, v in sorted(by.items(),
                              key=lambda kv: -sum(d for d, _ in kv[1])):
            durs = [d for d, _ in v]
            lines.append(
                f"{name:<28s} {len(v):>8d} {sum(durs) / 1e9:>10.3f} "
                f"{sum(s for _, s in v) / 1e9:>10.3f} "
                f"{p95(durs) / 1e6:>10.3f} {max(durs) / 1e6:>10.3f}")
        return "\n".join(lines)
