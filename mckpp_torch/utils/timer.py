"""Named wall-clock timer registry (the reference's mckpp_timer.F90:31-195):
start/stop/print with a self-measuring meta-timer and a stats table at exit
(a copy of ``mckpp_tpu/utils/timer.py``).  The CLI's ``--profile``
complements it with a torch.profiler trace for device time."""

from __future__ import annotations

import time
from typing import Dict


class Timers:
    def __init__(self, max_timers: int = 300):
        self.max_timers = max_timers
        self._elapsed: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._started: Dict[str, float] = {}
        self._meta = 0.0
        self.start("Total")

    def start(self, name: str):
        t0 = time.perf_counter()
        if name not in self._elapsed:
            if len(self._elapsed) >= self.max_timers:
                raise RuntimeError("too many timers")
            self._elapsed[name] = 0.0
            self._count[name] = 0
        self._started[name] = time.perf_counter()
        self._meta += time.perf_counter() - t0

    def stop(self, name: str):
        t0 = time.perf_counter()
        if name in self._started:
            self._elapsed[name] += t0 - self._started.pop(name)
            self._count[name] += 1
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
