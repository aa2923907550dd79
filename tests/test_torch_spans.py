"""The port's span log and counters (``mckpp_torch/utils/timer.py``) and
what the CLI records with them, on the CPU.

The API: spans nest on their thread (parent, self time), carry the
coupling hour (a writer thread's the hour it is given), the report gives
each name's p95, counts are safe from many threads, and with no profiler
on no profiler range is opened.  The CLI at the end-to-end inputs' toy
size (4 x 3 columns, with the SST climatology): the summary holds the
spans and the counters, each byte counter equals the bytes of the
tensors its copy point moved, the steady-state rate is read from the
hour marks and no longer cuts a chain of its own, and under ``--profile``
the log's clock is the trace's: a ``loop.hour`` span's start in the log
and in the trace agree within 50 us."""

import glob
import itertools
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mckpp_torch import cli
from mckpp_torch.models import chain
from mckpp_torch.utils import timer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_endtoend import NX, NY, write_inputs  # noqa: E402

NCOL = NX * NY
COORDS = ("time", "z", "longitude", "latitude")


@pytest.fixture
def clock(monkeypatch):
    """perf_counter_ns stepping 1 ms a read."""
    ticks = itertools.count(0, 1_000_000)
    monkeypatch.setattr(timer.time, "perf_counter_ns", lambda: next(ticks))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_spans_nest_with_parent_hour_and_self_time(clock):
    t = timer.Timers()
    with t.hour_span(7):
        with t.span("outer"):
            with t.span("inner"):
                pass
        t.start("Physics")
        t.stop("Physics")
    t.report()
    s = {k: v[0] for k, v in _by_name(t.spans()).items()}
    assert s["inner"]["parent"] == s["outer"]["id"]
    assert s["outer"]["parent"] == s["loop.hour"]["id"]
    assert s["Physics"]["parent"] == s["loop.hour"]["id"]
    assert s["loop.hour"]["parent"] == s["Total"]["id"]
    assert {s[n]["hour"] for n in ("inner", "outer", "Physics")} == {7}
    assert s["Total"]["hour"] is None
    # a tick a clock read: inner 1 ms inside outer's 3 ms
    dur = lambda n: s[n]["end_us"] - s[n]["start_us"]
    assert dur("inner") == pytest.approx(1e3, abs=1)
    assert dur("outer") == pytest.approx(3e3, abs=1)
    rows = {ln.split()[0]: ln.split()
            for ln in t.span_report().splitlines()[1:]}
    # self: outer less inner; the hour less outer and Physics
    assert float(rows["outer"][3]) == pytest.approx(0.002, abs=1e-6)
    assert float(rows["loop.hour"][3]) == pytest.approx(
        (dur("loop.hour") - dur("outer") - dur("Physics")) / 1e6, abs=1e-6)


def test_writer_thread_span_carries_its_hour():
    t = timer.Timers()
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="diag-writer") as ex:
        with t.hour_span(3):
            h = t.hour

            def job():
                with t.span("diag.d2h", h):
                    pass
            fut = ex.submit(job)
        t.hour = 4
        fut.result(timeout=30)
    s = _by_name(t.spans())["diag.d2h"][0]
    assert s["hour"] == 3 and s["parent"] is None
    assert s["thread"].startswith("diag-writer")
    assert _by_name(t.spans())["loop.hour"][0]["thread"] == \
        threading.current_thread().name


def test_report_gives_p95_and_max(clock):
    t = timer.Timers()
    for n in range(1, 21):
        with t.span("s"):
            for _ in range(n - 1):
                timer.time.perf_counter_ns()        # n ms in all
    row = next(ln.split() for ln in t.span_report().splitlines()
               if ln.startswith("s "))
    # 1..20 ms: nearest-rank p95 is the 19th
    assert row[1] == "20" and float(row[4]) == pytest.approx(19.0)
    assert float(row[5]) == pytest.approx(20.0)
    assert timer.p95(range(1, 101)) == 95


def test_no_profiler_range_without_a_profiler(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise AssertionError("a profiler range opened with no profiler on")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(timer, "_FAST", boom)
    t = timer.Timers()
    with t.hour_span(0), t.span("x"):
        pass
    write_inputs(tmp_path)
    _run(tmp_path, tmp_path / "out")


def test_counts_and_spans_from_many_threads():
    t = timer.Timers()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                t.count("n", 3)
                with t.span("w"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert t.counters["n"] == 16 * 500 * 3
    assert len(_by_name(t.spans())["w"]) == 16 * 500


def test_buffers_count_the_bytes_they_copy():
    """The graphs' static buffers (on the CPU): a load copies what is not
    in place; a hand-out's copies are the outputs' bytes."""
    from mckpp_torch.state import init_forcing, init_params, init_state
    st, prm, frc = (init_state(5, 4, torch.float64),
                    init_params(5, 4, dtype=torch.float64),
                    init_forcing(5, 4, torch.float64))
    acc = {"m": {"hmix": torch.zeros(5, dtype=torch.float64)}}
    nb = lambda x: sum(getattr(x, n).nbytes for n in x.__dataclass_fields__)
    buf = chain._Buffers(st, prm, frc, acc)
    assert buf.load(st, prm, frc, acc) == nb(st) + nb(prm) + nb(frc) + 40
    assert buf.load(st, prm, frc, acc) == 0
    out = buf.hand_out(prm, frc, ())
    assert chain._nbytes(out) == nb(st) + 40
    assert buf.load(out[0], prm, frc, out[1]) == 0


def test_steady_from_hour_marks():
    marks = {h: 1e6 * h for h in range(5)}      # an hour a second
    # 12 steps, 3 an hour: the midpoint step 7 starts hour 2
    assert cli._steady(marks, 12, 3) == (2.0, 6)
    # 10 steps: step 6 is mid, hour 2 starts at 7; the end is hour 4's
    assert cli._steady(marks, 10, 3) == (2.0, 4)
    assert cli._steady(marks, 3, 3) is None


def _run(d, out, *extra):
    return cli.run(["--namelist", str(d / "3D_ocn.nml"), "--data-dir",
                    str(d), "--output-dir", str(out), "--device", "cpu",
                    "--dtype", "float64", *extra])


@pytest.fixture(scope="module")
def sst_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    write_inputs(d, sst=True)
    out = d / "out"
    return d, out, _run(d, out, "--steps", "9")


def test_summary_spans_and_counters(sst_run):
    _, _, summary = sst_run
    spans = _by_name(summary["spans"])
    for name in ("loop.hour", "Physics", "forcing.fluxes", "diag.emit",
                 "diag.d2h", "diag.fill", "diag.pack", "diag.write",
                 "restart.d2h", "restart.save", "restart.wait",
                 "ancillary.sst.read", "ancillary.sst.h2d",
                 "setup.namelist", "setup.inputs", "setup.library",
                 "setup.initial_pass", "setup.output"):
        assert name in spans, name
    # 9 steps at 3 an hour: hours 0-2, each with its device marks
    hours = sorted(s["hour"] for s in spans["loop.hour"])
    assert hours == [0, 1, 2]
    for s in spans["loop.hour"]:
        assert s["device_start_us"] <= s["device_end_us"]
    emits = {s["hour"] for s in spans["diag.emit"]}
    assert {s["hour"] for s in spans["diag.d2h"]} <= emits
    assert all(s["thread"].startswith("diag-writer")
               for s in spans["diag.d2h"])
    assert set(summary["counters"]) == {
        "diag.d2h_bytes", "restart.d2h_bytes", "ancillary.h2d_bytes",
        "forcing.h2d_bytes", "step.passes"}


def test_byte_counters_equal_the_tensors(sst_run):
    d, out, summary = sst_run
    c, spans = summary["counters"], _by_name(summary["spans"])
    restarts = sorted(glob.glob(str(out / "restart_out_*.npz")))
    want = 0
    for p in restarts:
        with np.load(p) as z:
            want += sum(z[k].nbytes for k in z.files
                        if not k.startswith("meta_"))
    assert restarts and c["restart.d2h_bytes"] == want
    want = 0
    for p in glob.glob(str(out / "*.nc")):
        with netcdf_file(p, "r", mmap=False) as nc:
            want += sum(v.data.nbytes for k, v in nc.variables.items()
                        if k not in COORDS)
    assert c["diag.d2h_bytes"] == want
    # SST: one (ncol,) float64 record a read; the fluxes: 7 fields an hour
    assert c["ancillary.h2d_bytes"] == \
        len(spans["ancillary.sst.h2d"]) * NCOL * 8
    assert c["forcing.h2d_bytes"] == \
        len(spans["forcing.fluxes"]) * 7 * NCOL * 8


def test_steady_state_from_second_half_hours(sst_run):
    """9 steps: the midpoint (step 5) starts no hour, so the rate runs
    from hour 2 (step 7) and the chain is not cut at step 5: spans
    [1-3], [4-6], [7-9]."""
    _, _, summary = sst_run
    assert summary["segments"] == 3
    assert summary["steady_steps"] == 3
    hour = {s["hour"]: s for s in summary["spans"]
            if s["name"] == "loop.hour"}
    assert summary["steady_s"] == pytest.approx(
        (hour[2]["device_end_us"] - hour[2]["device_start_us"]) / 1e6)
    assert summary["column_steps_per_s"] == pytest.approx(
        NCOL * 3 / summary["steady_s"])


def test_profile_clock_is_the_trace_clock(tmp_path):
    """``--profile`` over three coupling hours: each ``loop.hour`` that
    the trace holds starts within 50 us of its start in the log, once the
    trace's base time is added."""
    write_inputs(tmp_path)
    prof = tmp_path / "prof"
    summary = _run(tmp_path, tmp_path / "out", "--steps", "18", "--profile",
                   str(prof), "--profile-steps", "9")
    with open(prof / "trace.json") as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    logged = [s["start_us"] for s in summary["spans"]
              if s["name"] == "loop.hour"]
    traced = [e["ts"] + base for e in doc["traceEvents"]
              if e.get("ph") == "X" and e.get("name") == "loop.hour"]
    assert traced
    for ts in traced:
        assert min(abs(x - ts) for x in logged) < 50.0
