"""The split of the device work by the program's spans
(``kppbench/spans.py``) and its four readers on a hand-made trace and
span log, and ``hour_ms_p95`` on a traced toy run."""

import pytest

from kppbench import harness, spans, spec

OFF = 1.0e6            # the log's clock less the trace's, in us
STEPS = 2

# (start_us, end_us, name, on_device, is_op) on the trace's clock
EVENTS = [
    # the loop's spans on the host
    (0.0, 100.0, "loop.hour", False, True),
    (1.0, 99.0, "Physics", False, True),
    (5.0, 40.0, "chain.replay", False, True),
    (45.0, 60.0, "chain.hand_out", False, True),
    # ... and on the card (gpu_user_annotation)
    (2.0, 98.0, "Physics", False, False),
    (10.0, 50.0, "chain.replay", False, False),
    (52.0, 58.0, "chain.hand_out", False, False),
    # a runtime call: both flags false, not a span
    (6.0, 7.0, "cudaGraphLaunch", False, False),
    # the card's work
    (10.0, 30.0, "void kpp::fused_step_kernel<float, 3, 0, 0>", True, False),
    (30.0, 50.0, "void at::native::elementwise_kernel", True, False),
    (52.0, 58.0, "Memcpy DtoD (Device -> Device)", True, False),
    (60.0, 62.0, "void at::native::vectorized_elementwise_kernel", True,
     False),
    (70.0, 90.0, "Memcpy DtoH (Device -> Pageable)", True, False),
]

# the log: loop spans a little off the trace's starts, a writer span only
LOG = [
    {"name": "loop.hour", "start_us": OFF + 0.5, "end_us": OFF + 100.0,
     "thread": "MainThread", "hour": 4, "device_start_us": OFF,
     "device_end_us": OFF + 70e3},
    {"name": "Physics", "start_us": OFF + 1.0, "end_us": OFF + 99.0,
     "thread": "MainThread", "hour": 4},
    {"name": "chain.replay", "start_us": OFF + 4.5, "end_us": OFF + 40.0,
     "thread": "MainThread", "hour": 4},
    {"name": "chain.hand_out", "start_us": OFF + 45.0, "end_us": OFF + 60.0,
     "thread": "MainThread", "hour": 4},
    {"name": "diag.d2h", "start_us": OFF + 65.5, "end_us": OFF + 115.5,
     "thread": "diag-writer_0", "hour": 3},
]

GLUE = ("glue_ms_per_step", "glue_ms_per_step.graph",
        "glue_ms_per_step.buffers", "glue_ms_per_step.output")


def _run(events=EVENTS, log=LOG):
    return harness.Run(steps=STEPS, dto=1200.0, ncol=10, setup_s=1.0,
                       window_s=1.0, init_s=0.5, peak_bytes=1,
                       summary={"spans": log}, events=events)


def _read(name, run):
    return spec.reader(name)(run)


def test_offset_aligns_the_log():
    """The loop.hour spans set the offset (the other loop spans' starts
    lie off by more); the writer's span moves onto the trace's clock and
    holds copies only."""
    assert spans.offsets(EVENTS, LOG) == pytest.approx([OFF + 0.5])
    assert spans.offsets(EVENTS, LOG, "chain.replay") == pytest.approx(
        [OFF - 0.5])
    rngs = spans.ranges(EVENTS, LOG)
    assert (65.0, 115.0, "diag.d2h", True) in [
        (pytest.approx(a), pytest.approx(b), n, c) for a, b, n, c in rngs]
    # the device-side ranges, not the host's and not the runtime call
    assert sorted((n, c) for _, _, n, c in rngs) == [
        ("Physics", False), ("chain.hand_out", False),
        ("chain.replay", False), ("diag.d2h", True)]
    assert spans.offsets(EVENTS, LOG[1:]) == []


def test_split_by_span():
    run = _run()
    assert spans.split(run) == pytest.approx({
        "chain.replay": 0.020, "chain.hand_out": 0.006,
        "Physics": 0.002, "diag.d2h": 0.020})
    assert _read("glue_ms_per_step.graph", run) == pytest.approx(
        0.020 / STEPS)
    assert _read("glue_ms_per_step.buffers", run) == pytest.approx(
        0.006 / STEPS)
    assert _read("glue_ms_per_step.output", run) == pytest.approx(
        0.020 / STEPS)


def test_split_sums_to_glue():
    """Every device event lies under a span: the parts sum to
    ``glue_ms_per_step``; one outside every span goes to None."""
    run = _run()
    parts = spans.split(run)
    assert None not in parts
    assert sum(parts.values()) / STEPS == pytest.approx(
        _read("glue_ms_per_step", run))
    out = _run(EVENTS + [(150.0, 153.0, "Memset (Device)", True, False),
                         (100.0, 101.0, "void at::native::fill", True,
                          False)])
    # the kernel lies in the writer's span, which holds copies only
    assert spans.split(out)[None] == pytest.approx(0.004)
    assert sum(spans.split(out).values()) / STEPS == pytest.approx(
        _read("glue_ms_per_step", out))


def test_shortest_range_wins():
    """The copy at 52-58 us lies under Physics and chain.hand_out; the
    kernel at 30-50 under Physics and chain.replay: the shorter takes
    each, and a tie of starts does not matter."""
    rngs = [(0.0, 100.0, "wide", False), (30.0, 50.0, "narrow", False),
            (30.0, 60.0, "middle", False)]
    ev = [(30.0, 50.0, "k", True, False), (55.0, 58.0, "c", True, False),
          (5.0, 6.0, "kpp::x", True, False)]
    assert spans.attribute(ev, rngs) == pytest.approx(
        {"narrow": 0.020, "middle": 0.003})


def test_readers_without_trace():
    run = _run(events=None)
    for name in GLUE:
        assert _read(name, run) is None
    # no log: the parent program's summary
    for name in GLUE[1:]:
        assert _read(name, _run(log=[])) is None
    assert _read("hour_ms_p95", run) == pytest.approx(70.0)
    assert _read("hour_ms_p95", _run(events=None, log=[])) is None


def test_hour_p95():
    log = [{"name": "loop.hour", "thread": "MainThread", "hour": h,
            "start_us": 0.0, "end_us": 0.0, "device_start_us": 0.0,
            "device_end_us": 1e3 * (h + 1)} for h in range(40)]
    log.append(dict(log[0], device_end_us=None))      # not resolved
    assert _read("hour_ms_p95", _run(log=log)) == pytest.approx(38.0)


def test_hour_p95_on_a_traced_toy_run(tmp_path, monkeypatch):
    """A traced run at 1/40 width on the CPU, with a step that returns
    its state (the plain step's every operation would fill the trace):
    the hours' marks come from the host clock, the glue's parts have no
    device events to read."""
    from mckpp_torch.models.column_model import KppModel
    monkeypatch.setattr(KppModel, "_step",
                        lambda self, st, prm, frc, first_step,
                        with_diags=True: st)
    r = harness.run_cell("terramaris.kpp_hourly", 2**31 + 21, 1.0, True,
                         device="cpu", shrink=40,
                         work=str(tmp_path / "work"))
    m = r["metrics"]
    assert 0 < m["hour_ms_p95"]["value"] < 1e3 * r["run"]["window_s"]
    assert m["hour_ms_p95"]["unit"] == "ms"
    assert not set(GLUE) & set(m)
