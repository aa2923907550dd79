"""The trace readers give known totals on a hand-made trace."""

import json

import pytest

from kppbench import harness, spec, tracing

# (start_us, end_us, name, on_device, is_op)
EVENTS = [
    (0.0, 50.0, "chain.exec", False, True),
    (10.0, 40.0, "kpp::fused_step_kernel<float, 3, 0, 0>", True, False),
    (40.0, 45.0, "void at::native::elementwise_kernel", True, False),
    (60.0, 200.0, "diag.encode", False, True),
    (100.0, 130.0, "kpp::fused_step_kernel<float, 3, 0, 0>", True, False),
    (130.0, 140.0, "Memcpy DtoH (Device -> Pageable)", True, False),
    (150.0, 160.0, "void at::native::elementwise_kernel", True, False),
]


def _run(**kw):
    base = dict(steps=2, dto=1200.0, ncol=10, setup_s=1.0, window_s=1.0,
                init_s=0.5, peak_bytes=1, summary={})
    base.update(kw)
    return harness.Run(**base)


def test_stats_window_and_idle():
    st = tracing.stats(EVENTS)
    assert st["window_ms"] == pytest.approx(0.160)
    assert st["device_busy_ms"] == pytest.approx(0.085)
    assert st["device_idle_share"] == pytest.approx(1 - 85 / 160)
    assert st["kernel_ms_kpp"] == pytest.approx(0.060)
    assert st["kernel_ms_other"] == pytest.approx(0.025)


def test_load_reads_chrome_trace(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5},
        {"ph": "X", "cat": "user_annotation", "name": "chain.exec",
         "ts": 0, "dur": 9},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 2, "dur": 3},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 2}]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    assert tracing.load(str(p)) == [(0.0, 5.0, "aten::add", False, True),
                                    (0.0, 9.0, "chain.exec", False, True),
                                    (2.0, 5.0, "k", True, False)]


def test_readers_on_hand_made_trace():
    st = tracing.stats(EVENTS)
    run = _run(events=EVENTS, stats=st, ops_per_step=1.0e6,
               step_bytes=3_350_000, peaks=(1.0e12, 3.35e12))
    read = lambda name: spec.reader(name)(run)
    assert read("glue_ms_per_step") == pytest.approx(0.025 / 2)
    assert read("device_idle_share") == pytest.approx(100 * (1 - 85 / 160))
    # bound a launch: max(3.35e6 B / 3.35e12 B/s, 1e6 / 1e12) = 1e-6 s;
    # 2 launches over 60 us
    assert read("roofline.fused_step") == pytest.approx(100 * 2e-6 / 60e-6)
    assert read("step_mfu") == pytest.approx(100 * 2e6 / (160e-6 * 1e12))


def test_breakdown_labels_gaps():
    b = tracing.breakdown(EVENTS)
    assert b["device_ops"][0][0].startswith("kpp::fused_step_kernel")
    assert b["device_ops"][0][1] == pytest.approx(60e-6)
    gaps = dict(b["idle_gaps"])
    # 45-100 under diag.encode (40 us of overlap) against chain.exec (5)
    assert gaps["diag.encode"] == pytest.approx(55e-6 + 10e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_without_trace():
    run = _run(summary={"bytes_written": 2_000_000})
    assert spec.reader("roofline.fused_step")(run) is None
    assert spec.reader("device_idle_share")(run) is None
    assert spec.reader("diag_mb_per_sim_day")(run) == pytest.approx(
        2.0 / (2 * 1200.0 / 86400.0))
    assert spec.reader("col_steps_per_s")(run) == pytest.approx(20.0)
