"""``step_block_fill`` reads the block fill the program's summary reports
for its whole-step kernel, and nothing where the program reports none (a
program before the fill, a run that launched no step kernel)."""

import pytest

from kppbench import harness, spec


def _run(summary):
    return harness.Run(steps=3, dto=1200.0, ncol=10, setup_s=1.0,
                       window_s=1.0, init_s=0.5, peak_bytes=1,
                       summary=summary, events=None, ops_per_step=1.0e6,
                       step_bytes=3_350_000, peaks=(1.0e12, 3.35e12))


def test_block_fill_metric():
    bench = spec.load_benchmark()
    assert spec.problems(bench) == []
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "step_block_fill")
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]]
    read = spec.reader("step_block_fill")
    build = {"lib": "ns4", "slots": 4, "warps": 8, "cols": 8}
    assert read(_run({"step_kernel": dict(build, block_fill=0.99995)})) \
        == pytest.approx(0.99995)
    assert read(_run({"step_kernel": dict(build, block_fill=1)})) == 1.0
    # no fill: the parent's build, a launch without a mask, no step kernel
    assert read(_run({"step_kernel": build})) is None
    assert read(_run({"step_kernel": dict(build, block_fill=None)})) is None
    assert read(_run({"step_kernel": None})) is None
    assert read(_run({})) is None
