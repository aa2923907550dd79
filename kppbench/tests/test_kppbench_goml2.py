"""The ``goml2_n216`` configuration and its cell: the entries resolve to
their files, the cell's two per-layer readers read what they should (the
4-slot step kernel's launches alone, the program's pass counter) and
nothing where there is nothing, and at toy size on the CPU (the grid
divided by 40, every one of its 100 levels kept) a sound run is correct
and the control is not."""

import json
import os

import pytest

from kppbench import harness, spec

CELL = "goml2_n216.kpp_means"
STEP3 = ("void kpp::fused_step_kernel<float, 3, (kpp::Spread)0, "
         "(kpp::Layout)0>(kpp::PassParams, kpp::Geometry)")
STEP4 = STEP3.replace("float, 3,", "float, 4,")
PAIR4 = STEP4.replace("(kpp::Spread)0", "(kpp::Spread)3")


def _json(*parts):
    with open(os.path.join(spec.ROOT, "kppbench", *parts)) as f:
        return json.load(f)


def test_cell_resolves_with_the_keys_of_terramaris():
    bench = spec.load_benchmark()
    assert spec.problems(bench) == []
    cell = spec.resolve(CELL)
    cfg, ref = cell.config, _json("configs", "terramaris.json")
    entry = next(c for c in bench["configs"] if c["name"] == "goml2_n216")
    # the source's cuts are named in ``reduced`` and described in the file
    assert set(cfg) == set(ref) | set(entry["reduced"])
    assert (cfg["nx"], cfg["ny"], cfg["nz"], cfg["dmax"]) == \
        (432, 324, 100, 1000.0)
    assert cell.chips == 1 and cell.traffic == _json("traffic",
                                                     "kpp_means.json")
    assert set(cell.limits) == set(_json("limits", "terramaris.json"))
    assert [m["name"] for m in cell.per_layer] == [
        "roofline.fused_step_ns4", "step_passes_per_col"]
    assert {m["name"] for m in cell.end_to_end} >= {"col_steps_per_s",
                                                    "setup_s"}


def _run(events=None, summary=None):
    return harness.Run(steps=3, dto=1200.0, ncol=10, setup_s=1.0,
                       window_s=1.0, init_s=0.5, peak_bytes=1,
                       summary=summary or {}, events=events,
                       ops_per_step=1.0e6, step_bytes=3_350_000,
                       peaks=(1.0e12, 3.35e12))


def test_ns4_roofline_reads_the_4_slot_build_alone():
    read = spec.reader("roofline.fused_step_ns4")
    ev = lambda t0, t1, name: (t0, t1, name, True, False)
    # bound a launch: max(3.35e6 B / 3.35e12 B/s, 1e6 / 1e12) = 1e-6 s;
    # the 4-slot launches: 2 over 40 us
    events = [ev(0, 100, STEP3), ev(100, 130, STEP4), ev(130, 140, STEP4),
              ev(140, 400, PAIR4), (0, 500, "chain.replay", False, True)]
    assert read(_run(events)) == pytest.approx(100 * 2e-6 / 40e-6)
    assert read(_run([ev(0, 100, STEP3), ev(100, 200, PAIR4)])) is None
    assert read(_run(None)) is None


def test_pass_counter_metric():
    read = spec.reader("step_passes_per_col")
    summary = {"counters": {"step.passes": 120}, "ocean_columns": 8}
    assert read(_run(summary=summary)) == pytest.approx(120 / (8 * 3))
    # a program without the counter (the parent of this metric)
    assert read(_run(summary={"counters": {}, "ocean_columns": 8})) is None
    assert read(_run(summary={"counters": {"chain.load_bytes": 1}})) is None


def test_sound_run_is_correct_and_control_fails(tmp_path):
    r = harness.run_cell(CELL, 2**31 + 21, 1.0, False, device="cpu",
                         shrink=40, control=True, work=str(tmp_path / "w"))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and set(r["checks"]) >= {
        "hmix_mean.first", "hmix_mean.last", "T.end", "S.end", "UV.end",
        "hmix.end", "kmix.end", "fill_bad", "records_bad"}
    ctl = r["control"]
    assert not ctl["correct"] and ctl["failed"] >= 1, ctl
