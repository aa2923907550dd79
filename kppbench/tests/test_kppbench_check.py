"""The check on the CPU at toy size (the grids divided by 40): a sound
run is correct, the control (the reference in bfloat16 in the program's
place) comes out not correct by the harness's own judgement, and a run
with the timed path broken underneath (the step returning its state
unchanged, half of the columns left unstepped, an answer altered where
it is produced) comes out not correct.  The harness runs as on the card,
without the look for a card.  A metric reader that imports a module
named ``jax`` leaves the run without a result."""

import json
import os
import shutil
import sys

import pytest
import torch

from kppbench import harness, spec


def _run(workload, seed, tmp_path, control=False, root=spec.ROOT):
    return harness.run_cell(workload, seed, 1.0, False, device="cpu",
                            shrink=40, control=control, root=root,
                            work=str(tmp_path / "work"))


def test_sound_run_is_correct_and_control_fails(tmp_path):
    r = _run("terramaris.kpp_hourly", 2**31 + 11, tmp_path, control=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == len(r["checks"])
    assert set(r["checks"]) >= {"hmix_mean.first", "hmix_inst.last",
                                "T.end", "fill_bad", "records_bad"}
    ctl = r["control"]
    assert not ctl["correct"] and ctl["failed"] >= 1, ctl
    assert set(ctl["values"]) <= set(r["checks"])


def _unchanged(step):
    def inner(self, st, prm, frc, first_step, with_diags=True):
        return st
    return inner


def _half(step):
    def inner(self, st, prm, frc, first_step, with_diags=True):
        from mckpp_torch.state import select
        new = step(self, st, prm, frc, first_step, with_diags=with_diags)
        keep = torch.arange(st.u.shape[0]) < st.u.shape[0] // 2
        return select(keep, new, st)
    return inner


def _altered_state(step):
    def inner(self, st, prm, frc, first_step, with_diags=True):
        new = step(self, st, prm, frc, first_step, with_diags=with_diags)
        x = new.x.clone()
        x[::5, 0, 0] += 0.01
        return new.replace(x=x)
    return inner


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered_state],
                         ids=["unchanged", "half", "altered_state"])
def test_broken_step_is_not_correct(fault, tmp_path, monkeypatch):
    from mckpp_torch.models.column_model import KppModel
    monkeypatch.setattr(KppModel, "_step", fault(KppModel._step))
    r = _run("terramaris.kpp_means", 2**31 + 12, tmp_path)
    assert not r["correct"], r["checks"]


def test_altered_output_is_not_correct(tmp_path, monkeypatch):
    """0.1 m added to the 3-hourly mean of hmix as the writer
    materializes it."""
    from mckpp_torch.io.diagnostics import DiagnosticsManager
    orig = DiagnosticsManager._materialize

    def materialize(self, packed):
        rec = orig(self, packed)
        if "hmix_mean" in rec:
            rec["hmix_mean"] = rec["hmix_mean"] + 0.1
        return rec
    monkeypatch.setattr(DiagnosticsManager, "_materialize", materialize)
    r = _run("terramaris.kpp_means", 2**31 + 13, tmp_path)
    assert not r["correct"], r["checks"]
    assert r["checks"]["hmix_mean.first"]["value"] > \
        r["checks"]["hmix_mean.first"]["limit"]


def test_metric_importing_jax_leaves_no_result(tmp_path, monkeypatch,
                                               capsys):
    """A metric file added to a copy of the benchmark imports a stub
    module named ``jax``: the run raises once its readers have run, and
    the result line is never printed."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(spec.ROOT, "kppbench"), root / "kppbench",
                    ignore=shutil.ignore_patterns("_work", "_cache",
                                                  "__pycache__"))
    bench = spec.load_benchmark(spec.ROOT)
    bench["end_to_end"].append({"name": "planted", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "kppbench" / "metrics" / "planted.py").write_text(
        "import jax\n\n\ndef read(run):\n    return 1.0\n")
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        with pytest.raises(RuntimeError, match="jax"):
            _run("terramaris.kpp_means", 2**31 + 14, tmp_path,
                 root=str(root))
        assert "jax" in sys.modules
        with pytest.raises(RuntimeError, match="jax"):
            harness.report({"checks": {}})
    finally:
        sys.modules.pop("jax", None)
    assert capsys.readouterr().out == ""
