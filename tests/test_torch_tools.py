"""The port's run tooling on the CPU: the baseline runner
(``mckpp_torch.tools.run_baseline_benchmarks``), the weak-scaling harness
(``tools.bench_scaling``), the trace digest (``tools.summarize_trace``),
the GPU launcher (``mckpp_torch/launch``), and two API members of the
JAX package the port carries: ``Timers.section`` and
``RestartControl(async_write=False)``.

The runner's parsers are held to the JAX tool's on the same captured
port CLI output; its runs go at the inputs' ``--toy`` size with
``--device cpu`` and a few steps.  The scaling harness runs 1 and 2 gloo
processes at 64 columns a rank.  The timer and the restart control are
held to the JAX classes on the same calls: the timer table's text equal
under one clock, the restart files equal byte for byte.
"""

import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from mckpp_tpu.io import restart as jrestart
from mckpp_tpu.utils import timer as jtimer

from mckpp_torch import cli
from mckpp_torch.io import restart as trestart
from mckpp_torch.tools import bench_scaling, summarize_trace
from mckpp_torch.tools import run_baseline_benchmarks as rb
from mckpp_torch.utils import timer as ttimer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_io import NX, NY, _pair  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool():
    """tools/run_baseline_benchmarks.py, the JAX package's runner."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_baseline", os.path.join(ROOT, "tools",
                                         "run_baseline_benchmarks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def regional(tmp_path_factory):
    """One toy regional_64x64 run of the port's CLI (8 steps, CPU), its
    output captured: the text the runner parses."""
    import contextlib
    import io
    from mckpp_torch.io.benchmark_inputs import generate
    d = tmp_path_factory.mktemp("regional")
    generate("regional_64x64", str(d), toy=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run(["--namelist", str(d / "3D_ocn.nml"), "--data-dir", str(d),
                 "--output-dir", str(d / "out"), "--steps", "8",
                 "--dtype", "float32", "--device", "cpu"])
    return buf.getvalue()


def test_runner_parsers_match_the_jax_tool(regional):
    """parse_timers and the steady-state rate give the JAX tool's numbers
    on the port CLI's output."""
    jt = jax_tool()
    timers = rb.parse_timers(regional)
    assert timers == jt.parse_timers(regional)
    assert {"Total", "Physics", "Initialization", "Diagnostic output",
            "Update surface fluxes"} <= set(timers)
    pat = re.search(r're\.search\(r"(steady-state:[^"]*)"',
                    inspect.getsource(jt.run_cli_config)).group(1)
    m = re.search(pat, regional)
    nx, ny, _ = jt.domain_of("regional_64x64")
    ref = float(m.group(2)) / float(m.group(1)) * nx * ny
    assert rb.parse_steady(regional, nx * ny) == ref > 0


@pytest.mark.parametrize("config", ["single_column", "regional_64x64"])
def test_run_cli_config_on_the_cpu(tmp_path, config):
    res = rb.run_cli_config(config, str(tmp_path), 3, device="cpu", toy=True)
    assert res["config"] == config and res["steps"] == 3
    assert res["ncol"] == {"single_column": 1, "regional_64x64": 64}[config]
    assert res["nz"] == {"single_column": 100, "regional_64x64": 40}[config]
    assert res["output_files"] == 1 and res["output_bytes"] > 0  # 1 h stream
    assert res["col_steps_per_s_wall"] > 0 and res["physics_s"] > 0
    assert res["col_steps_per_s_wall"] == \
        res["ncol"] * 3 / res["model_loop_s"] == \
        res["ncol"] * 3 / res["timers"]["Total"]
    assert res["wall_s"] >= res["inputs_s"] + res["model_loop_s"] - 1e-3
    assert res["col_steps_per_s_steady"] is None      # no half of 3 steps
    assert res["launches"] == {"fused_pass_fast": 0, "fused_pass_full": 0,
                               "fused_step": 0}
    assert res["peak_memory_bytes"] is None
    json.dumps(res)


def test_run_ensemble_on_the_cpu(tmp_path):
    res = rb.run_ensemble(str(tmp_path), 3, n_members=2, device="cpu",
                          toy=True)
    assert res["members"] == 2 and res["ncol"] == 2 * 45 * 22
    assert res["output_files"] == 1 and res["restarts"] == 1
    assert {"Physics", "Diagnostic output", "Restart output",
            "Update surface fluxes", "Initialization"} <= set(res["timers"])
    # the CLI configurations' definitions of wall, loop and rate
    assert res["model_loop_s"] == res["timers"]["Total"]
    assert res["col_steps_per_s_wall"] == res["ncol"] * 3 / \
        res["model_loop_s"]
    assert res["wall_s"] >= res["inputs_s"] + res["model_loop_s"] - 1e-3
    out = tmp_path / "ensemble10_dd" / "out"
    from scipy.io import netcdf_file
    (inst,) = out.glob("output_kpp_0*.nc")          # the 1 h stream
    with netcdf_file(str(inst), "r", mmap=False) as nc:
        t = np.array(nc.variables["T_inst"][:])
    assert t.shape[-2:] == (2 * 22, 45)               # members stack on y
    sea = t[..., t[0, 0] != np.float32(1e20)]
    assert np.isfinite(sea).all()
    json.dumps(res)


def test_runner_exits_nonzero_when_a_config_fails(tmp_path, monkeypatch,
                                                  capsys):
    """The failed configuration prints an error line, the others still
    run, --out holds every line, and the exit code is 1."""
    real = rb.run_cli_config

    def flaky(config, *a, **k):
        if config == "regional_64x64":
            raise RuntimeError("regional_64x64 failed rc=1")
        return real(config, *a, **k)
    monkeypatch.setattr(rb, "run_cli_config", flaky)
    out = tmp_path / "res.json"
    rc = rb.main(["--configs", "regional_64x64,single_column", "--steps",
                  "2", "--toy", "--device", "cpu", "--workdir",
                  str(tmp_path / "w"), "--out", str(out)])
    assert rc == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["config"] for x in lines] == ["regional_64x64",
                                            "single_column"]
    assert "failed rc=1" in lines[0]["error"] and "error" not in lines[1]
    assert all(x["card"] == "cpu" and x["power_limit"] == "cpu"
               for x in lines)
    assert json.loads(out.read_text()) == lines
    assert not (tmp_path / "w" / "single_column").exists()   # not --keep


def test_bench_scaling_two_gloo_processes(capsys):
    """1 and 2 ranks of 64 columns at nz 12: a line per count, the two
    ranks labelled as sharing the CPU, the summary the split cost."""
    lines = bench_scaling.run(["--ranks", "1,2", "--cols-per-rank", "64",
                               "--nz", "12", "--steps", "2", "--device",
                               "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines and len(lines) == 3
    one, two, summary = lines
    assert (one["ranks"], one["time_shared"], one["ncol"]) == (1, False, 64)
    assert (two["ranks"], two["time_shared"], two["ncol"]) == (2, True, 128)
    for ln in (one, two):
        assert ln["metric"] == "weak_scaling_step_time"
        assert len(ln["step_ms_per_rank"]) == ln["ranks"]
        assert ln["column_steps_per_s_total"] == pytest.approx(
            sum(ln["column_steps_per_s_per_rank"]))
        assert ln["card"] == "cpu" and ln["pass_impl"] == "eager_step"
    assert summary["metric"] == "split_cost" and summary["time_shared"]
    assert summary["value"] == pytest.approx(
        two["step_ms"] / (2 * one["step_ms"]))
    assert "weak_scaling_efficiency" not in json.dumps(summary)


def test_scaling_summary_without_sharing():
    """With a device a rank the summary is the weak-scaling efficiency."""
    lines = [{"ranks": 1, "time_shared": False, "step_ms": 10.0,
              "cols_per_rank": 64},
             {"ranks": 4, "time_shared": False, "step_ms": 12.5,
              "cols_per_rank": 64}]
    s = bench_scaling.summary_line(lines)
    assert s["metric"] == "weak_scaling_efficiency" and s["value"] == 0.8
    assert not s["time_shared"]


def test_summarize_trace_of_a_cpu_run(tmp_path, capsys):
    """The trace the CLI's --profile writes on the CPU has no device
    events: the digest says so and tables the host ops."""
    from mckpp_torch.io.benchmark_inputs import generate
    d = tmp_path / "in"
    generate("single_column", str(d), toy=True)
    prof = tmp_path / "prof"
    cli.run(["--namelist", str(d / "3D_ocn.nml"), "--data-dir", str(d),
             "--output-dir", str(tmp_path / "out"), "--steps", "4",
             "--device", "cpu", "--profile", str(prof), "--profile-steps",
             "2"])
    capsys.readouterr()
    assert summarize_trace.main([str(prof)]) == 0
    text = capsys.readouterr().out
    assert "no device events" in text
    st = json.loads(text.splitlines()[-1])
    assert st["device_events"] == 0 and st["host_ops"] > 0
    assert st["host_ms_by_op"] and all(v >= 0 for v in
                                       st["host_ms_by_op"].values())


def test_summarize_trace_known_totals(tmp_path):
    """A hand-made chrome trace: host ops from t=0, device events at
    10-20 (kpp::fused_step_kernel), 15-25 (a copy, overlapping) and 30-40
    (another kernel twice) us: window 0..40 us, busy 25 us, idle 37.5%."""
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur, "pid": 0,
                                     "tid": 0}
    trace = {"traceEvents": [
        ev("cpu_op", "aten::add", 0.0, 5.0),
        ev("cuda_runtime", "cudaLaunchKernel", 2.0, 1.0),
        ev("kernel", "void kpp::fused_step_kernel<float, 4>(...)", 10.0,
           10.0),
        ev("gpu_memcpy", "Memcpy DtoD", 15.0, 10.0),
        ev("kernel", "elementwise", 30.0, 5.0),
        ev("kernel", "elementwise", 35.0, 5.0),
        {"ph": "M", "name": "process_name", "pid": 0}]}
    path = tmp_path / "trace_rank1.json"
    path.write_text(json.dumps(trace))
    assert summarize_trace.traces(str(tmp_path)) == [str(path)]
    st = summarize_trace.stats(summarize_trace.load(str(path)))
    assert st["device_events"] == st["device_launches"] == 4
    assert st["window_ms"] == pytest.approx(0.040)
    assert st["device_busy_ms"] == pytest.approx(0.025)
    assert st["device_idle_share"] == pytest.approx(0.375)
    assert st["kernel_ms_kpp"] == pytest.approx(0.010)
    assert st["kernel_ms_other"] == pytest.approx(0.020)
    assert st["kpp_share"] == pytest.approx(1 / 3)
    assert st["launches_by_kernel"]["elementwise"] == 2


def test_gpu_launcher_parses():
    """KPPocean_gpu.slurm passes ``bash -n``; it runs torchrun per node
    over the Slurm nodes with the rendezvous on the first, and the CLI
    arguments it passes parse under mckpp_torch.cli's parser."""
    import shlex
    from mckpp_torch import launch
    slurm = os.path.join(os.path.dirname(launch.__file__),
                         "KPPocean_gpu.slurm")
    r = subprocess.run(["bash", "-n", slurm], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr
    with open(slurm) as f:
        text = f.read()
    assert "torchrun --nnodes ${SLURM_NNODES} --nproc-per-node" in text
    assert "head -n1" in text and "--rdzv-endpoint ${RDZV_HOST}" in text
    m = re.search(r"-m mckpp_torch\.cli\s+([^\"\n]*)",
                  text.replace("\\\n", " "))
    argv = shlex.split(m.group(1))
    assert argv == ["--namelist", "3D_ocn.nml", "--data-dir", ".",
                    "--output-dir", "output", "--distributed"]
    args = cli._parser().parse_args(argv)
    assert args.distributed and args.namelist == "3D_ocn.nml"
    assert args.device == "cuda" and not args.multi_device


def test_timers_section_matches_jax(monkeypatch):
    """The same start/stop/section calls under one fake clock give the JAX
    package's timer table, character for character."""
    tables = []
    for mod in (jtimer, ttimer):
        ticks = iter(np.arange(0.0, 1000.0, 0.25))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.Timers()
        with t.section("Physics"):
            pass
        t.start("Diagnostic output")
        t.stop("Diagnostic output")
        for _ in range(3):
            with t.section("Update surface fluxes"):
                pass
        with t.section("Physics"):
            pass
        tables.append(t.report())
    assert tables[0] == tables[1]
    assert re.search(r"^Update surface fluxes\s+3\s", tables[1], re.M)


def test_restart_control_sync_write_matches_jax(tmp_path):
    """async_write=False: the write happens on the caller's thread,
    maybe_write returns the .npz path, flush returns what was written,
    and the files (npz members and the reference NetCDF) equal the JAX
    package's byte for byte."""
    (js, jp, jf), (ts, tp, tf) = _pair(5)
    jrc = jrestart.RestartControl(str(tmp_path / "j" / "rs"), 2, 5, 1200.0,
                                  0.0, netcdf_grid=(NX, NY),
                                  async_write=False)
    trc = trestart.RestartControl(str(tmp_path / "t" / "rs"), 2, 5, 1200.0,
                                  0.0, netcdf_grid=(NX, NY),
                                  async_write=False)
    assert trc._writer is None
    for nt in range(1, 6):
        got = trc.maybe_write(nt, ts, tp, tf)
        ref = jrc.maybe_write(nt, js, jp, jf)
        assert (got is None) == (ref is None) == (not trc.due(nt))
        if got is not None:
            assert os.path.exists(got)
            assert os.path.basename(got) == os.path.basename(ref)
    paths_t, paths_j = trc.flush(), jrc.flush()
    assert [os.path.basename(p) for p in paths_t] == \
        [os.path.basename(p) for p in paths_j]
    assert len(paths_t) == 6                 # steps 2, 4, 5: npz + nc
    for pt, pj in zip(paths_t, paths_j):
        if pt.endswith(".npz"):
            with zipfile.ZipFile(pt) as a, zipfile.ZipFile(pj) as b:
                assert a.namelist() == b.namelist()
                for name in a.namelist():
                    assert a.read(name) == b.read(name), name
        else:
            with open(pt, "rb") as a, open(pj, "rb") as b:
                assert a.read() == b.read(), pt
