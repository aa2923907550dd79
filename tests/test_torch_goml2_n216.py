"""The N216 deployment of MetUM-GOML2 (``kppbench/configs/goml2_n216.json``:
432 x 324 columns, 100 levels over 1000 m), the first at nz + 2 = 102,
past the 96 level slots of the 3-slot kernels.

On the CPU, on the benchmark's seeded inputs of that configuration with
its full 324 rows from pole to pole (one column a row): the port's fused
whole step (``eager_step``, the plain body of the 4-slot step kernel)
follows the benchmark's frozen plain reference (``kppbench/reference``)
over 9 steps on columns at the poles, at mid-latitudes and inside the
Coriolis floor; the CLI's ``step.passes`` counter is the sum of the
step's colstep row 7 over the ocean columns, and a step run under
``KppModel.uncounted`` adds nothing to it; the port's own input set of
the grid (``benchmark_inputs.generate("goml2_n216")``) has its shape.
Tests marked ``gpu`` need a
CUDA card and skip without one: the 4-slot step kernel at the
deployment's full width against its plain body, and the CLI's counter
and step-kernel build with CUDA graphs against a run without them.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from kppbench import inputs, spec
from kppbench.reference import column
from mckpp_torch import forcing, setup
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.ops import fused_pass as fp
from mckpp_torch.utils import namelist as nml

from test_torch_kernels import INT_ROWS  # noqa: E402

STEPS = 9
SEED = 2**31 + 17
# |lat| under which the port floors the Coriolis parameter
# (grid.coriolis)
F_FLOOR_LAT = 2.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file's CPU runs (324 columns
    at 102 levels), the previous count restored after: six pytest
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deployment(nx=None):
    """The configuration as the benchmark runs it, at ``nx`` columns a
    row where given (every row kept)."""
    cfg = dict(spec.resolve("goml2_n216.kpp_means").config)
    if nx is not None:
        cfg["nx"] = nx
    return cfg


def write_inputs(cfg, d, steps=STEPS):
    traffic = spec.resolve("goml2_n216.kpp_means").traffic
    data = os.path.join(d, "in")
    inputs.prepare(cfg, traffic, os.path.join(d, "static"), data, SEED)
    with open(os.path.join(data, "3D_ocn.nml"), "w") as f:
        f.write(inputs.namelist(cfg, steps, 0))
    return data


def chosen_columns(cfg, data):
    """Ocean columns of one column a row: the first ocean row from each
    pole, the ocean rows nearest 45 S and 45 N, and those nearest the
    equator on either side (inside the Coriolis floor)."""
    lats = cfg["lat0"] + cfg["dlat"] * np.arange(cfg["ny"])
    ocean = np.flatnonzero(
        column.read_nc(os.path.join(data, "lsm.nc"), ["lsm"])["lsm"]
        .reshape(-1) != 1.0)
    olat = lats[ocean]
    pick = {int(ocean[0]), int(ocean[-1])}
    for target in (-45.0, 45.0):
        pick.add(int(ocean[np.argmin(np.abs(olat - target))]))
    for side in (olat < 0, olat >= 0):
        near = np.flatnonzero(side)
        pick.add(int(ocean[near[np.argmin(np.abs(olat[near]))]]))
    cols = np.array(sorted(pick))
    assert sum(abs(lats[c]) < F_FLOOR_LAT for c in cols) == 2
    assert abs(lats[cols[0]]) > 85 and abs(lats[cols[-1]]) > 85
    return cols


@pytest.fixture(scope="module")
def n216_rows(tmp_path_factory):
    cfg = deployment(nx=1)
    data = write_inputs(cfg, str(tmp_path_factory.mktemp("goml2")))
    return cfg, data


def port_states(data, dtype, impl, wscale, steps=STEPS):
    """The port's model, state, parameters and forcing after ``steps``
    steps through the CLI loop's flux and SST updates."""
    kcfg, _ = nml.load_config(os.path.join(data, "3D_ocn.nml"))
    kcfg = dataclasses.replace(
        kcfg, dtype=dtype, physics=dataclasses.replace(
            kcfg.physics, pass_impl=impl, wscale_mode=wscale))
    model, st, prm, frc, _, mgr = setup.build(kcfg, data, device="cpu")
    t = kcfg.time
    for nt in range(1, steps + 1):
        time_days = t.startt + (nt - 1) * t.dto / 86400.0
        if (nt - 1) % t.ndtocn == 0:
            raw = forcing.constant_test_fluxes(st.u.shape[0], model.dtype)
            st, frc = forcing.update_fluxes(kcfg, st, prm, frc, raw,
                                            nt <= 1, model.grid.dm)
        if nt != 1:
            frc = mgr.update(nt, time_days, frc)
        st = model.step(st, prm, frc, first_step=nt <= 1)
    return model, st, prm, frc


def test_fused_step_follows_the_reference(n216_rows):
    """Both in float64 with the analytic velocity scales (the card's
    float32 choice): the same algorithm, whose one difference is the
    order in which the reference averages sum ``aref``'s terms (the port
    a ``torch.matmul``, the reference its own), so u, T, S and hmix agree
    to 1e-10 of their scale and kmix exactly, as
    ``kppbench/tests/test_kppbench_reference.py`` holds them at nz 69."""
    cfg, data = n216_rows
    cols = chosen_columns(cfg, data)
    _, got, prm, _ = port_states(data, "float64", "eager_step",
                                 "analytic")
    col = column.load_columns(cfg, data, cols, wscale="analytic")
    st, rprm, frc = column.initial_state(cfg, data, col, cols)
    st, _, _, _ = column.run(col, st, rprm, frc, 0, STEPS, [])
    idx = torch.as_tensor(cols)
    # the floor's rows run with the floored f, the poles' with the largest
    assert torch.equal(prm.f[idx], rprm.f)
    assert torch.equal(got.kmix[idx], st.kmix)
    for f in ("u", "x", "hmix"):
        a, b = getattr(got, f)[idx], getattr(st, f)
        scale = b.abs().max()
        assert float((a - b).abs().max() / scale) < 1e-10, f


def test_pass_counter_sums_colstep_row_7(n216_rows, tmp_path, monkeypatch):
    """The CLI on the CPU (float32, the fused whole step's plain body, the
    chain without graphs): ``step.passes`` is the sum of colstep row 7
    over the ocean columns of every step, land columns run none, and the
    summary gives the ocean columns the counter's metric divides by."""
    cfg, data = n216_rows
    rows = []
    make = fp.make_fused_step

    def recording(*a, **k):
        fn = make(*a, **k)

        def step(*args, **kw):
            outs = fn(*args, **kw)
            rows.append(outs[8][7].clone())
            return outs
        return step
    monkeypatch.setattr(fp, "make_fused_step", recording)
    from mckpp_torch import cli
    summary = cli.run(["--namelist", os.path.join(data, "3D_ocn.nml"),
                       "--data-dir", data, "--output-dir",
                       str(tmp_path / "out"), "--dtype", "float32",
                       "--device", "cpu"])
    lsm = column.read_nc(os.path.join(data, "lsm.nc"), ["lsm"])["lsm"]
    ocean = torch.as_tensor(lsm.reshape(-1) != 1.0)
    assert len(rows) == STEPS and summary["ocean_columns"] == int(ocean.sum())
    total = torch.stack(rows)
    assert float(total[:, ~ocean].abs().sum()) == 0.0
    assert summary["counters"]["step.passes"] == int(total[:, ocean].sum())
    # 3 compulsory passes, then at least one of the hmix loop
    assert (total[:, ocean] >= 4).all()
    assert summary["step_kernel"] is None          # no kernel on the CPU


def test_uncounted_steps_add_nothing(n216_rows):
    """A step under ``uncounted`` (a CUDA graph's eager warm-up, which
    the replays run again) leaves the counter as it was; the next one
    adds its passes."""
    _, data = n216_rows
    model, st, prm, frc = port_states(data, "float32", "eager_step",
                                      "analytic", steps=1)
    before = model.passes.clone()
    assert float(before.sum()) > 0
    with model.uncounted():
        model.step(st, prm, frc)
    assert torch.equal(model.passes, before)
    model.step(st, prm, frc)
    assert float(model.passes.sum()) > float(before.sum())


def test_reference_impl_counts_no_passes(n216_rows):
    """The plain reference step has no colstep: no counter."""
    _, data = n216_rows
    model = port_states(data, "float32", "reference", "nodal", steps=1)[0]
    assert model.passes is None


def test_port_writes_the_n216_grid(tmp_path):
    """The port's own input set of the deployment (``chip_smoke.py``'s
    4-slot phase), shrunk by 8: the N216 grid from pole to pole at nz =
    100 over 1000 m, exactly 40% land, analytic fluxes and the SST
    relaxation on every row, read by the port's set-up."""
    from mckpp_torch.io import benchmark_inputs
    d = str(tmp_path / "n216")
    grid = benchmark_inputs.generate("goml2_n216", d, toy=True)
    assert (grid["nx"], grid["ny"], grid["nz"], grid["dmax"]) == \
        (54, 40, 100, 1000.0)
    assert grid["land_share"] == 0.4
    assert "goml2_n216" not in benchmark_inputs.CONFIGS   # no JAX twin
    lat = column.read_nc(os.path.join(d, "lsm.nc"), ["latitude"])["latitude"]
    assert lat[0] == pytest.approx(-89.72222)
    assert lat[-1] == pytest.approx(-89.72222 + 39 * 8 * 0.55556)
    kcfg, _ = nml.load_config(os.path.join(d, "3D_ocn.nml"))
    assert (kcfg.domain.nz, kcfg.forcing.l_fluxdata) == (100, False)
    assert kcfg.boundary.relax_sst_in == (5.0,) * 40


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """The benchmark's inputs of the whole N216 grid (139,968 columns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = deployment()
    return cfg, write_inputs(cfg, str(tmp_path_factory.mktemp("n216")))


@pytest.mark.gpu
def test_ns4_step_kernel_matches_its_plain_body(cuda, full_width,
                                                monkeypatch):
    """The first two steps of the deployment at 139,968 x 100 (float32,
    col_lanes, cuda_step): each launch of the whole-step kernel runs the
    4-slot one-warp build, 8 columns a block, and equals its plain body
    on the same inputs to 1e-5 of each output's scale (the kernels' bar,
    ``tests/test_torch_kernels.py``), its integer rows (kmix, comp_flag,
    the retries, the passes) exactly."""
    _, data = full_width
    kcfg, _ = nml.load_config(os.path.join(data, "3D_ocn.nml"))
    kcfg = dataclasses.replace(kcfg, dtype="float32")
    model, st, prm, frc, _, mgr = setup.build(kcfg, data, device=cuda)
    calls = []
    orig = ck.FusedStep.__call__

    def call(w, *a, **kw):
        calls.append((w, a, kw))
        return orig(w, *a, **kw)
    monkeypatch.setattr(ck.FusedStep, "__call__", call)
    raw = forcing.constant_test_fluxes(st.u.shape[0], model.dtype, cuda)
    st, frc = forcing.update_fluxes(kcfg, st, prm, frc, raw, True,
                                    model.grid.dm)
    st = model.step(st, prm, frc, first_step=True, with_diags=False)
    model.step(st, prm, frc, first_step=False, with_diags=False)
    assert len(calls) == 2
    pos, int_rows = INT_ROWS["fused_step"]
    for w, a, kw in calls:
        g = ck.launch_geometry(100, a[0].dtype, a[0].shape[1],
                               ck._ref_extents(a[-1])[1])
        assert (g.lib, g.ns, g.warps, g.cols_per_block) == (4, 4, 8, 8)
        assert kw["mask"] is prm.run_physics
        got = w.launch(*a, **kw)
        ref = fp._step_body(*a, **w.kw)
        torch.cuda.synchronize()
        for g_, r in zip(got, ref):
            rel = float((g_ - r).abs().max()) / max(float(r.abs().max()),
                                                    1e-6)
            assert rel <= 1e-5, rel
        for row in int_rows:
            assert torch.equal(got[pos][row], ref[pos][row]), row
    build = dict(ck.STEP_BUILD)
    assert build.pop("block_fill") >= 0.9999      # the ocean columns first
    assert build == {"lib": "ns4", "slots": 4, "warps": 8, "cols": 8}


@pytest.mark.gpu
def test_cli_counts_passes_once_a_step(cuda, full_width, tmp_path,
                                       monkeypatch):
    """9 steps of the deployment through the CLI with its defaults (CUDA
    graphs, each capture's eager warm-up uncounted) and with the chain
    off (``MCKPP_CHAIN=0``, a step at a time): the same ``step.passes``,
    and the summary names the 4-slot build."""
    from mckpp_torch import cli
    _, data = full_width
    argv = ["--namelist", os.path.join(data, "3D_ocn.nml"), "--data-dir",
            data, "--dtype", "float32"]
    graphs = cli.run(argv + ["--output-dir", str(tmp_path / "g")])
    monkeypatch.setenv("MCKPP_CHAIN", "0")
    eager = cli.run(argv + ["--output-dir", str(tmp_path / "e")])
    assert graphs["captures"] > 0
    assert graphs["launches"]["fused_step"] > STEPS
    builds = [dict(r["step_kernel"]) for r in (graphs, eager)]
    for b in builds:
        assert b.pop("block_fill") >= 0.9999
    assert builds[0] == builds[1] == {"lib": "ns4", "slots": 4, "warps": 8,
                                      "cols": 8}
    passes = graphs["counters"]["step.passes"]
    assert passes == eager["counters"]["step.passes"]
    assert 4 * STEPS * graphs["ocean_columns"] <= passes
