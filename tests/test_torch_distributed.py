"""The port's runs over several processes (``mckpp_torch.parallel``, the
``--distributed`` / ``--multi-device`` / ``--output-mode shard`` CLI) on
the CPU, against the JAX package's layout and against the port's own
single-process run.

* layout slabs equal the JAX layout's per-device slabs (k = 1..8 devices
  of the virtual CPU mesh, odd column counts), padding marks columns
  inactive as the JAX package's ``pad_columns`` does;
* host-local slab reads equal the matching rows of a whole-domain read;
* each slab of a padded domain, stepped on its own, equals the same rows
  of the whole-domain step bit for bit (the plain bodies' batch loops
  leave converged columns alone, and the reference-average matmul rounds
  each column alike at these widths);
* gloo gathers and the any-reduction over two real processes;
* the real CLI as two processes on the end-to-end inputs: single mode
  equal to the one-process run bit for bit (files and restart), shard
  mode with 0 emit gathers and merged files equal to the one-process
  files, ``--multi-device`` on the CPU as one worker equal to the plain
  run;
* the kernel and encoder builds: two concurrent builds into one
  directory (a stand-in compiler) leave whole libraries;
* no module of the port imports jax or mckpp_tpu.
"""

import glob
import os
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mckpp_tpu.parallel import distributed as jdist
from mckpp_tpu.parallel import sharding as jshard
from mckpp_tpu.state import init_params as jinit_params

import mckpp_torch as T
from mckpp_torch import native
from mckpp_torch.io.ancillaries import AncillaryReader, BoundaryManager
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.parallel.distributed import ColumnLayout, make_layout
from mckpp_torch.parallel.sharding import pad_columns, unpad_columns
from mckpp_torch.state import init_params, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_endtoend import write_inputs  # noqa: E402
from test_multihost import _write_inputs as write_slab_inputs  # noqa: E402

STEPS = 9
RUN_TIMEOUT = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the layout against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(1, 9))
def test_layout_slabs_match_jax(k):
    for ncol in (1, 7, 13, 33, 144, 1001):
        jl = jdist.make_layout(ncol, jshard.make_mesh(jax.devices()[:k]))
        imap = jl.sharding.devices_indices_map((jl.ncol,))
        jslabs = [(imap[d][0].start or 0,
                   jl.ncol if imap[d][0].stop is None else imap[d][0].stop)
                  for d in jl.mesh.devices.flat]
        for r in range(k):
            lay = make_layout(ncol, world=k, rank=r, device="cpu")
            assert lay.ncol == jl.ncol and lay.ncol_unpadded == ncol
            assert (lay.lo, lay.hi) == jslabs[r]
            assert lay.local_rows(ncol) == (min(jslabs[r][0], ncol),
                                            min(jslabs[r][1], ncol))


def test_pad_columns_matches_jax():
    tp = init_params(5, 4)
    jp = jinit_params(5, 4)
    tpad, n = pad_columns(tp, 4)
    jpad, jn = jshard.pad_columns(jp, 4)
    assert n == jn == 5
    for f in ("l_ocean", "run_physics", "ocdepth", "jerlov", "u_init"):
        np.testing.assert_array_equal(getattr(tpad, f).numpy(),
                                      np.asarray(getattr(jpad, f)), err_msg=f)
    assert not tpad.run_physics[5:].any() and tpad.run_physics[:5].all()
    assert unpad_columns(tpad, 5).u_init.shape == (5, 4, 2)
    assert pad_columns(tp, 5)[0] is tp


def test_global_array_shape_rules():
    lay = ColumnLayout(ncol=14, ncol_unpadded=13, rank=1, world=2,
                       device="cpu")
    full = np.arange(13.0)
    np.testing.assert_array_equal(lay.global_array(full, local=False).numpy(),
                                  np.r_[np.arange(7.0, 13.0), 0.0])
    np.testing.assert_array_equal(
        lay.global_array(np.ones(7), local=True).numpy(), np.ones(7))
    assert lay.global_array(full).shape == (7,)            # inferred full
    with pytest.raises(ValueError, match="expected 7"):
        lay.global_array(np.ones(6), local=True)
    with pytest.raises(ValueError, match="expected 14"):
        lay.global_array(np.ones(9), local=False)
    amb = ColumnLayout(ncol=2, ncol_unpadded=1, rank=0, world=2,
                       device="cpu")
    with pytest.raises(ValueError, match="both a valid local"):
        amb.global_array(np.ones(1))
    with pytest.raises(ValueError):
        ColumnLayout(ncol=13, ncol_unpadded=13, rank=0, world=2,
                     device="cpu")
    # a slab of a whole-domain tensor is a copy, not a view of it
    t = torch.arange(14.0)
    s = ColumnLayout(ncol=14, ncol_unpadded=14, rank=0, world=2,
                     device="cpu").global_array(t, local=False)
    assert s.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()


def test_layout_device_defaults_to_the_card(monkeypatch):
    """A layout made without a device puts its slabs where the model goes:
    the device initialize() chose, else the card (never the CPU unasked);
    build refuses a layout on another device than its model."""
    from mckpp_torch import setup as tsetup
    from mckpp_torch.parallel import distributed as tdist
    monkeypatch.setattr(tdist, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_layout(13, world=2, rank=0)
    assert make_layout(13, world=2, rank=0, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert make_layout(13, world=2, rank=1).device == torch.device("cuda")
    monkeypatch.setattr(tdist, "_device", torch.device("cuda", 1))
    for lay in (make_layout(13, world=2, rank=1),
                ColumnLayout(ncol=14, ncol_unpadded=13, rank=1, world=2)):
        assert lay.device == torch.device("cuda", 1)
    cfg = T.KppConfig(domain=T.DomainConfig(nx=13, ny=1, nz=4, dmax=100.0))
    with pytest.raises(ValueError, match="one device"):
        tsetup.build(cfg, device="cpu", layout=lay)


# ---------------------------------------------------------------------------
# host-local reads
# ---------------------------------------------------------------------------

SLAB_ROWS = [(0, 15), (0, 8), (8, 15), (7, 8), (4, 11), (15, 15), (14, 15)]


def test_slab_reads_match_full_reads(tmp_path):
    """Every (lo, hi) of tests/test_multihost.py, 2-D and 3-D, against the
    rows of a whole-domain read and the JAX reader's slab read."""
    write_slab_inputs(str(tmp_path))
    from mckpp_tpu.io.ancillaries import AncillaryReader as JReader
    from mckpp_torch.io import ncio
    z = np.linspace(0.0, -3.0, 4)
    col = np.arange(15.0).reshape(3, 5)
    ncio.write_fields(
        str(tmp_path / "t3.nc"), {"t": 2, "z": 4, "latitude": 3,
                                  "longitude": 5},
        {"t": ("t", [0.5, 1.5]), "z": ("z", z),
         "latitude": ("latitude", np.arange(3.0)),
         "longitude": ("longitude", np.arange(5.0))},
        {"temperature": (("t", "z", "latitude", "longitude"),
                         col[None, None] + z[None, :, None, None]
                         + np.arange(2.0)[:, None, None, None])})
    rd = AncillaryReader(f"{tmp_path}/sst.nc", 0.0, 0.0, 5, 3)
    jr = JReader(f"{tmp_path}/sst.nc", 0.0, 0.0, 5, 3)
    r3 = AncillaryReader(f"{tmp_path}/t3.nc", 0.0, 0.0, 5, 3)
    full, full3 = rd.read2d("sst", 3), r3.read3d("temperature", 1, 4)
    assert full.shape == (15,) and full3.shape == (15, 4)
    for lo, hi in SLAB_ROWS:
        got = rd.read2d("sst", 3, rows=(lo, hi))
        np.testing.assert_array_equal(got, full[lo:hi], err_msg=f"{lo}:{hi}")
        np.testing.assert_array_equal(
            got, jr._read2d_uncached("sst", 3, rows=(lo, hi)))
        np.testing.assert_array_equal(
            r3.read3d("temperature", 1, 4, rows=(lo, hi)), full3[lo:hi])


def test_boundary_manager_reads_its_slab(tmp_path):
    """A BoundaryManager with a layout holds its rank's rows of the SST
    (in Kelvin in the file: the autoconversion is decided over the whole
    domain) and of the flux file, padded to the slab."""
    write_slab_inputs(str(tmp_path))
    from mckpp_torch.io.ancillaries import FluxFileReader
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=5, ny=3, nz=4),
        time=T.TimeConfig(dtsec=3600.0, ndtocn=2, startt=0.0, finalt=1.0),
        boundary=T.BoundaryConfig(l_climsst=True, l_upd_climsst=True,
                                  ndtupdsst=2,
                                  sst_file=f"{tmp_path}/sst.nc"),
        forcing=T.ForcingConfig(forcing_file=f"{tmp_path}/fluxes.nc"))
    from mckpp_torch.state import init_forcing
    whole = BoundaryManager(cfg, 0.0, 0.0, 5, np.zeros(15))
    ref = whole.initial_reads(0.0, init_forcing(15, 5)).sst0.numpy()
    whole.drain_prefetch()
    fl_whole = FluxFileReader(cfg, 0.0, 0.0)(0.0)
    assert (ref < 100.0).all()                     # converted from Kelvin
    for rank in range(2):
        lay = ColumnLayout(ncol=16, ncol_unpadded=15, rank=rank, world=2,
                           device="cpu")
        mgr = BoundaryManager(cfg, 0.0, 0.0, 5, np.zeros(15))
        mgr.set_layout(lay)
        frc = mgr.initial_reads(0.0, init_forcing(8, 5))
        mgr.drain_prefetch()
        # the padding column (global 15) is inactive: its values are
        # whatever the reads make of a zero row, as in the JAX package
        n = min(lay.hi, 15) - lay.lo
        assert frc.sst0.shape == (8,)
        np.testing.assert_array_equal(frc.sst0.numpy()[:n],
                                      ref[lay.lo:lay.lo + n])
        fr = FluxFileReader(cfg, 0.0, 0.0)
        fr.set_layout(lay)
        got = fr(0.0)
        for k in got._fields:
            assert getattr(got, k).shape == (8,)
            np.testing.assert_array_equal(
                getattr(got, k).numpy()[:n],
                getattr(fl_whole, k).numpy()[lay.lo:lay.lo + n], err_msg=k)


# ---------------------------------------------------------------------------
# slabs stepped alone == the whole domain stepped
# ---------------------------------------------------------------------------

def small_model(ncol, nz=12, seed=0):
    """A float64 CPU model of ``ncol`` columns with seeded profile noise,
    two land columns and strong surface forcing (so the hmix loop runs a
    different number of passes in different columns)."""
    from mckpp_torch import forcing as forcing_mod
    from mckpp_torch.grid import coriolis
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=200.0),
        time=T.TimeConfig(dtsec=3600.0, ndtocn=1, startt=0.0, finalt=1.0),
        dtype="float64")
    model = T.KppModel(cfg, device="cpu")
    zm = model.grid.zm.numpy()
    rng = np.random.default_rng(seed)
    t0 = 20.0 + 8.0 * np.exp(zm / 40.0) + 0.5 * rng.standard_normal(
        (ncol, nz + 1))
    s0 = 35.0 - 0.4 * np.exp(zm / 60.0) + 0.05 * rng.standard_normal(
        (ncol, nz + 1))
    u0 = 0.2 * rng.standard_normal((ncol, nz + 1, 2))
    prm = init_params(ncol, nz + 1)
    lat = torch.linspace(-30.0, 30.0, ncol, dtype=torch.float64)
    wet = torch.ones(ncol, dtype=torch.bool)
    wet[[1, ncol - 2]] = False
    prm = prm.replace(f=coriolis(lat), dlat=lat, l_ocean=wet,
                      run_physics=wet)
    st, prm, frc = model.warm_start(u0, t0, s0, prm)
    raw = forcing_mod.constant_test_fluxes(ncol)
    raw = raw._replace(taux=torch.as_tensor(0.3 * rng.uniform(size=ncol)),
                       lhf=torch.as_tensor(-300.0 * rng.uniform(size=ncol)))
    st, frc = forcing_mod.update_fluxes(cfg, st, prm, frc, raw, True,
                                        model.grid.dm)
    return model, st, prm, frc


def run_steps(model, st, prm, frc, n):
    for nt in range(1, n + 1):
        st = model.step(st, prm, frc, first_step=nt == 1,
                        with_diags=nt == n)
    return st


@pytest.mark.parametrize("world", [2, 3])
def test_slab_steps_equal_whole_domain_steps(world):
    model, st, prm, frc = small_model(13)
    whole = run_steps(model, st, prm, frc, 3)
    for rank in range(world):
        lay = make_layout(13, world=world, rank=rank, device="cpu")
        s, p, f = (lay.shard_tree(t) for t in (st, prm, frc))
        assert not p.run_physics[max(13 - lay.lo, 0):].any()
        got = run_steps(model, s, p, f, 3)
        hi = min(lay.hi, 13)

        def same(a, b):
            assert torch.equal(a[:hi - lay.lo], b[lay.lo:hi])
        tree_map(same, got, whole)


# ---------------------------------------------------------------------------
# gloo collectives over two real processes
# ---------------------------------------------------------------------------

COLLECTIVES = r"""
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[3])
from mckpp_torch.parallel import distributed as d
from mckpp_torch.state import init_params
rank = int(sys.argv[2])
d.initialize(f"127.0.0.1:{sys.argv[1]}", 2, rank, device="cpu")
lay = d.make_layout(13)
assert lay.device == torch.device("cpu")       # the device initialize chose
assert (lay.lo, lay.hi, lay.ncol) == ((0, 7, 14) if rank == 0 else (7, 14, 14))
full = np.arange(13.0) * 1.5
slab = lay.global_array(full, local=False)
np.testing.assert_array_equal(lay.gather(slab), full)
g0 = lay.gather(slab, dst=0)
assert (g0 is None) == (rank == 1)
if rank == 0:
    np.testing.assert_array_equal(g0, full)
prm = lay.shard_tree(init_params(13, 3))
tree = lay.gather_tree(prm, dst=0)
if rank == 0:
    assert tree.l_ocean.dtype == torch.bool and tree.l_ocean.all()
    assert tuple(tree.u_init.shape) == (13, 3, 2)
else:
    assert tree is None
assert d.any_across_processes(rank == 1) is True
assert d.any_across_processes(False) is False
d.shutdown()
print("collectives ok", rank)
"""


def test_gloo_collectives_two_processes():
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", COLLECTIVES, port, str(r), ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"collectives ok {r}" in o, o[-3000:]


# ---------------------------------------------------------------------------
# the real CLI as two processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The SST-climatology end-to-end inputs (4 x 3 columns, one land
    point) and the one-process port run on them."""
    d = tmp_path_factory.mktemp("e2e")
    write_inputs(d, sst=True)
    out = d / "one"
    r = _cli(d, out, [])
    assert r.returncode == 0, r.stdout[-3000:]
    return d, out


def _cli_cmd(d, out, extra):
    return [sys.executable, "-m", "mckpp_torch.cli",
            "--namelist", str(d / "3D_ocn.nml"), "--data-dir", str(d),
            "--output-dir", str(out), "--steps", str(STEPS),
            "--device", "cpu", "--dtype", "float64", *extra]


def _env(**kw):
    env = dict(os.environ, **kw)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _cli(d, out, extra):
    return subprocess.run(_cli_cmd(d, out, extra), env=_env(), cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=RUN_TIMEOUT)


def _cli_ranks(d, out, extra, world=2):
    port = _free_port()
    procs = []
    for r in range(world):
        env = _env(KPP_COORDINATOR=f"127.0.0.1:{port}",
                   KPP_NUM_PROCS=str(world), KPP_PROC_ID=str(r))
        procs.append(subprocess.Popen(
            _cli_cmd(d, out, ["--distributed", *extra]), env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


def read_nc(path):
    with netcdf_file(str(path), "r", mmap=False) as nc:
        return ({k: np.array(v[:]) for k, v in nc.variables.items()},
                dict(nc._attributes))


def bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def assert_same_dir(a, b, pattern="*"):
    """Every .nc variable and every restart array of ``a`` equal to
    ``b``'s bit for bit."""
    names = sorted(os.path.basename(p) for p in glob.glob(f"{a}/{pattern}"))
    assert names and names == sorted(
        os.path.basename(p) for p in glob.glob(f"{b}/{pattern}"))
    for n in names:
        if n.endswith(".nc"):
            va, _ = read_nc(f"{a}/{n}")
            vb, _ = read_nc(f"{b}/{n}")
            assert sorted(va) == sorted(vb), n
            pairs = [(f"{n}:{k}", va[k], vb[k]) for k in va]
        else:
            with np.load(f"{a}/{n}") as za, np.load(f"{b}/{n}") as zb:
                assert sorted(za.files) == sorted(zb.files)
                pairs = [(f"{n}:{k}", za[k], zb[k]) for k in za.files]
        for what, x, y in pairs:
            assert x.dtype == y.dtype, what
            np.testing.assert_array_equal(bits(x), bits(y), err_msg=what)


def test_cli_two_processes_single_mode_equals_one(e2e, tmp_path):
    d, one = e2e
    logs = _cli_ranks(d, tmp_path, [])
    for r, log in enumerate(logs):
        assert f"rank {r} of 2" in log
        # the single writer gathered every emitted window
        assert "diag emit gathers: 0" not in log
    assert "NetCDF files written: 4 native, 0 scipy" in logs[0]
    assert "NetCDF files written: 0 native, 0 scipy" in logs[1]
    assert_same_dir(one, tmp_path)


def test_cli_torchrun_rendezvous_equals_one(e2e, tmp_path):
    """Two ranks started by torchrun (its MASTER_ADDR/MASTER_PORT/RANK/
    WORLD_SIZE/LOCAL_RANK, and its agent's store) write the one-process
    files."""
    d, one = e2e
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m",
           *_cli_cmd(d, tmp_path, ["--distributed"])[2:]]
    env = _env()
    for k in ("KPP_COORDINATOR", "KPP_NUM_PROCS", "KPP_PROC_ID"):
        env.pop(k, None)
    r = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=RUN_TIMEOUT)
    log = r.stdout + r.stderr
    assert r.returncode == 0, log[-4000:]
    for rank in range(2):
        assert f"rank {rank} of 2 (local rank {rank})" in log
    assert_same_dir(one, tmp_path)


def test_cli_two_processes_shard_mode_merges_to_one(e2e, tmp_path):
    d, one = e2e
    logs = _cli_ranks(d, tmp_path / "s", ["--output-mode", "shard"])
    for log in logs:
        assert "diag emit gathers: 0" in log, log[-2000:]
        assert "NetCDF files written: 4 native, 0 scipy" in log
    shards = sorted(p.name for p in (tmp_path / "s").glob("*_p[0-9].nc"))
    assert len(shards) == 8
    _, attrs = read_nc(tmp_path / "s" / "kpp_3h_mean_p1.nc")
    assert (int(attrs["shard_lo"]), int(attrs["shard_hi"]),
            int(attrs["shard_count"])) == (6, 12, 2)
    r = subprocess.run([sys.executable, "-m", "mckpp_torch.tools.merge_shards",
                        str(tmp_path / "s"), "--dest", str(tmp_path / "m")],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=RUN_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("merged 2 shards") == 4
    assert_same_dir(one, tmp_path / "m", "*.nc")
    # the restart is rank 0's, from the gathered state
    assert_same_dir(one, tmp_path / "s", "*.npz")


@pytest.mark.parametrize("restart", [False, True])
def test_build_under_layout_is_the_slab_of_the_whole_build(e2e, tmp_path,
                                                           restart):
    """setup.build with a layout (from the inputs, and resuming from the
    one-process run's npz restart, sliced on the host) equals the rank's
    slab of the whole-domain build; its readers read its rows only."""
    import shutil
    from mckpp_torch import setup as tsetup
    from mckpp_torch.utils import namelist as tnml
    d, one = e2e
    nml = d / "3D_ocn.nml"
    if restart:
        shutil.copy(glob.glob(f"{one}/restart_out_*.npz")[0],
                    tmp_path / "resume.npz")
        text = nml.read_text().replace(
            "L_RESTART=.F.", "L_RESTART=.T., restart_infile='resume.npz'")
        assert "resume.npz" in text
        nml = tmp_path / "3D_ocn.nml"
        nml.write_text(text)
        for f in os.listdir(d):
            if f.endswith(".nc"):
                os.symlink(d / f, tmp_path / f)
    data = nml.parent
    cfg, _ = tnml.load_config(str(nml))
    _, st, prm, frc, fl, _ = tsetup.build(cfg, str(data), device="cpu")
    for rank in range(2):
        lay = make_layout(12, world=2, rank=rank, device="cpu")
        _, s, p, f, fl_r, mgr = tsetup.build(cfg, str(data), device="cpu",
                                             layout=lay)
        assert mgr.layout is lay and fl_r.layout is lay
        for got, whole in ((s, st), (p, prm), (f, frc)):
            tree_map(lambda a, b: np.testing.assert_array_equal(
                a.numpy(), b[lay.lo:lay.hi].numpy()), got, whole)
        np.testing.assert_array_equal(fl_r(0.0).swf.numpy(),
                                      fl(0.0).swf[lay.lo:lay.hi].numpy())


def test_cli_multi_device_on_cpu_is_one_worker(e2e, tmp_path):
    """--multi-device on the CPU starts one worker (the CPU is one
    device), whose run equals the plain run."""
    d, one = e2e
    r = _cli(d, tmp_path, ["--multi-device"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "--multi-device: 1 worker process(es)" in r.stdout
    assert_same_dir(one, tmp_path)


# ---------------------------------------------------------------------------
# builds into one directory at once
# ---------------------------------------------------------------------------

FAKE_COMPILER = r"""#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    for i in range(50):
        f.write(b"%04d" % i * 256)
        f.flush()
        time.sleep(0.002)
"""
WHOLE = b"".join(b"%04d" % i * 256 for i in range(50))


def _fake_compiler(tmp_path):
    path = tmp_path / "fakecc"
    path.write_text(FAKE_COMPILER.format(python=sys.executable))
    path.chmod(0o755)
    return str(path)


def _concurrently(fn, n=4):
    errors = []

    def go():
        try:
            fn()
        except Exception as e:          # reported below
            errors.append(e)
    threads = [threading.Thread(target=go) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_concurrent_kernel_builds_leave_whole_libraries(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(ck, "_BUILD", str(tmp_path / "build"))
    cc = _fake_compiler(tmp_path)
    monkeypatch.setattr(ck, "_nvcc", lambda: cc)
    _concurrently(lambda: ck.build((torch.float32, torch.float64)))
    libs = [ck._lib_path(dt, ns) for dt in (torch.float32, torch.float64)
            for ns in ck.SLOTS]          # one a dtype and level-slot count
    for path in libs:
        with open(path, "rb") as f:
            assert f.read() == WHOLE
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(p) for p in libs)


def test_concurrent_encoder_builds_leave_a_whole_library(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", _fake_compiler(tmp_path))
    _concurrently(native.build)
    with open(native._lib_path(), "rb") as f:
        assert f.read() == WHOLE
    assert os.listdir(tmp_path / "build") == [
        os.path.basename(native._lib_path())]


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

NO_JAX = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mckpp_tpu"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import mckpp_torch
names = [m.name for m in pkgutil.walk_packages(mckpp_torch.__path__,
                                               "mckpp_torch.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mckpp_tpu")]
assert not bad, bad
need = {"mckpp_torch.native", "mckpp_torch.parallel.distributed",
        "mckpp_torch.parallel.sharding", "mckpp_torch.ensemble",
        "mckpp_torch.tools.merge_shards", "mckpp_torch.cli",
        "mckpp_torch.ops.tridiag", "mckpp_torch.ops.ocnint",
        "mckpp_torch.ops.ocnstep", "mckpp_torch.tools.make_benchmark_configs",
        "mckpp_torch.tools.run_baseline_benchmarks",
        "mckpp_torch.tools.bench_scaling", "mckpp_torch.tools.summarize_trace",
        "mckpp_torch.launch", "mckpp_torch.io.benchmark_inputs"}
assert need <= set(names), need - set(names)
# chip_smoke.py imports the port only, inside its functions: no line of
# it imports jax or the JAX package
import os, re
with open(os.path.join(sys.argv[1], "chip_smoke.py")) as f:
    src = f.read()
bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|jaxlib|mckpp_tpu)\b", src, re.M)
assert not bad, bad
import chip_smoke
print("imported", len(names))
"""


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", NO_JAX, ROOT],
                       capture_output=True, text=True, timeout=RUN_TIMEOUT,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "imported" in r.stdout
