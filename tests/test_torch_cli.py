"""The port's CLI (``python -m mckpp_torch.cli``) on the end-to-end inputs
of tests/test_endtoend.py (4 x 3 columns, 10 levels, one land point):
plain, then with the SST climatology, relaxation and advection.

Tier-1 runs the port alone on the CPU in float64: rc 0, the streams and
the restart written, land at the fill value; the chained run equal to
the per-step loop (``MCKPP_CHAIN=0``) bit for bit; ``setup.build`` (the
loaders, the initial mixing pass, the initial ancillary reads) against
mckpp_tpu's at rtol 1e-12; the options that raise.  The comparison of
whole runs with ``mckpp_tpu.cli`` (every variable of every stream file
and the restart at rtol 1e-9, integers equal) is marked slow: the JAX
CLI compiles its step for about two minutes on the CPU, once per input
set.
Float tolerances are scale-aware (:func:`close`).
"""

import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mckpp_tpu import setup as jsetup
from mckpp_tpu.utils import namelist as jnml

from mckpp_torch import cli
from mckpp_torch import convert
from mckpp_torch import setup as tsetup
from mckpp_torch.io.diagnostics import FILL_VALUE
from mckpp_torch.utils import namelist as tnml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_endtoend import NX, NY, NZ, write_inputs  # noqa: E402

STEPS = 9
VARIANTS = {"plain": {}, "sst_advect": dict(sst=True, advect=True)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def inputs(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    write_inputs(d, **VARIANTS[request.param])
    return d


def port_cli(d, out, *extra, chain=True, monkeypatch=None):
    argv = ["--namelist", str(d / "3D_ocn.nml"), "--data-dir", str(d),
            "--output-dir", str(out), "--steps", str(STEPS),
            "--device", "cpu", "--dtype", "float64", *extra]
    if monkeypatch is not None:
        monkeypatch.setenv("MCKPP_CHAIN", "1" if chain else "0")
    return cli.main(argv)


def read_dir(path):
    """{file: {variable: array}} and the restart npz of an output dir."""
    files = {}
    for p in sorted(glob.glob(os.path.join(path, "*.nc"))):
        with netcdf_file(p, "r", mmap=False) as nc:
            files[os.path.basename(p)] = {
                k: np.asarray(v[:]).copy() for k, v in nc.variables.items()}
    npz = sorted(glob.glob(os.path.join(path, "restart_out_*.npz")))
    with np.load(npz[-1]) as z:
        restart = {k: z[k] for k in z.files}
    return files, restart, os.path.basename(npz[-1])


def test_port_cli_runs(inputs, tmp_path, monkeypatch):
    out = tmp_path / "out"
    assert port_cli(inputs, out, monkeypatch=monkeypatch) == 0
    files, restart, name = read_dir(str(out))
    assert sorted(files) == ["kpp_1h_inst.nc", "kpp_3h_max.nc",
                             "kpp_3h_mean.nc", "kpp_3h_min.nc"]
    t = files["kpp_1h_inst.nc"]["T"]
    assert t.shape == (3, NZ + 1, NY, NX)            # 9 steps, every 3
    assert np.all(t[:, :, 0, 0] == FILL_VALUE)       # the land point
    assert np.isfinite(t).all() and (t[:, :, 1:, :] < 40.0).all()
    assert restart["meta_ntime"] == STEPS
    assert name == "restart_out_000000.12500.npz"


@pytest.mark.parametrize("chain", [True, False], ids=["chain", "per_step"])
def test_port_cli_runs_no_steps(tmp_path, monkeypatch, capsys, chain):
    """A run whose end is its start (0 steps) returns its summary, with no
    step glue share to print."""
    d = tmp_path / "in"
    d.mkdir()
    write_inputs(d)
    nml = d / "3D_ocn.nml"
    nml.write_text(nml.read_text().replace("finalt=0.25", "finalt=0.0"))
    monkeypatch.setenv("MCKPP_CHAIN", "1" if chain else "0")
    summary = cli.run(["--namelist", str(nml), "--data-dir", str(d),
                       "--output-dir", str(tmp_path / "out"), "--device",
                       "cpu", "--dtype", "float64"])
    assert summary["num_steps"] == 0 and summary["restarts"] == []
    assert not any(summary["launches"].values())
    assert "step glue in kernels" not in capsys.readouterr().out


def test_port_cli_profile_writes_trace(inputs, tmp_path, monkeypatch):
    prof = tmp_path / "prof"
    assert port_cli(inputs, tmp_path / "out", "--profile", str(prof),
                    "--profile-steps", "2", monkeypatch=monkeypatch) == 0
    assert (prof / "trace.json").stat().st_size > 0


def test_port_cli_chain_equals_per_step(inputs, tmp_path, monkeypatch):
    port_cli(inputs, tmp_path / "chain", monkeypatch=monkeypatch)
    port_cli(inputs, tmp_path / "step", chain=False, monkeypatch=monkeypatch)
    a_files, a_rs, _ = read_dir(str(tmp_path / "chain"))
    b_files, b_rs, _ = read_dir(str(tmp_path / "step"))
    assert sorted(a_files) == sorted(b_files)
    for fn in a_files:
        for k in a_files[fn]:
            np.testing.assert_array_equal(a_files[fn][k], b_files[fn][k],
                                          err_msg=f"{fn}:{k}")
    for k in a_rs:
        np.testing.assert_array_equal(a_rs[k], b_rs[k], err_msg=k)


def close(got, ref, name, rtol):
    """Integers equal; floats to ``rtol``, scale-aware: the absolute floor
    is rtol times the field's largest magnitude (fill values aside), since
    fields such as S - Sref cross zero and diffusivities sit far below
    O(1)."""
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    scale = float(np.abs(ref[ref != FILL_VALUE]).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * scale + 1e-300, err_msg=name)


def test_build_matches_jax(inputs):
    """setup.build: the files read, the initial mixing pass and the
    initial ancillary reads, against the JAX package's."""
    jcfg, _ = jnml.load_config(str(inputs / "3D_ocn.nml"))
    tcfg, _ = tnml.load_config(str(inputs / "3D_ocn.nml"))
    jm, jst, jprm, jfrc, jflux, _ = jsetup.build(jcfg, str(inputs))
    tm, tst, tprm, tfrc, tflux, _ = tsetup.build(tcfg, str(inputs),
                                                 device="cpu")
    assert tm.pass_impl == "eager_step" and tm.dtype == torch.float64
    np.testing.assert_array_equal(tm.grid.zm.numpy(), np.asarray(jm.grid.zm))
    for prefix, got, ref in (("st_", tst, jst), ("pr_", tprm, jprm),
                             ("fr_", tfrc, jfrc)):
        g = convert.to_numpy(got)
        r = {f.name: np.asarray(getattr(ref, f.name))
             for f in dataclasses.fields(ref)}
        assert set(g) == set(r)
        for k in r:
            close(g[k], r[k], prefix + k, 1e-12)
    for day in (0.0, 0.125):
        got, ref = tflux(day), jflux(day)
        for k in ref._fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)))


def test_cli_options_that_raise(tmp_path, monkeypatch):
    """What still raises: both process flags at once, a process count
    without a coordinator, and the card when there is none.  (The flags
    themselves run: tests/test_torch_distributed.py.)"""
    d = tmp_path
    with pytest.raises(ValueError, match="pass one of the two"):
        port_cli(d, d / "out", "--multi-device", "--distributed")
    monkeypatch.setenv("KPP_NUM_PROCS", "2")
    monkeypatch.delenv("KPP_COORDINATOR", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="KPP_COORDINATOR"):
        port_cli(d, d / "out", "--distributed")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--namelist", str(d / "none.nml")])


# ---------------------------------------------------------------------------
# whole runs against mckpp_tpu.cli
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(inputs, tmp_path_factory):
    """mckpp_tpu.cli on the same inputs, once per input set."""
    from mckpp_tpu import cli as jcli
    out = tmp_path_factory.mktemp("jax_out")
    rc = jcli.main(["--namelist", str(inputs / "3D_ocn.nml"),
                    "--data-dir", str(inputs), "--output-dir", str(out),
                    "--steps", str(STEPS)])
    assert rc == 0
    return read_dir(str(out))


@pytest.mark.slow
def test_cli_matches_jax(inputs, jax_run, tmp_path, monkeypatch):
    out = tmp_path / "out"
    assert port_cli(inputs, out, monkeypatch=monkeypatch) == 0
    files, restart, name = read_dir(str(out))
    j_files, j_restart, j_name = jax_run
    assert sorted(files) == sorted(j_files) and name == j_name
    for fn in j_files:
        assert sorted(files[fn]) == sorted(j_files[fn]), fn
        for k, ref in j_files[fn].items():
            close(files[fn][k], ref, f"{fn}:{k}", 1e-9)
    assert sorted(restart) == sorted(j_restart)
    for k, ref in j_restart.items():
        assert restart[k].dtype == ref.dtype, k
        close(restart[k], ref, k, 1e-9)
