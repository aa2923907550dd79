"""The five BASELINE.json input sets written by the port
(``mckpp_torch.io.benchmark_inputs``, ``python -m
mckpp_torch.tools.make_benchmark_configs``) against
``tools/make_benchmark_configs.py``, at the tool's ``--toy`` size.

Every set: the same files, each with the same dimensions, attributes and
variables bit for bit, and the same namelist and iodef texts.  Then the
model the port builds from them (``setup.build``: the files read, the
initial mixing pass, the initial ancillary reads) against the JAX
package's at rtol 1e-12, as tests/test_torch_cli.py holds it, on
single_column (nz = 100) and ensemble10_dd (double diffusion); the same
on the other three sets, and whole CLI runs against ``mckpp_tpu.cli`` on
the four CLI sets, are marked slow (the JAX package sets up and compiles
for tens of seconds to minutes an input set on the CPU).

One place is held differently: the still, homogeneous interfaces.  Below
the deepest level of ``init.nc`` the initial T and S are constant and the
currents zero, so the buoyancy jump ``dbloc`` and the shear ``shsq`` are
0 and the gradient Richardson number ``dbloc * dz / (shsq + 1e-16)`` is
0 / 1e-16.  In the initial state the port computes ``dbloc = 0`` there,
so Ri = 0 and the shear-instability mixing is at its maximum
(``DIFS0``); the JAX package's compiled CPU code leaves a rounding
residual of ~1e-17 between two equal buoyancies, which the 1e-16 turns
into Ri of order 1, above ``RIINFTY``: background mixing only.  Once the
columns step, both packages' jumps and shears there are rounding
residuals (~1e-17 and less), and the Ri each computes from them, with the
interior diffusivities that follow it, is their ratio.  So at the
interfaces where the reference's jump and shear are both below 1e-15
(:func:`still`), those fields are held to "still in the port too" (its
jump and shear below 1e-15; in the initial state its jump exactly 0);
everything else, T, S and the currents everywhere included, to the rtol
of the comparison (:func:`close_still`).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mckpp_tpu import setup as jsetup
from mckpp_tpu.utils import namelist as jnml

from mckpp_torch import cli, convert
from mckpp_torch import setup as tsetup
from mckpp_torch.io import benchmark_inputs
from mckpp_torch.utils import namelist as tnml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cli import close  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = benchmark_inputs.CONFIGS
CLI_STEPS = 9


def jax_tool():
    """tools/make_benchmark_configs.py (imports mckpp_tpu.io.ncio)."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_benchmark_configs",
        os.path.join(ROOT, "tools", "make_benchmark_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def toy_sets(tmp_path_factory):
    """{config: (port dir, tool dir)}, each set written once by each."""
    tool = jax_tool()
    root = tmp_path_factory.mktemp("toy_sets")
    out = {}
    for config in CONFIGS:
        p, j = root / f"port_{config}", root / f"tool_{config}"
        benchmark_inputs.generate(config, str(p), toy=True)
        tool.generate(config, str(j), toy=True)
        out[config] = (p, j)
    return out


# fields whose value at an interface follows Ri there (the interior
# diffusivities, the Richardson number and the buoyancy jump)
RI_FIELDS = ("difm", "difs", "dift", "rig", "dbloc")


STILL = 1e-15     # a buoyancy jump (m/s2) or shear (1/s2) below: rounding


def still(dbloc, shsq, width):
    """The reference's still, homogeneous interfaces (buoyancy jump and
    shear both below STILL: rounding residuals), padded or cut to
    ``width`` along the last axis; interface 0 (the surface) never."""
    m = ((np.abs(np.asarray(shsq)) < STILL)
         & (np.abs(np.asarray(dbloc)) < STILL))
    m[..., 0] = False
    pad = width - m.shape[-1]
    if pad > 0:
        m = np.concatenate([m, np.zeros(m.shape[:-1] + (pad,), bool)], -1)
    return m[..., :width]


def close_still(got, ref, name, rtol, mask):
    """:func:`close` away from the still interfaces ``mask``; there the
    port's buoyancy jump is a rounding residual too (and Ri, the
    diffusivities follow the ratio of two residuals: not compared)."""
    close(got[~mask], ref[~mask], name, rtol)
    if name.endswith("dbloc"):
        assert (np.abs(got[mask]) < STILL).all(), name


def read_out(path):
    """{file: {variable: array}} of an output directory's .nc files, and
    {file: {key: array}} of its npz restarts (none before the run's
    last step when --steps cuts it short)."""
    files, restarts = {}, {}
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if name.endswith(".nc"):
            with netcdf_file(p, "r", mmap=False) as nc:
                files[name] = {k: np.array(v[:])
                               for k, v in nc.variables.items()}
        elif name.endswith(".npz"):
            with np.load(p) as z:
                restarts[name] = {k: z[k] for k in z.files}
    return files, restarts


def nc_contents(path):
    with netcdf_file(str(path), "r", mmap=False) as nc:
        return (dict(nc.dimensions), dict(nc._attributes),
                {k: (v.dimensions, dict(v._attributes), v.data.dtype.str,
                     np.array(v[:]).tobytes())
                 for k, v in nc.variables.items()})


@pytest.mark.parametrize("config", CONFIGS)
def test_inputs_equal_the_tool(toy_sets, config):
    port, tool = toy_sets[config]
    names = sorted(os.listdir(tool))
    assert sorted(os.listdir(port)) == names
    assert {"3D_ocn.nml", "iodef.xml", "lsm.nc", "vgrid.nc", "init.nc",
            "paras.nc"} <= set(names)
    for name in names:
        if name.endswith(".nc"):
            assert nc_contents(port / name) == nc_contents(tool / name), name
        else:
            assert (port / name).read_text() == (tool / name).read_text()


def test_make_benchmark_configs_entry(tmp_path):
    """``python -m mckpp_torch.tools.make_benchmark_configs`` writes the
    set and names its grid."""
    r = subprocess.run([sys.executable, "-m",
                        "mckpp_torch.tools.make_benchmark_configs",
                        "single_column", str(tmp_path / "sc"), "--toy"],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "1 x 1 x 100" in r.stdout
    assert (tmp_path / "sc" / "3D_ocn.nml").exists()
    with pytest.raises(ValueError, match="unknown config"):
        benchmark_inputs.generate("nope", str(tmp_path / "x"))


SLOW = pytest.mark.slow


@pytest.mark.parametrize("config", [
    "single_column", "ensemble10_dd",
    pytest.param("regional_64x64", marks=SLOW),
    pytest.param("terramaris", marks=SLOW),
    pytest.param("global_1deg", marks=SLOW)])
def test_build_matches_jax(toy_sets, config):
    """setup.build of the port (float64, CPU) against the JAX package's on
    the same toy set: every state, parameter and forcing field at rtol
    1e-12, and the first flux records equal."""
    d = toy_sets[config][0]
    jcfg, _ = jnml.load_config(str(d / "3D_ocn.nml"))
    tcfg, _ = tnml.load_config(str(d / "3D_ocn.nml"))
    assert tcfg.domain.nz == jcfg.domain.nz
    assert tcfg.physics.ldd == jcfg.physics.ldd == (config == "ensemble10_dd")
    jm, jst, jprm, jfrc, jflux, _ = jsetup.build(jcfg, str(d))
    tm, tst, tprm, tfrc, tflux, _ = tsetup.build(tcfg, str(d), device="cpu")
    assert tm.dtype == torch.float64
    np.testing.assert_array_equal(tm.grid.zm.numpy(), np.asarray(jm.grid.zm))
    for prefix, got, ref in (("st_", tst, jst), ("pr_", tprm, jprm),
                             ("fr_", tfrc, jfrc)):
        g = convert.to_numpy(got)
        r = {f.name: np.asarray(getattr(ref, f.name))
             for f in dataclasses.fields(ref)}
        assert set(g) == set(r)
        for k in r:
            if prefix == "st_" and k in RI_FIELDS:
                mask = still(r["dbloc"], r["shsq"], r[k].shape[-1])
                close_still(g[k], r[k], prefix + k, 1e-12, mask)
                if k == "dbloc":      # the initial T and S are constant
                    assert (g[k][mask] == 0.0).all() and mask.any()
            else:
                close(g[k], r[k], prefix + k, 1e-12)
    assert (tflux is None) == (jflux is None) == (config == "single_column")
    if tflux is not None:
        for day in (0.0, 0.125):
            got, ref = tflux(day), jflux(day)
            for k in ref._fields:
                np.testing.assert_array_equal(getattr(got, k).numpy(),
                                              np.asarray(getattr(ref, k)))


@pytest.mark.slow
@pytest.mark.parametrize("config", ["single_column", "regional_64x64",
                                    "terramaris", "global_1deg"])
def test_cli_matches_jax(toy_sets, tmp_path, config):
    """Whole CLI runs (9 steps, float64, CPU) on a toy set: every variable
    of every stream file and the restart at rtol 1e-9 of each field's
    scale, integers equal."""
    from mckpp_tpu import cli as jcli
    d = toy_sets[config][0]
    argv = ["--namelist", str(d / "3D_ocn.nml"), "--data-dir", str(d),
            "--steps", str(CLI_STEPS)]
    assert jcli.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    assert cli.main(argv + ["--output-dir", str(tmp_path / "t"),
                            "--device", "cpu", "--dtype", "float64"]) == 0
    files, restarts = read_out(str(tmp_path / "t"))
    j_files, j_restarts = read_out(str(tmp_path / "j"))
    assert sorted(files) == sorted(j_files) and len(files) == 5
    assert sorted(restarts) == sorted(j_restarts)
    for fn in j_files:
        assert sorted(files[fn]) == sorted(j_files[fn]), fn
        jf = j_files[fn]
        for k, ref in jf.items():
            if k in ("difm", "difs", "dift", "Rig", "dbloc"):
                # (time, z, y, x) outputs: interfaces on the z axis
                m = np.moveaxis(still(np.moveaxis(jf["dbloc"], 1, -1),
                                      np.moveaxis(jf["Shsq"], 1, -1),
                                      ref.shape[1]), -1, 1)
                close_still(files[fn][k], ref, f"{fn}:{k}", 1e-9, m)
            else:
                close(files[fn][k], ref, f"{fn}:{k}", 1e-9)
    for rn, j_restart in j_restarts.items():
        restart = restarts[rn]
        assert sorted(restart) == sorted(j_restart)
        mask = still(j_restart["st_dbloc"], j_restart["st_shsq"],
                     j_restart["st_difs"].shape[-1])
        for k, ref in j_restart.items():
            assert restart[k].dtype == ref.dtype, k
            if k[3:] in RI_FIELDS:
                close_still(restart[k], ref, k, 1e-9,
                            mask[..., :ref.shape[-1]])
            else:
                close(restart[k], ref, k, 1e-9)
