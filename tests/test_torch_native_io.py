"""The port's C++ NetCDF encoder (``mckpp_torch/native``), the writer
routing of ``io/ncio.write_fields`` and the shard merge, against the JAX
package and against scipy's writer.

* the port's encoder writes files byte-identical to
  ``mckpp_tpu.native.write_fields_native`` for the same float32 and
  float64 payloads, and their values equal the port's scipy writer's
  (``MCKPP_NO_NATIVE=1``); ``ncio.WRITES`` counts each writer;
* payloads the encoder cannot express (an unlimited record dimension, an
  array-valued attribute) go to scipy;
* a failed build (a compiler that is not there, a flag it refuses) raises
  with the compiler's words, and nothing falls back;
* shard files written by two ranks' diagnostics merge, through the
  port's ``merge_shard_files`` and the JAX package's, into equal
  variables and attributes, equal to the one-process file.
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mckpp_tpu import native as jnative
from mckpp_tpu.io import diagnostics as jdiag

from mckpp_torch import native
from mckpp_torch.io import diagnostics as tdiag
from mckpp_torch.io import ncio
from mckpp_torch.parallel.distributed import ColumnLayout
from mckpp_torch.state import init_forcing, init_params, init_state


def payload(dtype, seed=0):
    rng = np.random.default_rng(seed)
    dims = {"time": 3, "z": 4, "y": 2, "x": 5}
    coords = {"time": ("time", [0.25, 0.5, 0.75]),
              "z": ("z", np.linspace(-1.0, -30.0, 4).astype(dtype))}
    fields = {"T": (("time", "z", "y", "x"),
                    rng.standard_normal((3, 4, 2, 5)).astype(dtype)),
              "hmix": (("time", "y", "x"),
                       rng.uniform(0, 100, (3, 2, 5)).astype(dtype))}
    attrs = {"reduction": b"average", "fill_value": 1.0e20, "shard_lo": 4}
    var_attrs = {"time": {"units": "days since 0000-01-02 00:00:00"},
                 "T": {"_FillValue": 1.0e20, "level": np.int32(3)}}
    return dims, coords, fields, attrs, var_attrs


def read(path, attr_types=False):
    """(variables, file attributes, variable attributes) of a file; with
    ``attr_types`` each attribute reads as (value, type code), e.g. "f8"."""
    conv = ((lambda b: (np.asarray(b).tolist(), np.asarray(b).dtype.str[1:]))
            if attr_types else (lambda b: np.asarray(b).tolist()))
    with netcdf_file(str(path), "r", mmap=False) as nc:
        return ({k: np.array(v[:]) for k, v in nc.variables.items()},
                {k: conv(v) for k, v in nc._attributes.items()},
                {k: {a: conv(b) for a, b in v._attributes.items()}
                 for k, v in nc.variables.items()})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_bytes_match_jax(dtype, tmp_path, monkeypatch):
    monkeypatch.setenv("MCKPP_NATIVE_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.delenv("MCKPP_NO_NATIVE", raising=False)
    dims, coords, fields, attrs, var_attrs = payload(dtype)
    w0 = dict(ncio.WRITES)
    ncio.write_fields(str(tmp_path / "t.nc"), dims, coords, fields, attrs,
                      var_attrs)
    assert ncio.WRITES["native"] == w0["native"] + 1
    assert ncio.WRITES["scipy"] == w0["scipy"]
    assert jnative.write_fields_native(str(tmp_path / "j.nc"), dims, coords,
                                       fields, attrs, var_attrs)
    got = (tmp_path / "t.nc").read_bytes()
    assert got[:4] == b"CDF\x02"
    assert got == (tmp_path / "j.nc").read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_values_equal_scipy(dtype, tmp_path, monkeypatch):
    args = payload(dtype, seed=1)
    monkeypatch.delenv("MCKPP_NO_NATIVE", raising=False)
    ncio.write_fields(str(tmp_path / "n.nc"), *args)
    monkeypatch.setenv("MCKPP_NO_NATIVE", "1")
    w0 = dict(ncio.WRITES)
    ncio.write_fields(str(tmp_path / "s.nc"), *args)
    assert ncio.WRITES["scipy"] == w0["scipy"] + 1
    assert ncio.WRITES["native"] == w0["native"]
    # one file format for both writers: the coordinates and fields in the
    # payload's precision, every numeric attribute a double
    nv, na, nva = read(tmp_path / "n.nc", attr_types=True)
    sv, sa, sva = read(tmp_path / "s.nc", attr_types=True)
    assert sorted(nv) == sorted(sv)
    for k in nv:
        assert nv[k].dtype == sv[k].dtype, k
        np.testing.assert_array_equal(nv[k], sv[k], err_msg=k)
    assert na == sa and nva == sva
    for k in ("T", "z"):
        assert nv[k].dtype.itemsize == np.dtype(dtype).itemsize, k
    assert nv["time"].dtype.itemsize == 8
    assert sa["shard_lo"] == (4.0, "f8")
    assert sva["T"]["level"] == (3.0, "f8")


def test_inexpressible_payloads_go_to_scipy(tmp_path, monkeypatch):
    monkeypatch.delenv("MCKPP_NO_NATIVE", raising=False)
    dims, coords, fields, attrs, var_attrs = payload(np.float64)
    assert native.expressible(dims, coords, fields, attrs, var_attrs)
    for i, (d, a) in enumerate((
            (dict(dims, time=None), attrs),                 # record dim
            (dims, dict(attrs, valid_range=np.array([0.0, 1.0]))))):
        assert not native.expressible(d, coords, fields, a, var_attrs)
        w0 = dict(ncio.WRITES)
        path = tmp_path / f"x{i}.nc"
        ncio.write_fields(str(path), d, coords, fields, a, var_attrs)
        assert ncio.WRITES["scipy"] == w0["scipy"] + 1
        v, _, _ = read(path)
        np.testing.assert_array_equal(v["T"], fields["T"][1])


@pytest.mark.parametrize("how", ["missing_compiler", "refused_flag"])
def test_failed_build_raises(how, tmp_path, monkeypatch):
    monkeypatch.delenv("MCKPP_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    if how == "missing_compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        match = "no-such-g\\+\\+"
    else:
        monkeypatch.setattr(native, "CXX_FLAGS",
                            native.CXX_FLAGS + ["-fno-such-flag-at-all"])
        match = "no-such-flag-at-all"
    with pytest.raises(RuntimeError, match=match):
        ncio.write_fields(str(tmp_path / "x.nc"), *payload(np.float32))
    assert not (tmp_path / "x.nc").exists()
    assert not os.listdir(tmp_path / "build")      # no temp file left


# ---------------------------------------------------------------------------
# shard files and their merge
# ---------------------------------------------------------------------------

NX, NY, NZ = 5, 3, 4           # 15 columns: two ranks of 8, one padding


def _state(seed, ncol):
    rng = np.random.default_rng(seed)
    st = init_state(ncol, NZ + 1)
    st = st.replace(x=torch.as_tensor(rng.standard_normal((ncol, NZ + 1, 2))),
                    hmix=torch.as_tensor(rng.uniform(0, 50, ncol)),
                    difm=torch.as_tensor(rng.uniform(0, 1, (ncol, NZ + 2))))
    return st, init_params(ncol, NZ + 1), init_forcing(ncol, NZ + 1)


def _streams(mod):
    return [mod.Stream("inst", "instant", 2, fields=("T", "hmix")),
            mod.Stream("mean", "average", 3, fields=("T", "difm", "hmix"),
                       split_freq_days=0.25)]


def test_merge_matches_jax_and_single_writer(tmp_path):
    zm = np.linspace(-1.0, -40.0, NZ + 1)
    l_ocean = np.ones(NX * NY, bool)
    l_ocean[[2, 9]] = False
    kw = dict(nx=NX, ny=NY, zm=zm, start_time_days=1.0, dto_seconds=3600.0,
              l_ocean=l_ocean, lons=np.arange(NX) + 100.0,
              lats=np.arange(NY) - 5.0)
    single = tdiag.DiagnosticsManager(_streams(tdiag),
                                      outdir=str(tmp_path / "one"), **kw)
    ranks = []
    for r in range(2):
        m = tdiag.DiagnosticsManager(_streams(tdiag),
                                     outdir=str(tmp_path / "shards"),
                                     write_mode="shard", **kw)
        m.set_layout(ColumnLayout(ncol=16, ncol_unpadded=15, rank=r,
                                  world=2, device="cpu"))
        ranks.append(m)
    for nt in range(1, 13):
        st, prm, frc = _state(nt, 15)
        single.step(nt, st, prm, frc)
        for m in ranks:
            lay = m.layout
            m.step(nt, *(lay.shard_tree(t) for t in (st, prm, frc)))
    one = single.flush()
    for m in ranks:
        m.flush()
        assert m.emit_gathers == 0
    assert len(one) == 3                    # inst + two quarter-day splits
    for key, path in one.items():
        base = os.path.basename(path)[:-3]
        shards = [str(tmp_path / "shards" / f"{base}_p{r}.nc")
                  for r in range(2)]
        t_out = tdiag.merge_shard_files(shards, str(tmp_path / f"t_{base}.nc"))
        j_out = jdiag.merge_shard_files(shards, str(tmp_path / f"j_{base}.nc"))
        tv, ta, tva = read(t_out)
        jv, ja, jva = read(j_out)
        ov, oa, ova = read(path)
        assert sorted(tv) == sorted(jv) == sorted(ov), key
        for k in ov:
            np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
            np.testing.assert_array_equal(tv[k], ov[k], err_msg=k)
            assert tv[k].dtype == ov[k].dtype
        assert ta == ja == oa and tva == jva == ova, key
        # the merge writes the single writer's bytes
        assert open(t_out, "rb").read() == open(path, "rb").read()
