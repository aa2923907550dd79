"""The port's NetCDF reader (``mckpp_torch.io.ncio``) at scale: the tests
of tests/test_ncio_scale.py through the port's ``ncio`` and its
``AncillaryReader``, on the same files with the same counts: hyperslab
reads touch O(record) bytes (``READ_BYTES``), a row-slab read touches
only its rows, and netCDF4/HDF5 inputs (the format real MC-KPP inputs
use) open through the h5py backend, dimension scales and nested groups
included.  Then the ``start``/``count`` form of ``get_var`` against the
JAX package's."""

import numpy as np

from mckpp_tpu.io import ncio as jncio

from mckpp_torch.io import ncio
from mckpp_torch.io.ancillaries import AncillaryReader


def test_record_read_is_o_record(tmp_path):
    """Reading one record of a many-record 3-D climatology materializes
    ~one record's bytes, not the whole variable
    (reference hyperslab reads: mckpp_netcdf_read.F90:120-432)."""
    nt, nz, ny, nx = 120, 16, 24, 36
    path = str(tmp_path / "clim.nc")
    data = np.arange(nt * nz * ny * nx, dtype=np.float64).reshape(
        nt, nz, ny, nx)
    ncio.write_fields(
        path,
        {"t": nt, "z": nz, "latitude": ny, "longitude": nx},
        {"t": ("t", np.arange(nt, dtype=float)),
         "z": ("z", np.arange(nz, dtype=float)),
         "latitude": ("latitude", np.arange(ny, dtype=float)),
         "longitude": ("longitude", np.arange(nx, dtype=float))},
        {"temperature": (("t", "z", "latitude", "longitude"), data)})

    record_bytes = nz * ny * nx * 8
    with ncio.open_nc(path) as nc:
        before = ncio.READ_BYTES
        rec = ncio.get_var(nc, "temperature",
                           index=(7, slice(None), slice(None), slice(None)))
        touched = ncio.READ_BYTES - before
    np.testing.assert_array_equal(rec, data[7])
    assert touched == record_bytes, (touched, record_bytes)
    # far below whole-variable materialization
    assert touched * 100 <= data.nbytes

    # the ancillary reader path (3-D read at one time index) stays
    # O(record) too
    rd = AncillaryReader(path, 0.0, 0.0, nx, ny)
    before = ncio.READ_BYTES
    slab = rd.read3d("temperature", 7, nz)
    touched = ncio.READ_BYTES - before
    assert slab.shape == (ny * nx, nz)
    assert touched <= 2 * record_bytes, (touched, record_bytes)


def test_row_slab_read_touches_only_covering_rows(tmp_path):
    """Host-local reads of a row range fetch only the covering y rows."""
    nt, ny, nx = 50, 64, 32
    path = str(tmp_path / "sst.nc")
    data = np.arange(nt * ny * nx, dtype=np.float64).reshape(nt, ny, nx)
    ncio.write_fields(
        path,
        {"t": nt, "latitude": ny, "longitude": nx},
        {"t": ("t", np.arange(nt, dtype=float)),
         "latitude": ("latitude", np.arange(ny, dtype=float)),
         "longitude": ("longitude", np.arange(nx, dtype=float))},
        {"sst": (("t", "latitude", "longitude"), data)})
    rd = AncillaryReader(path, 0.0, 0.0, nx, ny)
    rd.times()                        # initialize outside the measurement
    lo, hi = 100, 612                 # rows 3..20 cover this flat range
    before = ncio.READ_BYTES
    slab = rd.read2d("sst", 11, rows=(lo, hi))
    touched = ncio.READ_BYTES - before
    np.testing.assert_array_equal(slab, data[11].reshape(-1)[lo:hi])
    covering = (19 - 3 + 1) * nx * 8
    assert touched == covering, (touched, covering)
    assert touched < data[11].nbytes


def test_hdf5_backend_roundtrip(tmp_path):
    """netCDF4-style HDF5 files open transparently (magic-sniffed h5py
    backend) with lazy hyperslab reads."""
    import h5py

    nt, ny, nx = 12, 6, 8
    path = str(tmp_path / "anc.h5")
    data = np.arange(nt * ny * nx, dtype=np.float64).reshape(nt, ny, nx)
    with h5py.File(path, "w") as f:
        f.create_dataset("sst", data=data)
        f.create_dataset("t", data=np.arange(nt, dtype=float))
        f.create_dataset("latitude", data=np.arange(ny, dtype=float))
        f.create_dataset("longitude", data=np.arange(nx, dtype=float) + 10.0)

    with ncio.open_nc(path) as nc:
        t, n = ncio.get_coord(nc, "t")
        assert n == nt
        rec = ncio.get_var(nc, "sst", index=(5, slice(None), slice(None)))
        np.testing.assert_array_equal(rec, data[5])
        olon, olat = ncio.determine_boundaries(nc, 12.0, 3.0)
        assert (olon, olat) == (2, 3)

    # the full ancillary reader works on HDF5 input
    rd = AncillaryReader(path, 10.0, 0.0, nx, ny, time_name="t")
    slab = rd.read2d("sst", 5)
    np.testing.assert_array_equal(slab, data[5].reshape(-1))


def test_hdf5_dimension_scales_roundtrip(tmp_path):
    """A netCDF4-convention HDF5 file written with h5py — coordinate
    variables as DIMENSION_SCALEs attached to the data variables, plus a
    _NCProperties marker — round-trips through the backend: coordinate /
    variable discovery must not depend on the datasets being plain
    (VERDICT r3 item 8; reference inputs are netCDF4, README.md:14)."""
    import h5py

    nt, ny, nx = 10, 5, 7
    path = str(tmp_path / "nc4_style.nc")
    data = np.arange(nt * ny * nx, dtype=np.float64).reshape(nt, ny, nx)
    with h5py.File(path, "w") as f:
        f.attrs["_NCProperties"] = np.bytes_("version=2,h5py")
        tv = f.create_dataset("time", data=np.arange(nt, dtype=float) * 5.0)
        la = f.create_dataset("latitude", data=np.arange(ny, dtype=float))
        lo = f.create_dataset("longitude",
                              data=np.arange(nx, dtype=float) + 100.0)
        for ds, nm in ((tv, "time"), (la, "latitude"), (lo, "longitude")):
            ds.make_scale(nm)
        v = f.create_dataset("sst", data=data)
        v.dims[0].attach_scale(tv)
        v.dims[1].attach_scale(la)
        v.dims[2].attach_scale(lo)
        v.attrs["units"] = np.bytes_("K")

    with ncio.open_nc(path) as nc:
        t, n = ncio.get_coord(nc, "time")
        assert n == nt and t[3] == 15.0
        np.testing.assert_array_equal(ncio.get_time_axis(nc), t)
        rec = ncio.get_var(nc, "sst", index=(4, slice(None), slice(None)))
        np.testing.assert_array_equal(rec, data[4])
        olon, olat = ncio.determine_boundaries(nc, 102.0, 3.0)
        assert (olon, olat) == (2, 3)

    rd = AncillaryReader(path, 100.0, 0.0, nx, ny)
    slab = rd.read2d("sst", 4)
    np.testing.assert_array_equal(slab, data[4].reshape(-1))
    np.testing.assert_array_equal(rd.times(), np.arange(nt) * 5.0)


def test_hdf5_group_nested_duplicate_does_not_shadow_root(tmp_path):
    """Group-nested datasets with the same trailing name must not shadow
    root-level variables (netCDF4 allows groups; classic-model inputs keep
    variables at the root)."""
    import h5py

    path = str(tmp_path / "grouped.nc")
    with h5py.File(path, "w") as f:
        f.create_dataset("sst", data=np.full((3, 3), 1.0))
        g = f.create_group("ancient")          # 'a...' sorts before 'sst'
        g.create_dataset("sst", data=np.full((2, 2), -99.0))
        g.create_dataset("extra", data=np.arange(4.0))

    with ncio.open_nc(path) as nc:
        root = ncio.get_var(nc, "sst")
        assert root.shape == (3, 3) and root[0, 0] == 1.0
        # group-only datasets remain reachable by their trailing name
        np.testing.assert_array_equal(ncio.get_var(nc, "extra"),
                                      np.arange(4.0))


def test_start_count_form_matches_jax(tmp_path):
    """``get_var(nc, name, start=, count=)``: the older 0-based offset
    form, with and without ``count``, gives the JAX package's arrays and
    counts the bytes it materializes."""
    nt, ny, nx = 9, 5, 7
    path = str(tmp_path / "f.nc")
    data = np.arange(nt * ny * nx, dtype=np.float64).reshape(nt, ny, nx)
    ncio.write_fields(
        path, {"t": nt, "latitude": ny, "longitude": nx},
        {"t": ("t", np.arange(nt, dtype=float)),
         "latitude": ("latitude", np.arange(ny, dtype=float)),
         "longitude": ("longitude", np.arange(nx, dtype=float))},
        {"sst": (("t", "latitude", "longitude"), data)})
    with ncio.open_nc(path) as nc, jncio.open_nc(path) as jnc:
        for start, count in (((2, 1, 3), (4, 2, 3)), ((5, 0, 0), None),
                             ((0, 4, 6), (1, 1, 1))):
            before = ncio.READ_BYTES
            got = ncio.get_var(nc, "sst", start=start, count=count)
            ref = jncio.get_var(jnc, "sst", start=start, count=count)
            assert ncio.READ_BYTES - before == got.nbytes
            assert got.dtype == ref.dtype == np.float64
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(ncio.get_var(nc, "sst"), data)
        np.testing.assert_array_equal(
            ncio.get_var(nc, "sst", index=(3,)), data[3])
