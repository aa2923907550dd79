"""The frozen operation and byte counts equal the port's (commit a49d027
copies) on the nz = 40 and nz = 69 grids of the configurations."""

import numpy as np
import pytest
import torch

from kppbench import check, inputs, spec, yardstick


def _zm(nz, dmax=1000.0):
    cfg = {"nx": 1, "ny": 1, "nz": nz, "dmax": dmax, "lon0": 0.0,
           "lat0": 0.0, "dlon": 1.0, "dlat": 1.0}
    _, _, h, zf, _ = inputs.grids(cfg)
    return np.append(zf, zf[-1] - h[-1])


@pytest.mark.parametrize("nz", [40, 69])
def test_aref_and_pass_ops(nz):
    from mckpp_torch.ops import cuda_kernels as ck
    from mckpp_torch.ops import fused_pass as fp
    zm = _zm(nz)
    zm32 = torch.as_tensor(zm).float().double().numpy()
    want = fp.build_ref_matrix(zm32, nz + 2).T
    aref = yardstick.kernel_aref(zm, torch.float32)
    assert np.array_equal(aref.numpy(), want.astype(np.float32))
    assert np.array_equal(yardstick.row_extents(aref), ck.row_extents(aref))
    for kbl in (0, 1, 5, nz):
        for ldd in (False, True):
            assert yardstick.pass_ops(nz, aref, kbl, ldd) == \
                ck.pass_ops(nz, aref, kbl, ldd)
    kmix = torch.tensor([1.0, 7.0, float(nz)])
    assert torch.equal(yardstick.pass_ops(nz, aref, kmix),
                       ck.pass_ops(nz, aref, kmix))
    npass = np.array([3.0, 9.0, 0.0])
    assert yardstick.step_ops(nz, aref, npass, kmix.numpy()) == float(
        (torch.as_tensor(npass) * ck.pass_ops(nz, aref, kmix.double())).sum())


@pytest.mark.parametrize("nz", [40, 69])
def test_step_bytes(nz):
    """kernel_bytes equals chip_smoke's, and step_bytes counts the step
    kernel's 21 inputs and 9 outputs."""
    import chip_smoke
    ncol, wz = 37, nz + 2
    aref = yardstick.kernel_aref(_zm(nz), torch.float32)
    e = lambda *s: torch.zeros(s, dtype=torch.float32)
    a = ([e(wz, ncol) for _ in range(10)] + [e(wz, 1) for _ in range(4)]
         + [e(32, ncol)] + [e(wz, 1) for _ in range(5)] + [aref])
    got = [e(wz, ncol) for _ in range(8)] + [e(8, ncol)]
    assert yardstick.kernel_bytes(a, got, aref) == \
        chip_smoke.kernel_bytes(a, got, aref)
    assert yardstick.step_bytes(ncol, nz, aref) == \
        chip_smoke.kernel_bytes(a, got, aref)


def test_model_levels_match_the_port(tmp_path):
    cfg = dict(spec.resolve("terramaris.kpp_means").config, nz=40)
    inputs.write_static(cfg, str(tmp_path))
    from mckpp_torch.grid import vertical_grid_from_arrays
    from scipy.io import netcdf_file
    with netcdf_file(str(tmp_path / "vgrid.nc"), "r", mmap=False) as nc:
        z, h, d = (np.array(nc.variables[k][:]) for k in ("z", "h", "d"))
    g = vertical_grid_from_arrays(z, h, d, 1200.0)
    assert np.array_equal(check.model_levels(str(tmp_path / "vgrid.nc")),
                          g.zm.numpy())


def test_peaks():
    assert yardstick.card_peaks("NVIDIA H100 80GB HBM3") == (67.0e12, 3.35e12)
