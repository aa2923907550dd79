"""The step kernel's column order (``cuda_kernels.step_order``).

A one-warp or pair block of the whole-step kernel holds its SM's warp
slots until its slowest column is done, and a land column's warp skips
its loops, so a land warp beside ocean ones holds a slot idle.  Given the
main path's active-column mask, the wrapper hands the kernel an order, the
ocean columns ascending and then the land ones, and slot i of the launch
takes column ``order[i]``: the blocks hold ocean columns together.

On the CPU: the order and its absence (no land; one column a block, the
spreads over a block's warps or a cluster), its cache (once per mask
tensor, read again after a write to it), and the block fill the wrapper
reports on the masks the port's input sets draw.  In the host emulation
of ``test_torch_cluster_emulation.py``: the step kernel with the order
against the same kernel without it, bit for bit on all 9 outputs, in
both layouts, one warp a column at 3 slots and a pair of warps at 3
slots.  Tests marked ``gpu`` need a CUDA card and skip without one: the
same comparison at the deployments' widths, and a day of each
configuration through the CLI against a run with the order turned off
inside the test, every restart array equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mckpp_torch import forcing, setup
from mckpp_torch.io import benchmark_inputs
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.utils import namelist as nml

from test_torch_cluster_emulation import (  # noqa: F401 (emu_zl: a fixture)
    emu_zl, kernels, layout_inputs, run)

# ---- the order and its counter -----------------------------------------------


def mask_of(flags):
    return torch.tensor(flags, dtype=torch.bool)


def test_order_puts_the_ocean_columns_first():
    wet = mask_of([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1])
    order, fill = ck.step_order(wet, 4)
    assert order.dtype == torch.int32 and order.device == wet.device
    assert order.tolist() == [0, 2, 3, 6, 8, 9, 10, 1, 4, 5, 7]
    # 7 ocean columns over the 2 blocks of 4 that hold them; in slot
    # order all 3 blocks hold some
    assert fill == pytest.approx(7 / 8)
    assert ck.block_fill(wet.numpy(), 4) == pytest.approx(7 / 12)
    assert ck.block_fill(wet.numpy(), 4, order.numpy()) == fill


def test_no_order_without_land_or_with_one_column_a_block():
    ocean = torch.ones(13, dtype=torch.bool)
    order, fill = ck.step_order(ocean, 8)
    assert order is None
    assert fill == pytest.approx(13 / 16)         # the ragged last block
    wet = mask_of([1, 0, 1, 0, 1])
    assert ck.step_order(wet, 1) == (None, 1.0)
    # the spreads of one column a block: over a block's warps, a cluster
    for nz in (300, 1100):
        geom = ck.launch_geometry(nz, torch.float32, 5)
        assert geom.cols_per_block == 1
        assert ck.step_order(wet, geom.cols_per_block)[0] is None
    # all land: the land columns in slot order, no block holds ocean
    land = torch.zeros(5, dtype=torch.bool)
    order, fill = ck.step_order(land, 4)
    assert order.tolist() == list(range(5)) and fill == 1.0


def test_order_is_made_once_per_mask_tensor(monkeypatch):
    reads = []
    fill = ck.block_fill
    monkeypatch.setattr(ck, "block_fill",
                        lambda *a: reads.append(1) or fill(*a))
    wet = mask_of([1, 0, 1, 1, 0, 1, 1, 1, 0])
    first = ck.step_order(wet, 4)
    assert ck.step_order(wet, 4)[0] is first[0] and len(reads) == 1
    # a tensor of the same values is another mask
    assert ck.step_order(wet.clone(), 4)[0] is not first[0]
    assert len(reads) == 2
    # a write of the same values: read again, the same order kept
    wet.copy_(wet.clone())
    assert ck.step_order(wet, 4)[0] is first[0] and len(reads) == 2
    # a write that moves land: a new order; the old one stays alive for
    # any CUDA graph captured with it
    wet[1] = True
    order, _ = ck.step_order(wet, 4)
    assert order.tolist() == [0, 1, 2, 3, 5, 6, 7, 4, 8]
    assert any(o is first[0] for o in ck._orders[id(wet)][4])
    assert ck.step_order(wet, 4)[0] is order


def drawn_mask(config, monkeypatch):
    """The land-sea mask ``benchmark_inputs.generate(config)`` draws, as the
    model's active-column flags (row-major over the grid), with no file
    written."""
    got = {}
    monkeypatch.setattr(benchmark_inputs, "_write_common",
                        lambda d, lons, lats, h, zf, dd, lsm, depth:
                        got.update(lsm=lsm))
    for name in ("_write_fluxes", "_write_sst_sal", "_namelist"):
        monkeypatch.setattr(benchmark_inputs, name, lambda *a, **k: None)
    benchmark_inputs.generate(config, "unused")
    return got["lsm"].reshape(-1) == 0.0


@pytest.mark.parametrize("config,share,slots,cols", [
    ("terramaris", 0.880, 3, 8), ("goml2_n216", 0.600, 4, 8)])
def test_block_fill_on_the_drawn_masks(config, share, slots, cols,
                                       monkeypatch):
    """The fill of the one-warp build's blocks (8 columns) on the masks
    of the two deployments' input sets: their ocean shares in slot order,
    where nearly every block mixes land and ocean, and all but the last
    block's ragged tail with the order."""
    ocean = drawn_mask(config, monkeypatch)
    nz = {"terramaris": 69, "goml2_n216": 100}[config]
    geom = ck.launch_geometry(nz, torch.float32, ocean.size)
    assert (geom.ns, geom.cols_per_block) == (slots, cols)
    assert ck.block_fill(ocean, cols) == pytest.approx(share, abs=0.005)
    _, fill = ck.step_order(torch.as_tensor(ocean), cols)
    assert fill >= 0.9999


# ---- the kernel, emulated on the host ------------------------------------------

# (nz, ncol, dmax) of the one-warp build at 3 slots (8 columns a block in
# float64) and of the pair build at 3 slots (4 a block), the last block
# ragged, and the land columns of each scattered mask, so that in the
# order the block where the ocean columns end holds land too and the
# last block is land
ORDER_SPREADS = {"warp": (60, 19, 200.0), "pair": (150, 11, 450.0)}
ORDER_LAND = {"warp": (1, 4, 5, 9, 12, 17), "pair": (1, 3, 6, 7)}


@pytest.mark.parametrize("zaxis", [0, 1])
@pytest.mark.parametrize("mask", ["scattered", "all_land", "all_ocean"])
@pytest.mark.parametrize("spread", list(ORDER_SPREADS))
def test_column_order_keeps_the_bits(emu_zl, monkeypatch, spread, mask,
                                     zaxis):
    """The step kernel given the main path's mask (its blocks take the
    ocean columns first, then the land ones) against the same kernel
    without it (slot i takes column i), bit for bit on all 9 outputs, in
    both layouts: each column's outputs land where they did.  An
    all-ocean mask gives no order, so the launch is the other's."""
    nz, ncol, dmax = ORDER_SPREADS[spread]
    land = {"scattered": ORDER_LAND[spread], "all_land": tuple(range(ncol)),
            "all_ocean": ()}[mask]
    kw = {}
    w, a = layout_inputs(nz, ncol, dmax, "cuda_step", monkeypatch,
                         land=land, kwargs=kw)
    wet = kw["mask"]
    assert wet.dtype == torch.bool and int((~wet).sum()) == len(land)
    geom = ck.launch_geometry(nz, torch.float64, ncol,
                              ck._ref_extents(a[-1])[1])
    cols = geom.cols_per_block
    assert geom.lib == ("pw3" if spread == "pair" else 3)
    assert cols > 1 and ncol % cols, "the last block is not ragged"
    k = kernels("cuda_step", w)[0]
    if zaxis:
        k = type(k)(dict(k.kw, zaxis=1))
        a = tuple(x.T.contiguous() for x in a)     # aref too: prof @ aref
    order, fill = ck.step_order(wet, cols)
    ocean = wet.numpy()
    got = run(emu_zl, k, a, geom, monkeypatch, mask=wet)
    assert ck.STEP_BUILD["block_fill"] == fill
    npass = got[8][:, 7] if zaxis else got[8][7]
    assert (npass[~wet] == 0).all() and (npass[wet] > 0).all()
    if mask == "all_ocean":
        assert order is None
        return
    assert order.tolist() == (np.flatnonzero(ocean).tolist()
                              + np.flatnonzero(~ocean).tolist())
    if mask == "scattered":      # a block of the order holds both kinds
        assert ocean.sum() % cols and fill > ck.block_fill(ocean, cols)
    ref = run(emu_zl, k, a, geom, monkeypatch)
    assert ck.STEP_BUILD["block_fill"] is None
    for i, (x, y) in enumerate(zip(got, ref)):
        assert torch.equal(x, y), i


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the benchmark's seed-drawn inputs for the tests on the card, and a day
DAY_SEED, DAY = 2**31 + 41, 72


@pytest.fixture(scope="module")
def deployments(tmp_path_factory):
    """The benchmark's inputs of both deployments at full width, drawn from
    one seed, for a day of steps with its ``kpp_means`` streams (hmix
    means) and one restart at the end: TerraMaris (144,507 x 69, 12%
    land) and MetUM-GOML2's N216 (139,968 x 100, 40%)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from kppbench import inputs, spec
    out = {}
    for config in ("terramaris", "goml2_n216"):
        cell = spec.resolve(f"{config}.kpp_means")
        d = str(tmp_path_factory.mktemp(config))
        out[config] = os.path.join(d, "in")
        inputs.prepare(cell.config, cell.traffic, os.path.join(d, "static"),
                       out[config], DAY_SEED)
        with open(os.path.join(out[config], "3D_ocn.nml"), "w") as f:
            f.write(inputs.namelist(cell.config, DAY, 0))
    return out


class Stop(Exception):
    pass


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("config", ["terramaris", "goml2_n216"])
def test_order_keeps_the_bits_at_width(cuda, deployments, config, dtype,
                                       monkeypatch):
    """The first step kernel launch of each deployment at full width, in
    both layouts (the inputs transposed for z_lanes), with the main path's
    mask against without it: every output equal (``torch.equal``)."""
    data = deployments[config]
    kcfg, _ = nml.load_config(os.path.join(data, "3D_ocn.nml"))
    kcfg = dataclasses.replace(kcfg, dtype=dtype)
    model, st, prm, frc, _, _ = setup.build(kcfg, data, device=cuda)
    calls = []

    def call(w, *a, **kw):
        calls.append((w, a, kw))
        raise Stop
    monkeypatch.setattr(ck.FusedStep, "__call__", call)
    raw = forcing.constant_test_fluxes(st.u.shape[0], model.dtype, cuda)
    st, frc = forcing.update_fluxes(kcfg, st, prm, frc, raw, True,
                                    model.grid.dm)
    with pytest.raises(Stop):
        model.step(st, prm, frc, first_step=True, with_diags=False)
    monkeypatch.undo()
    (w, a, kw), = calls
    mask = kw["mask"]
    assert mask is prm.run_physics and not bool(mask.all())
    for zaxis in (0, 1):
        k = ck.FusedStep(dict(w.kw, zaxis=zaxis))
        args = tuple(x.T.contiguous() for x in a) if zaxis else a
        got = k.launch(*args, mask=mask)
        assert ck.STEP_BUILD["block_fill"] >= 0.9999
        ref = k.launch(*args)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(got, ref)):
            assert torch.equal(x, y), (zaxis, i)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["terramaris", "goml2_n216"])
def test_day_with_the_order_keeps_the_restart(cuda, deployments, config,
                                              tmp_path, monkeypatch):
    """A day of each deployment through the CLI with its defaults (float32,
    cuda_step, CUDA graphs): every array of the last restart is the same
    as a run whose `step_order` gives no order."""
    from mckpp_torch import cli
    data = deployments[config]

    def day(out):
        summary = cli.run(["--namelist", os.path.join(data, "3D_ocn.nml"),
                           "--data-dir", data, "--output-dir", out,
                           "--dtype", "float32"])
        path = os.path.join(out, sorted(f for f in os.listdir(out) if
                                        f.startswith("restart_out_"))[-1])
        return summary, dict(np.load(path))

    summary, got = day(str(tmp_path / "order"))
    assert summary["num_steps"] == DAY
    assert summary["step_kernel"]["block_fill"] >= 0.9999
    monkeypatch.setattr(ck, "step_order", lambda mask, cols: (None, None))
    summary, ref = day(str(tmp_path / "slots"))
    assert summary["step_kernel"]["block_fill"] is None
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
