"""The CUDA kernels of mckpp_torch against their plain torch versions.

Tests marked ``gpu`` need a CUDA card and skip without one; on the card
they build the kernels and hold each to its plain version at small
shapes.  ``python3 chip_smoke.py`` holds them at the main path's shapes.
The other tests check, on the CPU, how the launch wrappers route and
validate their inputs, the launch geometry, the reference-average row
extents and the operation count the bounds are computed from.
"""

import contextlib
import ctypes
import math
import re

import numpy as np
import pytest
import torch

import mckpp_torch as T
from mckpp_torch import forcing as tforcing
from mckpp_torch.grid import coriolis, make_vertical_grid
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.ops import fused_pass as fp
from mckpp_torch.state import init_params

NZ = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def model(ncol, pass_impl, device, dtype="float32", nz=NZ, dscale=0.0,
          **boundary):
    """``dscale`` > 0: a stretched vertical grid."""
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=120.0,
                              l_stretchgrid=dscale > 0, dscale=dscale),
        time=T.TimeConfig(dtsec=1200.0, ndtocn=1, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(pass_impl=pass_impl, wscale_mode="nodal"),
        boundary=T.BoundaryConfig(**boundary), dtype=dtype)
    m = T.KppModel(cfg, device=device)
    zm = m.grid.zm.double().cpu().numpy()
    rng = np.random.default_rng(1)
    t0 = 20.0 + 5.0 * np.exp(zm / 40.0) + 0.05 * rng.standard_normal((ncol, nz + 1))
    s0 = 35.0 - 0.3 * np.exp(zm / 60.0) + 0.01 * rng.standard_normal((ncol, nz + 1))
    u0 = 0.02 * rng.standard_normal((ncol, nz + 1, 2))
    prm = init_params(ncol, nz + 1, dtype=m.dtype, device=m.device)
    lat = torch.linspace(-40.0, 40.0, ncol, dtype=m.dtype, device=m.device)
    prm = prm.replace(f=coriolis(lat))
    st, prm, frc = m.warm_start(u0, t0, s0, prm)
    raw = tforcing.constant_test_fluxes(ncol, m.dtype, m.device)
    st, frc = tforcing.update_fluxes(cfg, st, prm, frc, raw, True, m.grid.dm)
    return m, st, prm, frc


def mixed_block(device, dtype, nz=NZ, dscale=0.0):
    """One 8-column block (the kernels' WARPS) mixing a land column (3), a
    column the instability trap retries (large T and u noise on columns 1
    and 6; at nz = 12 column 1 ends with comp_flag 1 after 11 attempts)
    and columns whose pass counts differ by >= 3."""
    m, st, prm, frc = model(8, "cuda_step", device, dtype, nz, dscale)
    rng = np.random.default_rng(2)
    x, u = st.x.clone(), st.u.clone()
    for col in (1, 6):
        x[col, :, 0] += torch.as_tensor(3.0 * rng.standard_normal(nz + 1),
                                        dtype=x.dtype, device=x.device)
        u[col] += torch.as_tensor(2.1 * rng.standard_normal((nz + 1, 2)),
                                  dtype=u.dtype, device=u.device)
    hist = lambda a: a[..., None].expand(*a.shape, 2).clone()
    st = st.replace(x=x, u=u, xs=hist(x), us=hist(u))
    wet = torch.ones(8, dtype=torch.bool, device=x.device)
    wet[3] = False
    return m, st, prm.replace(l_ocean=wet, run_physics=wet), frc


class Recorder:
    """Collects (wrapper, inputs) of the wrapper calls of one step."""

    def __init__(self, monkeypatch):
        self.calls = []
        for cls in (ck.FusedPass, ck.FusedStep):
            orig = cls.__call__

            def call(w, *a, _orig=orig, **kw):
                self.calls.append((w, a))
                return _orig(w, *a, **kw)
            monkeypatch.setattr(cls, "__call__", call)


# integer-valued rows of each kernel's per-column output: (output, rows)
INT_ROWS = {"fused_pass_fast": (8, (1,)), "fused_pass_full": (4, (1,)),
            "fused_step": (8, (1, 4, 5, 7))}


@contextlib.contextmanager
def serial_sums():
    """The plain bodies' one matmul, the reference averages ``aref @
    prof``, summed as the kernels sum them: term by term in k order, each
    product and each sum rounded on its own (cuBLAS orders them its own
    way, which shows where aref's rows are long)."""
    matmul = torch.matmul

    def serial(a, b):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=b.dtype,
                          device=b.device)
        for k in range(a.shape[1]):
            acc = acc + a[:, k:k + 1] * b[k:k + 1]
        return acc
    torch.matmul = serial
    try:
        yield
    finally:
        torch.matmul = matmul


def hold_to_plain(monkeypatch, setups, nz, tol, aref_dev=None, first=None,
                  serial=False):
    """Step each (model, state, params, forcing) of ``setups`` once and
    hold every kernel its wrapper was called for (``first``: the first
    ``first`` calls of each kernel) to its plain body on the same inputs
    (``serial``: with the reference averages summed serially,
    :func:`serial_sums`): floats within ``tol`` of each output's scale,
    the integer rows equal; each launch on the fewest level slots that
    cover nz + 2 (past 128 levels a column over a pair of warps of 3 or 4
    slots, past 256 over ceil((nz + 2) / 128) warps of 4 slots, past 1024
    over a cluster of ceil((nz + 2) / 1024) blocks), and (``aref_dev`` not
    None) with aref in that placement."""
    names = set()
    ns, cw, cb = _expected_slots(nz)
    for m, st, prm, frc in setups:
        rec = Recorder(monkeypatch)
        m.step(st, prm, frc, first_step=True)
        seen = []
        for w, a in rec.calls:
            seen.append(w.name)
            if first is not None and seen.count(w.name) > first:
                continue
            g = ck.launch_geometry(nz, a[0].dtype, a[0].shape[1],
                                   ck._ref_extents(a[-1])[1])
            assert (g.ns, g.cw, g.cb) == (ns, cw, cb)
            if aref_dev is not None:
                assert g.aref_dev == aref_dev
            got = w.launch(*a)
            body = fp._pass_body if isinstance(w, ck.FusedPass) else fp._step_body
            with serial_sums() if serial else contextlib.nullcontext():
                ref = body(*a, **w.kw)
            torch.cuda.synchronize()
            for g_, r in zip(got, ref):
                rel = float((g_ - r).abs().max()) / max(float(r.abs().max()), 1e-6)
                assert rel <= tol, (w.name, rel)
            pos, rows = INT_ROWS[w.name]
            for row in rows:
                assert torch.equal(got[pos][row], ref[pos][row]), (w.name, row)
            names.add(w.name)
        monkeypatch.undo()
    assert names == {"fused_pass_fast", "fused_pass_full", "fused_step"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("ncol,nz", [(5, NZ), (130, NZ), (13, NZ),
                                     ("mixed_block", NZ), (37, 100),
                                     (1, 100), (13, 126)])
def test_kernels_match_plain(cuda, monkeypatch, dtype, tol, ncol, nz):
    """5, 130 and 13 leave a ragged last 8-column block; "mixed_block" is
    one block of a land column, a trap column and uneven pass counts;
    nz = 100 and 126 run the kernels at 4 level slots (single_column's
    levels, and the most 4 slots take)."""
    setups = []
    for impl in ("cuda", "cuda_step"):
        if ncol == "mixed_block":
            _, st, prm, frc = mixed_block(cuda, dtype)
            setups.append((model(8, impl, cuda, dtype)[0], st, prm, frc))
        else:
            setups.append(model(ncol, impl, cuda, dtype, nz=nz,
                                l_advect=False))
    hold_to_plain(monkeypatch, setups, nz, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("nz,dscale", [(127, 0.0), (190, 0.0), (254, 0.0),
                                       (127, 5.0), (190, 5.0), (254, 5.0),
                                       (255, 0.0), (383, 5.0), (1022, 0.0),
                                       (1022, 5.0), (1023, 0.0),
                                       (2046, 5.0)])
def test_deep_kernels_match_plain(cuda, monkeypatch, dtype, tol, nz, dscale):
    """Past 126 levels: a column over a pair of warps of 3 slots (nz 127
    and 190) and of 4 (nz 254), several columns a block, on a uniform and
    a stretched grid, 13 columns (a ragged last block) with a land column;
    past 254 a column over 3 (nz 255), 4 (383) and 8 (1022) warps; past
    1022 a column over a cluster of 2 blocks (nz 1023, 5 warps each, and
    2046, 8 each).  Every one of these launches reads aref from device
    memory.  Some column's hmix loop runs to its
    limit (~200 passes), so the per-pass kernel is held on its first 8
    calls.  The plain bodies sum the reference averages serially
    (:func:`serial_sums`): the stretched grids' aref rows reach 48 to 122
    levels, where cuBLAS's order moves a pass by ~2e-5 and the hmix
    loop's kmix with it.  (``chip_smoke.py``'s gate adds a trap column and
    double diffusion at these depths.)"""
    setups = []
    for impl in ("cuda", "cuda_step"):
        m, st, prm, frc = model(13, impl, cuda, dtype, nz, dscale)
        wet = torch.ones(13, dtype=torch.bool, device=cuda)
        wet[3] = False
        setups.append((m, st, prm.replace(l_ocean=wet, run_physics=wet),
                       frc))
    hold_to_plain(monkeypatch, setups, nz, tol, aref_dev=1, first=8,
                  serial=True)


def test_mixed_block_has_its_cases(monkeypatch):
    """The mixed-block gate case holds what it is for (plain body, CPU): a
    land column, a column trapped after retries, pass counts apart by >= 3."""
    m, st, prm, frc = mixed_block("cpu", "float32")
    rec = Recorder(monkeypatch)
    m.step(st, prm, frc, first_step=True)
    w, a = next((w, a) for w, a in rec.calls if w.name == "fused_step")
    cs = w(*a)[8]
    npass, comp, reset = cs[7], cs[4], cs[5]
    assert npass[3] == 0                                   # land
    assert bool(((comp > 0.5) & (reset >= 2)).any())       # trapped
    wet = torch.arange(8) != 3
    assert float(npass[wet].max() - npass[wet].min()) >= 3


@pytest.mark.gpu
def test_launch_counts_and_no_fallback(cuda, monkeypatch):
    m, st, prm, frc = model(7, "cuda_step", cuda)
    rec = Recorder(monkeypatch)
    ck.reset_counts()
    m.step(st, prm, frc, first_step=True)
    assert ck.LAUNCHES == {"fused_pass_fast": 0, "fused_pass_full": 1,
                           "fused_step": 1, "step_glue_in": 1,
                           "step_glue_out": 1}
    w, a = next((w, a) for w, a in rec.calls if w.name == "fused_step")
    bad = list(a)
    bad[14] = a[14][:8]                        # colscal rows
    with pytest.raises(ValueError):            # raises, never runs plain
        w(*bad)
    assert ck.LAUNCHES["fused_step"] == 1


def test_cpu_tensors_run_the_plain_body():
    """A wrapper given CPU tensors runs the plain body and counts nothing."""
    m, st, prm, frc = model(4, "cuda_step", "cpu", dtype="float64")
    ref_m = model(4, "eager_step", "cpu", dtype="float64")[0]
    ck.reset_counts()
    out = m.step(st, prm, frc, first_step=True)
    ref = ref_m.step(st, prm, frc, first_step=True)
    assert ck.LAUNCHES == {k: 0 for k in ck.LAUNCHES}
    for name in ("x", "u", "hmix", "difm"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


def test_wrapper_checks_inputs(monkeypatch):
    m, st, prm, frc = model(4, "cuda", "cpu", dtype="float64")
    rec = Recorder(monkeypatch)
    m.step(st, prm, frc, first_step=True)
    w, a = next((w, a) for w, a in rec.calls if w.name == "fused_pass_fast")
    assert ck._check(a, w.kw, 12) == (4, torch.float64)
    bad = list(a)
    bad[2] = a[2].T.contiguous().T            # non-contiguous
    with pytest.raises(ValueError):
        ck._check(bad, w.kw, 12)
    bad = list(a)
    bad[5] = a[5].float()
    with pytest.raises(TypeError):
        ck._check(bad, w.kw, 12)
    bad = list(a)
    bad[18] = a[18][:10]                       # colscal rows
    with pytest.raises(ValueError):
        ck._check(bad, w.kw, 12)
    with pytest.raises(TypeError):
        ck._check([x.to(torch.int32) for x in a], w.kw, 12)


def test_pass_params_layout():
    """The ctypes struct has the fields of the C struct, in order: 19 ints,
    then 14 doubles, then rmsd_thr[4] (the C side's natural alignment pads
    after the ints)."""
    names = [f[0] for f in ck.PassParams._fields_]
    assert names[:3] == ["nz", "wz", "ncol"] and names[-1] == "rmsd_thr"
    assert ctypes.sizeof(ck.PassParams) == 19 * 4 + 4 + 14 * 8 + 4 * 8
    with open(ck._CSRC + "/fused_pass.cuh") as f:
        src = f.read()
    body = src[src.index("struct PassParams {"):src.index("};", src.index("struct PassParams {"))]
    for n in names:
        assert n in body, n


def test_unsupported_wscale_raises():
    kw = dict(nz=NZ, flags=fp.PassFlags(wscale="table"), dto=1200.0,
              zbot=-120.0, adv_st=None, full=False)
    with pytest.raises(NotImplementedError):
        ck._params(kw, 4)


def _aref(nz, dmax, stretch, dscale=2.0):
    """The reference-average matrix as ops/ocnstep_fused builds it."""
    g = make_vertical_grid(nz, dmax, 1200.0, stretch=stretch, dscale=dscale)
    zm = np.pad(g.zm.numpy(), (0, 1))
    return fp.build_ref_matrix(zm[:nz + 1], nz + 2).T


def _fewest_slots(nz):
    return min(n for n in ck.SLOTS if 32 * n >= nz + 2)


def _expected_slots(nz):
    """(level slots, warps a column in a block, blocks a column) of a
    launch at nz: the fewest slots of one warp up to WZ = 128, up to 256
    a pair of warps of 3 (WZ <= 192) or 4 slots, past it 4 slots on
    ceil(WZ / 128) warps, past 1024 on a cluster of cb = ceil(WZ / 1024)
    blocks of ceil(WZ / (128 cb)) warps."""
    wz = nz + 2
    if wz <= 128:
        return _fewest_slots(nz), 1, 1
    if wz <= 256:
        return (3 if wz <= 192 else 4), 2, 1
    cb = -(-wz // 1024)
    return 4, -(-wz // (128 * cb)), cb


@pytest.mark.parametrize("stretch", [False, True])
@pytest.mark.parametrize("dmax", [120.0, 1000.0])
@pytest.mark.parametrize("nz", [12, 33, 40, 65, 69, 94, 190, 254])
def test_ref_extents_and_pass_ops(nz, dmax, stretch):
    """aref is zero past each row's extent, each row's nonzeros are a
    prefix, and pass_ops is the dense count less the skipped entries."""
    aref = _aref(nz, dmax, stretch)
    wz = nz + 2
    hi = ck.row_extents(aref)
    cols = np.arange(wz)[None, :]
    assert hi.shape == (wz,) and hi.dtype == np.int32
    assert (aref[cols > hi[:, None]] == 0.0).all()
    assert (aref[cols <= hi[:, None]] != 0.0).all()
    assert (hi[nz:] == -1).all()                  # padding rows are zero
    kept = int((hi + 1).sum())
    # the dense count: 6 operations for every aref entry; PCR: 11 per
    # distinct matrix (two, three with double diffusion) + 4 per system
    stages = math.ceil(math.log2(nz))
    for ldd, nmat in ((False, 2), (True, 3)):
        dense_level = (12 + 270 + 11 + 6 * wz + 14 + 30
                       + stages * (11 * nmat + 16) + 24 + 24 + 8 + 8)
        for kbl in (1, 5, nz):
            dense = wz * dense_level + (kbl - 1) * 260 + 120
            assert (ck.pass_ops(nz, aref, kbl, ldd)
                    == dense - 6 * (wz * wz - kept))
    kbl_t = torch.tensor([1.0, 5.0, float(nz)])
    assert torch.equal(ck.pass_ops(nz, aref, kbl_t),
                       torch.tensor([float(ck.pass_ops(nz, aref, k))
                                     for k in (1, 5, nz)]))
    t = torch.as_tensor(aref)
    dev, kref = ck._ref_extents(t)
    assert kref == int(hi.max()) + 1
    assert ck._ref_extents(t)[0] is dev           # cached per aref tensor
    assert np.array_equal(dev.numpy(), hi)


@pytest.mark.parametrize("nz,dmax", [(69, 1000.0), (300, 1000.0),
                                     (1100, 2000.0)])
def test_kernel_bytes_count_aref_prefix(nz, dmax):
    """chip_smoke's bound counts of aref only the rows' nonzero prefixes
    (and their int32 extents), in both layouts' forms of aref, and every
    other input and output whole."""
    import chip_smoke
    aref = torch.as_tensor(_aref(nz, dmax, False), dtype=torch.float32)
    wz = nz + 2
    prof = torch.zeros((wz, 5), dtype=torch.float32)
    outs = [torch.zeros((wz, 5), dtype=torch.float32),
            torch.zeros((8, 5), dtype=torch.float32)]
    kept = int((ck.row_extents(aref) + 1).sum())
    assert kept < wz * wz
    want = 4 * (wz * 5) + 4 * kept + 4 * wz + 4 * (wz * 5 + 8 * 5)
    for a_ref in (aref, aref.t().contiguous()):     # col_lanes, z_lanes
        got = chip_smoke.kernel_bytes([prof, a_ref], outs,
                                      ck._kernel_aref(a_ref, 0 if a_ref is
                                                      aref else 1))
        assert got == want


@pytest.mark.parametrize("nz,dscale", [(69, 2.0), (190, 5.0), (254, 10.0),
                                       (300, 5.0), (1022, 5.0), (1100, 5.0)])
def test_ref_tile(nz, dscale):
    """The device-memory placement's tile is aref transposed, cut to its
    kref columns and padded with zeros to the 32 x slots levels of the
    launch (x the warps of a column past 126 levels: 2 of a pair, or
    past 254 those of a block; x the blocks of its cluster past 1022),
    made once per aref tensor and width."""
    aref = torch.as_tensor(_aref(nz, 250.0, True, dscale))
    kref = ck._ref_extents(aref)[1]
    ns, cw, cb = _expected_slots(nz)
    geom = ck.launch_geometry(nz, aref.dtype, 3, kref)
    assert geom.levels == 32 * ns * cw * cb
    tile = ck._ref_tile(aref, ns, cw, cb)
    assert tile.shape == (kref, geom.levels) and tile.dtype == aref.dtype
    assert torch.equal(tile[:, :nz + 2], aref[:, :kref].T)
    assert not tile[:, nz + 2:].any()
    assert ck._ref_tile(aref, ns, cw, cb) is tile
    wider = ck._ref_tile(aref, ns, cw + 1, cb)
    assert wider.shape == (kref, 32 * ns * (cw + 1) * cb)
    assert torch.equal(wider[:, :geom.levels], tile)


@pytest.mark.parametrize("advect", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_tile(dtype, advect):
    """The grid rows' device tile of a column over several warps holds
    zm, hm, dm, tdn, tup (the (nz + 2, 1) inputs before aref) and the depth
    prefix (zero without advection) on the launch's levels, padded as the
    kernels pad their shared copy: hm with 1, the others with 0."""
    nz, lz = 300, 384
    wz = nz + 2
    rng = np.random.default_rng(3)
    rows = [torch.as_tensor(rng.uniform(0.5, 2.0, (wz, 1)), dtype=dtype)
            for _ in range(5)]
    aref = torch.zeros((wz, wz), dtype=dtype)
    arrays = [torch.zeros((wz, 4), dtype=dtype)] + rows + [aref]
    pfx = fp._depth_prefix(rows[1], nz)
    tile = ck._grid_tile(arrays, pfx, advect, lz)
    assert tile.shape == (6, lz) and tile.dtype == dtype
    for i in range(5):
        assert torch.equal(tile[i, :wz], rows[i][:, 0])
    assert torch.equal(tile[5, :wz], pfx[:, 0] if advect
                       else torch.zeros(wz, dtype=dtype))
    assert bool((tile[1, wz:] == 1.0).all())
    assert not tile[[0, 2, 3, 4, 5], wz:].any()


def test_grid_tile_is_made_once():
    """A launch on the same grid rows reuses their tile (every float64
    launch at 8 warps, inside captured CUDA graphs too); a row written in
    place, or other row tensors, make a new one."""
    nz, lz = 1000, 1024
    wz = nz + 2
    rows = [torch.linspace(1.0, 2.0, wz, dtype=torch.float64)[:, None]
            .clone() for _ in range(5)]
    arrays = [torch.zeros((wz, 4), dtype=torch.float64)] + rows + \
        [torch.zeros((wz, wz), dtype=torch.float64)]
    pfx = fp._depth_prefix(rows[1], nz)
    tile = ck._grid_tile(arrays, pfx, True, lz)
    assert ck._grid_tile(arrays, pfx, True, lz) is tile
    assert ck._grid_tile(arrays, pfx, False, lz) is not tile
    rows[2].mul_(2.0)                       # dm written in place
    again = ck._grid_tile(arrays, pfx, True, lz)
    assert again is not tile and torch.equal(again[2, :wz], rows[2][:, 0])
    other = list(arrays)
    other[-3] = rows[3].clone()             # another tdn tensor
    assert ck._grid_tile(other, pfx, True, lz) is not again


def _check_mw(g, nz, dtype, ncol):
    """A launch past 256 levels: one column a block over ceil(WZ / 128)
    warps of 4 slots, aref from device memory, the grid rows too exactly
    where their shared copy does not fit."""
    cw = -(-(nz + 2) // 128)
    assert (g.ns, g.cw, g.warps, g.cols_per_block, g.cb) == (4, cw, cw, 1, 1)
    assert (g.blocks, g.aref_dev, g.lib, g.levels) == (ncol, 1, ck.MW,
                                                      128 * cw)
    fits = ck.smem_bytes_mw(cw, 0, dtype.itemsize) <= ck.SMEM_MAX
    assert g.grid_dev == int(not fits)
    assert g.smem == ck.smem_bytes_mw(cw, g.grid_dev, dtype.itemsize) \
        <= ck.SMEM_MAX


def _check_pw(g, nz, dtype, ncol):
    """A launch past 128 levels up to 256: columns over a pair of warps of
    3 (WZ <= 192) or 4 slots, ``PW_COLS`` columns a block (the named
    barriers 1..PW_COLS_MAX of the C side); every level on exactly one
    (warp, lane, slot) of its column and both warps holding some; aref
    from device memory, the grid rows in shared memory; the block's shared
    memory smem_bytes_pw, within SMEM_MAX."""
    wz = nz + 2
    ns = 3 if wz <= 192 else 4
    cols = ck.PW_COLS[dtype.itemsize]
    assert 2 <= cols <= 8
    assert (g.ns, g.cw, g.warps, g.cols_per_block, g.cb) == \
        (ns, 2, 2 * cols, cols, 1)
    assert (g.blocks, g.aref_dev, g.grid_dev, g.lib, g.levels) == \
        (-(-ncol // cols), 1, 0, f"pw{ns}", 64 * ns)
    # the kernels' map of level k of a column: warp k // (32 ns) of its
    # pair, lane k % 32, slot (k % (32 ns)) // 32
    k = np.arange(g.levels)
    place = np.stack([k // (32 * ns), k % 32, (k % (32 * ns)) // 32])
    assert (place[0] < 2).all() and (place[2] < ns).all()
    assert len({tuple(p) for p in place.T}) == g.levels
    assert np.array_equal(place[0] * 32 * ns + place[2] * 32 + place[1], k)
    assert set(place[0][:wz]) == {0, 1}
    assert g.smem == ck.smem_bytes_pw(ns, cols, dtype.itemsize) \
        <= ck.SMEM_MAX


def _check_cl(g, nz, dtype, ncol):
    """A launch past 1024 levels: one column over a cluster of cb =
    ceil(WZ / 1024) blocks of cw = ceil(WZ / (128 cb)) warps of 4 slots,
    ncol * cb blocks; every level on exactly one (block, warp, lane, slot)
    and every block holding some; aref and the grid rows from device
    memory; each block's shared memory smem_bytes_cl, within SMEM_MAX."""
    wz = nz + 2
    cb = -(-wz // 1024)
    cw = -(-wz // (128 * cb))
    assert (g.ns, g.cb, g.cw, g.warps, g.cols_per_block) == (4, cb, cw, cw, 1)
    assert (g.blocks, g.aref_dev, g.grid_dev, g.lib) == (ncol * cb, 1, 1,
                                                        ck.CL)
    assert 2 <= cb <= ck.CB_MAX and 1 <= cw <= 8
    assert g.levels == 128 * cw * cb >= wz > 128 * cw * (cb - 1)
    # the kernels' map of level k: block k // LB, warp (k % LB) // 128,
    # lane k % 32, slot (k % 128) // 32, LB = 128 cw
    k = np.arange(g.levels)
    lb = 128 * cw
    place = np.stack([k // lb, (k % lb) // 128, k % 32, (k % 128) // 32])
    assert (place[0] < cb).all() and (place[1] < cw).all()
    assert (place[3] < 4).all()
    assert len({tuple(p) for p in place.T}) == g.levels
    back = place[0] * lb + place[1] * 128 + place[3] * 32 + place[2]
    assert np.array_equal(back, k)
    assert set(place[0][:wz]) == set(range(cb))
    assert g.smem == ck.smem_bytes_cl(cw, dtype.itemsize) <= ck.SMEM_MAX


# nz past 1022 that the geometry tests take: every 97th, and the edges
# (the first of 2 blocks, WZ = 1024 + 2 blocks' first whole warp, the
# last of 2 blocks and the first of 3, 3 blocks' last, the most levels)
CL_EDGES = (1023, 1024, 2046, 2047, 3070, 8190)
CL_NZ = sorted(set(range(1023, 8191, 97)) | set(CL_EDGES))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_geometry(dtype):
    """Every nz the kernels take fits one block's shared memory, with aref
    kept whole (the worst case), on the fewest level slots that cover nz +
    2 up to 128 levels (one warp a column, 8 columns a block or fewer),
    up to 256 on a column over a pair of warps (:func:`_check_pw`), past
    them on a column over ceil((nz + 2) / 128) warps, past 1024 on a
    cluster of blocks (:func:`_check_cl`, every 97th nz and the edges);
    the grid covers every ncol exactly; past 8192 levels the geometry
    raises."""
    for nz in CL_NZ:
        for kref in (None, 0, 9):
            for ncol in (1, 7, 37, 144_507):
                g = ck.launch_geometry(nz, dtype, ncol, kref)
                assert g.kref == (nz + 2 if kref is None else kref)
                _check_cl(g, nz, dtype, ncol)
    for nz in range(1, 1023):
        for kref in (None, 0, 9):
            if kref is not None and kref > nz + 2:
                continue
            for ncol in (1, 7, 37, 129, 144_507):
                g = ck.launch_geometry(nz, dtype, ncol, kref)
                assert g.smem <= 232_448
                assert g.blocks * g.cols_per_block >= ncol
                assert (g.blocks - 1) * g.cols_per_block < ncol
                if nz + 2 > 256:
                    _check_mw(g, nz, dtype, ncol)
                    continue
                if nz + 2 > 128:
                    _check_pw(g, nz, dtype, ncol)
                    continue
                assert g.ns == _fewest_slots(nz)
                assert (g.cw, g.grid_dev, g.lib, g.aref_dev) == \
                    (1, 0, g.ns, 0)
                assert g.smem == ck.smem_bytes(g.ns, g.kref, g.warps,
                                               dtype.itemsize)
                assert 1 <= g.warps <= 8 and g.warps == g.cols_per_block
    with pytest.raises(ValueError, match="8192 levels"):
        ck.launch_geometry(8191, dtype, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dscale", [0.0, 5.0, 10.0])
def test_launch_geometry_on_real_grids(dtype, dscale):
    """For every nz in 1..254 on a uniform grid and stretched grids
    (``dscale`` 5 and 10), with the kref of the grid's own aref: the
    geometry never raises, fits SMEM_MAX, takes the fewest slots of one
    warp with aref's shared copy up to nz 126 (as many warps as fit
    beside it), and a pair of warps a column past it
    (:func:`_check_pw`).  Past 254 (the edges of each warp count and every
    7th nz, so that building the arefs stays cheap): a column over
    ceil(WZ / 128) warps with the grid's kref; past 1022 (the edges up to
    3070, whose dense aref is 75 MB in float64): a cluster with the
    grid's kref."""
    esize = dtype.itemsize
    for nz in range(1, 255):
        aref = _aref(nz, 250.0, dscale > 0, dscale or 2.0)
        kref = int(ck.row_extents(aref).max()) + 1
        g = ck.launch_geometry(nz, dtype, 37, kref)
        assert g.kref == kref
        if nz + 2 > 128:
            _check_pw(g, nz, dtype, 37)
            continue
        assert g.ns == _fewest_slots(nz) and g.aref_dev == 0
        assert g.smem == ck.smem_bytes(g.ns, kref, g.warps, esize) \
            <= ck.SMEM_MAX
        assert g.warps == 8 or \
            ck.smem_bytes(g.ns, kref, 2 * g.warps, esize) > ck.SMEM_MAX
    # past 254: the edges of each warp count, and every 7th nz between
    edges = {128 * cw + d for cw in range(3, 9) for d in (-3, -2, -1)}
    for nz in sorted((edges - {1023}) | set(range(255, 1023, 7))):
        aref = _aref(nz, 250.0, dscale > 0, dscale or 2.0)
        kref = int(ck.row_extents(aref).max()) + 1
        g = ck.launch_geometry(nz, dtype, 37, kref)
        assert g.kref == kref
        _check_mw(g, nz, dtype, 37)
    for nz in CL_EDGES[:-1]:
        aref = _aref(nz, 250.0, dscale > 0, dscale or 2.0)
        kref = int(ck.row_extents(aref).max()) + 1
        g = ck.launch_geometry(nz, dtype, 37, kref)
        assert g.kref == kref
        _check_cl(g, nz, dtype, 37)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [69, 94, 95, 100, 126, 127, 190, 191, 254,
                                255, 383, 510, 1022, 1023, 2000, 2046, 3070,
                                8190, 8191])
def test_level_slots(dtype, nz):
    """The slots, warps and shared memory a launch takes at the levels of
    the five configurations and at the edges of each instantiation: 3
    slots up to nz 94 (WZ 96), 4 up to nz 126 (WZ 128); then a column over
    a pair of warps of 3 slots up to nz 190 (WZ 192) and of 4 up to nz 254
    (WZ 256), its columns a block and shared memory pinned below, aref
    from device memory; past it one column a block over 3
    warps of 4 slots (nz 255 up to 382), 4 (nz 383 to 510), ... 8 (nz
    1022, WZ 1024), its shared memory pinned below; past it a cluster of
    blocks (nz 1023: 2 of 5 warps; 2000 and 2046: 2 of 8; 3070: 3 of 8;
    8190: 8 of 8), pinned below; a raise naming the limit at 8191.  With
    aref's real prefix (kref of a uniform grid) a one-warp block keeps 8
    warps; with aref kept whole a block takes fewer where 8 do not fit."""
    if nz == 8191:
        with pytest.raises(ValueError, match=r"nz\+2=8193 .*8192 levels"):
            ck.launch_geometry(nz, dtype, 37)
        return
    esize = dtype.itemsize
    if nz > 1022:
        cb, cw, smem = CL_GEOMETRY[esize, nz]
        for kref in (nz + 2, 40):
            g = ck.launch_geometry(nz, dtype, 37, kref)
            assert (g.ns, g.cb, g.cw, g.warps, g.blocks) == \
                (4, cb, cw, cw, 37 * cb)
            assert (g.aref_dev, g.grid_dev, g.smem, g.kref) == \
                (1, 1, smem, kref)
        return
    kref = int(ck.row_extents(_aref(nz, 1000.0, False)).max()) + 1
    g = ck.launch_geometry(nz, dtype, 37, kref)
    if 126 < nz <= 254:
        ns, warps, smem = PW_GEOMETRY[esize, nz]
        for geom in (g, ck.launch_geometry(nz, dtype, 37)):
            assert (geom.ns, geom.cw, geom.warps, geom.cb) == (ns, 2, warps, 1)
            assert (geom.blocks, geom.aref_dev, geom.grid_dev, geom.smem) == \
                (-(-37 // (warps // 2)), 1, 0, smem)
        return
    if nz > 254:
        cw, grid_dev, smem = MW_GEOMETRY[esize, nz]
        assert (g.ns, g.cw, g.warps, g.blocks, g.kref) == (4, cw, cw, 37, kref)
        assert (g.aref_dev, g.grid_dev, g.smem) == (1, grid_dev, smem)
        worst = ck.launch_geometry(nz, dtype, 37)
        assert (worst.cw, worst.grid_dev, worst.smem) == (cw, grid_dev, smem)
        return
    assert g.ns == _fewest_slots(nz)
    assert (g.warps, g.blocks, g.aref_dev) == (8, -(-37 // 8), 0)
    assert g.smem == ck.smem_bytes(g.ns, kref, 8, esize) <= ck.SMEM_MAX
    worst = ck.launch_geometry(nz, dtype, 37)
    assert (worst.warps, worst.aref_dev) == (WORST[dtype.itemsize, nz], 0)
    assert worst.smem == ck.smem_bytes(g.ns, nz + 2, worst.warps, esize) \
        <= ck.SMEM_MAX
    assert worst.warps == 8 or \
        ck.smem_bytes(g.ns, nz + 2, 2 * worst.warps, esize) > ck.SMEM_MAX


# warps a block with aref kept whole (kref = nz + 2), by element size and
# nz (the shared copy always fits beside one warp up to 128 levels)
WORST = {(4, nz): 8 for nz in (69, 94, 95, 100, 126)}
WORST.update({(8, 69): 8, (8, 94): 8, (8, 95): 4, (8, 100): 4, (8, 126): 2})
# (level slots, warps a block, shared-memory bytes) of a column over a pair
# of warps, by element size and nz: float32 8 columns a block, float64 4;
# a column holds 24 rows of 64 ns levels, 48 column values and 43 cells
PW_GEOMETRY = {(4, 127): (3, 16, 155_744), (4, 190): (3, 16, 155_744),
               (4, 191): (4, 16, 206_688), (4, 254): (4, 16, 206_688),
               (8, 127): (3, 8, 160_352), (8, 190): (3, 8, 160_352),
               (8, 191): (4, 8, 212_832), (8, 254): (4, 8, 212_832)}
# (warps a column, grid_dev, shared-memory bytes) past 254 levels, by
# element size and nz: float64 at 8 warps reads the grid rows from device
# memory (250,584 B with them in shared memory, over SMEM_MAX); a column
# holds 24 rows (23 and the second PCR buffer's fifth, X5)
MW_GEOMETRY = {(4, 255): (3, 0, 47_980), (4, 383): (4, 0, 63_852),
               (4, 510): (4, 0, 63_852), (4, 1022): (8, 0, 127_340),
               (8, 255): (3, 0, 94_424), (8, 383): (4, 0, 125_656),
               (8, 510): (4, 0, 125_656), (8, 1022): (8, 1, 201_432)}
# (blocks of the cluster, warps a block, shared-memory bytes a block) past
# 1022 levels, by element size and nz: a block holds 24 rows of its 128 cw
# levels, 48 column values, 45 cells and its levels' row extents
CL_GEOMETRY = {(4, 1023): (2, 5, 64_372), (4, 2000): (2, 8, 102_772),
               (4, 2046): (2, 8, 102_772), (4, 3070): (3, 8, 102_772),
               (4, 8190): (8, 8, 102_772),
               (8, 1023): (2, 5, 126_184), (8, 2000): (2, 8, 201_448),
               (8, 2046): (2, 8, 201_448), (8, 3070): (3, 8, 201_448),
               (8, 8190): (8, 8, 201_448)}


def test_geometry_constants_match_the_source():
    """launch_geometry mirrors csrc/fused_pass.cuh's shared-memory layout:
    the slot count, the column values, the level slots, the most warps a
    block takes, a pair column's warps and a block's most columns, and the
    Geometry struct (aref's placement last)."""
    with open(ck._CSRC + "/fused_pass.cuh") as f:
        src = f.read()
    slots = src[src.index("  B_U = 0,"):src.index(", NB\n")]
    assert len(re.findall(r"B_\w+", slots)) == ck.N_SLOTS
    assert "constexpr int NCV = NSC + 16;" in src and ck.N_COLV == 32 + 16
    assert "constexpr int NS_MAX = 4;" in src and ck.SLOTS == (3, 4)
    assert "constexpr int MW_NS = 4;" in src and ck.MW_NS == 4
    assert "constexpr int CW_MAX = 8;" in src and ck.WARPS == 8
    assert "constexpr int ONE_BLOCK_WZ = 32 * MW_NS * CW_MAX;" in src
    assert "constexpr int CB_MAX = 8;" in src and ck.CB_MAX == 8
    assert "constexpr int MAXWZ = ONE_BLOCK_WZ * CB_MAX;" in src
    assert ck.MAXWZ == 8192 and ck.ONE_BLOCK_WZ == 1024
    assert ck.ONE_WARP_WZ == 128 and ck.PAIR_WZ == 256
    # a column over a pair of warps: 2 warps, at most 8 columns a block
    # (named barriers 1..8 of the 16), its block's bytes
    assert "constexpr int PW_CW = 2;" in src and ck.PW_CW == 2
    assert "constexpr int PW_COLS_MAX = 8;" in src and \
        max(ck.PW_COLS.values()) <= 8
    assert ck.PAIRS == ("pw3", "pw4")
    assert "return size_t(6 * lz + cols * col_stride(lz)) * tsize" in src
    assert "KPP_DEV int pair_bar() { return 1 + int(threadIdx.x >> 6); }" \
        in src
    cells = src[src.index("  BC_RHO0 = 0,"):src.index("NBC = ")]
    # 11 single cells, 9 for blmix's matching, 3 enhance, a crossing and
    # its hmin per warp, 4 RMSD sums
    assert "BC_ENH = BC_MATCH + 9," in cells and \
        "BC_FX = BC_ENH + 3, BC_HX = BC_FX + CW_MAX, " \
        "BC_RMSD = BC_HX + CW_MAX," in src and "NBC = BC_RMSD + 4" in src
    # the single cells, then BC_MATCH
    assert len(re.findall(r"BC_\w+", cells.split("BC_ENH")[0])) == 11 + 1
    assert ck.N_BC == 11 + 9 + 3 + 8 + 8 + 4
    # a column over warps or a cluster: one more row (X5)
    assert "enum { B_X5 = NB, NB_MW };" in src and \
        ck.N_SLOTS_MW == ck.N_SLOTS + 1
    assert "KPP_HD int col_stride(int lz) { return NB_MW * lz + NCV + NBC; }" \
        in src
    # the cluster's cells after them: a block's column AND and count
    assert "enum { BC_AND = NBC, BC_CNT, NBC_CL };" in src
    assert ck.N_BC_CL == ck.N_BC + 2
    assert "return size_t(NB_MW * lb + NCV + NBC_CL) * tsize" in src
    assert "int warps, blocks, kref, smem, ns, aref_dev, cw, grid_dev, cb;" \
        in src
    assert [f[0] for f in ck.Geometry._fields_] == \
        ["warps", "blocks", "kref", "smem", "ns", "aref_dev", "cw",
         "grid_dev", "cb"]
    assert all(f[1] is ctypes.c_int for f in ck.Geometry._fields_)
    with open(ck._CSRC + "/fused_kernels.cu") as f:
        ker = f.read()
    assert "constexpr int MAX_WARPS = 8;" in ker
    assert ck.WARPS == 8
    assert "constexpr int SMEM_MAX = 232448;" in ker and \
        ck.SMEM_MAX == 232_448
    assert "in->aref_t = static_cast<const Real*>(ip[kpp::N_IN + 1]);" in ker
    assert "in->grid_t = static_cast<const Real*>(ip[kpp::N_IN + 2]);" in ker
    assert "  if (MWL == kpp::PAIR) return 32 * kpp::PW_CW * NSL;\n" \
           "  return 32 * NSL * (MWL ? kpp::CW_MAX : 1)\n" \
           "         * (MWL == kpp::CLUSTER ? kpp::CB_MAX : 1);" in ker
    assert "G.warps <= PW_CW * PW_COLS_MAX" in ker
    assert "constexpr int KPP_NO_CLUSTER = -2;" in ker and \
        ck.NO_CLUSTER == -2
    assert "AREF_DEV_MIN_NS" not in src + ker   # one warp: aref shared


def test_stage_marks_match_chip_phases():
    """csrc/fused_pass.cuh holds the stage clocks chip_phases.py names:
    KPP_MARK(i) once for each stage of the pass body, KPP_BMARK(10 + i)
    once in each of pass_block and step_block, the clocks they read, and
    the library exports that return the sums."""
    import chip_phases
    with open(ck._CSRC + "/fused_pass.cuh") as f:
        src = f.read()
    marks = [int(i) for i in re.findall(r"^\s*KPP_MARK\((\d+)\);", src, re.M)]
    assert sorted(marks) == list(range(len(chip_phases.STAGES)))
    bmarks = [int(i) for i in re.findall(r"^\s*KPP_BMARK\((\d+)\);", src, re.M)]
    assert sorted(bmarks) == sorted(2 * [10 + i for i in range(len(chip_phases.BLOCK))])
    assert len(re.findall(r"^\s*KPP_CLOCK\(kpp_t0\);", src, re.M)) == 2
    assert len(re.findall(r"^\s*KPP_CLOCK\(kpp_b0\);", src, re.M)) == 2
    for body in ("pass_block", "step_block"):
        i0 = src.index(f"KPP_DEV void {body}(")
        text = src[i0:src.index("\n}\n", i0)]
        assert [int(i) for i in re.findall(r"KPP_BMARK\((\d+)\)", text)] == \
            [10, 11, 12, 13], body
    with open(ck._CSRC + "/fused_kernels.cu") as f:
        ker = f.read()
    tail = ker[ker.index("#ifdef KPP_PHASES"):]
    assert "int kpp_phase_read(" in tail and "int kpp_phase_zero(" in tail


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_graph_chain_matches_eager_chain(tmp_path, cuda, wide):
    """models/chain.py on the card: the spans replayed as CUDA graphs give
    the eager chain's state and emitted windows bit for bit, with and
    without a reducing stream that samples a wide field; the replays
    count the kernel launches they issue."""
    from scipy.io import netcdf_file
    from mckpp_torch.io.diagnostics import DiagnosticsManager, Stream
    from mckpp_torch.models import chain

    ck.build((torch.float32,))

    def run(graphs, out):
        m, st, prm, frc = model(19, "cuda_step", cuda)
        streams = [Stream("i", "instant", 2, fields=("T", "hmix", "difs")),
                   Stream("mean", "average", 4, fields=("S", "hmix")),
                   Stream("min", "minimum", 4,
                          fields=("difm",) if wide else ("T",))]
        diag = DiagnosticsManager(streams, 19, 1, m.grid.zm, outdir=str(out),
                                  dto_seconds=m.cfg.time.dto,
                                  async_write=False)
        stepper = chain.ChainedStepper(m._step, diag, graphs=graphs)

        def end(nt):
            return (chain.emit_due(diag, nt)
                    or (diag.needs_full(nt) and not stepper.wide_reducing))

        for nt0, k in chain.plan_segments(9, ndtocn=3, end_pred=end):
            st = stepper.run(nt0, k, st, prm, frc)
        return st, diag.flush(), stepper

    st_e, paths_e, _ = run(False, tmp_path / "e")
    ck.reset_counts()
    st_g, paths_g, stepper = run(True, tmp_path / "g")
    assert stepper.captures >= 1 and stepper.replays >= stepper.captures
    assert ck.LAUNCHES["fused_step"] >= 9
    for name in st_e.__dataclass_fields__:
        assert torch.equal(getattr(st_e, name), getattr(st_g, name)), name
    assert set(paths_e) == set(paths_g)
    for key in paths_e:
        with netcdf_file(paths_e[key], "r", mmap=False) as a, \
                netcdf_file(paths_g[key], "r", mmap=False) as b:
            for v in a.variables:
                np.testing.assert_array_equal(np.asarray(a.variables[v][:]),
                                              np.asarray(b.variables[v][:]),
                                              err_msg=f"{key}:{v}")
