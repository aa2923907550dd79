"""The CUDA kernels of mckpp_torch against their plain torch versions.

Tests marked ``gpu`` need a CUDA card and skip without one; on the card
they build the kernels and hold each to its plain version at small
shapes.  ``python3 chip_smoke.py`` holds them at the main path's shapes.
The other tests check, on the CPU, how the launch wrappers route and
validate their inputs, the launch geometry, the reference-average row
extents and the operation count the bounds are computed from.
"""

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


def model(ncol, pass_impl, device, dtype="float32", nz=NZ, **boundary):
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=120.0),
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


def mixed_block(device, dtype):
    """One 8-column block (the kernels' WARPS) mixing a land column (3), a
    column the instability trap retries (large T and u noise on columns 1
    and 6; column 1 ends with comp_flag 1 after 11 attempts) and columns
    whose pass counts differ by >= 3."""
    m, st, prm, frc = model(8, "cuda_step", device, dtype)
    rng = np.random.default_rng(2)
    x, u = st.x.clone(), st.u.clone()
    for col in (1, 6):
        x[col, :, 0] += torch.as_tensor(3.0 * rng.standard_normal(NZ + 1),
                                        dtype=x.dtype, device=x.device)
        u[col] += torch.as_tensor(2.1 * rng.standard_normal((NZ + 1, 2)),
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

            def call(w, *a, _orig=orig):
                self.calls.append((w, a))
                return _orig(w, *a)
            monkeypatch.setattr(cls, "__call__", call)


# integer-valued rows of each kernel's per-column output: (output, rows)
INT_ROWS = {"fused_pass_fast": (8, (1,)), "fused_pass_full": (4, (1,)),
            "fused_step": (8, (1, 4, 5, 7))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("ncol,nz", [(5, NZ), (130, NZ), (13, NZ),
                                     ("mixed_block", NZ), (37, 100),
                                     (1, 100), (13, 126)])
def test_kernels_match_plain(cuda, monkeypatch, dtype, tol, ncol, nz):
    """5, 130 and 13 leave a ragged last 8-column block; "mixed_block" is
    one block of a land column, a trap column and uneven pass counts;
    nz = 100 and 126 run the kernels at 4 level slots (single_column's
    levels, and the most they take)."""
    names = set()
    for impl in ("cuda", "cuda_step"):
        if ncol == "mixed_block":
            m, st, prm, frc = mixed_block(cuda, dtype)
            m = model(8, impl, cuda, dtype)[0]
        else:
            m, st, prm, frc = model(ncol, impl, cuda, dtype, nz=nz,
                                    l_advect=False)
        rec = Recorder(monkeypatch)
        m.step(st, prm, frc, first_step=True)
        for w, a in rec.calls:
            assert ck.launch_geometry(
                nz, a[0].dtype, a[0].shape[1]).ns == (3 if nz <= 94 else 4)
            got = w.launch(*a)
            body = fp._pass_body if isinstance(w, ck.FusedPass) else fp._step_body
            ref = body(*a, **w.kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                rel = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-6)
                assert rel <= tol, (w.name, rel)
            pos, rows = INT_ROWS[w.name]
            for row in rows:
                assert torch.equal(got[pos][row], ref[pos][row]), (w.name, row)
            names.add(w.name)
        monkeypatch.undo()
    assert names == {"fused_pass_fast", "fused_pass_full", "fused_step"}


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
                           "fused_step": 1}
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


def _aref(nz, dmax, stretch):
    """The reference-average matrix as ops/ocnstep_fused builds it."""
    g = make_vertical_grid(nz, dmax, 1200.0, stretch=stretch, dscale=2.0)
    zm = np.pad(g.zm.numpy(), (0, 1))
    return fp.build_ref_matrix(zm[:nz + 1], nz + 2).T


@pytest.mark.parametrize("stretch", [False, True])
@pytest.mark.parametrize("dmax", [120.0, 1000.0])
@pytest.mark.parametrize("nz", [12, 33, 40, 65, 69, 94])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_geometry(dtype):
    """Every nz the kernels take fits one block's shared memory with aref
    kept whole (the worst case), on the fewest level slots that cover
    nz + 2, and the grid covers every ncol exactly; past 128 levels the
    geometry raises."""
    for nz in range(1, 127):
        for kref in (None, 0, 9):
            if kref is not None and kref > nz + 2:
                continue
            for ncol in (1, 7, 37, 129, 144_507):
                g = ck.launch_geometry(nz, dtype, ncol, kref)
                assert g.ns == (3 if nz + 2 <= 96 else 4)
                assert g.smem <= 232_448
                assert g.smem == ck.smem_bytes(g.ns, g.kref, g.warps,
                                               dtype.itemsize)
                assert 1 <= g.warps <= 8 and g.warps == g.cols_per_block
                assert g.blocks * g.cols_per_block >= ncol
                assert (g.blocks - 1) * g.cols_per_block < ncol
    with pytest.raises(ValueError, match="128 levels"):
        ck.launch_geometry(127, dtype, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [69, 94, 95, 100, 126, 127])
def test_level_slots(dtype, nz):
    """The slots, warps and shared memory a launch takes at the levels of
    the five configurations and at the edges of each instantiation: 3
    slots up to nz 94 (WZ 96), 4 up to nz 126 (WZ 128), a raise naming
    the limit at 127.  With aref's real prefix (kref of the grid) a block
    keeps 8 warps; float64 at 4 slots with aref kept whole takes fewer."""
    if nz == 127:
        with pytest.raises(ValueError, match=r"nz\+2=129 .*128 levels"):
            ck.launch_geometry(nz, dtype, 37)
        return
    esize = dtype.itemsize
    kref = int(ck.row_extents(_aref(nz, 1000.0, False)).max()) + 1
    g = ck.launch_geometry(nz, dtype, 37, kref)
    assert g.ns == (3 if nz <= 94 else 4)
    assert (g.warps, g.blocks) == (8, 5)
    assert g.smem == ck.smem_bytes(g.ns, kref, 8, esize) <= ck.SMEM_MAX
    worst = ck.launch_geometry(nz, dtype, 37)
    if dtype == torch.float64 and g.ns == 4:
        assert worst.warps == (4 if nz + 2 <= 102 else 2)
        assert ck.smem_bytes(4, nz + 2, 8, esize) > ck.SMEM_MAX
    else:
        assert worst.warps == 8
    assert worst.smem <= ck.SMEM_MAX


def test_geometry_constants_match_the_source():
    """launch_geometry mirrors csrc/fused_pass.cuh's shared-memory layout:
    the slot count, the column values, the level slots and the most
    warps a block takes."""
    with open(ck._CSRC + "/fused_pass.cuh") as f:
        src = f.read()
    slots = src[src.index("  B_U = 0,"):src.index(", NB\n")]
    assert len(re.findall(r"B_\w+", slots)) == ck.N_SLOTS
    assert "constexpr int NCV = NSC + 16;" in src and ck.N_COLV == 32 + 16
    assert "constexpr int NS_MAX = 4;" in src and ck.SLOTS[-1] == 4
    assert ck.MAXWZ == 128
    assert "int warps, blocks, kref, smem, ns;" in src
    assert [f[0] for f in ck.Geometry._fields_] == \
        ["warps", "blocks", "kref", "smem", "ns"]
    with open(ck._CSRC + "/fused_kernels.cu") as f:
        ker = f.read()
    assert "constexpr int MAX_WARPS = 8;" in ker
    assert ck.WARPS == 8
    assert "constexpr int SMEM_MAX = 232448;" in ker and \
        ck.SMEM_MAX == 232_448


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
