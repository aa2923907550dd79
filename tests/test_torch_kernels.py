"""The CUDA kernels of mckpp_torch against their plain torch versions.

Tests marked ``gpu`` need a CUDA card and skip without one; on the card
they build the kernels and hold each to its plain version at small
shapes.  ``python3 chip_smoke.py`` holds them at the main path's shapes.
The other tests check, on the CPU, how the launch wrappers route and
validate their inputs.
"""

import ctypes

import numpy as np
import pytest
import torch

import mckpp_torch as T
from mckpp_torch import forcing as tforcing
from mckpp_torch.grid import coriolis
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.ops import fused_pass as fp
from mckpp_torch.state import init_params

NZ = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def model(ncol, pass_impl, device, dtype="float32", **boundary):
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=NZ, dmax=120.0),
        time=T.TimeConfig(dtsec=1200.0, ndtocn=1, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(pass_impl=pass_impl, wscale_mode="nodal"),
        boundary=T.BoundaryConfig(**boundary), dtype=dtype)
    m = T.KppModel(cfg, device=device)
    zm = m.grid.zm.double().cpu().numpy()
    rng = np.random.default_rng(1)
    t0 = 20.0 + 5.0 * np.exp(zm / 40.0) + 0.05 * rng.standard_normal((ncol, NZ + 1))
    s0 = 35.0 - 0.3 * np.exp(zm / 60.0) + 0.01 * rng.standard_normal((ncol, NZ + 1))
    u0 = 0.02 * rng.standard_normal((ncol, NZ + 1, 2))
    prm = init_params(ncol, NZ + 1, dtype=m.dtype, device=m.device)
    lat = torch.linspace(-40.0, 40.0, ncol, dtype=m.dtype, device=m.device)
    prm = prm.replace(f=coriolis(lat))
    st, prm, frc = m.warm_start(u0, t0, s0, prm)
    raw = tforcing.constant_test_fluxes(ncol, m.dtype, m.device)
    st, frc = tforcing.update_fluxes(cfg, st, prm, frc, raw, True, m.grid.dm)
    return m, st, prm, frc


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("ncol", [5, 130])
def test_kernels_match_plain(cuda, monkeypatch, dtype, tol, ncol):
    names = set()
    for impl in ("cuda", "cuda_step"):
        m, st, prm, frc = model(ncol, impl, cuda, dtype, l_advect=False)
        rec = Recorder(monkeypatch)
        m.step(st, prm, frc, first_step=True)
        for w, a in rec.calls:
            got = w.launch(*a)
            body = fp._pass_body if isinstance(w, ck.FusedPass) else fp._step_body
            ref = body(*a, **w.kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                rel = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-6)
                assert rel <= tol, (w.name, rel)
            names.add(w.name)
        monkeypatch.undo()
    assert names == {"fused_pass_fast", "fused_pass_full", "fused_step"}


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
