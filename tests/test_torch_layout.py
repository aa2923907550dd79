"""The kernels' two layouts, ``pass_layout`` "col_lanes" (``zaxis=0``,
profiles ``(nz + 2, ncol)``) and "z_lanes" (``zaxis=1``, profiles
``(ncol, nz + 2)``, the state's own order), in float64 at small shapes.

On the CPU:

* the port's ``zaxis=1`` fast pass, full pass and step (the plain bodies)
  against the JAX package's ``make_fused_pass`` / ``make_fused_step(impl=
  "xla", zaxis=1)`` on the inputs of tests/test_torch_fused_pass.py and
  tests/test_torch_step.py transposed, at those files' bar (rtol 1e-12):
  default flags and advection, a land column, the instability trap;
* the port's ``zaxis=1`` against its ``zaxis=0`` on the same inputs, bit
  for bit;
* the launch wrappers' input check on arrays of the other layout, ncol =
  nz + 2 included.

tests/test_torch_layout_model.py holds the layouts' ``KppModel``
trajectories (a file of its own, so that the test workers take the JAX
compiles apart).

On the card (``gpu``, skipped here): the z_lanes kernels against the
col_lanes kernels on the same inputs transposed, bit for bit, in each
spread (one warp at 3 and 4 slots, a pair of warps at 3 and 4, a column
over a block's warps
and over a cluster) and dtype, and against the z_lanes plain version at
``chip_smoke.py``'s bar.  JAX is imported inside the fixtures that use
it, so on the card's machine, which has no JAX, those cases skip and the
kernel cases run (``python -m pytest --noconftest -o addopts='' -q
tests/test_torch_layout.py``).  tests/test_torch_cluster_emulation.py
holds the z_lanes staging to the col_lanes one bit for bit on the CPU,
through a host emulation of the kernels.
"""

import types

import numpy as np
import pytest
import torch

from mckpp_torch import grid as tgrid
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.ops import fused_pass as tfp

from test_torch_kernels import INT_ROWS, Recorder, cuda, model  # noqa: F401

RTOL = 1e-12            # tests/test_torch_fused_pass.py, test_torch_step.py


def transposed(arrays):
    """zaxis=0 arguments as zaxis=1 takes them: every array transposed
    (aref too: the col_lanes one is the transpose of build_ref_matrix)."""
    return tuple(np.ascontiguousarray(np.asarray(a).T) for a in arrays)


@pytest.fixture(scope="module")
def jx():
    """The JAX package and the parity tests' input builders, imported
    here: the card's machine has no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import mckpp_tpu as J
    from mckpp_tpu.ops import fused_pass as jfp
    import test_torch_fused_pass as tpass
    import test_torch_step as tstep
    return types.SimpleNamespace(jnp=jnp, J=J, jfp=jfp, tpass=tpass,
                                 tstep=tstep)


def close(got, ref, what):
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()),
                                   err_msg=f"{what} output {i}")


@pytest.fixture(scope="module")
def pass_bodies(jx):
    """The JAX zaxis=1 fast and full pass bodies (one compile each) with
    advection on, and the port's in both layouts."""
    tp = jx.tpass
    flags = dict(l_advect=True)
    g = jx.J.make_vertical_grid(tp.NZ, tp.DMAX, tp.DTO)
    tg = tgrid.make_vertical_grid(tp.NZ, tp.DMAX, tp.DTO)
    out = {}
    for full in (False, True):
        out[full] = (
            jx.jfp.make_fused_pass(g, tp.NCOL, jx.jnp.float64,
                                   jx.jfp.PassFlags(**flags), tp.DTO,
                                   full=full, impl="xla", zaxis=1),
            tfp.make_fused_pass(tg, torch.float64, tfp.PassFlags(**flags),
                                tp.DTO, full=full, impl="eager", zaxis=1),
            tfp.make_fused_pass(tg, torch.float64, tfp.PassFlags(**flags),
                                tp.DTO, full=full, impl="eager", zaxis=0))
    return out


@pytest.mark.parametrize("full", [False, True], ids=["fast", "full"])
@pytest.mark.parametrize("case", ["default", "advect"])
def test_pass_z_lanes_matches_jax(jx, pass_bodies, case, full):
    """The zaxis=1 pass against JAX's zaxis=1 body, and against the port's
    zaxis=0 pass transposed, bit for bit; advection corrections are on in
    both cases, with zero magnitudes in "default"."""
    tp = jx.tpass
    flags = tfp.PassFlags(l_advect=case == "advect")
    arrays, _ = tp.pass_inputs(1 if full else 2, flags)
    z1 = transposed(arrays)
    jbody, tbody1, tbody0 = pass_bodies[full]
    ref = jbody(*(jx.jnp.asarray(a) for a in z1))
    got = tbody1(*(torch.tensor(a) for a in z1))
    cols = tbody0(*(torch.tensor(a) for a in arrays))
    assert len(got) == len(ref) == (23 if full else 9)
    assert got[4 if full else 8].shape == (tp.NCOL, 16 if full else 8)
    close(got, ref, "pass")
    for i, (a, b) in enumerate(zip(got, cols)):
        assert torch.equal(a, b.T), i


@pytest.fixture(scope="module")
def step_bodies(jx):
    """The JAX zaxis=1 step body (one compile), advection on, and the
    port's in both layouts."""
    ts = jx.tstep
    flags = dict(l_advect=True)
    kw = dict(itermax=200, hmixtolfrac=0.1, extra_iters=40, impl="xla")
    jbody = jx.jfp.make_fused_step(
        jx.J.make_vertical_grid(ts.NZ, ts.DMAX, ts.DTO), ts.NCOL,
        jx.jnp.float64, jx.jfp.PassFlags(**flags), ts.DTO, zaxis=1, **kw)
    tg = tgrid.make_vertical_grid(ts.NZ, ts.DMAX, ts.DTO)
    kw["impl"] = "eager"
    return (jbody,) + tuple(
        tfp.make_fused_step(tg, torch.float64, tfp.PassFlags(**flags),
                            ts.DTO, zaxis=z, **kw) for z in (1, 0))


@pytest.mark.parametrize("case", ["default", "advect", "trap"])
def test_step_z_lanes_matches_jax(jx, step_bodies, case):
    """The zaxis=1 step (column 2 land; "trap": column 0 retried to the
    trap's limit) against JAX's zaxis=1 body at tests/test_torch_step.py's
    bar (colstep rows 0-6; row 7 is the port's pass count), and against
    the port's zaxis=0 step transposed, bit for bit."""
    arrays, _ = jx.tstep.step_inputs(case)
    z1 = transposed(arrays)
    jbody, tbody1, tbody0 = step_bodies
    ref = [np.asarray(a) for a in jbody(*(jx.jnp.asarray(a) for a in z1))]
    got = tbody1(*(torch.tensor(a) for a in z1))
    cols = tbody0(*(torch.tensor(a) for a in arrays))
    close(got[:8], ref[:8], "step")
    np.testing.assert_allclose(got[8][:, :7].numpy(), ref[8][:, :7],
                               rtol=RTOL, atol=1e-14, err_msg="colstep")
    for i, (a, b) in enumerate(zip(got, cols)):
        assert torch.equal(a, b.T), i
    cs = got[8].numpy()
    assert cs[2, 7] == 0 and (cs[[0, 1, 3, 4], 7] >= 4).all()
    if case == "trap":
        assert cs[0, 4] == 1.0 and cs[0, 5] == 11.0, cs[0]


def wrapper_inputs(monkeypatch, ncol, kernel):
    """The wrapper and (col_lanes) inputs of ``kernel``'s first call in a
    float64 CPU step at NZ = 12 over ``ncol`` columns."""
    impl = "cuda_step" if kernel == "fused_step" else "cuda"
    m, st, prm, frc = model(ncol, impl, "cpu", dtype="float64")
    rec = Recorder(monkeypatch)
    m.step(st, prm, frc, first_step=True)
    monkeypatch.undo()
    return next((w, a) for w, a in rec.calls if w.name == kernel)


@pytest.mark.parametrize("kernel,n_prof", [("fused_pass_fast", 12),
                                           ("fused_step", 8)])
@pytest.mark.parametrize("ncol", [5, 14], ids=["ncol5", "ncol_eq_wz"])
def test_check_refuses_the_other_layout(monkeypatch, ncol, kernel, n_prof):
    """``_check`` takes the layout from the wrapper: col_lanes arrays pass
    a col_lanes wrapper and raise in a z_lanes one, and the other way
    round, also at ncol = nz + 2 = 14, where a profile is square (the grid
    rows and dummies tell the layouts apart); a z_lanes wrapper launched
    on them raises before any kernel (on the CPU the launch would need a
    card)."""
    w, a = wrapper_inputs(monkeypatch, ncol, kernel)
    wz = w.kw["nz"] + 2
    kw1 = dict(w.kw, zaxis=1)
    a1 = tuple(x.T.contiguous() for x in a)
    assert ck._check(a, w.kw, n_prof) == (ncol, torch.float64)
    assert ck._check(a1, kw1, n_prof) == (ncol, torch.float64)
    with pytest.raises(ValueError):
        ck._check(a, kw1, n_prof)
    with pytest.raises(ValueError):
        ck._check(a1, w.kw, n_prof)
    with pytest.raises(ValueError):
        type(w)(kw1).launch(*a)
    bad = list(a1)
    bad[n_prof + 6] = a[n_prof + 6]              # colscal (NSC, ncol)
    if ncol != tfp.NSC:
        with pytest.raises(ValueError):
            ck._check(bad, kw1, n_prof)
    bad = list(a1)
    bad[n_prof + 2] = torch.zeros((wz, 1), dtype=torch.float64)  # dummy
    with pytest.raises(ValueError):
        ck._check(bad, kw1, n_prof)
    with pytest.raises(ValueError):
        ck._check(a, dict(w.kw, zaxis=2), n_prof)


def test_kernel_aref_is_made_once():
    """The z_lanes aref reaches the kernels transposed into the col_lanes
    form, one tensor per aref (so the row extents' cache hits on every
    launch, inside a captured graph too); col_lanes' passes as given."""
    a = torch.rand(14, 14, dtype=torch.float64)
    t = ck._kernel_aref(a, 1)
    assert t.is_contiguous() and torch.equal(t, a.T)
    assert ck._kernel_aref(a, 1) is t
    assert ck._kernel_aref(a, 0) is a
    a.mul_(2.0)                                   # a new version: remade
    assert torch.equal(ck._kernel_aref(a, 1), a.T)


def test_lib_names_carry_the_layout():
    assert ck._lib_tag(3) == "ns3" and ck._lib_tag(ck.CL, 1) == "cl_zl"
    assert ck._lib_path(torch.float32, 3) != ck._lib_path(torch.float32, 3,
                                                           zaxis=1)


# each spread of the kernels: (nz, dscale) whose launch takes it
GPU_SPREADS = {"ns3": (12, 0.0), "ns4": (100, 0.0), "pw3": (190, 0.0),
               "pw4": (254, 5.0), "cw": (383, 5.0), "cl": (1023, 0.0)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("spread", list(GPU_SPREADS))
def test_z_lanes_kernels_equal_col_lanes(cuda, monkeypatch, dtype, tol,
                                         spread):
    """Each kernel's z_lanes build on the col_lanes inputs of a step's
    first launches (13 columns, a ragged last block, column 3 land),
    transposed: equal to the col_lanes kernel transposed bit for bit;
    the fast pass and the step also held to the z_lanes plain version
    (the reference averages summed serially, as the kernels sum them) at
    ``tol`` with the integer rows equal."""
    from test_torch_kernels import serial_sums
    nz, dscale = GPU_SPREADS[spread]
    assert ck._lib_tag(ck.launch_geometry(nz, getattr(torch, dtype),
                                          13).lib) == spread
    seen = set()
    for impl in ("cuda", "cuda_step"):
        m, st, prm, frc = model(13, impl, cuda, dtype, nz, dscale)
        wet = torch.ones(13, dtype=torch.bool, device=cuda)
        wet[3] = False
        rec = Recorder(monkeypatch)
        m.step(st, prm.replace(l_ocean=wet, run_physics=wet), frc,
               first_step=True)
        monkeypatch.undo()
        for w, a in rec.calls:
            if w.name in seen:
                continue
            seen.add(w.name)
            wz_ = type(w)(dict(w.kw, zaxis=1))
            a1 = tuple(x.T.contiguous() for x in a)
            ck.reset_counts()
            got, ref = wz_.launch(*a1), w.launch(*a)
            assert ck.LAUNCHES[w.name] == 2
            torch.cuda.synchronize()
            for i, (x, y) in enumerate(zip(got, ref)):
                assert torch.equal(x, y.T), (w.name, i)
            if w.name == "fused_pass_full":
                continue
            body = (tfp._pass_body if isinstance(w, ck.FusedPass)
                    else tfp._step_body)
            with serial_sums():                  # on the card
                plain = body(*a1, **wz_.kw)
            torch.cuda.synchronize()
            pos, rows = INT_ROWS[w.name]
            for x, y in zip(got, plain):
                rel = float((x - y).abs().max()) / max(float(y.abs().max()),
                                                       1e-6)
                assert rel <= tol, (w.name, rel)
            for r in rows:
                assert torch.equal(got[pos][:, r], plain[pos][:, r])
    assert seen == set(INT_ROWS)
