"""The fused step's glue (``mckpp_torch/ops/step_glue.py``): the prologue
before the whole-step kernel and the epilogue after it.

On the CPU, at a few hundred columns: the plain ``glue_in`` and the
epilogue through ``glue_out`` are bit-equal to the step's glue as it was
written before the kernels (frozen below, from ``ops/ocnstep_fused.py``
and ``models/column_model.py``), over both layouts, the damping, freezing
floor, bottom pin and climatology flags, land columns, lazy and full
steps; a configuration with ``l_no_isotherm`` keeps the torch epilogue;
a lazy step hands every field it leaves unchanged through as the same
tensor.  Tests marked ``gpu`` need a CUDA card and skip without one: each
kernel against its plain body at the main path's shapes, and a day of the
benchmark's configuration with the kernels against the plain glue.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import mckpp_torch as T
from mckpp_torch.grid import make_vertical_grid
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.ops import ocnstep_fused as of
from mckpp_torch.ops import step_glue as sg
from mckpp_torch.ops.overrides import bottomtemp, check_profile
from mckpp_torch.state import (Forcing, State, init_forcing, init_params,
                               init_state, tree_map)

NCOL, NZ = 300, 12
LAYOUTS = {"col_lanes": 0, "z_lanes": 1}
FLAGS = {
    "none": {},
    "damp": dict(l_damp_curr=True, dtuvdamp=2),
    "freeze_clim": dict(l_no_freeze=True, ocnt_file="t.nc",
                        sal_file="s.nc"),
    "bottom": dict(l_vary_bottom_temp=True),
    "all": dict(l_damp_curr=True, dtuvdamp=2, l_no_freeze=True,
                ocnt_file="t.nc", sal_file="s.nc",
                l_vary_bottom_temp=True),
}
WIDE_LEVELS = ("rho", "cp", "buoy", "talpha", "sbeta", "tinc_fcorr",
               "sinc_fcorr", "ocntcorr", "scorr")
WIDE_IFACE = ("difm", "difs", "dift", "ghat", "rig", "dbloc", "shsq",
              "swdk_opt")


def config(nz=NZ, l_ssref=True, **forcing):
    return T.KppConfig(
        domain=T.DomainConfig(nx=NCOL, ny=1, nz=nz, dmax=120.0),
        time=T.TimeConfig(dtsec=3600.0, ndtocn=1, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(l_ssref=l_ssref),
        forcing=T.ForcingConfig(**forcing))


def inputs(cfg, ncol, dtype, device, zaxis, seed=0):
    """A random state, parameters and forcing, and what the step hands
    its epilogue: the final u, v, T, S in the kernels' layout, comp_flag,
    hmix, kmix, reset_flag, the new surface rows and a full step's wide
    fields (views of kernel-layout arrays, as the full pass gives them).
    T spans the freezing floor; a tenth of the columns are land, some of
    them ocean points that do not run physics; the history phases take
    values out of 0..1 too."""
    g = torch.Generator(device=device).manual_seed(seed)
    nz = cfg.domain.nz
    nzp1, wz = nz + 1, nz + 2
    rnd = lambda *s: torch.rand(s, generator=g, device=device,
                                dtype=dtype)
    st = tree_map(lambda a: (rnd(*a.shape) * 4.0 - 2.0)
                  if a.is_floating_point() else a,
                  init_state(ncol, nzp1, dtype, device))
    st = st.replace(x=torch.stack([rnd(ncol, nzp1) * 32.0 - 3.0,
                                   rnd(ncol, nzp1) - 0.5], dim=-1),
                    old=torch.randint(-1, 3, (ncol,), generator=g,
                                      device=device, dtype=torch.int32),
                    new=torch.randint(-1, 3, (ncol,), generator=g,
                                      device=device, dtype=torch.int32))
    prm = init_params(ncol, nzp1, dtype=dtype, device=device)
    land = rnd(ncol) < 0.1
    prm = prm.replace(run_physics=~land,
                      l_ocean=~land | (torch.arange(ncol, device=device)
                                       % 3 == 0),
                      u_init=rnd(ncol, nzp1, 2) - 0.5,
                      sref=rnd(ncol) + 34.0, ssref=rnd(ncol) + 34.0)
    frc = init_forcing(ncol, nzp1, dtype, device).replace(
        ocnt_clim=rnd(ncol, nzp1) * 20.0, sal_clim=rnd(ncol, nzp1) - 0.5,
        bottom_temp=rnd(ncol) * 4.0)
    kshape = (ncol, wz) if zaxis else (wz, ncol)
    tob = (lambda a: a) if zaxis else (lambda a: a.T)
    q = (rnd(*kshape) - 0.5, rnd(*kshape) - 0.5,
         rnd(*kshape) * 32.0 - 3.0, rnd(*kshape) - 0.5)
    step = dict(comp_flag=rnd(ncol) < 0.2, hmixn=rnd(ncol) * 50.0,
                kmixn=torch.randint(1, nz, (ncol,), generator=g,
                                    device=device, dtype=torch.int32),
                reset_flag=torch.floor(rnd(ncol) * 3.0),
                row0=(rnd(ncol) + 1020.0, rnd(ncol) + 3990.0))
    wide = {n: tob(rnd(*kshape))[:, :nzp1] for n in WIDE_LEVELS}
    wide.update({n: tob(rnd(*kshape))[:, :nz + 2 if n[:3] == "dif"
                                      else nz + 1] for n in WIDE_IFACE})
    wide.update(rhoh2o=rnd(ncol), fcorr=rnd(ncol),
                wu=rnd(ncol, nz + 1, 2), wx=rnd(ncol, nz + 1, 3),
                wxnt=rnd(ncol, nz + 1, 2))
    return st, prm, frc, q, step, wide


# ---- the glue before the kernels (frozen) ------------------------------------

def parent_prologue(st: State, wz, zaxis):
    old = torch.where((st.old < 0) | (st.old > 1), st.new, st.old)
    new = torch.where((st.new < 0) | (st.new > 1), old, st.new)
    sel_new = (new == 1)[:, None, None]
    sel_old = (old == 1)[:, None, None]
    us_new = torch.where(sel_new, st.us[..., 1], st.us[..., 0])
    us_old = torch.where(sel_old, st.us[..., 1], st.us[..., 0])
    xs_new = torch.where(sel_new, st.xs[..., 1], st.xs[..., 0])
    xs_old = torch.where(sel_old, st.xs[..., 1], st.xs[..., 0])
    u_ex3 = 2.0 * us_new - us_old
    x_ex3 = 2.0 * xs_new - xs_old

    def tok(a):
        p = torch.nn.functional.pad(a, (0, wz - a.shape[1]))
        return p if zaxis else p.T.contiguous()

    return (tok(u_ex3[:, :, 0]), tok(u_ex3[:, :, 1]), tok(x_ex3[:, :, 0]),
            tok(x_ex3[:, :, 1]), tok(st.u[:, :, 0]), tok(st.u[:, :, 1]),
            tok(st.x[:, :, 0]), tok(st.x[:, :, 1]), tok(st.swdk_opt),
            tok(st.swfrac))


def parent_epilogue(st: State, prm, frc: Forcing, q, comp_flag, hmixn,
                    kmixn, reset_flag, row0, wide, grid, cfg, zaxis):
    dtype, ph = st.u.dtype, cfg.physics
    nzp1, ncol, dto = grid.nzp1, st.u.shape[0], cfg.time.dto
    tob = (lambda a: a) if zaxis else (lambda a: a.T)
    old = torch.where((st.old < 0) | (st.old > 1), st.new, st.old)
    new = torch.where((st.new < 0) | (st.new > 1), old, st.new)
    u_lvl, v_lvl, t_lvl, s_lvl = (tob(a)[:, :nzp1] for a in q)
    zero = torch.zeros((ncol,), dtype=dtype, device=st.u.device)
    ssurf = prm.ssref if ph.l_ssref else s_lvl[:, 0] + prm.sref
    dampu_flag, dampv_flag = zero, zero
    if cfg.forcing.l_damp_curr:
        r = cfg.forcing.dtuvdamp * (86400.0 / dto)

        def damp(q):
            a = 0.99 * torch.abs(q)
            b = q * q / r
            qi = torch.minimum(a, b)
            frac = (b < a).to(dtype).sum(dim=1) / float(nzp1)
            return q - torch.sign(q) * qi, frac

        u_lvl, dampu_flag = damp(u_lvl)
        v_lvl, dampv_flag = damp(v_lvl)
    u3 = torch.stack([u_lvl, v_lvl], dim=-1)
    x3 = torch.stack([t_lvl, s_lvl], dim=-1)
    old2 = new
    new2 = 1 - old2
    sel2 = (new2 == 1)[:, None, None]
    us = torch.stack([torch.where(sel2, st.us[..., 0], u3),
                      torch.where(sel2, u3, st.us[..., 1])], dim=-1)
    xs = torch.stack([torch.where(sel2, st.xs[..., 0], x3),
                      torch.where(sel2, x3, st.xs[..., 1])], dim=-1)
    selh = new2 == 1
    hmixd = torch.stack([torch.where(selh, st.hmixd[:, 0], hmixn),
                         torch.where(selh, hmixn, st.hmixd[:, 1])], dim=-1)
    common = dict(u=u3, x=x3, us=us, xs=xs, hmixd=hmixd, old=old2,
                  new=new2, hmix=hmixn, kmix=kmixn,
                  uref=u_lvl[:, 0], vref=v_lvl[:, 0], tref=t_lvl[:, 0],
                  ssurf=ssurf.to(dtype), reset_flag=reset_flag,
                  dampu_flag=dampu_flag, dampv_flag=dampv_flag)
    if row0 is None:
        new_st = st.replace(**wide, **common)
    else:
        rho_n, cp_n = st.rho.clone(), st.cp.clone()
        rho_n[:, 0] = row0[0]
        cp_n[:, 0] = row0[1]
        new_st = st.replace(rho=rho_n, cp=cp_n, **common)
    new_st = check_profile(new_st, prm, frc, comp_flag, grid, cfg)
    m = prm.run_physics
    out = tree_map(lambda a, b: torch.where(
        m.reshape(m.shape + (1,) * (a.dim() - 1)), a, b), new_st, st)
    if cfg.forcing.l_vary_bottom_temp:
        out = bottomtemp(out, frc, grid, dto)
    return out


def assert_states_equal(got: State, ref: State):
    for f in dataclasses.fields(State):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name


def run_epilogue(cfg, glue_out, st, prm, frc, q, step, wide, full, zaxis,
                 grid):
    return of.epilogue(st, prm, frc, q, step["comp_flag"], step["hmixn"],
                       step["kmixn"], step["reset_flag"],
                       None if full else step["row0"],
                       wide if full else {}, glue_out, grid=grid, cfg=cfg,
                       zaxis=zaxis)


def run_parent(cfg, st, prm, frc, q, step, wide, full, zaxis, grid):
    return parent_epilogue(st, prm, frc, q, step["comp_flag"],
                           step["hmixn"], step["kmixn"],
                           step["reset_flag"],
                           None if full else step["row0"], wide, grid,
                           cfg, zaxis)


# ---- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_glue_in_matches_the_parent_prologue(layout, dtype):
    zaxis = LAYOUTS[layout]
    cfg = config()
    st = inputs(cfg, NCOL, dtype, "cpu", zaxis)[0]
    gin = sg.make_glue(make_vertical_grid(NZ, 120.0, 3600.0), cfg,
                       impl="cuda", zaxis=zaxis)[0]
    got = gin(st.us, st.xs, st.u, st.x, st.swdk_opt, st.swfrac, st.old,
              st.new)
    for a, b in zip(got, parent_prologue(st, NZ + 2, zaxis)):
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)


@pytest.mark.parametrize("full", [False, True], ids=["lazy", "full"])
@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_glue_out_matches_the_parent_epilogue(layout, flags, full):
    """Every State field, through glue_out's plain body and the per-column
    selects, equals the parent's epilogue (l_ssref off under "all")."""
    zaxis = LAYOUTS[layout]
    cfg = config(l_ssref=flags != "all", **FLAGS[flags])
    grid = make_vertical_grid(NZ, 120.0, 3600.0, dtype=torch.float32)
    st, prm, frc, q, step, wide = inputs(cfg, NCOL, torch.float32, "cpu",
                                         zaxis, seed=len(flags))
    ref = run_parent(cfg, st, prm, frc, q, step, wide, full, zaxis, grid)
    for impl in ("eager", "cuda"):
        gout = sg.make_glue(grid, cfg, impl=impl, zaxis=zaxis)[1]
        got = run_epilogue(cfg, gout, st, prm, frc, q, step, wide, full,
                           zaxis, grid)
        assert_states_equal(got, ref)
    if flags != "none":
        # the flags change what the epilogue writes
        plain = run_parent(config(), st, prm, frc, q, step, wide, full,
                           zaxis, grid)
        assert any(not torch.equal(getattr(ref, n), getattr(plain, n))
                   for n in sg.out_fields(cfg, full))


def test_isotherm_keeps_the_torch_epilogue(monkeypatch):
    """l_no_isotherm: no glue_out (its wrapper refuses the configuration)
    and the torch epilogue is the parent's, bit for bit."""
    cfg = config(l_no_isotherm=True, isotherm_bottom=8, ocnt_file="t.nc",
                 sal_file="s.nc", l_no_freeze=True)
    grid = make_vertical_grid(NZ, 120.0, 3600.0, dtype=torch.float32)
    assert not sg.fusable(cfg) and sg.fusable(config(**FLAGS["all"]))
    for impl in ("eager", "cuda"):
        assert sg.make_glue(grid, cfg, impl=impl, zaxis=0)[1] is None
    with pytest.raises(ValueError):
        sg.GlueOut(grid, cfg, 0)
    monkeypatch.setattr(sg, "glue_out_body", None)   # never reached
    st, prm, frc, q, step, wide = inputs(cfg, NCOL, torch.float32, "cpu", 0)
    # make some columns isothermal, so the test resets them
    x = st.x.clone()
    x[::7, :, 0] = 11.0
    st = st.replace(x=x)
    q = (q[0], q[1], torch.where(torch.arange(NCOL) % 7 == 0, 11.0, q[2]),
         q[3])
    for full in (False, True):
        got = run_epilogue(cfg, None, st, prm, frc, q, step, wide, full, 0,
                           grid)
        assert_states_equal(got, run_parent(cfg, st, prm, frc, q, step,
                                            wide, full, 0, grid))
        assert bool((got.reset_flag < 0).any())


def test_lazy_step_passes_unchanged_fields_through():
    """A lazy fused step returns the input's own tensor for every field it
    does not change, so the chain's in-graph store skips them."""
    cfg = config(nz=NZ)
    cfg = cfg.replace(domain=dataclasses.replace(cfg.domain, nx=40))
    m = T.KppModel(cfg, device="cpu")
    rng = np.random.default_rng(3)
    zm = m.grid.zm.double().numpy()
    t0 = 20.0 + 5.0 * np.exp(zm / 40.0) + 0.05 * rng.standard_normal((40, NZ + 1))
    s0 = 35.0 - 0.3 * np.exp(zm / 60.0) + np.zeros((40, NZ + 1))
    u0 = 0.02 * rng.standard_normal((40, NZ + 1, 2))
    prm = init_params(40, NZ + 1, dtype=m.dtype)
    wet = torch.arange(40) % 9 != 4
    st, prm, frc = m.warm_start(u0, t0, s0, prm.replace(
        run_physics=wet, l_ocean=wet))
    out = m.step(st, prm, frc, first_step=False, with_diags=False)
    changed = set(sg.OUT_FIELDS) | {"hmixd", "old", "new", "hmix", "kmix",
                                    "ssurf", "reset_flag"}
    for f in dataclasses.fields(State):
        if f.name not in changed:
            assert getattr(out, f.name) is getattr(st, f.name), f.name
    assert out.u is not st.u and not torch.equal(out.us, st.us)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the main path's width: TerraMaris's 144,507 columns, and at nz = 100 the
# N216 grid's 139,968 (the 4-slot build's deployment); at nz = 510 in
# float64 a width whose inputs and plain bodies fit the card's 80 GB
GATE = ([(nz, 139_968 if nz == 100 else 65_536 if (nz, dt) == (510, "float64")
          else 144_507, dt, lay, fl) for nz in (69, 100, 150, 510)
         for dt in ("float32", "float64") for lay in LAYOUTS
         for fl in ("none", "all")]
        + [(69, 3001, dt, lay, fl) for dt in ("float32", "float64")
           for lay in LAYOUTS for fl in FLAGS])


@pytest.mark.gpu
@pytest.mark.parametrize("nz,ncol,dtype,layout,flags", GATE)
def test_glue_kernels_match_their_plain_bodies(cuda, nz, ncol, dtype,
                                               layout, flags):
    """Each kernel, bit for bit, against its plain body on the card (lazy
    and full steps for glue_out); the launch counter counts each launch."""
    zaxis, dt = LAYOUTS[layout], getattr(torch, dtype)
    cfg = config(nz=nz, l_ssref=flags != "all", **FLAGS[flags])
    grid = make_vertical_grid(nz, 120.0, 3600.0, dtype=dt, device=cuda)
    st, prm, frc, q, step, wide = inputs(cfg, ncol, dt, cuda, zaxis)
    gin, gout = sg.make_glue(grid, cfg, impl="cuda", zaxis=zaxis)
    ck.reset_counts()
    args = (st.us, st.xs, st.u, st.x, st.swdk_opt, st.swfrac, st.old,
            st.new)
    for a, b in zip(gin(*args),
                    sg.glue_in_body(*args, wz=nz + 2, zaxis=zaxis)):
        assert a.shape == b.shape and torch.equal(a, b)
    for full in (False, True):
        src = (tuple(wide[n] for n in ("rho", "cp", "tinc_fcorr",
                                       "ocntcorr")) if full else
               (st.rho, st.cp, st.tinc_fcorr, st.ocntcorr))
        ca = (q, st, prm, frc, step["comp_flag"],
              None if full else step["row0"], src)
        got = gout(*ca)
        ref = sg.glue_out_body(*ca, grid=grid, cfg=cfg, zaxis=zaxis)
        assert got.keys() == ref.keys()
        for n in ref:
            assert torch.equal(got[n], ref[n]), n
    torch.cuda.synchronize()
    assert ck.LAUNCHES["step_glue_in"] == 1
    assert ck.LAUNCHES["step_glue_out"] == 2


@pytest.mark.gpu
def test_day_of_the_benchmark_config_matches_the_plain_glue(cuda, tmp_path,
                                                            monkeypatch):
    """One day (72 steps) of the TerraMaris configuration the benchmark
    runs (``io/benchmark_inputs.py``, which the benchmark's inputs copy)
    at full width through the CLI (cuda_step, CUDA graphs, float32):
    every State field of the final restart is the same with the kernels
    as with the plain glue, and the kernels ran once a step each."""
    from mckpp_torch import cli
    from mckpp_torch.io import benchmark_inputs

    data = str(tmp_path / "inputs")
    benchmark_inputs.generate("terramaris", data)

    def day(out):
        summary = cli.run(["--namelist", os.path.join(data, "3D_ocn.nml"),
                           "--data-dir", data, "--output-dir", out,
                           "--dtype", "float32"])
        assert summary["num_steps"] == 72
        path = os.path.join(out, sorted(f for f in os.listdir(out) if
                                        f.startswith("restart_out_"))[-1])
        return summary, dict(np.load(path))

    summary, got = day(str(tmp_path / "kernels"))
    n = summary["launches"]
    # every step, and each graph's eager warm-up, ran both kernels
    assert n["step_glue_in"] == n["step_glue_out"] == n["fused_step"] >= 72
    monkeypatch.setattr(sg.GlueIn, "launch",
                        lambda w, *a: sg.glue_in_body(*a, wz=w.wz,
                                                      zaxis=w.zaxis))
    monkeypatch.setattr(sg.GlueOut, "launch",
                        lambda w, *a: sg.glue_out_body(
                            *a, grid=w.grid, cfg=w.cfg, zaxis=w.zaxis))
    summary, ref = day(str(tmp_path / "plain"))
    assert summary["launches"]["step_glue_out"] == 0
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
