"""mckpp_torch's I/O layer against mckpp_tpu's, on the same inputs:
namelists, iodef streams, the diagnostics files written from the same
state sequence, npz restarts across the two packages, the reference
NetCDF restart, the ancillary reads of the end-to-end inputs, and the
TerraMaris input writer against the tool it copies.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mckpp_tpu import setup as jsetup
from mckpp_tpu import state as jstate
from mckpp_tpu.io import ancillaries as janc
from mckpp_tpu.io import diagnostics as jdiag
from mckpp_tpu.io import restart as jrestart
from mckpp_tpu.io import streams as jstreams
from mckpp_tpu.utils import namelist as jnml

from mckpp_torch import convert
from mckpp_torch import state as tstate
from mckpp_torch.grid import make_vertical_grid
from mckpp_torch.io import ancillaries as tanc
from mckpp_torch.io import benchmark_inputs
from mckpp_torch.io import diagnostics as tdiag
from mckpp_torch.io import restart as trestart
from mckpp_torch.io import streams as tstreams
from mckpp_torch.utils import namelist as tnml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_endtoend import write_inputs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import make_benchmark_configs as tool  # noqa: E402

NAMELIST = """
 &NAME_PARAMETERS nz=20, nx=6, ny=4, ngrid=20, nztmax=34, itermax=150,
 hmixtolfrac=0.05, maxmodeadv=6 &END
 &NAME_CONSTANTS grav=9.81, vonk=0.41, spd=86400.0, TK0=273.16 &END
 &NAME_PROCSWIT LKPP=.T., LRI=.F., LDD=.T., LICE=.T., LBIO=.F.,
 L_SSREF=.F. &END
 &NAME_DOMAIN dmax=300.0, alon=100.5, alat=-8.25, delta_lat=0.5,
 delta_lon=0.75, L_STRETCHGRID=.T., dscale=3.5, L_REGGRID=.T.,
 L_VGRID_FILE=.F., vgrid_file='none' &END
 &NAME_LANDSEA L_LANDSEA=.T., landsea_file='lsm.nc' &END
 &NAME_START L_INITDATA=.T., initdata_file='init.nc', L_INTERPINIT=.F.,
 L_RESTART=.T., restart_infile='restart_in.npz' &END
 &NAME_TIMES dtsec=1800.0, startt=10.0, finalt=12.5, ndtocn=2, nyear=1 &END
 &NAME_COUPLE L_COUPLE=.T., ifirst=1, ilast=6, jfirst=1, jlast=4,
 L_CLIMSST=.T., sstin_file='sst.nc', L_UPD_CLIMSST=.T., ndtupdsst=12,
 L_CPLWGHT=.T., cplwght_file='cplwght.nc', icein_file='ice.nc',
 L_CLIMICE=.T., L_UPD_CLIMICE=.T., ndtupdice=6, L_CLIM_ICE_DEPTH=.T.,
 L_CLIM_SNOW_ON_ICE=.F., L_OUTKELVIN=.F., L_PERIODIC_CLIMICE=.T.,
 L_PERIODIC_CLIMSST=.T., climsst_period=365, climice_period=360 &END
 &NAME_ADVEC L_ADVECT=.T., advect_file='adv.nc', L_RELAX_SST=.T.,
 relax_sst_in=5.0,4.0,3*2.5, L_RELAX_CALCONLY=.F., L_RELAX_SAL=.T.,
 relax_sal_in=4*10.0, L_RELAX_OCNT=.T., relax_ocnt_in=1.0,2.0,3.0,4.0 &END
 &NAME_PARAS paras_file='paras.nc', L_JERLOV=.F. &END
 &NAME_FORCING L_FLUXDATA=.T., forcing_file='f.nc', L_FCORR_WITHZ=.T.,
 fcorrin_file='fc.nc', ndtupdfcorr=3, L_VARY_BOTTOM_TEMP=.T.,
 ndtupdbottom=5, bottomin_file='bt.nc', L_FCORR=.F., L_UPD_FCORR=.T.,
 L_UPD_BOTTOM_TEMP=.T., L_REST=.T., L_PERIODIC_FCORR=.T.,
 L_PERIODIC_BOTTOM_TEMP=.F., fcorr_period=30, L_SFCORR_WITHZ=.F.,
 sfcorrin_file='sfc.nc', ndtupdsfcorr=7, L_SFCORR=.T., L_UPD_SFCORR=.T.,
 L_PERIODIC_SFCORR=.T., sfcorr_period=31, bottom_temp_period=32,
 sal_file='sal.nc', L_UPD_SAL=.T., L_PERIODIC_SAL=.T., sal_period=33,
 ndtupdsal=8, ocnt_file='t.nc', L_UPD_OCNT=.T., L_PERIODIC_OCNT=.F.,
 ocnt_period=34, ndtupdocnt=9, L_NO_FREEZE=.T., L_NO_ISOTHERM=.T.,
 isotherm_bottom=10, isotherm_threshold=0.01, L_DAMP_CURR=.T.,
 dtuvdamp=120, L_INTERP_OCNT=.T., ndt_interp_ocnt=4, L_INTERP_SAL=.F.,
 ndt_interp_sal=2 &END
 &NAME_OUTPUT L_RESTARTW=.T., restart_outfile='rs_out',
 ndt_per_restart=24, IODEF_FILE='my_iodef.xml', L_RESTART_NETCDF=.T. &END
 &NAME_UNKNOWN_GROUP foo=1 &END
"""


def test_namelist_every_group_parses_equal():
    jcfg, jextras = jnml.config_from_namelist(NAMELIST)
    tcfg, textras = tnml.config_from_namelist(NAMELIST)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert textras == jextras
    assert tcfg.time.dto == jcfg.time.dto and tcfg.time.num_timesteps == 240
    with pytest.raises(ValueError):                 # undeclared variable
        tnml.config_from_namelist(" &NAME_TIMES dtsec=1.0, bogus=2 &END")


def _same_streams(a, b):
    assert [dataclasses.asdict(s) for s in a] == \
        [dataclasses.asdict(s) for s in b]


def test_parse_iodef_matches(tmp_path):
    path = tmp_path / "iodef.xml"
    path.write_text(tool.IODEF)
    assert benchmark_inputs.IODEF == tool.IODEF
    for dto in (1200.0, 3600.0):
        got = tstreams.parse_iodef(str(path), dto)
        _same_streams(got, jstreams.parse_iodef(str(path), dto))
        assert [s.name for s in got][-1] == "output_kpp_all"
    _same_streams(tdiag.default_streams(1200.0, 1.0),
                  jdiag.default_streams(1200.0, 1.0))


# ---------------------------------------------------------------------------
# diagnostics files from one state sequence
# ---------------------------------------------------------------------------

NX, NY, NZ = 3, 2, 6
NCOL = NX * NY


def _random_fields(init, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f in dataclasses.fields(init):
        a = np.asarray(getattr(init, f.name))
        if a.dtype.kind == "f":
            a = rng.standard_normal(a.shape)
        out[f.name] = a
    return out


def _pair(seed):
    """(jax (st, prm, frc), port (st, prm, frc)) from the same numpy."""
    js = _random_fields(jstate.init_state(NCOL, NZ + 1), seed)
    jp = _random_fields(jstate.init_params(NCOL, NZ + 1), seed + 100)
    jf = _random_fields(jstate.init_forcing(NCOL, NZ + 1), seed + 200)
    j = (jstate.State(**{k: jnp.asarray(v) for k, v in js.items()}),
         jstate.ColumnParams(**{k: jnp.asarray(v) for k, v in jp.items()}),
         jstate.Forcing(**{k: jnp.asarray(v) for k, v in jf.items()}))
    t = (convert.state_from_numpy(js), convert.params_from_numpy(jp),
         convert.forcing_from_numpy(jf))
    return j, t


def _streams(mod):
    return [mod.Stream("inst", "instant", 2, fields=("T", "hmix", "difm"),
                       split_freq_days=0.5),
            mod.Stream("mean", "average", 3, split_freq_days=0.5),
            mod.Stream("mixed", "mixed", 3,
                       entries=(("Tmin", "T", "minimum"),
                                ("Tmax", "T", "maximum"),
                                ("S_now", "S", "instant"),
                                ("h_mean", "hmix", "average")))]


def _read(path):
    with netcdf_file(path, "r", mmap=False) as nc:
        return (dict(nc.dimensions), dict(nc._attributes),
                {k: (np.asarray(v[:]).copy(), dict(v._attributes))
                 for k, v in nc.variables.items()})


def test_diagnostics_files_match(tmp_path):
    zm = np.linspace(-1.0, -60.0, NZ + 1)
    l_ocean = np.ones(NCOL, bool)
    l_ocean[4] = False
    lons, lats = 90.0 + np.arange(NX), -5.0 + np.arange(NY)
    kw = dict(nx=NX, ny=NY, zm=zm, start_time_days=3.0, dto_seconds=10800.0,
              l_ocean=l_ocean, lons=lons, lats=lats)
    jm = jdiag.DiagnosticsManager(_streams(jdiag), outdir=str(tmp_path / "j"),
                                  **kw)
    tm = tdiag.DiagnosticsManager(_streams(tdiag), outdir=str(tmp_path / "t"),
                                  **kw)
    for nt in range(1, 10):
        (js, jp, jf), (ts, tp, tf) = _pair(nt)
        jm.step(nt, js, jp, jf)
        tm.step(nt, ts, tp, tf)
    jpaths, tpaths = jm.flush(), tm.flush()
    assert set(tpaths) == set(jpaths) and len(tpaths) >= 6
    for key in jpaths:
        assert os.path.basename(tpaths[key]) == os.path.basename(jpaths[key])
        jd, ja, jv = _read(jpaths[key])
        td, ta, tv = _read(tpaths[key])
        assert td == jd and ta == ja, key
        assert set(tv) == set(jv), key
        for name in jv:
            np.testing.assert_array_equal(tv[name][0], jv[name][0],
                                          err_msg=f"{key}:{name}")
            assert tv[name][1] == jv[name][1], f"{key}:{name} attributes"
    # non-vacuous: land at the fill value, the time axis stamped
    _, _, tv = _read(tpaths["mean_00003.000.nc"])
    assert np.all(tv["T"][0][:, :, 1, 1] == tdiag.FILL_VALUE)
    assert tv["time"][1]["units"] == b"days since 0000-01-02 00:00:00"


def test_shard_mode_not_ported(tmp_path):
    """The shard mode is ported now (the name dates from when it raised):
    a rank's shard file carries its rows and the slab attributes, an
    unknown mode raises, and the merge refuses shard files that do not
    tile the domain."""
    from mckpp_torch.parallel.distributed import ColumnLayout
    with pytest.raises(ValueError, match="write_mode"):
        tdiag.DiagnosticsManager([], 1, 1, np.zeros(2), write_mode="both")
    zm = np.linspace(-1.0, -60.0, NZ + 1)
    lay = ColumnLayout(ncol=NCOL, ncol_unpadded=NCOL, rank=1, world=2,
                       device="cpu")
    tm = tdiag.DiagnosticsManager(
        [tdiag.Stream("inst", "instant", 1, fields=("T", "hmix"))], NX, NY,
        zm, outdir=str(tmp_path), write_mode="shard", l_ocean=np.ones(NCOL, bool))
    tm.set_layout(lay)
    (_, _, _), (ts, tp, tf) = _pair(1)
    half = lambda tree: tree.replace(**{
        f: getattr(tree, f)[lay.lo:lay.hi]
        for f in tree.__dataclass_fields__})
    tm.step(1, half(ts), half(tp), half(tf))
    path = tm.flush()["inst"]
    assert os.path.basename(path) == "inst_p1.nc"
    dims, attrs, vs = _read(path)
    assert dims["points"] == NCOL // 2 and tm.emit_gathers == 0
    assert (attrs["shard_lo"], attrs["shard_hi"], attrs["shard_rank"]) \
        == (NCOL // 2, NCOL, 1)
    np.testing.assert_array_equal(
        vs["T"][0][0], ts.x[lay.lo:lay.hi, :, 0].numpy().T)
    with pytest.raises(ValueError, match="gap at rows"):
        tdiag.merge_shard_files([path], str(tmp_path / "m.nc"))


# ---------------------------------------------------------------------------
# restarts
# ---------------------------------------------------------------------------

def _bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _np(obj):
    if isinstance(obj, (tstate.State, tstate.ColumnParams, tstate.Forcing)):
        return convert.to_numpy(obj)
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_npz_restart_crosses_packages(tmp_path):
    (js, jp, jf), (ts, tp, tf) = _pair(7)
    pj = jrestart.save_restart(str(tmp_path / "jax"), js, jp, jf, 12, 3.5,
                               1200.0)
    pt = trestart.save_restart(str(tmp_path / "port"), ts, tp, tf, 12, 3.5,
                               1200.0)
    with np.load(pj) as a, np.load(pt) as b:
        _bitwise(dict(a), dict(b))                  # same keys, same bytes
    st, prm, frc, ntime, days = trestart.load_restart(pj)
    for got, ref in ((st, js), (prm, jp), (frc, jf)):
        _bitwise(_np(got), _np(ref))
    assert ntime == 12 and days == 3.5 + 1200.0 / 86400.0
    st, prm, frc, _, _ = jrestart.load_restart(pt)
    for got, ref in ((st, ts), (prm, tp), (frc, tf)):
        _bitwise(_np(got), _np(ref))


def test_reference_netcdf_restart_round_trip(tmp_path):
    (js, jp, _), (ts, tp, _) = _pair(8)
    path = str(tmp_path / "ref.nc")
    trestart.export_reference_restart(path, ts, tp, NX, NY, 2.0, 1200.0)
    grid = make_vertical_grid(NZ, 60.0, 1200.0)
    st0 = tstate.init_state(NCOL, NZ + 1)
    st, prm, days = trestart.import_reference_restart(path, st0, tp, grid)
    assert days == 2.0 + 1200.0 / 86400.0
    got, ref = convert.to_numpy(st), convert.to_numpy(ts)
    for name in ("u", "x", "us", "xs", "hmixd", "cp", "rho", "hmix", "ssurf",
                 "tref"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for name in ("kmix", "old", "new"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    assert got["swfrac"].any() and got["swdk_opt"].any()   # caches reseeded
    # the JAX reader takes the port's file to the same state
    jst, jprm, _ = jrestart.import_reference_restart(
        path, jstate.init_state(NCOL, NZ + 1), jp)
    for name in ("u", "x", "us", "xs", "hmixd", "hmix", "kmix", "old"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                      got[name], err_msg=name)
    np.testing.assert_array_equal(convert.to_numpy(prm)["sref"],
                                  np.asarray(jprm.sref))


def test_restart_control_writes_npz_and_netcdf(tmp_path):
    (_, _, _), (ts, tp, tf) = _pair(9)
    rc = trestart.RestartControl(str(tmp_path / "rs"), 3, 7, 1200.0, 0.0,
                                 netcdf_grid=(NX, NY))
    assert [n for n in range(1, 8) if rc.due(n)] == [3, 6, 7]
    for nt in range(1, 8):
        rc.maybe_write(nt, ts, tp, tf)
    written = rc.flush()
    assert len(written) == 6 and sum(p.endswith(".nc") for p in written) == 3


# ---------------------------------------------------------------------------
# ancillaries
# ---------------------------------------------------------------------------

def _managers(d):
    cfgs = (jnml.load_config(str(d / "3D_ocn.nml"))[0],
            tnml.load_config(str(d / "3D_ocn.nml"))[0])
    join = lambda p: os.path.join(str(d), p) if p not in ("", "none") else p
    out = []
    for cfg, mod in zip(cfgs, (janc, tanc)):
        cfg = dataclasses.replace(cfg, boundary=dataclasses.replace(
            cfg.boundary, sst_file=join(cfg.boundary.sst_file)))
        sref = np.full(cfg.domain.npts, 35.2)
        out.append((cfg, mod.BoundaryManager(cfg, 90.0, -5.0, 11, sref)))
    return out


def test_boundary_manager_matches(tmp_path):
    write_inputs(tmp_path, sst=True, advect=True)
    (jcfg, jm), (tcfg, tm) = _managers(tmp_path)
    ncol = jcfg.domain.npts
    jf = jm.initial_reads(jcfg.time.startt, jstate.init_forcing(ncol, 11))
    tf = tm.initial_reads(tcfg.time.startt, tstate.init_forcing(ncol, 11))
    _bitwise(_np(tf), _np(jf))
    assert np.asarray(jf.sst0).min() > 20.0           # SST read, in degC
    dto = jcfg.time.dto
    for nt in range(2, 10):
        days = jcfg.time.startt + (nt - 1) * dto / 86400.0
        assert tm.due_any(nt) == jm.due_any(nt)
        jf = jm.update(nt, days, jf)
        tf = tm.update(nt, days, tf)
        _bitwise(_np(tf), _np(jf))
    tm.drain_prefetch()
    assert tm.sst.cache_hits > 0                       # the prefetch worked
    # the flux file reader
    jr = janc.FluxFileReader(dataclasses.replace(jcfg, forcing=dataclasses.replace(
        jcfg.forcing, forcing_file=str(tmp_path / "fluxes.nc"))), 90.0, -5.0)
    tr = tanc.FluxFileReader(dataclasses.replace(tcfg, forcing=dataclasses.replace(
        tcfg.forcing, forcing_file=str(tmp_path / "fluxes.nc"))), 90.0, -5.0)
    for days in (0.0, 0.125, 0.25):
        _bitwise({k: v.numpy() for k, v in tr(days)._asdict().items()},
                 {k: np.asarray(v) for k, v in jr(days)._asdict().items()})


def test_update_time_matches():
    times = (np.arange(12) + 0.5) * 0.25
    for t in (0.0, 0.25, 1.0, 2.5, 3.0, 5.5):     # the last two wrap
        for method in (1, 2):
            args = (t, 6, times, True, 3, 3600.0, 3600.0)
            assert tanc.get_update_time(*args, method=method) == \
                janc.get_update_time(*args, method=method)
    with pytest.raises(tanc.ncio.NetCDFError):   # past the end, not periodic
        tanc.get_update_time(3.0, 6, times, False, 3, 3600.0, 3600.0)


def test_terramaris_writer_matches_tool(tmp_path):
    """The port's copy of the TerraMaris branch writes what the tool
    writes (the toy shrink of 8)."""
    benchmark_inputs.write_terramaris(str(tmp_path / "port"), shrink=8)
    tool.generate("terramaris", str(tmp_path / "tool"), toy=True)
    names = sorted(os.listdir(tmp_path / "tool"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for fn in names:
        a, b = tmp_path / "port" / fn, tmp_path / "tool" / fn
        if not fn.endswith(".nc"):
            assert a.read_text() == b.read_text(), fn
            continue
        _, _, av = _read(str(a))
        _, _, bv = _read(str(b))
        assert set(av) == set(bv), fn
        for k in av:
            np.testing.assert_array_equal(av[k][0], bv[k][0],
                                          err_msg=f"{fn}:{k}")
    # setup.build of the JAX package reads the port's files
    cfg, _ = jnml.load_config(str(tmp_path / "port" / "3D_ocn.nml"))
    dlon, dlat, l_ocean, _ = jsetup.load_landsea(cfg, str(tmp_path / "port"))
    assert 0.05 < 1.0 - l_ocean.mean() < 0.2
