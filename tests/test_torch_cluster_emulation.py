"""The cluster and pair kernels emulated on the host, bit for bit.

Past 1024 levels the CUDA kernels spread one column over a thread-block
cluster (``csrc/fused_pass.cuh``, ``MW = CLUSTER``): each block holds its
slice of the column's rows and reads the others' through distributed
shared memory between cluster barriers.  No CPU runs that code, so this
file compiles ``fused_pass.cuh`` with g++ beside a shim (below) that runs
each CUDA thread as a ``std::thread``: ``__syncwarp``, ``__syncthreads``
and the cluster barrier are barriers over the warp's, the block's and the
cluster's threads; shuffles and ballots go through a per-warp exchange
row; a pair column's named barrier (and its AND and count) is a barrier
over that column's 64 threads; a block's shared memory is a buffer
filled with NaN, and the map to another block's copy (``cl_map``) points
into that block's buffer.  The
shim exports ``kpp_fused_pass`` and ``kpp_fused_step`` as
``fused_kernels.cu`` does, so the launch wrappers of
``ops/cuda_kernels.py`` drive it with CPU tensors (through a patched
``_lib``).

The same template body built three ways must give the same bits: the
cluster kernels at nz = 1100 (2 blocks of 5 warps) against the one-warp
design at 36 level slots a lane (WZ <= 1152, one warp a column: the
design the other two were derived from, whose exchanges are shuffles and
whole-slot moves), and at nz = 1000 a cluster forced to 2 blocks of 4
warps against the multi-warp kernels of one block (8 warps).  The inputs
are a step's at 3 columns with double diffusion: a land column, a column
whose temperature jump in the cluster's second block makes the
instability trap retry (so the blocks' counts must combine), and a quiet
one.  Past 128 levels the pair kernels (``MW = PAIR``: several columns a
block, each over a pair of warps meeting at a named barrier of its own)
at nz = 150 and 254 against the same one-warp design, bit for bit, and
against the plain body at the gate's bar, on 5 columns (a land column,
a trap column, double diffusion; the last block ragged).  The emulation
rounds as the host does, not as the card: it compares designs, and the
card's gate (``chip_smoke.py`` phase 2) holds the kernels to their plain
versions.
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import mckpp_torch as T
from mckpp_torch import forcing as tforcing
from mckpp_torch.grid import coriolis
from mckpp_torch.ops import cuda_kernels as ck
from mckpp_torch.ops import fused_pass as fp
from mckpp_torch.state import init_params
from test_torch_kernels import INT_ROWS

EMU_NS = 36            # the one-warp reference's level slots (WZ <= 1152)

SHIM = r"""
// Host emulation of the fused kernels: one std::thread per CUDA thread,
// broken-on-timeout barriers for __syncwarp, __syncthreads and the cluster
// barrier, shuffles and ballots through a per-warp exchange row, and
// distributed shared memory as plain pointers into the other blocks'
// buffers.  Exports kpp_fused_pass / kpp_fused_step as fused_kernels.cu
// does, dispatching on the spread the test sets (emu_spread): a cluster,
// a column over a block's warps, columns over a pair of warps (at the
// geometry's 3 or 4 slots) or one warp a column at EMU_NS slots.
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

struct EmuDim { unsigned x = 0, y = 0, z = 0; };
static thread_local EmuDim threadIdx, blockIdx;
static EmuDim blockDim;
static std::atomic<bool> g_broken{false};
// the barriers of the last launch: a block's (__syncthreads and its
// _count and _and forms) and a cluster's, each counted once by thread 0 of
// every block that reaches it, and a pair column's (its named barrier and
// that barrier's reductions), counted once by the column's thread 0
static std::atomic<long> g_block_bars{0}, g_cluster_bars{0}, g_pair_bars{0};

struct EmuBar {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> l(m);
    if (g_broken) return;
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    if (!cv.wait_for(l, std::chrono::seconds(EMU_TIMEOUT_S),
                     [&] { return gen != g || g_broken.load(); })) {
      g_broken = true;
      cv.notify_all();
    }
  }
};

struct EmuBlock {
  EmuBar bar;
  std::vector<EmuBar> warp;
  std::vector<EmuBar> pair;      // a pair column's named barrier
  std::atomic<int> pacc[16];
  std::vector<uint64_t> xch;     // 32 values a warp
  std::atomic<int> acc{0};
  unsigned char* smem = nullptr;
};
struct EmuCluster {
  EmuBar bar;
  std::vector<unsigned char*> smem;
};
static thread_local EmuBlock* t_blk;
static thread_local EmuCluster* t_cl;

static inline int emu_warp() { return int(threadIdx.x) >> 5; }
static inline int emu_lane() { return int(threadIdx.x) & 31; }
static inline void __syncthreads() {
  if (threadIdx.x == 0) ++g_block_bars;
  t_blk->bar.wait();
}
static inline void __syncwarp(unsigned = 0xffffffffu) {
  t_blk->warp[emu_warp()].wait();
}
template <typename T> static T __shfl_sync(unsigned, T v, int src) {
  uint64_t* x = t_blk->xch.data() + 32 * emu_warp();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  x[emu_lane()] = bits;
  __syncwarp();
  bits = x[src & 31];
  __syncwarp();
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}
static unsigned __ballot_sync(unsigned, int p) {
  uint64_t* x = t_blk->xch.data() + 32 * emu_warp();
  x[emu_lane()] = p ? 1 : 0;
  __syncwarp();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= unsigned(x[i] != 0) << i;
  __syncwarp();
  return b;
}
static int __all_sync(unsigned m, int p) { return __ballot_sync(m, p) == ~0u; }
static int __syncthreads_count(int p) {
  EmuBlock* b = t_blk;
  if (threadIdx.x == 0) ++g_block_bars;
  b->bar.wait();
  if (p) b->acc.fetch_add(1);
  b->bar.wait();
  const int n = b->acc.load();
  b->bar.wait();
  if (threadIdx.x == 0) b->acc.store(0);
  b->bar.wait();
  return n;
}
static int __syncthreads_and(int p) { return __syncthreads_count(!p) == 0; }
static inline void pair_sync() {
  if ((threadIdx.x & 63) == 0) ++g_pair_bars;
  t_blk->pair[threadIdx.x >> 6].wait();
}
static int pair_count(bool p) {
  EmuBlock* b = t_blk;
  EmuBar& bar = b->pair[threadIdx.x >> 6];
  std::atomic<int>& acc = b->pacc[threadIdx.x >> 6];
  if ((threadIdx.x & 63) == 0) ++g_pair_bars;
  bar.wait();
  if (p) acc.fetch_add(1);
  bar.wait();
  const int n = acc.load();
  bar.wait();
  if ((threadIdx.x & 63) == 0) acc.store(0);
  bar.wait();
  return n;
}
static bool pair_and(bool p) { return pair_count(!p) == 0; }
static inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <typename T> static inline T __ldg(const T* p) { return *p; }
static inline unsigned __umulhi(unsigned a, unsigned b) {
  return unsigned((uint64_t(a) * b) >> 32);
}
static inline void cl_sync() {
  if (threadIdx.x == 0) ++g_cluster_bars;
  t_cl->bar.wait();
}
template <typename T> static T* cl_map(T* p, int rank) {
  const auto off = reinterpret_cast<unsigned char*>(p) - t_blk->smem;
  return reinterpret_cast<T*>(t_cl->smem[rank] + off);
}

#include "fused_pass.cuh"

using kpp::Geometry;
using kpp::PassParams;
using Real = EMU_REAL;

// run body(smem) on every thread of the grid, one cluster (or block) at a
// time; returns 0, or 1 where a barrier timed out
template <typename F>
static int emu_grid(const Geometry& G, F body) {
  const int cb = G.cb > 1 ? G.cb : 1, nt = 32 * G.warps;
  blockDim.x = unsigned(nt);
  g_broken = false;
  g_block_bars = 0;
  g_cluster_bars = 0;
  g_pair_bars = 0;
  for (int c = 0; c < G.blocks / cb; ++c) {
    EmuCluster cl;
    cl.bar.n = cb * nt;
    std::vector<EmuBlock> blk(cb);
    std::vector<std::vector<uint64_t>> mem(cb);
    for (int r = 0; r < cb; ++r) {
      mem[r].assign((size_t(G.smem) + 7) / 8, ~uint64_t(0));   // NaN
      blk[r].smem = reinterpret_cast<unsigned char*>(mem[r].data());
      blk[r].bar.n = nt;
      blk[r].warp = std::vector<EmuBar>(G.warps);
      for (auto& w : blk[r].warp) w.n = 32;
      blk[r].pair = std::vector<EmuBar>((G.warps + 1) / 2);
      for (auto& w : blk[r].pair) w.n = 64;
      for (auto& a : blk[r].pacc) a = 0;
      blk[r].xch.assign(32 * G.warps, 0);
      cl.smem.push_back(blk[r].smem);
    }
    std::vector<std::thread> th;
    for (int r = 0; r < cb; ++r)
      for (int t = 0; t < nt; ++t)
        th.emplace_back([&, r, t] {
          threadIdx.x = unsigned(t);
          blockIdx.x = unsigned(c * cb + r);
          t_blk = &blk[r];
          t_cl = &cl;
          body(blk[r].smem);
        });
    for (auto& x : th) x.join();
  }
  return g_broken ? 1 : 0;
}

static void unpack(const void* ins, const void* outs, int n_out,
                   kpp::Inputs<Real>* in, kpp::Outputs<Real>* out) {
  const void* const* ip = static_cast<const void* const*>(ins);
  void* const* op = static_cast<void* const*>(outs);
  for (int i = 0; i < kpp::N_IN; ++i) in->p[i] = static_cast<const Real*>(ip[i]);
  in->ref_hi = static_cast<const int*>(ip[kpp::N_IN]);
  in->aref_t = static_cast<const Real*>(ip[kpp::N_IN + 1]);
  in->grid_t = static_cast<const Real*>(ip[kpp::N_IN + 2]);
  in->order = static_cast<const int*>(ip[kpp::N_IN + 3]);
  for (int i = 0; i < kpp::N_OUT_MAX; ++i)
    out->p[i] = i < n_out ? static_cast<Real*>(op[i]) : nullptr;
}

// the layout of the next launch (emu_zaxis); built with EMU_ZL, the
// Z_LANES kernels too; and its spread (emu_spread, a kpp::Spread)
static int g_zaxis = 0, g_spread = 0;

template <bool FULL, kpp::Layout L>
static int emu_pass_in(const PassParams& P, const Geometry& G,
                       const kpp::Inputs<Real>& in,
                       const kpp::Outputs<Real>& out) {
  if (g_spread == kpp::CLUSTER)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::pass_block<Real, FULL, 4, kpp::CLUSTER, L>(P, G, in, out, s); });
  if (g_spread == kpp::BLOCK)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::pass_block<Real, FULL, 4, kpp::BLOCK, L>(P, G, in, out, s); });
  if (g_spread == kpp::PAIR && G.ns == 3)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::pass_block<Real, FULL, 3, kpp::PAIR, L>(P, G, in, out, s); });
  if (g_spread == kpp::PAIR)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::pass_block<Real, FULL, 4, kpp::PAIR, L>(P, G, in, out, s); });
  return emu_grid(G, [&](unsigned char* s) {
    kpp::pass_block<Real, FULL, EMU_NS, kpp::WARP, L>(P, G, in, out, s); });
}

template <kpp::Layout L>
static int emu_step_in(const PassParams& P, const Geometry& G,
                       const kpp::Inputs<Real>& in,
                       const kpp::Outputs<Real>& out) {
  if (g_spread == kpp::CLUSTER)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::step_block<Real, 4, kpp::CLUSTER, L>(P, G, in, out, s); });
  if (g_spread == kpp::BLOCK)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::step_block<Real, 4, kpp::BLOCK, L>(P, G, in, out, s); });
  if (g_spread == kpp::PAIR && G.ns == 3)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::step_block<Real, 3, kpp::PAIR, L>(P, G, in, out, s); });
  if (g_spread == kpp::PAIR)
    return emu_grid(G, [&](unsigned char* s) {
      kpp::step_block<Real, 4, kpp::PAIR, L>(P, G, in, out, s); });
  return emu_grid(G, [&](unsigned char* s) {
    kpp::step_block<Real, EMU_NS, kpp::WARP, L>(P, G, in, out, s); });
}

template <bool FULL>
static int emu_pass(const PassParams& P, const Geometry& G,
                    const kpp::Inputs<Real>& in, const kpp::Outputs<Real>& out) {
#if EMU_ZL
  if (g_zaxis) return emu_pass_in<FULL, kpp::Z_LANES>(P, G, in, out);
#endif
  return emu_pass_in<FULL, kpp::COL_LANES>(P, G, in, out);
}

extern "C" {
void emu_zaxis(int zaxis) { g_zaxis = zaxis; }
void emu_spread(int spread) { g_spread = spread; }
void emu_barriers(long* out) {
  out[0] = g_block_bars;
  out[1] = g_cluster_bars;
  out[2] = g_pair_bars;
}
int kpp_real_bytes() { return int(sizeof(Real)); }
int kpp_max_wz() { return kpp::MAXWZ; }
int kpp_fused_pass(int full, const void* ins, const void* outs,
                   const void* params, const void* geom, void*) {
  const PassParams& P = *static_cast<const PassParams*>(params);
  const Geometry& G = *static_cast<const Geometry*>(geom);
  kpp::Inputs<Real> in;
  kpp::Outputs<Real> out;
  unpack(ins, outs, full ? 23 : 9, &in, &out);
  return full ? emu_pass<true>(P, G, in, out) : emu_pass<false>(P, G, in, out);
}
int kpp_fused_step(const void* ins, const void* outs, const void* params,
                   const void* geom, void*) {
  const PassParams& P = *static_cast<const PassParams*>(params);
  const Geometry& G = *static_cast<const Geometry*>(geom);
  kpp::Inputs<Real> in;
  kpp::Outputs<Real> out;
  unpack(ins, outs, 9, &in, &out);
#if EMU_ZL
  if (g_zaxis) return emu_step_in<kpp::Z_LANES>(P, G, in, out);
#endif
  return emu_step_in<kpp::COL_LANES>(P, G, in, out);
}
}
"""


def build_emu(tmp_path_factory, ns, zl):
    """The shim and fused_pass.cuh built with g++ in float64, one warp a
    column at ``ns`` slots; ``zl``: with the Z_LANES kernels too."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    d = tmp_path_factory.mktemp("emu")
    src, so = d / "emu.cc", d / "emu.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-DEMU_REAL=double",
                    f"-DEMU_NS={ns}", f"-DEMU_ZL={int(zl)}",
                    "-DEMU_TIMEOUT_S=60", "-I", ck._CSRC, "-o", str(so),
                    str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kpp_fused_pass.argtypes = [ci, vp, vp, vp, vp, vp]
    lib.kpp_fused_pass.restype = ci
    lib.kpp_fused_step.argtypes = [vp, vp, vp, vp, vp]
    lib.kpp_fused_step.restype = ci
    lib.emu_zaxis.argtypes = [ci]
    lib.emu_spread.argtypes = [ci]
    lib.emu_barriers.argtypes = [vp]
    return lib


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The emulation with one warp a column at EMU_NS slots."""
    return build_emu(tmp_path_factory, EMU_NS, False)


@pytest.fixture(scope="module")
def barriers():
    """{(spread, kernel): (block barriers, cluster barriers)} of the
    emulated launches this file makes, filled by the tests that make them
    (the cluster's at nz = 1100, the block's at nz = 1000)."""
    return {}


def count_barriers(lib):
    """(block, cluster, pair) barriers of ``lib``'s last launch: a block's
    and a cluster's counted once a block, a pair column's once a
    column."""
    out = (ctypes.c_long * 3)()
    lib.emu_barriers(ctypes.addressof(out))
    return out[0], out[1], out[2]


class Stop(Exception):
    pass


def first_inputs(nz, pass_impl, monkeypatch):
    """The wrapper and inputs of the first kernel call of a float64 step
    at ``nz`` over 3 columns on the CPU, with double diffusion: column 1
    land, column 0 with large u noise, u = 12 m/s on levels 700..704 and
    T 15 C colder below level 800, which the trap counts on block 1 alone
    (blocks hold 640 or 512 levels here) and retries on every attempt,
    column 2 quiet; salinity uniform down to level 700 and fresher below
    it, so that double diffusion parts dift from difs in block 1 alone."""
    ncol = 3
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=4000.0),
        time=T.TimeConfig(dtsec=1200.0, ndtocn=1, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(pass_impl=pass_impl, wscale_mode="nodal",
                               ldd=True),
        dtype="float64")
    m = T.KppModel(cfg, device="cpu")
    zm = m.grid.zm.double().numpy()
    rng = np.random.default_rng(5)
    t0 = 20.0 + 5.0 * np.exp(zm / 400.0) + 0.05 * rng.standard_normal(
        (ncol, nz + 1))
    s0 = np.full((ncol, nz + 1), 35.0)
    s0[:, 700:] -= 0.5 * np.linspace(0.0, 1.0, nz - 699)
    u0 = 0.02 * rng.standard_normal((ncol, nz + 1, 2))
    t0[0, 800:] -= 15.0
    u0[0] += 2.1 * rng.standard_normal((nz + 1, 2))
    u0[0, 700:705, 0] = 12.0
    prm = init_params(ncol, nz + 1, dtype=m.dtype)
    wet = torch.tensor([True, False, True])
    prm = prm.replace(f=coriolis(torch.tensor([-30.0, 0.0, 45.0],
                                              dtype=m.dtype)),
                      l_ocean=wet, run_physics=wet)
    st, prm, frc = m.warm_start(u0, t0, s0, prm)
    raw = tforcing.constant_test_fluxes(ncol, m.dtype, m.device)
    st, frc = tforcing.update_fluxes(cfg, st, prm, frc, raw, True, m.grid.dm)
    got = []

    def call(w, *a, **kw):
        got.append((w, a))
        raise Stop
    for cls in (ck.FusedPass, ck.FusedStep):
        monkeypatch.setattr(cls, "__call__", call)
    with pytest.raises(Stop):
        m.step(st, prm, frc, first_step=True)
    monkeypatch.undo()
    return got[0]


# the spread (csrc/fused_pass.cuh Spread) of each library's kernels
SPREAD = {ck.CL: 2, ck.MW: 1, **{p: 3 for p in ck.PAIRS}}


def run(lib, w, a, geom, monkeypatch, spread=None, **kw):
    """``w``'s kernel on ``a`` (and the launch's keywords ``kw``) through
    the emulation at ``geom``, in ``w``'s layout, by the kernels of
    ``spread`` (by default those of the geometry's library)."""
    lib.emu_zaxis(w.kw.get("zaxis", 0))
    lib.emu_spread(SPREAD.get(geom.lib, 0) if spread is None else spread)
    monkeypatch.setattr(ck, "_lib", lambda *x, **k: lib)
    monkeypatch.setattr(ck, "launch_geometry", lambda *x, **k: geom)
    monkeypatch.setattr(ck, "LAUNCHES", dict(ck.LAUNCHES))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=0))
    try:
        return w.launch(*a, **kw)
    finally:
        monkeypatch.undo()


def one_warp(nz, ncol, kref):
    """One warp a column at EMU_NS slots, aref's shared copy beside it."""
    smem = ck.smem_bytes(EMU_NS, kref, 1, 8)
    return ck.Geometry(warps=1, blocks=ncol, kref=kref, smem=smem, ns=EMU_NS,
                       aref_dev=0, cw=1, grid_dev=0, cb=1)


def forced_cluster(ncol, kref, cb, cw):
    return ck.Geometry(warps=cw, blocks=ncol * cb, kref=kref,
                       smem=ck.smem_bytes_cl(cw, 8), ns=ck.MW_NS, aref_dev=1,
                       cw=cw, grid_dev=1, cb=cb)


def kernels(pass_impl, w):
    """The wrappers to hold on the captured inputs: the step (with at most
    3 attempts, so that the trap column retries twice and the emulation
    stays short), or the fast and the full pass."""
    if pass_impl == "cuda_step":
        return [ck.FusedStep(dict(w.kw, comp_iter_max=2))]
    return [ck.FusedPass(dict(w.kw, full=full)) for full in (False, True)]


@pytest.mark.parametrize("pass_impl", ["cuda_step", "cuda"])
def test_cluster_equals_one_warp_at_nz1100(emu, monkeypatch, pass_impl,
                                           barriers):
    """nz = 1100 (WZ 1102): the cluster geometry launch_geometry takes (2
    blocks of 5 warps) against one warp of 36 slots, bit for bit."""
    nz = 1100
    w, a = first_inputs(nz, pass_impl, monkeypatch)
    kref = ck._ref_extents(a[-1])[1]
    geom = ck.launch_geometry(nz, torch.float64, 3, kref)
    assert (geom.lib, geom.cb, geom.cw, geom.blocks) == (ck.CL, 2, 5, 6)
    for k in kernels(pass_impl, w):
        got = run(emu, k, a, geom, monkeypatch)
        barriers["cl", k.name] = count_barriers(emu)
        ref = run(emu, k, a, one_warp(nz, 3, kref), monkeypatch)
        for i, (x, y) in enumerate(zip(got, ref)):
            assert torch.equal(x, y), (k.name if hasattr(k, "name") else
                                       "step", i)
        if pass_impl == "cuda_step":       # land; the trap's retries
            npass, reset = got[8][7], got[8][5]
            assert npass[1] == 0 and npass[0] > npass[2] > 0
            assert reset[0] == 3 and reset[2] == 1


@pytest.mark.parametrize("pass_impl", ["cuda_step", "cuda"])
def test_cluster_equals_block_at_nz1000(emu, monkeypatch, pass_impl,
                                        barriers):
    """nz = 1000 (WZ 1002): a cluster forced to 2 blocks of 4 warps
    against the multi-warp kernels of one block (8 warps), bit for bit."""
    nz = 1000
    w, a = first_inputs(nz, pass_impl, monkeypatch)
    kref = ck._ref_extents(a[-1])[1]
    block = ck.launch_geometry(nz, torch.float64, 3, kref)
    assert (block.lib, block.cw) == (ck.MW, 8)
    for k in kernels(pass_impl, w):
        got = run(emu, k, a, forced_cluster(3, kref, 2, 4), monkeypatch)
        ref = run(emu, k, a, block, monkeypatch)
        barriers["cw", k.name] = count_barriers(emu)
        for i, (x, y) in enumerate(zip(got, ref)):
            assert torch.equal(x, y), i


# the layouts: one warp a column at 3 slots (a block of 8 or 4 columns,
# the last ragged), a block of 2 warps a column, a pair of warps a column
# at 3 slots (4 columns a block, the last block ragged), a cluster of 2
# blocks of 1 warp (block 1 holding levels 128..131): (nz, ncol, dmax) of
# each, ~3 m levels, where the hmix loop converges in a few passes
LAYOUT_SPREADS = {"warp": (60, 11, 200.0), "block": (130, 3, 400.0),
                  "pair": (130, 5, 400.0), "cluster": (130, 3, 400.0)}


@pytest.fixture(scope="module")
def emu_zl(tmp_path_factory):
    """The emulation with one warp a column at 3 slots, both layouts."""
    return build_emu(tmp_path_factory, 3, True)


def layout_inputs(nz, ncol, dmax, pass_impl, monkeypatch, dscale=0.0,
                  land=(1,), kwargs=None):
    """The wrapper and (col_lanes) inputs of the first kernel call of a
    float64 step at ``nz`` over ``dmax`` m and ``ncol`` columns on the CPU
    (a grid stretched by ``dscale`` where it is not 0), with double
    diffusion: the columns ``land`` land, column 0 with large T and u
    noise (the trap retries it), the others quiet.  ``kwargs``: a dict
    that receives the call's keywords (the step's ``mask``)."""
    cfg = T.KppConfig(
        domain=T.DomainConfig(nx=ncol, ny=1, nz=nz, dmax=dmax,
                              l_stretchgrid=dscale > 0, dscale=dscale),
        time=T.TimeConfig(dtsec=1200.0, ndtocn=1, startt=0.0, finalt=1.0),
        physics=T.PhysicsFlags(pass_impl=pass_impl, wscale_mode="nodal",
                               ldd=True),
        dtype="float64")
    m = T.KppModel(cfg, device="cpu")
    zm = m.grid.zm.double().numpy()
    rng = np.random.default_rng(6)
    t0 = 20.0 + 5.0 * np.exp(zm / 40.0) + 0.05 * rng.standard_normal(
        (ncol, nz + 1))
    s0 = 35.0 - 0.3 * np.exp(zm / 60.0) + 0.01 * rng.standard_normal(
        (ncol, nz + 1))
    u0 = 0.02 * rng.standard_normal((ncol, nz + 1, 2))
    t0[0] += 3.0 * rng.standard_normal(nz + 1)
    u0[0] += 2.1 * rng.standard_normal((nz + 1, 2))
    prm = init_params(ncol, nz + 1, dtype=m.dtype)
    wet = torch.ones(ncol, dtype=torch.bool)
    wet[list(land)] = False
    lat = torch.linspace(-40.0, 40.0, ncol, dtype=m.dtype)
    prm = prm.replace(f=coriolis(lat), l_ocean=wet, run_physics=wet)
    st, prm, frc = m.warm_start(u0, t0, s0, prm)
    raw = tforcing.constant_test_fluxes(ncol, m.dtype, m.device)
    st, frc = tforcing.update_fluxes(cfg, st, prm, frc, raw, True, m.grid.dm)
    got = []

    def call(w, *a, **kw):
        got.append((w, a))
        if kwargs is not None:
            kwargs.update(kw)
        raise Stop
    for cls in (ck.FusedPass, ck.FusedStep):
        monkeypatch.setattr(cls, "__call__", call)
    with pytest.raises(Stop):
        m.step(st, prm, frc, first_step=True)
    monkeypatch.undo()
    return got[0]


@pytest.mark.parametrize("pass_impl", ["cuda_step", "cuda"])
@pytest.mark.parametrize("spread", list(LAYOUT_SPREADS))
def test_z_lanes_equals_col_lanes(emu_zl, monkeypatch, spread, pass_impl):
    """The z_lanes kernels ((ncol, nz + 2) profiles, the wrappers' zaxis
    1) against the col_lanes kernels on the same inputs transposed, bit
    for bit, in each spread: only the staging reads the layout."""
    nz, ncol, dmax = LAYOUT_SPREADS[spread]
    w, a = layout_inputs(nz, ncol, dmax, pass_impl, monkeypatch)
    kref = ck._ref_extents(a[-1])[1]
    if spread == "warp":
        geom = ck.launch_geometry(nz, torch.float64, ncol, kref)
        assert (geom.ns, geom.cw) == (3, 1) and geom.warps > 1
        assert ncol % geom.warps, "the last block is not ragged"
    elif spread == "block":     # the cw kernels at 2 warps a column
        geom = ck.Geometry(warps=2, blocks=ncol, kref=kref,
                           smem=ck.smem_bytes_mw(2, 0, 8), ns=ck.MW_NS,
                           aref_dev=1, cw=2, grid_dev=0, cb=1)
    elif spread == "pair":
        geom = ck.launch_geometry(nz, torch.float64, ncol, kref)
        assert (geom.lib, geom.cw) == ("pw3", 2) and geom.warps > 2
        assert ncol % geom.cols_per_block, "the last block is not ragged"
    else:
        geom = forced_cluster(ncol, kref, 2, 1)
    how = SPREAD.get("cw" if spread == "block" else geom.lib, 0)
    az = tuple(x.T.contiguous() for x in a)     # aref too: prof @ aref
    for k in kernels(pass_impl, w):
        kz = type(k)(dict(k.kw, zaxis=1))
        got = run(emu_zl, kz, az, geom, monkeypatch, how)
        ref = run(emu_zl, k, a, geom, monkeypatch, how)
        assert len(got) == len(ref)
        for i, (x, y) in enumerate(zip(got, ref)):
            assert x.shape == y.T.shape and torch.equal(x, y.T), i
        if pass_impl == "cuda_step":        # land; the trap's retries
            npass, reset = got[8][:, 7], got[8][:, 5]
            assert npass[1] == 0 and (npass[[0, 2]] > 0).all()
            assert reset[0] == 3, reset


@pytest.mark.parametrize("pass_impl", ["cuda_step", "cuda"])
def test_cluster_reads_past_the_pushed_levels(emu, monkeypatch, pass_impl):
    """A cluster of 2 blocks of 1 warp at nz = 130 (block 1 holds levels
    128..131, whose aref rows reach level 13): with the geometry's kref cut
    to 4, block 0 pushes only levels 0..3 of the reference averages' rows
    to block 1, which reads the rest of each prefix from block 0 through
    distributed shared memory (and the full pass, which pushes none, all
    of it); the outputs equal the one-warp design's, bit for bit."""
    nz, ncol, dmax = LAYOUT_SPREADS["cluster"]
    w, a = layout_inputs(nz, ncol, dmax, pass_impl, monkeypatch)
    kref = ck._ref_extents(a[-1])[1]
    assert kref > 8
    for k in kernels(pass_impl, w):
        got = run(emu, k, a, forced_cluster(ncol, 4, 2, 1), monkeypatch)
        ref = run(emu, k, a, one_warp(nz, ncol, kref), monkeypatch)
        for i, (x, y) in enumerate(zip(got, ref)):
            assert torch.equal(x, y), i


# the pair kernels past 128 levels, a column over a pair of warps of 3
# slots (nz 150) and of 4 (nz 254), several columns a block: (nz, dmax,
# dscale) of each case, ~3 m levels and a grid stretched by 5 (aref's rows
# reach further), where the hmix loop converges (at 1 m levels it runs to
# its 200-pass limit, and the host's rounding parts it from the plain
# body's); 5 columns leave the last block of 4 ragged
PAIR_CASES = [(150, 450.0, 0.0), (150, 1000.0, 5.0), (254, 760.0, 0.0),
              (254, 1500.0, 5.0)]
PAIR_NCOL = 5


def hold_to_plain_body(w, a, got):
    """``got``, a kernel's outputs on ``a``, against the port's plain body
    on the same inputs at the gate's float64 bar: 1e-10 of each output's
    scale, the integer rows (kbl, kmix, the step's flags and counts)
    equal."""
    body = fp._step_body if isinstance(w, ck.FusedStep) else fp._pass_body
    ref = body(*a, **w.kw)
    for i, (x, y) in enumerate(zip(got, ref)):
        scale = max(float(y.abs().max()), 1e-6)
        assert float((x - y).abs().max()) <= 1e-10 * scale, (w.name, i)
    pos, rows = INT_ROWS[w.name]
    for row in rows:
        assert torch.equal(got[pos][row], ref[pos][row]), (w.name, row)


@pytest.mark.parametrize("pass_impl", ["cuda_step", "cuda"])
@pytest.mark.parametrize("nz,dmax,dscale", PAIR_CASES)
def test_pair_equals_one_warp(emu, monkeypatch, nz, dmax, dscale, pass_impl,
                              barriers):
    """The geometry launch_geometry takes past 128 levels, columns over a
    pair of warps (3 slots at nz = 150, 4 at 254; 4 columns a block in
    float64, the last ragged), against the one-warp design at 36 slots,
    bit for bit, on a land column, a column the trap retries and double
    diffusion; and against the plain body at the gate's bar."""
    w, a = layout_inputs(nz, PAIR_NCOL, dmax, pass_impl, monkeypatch,
                         dscale)
    kref = ck._ref_extents(a[-1])[1]
    geom = ck.launch_geometry(nz, torch.float64, PAIR_NCOL, kref)
    ns = 3 if nz + 2 <= 192 else 4
    assert (geom.lib, geom.ns, geom.cw, geom.cb) == (f"pw{ns}", ns, 2, 1)
    assert PAIR_NCOL % geom.cols_per_block and geom.cols_per_block > 1
    for k in kernels(pass_impl, w):
        got = run(emu, k, a, geom, monkeypatch)
        barriers["pw", nz, dscale, k.name] = count_barriers(emu)
        ref = run(emu, k, a, one_warp(nz, PAIR_NCOL, kref), monkeypatch)
        for i, (x, y) in enumerate(zip(got, ref)):
            assert torch.equal(x, y), (k.name, i)
        hold_to_plain_body(k, a, got)
        if pass_impl == "cuda_step":        # land; the trap's retries
            npass, reset = got[8][7], got[8][5]
            assert npass[1] == 0 and (npass[[0, 2, 3, 4]] > 0).all()
            assert reset[0] == 3, reset



@pytest.mark.parametrize("pass_impl", ["cuda_step", "cuda"])
def test_pair_block_width_keeps_the_bits(emu, monkeypatch, pass_impl):
    """The float32 block of 8 pair columns (named barriers 1..8; 9
    columns, so the second block is ragged) against the float64 block of
    4 that test_pair_equals_one_warp holds, bit for bit, at nz = 190."""
    nz, ncol, dmax = 190, 9, 570.0
    w, a = layout_inputs(nz, ncol, dmax, pass_impl, monkeypatch)
    kref = ck._ref_extents(a[-1])[1]
    four = ck.launch_geometry(nz, torch.float64, ncol, kref)
    cols = ck.PW_COLS[4]
    eight = ck.Geometry(warps=2 * cols, blocks=-(-ncol // cols), kref=kref,
                        smem=ck.smem_bytes_pw(3, cols, 8), ns=3, aref_dev=1,
                        cw=2, grid_dev=0, cb=1)
    assert (four.cols_per_block, eight.cols_per_block, eight.blocks) == \
        (4, 8, 2)
    for k in kernels(pass_impl, w):
        got = run(emu, k, a, eight, monkeypatch)
        ref = run(emu, k, a, four, monkeypatch)
        for i, (x, y) in enumerate(zip(got, ref)):
            assert torch.equal(x, y), (k.name, i)

# (block, cluster, pair) barriers of one launch on the inputs of the cw
# and cl tests above (3 columns, one of them land; the step's columns run
# 18 and 6 passes): at most what the design with one barrier a PCR or scan stage and one a run
# of broadcasts takes.  Before it (two barriers a stage, one a broadcast,
# the RMSD sums read across blocks), in the comments: the cw step 2.5x as
# many, the cl step's cluster barriers 2.4x.
BARRIERS = {("cw", "fused_step"): (1310, 0, 0),       # (3230, 0)
            ("cw", "fused_pass_fast"): (168, 0, 0),   # (405, 0)
            ("cw", "fused_pass_full"): (294, 0, 0),   # (417, 0)
            ("cl", "fused_step"): (88, 2788, 0),      # (80, 6820)
            ("cl", "fused_pass_fast"): (6, 360, 0),   # (6, 858)
            ("cl", "fused_pass_full"): (6, 636, 0)}   # (6, 882)


# the pair kernels' named barriers of one launch on the uniform grids'
# inputs of test_pair_equals_one_warp (5 columns, one land; the step's
# columns run 18 and 6 passes), counted once a column, exactly: each a
# column's own (block barriers: 2 a block, staging and write-back)
PAIR_BARRIERS = {(150, "fused_step"): 1662, (150, "fused_pass_fast"): 230,
                 (150, "fused_pass_full"): 400, (254, "fused_step"): 1668,
                 (254, "fused_pass_fast"): 230, (254, "fused_pass_full"): 400}


def test_barriers_per_launch(emu, monkeypatch, barriers):
    """The barriers of the cw (nz = 1000, 8 warps) and cl (nz = 1100, 2
    blocks of 5 warps) launches above, counted by the emulation's
    barriers, at most ``BARRIERS``, and the pair kernels' (nz = 150 and
    254, 2 blocks of 4 columns), exactly ``PAIR_BARRIERS``; read from the
    runs the tests above made (made here only where those did not
    run)."""
    for pass_impl, kname in (("cuda_step", "fused_step"),
                             ("cuda", "fused_pass_fast")):
        if ("cw", kname) not in barriers:
            test_cluster_equals_block_at_nz1000(emu, monkeypatch, pass_impl,
                                                barriers)
        if ("cl", kname) not in barriers:
            test_cluster_equals_one_warp_at_nz1100(emu, monkeypatch,
                                                   pass_impl, barriers)
    for nz, dmax, dscale in PAIR_CASES:
        for pass_impl, kname in (("cuda_step", "fused_step"),
                                 ("cuda", "fused_pass_fast")):
            if dscale == 0.0 and ("pw", nz, dscale, kname) not in barriers:
                test_pair_equals_one_warp(emu, monkeypatch, nz, dmax, dscale,
                                          pass_impl, barriers)
    for key, (block, cluster, pair) in BARRIERS.items():
        got = barriers[key]
        assert got[0] <= block and got[1] <= cluster and got[2] <= pair, \
            (key, got)
    for (nz, kname), pair in PAIR_BARRIERS.items():
        assert barriers["pw", nz, 0.0, kname] == (4, 0, pair), (nz, kname)
