// CUDA kernels for the fused ocean pass and step, with a plain C interface
// loaded by mckpp_torch/ops/cuda_kernels.py through ctypes.
//
// fused_pass_kernel<T, false>  replaces the Pallas kernel of
//     mckpp_tpu/ops/fused_pass.py make_fused_pass(full=False)
//     (pallas_call at fused_pass.py:1031, body _pass_body);
// fused_pass_kernel<T, true>   replaces make_fused_pass(full=True), the
//     same pallas_call with the diagnostic outputs;
// fused_step_kernel<T>         replaces make_fused_step (pallas_call at
//     fused_pass.py:1149, body _step_body).
//
// What bounds them on the H100: one pass of one column at nz = 69 needs
// ~49,600 floating-point operations (EOS polynomials and four PCR solves on
// two distinct matrices at every level, the reference averages over aref's
// nonzeros; cuda_kernels.pass_ops) on ~6.4 KB
// (fast) or ~10.4 KB (full) of profiles moved once; one pass is bytes-bound
// on paper and the step, ~6 passes per active column on data that stays on
// chip, is bound by operations.  What the design does about it
// (fused_pass.cuh has the details):
// * one warp per column, levels on lanes (NS slots of 32 levels: NS = 3
//   for WZ <= 96, 4 for WZ <= 128), so a column's profiles live in
//   registers and a small per-warp shared-memory area, not in per-thread
//   local memory (L2/HBM);
// * past 128 levels (WZ <= 256) one column over a pair of warps of NS = 3
//   (WZ <= 192) or 4 slots, several columns a block (the "pw3" and "pw4"
//   libraries, KPP_MW=3): a thread holds 3 or 4 slots where one warp
//   would hold 6 or 8 (220-255 registers, 8 warps an SM), the column's
//   rows shared by its two warps, which meet at a named barrier of their
//   own (bar.sync 1 + the column's place in the block, 64 threads; its
//   barrier.red forms for the column AND and count), so a column never
//   waits for the block's others; the multi-warp body below, aref read
//   from device memory; a level row of a profile staged as a run of the
//   block's columns;
// * past 256 levels (WZ <= 1024) one column a block over CW = 3..8 warps
//   of 4 slots (the "cw" library, KPP_MW): the 4-slot register footprint,
//   the column's rows shared by its warps, block barriers where levels
//   meet, as few as the hazards allow (one a PCR or scan stage on
//   alternating buffers, one a run of broadcasts), aref (and, for float64
//   at CW = 8, the grid rows) read from device memory; a column's input
//   rows are read one level at a time (stride ncol), so its staging moves
//   whole sectors for one value;
// * past 1024 levels (WZ <= 8192) one column over a cluster of CB = 2..8
//   blocks (the "cl" library, KPP_MW=2), each block CW warps of 4 slots
//   holding its slice of the column's rows; where levels meet, the blocks
//   read each other's slices through distributed shared memory between
//   cluster barriers (their own levels at home, the reference averages'
//   first levels from a copy block 0 pushes to each); aref and the grid
//   rows are read from device memory.
//   It launches with cudaLaunchKernelEx and a cluster dimension of CB, and
//   refuses (KPP_NO_CLUSTER) a geometry of which the card cannot hold one
//   cluster at once (cudaOccupancyMaxActiveClusters 0);
// * each warp runs its own column's convergence and trap loops, so a warp
//   never waits for a slower column, and a land column's warp skips them;
// * a block of W >= 8 warps takes W consecutive columns and stages their
//   inputs and outputs through shared memory, so each level row of a
//   profile moves as whole 32-byte sectors; the step's one-warp and pair
//   blocks take W consecutive entries of a column order instead where
//   the wrapper gives one (the ocean columns first, then the land ones:
//   a block holds its SM's warp slots until its slowest column is done,
//   so a land warp beside ocean ones would hold its slot idle), each
//   block's row then W near-consecutive values;
// * both layouts of the JAX package (its zaxis; the template parameter L
//   of the staging, one library each, KPP_ZL): COL_LANES (zaxis = 0),
//   profiles (WZ, ncol), and Z_LANES (zaxis = 1), profiles (ncol, WZ), the
//   state's own order, so the step's glue transposes nothing.  The bytes
//   and operations, and so the bounds, are the same in both; in Z_LANES a
//   block's W columns are one run of W * WZ values, each warp staging its
//   own column (32 consecutive values an access), and a column over
//   several warps or a cluster reads its levels as consecutive values where
//   COL_LANES reads one value a level at stride ncol (a 32-byte sector for
//   each 4- or 8-byte value);
// * the reference averages run over each aref row's nonzero prefix, from
//   a copy in shared memory (one warp a column) or from a tile in device
//   memory (a column over several warps or a cluster).
// The launch geometry (warps per block, blocks, aref columns kept, dynamic
// shared-memory bytes, level slots, aref's placement, warps a column, the
// grid rows' placement, the blocks of a column's cluster) comes from the
// wrapper; the launcher checks the bytes against smem_bytes(),
// smem_bytes_pw(), smem_bytes_mw() or smem_bytes_cl().  One library holds
// the three kernels of one type and one number of level slots, or
// (KPP_MW=3, NS = 3 or 4) of a column over a pair of warps, or (KPP_MW=1,
// NS = 4) of a column over several warps, or (KPP_MW=2, NS = 4) of a
// column over a cluster, in one layout (KPP_ZL=0 COL_LANES, 1 Z_LANES).
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -DKPP_REAL=float|double -DKPP_NS=3|4
//        [-DKPP_MW=1|2|3] [-DKPP_ZL=1]
// -fmad=false keeps each multiply and add rounded on its own, as the
// unfused eager torch ops that the kernels are held against round them.
#include <cuda_runtime.h>

#include "fused_pass.cuh"

#ifndef KPP_REAL
#define KPP_REAL float
#endif
#ifndef KPP_NS
#define KPP_NS 3
#endif
#ifndef KPP_MW
#define KPP_MW 0
#endif
#ifndef KPP_ZL
#define KPP_ZL 0
#endif
// KPP_F32: 1 in a float32 build (KPP_REAL float), else 0
#define KPP_F32_float 1
#define KPP_F32_OF_(r) KPP_F32_##r
#define KPP_F32_OF(r) KPP_F32_OF_(r)
#if KPP_F32_OF(KPP_REAL)
#define KPP_F32 1
#else
#define KPP_F32 0
#endif
// The cw kernels in float32 are capped at 168 registers a thread
// (__maxnreg__: where their 203 held 2 blocks of 4 warps an SM, 168 holds
// 3, with no spill); the cl kernels in float32 are bound for 2 blocks of
// 256 threads an SM (MinBlocks: 128 registers, spilling, but on a card
// full of clusters the second block of 8 warps outweighs the spills; a
// single cluster's step, latency-bound, runs ~20% slower so, and bound
// for one block, 255 registers, the step on 16,384 columns gave back most
// of its gain and the fast pass ran slower).  float64, whose values take
// two registers each, keeps one block of 256 threads an SM (capped as
// float32, its cw step ran 12% and its cl step 30% slower).  The pair
// kernels (KPP_MW=3) in float32 are capped at 128 registers a thread: one
// block of 8 columns, 16 warps an SM; the step spills (44 B a thread at 3
// slots, ~270 at 4) where at 168 it did not (141 and 168 registers, 12
// warps an SM), but ran 10-15% faster so.  float64: one block of 4
// columns (8 warps) an SM.
#if KPP_MW == 1 && KPP_F32
#define KPP_BOUNDS(T, NS) __maxnreg__(168)
#elif KPP_MW == 3 && KPP_F32
#define KPP_BOUNDS(T, NS) __maxnreg__(128)
#else
#define KPP_BOUNDS(T, NS) \
  __launch_bounds__(MAX_WARPS * 32, MinBlocks<T, NS>::value)
#endif

namespace kpp {

constexpr int MAX_WARPS = 8;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory one block may use
// blocks per SM the register budget aims at: 2 x 8 warps (128 registers a
// thread) in float at NS = 3 and in the float cl kernels (above), 1 block
// otherwise (in double, and from NS = 4 up, whose profile registers would
// spill under 128; their shared memory holds one block at a time anyway)
template <typename T, int NS> struct MinBlocks {
  static constexpr int value = KPP_MW == 2 && KPP_F32 ? 2 : 1;
};
template <> struct MinBlocks<float, 3> { static constexpr int value = 2; };

static_assert(CW_MAX == MAX_WARPS, "a column's warps fill at most a block");
static_assert(!KPP_MW || KPP_NS == MW_NS || (KPP_MW == PAIR && KPP_NS == 3),
              "a column over warps has 4 slots (a pair: 3 or 4)");

template <typename T, bool FULL, int NS, Spread MW, Layout L>
__global__ void KPP_BOUNDS(T, NS)
fused_pass_kernel(PassParams P, Geometry G, Inputs<T> in, Outputs<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  pass_block<T, FULL, NS, MW, L>(P, G, in, out, smem_raw);
}

template <typename T, int NS, Spread MW, Layout L>
__global__ void KPP_BOUNDS(T, NS)
fused_step_kernel(PassParams P, Geometry G, Inputs<T> in, Outputs<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  step_block<T, NS, MW, L>(P, G, in, out, smem_raw);
}

// the checks of one launch's geometry against this library's kernels
bool geometry_ok(const PassParams& P, const Geometry& G,
                 const Inputs<KPP_REAL>& in) {
  const int tsize = int(sizeof(KPP_REAL));
  const bool common = G.ns == KPP_NS && G.kref >= 0 && G.kref <= P.wz
                      && G.smem <= SMEM_MAX;
  if (KPP_MW == CLUSTER)   // one column over cb blocks of cw warps each,
                           // every block holding some of its levels
    return common && G.cb >= 2 && G.cb <= CB_MAX && G.cw >= 1
           && G.cw <= CW_MAX && G.warps == G.cw
           && P.wz <= 32 * KPP_NS * G.cw * G.cb
           && P.wz > 32 * KPP_NS * G.cw * (G.cb - 1)
           && G.aref_dev == 1 && in.aref_t && G.grid_dev == 1 && in.grid_t
           && size_t(G.smem) == smem_bytes_cl(G.cw, tsize)
           && size_t(G.blocks) == size_t(P.ncol) * G.cb;
  if (G.cb != 1) return false;
  if (KPP_MW == PAIR)   // cols = warps / 2 columns a block, each over a
                        // pair of warps; aref from device memory
    return common && G.cw == PW_CW && G.warps >= PW_CW
           && G.warps % PW_CW == 0 && G.warps <= PW_CW * PW_COLS_MAX
           && P.wz <= 32 * PW_CW * KPP_NS && G.aref_dev == 1 && in.aref_t
           && G.grid_dev == 0
           && size_t(G.smem) == smem_bytes_pw(KPP_NS, G.warps / PW_CW, tsize)
           && size_t(G.blocks) * (G.warps / PW_CW) >= size_t(P.ncol);
  if (KPP_MW)   // one column a block over cw warps, aref from device memory
    return common && G.cw >= 2 && G.cw <= CW_MAX && G.warps == G.cw
           && P.wz <= 32 * KPP_NS * G.cw && G.aref_dev == 1 && in.aref_t
           && (G.grid_dev == 0 || (G.grid_dev == 1 && in.grid_t))
           && size_t(G.smem) == smem_bytes_mw(G.cw, G.grid_dev, tsize)
           && G.blocks >= P.ncol;
  return common && G.cw == 1 && G.grid_dev == 0 && P.wz <= 32 * KPP_NS
         && G.warps >= 1 && G.warps <= MAX_WARPS && G.aref_dev == 0
         && size_t(G.smem) == smem_bytes(KPP_NS, G.kref, G.warps, tsize)
         && size_t(G.blocks) * G.warps >= size_t(P.ncol);
}

#if KPP_MW == 2
// the launcher's code for a cluster the card cannot hold (not a CUDA error)
constexpr int KPP_NO_CLUSTER = -2;

// geometry G's launch: ncol clusters of cb blocks, each cluster one
// column (``attr`` holds the launch's one attribute, the cluster size)
inline cudaLaunchConfig_t cluster_launch(const Geometry& G,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = unsigned(G.cb);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(G.blocks));
  cfg.blockDim = dim3(unsigned(G.warps * 32));
  cfg.dynamicSmemBytes = size_t(G.smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}
#endif

// A one-warp block of fewer than MAX_WARPS warps is taken where the
// shared memory of 8 would not fit (float64 with a deep aref prefix).  With aref_dev (a column over several warps or a cluster) the
// kernels read in.aref_t, which must be given; with grid_dev (MW)
// in.grid_t.
template <typename K>
int launch(K kern, const PassParams& P, const Geometry& G, cudaStream_t stream,
           const Inputs<KPP_REAL>& in, const Outputs<KPP_REAL>& out) {
  if (!geometry_ok(P, G, in)) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G.smem);
  if (e != cudaSuccess) return int(e);
  if (P.ncol <= 0) return 0;
#if KPP_MW == 2
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(G, stream, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return int(e);
  if (clusters < 1) return KPP_NO_CLUSTER;
  e = cudaLaunchKernelEx(&cfg, kern, P, G, in, out);
  if (e != cudaSuccess) return int(e);
#else
  kern<<<G.blocks, G.warps * 32, G.smem, stream>>>(P, G, in, out);
#endif
  return int(cudaGetLastError());
}

#if KPP_MW == 2
// the clusters of geometry G the card holds at once, for kernel ``kind``
// (0 the fast pass, 1 the full pass, 2 the step), or a negative CUDA error
template <typename K>
int max_clusters(K kern, const Geometry& G) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G.smem);
  if (e != cudaSuccess) return -int(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(G, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  return e != cudaSuccess ? -int(e) : clusters;
}
#endif

}  // namespace kpp

using kpp::Geometry;
using kpp::Inputs;
using kpp::Outputs;
using kpp::PassParams;
using Real = KPP_REAL;
constexpr int NSL = KPP_NS;   // the level slots of this library's kernels
// ... whose column spreads over one warp, a block's warps or a cluster
constexpr kpp::Spread MWL = kpp::Spread(KPP_MW);
// ... which take their arrays in this layout
constexpr kpp::Layout LAYOUT = kpp::Layout(KPP_ZL);

static void unpack(const void* ins, const void* outs, int n_out,
                   Inputs<Real>* in, Outputs<Real>* out) {
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

extern "C" {

// element size of the build, for the wrapper's dtype check
int kpp_real_bytes() { return int(sizeof(Real)); }

// the layout of the build (the JAX package's zaxis), for the wrapper's check
int kpp_zaxis() { return int(LAYOUT); }

// the levels this library's kernels cover (32 x its level slots, times
// the 2 warps of a column in the PAIR libraries, the most warps of a
// block in the MW libraries, times the most blocks of a cluster in the
// CLUSTER one)
int kpp_max_wz() {
  if (MWL == kpp::PAIR) return 32 * kpp::PW_CW * NSL;
  return 32 * NSL * (MWL ? kpp::CW_MAX : 1)
         * (MWL == kpp::CLUSTER ? kpp::CB_MAX : 1);
}

#if KPP_MW == 2
// cudaOccupancyMaxActiveClusters of one kernel (kind 0 the fast pass, 1
// the full pass, 2 the step) at geometry geom (host Geometry)
int kpp_max_clusters(int kind, const void* geom) {
  const Geometry& G = *static_cast<const Geometry*>(geom);
  if (kind == 0)
    return kpp::max_clusters(
        kpp::fused_pass_kernel<Real, false, NSL, MWL, LAYOUT>, G);
  if (kind == 1)
    return kpp::max_clusters(
        kpp::fused_pass_kernel<Real, true, NSL, MWL, LAYOUT>, G);
  return kpp::max_clusters(kpp::fused_step_kernel<Real, NSL, MWL, LAYOUT>, G);
}
#endif

#ifdef KPP_PHASES
// the stage clocks of fused_pass.cuh: copy the 16 sums out, or zero them
int kpp_phase_read(unsigned long long* out) {
  return int(cudaMemcpyFromSymbol(out, kpp_phase, sizeof(kpp_phase)));
}
int kpp_phase_zero() {
  const unsigned long long z[16] = {0};
  return int(cudaMemcpyToSymbol(kpp_phase, z, sizeof(z)));
}
#endif

// ins: host array of kpp::N_IN device pointers (the 25 pass inputs + the
// depth prefix), then the int32 aref row extents, then aref's device tile
// (null unless geom's aref_dev is set), then the grid rows' padded tile
// (null unless geom's grid_dev is set), then a null (the column order,
// which the passes do not take); outs: 9 (full=0) or 23
// (full=1) device pointers; params: host PassParams; geom: host Geometry;
// stream: cudaStream_t.  Returns a cudaError_t code.
int kpp_fused_pass(int full, const void* ins, const void* outs,
                   const void* params, const void* geom, void* stream) {
  const PassParams& P = *static_cast<const PassParams*>(params);
  const Geometry& G = *static_cast<const Geometry*>(geom);
  Inputs<Real> in;
  Outputs<Real> out;
  unpack(ins, outs, full ? 23 : 9, &in, &out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full ? kpp::launch(
                    kpp::fused_pass_kernel<Real, true, NSL, MWL, LAYOUT>, P,
                    G, st, in, out)
              : kpp::launch(
                    kpp::fused_pass_kernel<Real, false, NSL, MWL, LAYOUT>, P,
                    G, st, in, out);
}

// ins: the step's 21 inputs placed in the pass slots (ux..sx repeat
// u0..s0) + the depth prefix + the aref row extents + aref's device tile
// (or null) + the grid rows' tile (or null) + the int32 column order (or
// null: slot i takes column i); outs: 9 device pointers.
int kpp_fused_step(const void* ins, const void* outs, const void* params,
                   const void* geom, void* stream) {
  const PassParams& P = *static_cast<const PassParams*>(params);
  const Geometry& G = *static_cast<const Geometry*>(geom);
  Inputs<Real> in;
  Outputs<Real> out;
  unpack(ins, outs, 9, &in, &out);
  return kpp::launch(kpp::fused_step_kernel<Real, NSL, MWL, LAYOUT>, P, G,
                     static_cast<cudaStream_t>(stream), in, out);
}

}  // extern "C"
