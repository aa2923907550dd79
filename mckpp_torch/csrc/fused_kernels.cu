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
//   for WZ <= 96, 4 for WZ <= 128, 6 for WZ <= 192, 8 for WZ <= 256), so
//   a column's profiles live in registers and a small per-warp
//   shared-memory area, not in per-thread local memory (L2/HBM); at 6 and
//   8 slots a thread holds up to the 255 registers it may, and what ptxas
//   spills goes to local memory;
// * past 256 levels (WZ <= 1024) one column a block over CW = 3..8 warps
//   of 4 slots (the "cw" library, KPP_MW): the 4-slot register footprint,
//   the column's rows shared by its warps, block barriers where levels
//   meet, aref (and, for float64 at CW = 8, the grid rows) read from
//   device memory; a column's input rows are read one level at a time
//   (stride ncol), so its staging moves whole sectors for one value;
// * past 1024 levels (WZ <= 8192) one column over a cluster of CB = 2..8
//   blocks (the "cl" library, KPP_MW=2), each block CW warps of 4 slots
//   holding its slice of the column's rows; where levels meet, the blocks
//   read each other's slices through distributed shared memory between
//   cluster barriers; aref and the grid rows are read from device memory.
//   It launches with cudaLaunchKernelEx and a cluster dimension of CB, and
//   refuses (KPP_NO_CLUSTER) a geometry of which the card cannot hold one
//   cluster at once (cudaOccupancyMaxActiveClusters 0);
// * each warp runs its own column's convergence and trap loops, so a warp
//   never waits for a slower column, and a land column's warp skips them;
// * a block of W >= 8 warps takes W consecutive columns and stages their
//   inputs and outputs through shared memory, so each level row of a
//   profile moves as whole 32-byte sectors;
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
//   a copy in shared memory, or from a tile in device memory where no
//   block holds the copy (float64 at 8 slots on a stretched grid).
// The launch geometry (warps per block, blocks, aref columns kept, dynamic
// shared-memory bytes, level slots, aref's placement, warps a column, the
// grid rows' placement, the blocks of a column's cluster) comes from the
// wrapper; the launcher checks the bytes against smem_bytes(),
// smem_bytes_mw() or smem_bytes_cl().  One library holds the three
// kernels of one type and one number of level slots, or (KPP_MW=1, NS =
// 4) of a column over several warps, or (KPP_MW=2, NS = 4) of a column
// over a cluster, in one layout (KPP_ZL=0 COL_LANES, 1 Z_LANES).  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -DKPP_REAL=float|double -DKPP_NS=3|4|6|8
//        [-DKPP_MW=1|2] [-DKPP_ZL=1]
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

namespace kpp {

constexpr int MAX_WARPS = 8;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory one block may use
// blocks per SM the register budget aims at: 2 x 8 warps (128 registers a
// thread) in float at NS = 3, 1 block otherwise (in double, and from NS = 4
// up, whose profile registers would spill under 128; their shared memory
// holds one block at a time anyway)
template <typename T, int NS> struct MinBlocks {
  static constexpr int value = 1;
};
template <> struct MinBlocks<float, 3> { static constexpr int value = 2; };

static_assert(CW_MAX == MAX_WARPS, "a column's warps fill at most a block");
static_assert(!KPP_MW || KPP_NS == MW_NS, "a column over warps has 4 slots");

template <typename T, bool FULL, int NS, Spread MW, Layout L>
__global__ void __launch_bounds__(MAX_WARPS * 32, MinBlocks<T, NS>::value)
fused_pass_kernel(PassParams P, Geometry G, Inputs<T> in, Outputs<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  pass_block<T, FULL, NS, MW, L>(P, G, in, out, smem_raw);
}

template <typename T, int NS, Spread MW, Layout L>
__global__ void __launch_bounds__(MAX_WARPS * 32, MinBlocks<T, NS>::value)
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
  if (KPP_MW)   // one column a block over cw warps, aref from device memory
    return common && G.cw >= 2 && G.cw <= CW_MAX && G.warps == G.cw
           && P.wz <= 32 * KPP_NS * G.cw && G.aref_dev == 1 && in.aref_t
           && (G.grid_dev == 0 || (G.grid_dev == 1 && in.grid_t))
           && size_t(G.smem) == smem_bytes_mw(G.cw, G.grid_dev, tsize)
           && G.blocks >= P.ncol;
  return common && G.cw == 1 && G.grid_dev == 0 && P.wz <= 32 * KPP_NS
         && G.warps >= 1 && G.warps <= MAX_WARPS
         && (G.aref_dev == 0 || G.aref_dev == 1)
         && (!G.aref_dev || (KPP_NS >= AREF_DEV_MIN_NS && in.aref_t))
         && size_t(G.smem) == smem_bytes(KPP_NS, G.aref_dev ? 0 : G.kref,
                                         G.warps, tsize)
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

// A block of fewer than MAX_WARPS warps is taken where the shared memory
// of 8 would not fit (float64 from NS = 4 up, float at NS = 8 with a deep
// aref prefix).  With aref_dev (from AREF_DEV_MIN_NS slots up, and always
// in the MW library) the kernels read in.aref_t, which must be given; with
// grid_dev (MW) in.grid_t.
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
  for (int i = 0; i < kpp::N_OUT_MAX; ++i)
    out->p[i] = i < n_out ? static_cast<Real*>(op[i]) : nullptr;
}

extern "C" {

// element size of the build, for the wrapper's dtype check
int kpp_real_bytes() { return int(sizeof(Real)); }

// the layout of the build (the JAX package's zaxis), for the wrapper's check
int kpp_zaxis() { return int(LAYOUT); }

// the levels this library's kernels cover (32 x its level slots, times
// the most warps of a block in the MW libraries, times the most blocks of
// a cluster in the CLUSTER one)
int kpp_max_wz() {
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
// (null unless geom's grid_dev is set); outs: 9 (full=0) or 23
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
// (or null) + the grid rows' tile (or null); outs: 9 device pointers.
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
