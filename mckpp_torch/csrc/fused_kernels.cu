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
//   for WZ <= 96, NS = 4 for WZ <= 128), so a column's profiles live in
//   registers and a small per-warp shared-memory area, not in per-thread
//   local memory (L2/HBM);
// * each warp runs its own column's convergence and trap loops, so a warp
//   never waits for a slower column, and a land column's warp skips them;
// * a block of W >= 8 warps takes W consecutive columns and stages their
//   inputs and outputs through shared memory, so each level row of a
//   profile moves as whole 32-byte sectors;
// * the reference averages run over each aref row's nonzero prefix.
// The launch geometry (warps per block, blocks, aref columns kept, dynamic
// shared-memory bytes, level slots) comes from the wrapper; the launcher
// checks the bytes against smem_bytes().  One library holds the three
// kernels of one type and one number of level slots.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -DKPP_REAL=float|double -DKPP_NS=3|4
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

namespace kpp {

constexpr int MAX_WARPS = 8;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory one block may use
// blocks per SM the register budget aims at: 2 x 8 warps (128 registers a
// thread) in float at NS = 3, 1 block otherwise (in double, and at NS = 4,
// whose third more profile registers would spill under 128; its shared
// memory holds one block of 8 warps at the worst kref)
template <typename T, int NS> struct MinBlocks {
  static constexpr int value = 1;
};
template <> struct MinBlocks<float, 3> { static constexpr int value = 2; };

template <typename T, bool FULL, int NS>
__global__ void __launch_bounds__(MAX_WARPS * 32, MinBlocks<T, NS>::value)
fused_pass_kernel(PassParams P, Geometry G, Inputs<T> in, Outputs<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  pass_block<T, FULL, NS>(P, G, in, out, smem_raw);
}

template <typename T, int NS>
__global__ void __launch_bounds__(MAX_WARPS * 32, MinBlocks<T, NS>::value)
fused_step_kernel(PassParams P, Geometry G, Inputs<T> in, Outputs<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  step_block<T, NS>(P, G, in, out, smem_raw);
}

// A block of fewer than MAX_WARPS warps is taken where the shared memory
// of 8 would not fit (float64 at NS = 4 with a deep aref prefix).
template <typename K>
int launch(K kern, const PassParams& P, const Geometry& G, cudaStream_t stream,
           const Inputs<KPP_REAL>& in, const Outputs<KPP_REAL>& out) {
  const size_t need = smem_bytes(KPP_NS, G.kref, G.warps,
                                 int(sizeof(KPP_REAL)));
  if (G.ns != KPP_NS || P.wz > 32 * KPP_NS
      || G.warps < 1 || G.warps > MAX_WARPS || G.kref < 0 || G.kref > P.wz
      || size_t(G.smem) != need || G.smem > SMEM_MAX
      || size_t(G.blocks) * G.warps < size_t(P.ncol))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G.smem);
  if (e != cudaSuccess) return int(e);
  if (P.ncol <= 0) return 0;
  kern<<<G.blocks, G.warps * 32, G.smem, stream>>>(P, G, in, out);
  return int(cudaGetLastError());
}

}  // namespace kpp

using kpp::Geometry;
using kpp::Inputs;
using kpp::Outputs;
using kpp::PassParams;
using Real = KPP_REAL;
constexpr int NSL = KPP_NS;   // the level slots of this library's kernels

static void unpack(const void* ins, const void* outs, int n_out,
                   Inputs<Real>* in, Outputs<Real>* out) {
  const void* const* ip = static_cast<const void* const*>(ins);
  void* const* op = static_cast<void* const*>(outs);
  for (int i = 0; i < kpp::N_IN; ++i) in->p[i] = static_cast<const Real*>(ip[i]);
  in->ref_hi = static_cast<const int*>(ip[kpp::N_IN]);
  for (int i = 0; i < kpp::N_OUT_MAX; ++i)
    out->p[i] = i < n_out ? static_cast<Real*>(op[i]) : nullptr;
}

extern "C" {

// element size of the build, for the wrapper's dtype check
int kpp_real_bytes() { return int(sizeof(Real)); }

// the levels this library's kernels cover (32 x its level slots)
int kpp_max_wz() { return 32 * NSL; }

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
// depth prefix), then the int32 aref row extents; outs: 9 (full=0) or 23
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
  return full ? kpp::launch(kpp::fused_pass_kernel<Real, true, NSL>, P, G, st,
                            in, out)
              : kpp::launch(kpp::fused_pass_kernel<Real, false, NSL>, P, G,
                            st, in, out);
}

// ins: the step's 21 inputs placed in the pass slots (ux..sx repeat
// u0..s0) + the depth prefix + the aref row extents; outs: 9 device
// pointers.
int kpp_fused_step(const void* ins, const void* outs, const void* params,
                   const void* geom, void* stream) {
  const PassParams& P = *static_cast<const PassParams*>(params);
  const Geometry& G = *static_cast<const Geometry*>(geom);
  Inputs<Real> in;
  Outputs<Real> out;
  unpack(ins, outs, 9, &in, &out);
  return kpp::launch(kpp::fused_step_kernel<Real, NSL>, P, G,
                     static_cast<cudaStream_t>(stream), in, out);
}

}  // extern "C"
