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
// One thread per column, 128 columns per block, the ragged last block
// masked; the per-block shared data (aref, grid rows, depth prefix) is
// loaded cooperatively before the mask.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -DKPP_REAL=float|double
// -fmad=false keeps each multiply and add rounded on its own, as the
// unfused eager torch ops that the kernels are held against round them.
#include <cuda_runtime.h>

#include "fused_pass.cuh"

#ifndef KPP_REAL
#define KPP_REAL float
#endif

namespace kpp {

constexpr int THREADS = 128;
constexpr int N_OUT_MAX = 23;

template <typename T> struct Outputs { T* p[N_OUT_MAX]; };

template <typename T>
__device__ Shared<T> load_shared(const PassParams& P, const Inputs<T>& in,
                                 unsigned char* raw) {
  const int wz = P.wz;
  T* sm = reinterpret_cast<T*>(raw);
  Shared<T> g;
  T* aref = sm;
  T* rows = sm + wz * wz;   // zm hm dm tdn tup pfx, wz each
  for (int i = threadIdx.x; i < wz * wz; i += blockDim.x) aref[i] = in.p[IN_AREF][i];
  const int src[6] = {IN_ZM, IN_HM, IN_DM, IN_TDN, IN_TUP, IN_PFX};
  const int nrows = P.l_advect ? 6 : 5;
  for (int i = threadIdx.x; i < nrows * wz; i += blockDim.x)
    rows[i] = in.p[src[i / wz]][i % wz];
  __syncthreads();
  g.aref = aref;
  g.zm = rows;
  g.hm = rows + wz;
  g.dm = rows + 2 * wz;
  g.tdn = rows + 3 * wz;
  g.tup = rows + 4 * wz;
  g.pfx = rows + 5 * wz;
  return g;
}

template <typename T>
size_t shared_bytes(const PassParams& P) {
  return (size_t(P.wz) * P.wz + 6 * size_t(P.wz)) * sizeof(T);
}

template <typename T, bool FULL>
__global__ void __launch_bounds__(THREADS)
fused_pass_kernel(PassParams P, Inputs<T> in, Outputs<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shared<T> g = load_shared<T>(P, in, smem_raw);
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= P.ncol) return;
  const int nc = P.ncol, wz = P.wz;
  T u[MAXWZ], v[MAXWZ], t[MAXWZ], s[MAXWZ];
  T ux[MAXWZ], vx[MAXWZ], tx[MAXWZ], sx[MAXWZ];
  T* w[8] = {u, v, t, s, ux, vx, tx, sx};
  for (int i = 0; i < 8; ++i)
    for (int k = 0; k < wz; ++k) w[i][k] = in.p[IN_U + i][k * nc + col];
  ColOut<T> co;
  pass_column<T, FULL>(P, in, g, col, u, v, t, s, ux, vx, tx, sx,
                       in.p[IN_COLSCAL][CS_F * nc + col], &co,
                       FULL ? out.p + 4 : nullptr);
  const int nprof = FULL ? 4 : 8;
  for (int i = 0; i < nprof; ++i)
    for (int k = 0; k < wz; ++k) out.p[i][k * nc + col] = w[i][k];
  if (!FULL) {
    const T c8[8] = {co.hbl, co.kbl, co.rho0, co.cp0, T(0), T(0), T(0), T(0)};
    for (int i = 0; i < 8; ++i) out.p[8][i * nc + col] = c8[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(PassParams P, Inputs<T> in, Outputs<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shared<T> g = load_shared<T>(P, in, smem_raw);
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= P.ncol) return;
  const int nc = P.ncol, wz = P.wz;
  T u[MAXWZ], v[MAXWZ], t[MAXWZ], s[MAXWZ];
  T ux[MAXWZ], vx[MAXWZ], tx[MAXWZ], sx[MAXWZ];
  T colstep[8];
  step_column<T>(P, in, g, col, u, v, t, s, ux, vx, tx, sx, colstep);
  T* w[8] = {u, v, t, s, ux, vx, tx, sx};
  for (int i = 0; i < 8; ++i)
    for (int k = 0; k < wz; ++k) out.p[i][k * nc + col] = w[i][k];
  for (int i = 0; i < 8; ++i) out.p[8][i * nc + col] = colstep[i];
}

template <typename K>
int launch(K kern, const PassParams& P, size_t smem, cudaStream_t stream,
           const Inputs<KPP_REAL>& in, const Outputs<KPP_REAL>& out) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  if (P.ncol <= 0) return 0;
  const int blocks = (P.ncol + THREADS - 1) / THREADS;
  kern<<<blocks, THREADS, smem, stream>>>(P, in, out);
  return int(cudaGetLastError());
}

}  // namespace kpp

using kpp::Inputs;
using kpp::Outputs;
using kpp::PassParams;
using Real = KPP_REAL;

static void unpack(const void* ins, const void* outs, int n_out,
                   Inputs<Real>* in, Outputs<Real>* out) {
  const void* const* ip = static_cast<const void* const*>(ins);
  void* const* op = static_cast<void* const*>(outs);
  for (int i = 0; i < kpp::N_IN; ++i) in->p[i] = static_cast<const Real*>(ip[i]);
  for (int i = 0; i < kpp::N_OUT_MAX; ++i)
    out->p[i] = i < n_out ? static_cast<Real*>(op[i]) : nullptr;
}

extern "C" {

// element size of the build, for the wrapper's dtype check
int kpp_real_bytes() { return int(sizeof(Real)); }

int kpp_max_wz() { return kpp::MAXWZ; }

// ins: host array of kpp::N_IN device pointers (the 25 pass inputs + the
// depth prefix); outs: 9 (full=0) or 23 (full=1) device pointers; params:
// host PassParams; stream: cudaStream_t.  Returns a cudaError_t code.
int kpp_fused_pass(int full, const void* ins, const void* outs,
                   const void* params, void* stream) {
  const PassParams& P = *static_cast<const PassParams*>(params);
  Inputs<Real> in;
  Outputs<Real> out;
  unpack(ins, outs, full ? 23 : 9, &in, &out);
  const size_t smem = kpp::shared_bytes<Real>(P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full ? kpp::launch(kpp::fused_pass_kernel<Real, true>, P, smem, st, in, out)
              : kpp::launch(kpp::fused_pass_kernel<Real, false>, P, smem, st, in, out);
}

// ins: the step's 21 inputs placed in the pass slots (ux..sx repeat
// u0..s0) + the depth prefix; outs: 9 device pointers.
int kpp_fused_step(const void* ins, const void* outs, const void* params,
                   void* stream) {
  const PassParams& P = *static_cast<const PassParams*>(params);
  Inputs<Real> in;
  Outputs<Real> out;
  unpack(ins, outs, 9, &in, &out);
  return kpp::launch(kpp::fused_step_kernel<Real>, P, kpp::shared_bytes<Real>(P),
                     static_cast<cudaStream_t>(stream), in, out);
}

}  // extern "C"
