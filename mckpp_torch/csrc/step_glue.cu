// The fused step's glue around fused_step_kernel, as two kernels with a
// plain C interface, built and loaded by mckpp_torch/ops/cuda_kernels.py
// through ctypes (its library GLUE); their plain versions and wrappers are in
// mckpp_torch/ops/step_glue.py.
//
// glue_in_kernel<T, ZL>   before the step: the history-phase repair, the
//     selects of the two history levels, the extrapolation 2 * new - old,
//     the pad to WZ rows and the change to the kernels' layout, writing the
//     step's ten profile inputs;
// glue_out_kernel<T, ZL>  after it: the levels back to the state's layout,
//     the current damping, the history ping-pong, check_profile's reset and
//     freezing floor, the land select and bottomtemp's pin (the isotherm
//     test stays in torch, ops/step_glue.py).
//
// They replace no TPU kernel: the JAX package leaves this glue to XLA.
// Both are bound by bytes: each element of the state is read once and each
// output written once (at nz = 69 and 144,507 columns in float32, ~0.57 GB
// in and 0.41 GB out before the step, ~0.55 GB in and 0.57 GB out after
// it).  A block takes TC = 32 consecutive columns and walks their levels in
// tiles of TL; in COL_LANES (ZL false) the kernels' profiles are (WZ, ncol)
// and the state's (ncol, nz + 1, ...), so the tile goes through shared
// memory: one side is read or written a level row of 32 columns at a time
// (128 or 256 contiguous bytes), the other a column's run of levels.  In
// Z_LANES (ZL true) both sides are a column's run of levels and nothing is
// staged.  A block owns its columns' levels, so the per-column sums of the
// damping and freezing fractions (counts of 0/1, exact in any order) stay
// in the block.
//
// The arithmetic is torch's on the card: a division by a Python scalar is
// a product with its reciprocal (div_s), each product and sum is rounded on
// its own (-fmad=false), selects copy bits.
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libkpp_glue.so step_glue.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace step_glue {

constexpr int NT = 256;  // threads a block
constexpr int TC = 32;   // columns a block

// levels a tile at most (COL_LANES): 32 in float and 16 in double before
// the step (ten staged profiles), twice as many after it (four); the staged
// tiles fit 48 KB of static shared memory
template <typename T>
constexpr int IN_LEVELS = 128 / (int)sizeof(T);
template <typename T>
constexpr int OUT_LEVELS = 256 / (int)sizeof(T);

// the levels of each of the fewest tiles of at most ``most`` levels that
// cover ``n`` (so a short last tile leaves no threads idle)
__device__ __forceinline__ int tile_span(int n, int most) {
  const int tiles = (n + most - 1) / most;
  return (n + tiles - 1) / tiles;
}

template <typename T>
__device__ __forceinline__ T div_s(T x, double s) {
  return x * (T(1) / T(s));
}

// four and two consecutive values of a 16-byte aligned row, in as few
// accesses as the type allows
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static __device__ __forceinline__ void ld4(const float* p, float* o) {
    const float4 v = *(const float4*)p;
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void st4(float* p, const float* o) {
    *(float4*)p = make_float4(o[0], o[1], o[2], o[3]);
  }
  static __device__ __forceinline__ void ld2(const float* p, float* o) {
    const float2 v = *(const float2*)p;
    o[0] = v.x; o[1] = v.y;
  }
  static __device__ __forceinline__ void st2(float* p, const float* o) {
    *(float2*)p = make_float2(o[0], o[1]);
  }
};
template <>
struct Vec<double> {
  static __device__ __forceinline__ void ld4(const double* p, double* o) {
    ld2(p, o);
    ld2(p + 2, o + 2);
  }
  static __device__ __forceinline__ void st4(double* p, const double* o) {
    st2(p, o);
    st2(p + 2, o + 2);
  }
  static __device__ __forceinline__ void ld2(const double* p, double* o) {
    const double2 v = *(const double2*)p;
    o[0] = v.x; o[1] = v.y;
  }
  static __device__ __forceinline__ void st2(double* p, const double* o) {
    *(double2*)p = make_double2(o[0], o[1]);
  }
};

struct InArgs {
  const void *us, *xs, *u, *x, *swdk, *swfrac;
  const int *old_, *new_;
  long long sw_sc[2], sw_sl[2];  // swdk_opt's and swfrac's strides
  void* out[10];
  int ncol, nzp1, wz;
};

struct OutArgs {
  const void* q[4];    // u, v, T, S in the kernels' layout
  const void* src[4];  // rho, cp, tinc_fcorr, ocntcorr at levels
  long long src_sc[4], src_sl[4];
  const void *st_u, *st_x, *st_us, *st_xs, *u_init, *ocnt_clim, *sal_clim,
      *st_rho, *st_cp, *st_tinc, *st_ocnt, *st_uref, *st_vref, *st_tref,
      *st_dampu, *st_dampv, *st_ff, *bottom_temp;
  const unsigned char *comp, *rp, *ocean;
  const int *old_, *new_;
  const void *rho0, *cp0;  // a lazy step's surface rows, or null
  void *u, *x, *us, *xs, *rho, *cp, *tinc, *ocnt, *uref, *vref, *tref,
      *dampu, *dampv, *ff;  // tinc, ocnt, ff: null where not written
  int ncol, nzp1, wz, nz, damp, have_clim, no_freeze, bottom;
  double damp_r, dto;
};

// The repaired history phases of column c.
__device__ __forceinline__ void phases(const int* old_, const int* new_,
                                       int c, int* o_r, int* n_r) {
  const int o = old_[c], n = new_[c];
  *o_r = (o < 0 || o > 1) ? n : o;
  *n_r = (n < 0 || n > 1) ? *o_r : n;
}

// The ten inputs of the step at level l (< wz) of column c; ``sel``: bit 0
// the repaired new phase is 1, bit 1 the old one is.
template <typename T>
__device__ __forceinline__ void glue_in_point(const InArgs& a, int c, int l,
                                              int sel, T* v) {
  if (l >= a.nzp1) {
#pragma unroll
    for (int f = 0; f < 10; ++f) v[f] = T(0);  // the pad row
    return;
  }
  const bool sn = sel & 1, so = sel & 2;
  const size_t p = (size_t)c * a.nzp1 + l;
  T h[4];  // [component][phase]
  Vec<T>::ld4((const T*)a.us + 4 * p, h);
  v[0] = T(2) * (sn ? h[1] : h[0]) - (so ? h[1] : h[0]);
  v[1] = T(2) * (sn ? h[3] : h[2]) - (so ? h[3] : h[2]);
  Vec<T>::ld4((const T*)a.xs + 4 * p, h);
  v[2] = T(2) * (sn ? h[1] : h[0]) - (so ? h[1] : h[0]);
  v[3] = T(2) * (sn ? h[3] : h[2]) - (so ? h[3] : h[2]);
  Vec<T>::ld2((const T*)a.u + 2 * p, v + 4);
  Vec<T>::ld2((const T*)a.x + 2 * p, v + 6);
  v[8] = ((const T*)a.swdk)[c * a.sw_sc[0] + l * a.sw_sl[0]];
  v[9] = ((const T*)a.swfrac)[c * a.sw_sc[1] + l * a.sw_sl[1]];
}

template <typename T, bool ZL>
__global__ void __launch_bounds__(NT) glue_in_kernel(InArgs a) {
  constexpr int TLM = IN_LEVELS<T>;
  __shared__ T tile[ZL ? 1 : 10][TLM][TC + 1];
  __shared__ int sel[TC];
  const int t = threadIdx.x, c0 = blockIdx.x * TC;
  const int nc = min(TC, a.ncol - c0);
  if (t < nc) {
    int o_r, n_r;
    phases(a.old_, a.new_, c0 + t, &o_r, &n_r);
    sel[t] = (n_r == 1) | ((o_r == 1) << 1);
  }
  __syncthreads();
  if (ZL) {
    // the block's outputs are one run of nc * wz values a profile
    for (int i = t; i < nc * a.wz; i += NT) {
      const int cl = i / a.wz, l = i - cl * a.wz;
      T v[10];
      glue_in_point(a, c0 + cl, l, sel[cl], v);
      const size_t k = (size_t)c0 * a.wz + i;
#pragma unroll
      for (int f = 0; f < 10; ++f) ((T*)a.out[f])[k] = v[f];
    }
    return;
  }
  const int tl = tile_span(a.wz, TLM);
  for (int l0 = 0; l0 < a.wz; l0 += tl) {
    const int n = min(tl, a.wz - l0);
    // a column's run of levels in the state's layout
    for (int i = t; i < nc * n; i += NT) {
      const int cl = i / n, ll = i - cl * n;
      T v[10];
      glue_in_point(a, c0 + cl, l0 + ll, sel[cl], v);
#pragma unroll
      for (int f = 0; f < 10; ++f) tile[f][ll][cl] = v[f];
    }
    __syncthreads();
    // a level row of the block's columns in the kernels' layout
    const int cl = t % TC;
    for (int lr = t / TC; lr < n; lr += NT / TC) {
      if (cl >= nc) continue;
      const size_t k = (size_t)(l0 + lr) * a.ncol + c0 + cl;
#pragma unroll
      for (int f = 0; f < 10; ++f) ((T*)a.out[f])[k] = tile[f][lr][cl];
    }
    __syncthreads();
  }
}

// ops/step_glue.py damp_currents: q less sign(q) * min(0.99 |q|, q^2 / r)
// (torch.minimum keeps a NaN, torch.sign gives 0 for one), adding the level
// to the column's count ``n`` where q^2 / r < 0.99 |q|.
template <typename T>
__device__ __forceinline__ T damp(T q, double r, int* n) {
  const T a = T(0.99) * fabs(q);
  const T b = div_s(q * q, r);
  const T qi = (a != a) ? a : (b != b) ? b : (b < a ? b : a);
  if (b < a) atomicAdd(n, 1);
  const T sg = q > T(0) ? T(1) : (q < T(0) ? T(-1) : T(0));
  return q - sg * qi;
}

template <typename T>
__device__ __forceinline__ T at(const void* p, long long sc, long long sl,
                                int c, int l) {
  return ((const T*)p)[c * sc + l * sl];
}

// column flags of glue_out, one byte a column of the block
enum : unsigned char { RP = 1, COMP = 2, OCEAN = 4, SEL2 = 8 };

// The epilogue at level l (< nz + 1) of column c from the step's u, v, T,
// S there (q); ``cnt``: the column's counts of damped u, v and frozen
// levels.
template <typename T>
__device__ __forceinline__ void glue_out_point(const OutArgs& a, int c, int l,
                                               unsigned char fl, T* q,
                                               int* cnt) {
  const size_t p = (size_t)c * a.nzp1 + l;
  T o_u[2], o_x[2], o_us[4], o_xs[4], rho, cp, tinc = T(0), ocnt = T(0);
  if (fl & RP) {
    if (a.damp) {
      q[0] = damp(q[0], a.damp_r, cnt);
      q[1] = damp(q[1], a.damp_r, cnt + 1);
    }
    // the history ping-pong on the step's levels, before the reset: they
    // go to the slot the repaired new phase does not name
    const bool sel2 = fl & SEL2;
    T h[4];
    Vec<T>::ld4((const T*)a.st_us + 4 * p, h);
    o_us[0] = sel2 ? h[0] : q[0];
    o_us[1] = sel2 ? q[0] : h[1];
    o_us[2] = sel2 ? h[2] : q[1];
    o_us[3] = sel2 ? q[1] : h[3];
    Vec<T>::ld4((const T*)a.st_xs + 4 * p, h);
    o_xs[0] = sel2 ? h[0] : q[2];
    o_xs[1] = sel2 ? q[2] : h[1];
    o_xs[2] = sel2 ? h[2] : q[3];
    o_xs[3] = sel2 ? q[3] : h[3];
    // check_profile: a failed column resets to the initial currents, and
    // to the climatology where its files exist
    const bool comp = fl & COMP;
    if (comp) {
      Vec<T>::ld2((const T*)a.u_init + 2 * p, o_u);
    } else {
      o_u[0] = q[0];
      o_u[1] = q[1];
    }
    o_x[0] = q[2];
    o_x[1] = q[3];
    if (a.have_clim && comp) {
      o_x[0] = ((const T*)a.ocnt_clim)[p];
      o_x[1] = ((const T*)a.sal_clim)[p];
    }
    if (a.tinc) tinc = at<T>(a.src[2], a.src_sc[2], a.src_sl[2], c, l);
    if (a.no_freeze) {
      const bool frozen = (fl & OCEAN) && o_x[0] < T(-1.8);
      tinc = tinc + (frozen ? T(-1.8) - o_x[0] : T(0));
      if (frozen) {
        atomicAdd(cnt + 2, 1);
        o_x[0] = T(-1.8);
      }
    }
    rho = (a.rho0 && l == 0) ? ((const T*)a.rho0)[c]
                             : at<T>(a.src[0], a.src_sc[0], a.src_sl[0], c, l);
    cp = (a.cp0 && l == 0) ? ((const T*)a.cp0)[c]
                           : at<T>(a.src[1], a.src_sc[1], a.src_sl[1], c, l);
    if (a.ocnt) ocnt = at<T>(a.src[3], a.src_sc[3], a.src_sl[3], c, l);
  } else {  // the land select: the state as it was
    Vec<T>::ld2((const T*)a.st_u + 2 * p, o_u);
    Vec<T>::ld2((const T*)a.st_x + 2 * p, o_x);
    Vec<T>::ld4((const T*)a.st_us + 4 * p, o_us);
    Vec<T>::ld4((const T*)a.st_xs + 4 * p, o_xs);
    rho = ((const T*)a.st_rho)[p];
    cp = ((const T*)a.st_cp)[p];
    if (a.tinc) tinc = ((const T*)a.st_tinc)[p];
    if (a.ocnt) ocnt = ((const T*)a.st_ocnt)[p];
  }
  if (a.bottom && l == a.nz) {  // bottomtemp, after the select
    const T bt = ((const T*)a.bottom_temp)[c];
    const T tb = bt - o_x[0];
    tinc = tb;
    ocnt = div_s(tb * rho * cp, a.dto);
    o_x[0] = bt;
  }
  Vec<T>::st2((T*)a.u + 2 * p, o_u);
  Vec<T>::st2((T*)a.x + 2 * p, o_x);
  Vec<T>::st4((T*)a.us + 4 * p, o_us);
  Vec<T>::st4((T*)a.xs + 4 * p, o_xs);
  ((T*)a.rho)[p] = rho;
  ((T*)a.cp)[p] = cp;
  if (a.tinc) ((T*)a.tinc)[p] = tinc;
  if (a.ocnt) ((T*)a.ocnt)[p] = ocnt;
  if (l == 0) {  // the surface values, from the levels before the reset
    const bool rp = fl & RP;
    ((T*)a.uref)[c] = rp ? q[0] : ((const T*)a.st_uref)[c];
    ((T*)a.vref)[c] = rp ? q[1] : ((const T*)a.st_vref)[c];
    ((T*)a.tref)[c] = rp ? q[2] : ((const T*)a.st_tref)[c];
  }
}

template <typename T, bool ZL>
__global__ void __launch_bounds__(NT) glue_out_kernel(OutArgs a) {
  constexpr int TLM = OUT_LEVELS<T>;
  __shared__ T tile[ZL ? 1 : 4][TLM][TC + 1];
  __shared__ int cnt[TC][3];  // damped u, damped v, frozen levels
  __shared__ unsigned char flags[TC];
  const int t = threadIdx.x, c0 = blockIdx.x * TC;
  const int nc = min(TC, a.ncol - c0);
  if (t < nc) {
    const int c = c0 + t;
    int o_r, n_r;
    phases(a.old_, a.new_, c, &o_r, &n_r);
    flags[t] = (a.rp[c] ? RP : 0) | (a.comp[c] ? COMP : 0) |
               (a.ocean[c] ? OCEAN : 0) | (1 - n_r == 1 ? SEL2 : 0);
    cnt[t][0] = cnt[t][1] = cnt[t][2] = 0;
  }
  __syncthreads();
  if (ZL) {
    for (int i = t; i < nc * a.nzp1; i += NT) {
      const int cl = i / a.nzp1, l = i - cl * a.nzp1;
      const size_t k = (size_t)(c0 + cl) * a.wz + l;
      T q[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) q[f] = ((const T*)a.q[f])[k];
      glue_out_point(a, c0 + cl, l, flags[cl], q, cnt[cl]);
    }
  } else {
    const int tl = tile_span(a.nzp1, TLM);
    for (int l0 = 0; l0 < a.nzp1; l0 += tl) {
      const int n = min(tl, a.nzp1 - l0);
      // a level row of the block's columns in the kernels' layout
      const int cr = t % TC;
      for (int lr = t / TC; lr < n; lr += NT / TC) {
        if (cr >= nc) continue;
        const size_t k = (size_t)(l0 + lr) * a.ncol + c0 + cr;
#pragma unroll
        for (int f = 0; f < 4; ++f) tile[f][lr][cr] = ((const T*)a.q[f])[k];
      }
      __syncthreads();
      // a column's run of levels in the state's layout
      for (int i = t; i < nc * n; i += NT) {
        const int cl = i / n, ll = i - cl * n;
        T q[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) q[f] = tile[f][ll][cl];
        glue_out_point(a, c0 + cl, l0 + ll, flags[cl], q, cnt[cl]);
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (t < nc) {
    const int c = c0 + t;
    const bool rp = flags[t] & RP;
    const T fu = a.damp ? div_s(T(cnt[t][0]), (double)a.nzp1) : T(0);
    const T fv = a.damp ? div_s(T(cnt[t][1]), (double)a.nzp1) : T(0);
    ((T*)a.dampu)[c] = rp ? fu : ((const T*)a.st_dampu)[c];
    ((T*)a.dampv)[c] = rp ? fv : ((const T*)a.st_dampv)[c];
    if (a.ff) {
      const T ff = ((const T*)a.st_ff)[c];
      ((T*)a.ff)[c] = rp ? ff + div_s(T(cnt[t][2]), (double)a.nzp1) : ff;
    }
  }
}

template <typename T, bool ZL>
int launch_in(const InArgs& a, cudaStream_t s) {
  glue_in_kernel<T, ZL><<<(a.ncol + TC - 1) / TC, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool ZL>
int launch_out(const OutArgs& a, cudaStream_t s) {
  glue_out_kernel<T, ZL><<<(a.ncol + TC - 1) / TC, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace step_glue

using namespace step_glue;

// esize: 4 (float) or 8 (double); zaxis: 0 (COL_LANES) or 1 (Z_LANES).
// Returns the launch's CUDA error (0: launched).
extern "C" int kpp_glue_in(int esize, int zaxis, const void* args,
                           void* stream) {
  const InArgs& a = *(const InArgs*)args;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.ncol <= 0) return 0;
  if (esize == 4)
    return zaxis ? launch_in<float, true>(a, s) : launch_in<float, false>(a, s);
  if (esize == 8)
    return zaxis ? launch_in<double, true>(a, s)
                 : launch_in<double, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int kpp_glue_out(int esize, int zaxis, const void* args,
                            void* stream) {
  const OutArgs& a = *(const OutArgs*)args;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.ncol <= 0) return 0;
  if (esize == 4)
    return zaxis ? launch_out<float, true>(a, s)
                 : launch_out<float, false>(a, s);
  if (esize == 8)
    return zaxis ? launch_out<double, true>(a, s)
                 : launch_out<double, false>(a, s);
  return (int)cudaErrorInvalidValue;
}
