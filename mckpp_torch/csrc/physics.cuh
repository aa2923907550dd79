// Pointwise physics shared by the fused-pass kernels: UNESCO-1980 EOS
// (abk80, cpsw) and the turbulent velocity scales (wscale_analytic,
// wscale_nodal).  Device-function twins of mckpp_torch/ops/eos.py and
// mckpp_torch/ops/wscale.py; each expression keeps the operation order of
// the plain torch code, so with -fmad=false the kernels round like the
// unfused eager ops.
//
// Without nvcc (__CUDACC__ undefined) the same functions compile as plain
// host C++, so the arithmetic can be exercised without a card.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define KPP_DEV __device__ __forceinline__
#else
#define KPP_DEV inline
#endif

namespace kpp {

// ---- physical and scheme constants (mckpp_torch/constants.py) ------------
constexpr double RICR = 0.30, EPSILON_KPP = 0.1, CEKMAN = 0.7, CMONOB = 1.0;
constexpr double CS = 98.96, CV = 1.6, AM = 1.257, CM = 8.380, AS_WS = -28.86;
constexpr double C1_WS = 5.0, C2_WS = 16.0, C3_WS = 16.0, ZETAM = -0.2,
                 ZETAS = -1.0, CSTAR = 5.0;
constexpr int WS_NI = 890, WS_NJ = 48;
constexpr double WS_ZMIN = -4.0e-7, WS_ZMAX = 0.0, WS_UMIN = 0.0, WS_UMAX = 0.04;
constexpr double RIINFTY = 0.8, RICON = -0.2, DIFM0 = 0.005, DIFS0 = 0.005,
                 DIFMIW = 1.0e-4, DIFSIW = 1.0e-5, DIFMCON = 0.0, DIFSCON = 0.0;
constexpr double RRHO0 = 1.9, DSFMAX = 1.0e-4;
constexpr double DLIMIT_BOTTOM = 1.0e-5, VLIMIT_BOTTOM = 1.0e-4;
constexpr double LAMBDA_SMOOTH = 0.5, SWFRAC_RMIN = -80.0;
constexpr double EPS16 = 1.0e-16, EPS20 = 1.0e-20;
constexpr double DELTAZ = (WS_ZMAX - WS_ZMIN) / (WS_NI + 1);
constexpr double DELTAU = (WS_UMAX - WS_UMIN) / (WS_NJ + 1);

// ---- math in the working type ----------------------------------------------
KPP_DEV float k_exp(float x) { return expf(x); }
KPP_DEV double k_exp(double x) { return exp(x); }
KPP_DEV float k_sqrt(float x) { return sqrtf(x); }
KPP_DEV double k_sqrt(double x) { return sqrt(x); }
KPP_DEV float k_pow(float x, float y) { return powf(x, y); }
KPP_DEV double k_pow(double x, double y) { return pow(x, y); }
KPP_DEV float k_abs(float x) { return fabsf(x); }
KPP_DEV double k_abs(double x) { return fabs(x); }
// A profile divided by a constant, and a constant divided by a profile,
// rounded as the plain body's torch ops round them on the card: torch's
// CUDA true division by a Python scalar multiplies by the reciprocal
// (rounded in T), and `scalar / tensor` is `tensor.reciprocal() * scalar`.
template <typename T> KPP_DEV T div_s(T x, double s) { return x * (T(1) / T(s)); }
template <typename T> KPP_DEV T rdiv_s(double s, T x) { return (T(1) / x) * T(s); }
template <typename T> KPP_DEV T k_max(T a, T b) { return a > b ? a : b; }
template <typename T> KPP_DEV T k_min(T a, T b) { return a < b ? a : b; }
template <typename T> KPP_DEV T k_sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// ---- UNESCO-1980 EOS (ops/eos.py) --------------------------------------------
template <typename T>
KPP_DEV T cpsw(T s, T t1, T p0) {
  T t = k_max(t1, T(-2.0));
  T p = div_s(p0, 10.0);
  T sr = k_sqrt(k_abs(s));
  T a = (T(-1.38385e-3) * t + T(0.1072763)) * t - T(7.643575);
  T b = (T(5.148e-5) * t - T(4.07718e-3)) * t + T(0.1770383);
  T cc = (((T(2.093236e-5) * t - T(2.654387e-3)) * t + T(0.1412855)) * t
          - T(3.720283)) * t + T(4217.4);
  T cp0 = (b * sr + a) * s + cc;
  a = (((T(1.7168e-8) * t + T(2.0357e-6)) * t - T(3.13885e-4)) * t
       + T(1.45747e-2)) * t - T(0.49592);
  b = (((T(2.2956e-11) * t - T(4.0027e-9)) * t + T(2.87533e-7)) * t
       - T(1.08645e-5)) * t + T(2.4931e-4);
  cc = ((T(6.136e-13) * t - T(6.5637e-11)) * t + T(2.6380e-9)) * t - T(5.422e-8);
  T cp1 = ((cc * p + b) * p + a) * p;
  a = (((T(-2.9179e-10) * t + T(2.5941e-8)) * t + T(9.802e-7)) * t
       - T(1.28315e-4)) * t + T(4.9247e-3);
  b = (T(3.122e-8) * t - T(1.517e-6)) * t - T(1.2331e-4);
  a = (a + b * sr) * s;
  b = ((T(1.8448e-11) * t - T(2.3905e-9)) * t + T(1.17054e-7)) * t - T(2.9558e-6);
  b = (b + T(9.971e-8) * sr) * s;
  cc = (T(3.513e-13) * t - T(1.7682e-11)) * t + T(5.540e-10);
  cc = (cc - T(1.4300e-12) * t * sr) * s;
  T cp2 = ((cc * p + b) * p + a) * p;
  return cp0 + cp1 + cp2;
}

// alpha, beta and sigma0 of abk80 (kappa and sigma are not needed here)
template <typename T>
KPP_DEV void abk80(T s, T t1, T p, T* alpha, T* beta, T* sig0_out) {
  T t = k_max(t1, T(-2.0));
  T p0 = div_s(p, 10.0);
  T sr = k_sqrt(k_abs(s));
  bool is_p0 = (p == T(0));
  T r1 = ((((T(6.536332e-9) * t - T(1.120083e-6)) * t + T(1.001685e-4)) * t
           - T(9.095290e-3)) * t + T(6.793952e-2)) * t - T(0.157406);
  T r2 = (((T(5.3875e-9) * t - T(8.2467e-7)) * t + T(7.6438e-5)) * t
          - T(4.0899e-3)) * t + T(8.24493e-1);
  T r3 = (T(-1.6546e-6) * t + T(1.0227e-4)) * t - T(5.72466e-3);
  T r4 = T(4.8314e-4);
  T sig0 = (r4 * s + r3 * sr + r2) * s + r1;
  T rho0 = T(1000.0) + sig0;
  T b1 = (T(-5.3009e-4) * t + T(1.6483e-2)) * t + T(7.944e-2);
  T a1 = ((T(-6.1670e-5) * t + T(1.09987e-2)) * t - T(0.603459)) * t + T(54.6746);
  T kw = (((T(-5.155288e-5) * t + T(1.360477e-2)) * t - T(2.327105)) * t
          + T(148.4206)) * t + T(19652.21);
  T k0 = (b1 * sr + a1) * s + kw;
  T e = (T(9.1697e-10) * t + T(2.0816e-8)) * t - T(9.9348e-7);
  T bw = (T(5.2787e-8) * t - T(6.12293e-6)) * t + T(8.50935e-5);
  T bb = bw + e * s;
  T d = T(1.91075e-4);
  T cterm = (T(-1.6078e-6) * t - T(1.0981e-5)) * t + T(2.2838e-3);
  T aw = ((T(-5.77905e-7) * t + T(1.16092e-4)) * t + T(1.43713e-3)) * t
         + T(3.239908);
  T aa = (d * sr + cterm) * s + aw;
  T k = (bb * p0 + aa) * p0 + k0;
  T pk = is_p0 ? T(0) : p0 / k;
  T sig = is_p0 ? sig0 : (T(1000.0) * pk + sig0) / (T(1) - pk);
  T rho = T(1000.0) + sig;
  T sr5 = sr * T(1.5);
  T drho = r2 + sr5 * r3 + (s + s) * r4;
  T dk0 = a1 + sr5 * b1;
  T da = cterm + sr5 * d;
  T db = e;
  T dk = (db * p0 + da) * p0 + dk0;
  T denom = (k - p0);
  T abfac = is_p0 ? T(0) : rho0 * p0 / (denom * denom);
  *beta = is_p0 ? drho / rho : (drho / (T(1) - pk) - abfac * dk) / rho;
  T r1a = (((T(0.3268166e-7) * t - T(0.4480332e-5)) * t + T(0.3005055e-3)) * t
           - T(0.1819058e-1)) * t + T(6.793952e-2);
  T r2a = ((T(0.215500e-7) * t - T(0.247401e-5)) * t + T(0.152876e-3)) * t
          - T(4.0899e-3);
  T r3a = T(-0.33092e-5) * t + T(1.0227e-4);
  T alph0 = (r3a * sr + r2a) * s + r1a;
  T b1a = T(-0.106018e-2) * t + T(1.6483e-2);
  T a1a = (T(-0.18501e-3) * t + T(0.219974e-1)) * t - T(0.603459);
  T kwa = ((T(-0.2062115e-3) * t + T(0.4081431e-1)) * t - T(0.4654210e+1)) * t
          + T(148.4206);
  T k0a = (b1a * sr + a1a) * s + kwa;
  T ea = T(0.183394e-8) * t + T(2.0816e-8);
  T bwa = T(0.105574e-6) * t - T(6.12293e-6);
  T alphb = bwa + ea * s;
  T ca = T(-0.32156e-5) * t - T(1.0981e-5);
  T awa = (T(-0.1733715e-5) * t + T(0.232184e-3)) * t + T(1.43713e-3);
  T alphaa = ca * s + awa;
  T alphk = (alphb * p0 + alphaa) * p0 + k0a;
  *alpha = is_p0 ? -alph0 / rho
                 : -(alph0 / (T(1) - pk) - abfac * alphk) / rho;
  *sig0_out = sig0;
}

template <typename T>
KPP_DEV T sig0_of(T s, T t, T p) {
  T a, b, s0;
  abk80(s, t, p, &a, &b, &s0);
  return s0;
}

// ---- turbulent velocity scales (ops/wscale.py) -------------------------------
// signed cube root through pow, like the plain body (not cbrt)
template <typename T> KPP_DEV T cbrt_pow(T x) {
  return k_sign(x) * k_pow(k_abs(x), T(1.0 / 3.0));
}
template <typename T> KPP_DEV T quartic_root(T x) { return k_sqrt(k_sqrt(x)); }

template <typename T>
KPP_DEV void wscale_analytic(T sigma, T hbl, T ustar, T bfsfc, T vonk,
                             T* wm, T* ws) {
  T zehat = vonk * sigma * hbl * bfsfc;
  T ucube = ustar * ustar * ustar;
  T zeta = zehat / (ucube + T(1.0e-30));
  T w_stab = vonk * ustar * ucube / (ucube + T(C1_WS) * zehat + T(1.0e-30));
  if (zehat >= T(0)) {
    *wm = w_stab;
    *ws = w_stab;
    return;
  }
  *wm = zeta > T(ZETAM)
            ? vonk * ustar * quartic_root(k_abs(T(1) - T(C2_WS) * zeta))
            : vonk * cbrt_pow(T(AM) * ucube - T(CM) * zehat);
  *ws = zeta > T(ZETAS)
            ? vonk * ustar * k_sqrt(k_abs(T(1) - T(C3_WS) * zeta))
            : vonk * cbrt_pow(T(AS_WS) * ucube - T(CS) * zehat);
}

// the table-build formula at a grid node (mckpp_physics_lookup_mod.F90:47-62)
template <typename T>
KPP_DEV void node_wmws(T zehat_n, T usta_n, T vonk, T* wm, T* ws) {
  T ucube = usta_n * usta_n * usta_n;
  T zeta = zehat_n / (ucube + T(1.0e-20));
  if (zehat_n >= T(0)) {
    T w_st = vonk * usta_n / (T(1) + T(C1_WS) * zeta);
    *wm = w_st;
    *ws = w_st;
    return;
  }
  *wm = zeta > T(ZETAM)
            ? vonk * usta_n * quartic_root(k_abs(T(1) - T(C2_WS) * zeta))
            : vonk * cbrt_pow(T(AM) * ucube - T(CM) * zehat_n);
  *ws = zeta > T(ZETAS)
            ? vonk * usta_n * k_sqrt(k_abs(T(1) - T(C3_WS) * zeta))
            : vonk * cbrt_pow(T(AS_WS) * ucube - T(CS) * zehat_n);
}

// table cell: truncation toward zero of the clamped quotient, clipped 0..n
template <typename T> KPP_DEV int ws_cell(T diff, double delta, int n) {
  T q = k_min(k_max(div_s(diff, delta), T(-1.0)), T(n + 1.0));
  int i = (int)q;
  return i < 0 ? 0 : (i > n ? n : i);
}

template <typename T>
KPP_DEV void wscale_nodal(T sigma, T hbl, T ustar, T bfsfc, T vonk,
                          T* wm, T* ws) {
  const T dz = T(DELTAZ), du = T(DELTAU);
  T zehat = vonk * sigma * hbl * bfsfc;
  T zdiff = zehat - T(WS_ZMIN);
  T iz = T(ws_cell(zdiff, DELTAZ, WS_NI));
  T udiff = ustar - T(WS_UMIN);
  T ju = T(ws_cell(udiff, DELTAU, WS_NJ));
  T zfrac = div_s(zdiff, DELTAZ) - iz;
  T ufrac = div_s(udiff, DELTAU) - ju;
  T fzfrac = T(1) - zfrac;
  T z_lo = T(WS_ZMIN) + dz * iz;
  T z_hi = z_lo + dz;
  T u_lo = T(WS_UMIN) + du * ju;
  T u_hi = u_lo + du;
  T wm_ll, ws_ll, wm_hl, ws_hl, wm_lh, ws_lh, wm_hh, ws_hh;
  node_wmws(z_lo, u_lo, vonk, &wm_ll, &ws_ll);
  node_wmws(z_hi, u_lo, vonk, &wm_hl, &ws_hl);
  node_wmws(z_lo, u_hi, vonk, &wm_lh, &ws_lh);
  node_wmws(z_hi, u_hi, vonk, &wm_hh, &ws_hh);
  if (zehat <= T(WS_ZMAX)) {
    T wam = fzfrac * wm_lh + zfrac * wm_hh;
    T wbm = fzfrac * wm_ll + zfrac * wm_hl;
    T was = fzfrac * ws_lh + zfrac * ws_hh;
    T wbs = fzfrac * ws_ll + zfrac * ws_hl;
    *wm = (T(1) - ufrac) * wbm + ufrac * wam;
    *ws = (T(1) - ufrac) * wbs + ufrac * was;
  } else {
    T ucube = ustar * ustar * ustar;
    T wm_ana = vonk * ustar * ucube / (ucube + T(C1_WS) * zehat);
    *wm = wm_ana;
    *ws = wm_ana;
  }
}

}  // namespace kpp
