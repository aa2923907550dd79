// The fused ocean pass and the whole ocean step for ONE column, as
// functions a CUDA thread runs (one thread per column).  Twins of
// _pass_body and _step_body in mckpp_torch/ops/fused_pass.py, which are the
// plain versions these kernels are held against.
//
// Layout: every profile is (WZ, ncol) row-major, WZ = nz + 2; element
// (k, col) is at k * ncol + col, so the threads of a warp read one level of
// 32 neighbouring columns in one coalesced access.  The grid rows (zm, hm,
// dm, tdn, tup), the reference-average matrix aref (WZ x WZ) and the
// rhsmod depth prefix sum live in shared memory, one copy per block.
// Each thread keeps its live profiles in local arrays of MAXWZ entries.
//
// Sequential forms that the plain version computes with log-depth shifts:
// * bldepth's bulk Richardson scan is the recurrence
//   Rib(k) = max(raw_k, Rib(k-1) + 1e-16), Rib(1) = 0, the same maximum as
//   the plain max-plus doubling scan;
// * the first crossing is the first k = 2..nz that crosses (default
//   kbl = nz);
// * the PCR solve keeps the plain elimination order, double-buffered so
//   that each stage reads the neighbours of the previous stage;
// * the rhsmod depth prefix sum comes in as an input, computed by the
//   plain helper (fused_pass._depth_prefix), because its sums decide band
//   edges by >= comparisons and must round exactly as the plain ones.
#pragma once

#include "physics.cuh"

#ifndef KPP_MAXWZ
#define KPP_MAXWZ 96
#endif

namespace kpp {

constexpr int MAXWZ = KPP_MAXWZ;

// colscal rows (ops/fused_pass.py CS_*)
enum {
  CS_TAUX = 0, CS_TAUY = 1, CS_SWF = 2, CS_NSOL = 3, CS_ICE = 4, CS_RAIN = 5,
  CS_SSURF = 6, CS_SREF = 7, CS_F = 8, CS_OCDEPTH = 9, CS_RFAC = 10,
  CS_A1 = 11, CS_A2 = 12, CS_FIRST = 13, CS_RELAX_SST = 14, CS_SST0 = 15,
  CS_FCORR2D = 16, CS_RELAX_OCNT = 17, CS_RELAX_SAL = 18, CS_FCORRP = 19,
  CS_ADV1 = 20, CS_ACTIVE = 27, CS_RHO0_IN = 28, CS_CP0_IN = 29
};

// PassFlags, the static scalars and the step controls (the C struct the
// Python wrapper fills, field for field)
struct PassParams {
  int nz, wz, ncol;
  int lri, ldd, lkpp, l_relax_sst, l_relax_calconly, l_fcorr, l_fcorr_withz,
      l_sfcorr_withz, l_relax_sal, l_relax_ocnt, l_advect, wscale_analytic;
  int adv_n1_4, itermax, extra_iters, comp_iter_max;
  double grav, vonk, sice, dto, zbot, vtc, cg;
  double adv_hm1, adv_inv_delta3, adv_delta4, adv_hm_nz;
  double hmixtolfrac, hm_bot, dm_nz;
  double rmsd_thr[4];
};

// the 25 pass inputs in the order of make_fused_pass plus the depth prefix
// sum; the step's 21 inputs are placed in the same slots (ux..sx unused)
enum {
  IN_U = 0, IN_V, IN_T, IN_S, IN_UX, IN_VX, IN_TX, IN_SX, IN_UO, IN_VO,
  IN_TO, IN_SO, IN_SWDK, IN_SWFRAC, IN_OCNT, IN_SAL, IN_FCZ, IN_SFCZ,
  IN_COLSCAL, IN_ZM, IN_HM, IN_DM, IN_TDN, IN_TUP, IN_AREF,
  IN_PFX,  // rhsmod depth prefix sum (WZ,), fused_pass._depth_prefix
  N_IN
};

template <typename T> struct Inputs { const T* p[N_IN]; };

// per-block shared data
template <typename T> struct Shared {
  const T* aref;  // (wz, wz), ref_avg(prof)[n] = sum_k aref[n*wz+k] prof[k]
  const T *zm, *hm, *dm, *tdn, *tup;
  const T* pfx;   // rhsmod depth prefix sum (l_advect only)
};

// full-pass diagnostic outputs (ops/fused_pass.py full tuple, after u..s)
enum {
  FO_COLOUT = 0, FO_DIFM, FO_DIFS, FO_DIFT, FO_GHAT, FO_RHO, FO_CP, FO_ALPHA,
  FO_BETA, FO_BUOY, FO_RIG, FO_DBLOC, FO_SHSQ, FO_WXNT, FO_SWDK, FO_TINC,
  FO_SINC, FO_OCNTCORR, FO_SCORR, N_FO
};

template <typename T> struct ColOut { T hbl, kbl, rho0, cp0; };

template <typename T>
KPP_DEV void ws_fn(const PassParams& P, T sig, T h, T us, T bf, T* wm, T* ws) {
  if (P.wscale_analytic)
    wscale_analytic(sig, h, us, bf, T(P.vonk), wm, ws);
  else
    wscale_nodal(sig, h, us, bf, T(P.vonk), wm, ws);
}

// per-column z-gather with the plain one-hot semantics: 0 out of range
template <typename T> KPP_DEV T ext(const T* a, int idx, int wz) {
  return (idx >= 0 && idx < wz) ? a[idx] : T(0);
}

// tridiagonal coefficients on rows (solvers.F90:14-44)
template <typename T>
KPP_DEV void tridcof(const T* diff, const Shared<T>& g, int nz, int wz,
                     T* cu, T* cc, T* cl) {
  for (int r = 0; r < wz; ++r) {
    T diff1 = r + 1 < wz ? diff[r + 1] : T(0);
    T tdn1 = r + 1 < wz ? g.tdn[r + 1] : T(0);
    T tup1 = r + 1 < wz ? g.tup[r + 1] : T(0);
    cu[r] = r == 0 ? T(0) : -tup1 * diff[r];
    cc[r] = T(1) + tdn1 * diff1 + (r == 0 ? T(0) : tup1 * diff[r]);
    cl[r] = r == nz - 1 ? T(0) : -tdn1 * diff1;
  }
}

// scalar RHS on rows (solvers.F90:53-107); ntflux == nullptr means zero
template <typename T>
KPP_DEV void tridrhs(const Shared<T>& g, const T* yo, const T* ntflux,
                     const T* diff, const T* ghat, T sturflux, T ghatflux,
                     T dto, int nz, int wz, T* rhs) {
  T bot = yo[nz] * g.tdn[nz] * diff[nz];
  for (int r = 0; r < wz; ++r) {
    T d1 = r + 1 < wz ? diff[r + 1] : T(0);
    T gh1 = r + 1 < wz ? ghat[r + 1] : T(0);
    T ghterm = ghatflux * (d1 * gh1 - diff[r] * ghat[r]);
    T ntterm = T(0);
    if (ntflux) ntterm = (r + 1 < wz ? ntflux[r + 1] : T(0)) - ntflux[r];
    T x = yo[r] + rdiv_s(double(dto), g.hm[r]) * (ghterm + ntterm);
    if (r == 0) x = x + rdiv_s(-double(dto), g.hm[r]) * sturflux;
    if (r == nz - 1) x = x + bot;
    rhs[r] = x;
  }
}

// parallel cyclic reduction (ops/fused_pass.py _pcr_solve), one system;
// the solution overwrites rhs.  cu/cc/cl are left untouched.
template <typename T>
KPP_DEV void pcr_solve(const T* cu, const T* cc, const T* cl, T* rhs,
                       int nz, int wz) {
  T a0[MAXWZ], b0[MAXWZ], c0[MAXWZ], r0[MAXWZ];
  T a1[MAXWZ], b1[MAXWZ], c1[MAXWZ], r1[MAXWZ], rb[MAXWZ];
  for (int j = 0; j < wz; ++j) {
    bool in = j < nz;
    a0[j] = in ? cu[j] : T(0);
    b0[j] = in ? cc[j] : T(1);
    c0[j] = in ? cl[j] : T(0);
    r0[j] = in ? rhs[j] : T(0);
  }
  T *a = a0, *b = b0, *c = c0, *r = r0;
  T *an = a1, *bn = b1, *cn = c1, *rn = r1;
  for (int s = 1; s < nz; s *= 2) {
    for (int j = 0; j < wz; ++j) rb[j] = T(1) / (b[j] == T(0) ? T(1) : b[j]);
    for (int j = 0; j < wz; ++j) {
      bool lo = j - s >= 0, hi = j + s < wz;
      T alpha = -a[j] * (lo ? rb[j - s] : T(1));
      T beta = -c[j] * (hi ? rb[j + s] : T(1));
      T c_lo = lo ? c[j - s] : T(0), a_hi = hi ? a[j + s] : T(0);
      T r_lo = lo ? r[j - s] : T(0), r_hi = hi ? r[j + s] : T(0);
      T a_lo = lo ? a[j - s] : T(0), c_hi = hi ? c[j + s] : T(0);
      bn[j] = b[j] + alpha * c_lo + beta * a_hi;
      rn[j] = r[j] + alpha * r_lo + beta * r_hi;
      an[j] = alpha * a_lo;
      cn[j] = beta * c_hi;
    }
    T* tp;
    tp = a; a = an; an = tp;
    tp = b; b = bn; bn = tp;
    tp = c; c = cn; cn = tp;
    tp = r; r = rn; rn = tp;
  }
  for (int j = 0; j < wz; ++j) rhs[j] = r[j] / b[j];
}

// rhsmod band basis (mode 6/7 walk): rows [lo, n2r] with n2r the first row
// >= lo (below nz) whose depth reaches target, else nz-1
template <typename T>
KPP_DEV void band(const T* depth_pfx, T depth_off, T target, int lo, int nz,
                  const Shared<T>& g, int* hi_out, T* val_out) {
  int n2r = nz - 1;
  for (int r = lo < 0 ? 0 : lo; r < nz; ++r)
    if (depth_off + depth_pfx[r] >= target) { n2r = r; break; }
  T delta = T(0);
  for (int r = lo < 0 ? 0 : lo; r <= n2r && r < nz; ++r) delta = delta + g.hm[r];
  *hi_out = n2r;
  *val_out = T(1) / (delta > T(0) ? delta : T(1));
}

// One fused pass for column `col`.  In: u..s (current iterate) and
// ux..sx.  Out: u..s become the solved u_n..s_n and ux..sx the
// under-relaxed iterate (the plain fast tuple's 2nd quartet).  f_cor is
// the Coriolis parameter this pass uses.  With FULL, the diagnostic
// profiles and colout16 are written to fo[] at column col.
template <typename T, bool FULL>
KPP_DEV void pass_column(const PassParams& P, const Inputs<T>& in,
                         const Shared<T>& g, int col, T* u, T* v, T* t, T* s,
                         T* ux, T* vx, T* tx, T* sx, T f_cor, ColOut<T>* co,
                         T* const* fo) {
  const int nz = P.nz, wz = P.wz, nc = P.ncol;
  const T dto = T(P.dto), grav = T(P.grav), zbot = T(P.zbot);
  const T lam = T(LAMBDA_SMOOTH), oml = T(1.0 - LAMBDA_SMOOTH);
  auto cs = [&](int k) { return in.p[IN_COLSCAL][k * nc + col]; };
  auto prof = [&](int i, int k) { return in.p[i][k * nc + col]; };

  // ---- under-relaxation: ux..sx := relaxed iterate ----------------------
  for (int k = 0; k < wz; ++k) {
    ux[k] = lam * ux[k] + oml * u[k];
    vx[k] = lam * vx[k] + oml * v[k];
    tx[k] = lam * tx[k] + oml * t[k];
    sx[k] = lam * sx[k] + oml * s[k];
  }
  const T* ur = ux; const T* vr = vx; const T* tr = tx; const T* sr = sx;

  // ---- EOS on every level ---------------------------------------------------
  T alpha[MAXWZ], beta[MAXWZ], rho[MAXWZ], cp[MAXWZ], buoy[MAXWZ];
  const T sref = cs(CS_SREF);
  for (int k = 0; k < wz; ++k) {
    T s_abs = sr[k] + sref, pr = -g.zm[k], sig0;
    abk80(s_abs, tr[k], pr, &alpha[k], &beta[k], &sig0);
    rho[k] = T(1000.0) + sig0;
    cp[k] = cpsw(s_abs, tr[k], pr);
    buoy[k] = div_s(-grav * sig0, 1000.0);
  }
  const T rho0 = rho[0], cp0 = cp[0], ta0 = alpha[0], sb0 = beta[0];
  const T rhoh2o = T(1000.0) + sig0_of(T(0), tr[0], -g.zm[0]);
  const T rhob = T(1000.0) + sig0_of(T(P.sice), tr[0], -g.zm[0]);

  // ---- solar decay cache + non-turbulent flux -------------------------------
  const T first = cs(CS_FIRST), rfac = cs(CS_RFAC), a1j = cs(CS_A1),
          a2j = cs(CS_A2), swf = cs(CS_SWF);
  T wxnt[MAXWZ];
  for (int k = 0; k < wz; ++k) {
    T swdk_new = rfac * k_exp(-g.dm[k] / a1j)
                 + (T(1) - rfac) * k_exp(-g.dm[k] / a2j);
    T swdk_opt = first * swdk_new + (T(1) - first) * prof(IN_SWDK, k);
    wxnt[k] = -swf * swdk_opt / (rho0 * cp0);
    if (FULL) fo[FO_SWDK][k * nc + col] = swdk_opt;
  }

  // ---- kinematic surface fluxes ---------------------------------------------
  const T taux = cs(CS_TAUX), tauy = cs(CS_TAUY);
  const T wu0x = -taux / rho0, wu0y = -tauy / rho0;
  const T tau = k_sqrt(taux * taux + tauy * tauy) + T(EPS16);
  const T ustar = k_sqrt(tau / rho0);
  const T ssurf = cs(CS_SSURF), sice = T(P.sice);
  const T wx0t = -cs(CS_NSOL) / rho0 / cp0;
  const T wx0s = ssurf * cs(CS_RAIN) / rhoh2o
                 + (ssurf - sice) * cs(CS_ICE) / rhob;
  const T b0 = -grav * (ta0 * wx0t - sb0 * wx0s);
  const T wx0b = -b0;
  const T b0sol = grav * ta0 * swf / (rho0 * cp0);

  // ---- reference profiles & bulk-Richardson inputs -----------------------
  T ritop[MAXWZ], dvsq[MAXWZ], dbloc[MAXWZ], shsq[MAXWZ];
  T uref_b = T(0), vref_b = T(0);
  for (int n = 0; n < wz; ++n) {
    T uref = T(0), vref = T(0), bref = T(0);
    const T* arow = g.aref + n * wz;
    for (int k = 0; k < wz; ++k) {
      uref = uref + arow[k] * ur[k];
      vref = vref + arow[k] * vr[k];
      bref = bref + arow[k] * buoy[k];
    }
    if (n == nz - 1) { uref_b = uref; vref_b = vref; }
    T zref = T(EPSILON_KPP) * g.zm[n];
    ritop[n] = (zref - g.zm[n]) * (bref - buoy[n]);
    T eu = uref - ur[n], ev = vref - vr[n];
    dvsq[n] = eu * eu + ev * ev;
    bool im = n >= 1 && n <= nz;
    dbloc[n] = im ? buoy[n - 1] - buoy[n] : T(0);
    T du = im ? ur[n - 1] - ur[n] : T(0), dv = im ? vr[n - 1] - vr[n] : T(0);
    shsq[n] = im ? du * du + dv * dv : T(0);
  }

  // ---- rimix + z121 ------------------------------------------------------------
  T rig[MAXWZ], difm[MAXWZ], difs[MAXWZ], dift[MAXWZ], ghat[MAXWZ];
  for (int k = 0; k < wz; ++k) {
    bool im = k >= 1 && k <= nz;
    rig[k] = (P.lri && im)
                 ? dbloc[k] * (g.zm[k - 1] - g.zm[k]) / (shsq[k] + T(EPS16))
                 : T(0);
  }
  for (int k = 0; k < wz; ++k) {
    bool im = k >= 1 && k <= nz;
    if (!P.lri || !im) {
      difm[k] = difs[k] = dift[k] = T(0);
      continue;
    }
    // w*vz of the neighbours (both zero outside the interfaces)
    auto wv = [&](int j, T* w) {
      bool imj = j >= 1 && j <= nz;
      T r = rig[j];
      *w = (imj && !(r < T(0) || r > T(RIINFTY))) ? T(1) : T(0);
      return *w * (imj ? r : T(0));
    };
    T wl, wc, wh;
    T wvl = k - 1 >= 0 ? wv(k - 1, &wl) : (wl = T(0), T(0));
    wv(k, &wc);
    T wvh = k + 1 < wz ? wv(k + 1, &wh) : (wh = T(0), T(0));
    T num = wvl + T(2) * rig[k] + wvh;
    T den = wl + T(2) + wh;
    T smooth = num / den;
    T rigg = k_max(rig[k], T(RICON));
    T ratio = k_min(div_s(T(RICON) - rigg, RICON), T(1));
    T x = T(1) - ratio * ratio;
    T fcon = x * x * x;
    rigg = k_max(smooth, T(0));
    ratio = k_min(div_s(rigg, RIINFTY), T(1));
    x = T(1) - ratio * ratio;
    T fri = x * x * x;
    difm[k] = T(DIFMIW) + fcon * T(DIFMCON) + fri * T(DIFM0);
    difs[k] = T(DIFSIW) + fcon * T(DIFSCON) + fri * T(DIFS0);
    dift[k] = difs[k];
  }

  if (P.ldd) {  // double diffusion (ddmix_mod :12-52)
    for (int k = 1; k <= nz; ++k) {
      T adt = T(0.5) * (alpha[k - 1] + alpha[k]) * (tr[k - 1] - tr[k]);
      T bds = T(0.5) * (beta[k - 1] + beta[k]) * (sr[k - 1] - sr[k]);
      if (adt > bds && bds > T(0)) {
        T rrho_f = k_min(adt / bds, T(RRHO0));
        T q = div_s(rrho_f - T(1), RRHO0 - 1.0);
        T dd = T(1) - q * q;
        T diff_f = T(DSFMAX) * dd * dd * dd;
        dift[k] = dift[k] + diff_f * T(0.8) / rrho_f;
        difs[k] = difs[k] + diff_f;
      }
      if (adt < T(0) && bds < T(0) && adt < bds) {
        T rrho_c = adt / bds;
        T diff_c = T(1.5e-6 * 9.0 * 0.101)
                   * k_exp(T(4.6) * k_exp(T(-0.54) * (T(1) / rrho_c - T(1))));
        T prandtl = rrho_c > T(0.5) ? (T(1.85) - rdiv_s(0.85, rrho_c)) * rrho_c
                                    : T(0.15) * rrho_c;
        dift[k] = dift[k] + diff_c;
        difs[k] = difs[k] + prandtl * diff_c;
      }
    }
  }
  // bottom kmp1 coefficient for blmix matching (kppmix :58-62)
  difm[nz + 1] = difm[nz];
  difs[nz + 1] = difs[nz];
  dift[nz + 1] = dift[nz];

  for (int k = 0; k < wz; ++k) ghat[k] = T(0);
  T hbl;
  int kbl;
  if (P.lkpp) {
    // ---- bldepth (bldepth_mod :32-203); k = Fortran kl ---------------------
    const T vonk = T(P.vonk), vtc = T(P.vtc), ocdepth = cs(CS_OCDEPTH);
    const T hek = T(CEKMAN) * ustar / (k_abs(f_cor) + T(EPS16));
    T rib_prev = T(0), dmo_prev = -zbot;
    kbl = nz;
    hbl = -g.zm[nz - 1];
    for (int k = 2; k <= nz; ++k) {
      T z_kl = g.zm[k - 1], z_klm1 = g.zm[k - 2];
      T bfsfc_l = b0 + b0sol * (T(1) - prof(IN_SWFRAC, k - 1));
      T stable_l = (bfsfc_l + T(EPS16) >= T(0)) ? T(1) : T(0);
      T sigma_l = stable_l + (T(1) - stable_l) * T(EPSILON_KPP);
      T wm_l, ws_l;
      ws_fn(P, sigma_l, -z_kl, ustar, bfsfc_l, &wm_l, &ws_l);
      T dz_up = z_klm1 - z_kl, dz_dn = z_kl - g.zm[k];
      T bvsq = T(0.5) * (dbloc[k - 1] / dz_up + dbloc[k] / dz_dn);
      T vtsq = -z_kl * ws_l * k_sqrt(k_abs(bvsq)) * vtc;
      T dmo_raw = div_s(T(CMONOB) * (ustar * ustar * ustar), P.vonk)
                  / (k_abs(bfsfc_l) + T(EPS16));
      T dmo_l = stable_l * dmo_raw - (T(1) - stable_l) * zbot;
      T hekman_l = stable_l * hek - (T(1) - stable_l) * zbot;
      T raw = ritop[k - 1] / (dvsq[k - 1] + vtsq + T(EPS16));
      T rib = k_max(raw, rib_prev + T(EPS16));
      T hri = -z_klm1 + (z_klm1 - z_kl) * (T(RICR) - rib_prev) / (rib - rib_prev);
      T slope = (dmo_l - dmo_prev) / (z_klm1 - z_kl);
      T hmonob = dmo_l <= -z_kl ? (dmo_l + slope * z_kl) / (T(1) - slope)
                                : -zbot;
      T hmin = k_min(k_min(hri, hmonob), k_min(hekman_l, -ocdepth));
      T hmin2 = k_min(k_min(hri, hmonob), -ocdepth);
      if (hmin < -z_klm1 && hmin2 < -z_kl) hmin = hmin2;
      if (hmin < -z_kl) {
        kbl = k;
        hbl = hmin;
        break;
      }
      rib_prev = rib;
      dmo_prev = dmo_l;
    }
    // final surface forcing at hbl (:187-201)
    T swdk_hbl = rfac * k_exp(k_max(-hbl / a1j, T(SWFRAC_RMIN)))
                 + (T(1) - rfac) * k_exp(k_max(-hbl / a2j, T(SWFRAC_RMIN)));
    T bfsfc = b0 + b0sol * (T(1) - swdk_hbl);
    T stable = bfsfc >= T(0) ? T(1) : T(0);
    bfsfc = bfsfc + stable * T(EPS16);
    T zm_kbl = ext(g.zm, kbl - 1, wz), hm_kbl = ext(g.hm, kbl - 1, wz);
    T case_a = (-zm_kbl - T(0.5) * hm_kbl - hbl >= T(0)) ? T(1) : T(0);

    // ---- blmix (blmix_mod :13-151) -------------------------------------------
    const T cg = T(P.cg);
    T sigma_bl = stable * T(1) + (T(1) - stable) * T(EPSILON_KPP);
    T wm_h, ws_h;
    ws_fn(P, sigma_bl, hbl, ustar, bfsfc, &wm_h, &ws_h);
    int kn = (case_a + T(EPS20) >= T(1)) ? kbl - 1 : kbl;
    T hm_kn = ext(g.hm, kn - 1, wz), hm_knp1 = ext(g.hm, kn, wz);
    T delhat = T(0.5) * hm_kn - ext(g.zm, kn - 1, wz) - hbl;
    T r_frac = T(1) - delhat / hm_kn;
    auto match = [&](const T* dif, T* dp_out) {
      T d_m1 = ext(dif, kn - 1, wz), d_0 = ext(dif, kn, wz),
        d_p1 = ext(dif, kn + 1, wz);
      T dvdzup = (d_m1 - d_0) / hm_kn;
      T dvdzdn = (d_0 - d_p1) / hm_knp1;
      T dp = T(0.5) * ((T(1) - r_frac) * (dvdzup + k_abs(dvdzup))
                       + r_frac * (dvdzdn + k_abs(dvdzdn)));
      *dp_out = dp;
      return d_0 + dp * delhat;
    };
    T viscp, difsp, diftp;
    T visch = match(difm, &viscp);
    T difsh = match(difs, &difsp);
    T difth = match(dift, &diftp);
    T u2 = ustar * ustar;
    T f1 = stable * T(C1_WS) * bfsfc / (u2 * u2 + T(EPS20));
    T gat1m = visch / hbl / (wm_h + T(EPS20));
    T gat1s = difsh / hbl / (ws_h + T(EPS20));
    T gat1t = difth / hbl / (ws_h + T(EPS20));
    T dat1m = k_min(-viscp / (wm_h + T(EPS20)) + f1 * visch, T(0));
    T dat1s = k_min(-difsp / (ws_h + T(EPS20)) + f1 * difsh, T(0));
    T dat1t = k_min(-diftp / (ws_h + T(EPS20)) + f1 * difth, T(0));
    auto shape = [](T sig, T gat1, T dat1) {
      return (sig - T(2)) + (T(3) - T(2) * sig) * gat1 + (sig - T(1)) * dat1;
    };
    // boundary-layer profiles at interface k (blmix :100-140)
    auto blmc = [&](int k, T* bm, T* bs, T* bt, T* gh) {
      T sig_i = (-g.zm[k - 1] + T(0.5) * g.hm[k - 1]) / hbl;   // k >= 1
      T sigma_i = stable * sig_i
                  + (T(1) - stable) * k_min(sig_i, T(EPSILON_KPP));
      T wm_i, ws_i;
      ws_fn(P, sigma_i, hbl, ustar, bfsfc, &wm_i, &ws_i);
      *bm = hbl * wm_i * sig_i * (T(1) + sig_i * shape(sig_i, gat1m, dat1m));
      *bs = hbl * ws_i * sig_i * (T(1) + sig_i * shape(sig_i, gat1s, dat1s));
      *bt = hbl * ws_i * sig_i * (T(1) + sig_i * shape(sig_i, gat1t, dat1t));
      *gh = (T(1) - stable) * cg / (ws_i * hbl + T(EPS20));
    };
    // diffusivities at grid level kbl-1 (blmix :86-95)
    T sig_k = -ext(g.zm, kbl - 2, wz) / hbl;
    T sigma_k = stable * sig_k + (T(1) - stable) * k_min(sig_k, T(EPSILON_KPP));
    T wm_k, ws_k;
    ws_fn(P, sigma_k, hbl, ustar, bfsfc, &wm_k, &ws_k);
    T dkm1_m = hbl * wm_k * sig_k * (T(1) + sig_k * shape(sig_k, gat1m, dat1m));
    T dkm1_s = hbl * ws_k * sig_k * (T(1) + sig_k * shape(sig_k, gat1s, dat1s));
    T dkm1_t = hbl * ws_k * sig_k * (T(1) + sig_k * shape(sig_k, gat1t, dat1t));

    // ---- enhance at interface kbl-1 (enhance_mod :10-51) --------------------
    const int ki_e = kbl - 1;
    const bool sel_ok = ki_e >= 1 && ki_e <= nz - 1;
    T enh_m = T(0), enh_s = T(0), enh_t = T(0), enh_g = T(0);
    if (sel_ok) {
      T zm_em1 = ext(g.zm, ki_e - 1, wz), zm_e = ext(g.zm, ki_e, wz);
      T delta = (hbl + zm_em1) / (zm_em1 - zm_e);
      T om = T(1) - delta;
      T bm, bs, bt, gh;
      blmc(ki_e, &bm, &bs, &bt, &gh);
      auto enh = [&](T dif_e, T blmc_x, T dkm1_x) {
        T dkmp5 = case_a * dif_e + (T(1) - case_a) * blmc_x;
        T dstar = om * om * dkm1_x + delta * delta * dkmp5;
        return om * dif_e + delta * dstar;
      };
      enh_m = enh(difm[ki_e], bm, dkm1_m);
      enh_s = enh(difs[ki_e], bs, dkm1_s);
      enh_t = enh(dift[ki_e], bt, dkm1_t);
      enh_g = (T(1) - case_a) * gh;
    }
    // ---- merge boundary layer and interior (kppmix :100-124) ---------------
    for (int k = 1; k < kbl && k <= nz; ++k) {
      if (sel_ok && k == ki_e) {
        difm[k] = enh_m;
        difs[k] = enh_s;
        dift[k] = enh_t;
        ghat[k] = enh_g;
      } else {
        blmc(k, &difm[k], &difs[k], &dift[k], &ghat[k]);
      }
    }
  } else {
    hbl = -g.zm[nz - 1];
    kbl = nz;
  }

  // bottom diffusivity limits + no bottom ghat (verticalmixing :151-159)
  for (int k = nz; k < wz; ++k) {
    difm[k] = T(VLIMIT_BOTTOM);
    difs[k] = T(DLIMIT_BOTTOM);
    dift[k] = T(DLIMIT_BOTTOM);
  }
  ghat[nz] = T(0);

  // ---- ocnint: backward-Euler solves (ocnint_mod :19-221) ----------------
  const T hm_sfc = g.hm[0];
  T cu[MAXWZ], cc[MAXWZ], cl[MAXWZ], rhs[MAXWZ];
  const T* uo = in.p[IN_UO] + col;
  const T* vo = in.p[IN_VO] + col;
  const T* to = in.p[IN_TO] + col;
  const T* so = in.p[IN_SO] + col;
  auto O = [&](const T* p, int k) { return p[k * nc]; };
  // U / V with semi-implicit Coriolis (:44-72)
  tridcof(difm, g, nz, wz, cu, cc, cl);
  const T bot_m = g.tdn[nz] * difm[nz];
  const T fc = dto * f_cor * T(0.5);
  for (int r = 0; r < wz; ++r) {
    T x = O(uo, r) + fc * (O(vo, r) + vr[r]);
    if (r == 0) x = x + -dto * wu0x / hm_sfc;
    if (r == nz - 1) x = x + bot_m * O(uo, nz);
    rhs[r] = x;
  }
  pcr_solve(cu, cc, cl, rhs, nz, wz);
  for (int r = 0; r < wz; ++r) u[r] = r < nz ? rhs[r] : (r == nz ? O(uo, r) : T(0));
  for (int r = 0; r < wz; ++r) {
    T us_r = r < nz ? u[r] : T(0);   // the solve's own rows (0 below nz)
    T x = O(vo, r) - fc * (O(uo, r) + us_r);
    if (r == 0) x = x + -dto * wu0y / hm_sfc;
    if (r == nz - 1) x = x + bot_m * O(vo, nz);
    rhs[r] = x;
  }
  pcr_solve(cu, cc, cl, rhs, nz, wz);
  for (int r = 0; r < wz; ++r) v[r] = r < nz ? rhs[r] : (r == nz ? O(vo, r) : T(0));

  // temperature (:82-162)
  T tmp[MAXWZ];
  for (int r = 0; r < wz; ++r) tmp[r] = O(to, r);
  tridcof(dift, g, nz, wz, cu, cc, cl);
  tridrhs(g, tmp, wxnt, dift, ghat, wx0t, wx0t, dto, nz, wz, rhs);
  T fcorr = cs(CS_FCORRP);
  if (P.l_relax_sst && !P.l_fcorr_withz && !P.l_fcorr) {
    T relax_sst = cs(CS_RELAX_SST), sst0 = cs(CS_SST0);
    bool do_rlx = relax_sst > T(1.0e-10);
    T dm_kmixe = ext(g.dm, kbl, wz);
    T to_sfc = O(to, 0);
    T incr = dto * relax_sst * (sst0 - to_sfc) * dm_kmixe / hm_sfc;
    if (!P.l_relax_calconly && do_rlx) rhs[0] = rhs[0] + incr;
    fcorr = do_rlx ? relax_sst * (sst0 - to_sfc) * dm_kmixe * rho0 * cp0 : T(0);
  }
  if (P.l_fcorr && !P.l_relax_sst && !P.l_fcorr_withz)
    rhs[0] = rhs[0] + dto * cs(CS_FCORR2D) / (rho0 * cp0 * hm_sfc);
  const T relax_ocnt = cs(CS_RELAX_OCNT);
  for (int r = 0; r < wz; ++r) {
    T tinc = T(0);
    if (P.l_fcorr_withz && !P.l_fcorr)
      tinc = tinc + dto * prof(IN_FCZ, r) / (rho[r] * cp[r]);
    if (P.l_relax_ocnt)
      tinc = tinc + dto * relax_ocnt * (prof(IN_OCNT, r) - O(to, r));
    if (r <= nz - 1) rhs[r] = rhs[r] + tinc;
    if (FULL) {
      fo[FO_TINC][r * nc + col] = tinc;
      fo[FO_OCNTCORR][r * nc + col] = div_s(tinc * rho[r] * cp[r], P.dto);
    }
  }
  pcr_solve(cu, cc, cl, rhs, nz, wz);
  for (int r = 0; r < wz; ++r) t[r] = r < nz ? rhs[r] : (r == nz ? O(to, r) : T(0));

  // salinity (:164-219); wXNT(:,2) is identically zero in the reference
  for (int r = 0; r < wz; ++r) tmp[r] = O(so, r);
  tridcof(difs, g, nz, wz, cu, cc, cl);
  tridrhs(g, tmp, (const T*)nullptr, difs, ghat, wx0s, wx0s, dto, nz, wz, rhs);
  if (P.l_advect) {
    // steady advection corrections (rhsmod modes 1-7, solvers.F90:176-335):
    // each mode's basis is one value over a band of rows
    const int km = kbl;
    const T dm_km = ext(g.dm, km, wz), hm_km = ext(g.hm, km - 1, wz),
            hm_km1 = ext(g.hm, km - 2, wz);
    T c_m[7];
    for (int m = 0; m < 7; ++m) c_m[m] = cs(CS_ADV1 + m);
    // mode 2: rows 0..km-2
    T d2 = T(0);
    for (int r = 0; r < nz && r <= km - 2; ++r) d2 = d2 + g.hm[r];
    const T v2 = T(1) / (d2 > T(0) ? d2 : T(1));
    // mode 6: walk from the surface to the seasonal mixed-layer depth
    int hi6, hi7;
    T v6, v7;
    band(g.pfx, T(P.adv_hm1), dm_km - T(0.5) * (hm_km + hm_km1), 0, nz, g,
         &hi6, &v6);
    // mode 7: walk from row km7-2 to 100 m below
    const int km7 = km > 2 ? km : 2;
    const T pfx_lo = km7 >= 3 ? ext(g.pfx, km7 - 3, wz) : T(0);
    T pfx_rel[MAXWZ];
    for (int r = 0; r < wz; ++r) pfx_rel[r] = g.pfx[r] - pfx_lo;
    band(pfx_rel, dm_km - T(0.5) * hm_km, T(100.0), km7 - 2, nz, g, &hi7, &v7);
    const bool mode4 = P.adv_n1_4 > 0 && P.adv_delta4 > 0.0;
    const T adv = T(P.dto * 0.033);
    for (int r = 0; r < wz; ++r) {
      bool rn = r < nz;
      T total = c_m[0] * (r == 0 ? T(1.0 / P.adv_hm1) : T(0));
      total = total + c_m[1] * ((rn && r <= km - 2) ? v2 : T(0));
      total = total + c_m[2] * (rn ? T(P.adv_inv_delta3) : T(0));
      if (mode4)
        total = total + c_m[3] * ((r >= P.adv_n1_4 - 1 && r <= nz - 2)
                                      ? T(1.0 / P.adv_delta4) : T(0));
      total = total + c_m[4] * (r == nz - 1 ? T(1.0 / P.adv_hm_nz) : T(0));
      total = total + c_m[5] * ((rn && r <= hi6) ? v6 : T(0));
      total = total + c_m[6] * ((rn && r >= km7 - 2 && r <= hi7) ? v7 : T(0));
      rhs[r] = rhs[r] + adv * total;
    }
  }
  const T relax_sal = cs(CS_RELAX_SAL);
  for (int r = 0; r < wz; ++r) {
    T sinc = T(0);
    if (P.l_sfcorr_withz) sinc = sinc + dto * prof(IN_SFCZ, r);
    if (P.l_relax_sal) sinc = sinc + dto * relax_sal * (prof(IN_SAL, r) - O(so, r));
    if (r <= nz - 1) rhs[r] = rhs[r] + sinc;
    if (FULL) {
      fo[FO_SINC][r * nc + col] = sinc;
      fo[FO_SCORR][r * nc + col] = div_s(sinc, P.dto);
    }
  }
  pcr_solve(cu, cc, cl, rhs, nz, wz);
  for (int r = 0; r < wz; ++r) s[r] = r < nz ? rhs[r] : (r == nz ? O(so, r) : T(0));

  co->hbl = hbl;
  co->kbl = T(kbl);
  co->rho0 = rho0;
  co->cp0 = cp0;
  if (FULL) {
    T* c16 = fo[FO_COLOUT];
    const T vals[12] = {hbl, T(kbl), rhoh2o, fcorr, wu0x, wu0y,
                        wx0t, wx0s, wx0b, uref_b, vref_b, ustar};
    for (int i = 0; i < 16; ++i) c16[i * nc + col] = i < 12 ? vals[i] : T(0);
    for (int k = 0; k < wz; ++k) {
      const int o = k * nc + col;
      fo[FO_DIFM][o] = difm[k];
      fo[FO_DIFS][o] = difs[k];
      fo[FO_DIFT][o] = dift[k];
      fo[FO_GHAT][o] = ghat[k];
      fo[FO_RHO][o] = rho[k];
      fo[FO_CP][o] = cp[k];
      fo[FO_ALPHA][o] = alpha[k];
      fo[FO_BETA][o] = beta[k];
      fo[FO_BUOY][o] = buoy[k];
      fo[FO_RIG][o] = rig[k];
      fo[FO_DBLOC][o] = dbloc[k];
      fo[FO_SHSQ][o] = shsq[k];
      fo[FO_WXNT][o] = wxnt[k];
    }
  }
}

// ---- the whole step for one column (ops/fused_pass.py _step_body) ----------
// The convergence and trap loops run per column: a column's updates depend
// only on that column, so the result equals the plain batch-masked loops.
template <typename T>
KPP_DEV bool instability(const PassParams& P, const Inputs<T>& in,
                         const Shared<T>& g, int col, const T* u, const T* v,
                         const T* t, const T* s, T* fmul) {
  const int nz = P.nz, wz = P.wz, nc = P.ncol;
  int nbad = 0;
  for (int k = 0; k < nz; ++k) {
    T dxv = k_abs(t[k] - (k + 1 < wz ? t[k + 1] : T(0)));
    if (k_abs(u[k]) >= T(10) || k_abs(v[k]) >= T(10) || dxv >= T(10)) ++nbad;
  }
  const T* q[4] = {u, v, t, s};
  const int oi[4] = {IN_UO, IN_VO, IN_TO, IN_SO};
  int nex = 0;
  bool any_ex = false;
  for (int i = 0; i < 4; ++i) {
    T acc = T(0);
    for (int k = 0; k < wz; ++k) {
      T w = k <= nz ? div_s(g.hm[k], P.dm_nz) : T(0);
      T d = q[i][k] - in.p[oi[i]][k * nc + col];
      acc = acc + d * d * w;
    }
    bool ex = k_sqrt(acc) >= T(P.rmsd_thr[i]);
    nex += ex;
    any_ex = any_ex || ex;
  }
  bool blown = nbad > 0;
  int n = nbad + (blown ? 0 : nex);
  *fmul = k_pow(T(1.01), T(n));
  return blown || any_ex;
}

// colstep rows: 0=hmix, 1=kmix, 2=rho0, 3=cp0, 4=comp_flag, 5=reset_flag,
// 6=f_used, 7=npass (passes the column ran).  u..sx hold the step's 8
// output profiles on return.
template <typename T>
KPP_DEV void step_column(const PassParams& P, const Inputs<T>& in,
                         const Shared<T>& g, int col, T* u, T* v, T* t, T* s,
                         T* ux, T* vx, T* tx, T* sx, T colstep[8]) {
  const int nz = P.nz, wz = P.wz, nc = P.ncol;
  auto cs = [&](int k) { return in.p[IN_COLSCAL][k * nc + col]; };
  T* w[8] = {u, v, t, s, ux, vx, tx, sx};
  auto load0 = [&]() {
    for (int i = 0; i < 8; ++i)
      for (int k = 0; k < wz; ++k) w[i][k] = in.p[IN_U + (i & 3)][k * nc + col];
  };
  const bool active = cs(CS_ACTIVE) > T(0.5);
  const T f0 = cs(CS_F);
  T hmixn = T(0), kmixn = T(nz), rho0 = cs(CS_RHO0_IN), cp0 = cs(CS_CP0_IN);
  T f_local = f0, f_used = f0, reset = T(0), npass = T(0);
  bool comp = true;
  load0();
  while (comp && reset <= T(P.comp_iter_max) && active) {
    // one integration attempt (ocnstep:103-192): 3 compulsory passes, then
    // the hmix convergence loop; one call site keeps the inlined pass once
    load0();
    ColOut<T> co;
    T hm_i = T(0), km_i = T(0), r0_i = T(0), c0_i = T(0);
    T hmixe = T(0), it = T(3), iconv = T(0), npass_total = T(0);
    for (int ip = 1;; ++ip) {
      pass_column<T, false>(P, in, g, col, u, v, t, s, ux, vx, tx, sx,
                            f_local, &co, nullptr);
      npass_total = npass_total + T(1);
      if (ip > 3) {
        T it_n = it + T(1);
        int kidx = (int)co.kbl;
        int kk = kidx - 1 < 0 ? 0 : (kidx - 1 > nz ? nz : kidx - 1);
        T tol = T(P.hmixtolfrac) * (kidx == nz + 1 ? T(P.hm_bot) : g.hm[kk]);
        T iconv_n = k_abs(co.hbl - hmixe) > tol ? T(0) : iconv + T(1);
        bool cont_n = iconv_n < T(3)
                      && (it_n < T(P.itermax) || co.hbl > hmixe)
                      && it_n < T(P.itermax + P.extra_iters);
        if (cont_n) hmixe = co.hbl;
        it = it_n;
        iconv = iconv_n;
        hm_i = co.hbl;
        km_i = co.kbl;
        r0_i = co.rho0;
        c0_i = co.cp0;
        if (!cont_n) break;
      } else if (ip == 3) {
        hm_i = hmixe = co.hbl;
        km_i = co.kbl;
        r0_i = co.rho0;
        c0_i = co.cp0;
        if (!P.lkpp) break;
      }
    }
    T fmul;
    bool comp_n = instability(P, in, g, col, u, v, t, s, &fmul);
    f_used = f_local;
    if (comp_n) f_local = f_local * fmul;
    comp = comp_n;
    reset = reset + T(1);
    npass = npass + npass_total;
    hmixn = hm_i;
    kmixn = km_i;
    rho0 = r0_i;
    cp0 = c0_i;
  }
  colstep[0] = hmixn;
  colstep[1] = kmixn;
  colstep[2] = rho0;
  colstep[3] = cp0;
  colstep[4] = comp ? T(1) : T(0);
  colstep[5] = reset;
  colstep[6] = f_used;
  colstep[7] = npass;
}

}  // namespace kpp
