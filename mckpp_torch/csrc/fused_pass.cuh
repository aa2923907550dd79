// The fused ocean pass and the whole ocean step for ONE column, run by ONE
// warp (up to 256 levels) or by the CW warps of one block (past 256).
// Twins of _pass_body and _step_body in mckpp_torch/ops/fused_pass.py,
// which are the plain versions these kernels are held against.
//
// Layout in device memory, the template parameter L of the staging (the
// JAX package's zaxis; WZ = nz + 2): COL_LANES (zaxis = 0) holds every
// profile as (WZ, ncol) row-major, element (k, col) at k * ncol + col;
// Z_LANES (zaxis = 1) as (ncol, WZ), element (k, col) at col * WZ + k, the
// state's own order.  A block of W warps takes W consecutive columns and
// stages their inputs through shared memory, and its outputs the same way
// back: in COL_LANES each level row of a profile is one run of W values,
// read and written whole; in Z_LANES the W columns are one run of W * WZ
// values, and each warp stages its own column, lane k % 32 on level k, so
// a warp's access is 32 consecutive values.  Only the staging reads L: the
// body, the grid rows and aref are the same in both layouts.
//
// Levels on lanes: level k of the warp's column sits on lane k % 32, slot
// k / 32.  The number of slots NS is a template parameter of every
// function below: NS = 3 covers WZ <= 96 (the production TerraMaris shape,
// nz = 69), NS = 4 covers WZ <= 128 (nz = 100 of the single-column
// configuration), NS = 6 covers WZ <= 192 and NS = 8 WZ <= 256 (a
// 250-level single column at 1 m); cuda_kernels.launch_geometry picks
// the smallest that covers WZ.  A live profile is an array T x[NS] in
// registers whose every index is a compile-time constant after unrolling,
// so no profile is indexed in local memory (at 6 and 8 slots a thread
// holds up to 255 registers, and what ptxas spills lives there).
// Level-parallel work runs per lane (relaxation, EOS, solar terms, shear
// and dbloc, rimix with z121, ddmix, bldepth's per-level terms, blmix,
// tridcof and tridrhs, the T/S increments).  A stage that needs another level reads it from the
// warp's inputs in shared memory, from a per-warp exchange row that the
// lanes publish to (X0..X4), or by a shuffle for a single level (lvl).
// Column scalars are computed alike on every lane, so every branch on them
// is warp-uniform; each warp runs its own column's convergence and trap
// loops and never waits for another column.
//
// A column over several warps (the template parameter MW, the spread:
// WARP, BLOCK or CLUSTER; as a flag, "over several warps"), the "cw"
// library (MW = BLOCK): past 256 levels one block holds one column, spread
// over CW = 2..8 warps of NS = 4 slots (WZ <= 128 CW, ONE_BLOCK_WZ =
// 1024).  Level k sits on warp k / 128, lane k % 32, slot (k % 128) / 32;
// the column's rows in shared memory hold LZ = 128 CW levels, shared by
// its warps.  Every exchange across levels goes through those rows with a
// block barrier (the PCR and scan strides too, whatever their length); a
// single level's value (lvl) goes through a broadcast cell; bldepth's
// first crossing is the first of the warps' own in level order; the
// column-wide AND and count are __syncthreads_and and __syncthreads_count.
// The column's scalars are computed alike on every thread from the same
// shared values, so every branch around a barrier is uniform over the
// block; a land column's block skips the step's loops whole.  aref is read
// from device memory, and so are the grid rows where the column's rows
// leave no room (float64 at CW = 8).  With MW = WARP every function below
// compiles to the one-warp code (__syncwarp, shuffles, ballots).
//
// A column over a thread-block cluster (MW = CLUSTER, the "cl" library):
// past 1024 levels the column spreads over CB = 2..8 blocks of one
// cluster (MAXWZ = 8192), each of CW warps of 4 slots; block r of the
// cluster holds the levels [r LB, (r + 1) LB), LB = 128 CW, and only
// those levels of the column's rows (a ClRow: a read of level k maps the
// row to block k / LB's shared memory, distributed shared memory).  The
// body is the multi-warp one with cluster-wide primitives: col_sync is a
// cluster barrier (release/acquire, so it also orders the remote writes);
// lvl's holder writes the broadcast cell of every block, which each reads
// at home; the column AND and count combine the blocks' own through a
// cell per block (cl_sum); bldepth's first crossing is the first of the
// blocks' warps' own in level order; the RMSD sums stay serial in level
// order on block 0's first threads, reading every block's rows.  The
// column's scalars are computed alike on every thread of every block from
// the same cells, so every branch around a cluster barrier is uniform
// over the cluster.  aref and the grid rows are read from device memory
// (a block's slice holds only its own levels), and a block's shared
// memory outlives its neighbours' reads of it: the kernel ends on a
// cluster barrier before the write-back.
//
// Order-sensitive pieces keep the plain version's numbers:
// * bldepth's bulk Richardson scan is the plain max-plus doubling scan,
//   stage for stage; the first crossing comes from ballots;
// * the reference averages sum each row's nonzero prefix k = 0..hi[n] of
//   aref in the k order of the dense loop (the skipped terms are exact
//   zeros); the wrapper computes hi from aref once per aref tensor;
// * the instability RMSD sums and the mode-2 and band depth sums run
//   serially in level order (the column's first four threads take one
//   RMSD sum each);
// * the PCR solve keeps the plain elimination order;
// * the rhsmod depth prefix sum comes in as an input, computed by the plain
//   helper (fused_pass._depth_prefix), because its sums decide band edges
//   by >= comparisons and must round exactly as the plain ones.
#pragma once

#include <stddef.h>

#include <type_traits>

#include "physics.cuh"

#ifdef __CUDACC__
#define KPP_HD __host__ __device__ inline
#else
#define KPP_HD inline
#endif

// Stage clocks (chip_phases.py).  Built with -DKPP_PHASES, KPP_MARK(i)
// adds the warp's clock64() cycles since its previous mark to stage i of
// the pass body (lane 0 of each warp adds them to kpp_phase[i]) and
// KPP_BMARK(i) does the same for the block-level stages 10..13; without
// it they compile to nothing.
#ifdef KPP_PHASES
__device__ unsigned long long kpp_phase[16];
#define KPP_CLOCK(t0) long long t0 = clock64()
#define KPP_MARK_AT(i, t0)                                             \
  do {                                                                 \
    const long long kpp_t1 = clock64();                                \
    if ((threadIdx.x & 31) == 0)                                       \
      atomicAdd(&kpp_phase[i], (unsigned long long)(kpp_t1 - (t0)));   \
    t0 = kpp_t1;                                                       \
  } while (0)
#else
#define KPP_CLOCK(t0)
#define KPP_MARK_AT(i, t0)
#endif
#define KPP_MARK(i) KPP_MARK_AT(i, kpp_t0)    // stages 0..8 of the pass body
#define KPP_BMARK(i) KPP_MARK_AT(i, kpp_b0)   // stages 10..13 of a block

namespace kpp {

constexpr int NS_MAX = 8;         // level slots per lane of a one-warp column
constexpr int MW_NS = 4;          // ... of a column over several warps (MW)
constexpr int CW_MAX = 8;         // warps of one block's share of a column
constexpr int ONE_BLOCK_WZ = 32 * MW_NS * CW_MAX;  // levels a block covers
constexpr int CB_MAX = 8;         // blocks of a column's cluster (portable)
constexpr int MAXWZ = ONE_BLOCK_WZ * CB_MAX;  // levels a column covers (8192)
// how a column's levels spread: over one warp's lanes, over the warps of
// one block (the "cw" library), over the blocks of a cluster ("cl")
enum Spread { WARP = 0, BLOCK = 1, CLUSTER = 2 };
// how a launch's arrays lie in device memory (the header above): a
// profile (WZ, ncol) or (ncol, WZ), colscal (NSC, ncol) or (ncol, NSC),
// the column outputs (8 or 16, ncol) or (ncol, 8 or 16); the grid rows,
// aref and the row extents lie alike in both (the wrapper hands Z_LANES'
// aref over as COL_LANES passes it, transposed once per tensor)
enum Layout { COL_LANES = 0, Z_LANES = 1 };

#ifdef __CUDACC__
// the cluster's barrier (arrive has release and wait acquire semantics at
// cluster scope, so it orders the blocks' shared-memory writes before
// their reads) and the map of a generic address in this block's shared
// memory to block ``rank``'s copy (distributed shared memory); a host
// build of this file (an emulation of the kernels) defines cl_sync,
// cl_map and __umulhi itself
KPP_DEV void cl_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}
template <typename T> KPP_DEV T* cl_map(T* p, int rank) {
  T* q;
  asm("mapa.u64 %0, %1, %2;" : "=l"(q) : "l"(p), "r"(rank));
  return q;
}
#endif
// aref from device memory (Geometry::aref_dev) is compiled in from this
// many slots up: below it one warp and aref's whole shared copy always
// fit, and the 3- and 4-slot kernels keep their code without the branch
constexpr int AREF_DEV_MIN_NS = 6;
// In each function templated on NS, LZ is the number of levels of a
// profile row in shared memory: 32 * NS for one warp, 32 * NS * CW for a
// column over CW warps (Col::lz).
constexpr unsigned FULLMASK = 0xffffffffu;
constexpr double BIG = 1.0e30;    // the plain scan's -inf stand-in

// colscal rows (ops/fused_pass.py CS_*)
enum {
  CS_TAUX = 0, CS_TAUY = 1, CS_SWF = 2, CS_NSOL = 3, CS_ICE = 4, CS_RAIN = 5,
  CS_SSURF = 6, CS_SREF = 7, CS_F = 8, CS_OCDEPTH = 9, CS_RFAC = 10,
  CS_A1 = 11, CS_A2 = 12, CS_FIRST = 13, CS_RELAX_SST = 14, CS_SST0 = 15,
  CS_FCORR2D = 16, CS_RELAX_OCNT = 17, CS_RELAX_SAL = 18, CS_FCORRP = 19,
  CS_ADV1 = 20, CS_ACTIVE = 27, CS_RHO0_IN = 28, CS_CP0_IN = 29, NSC = 32
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

// Launch geometry, computed by the wrapper (cuda_kernels.launch_geometry):
// warps per block, blocks, aref columns the reference averages read,
// dynamic shared-memory bytes (smem_bytes below, checked by the launcher),
// level slots per lane (the NS of the kernels launched), where the
// transposed aref is read from: 0 a copy in shared memory, 1 the wrapper's
// (kref, LZ) tile in device memory (Inputs::aref_t), taken where no block
// of 8 down to 1 warps holds the shared copy (float64 at 8 slots on a
// stretched grid) and always by a column over several warps; the warps of
// one column (cw: 1, or 2..CW_MAX for the MW kernels, whose block is one
// column); and where the MW kernels read the grid rows: 0 a copy in
// shared memory, 1 the wrapper's padded (6, LZ) tile (Inputs::grid_t);
// the blocks of one column's cluster (cb: 1, or 2..CB_MAX for the
// CLUSTER kernels, whose blocks each hold cw warps of the column and
// always read aref and the grid rows from device memory).
struct Geometry {
  int warps, blocks, kref, smem, ns, aref_dev, cw, grid_dev, cb;
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

constexpr int N_OUT_MAX = 23;

// ref_hi: (WZ,) last nonzero column of each aref row, -1 for a zero row;
// aref_t: aref transposed into a (kref, LZ) tile, zero past WZ, in device
// memory (cuda_kernels._ref_tile), read where Geometry::aref_dev is set;
// grid_t: the rows zm, hm, dm, tdn, tup, pfx padded to LZ levels as their
// shared copy pads them (cuda_kernels._grid_tile), read where
// Geometry::grid_dev is set
template <typename T> struct Inputs {
  const T* p[N_IN];
  const int* ref_hi;
  const T* aref_t;
  const T* grid_t;
};
template <typename T> struct Outputs { T* p[N_OUT_MAX]; };

// Per-warp profile slots in shared memory, 32 * NS values each.  Slots 0..17
// receive the staged profile inputs of the same IN_* index; X0..X4 are the
// warp's exchange rows.  The full pass reuses input slots for its outputs
// once their inputs are dead (full_slot below).
enum {
  B_U = 0, B_V, B_T, B_S, B_UX, B_VX, B_TX, B_SX, B_UO, B_VO, B_TO, B_SO,
  B_SWDK, B_SWFRAC, B_OCNT, B_SAL, B_FCZ, B_SFCZ,
  B_X0, B_X1, B_X2, B_X3, B_X4, NB
};
constexpr int NCV = NSC + 16;     // colscal rows, then the column outputs
// MW: broadcast cells after the column values: lvl's level value at each
// call site (its own cell, so no reader waits on a later writer), each
// warp's first bldepth crossing, the four RMSD sums
enum {
  BC_RHO0 = 0, BC_CP0, BC_TA0, BC_SB0, BC_TSFC, BC_UREF, BC_VREF, BC_MNZ,
  BC_SNZ, BC_TNZ, BC_HBL, BC_MATCH, BC_ENH = BC_MATCH + 9,
  BC_FX = BC_ENH + 3, BC_RMSD = BC_FX + CW_MAX, NBC = BC_RMSD + 4
};
// CLUSTER: then a block's own column AND and count (cl_sum)
enum { BC_AND = NBC, BC_CNT, NBC_CL };

// per-warp stride in elements at ns level slots: padded to 4 (mod 32) so
// that the staging accesses of 8 warps x 4 levels fall on 32 different
// banks
KPP_HD int warp_stride(int ns) {
  int pw = NB * 32 * ns + NCV;
  return pw + ((4 - pw % 32) + 32) % 32;
}

// dynamic shared memory of one block at ns level slots (LZ = 32 ns): grid
// rows (6 x LZ), aref transposed (kref x LZ; kref = 0 where it is read from
// device memory), the warps' slots and column values, then hi (LZ ints)
KPP_HD size_t smem_bytes(int ns, int kref, int warps, int tsize) {
  const int lz = 32 * ns;
  return size_t((6 + kref) * lz + warps * warp_stride(ns)) * tsize
         + size_t(lz) * sizeof(int);
}

// MW: the elements of one column's area at lz levels a row (its NB rows,
// the column values, the broadcast cells)
KPP_HD int col_stride(int lz) { return NB * lz + NCV + NBC; }

// dynamic shared memory of one MW block, one column over cw warps (LZ =
// 32 MW_NS cw): the grid rows (6 x LZ, none where they are read from
// device memory), the column's area, then hi (LZ ints); aref is always
// read from device memory
KPP_HD size_t smem_bytes_mw(int cw, int grid_dev, int tsize) {
  const int lz = 32 * MW_NS * cw;
  return size_t((grid_dev ? 0 : 6) * lz + col_stride(lz)) * tsize
         + size_t(lz) * sizeof(int);
}

// dynamic shared memory of one block of a CLUSTER column, cw warps of it
// (LB = 32 MW_NS cw levels): its slice of the column's rows, the column
// values and broadcast cells, then its levels' hi (LB ints); aref and the
// grid rows are read from device memory
KPP_HD size_t smem_bytes_cl(int cw, int tsize) {
  const int lb = 32 * MW_NS * cw;
  return size_t(NB * lb + NCV + NBC_CL) * tsize + size_t(lb) * sizeof(int);
}

// full-pass diagnostic outputs (ops/fused_pass.py full tuple, after u..s)
enum {
  FO_COLOUT = 0, FO_DIFM, FO_DIFS, FO_DIFT, FO_GHAT, FO_RHO, FO_CP, FO_ALPHA,
  FO_BETA, FO_BUOY, FO_RIG, FO_DBLOC, FO_SHSQ, FO_WXNT, FO_SWDK, FO_TINC,
  FO_SINC, FO_OCNTCORR, FO_SCORR, N_FO
};
// the slot each full-pass output leaves in: outputs 0..3 (u..s solved),
// then FO_DIFM..FO_SCORR (FO_COLOUT goes from the column values)
KPP_HD constexpr int full_slot(int i) {
  constexpr int slot[4 + N_FO] = {
      B_UO, B_VO, B_TO, B_SO, -1, B_X0, B_X1, B_X2, B_X3, B_U, B_V, B_T,
      B_S, B_UX, B_SWFRAC, B_TX, B_SX, B_VX, B_SWDK, B_OCNT, B_SAL, B_FCZ,
      B_SFCZ};
  return slot[i];
}

template <typename T> struct ColOut { T hbl, kbl, rho0, cp0; };

// per-block shared grid data
template <typename T> struct Grid {
  const T *zm, *hm, *dm, *tdn, *tup, *pfx;  // LZ each, 0 beyond wz
  const T* arefT;   // (kref, LZ): arefT[k * LZ + n] = aref[n * wz + k]
  const T* arefG;   // the same tile in device memory, or nullptr (arefT)
  const int* hi;    // LZ: last nonzero k of aref row n, -1 beyond wz
};

// CLUSTER: one row of the column, whose LB levels held by this block
// start at p; level k lies in block k / LB (umulhi by mg = ceil(2^32 /
// LB), exact for k < 2^32 / LB), at k % LB in that block's copy of the
// row.  Adding n LZ (LZ = lzc, the column's levels) moves n rows on, as
// adding it to a row pointer of the other spreads does.
template <typename T> struct ClRow {
  T* p;
  int lb, lzc;
  unsigned mg;
  KPP_DEV int rank_of(int k) const { return int(__umulhi(unsigned(k), mg)); }
  KPP_DEV T& operator[](int k) const {
    const int r = rank_of(k);
    return *cl_map(p + (k - r * lb), r);
  }
  KPP_DEV ClRow operator+(int n) const {
    return {p + n / lzc * lb, lb, lzc, mg};
  }
  KPP_DEV explicit operator bool() const { return p != nullptr; }
};
// a row of one column's area: a pointer, or (CLUSTER) a ClRow
template <typename T, Spread MW>
using Row = std::conditional_t<MW == CLUSTER, ClRow<T>, T*>;

// CLUSTER: lb, the levels a block holds, mg, its ClRow divisor, and cb,
// the cluster's blocks (an empty base of the other spreads' Col, which
// keep the layout they had before the cluster form existed)
template <Spread MW> struct ColCluster {};
template <> struct ColCluster<CLUSTER> {
  int lb, cb;
  unsigned mg;
};

// one column's area in shared memory and this thread's place in it: its
// lane; (MW) k0, the level of its slot 0 (128 x its warp in the column +
// lane), and lzc, the levels of a row (CLUSTER: of the whole column)
template <typename T, int NS, Spread MW> struct Col : ColCluster<MW> {
  T* b;     // NB slots of LZ levels (CLUSTER: this block's LB of each)
  T* cv;    // colscal [0, NSC), column outputs [NSC, NSC + 16), then (MW)
            // the broadcast cells
  int lane, k0, lzc;
  // The one-warp forms are written as the constants they are (not
  // through a helper that returns one), and a one-warp block takes its
  // lane from its own variable, not back from this struct (col_of,
  // pass_block), so that those kernels compile to the registers they had
  // before the MW form existed.
  KPP_DEV int lev0() const {   // the level of slot 0
    if constexpr (MW) return k0; else return lane;
  }
  KPP_DEV Row<T, MW> slot(int i) const {
    if constexpr (MW == CLUSTER)
      return ClRow<T>{b + i * this->lb, this->lb, lzc, this->mg};
    else if constexpr (MW)
      return b + i * lzc;
    else
      return b + i * (32 * NS);
  }
};

// the barrier of one column's threads: its warp, (MW) its block or
// (CLUSTER) its cluster
template <Spread MW> KPP_DEV void col_sync() {
  if constexpr (MW == CLUSTER)
    cl_sync();
  else if (MW)
    __syncthreads();
  else
    __syncwarp();
}

#define KPP_FOR_Q _Pragma("unroll") for (int q = 0; q < NS; ++q)

// level k of x on every thread of the column (k uniform, 0 <= k < LZ): a
// shuffle, or (MW) through broadcast cell ``cell`` after a barrier
// (CLUSTER: the holder writes the cell of every block of the cluster)
template <typename T, int NS, Spread MW>
KPP_DEV T lvl(const Col<T, NS, MW>& w, const T (&x)[NS], int k, int cell) {
  if (!MW) {
    T v = x[0];
#pragma unroll
    for (int q = 1; q < NS; ++q)
      if (k >= 32 * q) v = x[q];
    return __shfl_sync(FULLMASK, v, k & 31);
  }
  const int kw = k % (32 * NS);           // k's place in its warp
  if (w.k0 == k - kw + (k & 31)) {        // the thread that holds k
    T v = x[0];
#pragma unroll
    for (int q = 1; q < NS; ++q)
      if (kw >= 32 * q) v = x[q];
    if constexpr (MW == CLUSTER)            // every block's cell
      for (int r = 0; r < w.cb; ++r) *cl_map(w.cv + NCV + cell, r) = v;
    else
      w.cv[NCV + cell] = v;
  }
  if constexpr (MW == CLUSTER)
    cl_sync();
  else
    __syncthreads();
  return w.cv[NCV + cell];
}
// the plain one-hot gather: 0 outside 0..wz-1 (k uniform)
template <typename T, int NS, Spread MW>
KPP_DEV T ext_l(const Col<T, NS, MW>& w, const T (&x)[NS], int k, int wz,
                int cell) {
  return (k >= 0 && k < wz) ? lvl(w, x, k, cell) : T(0);
}
template <typename T> KPP_DEV T ext(const T* a, int idx, int wz) {
  return (idx >= 0 && idx < wz) ? a[idx] : T(0);
}
// publish this thread's levels of x (slot 0 at level k0) to an exchange
// row (callers bracket a group of puts with col_sync)
template <typename T, int NS>
KPP_DEV void put(T* xb, const T (&x)[NS], int k0) {
  KPP_FOR_Q xb[k0 + 32 * q] = x[q];
}
// CLUSTER: a thread's levels lie in its own block (a warp's 128 levels
// never straddle two), so it writes them at home
template <typename T, int NS>
KPP_DEV void put(const ClRow<T>& xb, const T (&x)[NS], int k0) {
  T* p = xb.p + (k0 - xb.rank_of(k0) * xb.lb);
  KPP_FOR_Q p[32 * q] = x[q];
}

template <typename T>
KPP_DEV void ws_fn(const PassParams& P, T sig, T h, T us, T bf, T* wm, T* ws) {
  if (P.wscale_analytic)
    wscale_analytic(sig, h, us, bf, T(P.vonk), wm, ws);
  else
    wscale_nodal(sig, h, us, bf, T(P.vonk), wm, ws);
}

// One warp's column: x at level j - s (dn) or j + s (up) for s = 32, 64
// or 128 (the stages of WZ <= 256): whole slots move within each lane, no
// other lane is read; fill outside 0..LZ-1
template <typename T, int NS>
KPP_DEV void slot_dn(const T (&x)[NS], int s, T fill, T (&out)[NS]) {
  const int d = s >> 5;
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    T v = fill;
#pragma unroll
    for (int p = 0; p < q; ++p)
      if (q - p == d) v = x[p];
    out[q] = v;
  }
}
template <typename T, int NS>
KPP_DEV void slot_up(const T (&x)[NS], int s, T fill, T (&out)[NS]) {
  const int d = s >> 5;
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    T v = fill;
#pragma unroll
    for (int p = q + 1; p < NS; ++p)
      if (p - q == d) v = x[p];
    out[q] = v;
  }
}

// tridiagonal coefficients on rows (solvers.F90:14-44); leaves diff
// published in xd
template <typename T, int NS, Spread MW>
KPP_DEV void tridcof(const Col<T, NS, MW>& w, const T (&diff)[NS],
                     const Grid<T>& g, int nz, int wz, Row<T, MW> xd,
                     T (&cu)[NS],
                     T (&cc)[NS], T (&cl)[NS]) {
  const int k0 = w.lev0();
  col_sync<MW>();
  put(xd, diff, k0);
  col_sync<MW>();
  KPP_FOR_Q {
    const int r = k0 + 32 * q;
    const bool in1 = r + 1 < wz;
    T diff1 = in1 ? xd[r + 1] : T(0);
    T tdn1 = in1 ? g.tdn[r + 1] : T(0);
    T tup1 = in1 ? g.tup[r + 1] : T(0);
    cu[q] = r == 0 ? T(0) : -tup1 * diff[q];
    cc[q] = T(1) + tdn1 * diff1 + (r == 0 ? T(0) : tup1 * diff[q]);
    cl[q] = r == nz - 1 ? T(0) : -tdn1 * diff1;
  }
}

// scalar RHS on rows (solvers.F90:53-107); xd, xg, xn hold diff, ghat and
// the non-turbulent flux published (a null xn means zero flux)
template <typename T, int NS, typename R>
KPP_DEV void tridrhs(const Grid<T>& g, R yo, R xn, const T (&diff)[NS], R xd,
                     const T (&ghat)[NS], R xg, T sturflux, T ghatflux,
                     T dto, int nz, int wz, int k0, T (&rhs)[NS]) {
  const T bot = yo[nz] * g.tdn[nz] * xd[nz];
  KPP_FOR_Q {
    const int r = k0 + 32 * q;
    const bool in1 = r + 1 < wz;
    T d1 = in1 ? xd[r + 1] : T(0);
    T gh1 = in1 ? xg[r + 1] : T(0);
    T ghterm = ghatflux * (d1 * gh1 - diff[q] * ghat[q]);
    T ntterm = T(0);
    if (xn) ntterm = (in1 ? xn[r + 1] : T(0)) - xn[r];
    T x = yo[r] + rdiv_s(double(dto), g.hm[r]) * (ghterm + ntterm);
    if (r == 0) x = x + rdiv_s(-double(dto), g.hm[r]) * sturflux;
    if (r == nz - 1) x = x + bot;
    rhs[q] = x;
  }
}

// parallel cyclic reduction (ops/fused_pass.py _pcr_solve) of NR = 1 or 2
// systems that share one matrix, one column; the solutions overwrite rhs0
// (and rhs1 with NR = 2).  Stages s < 32 (every stage, MW) exchange
// through the five consecutive exchange rows x5; on one warp stages 32, 64
// and 128 move whole slots.
template <typename T, int NR, int NS, Spread MW>
KPP_DEV void pcr_solve(const Col<T, NS, MW>& w, const T (&cu)[NS],
                       const T (&cc)[NS], const T (&cl)[NS], T (&rhs0)[NS],
                       T (&rhs1)[NS], int nz, int wz, Row<T, MW> x5) {
  const int LZ = MW ? w.lzc : 32 * NS, k0 = w.lev0();
  const Row<T, MW> xa = x5;
  const Row<T, MW> xc = x5 + LZ;
  const Row<T, MW> xb = x5 + 2 * LZ;
  const Row<T, MW> xr = x5 + 3 * LZ;     // NR rows
  T a[NS], b[NS], c[NS], r[NR][NS];
  KPP_FOR_Q {
    const bool in = k0 + 32 * q < nz;
    a[q] = in ? cu[q] : T(0);
    b[q] = in ? cc[q] : T(1);
    c[q] = in ? cl[q] : T(0);
    r[0][q] = in ? rhs0[q] : T(0);
    if (NR == 2) r[NR - 1][q] = in ? rhs1[q] : T(0);
  }
  for (int s = 1; s < nz; s *= 2) {
    T rb[NS], rb_lo[NS], rb_hi[NS], a_lo[NS], a_hi[NS], c_lo[NS], c_hi[NS];
    T r_lo[NR][NS], r_hi[NR][NS];
    KPP_FOR_Q rb[q] = T(1) / (b[q] == T(0) ? T(1) : b[q]);
    if (MW || s < 32) {
      col_sync<MW>();
      put(xa, a, k0);
      put(xc, c, k0);
      put(xb, rb, k0);
#pragma unroll
      for (int i = 0; i < NR; ++i) put(xr + i * LZ, r[i], k0);
      col_sync<MW>();
      KPP_FOR_Q {
        const int j = k0 + 32 * q;
        const bool lo = j - s >= 0, up = j + s < LZ;
        rb_lo[q] = lo ? xb[j - s] : T(1);
        rb_hi[q] = up ? xb[j + s] : T(1);
        a_lo[q] = lo ? xa[j - s] : T(0);
        a_hi[q] = up ? xa[j + s] : T(0);
        c_lo[q] = lo ? xc[j - s] : T(0);
        c_hi[q] = up ? xc[j + s] : T(0);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if constexpr (MW == CLUSTER) {   // a ClRow indexes one row
            r_lo[i][q] = lo ? (xr + i * LZ)[j - s] : T(0);
            r_hi[i][q] = up ? (xr + i * LZ)[j + s] : T(0);
          } else {
            r_lo[i][q] = lo ? xr[i * LZ + j - s] : T(0);
            r_hi[i][q] = up ? xr[i * LZ + j + s] : T(0);
          }
        }
      }
    } else {
      slot_dn(rb, s, T(1), rb_lo);
      slot_up(rb, s, T(1), rb_hi);
      slot_dn(a, s, T(0), a_lo);
      slot_up(a, s, T(0), a_hi);
      slot_dn(c, s, T(0), c_lo);
      slot_up(c, s, T(0), c_hi);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        slot_dn(r[i], s, T(0), r_lo[i]);
        slot_up(r[i], s, T(0), r_hi[i]);
      }
    }
    KPP_FOR_Q {
      const bool hi = k0 + 32 * q + s < wz;   // beyond: shifted-in fill
      T alpha = -a[q] * rb_lo[q];
      T beta = -c[q] * (hi ? rb_hi[q] : T(1));
      T ah = hi ? a_hi[q] : T(0), ch = hi ? c_hi[q] : T(0);
      b[q] = b[q] + alpha * c_lo[q] + beta * ah;
#pragma unroll
      for (int i = 0; i < NR; ++i)
        r[i][q] = r[i][q] + alpha * r_lo[i][q]
                  + beta * (hi ? r_hi[i][q] : T(0));
      a[q] = alpha * a_lo[q];
      c[q] = beta * ch;
    }
  }
  KPP_FOR_Q {
    rhs0[q] = r[0][q] / b[q];
    if (NR == 2) rhs1[q] = r[NR - 1][q] / b[q];
  }
}

// the reference sums of level n over aref row n's nonzero prefix k =
// 0..hi, in k order: sum_k aT[k * lz + n] * x[k] for x = x0, x1, x2.  DEV:
// aT is the tile in device memory, read through the read-only path (one
// tile for every column, so it stays in L2); else the block's shared copy.
// x0..x2 are rows of the column (R: Row).
template <typename T, bool DEV, typename R>
KPP_DEV void ref_sums(const T* aT, int lz, int n, int hi, R x0, R x1, R x2,
                      T* u_out, T* v_out, T* b_out) {
  T u = T(0), v = T(0), b = T(0);
  for (int k = 0; k <= hi; ++k) {
    const T a = DEV ? __ldg(aT + k * lz + n) : aT[k * lz + n];
    u = u + a * x0[k];
    v = v + a * x1[k];
    b = b + a * x2[k];
  }
  *u_out = u;
  *v_out = v;
  *b_out = b;
}

// rhsmod band basis (mode 6/7 walk): rows [lo, n2r] with n2r the first row
// >= lo (below nz) whose depth depth_off + (pfx[r] - sub) reaches target,
// else nz-1; every thread walks alike
template <typename T>
KPP_DEV void band(const T* pfx, T sub, T depth_off, T target, int lo, int nz,
                  const Grid<T>& g, int* hi_out, T* val_out) {
  int n2r = nz - 1;
  for (int r = lo < 0 ? 0 : lo; r < nz; ++r)
    if (depth_off + (pfx[r] - sub) >= target) { n2r = r; break; }
  T delta = T(0);
  for (int r = lo < 0 ? 0 : lo; r <= n2r && r < nz; ++r) delta = delta + g.hm[r];
  *hi_out = n2r;
  *val_out = T(1) / (delta > T(0) ? delta : T(1));
}

// MW: the column's first bldepth crossing, the first of its warps' own
// (``firstx``, alike on a warp's lanes; -1 for none) in level order
// (CLUSTER: each warp's in its block's cell, read across the blocks)
template <typename T, int NS, Spread MW>
KPP_DEV int first_crossing(const Col<T, NS, MW>& w, int firstx) {
  T* fx = w.cv + NCV + BC_FX;
  const int wc = (w.k0 - w.lane) / (32 * NS), cw = w.lzc / (32 * NS);
  if constexpr (MW == CLUSTER) {
    const int wb = w.lb / (32 * NS);        // warps a block
    if (w.lane == 0) fx[wc % wb] = T(firstx);
    cl_sync();
    int f = -1;
    for (int i = 0; i < cw && f < 0; ++i)
      f = int(*cl_map(fx + i % wb, i / wb));
    return f;
  }
  if (w.lane == 0) fx[wc] = T(firstx);
  __syncthreads();
  int f = -1;
  for (int i = 0; i < cw && f < 0; ++i) f = int(fx[i]);
  return f;
}

// CLUSTER: the sum over the cluster's blocks of ``v``, alike on every
// thread of a block (each block's in its own cell ``cell``, then every
// block's read in rank order after a cluster barrier)
template <typename T, int NS, Spread MW>
KPP_DEV int cl_sum(const Col<T, NS, MW>& w, int v, int cell) {
  if (threadIdx.x == 0) w.cv[NCV + cell] = T(v);
  cl_sync();
  int n = 0;
  for (int r = 0; r < w.cb; ++r) n += int(*cl_map(w.cv + NCV + cell, r));
  return n;
}

// One fused pass of the column.  In: u..s (current iterate) and
// ux..sx.  Out: u..s become the solved u_n..s_n and ux..sx the
// under-relaxed iterate (the plain fast tuple's 2nd quartet).  f_cor is
// the Coriolis parameter this pass uses.  With FULL, the diagnostic
// profiles go to their full_slot slots and colout16 to the column values
// (the input slots they overwrite are dead by then).
template <typename T, bool FULL, int NS, Spread MW>
KPP_DEV void pass_warp(const PassParams& P, const Grid<T>& g,
                       const Col<T, NS, MW>& w,
                       T (&u)[NS], T (&v)[NS], T (&t)[NS], T (&s)[NS],
                       T (&ux)[NS], T (&vx)[NS], T (&tx)[NS], T (&sx)[NS],
                       T f_cor, ColOut<T>* co) {
  const int LZ = MW ? w.lzc : 32 * NS;
  const int nz = P.nz, wz = P.wz, k0 = w.lev0();
  const T dto = T(P.dto), grav = T(P.grav), zbot = T(P.zbot);
  const T lam = T(LAMBDA_SMOOTH), oml = T(1.0 - LAMBDA_SMOOTH);
  const T* cv = w.cv;
  const Row<T, MW> X0 = w.slot(B_X0);
  const Row<T, MW> X1 = w.slot(B_X1);
  const Row<T, MW> X2 = w.slot(B_X2);
  const Row<T, MW> X3 = w.slot(B_X3);
  const Row<T, MW> X4 = w.slot(B_X4);
  const Row<T, MW> UO = w.slot(B_UO);
  const Row<T, MW> VO = w.slot(B_VO);
  const Row<T, MW> TO = w.slot(B_TO);
  const Row<T, MW> SO = w.slot(B_SO);

  KPP_CLOCK(kpp_t0);
  // ---- under-relaxation: ux..sx := relaxed iterate ----------------------
  KPP_FOR_Q {
    ux[q] = lam * ux[q] + oml * u[q];
    vx[q] = lam * vx[q] + oml * v[q];
    tx[q] = lam * tx[q] + oml * t[q];
    sx[q] = lam * sx[q] + oml * s[q];
  }

  // ---- EOS on every level ---------------------------------------------------
  T alpha[NS], beta[NS], rho[NS], cp[NS], buoy[NS];
  const T sref = cv[CS_SREF];
  KPP_FOR_Q {
    const int k = k0 + 32 * q;
    alpha[q] = beta[q] = rho[q] = cp[q] = buoy[q] = T(0);
    if (k < wz) {
      T s_abs = sx[q] + sref, pr = -g.zm[k], al, be, sig0;
      abk80(s_abs, tx[q], pr, &al, &be, &sig0);
      alpha[q] = al;
      beta[q] = be;
      rho[q] = T(1000.0) + sig0;
      cp[q] = cpsw(s_abs, tx[q], pr);
      buoy[q] = div_s(-grav * sig0, 1000.0);
    }
    if (FULL) {   // the u..sx input slots are dead: each thread read its own
      w.slot(full_slot(4 + FO_RHO))[k] = rho[q];
      w.slot(full_slot(4 + FO_CP))[k] = cp[q];
      w.slot(full_slot(4 + FO_ALPHA))[k] = alpha[q];
      w.slot(full_slot(4 + FO_BETA))[k] = beta[q];
      w.slot(full_slot(4 + FO_BUOY))[k] = buoy[q];
    }
  }
  const T rho0 = lvl(w, rho, 0, BC_RHO0), cp0 = lvl(w, cp, 0, BC_CP0);
  const T ta0 = lvl(w, alpha, 0, BC_TA0), sb0 = lvl(w, beta, 0, BC_SB0);
  const T t_sfc = lvl(w, tx, 0, BC_TSFC);
  const T rhoh2o = T(1000.0) + sig0_of(T(0), t_sfc, -g.zm[0]);
  const T rhob = T(1000.0) + sig0_of(T(P.sice), t_sfc, -g.zm[0]);

  KPP_MARK(0);   // relaxation + EOS
  // ---- solar decay cache + non-turbulent flux -------------------------------
  const T first = cv[CS_FIRST], rfac = cv[CS_RFAC], a1j = cv[CS_A1],
          a2j = cv[CS_A2], swf = cv[CS_SWF];
  T wxnt[NS];
  {
    const Row<T, MW> swdk = w.slot(B_SWDK);
    KPP_FOR_Q {
      const int k = k0 + 32 * q;
      T swdk_new = rfac * k_exp(-g.dm[k] / a1j)
                   + (T(1) - rfac) * k_exp(-g.dm[k] / a2j);
      T swdk_opt = first * swdk_new + (T(1) - first) * swdk[k];
      wxnt[q] = -swf * swdk_opt / (rho0 * cp0);
      if (FULL) {   // own level only
        swdk[k] = swdk_opt;
        w.slot(full_slot(4 + FO_WXNT))[k] = wxnt[q];
      }
    }
  }

  // ---- kinematic surface fluxes ---------------------------------------------
  const T taux = cv[CS_TAUX], tauy = cv[CS_TAUY];
  const T wu0x = -taux / rho0, wu0y = -tauy / rho0;
  const T tau = k_sqrt(taux * taux + tauy * tauy) + T(EPS16);
  const T ustar = k_sqrt(tau / rho0);
  const T ssurf = cv[CS_SSURF], sice = T(P.sice);
  const T wx0t = -cv[CS_NSOL] / rho0 / cp0;
  const T wx0s = ssurf * cv[CS_RAIN] / rhoh2o
                 + (ssurf - sice) * cv[CS_ICE] / rhob;
  const T b0 = -grav * (ta0 * wx0t - sb0 * wx0s);
  const T wx0b = -b0;
  const T b0sol = grav * ta0 * swf / (rho0 * cp0);

  KPP_MARK(1);   // solar terms + surface fluxes
  // ---- reference profiles & bulk-Richardson inputs -----------------------
  // ref_avg(prof)[n] = sum over k <= hi[n] of aref[n, k] prof[k]
  T ritop[NS], dvsq[NS], dbloc[NS], shsq[NS];
  T uref_b = T(0), vref_b = T(0);
  {
    col_sync<MW>();
    put(X0, ux, k0);
    put(X1, vx, k0);
    put(X2, buoy, k0);
    col_sync<MW>();
    T urefv[NS], vrefv[NS];
    KPP_FOR_Q {
      const int n = k0 + 32 * q;
      T uref, vref, bref;
      if ((MW || NS >= AREF_DEV_MIN_NS) && g.arefG)
        ref_sums<T, true>(g.arefG, LZ, n, g.hi[n], X0, X1, X2, &uref, &vref,
                          &bref);
      else
        ref_sums<T, false>(g.arefT, LZ, n, g.hi[n], X0, X1, X2, &uref,
                           &vref, &bref);
      urefv[q] = uref;
      vrefv[q] = vref;
      T zref = T(EPSILON_KPP) * g.zm[n];
      ritop[q] = (zref - g.zm[n]) * (bref - buoy[q]);
      T eu = uref - ux[q], ev = vref - vx[q];
      dvsq[q] = eu * eu + ev * ev;
      const bool im = n >= 1 && n <= nz;
      dbloc[q] = im ? X2[n - 1] - buoy[q] : T(0);
      T du = im ? X0[n - 1] - ux[q] : T(0), dv = im ? X1[n - 1] - vx[q] : T(0);
      shsq[q] = im ? du * du + dv * dv : T(0);
      if (FULL) {   // own level only
        w.slot(full_slot(4 + FO_DBLOC))[n] = dbloc[q];
        w.slot(full_slot(4 + FO_SHSQ))[n] = shsq[q];
      }
    }
    if (FULL) {
      uref_b = lvl(w, urefv, nz - 1, BC_UREF);
      vref_b = lvl(w, vrefv, nz - 1, BC_VREF);
    }
  }

  KPP_MARK(2);   // reference averages
  // ---- rimix + z121 ------------------------------------------------------------
  T rig[NS], difm[NS], difs[NS], dift[NS], ghat[NS];
  KPP_FOR_Q {
    const int k = k0 + 32 * q;
    const bool im = k >= 1 && k <= nz;
    rig[q] = (P.lri && im)
                 ? dbloc[q] * (g.zm[k - 1] - g.zm[k]) / (shsq[q] + T(EPS16))
                 : T(0);
  }
  col_sync<MW>();
  put(X3, rig, k0);
  col_sync<MW>();
  KPP_FOR_Q {
    const int k = k0 + 32 * q;
    const bool im = k >= 1 && k <= nz;
    difm[q] = difs[q] = dift[q] = ghat[q] = T(0);
    if (P.lri && im) {
      // w*vz of the neighbours (both zero outside the interfaces)
      auto wv = [&](int j, T* wt) {
        bool imj = j >= 1 && j <= nz;
        T r = X3[j];
        *wt = (imj && !(r < T(0) || r > T(RIINFTY))) ? T(1) : T(0);
        return *wt * (imj ? r : T(0));
      };
      T wl, wh;
      T wvl = wv(k - 1, &wl);                       // k >= 1
      T wvh = k + 1 < wz ? wv(k + 1, &wh) : (wh = T(0), T(0));
      T num = wvl + T(2) * rig[q] + wvh;
      T den = wl + T(2) + wh;
      T smooth = num / den;
      T rigg = k_max(rig[q], T(RICON));
      T ratio = k_min(div_s(T(RICON) - rigg, RICON), T(1));
      T x = T(1) - ratio * ratio;
      T fcon = x * x * x;
      rigg = k_max(smooth, T(0));
      ratio = k_min(div_s(rigg, RIINFTY), T(1));
      x = T(1) - ratio * ratio;
      T fri = x * x * x;
      difm[q] = T(DIFMIW) + fcon * T(DIFMCON) + fri * T(DIFM0);
      difs[q] = T(DIFSIW) + fcon * T(DIFSCON) + fri * T(DIFS0);
      dift[q] = difs[q];
    }
  }

  if (P.ldd) {  // double diffusion (ddmix_mod :12-52)
    col_sync<MW>();
    put(X0, alpha, k0);
    put(X1, beta, k0);
    put(X2, tx, k0);
    put(X4, sx, k0);
    col_sync<MW>();
    KPP_FOR_Q {
      const int k = k0 + 32 * q;
      if (k >= 1 && k <= nz) {
        T adt = T(0.5) * (X0[k - 1] + alpha[q]) * (X2[k - 1] - tx[q]);
        T bds = T(0.5) * (X1[k - 1] + beta[q]) * (X4[k - 1] - sx[q]);
        if (adt > bds && bds > T(0)) {
          T rrho_f = k_min(adt / bds, T(RRHO0));
          T qq = div_s(rrho_f - T(1), RRHO0 - 1.0);
          T dd = T(1) - qq * qq;
          T diff_f = T(DSFMAX) * dd * dd * dd;
          dift[q] = dift[q] + diff_f * T(0.8) / rrho_f;
          difs[q] = difs[q] + diff_f;
        }
        if (adt < T(0) && bds < T(0) && adt < bds) {
          T rrho_c = adt / bds;
          T diff_c = T(1.5e-6 * 9.0 * 0.101)
                     * k_exp(T(4.6) * k_exp(T(-0.54) * (T(1) / rrho_c - T(1))));
          T prandtl = rrho_c > T(0.5) ? (T(1.85) - rdiv_s(0.85, rrho_c)) * rrho_c
                                      : T(0.15) * rrho_c;
          dift[q] = dift[q] + diff_c;
          difs[q] = difs[q] + prandtl * diff_c;
        }
      }
    }
  }
  {  // bottom kmp1 coefficient for blmix matching (kppmix :58-62)
    const T m_nz = lvl(w, difm, nz, BC_MNZ), s_nz = lvl(w, difs, nz, BC_SNZ),
            t_nz = lvl(w, dift, nz, BC_TNZ);
    KPP_FOR_Q {
      if (k0 + 32 * q == nz + 1) {
        difm[q] = m_nz;
        difs[q] = s_nz;
        dift[q] = t_nz;
      }
    }
  }

  KPP_MARK(3);   // rimix + z121 + ddmix
  T hbl;
  int kbl;
  if (P.lkpp) {
    // ---- bldepth (bldepth_mod :32-203); level k = Fortran kl ---------------
    const T vtc = T(P.vtc), ocdepth = cv[CS_OCDEPTH];
    const T hek = T(CEKMAN) * ustar / (k_abs(f_cor) + T(EPS16));
    const T dmo_num = div_s(T(CMONOB) * (ustar * ustar * ustar), P.vonk);
    const Row<T, MW> swfrac = w.slot(B_SWFRAC);
    col_sync<MW>();
    put(X0, dbloc, k0);
    put(X1, ritop, k0);
    put(X2, dvsq, k0);
    col_sync<MW>();
    // The first crossing is usually in slot 0 (levels < 32), and the
    // doubling scan's values there are final after its stages < 32, so
    // slot 0 goes first; slots 1..NS-1 only when it has no crossing
    // (levels past the first crossing never change hbl or kbl).  (MW: the
    // first round is levels < 32, slot 0 of the column's first warp.)
    T hmin_l[NS];
    int firstx = -1;
    for (int nsl = 1;; nsl = NS) {
      // per-level terms; the scan starts from m = raw, c = 1e-16 on 2..nz
      T m_acc[NS], c_acc[NS], dmo_l[NS], hekman_l[NS];
      KPP_FOR_Q {
        const int k = k0 + 32 * q;
        m_acc[q] = T(-BIG);
        c_acc[q] = dmo_l[q] = hekman_l[q] = T(0);
        if ((MW ? nsl > 1 || k < 32 : q < nsl) && k >= 2 && k <= nz) {
          T z_kl = g.zm[k - 1], z_klm1 = g.zm[k - 2];
          T bfsfc_l = b0 + b0sol * (T(1) - swfrac[k - 1]);
          T stable_l = (bfsfc_l + T(EPS16) >= T(0)) ? T(1) : T(0);
          T sigma_l = stable_l + (T(1) - stable_l) * T(EPSILON_KPP);
          T wm_l, ws_l;
          ws_fn(P, sigma_l, -z_kl, ustar, bfsfc_l, &wm_l, &ws_l);
          T dz_up = z_klm1 - z_kl, dz_dn = z_kl - g.zm[k];
          T bvsq = T(0.5) * (X0[k - 1] / dz_up + dbloc[q] / dz_dn);
          T vtsq = -z_kl * ws_l * k_sqrt(k_abs(bvsq)) * vtc;
          T dmo_raw = dmo_num / (k_abs(bfsfc_l) + T(EPS16));
          dmo_l[q] = stable_l * dmo_raw - (T(1) - stable_l) * zbot;
          hekman_l[q] = stable_l * hek - (T(1) - stable_l) * zbot;
          m_acc[q] = X1[k - 1] / (X2[k - 1] + vtsq + T(EPS16));   // raw
          c_acc[q] = T(EPS16);
        }
      }
      // Rib(k) = max(raw_k, Rib(k-1) + 1e-16): the plain doubling scan
      const int smax = nsl == 1 ? 32 : wz;
      for (int step = 1; step < wz && step < smax; step *= 2) {
        T m_s[NS], c_s[NS];
        if (MW || step < 32) {
          col_sync<MW>();
          put(X3, m_acc, k0);
          put(X4, c_acc, k0);
          col_sync<MW>();
          KPP_FOR_Q {
            const int j = k0 + 32 * q - step;
            m_s[q] = j >= 0 ? X3[j] : T(-BIG);
            c_s[q] = j >= 0 ? X4[j] : T(0);
          }
        } else {
          slot_dn(m_acc, step, T(-BIG), m_s);
          slot_dn(c_acc, step, T(0), c_s);
        }
        KPP_FOR_Q {
          m_acc[q] = k_max(m_acc[q], m_s[q] + c_acc[q]);
          c_acc[q] = c_s[q] + c_acc[q];
        }
      }
      T rib[NS];
      KPP_FOR_Q rib[q] = k_max(m_acc[q], c_acc[q]);
      col_sync<MW>();
      put(X3, rib, k0);
      put(X4, dmo_l, k0);
      col_sync<MW>();
      KPP_FOR_Q {
        const int k = k0 + 32 * q;
        bool cross = false;
        hmin_l[q] = T(0);
        if ((MW ? nsl > 1 || k < 32 : q < nsl) && k >= 2 && k <= nz) {
          T z_kl = g.zm[k - 1], z_klm1 = g.zm[k - 2];
          T rib_prev = X3[k - 1];
          T dmo_prev = k == 2 ? -zbot : X4[k - 1];
          T hri = -z_klm1 + (z_klm1 - z_kl) * (T(RICR) - rib_prev)
                                / (rib[q] - rib_prev);
          T slope = (dmo_l[q] - dmo_prev) / (z_klm1 - z_kl);
          T hmonob = dmo_l[q] <= -z_kl
                         ? (dmo_l[q] + slope * z_kl) / (T(1) - slope) : -zbot;
          T hmin = k_min(k_min(hri, hmonob), k_min(hekman_l[q], -ocdepth));
          T hmin2 = k_min(k_min(hri, hmonob), -ocdepth);
          if (hmin < -z_klm1 && hmin2 < -z_kl) hmin = hmin2;
          hmin_l[q] = hmin;
          cross = hmin < -z_kl;
        }
        unsigned bal = __ballot_sync(FULLMASK, cross);
        if (firstx < 0 && bal)
          firstx = (MW ? k0 - w.lane : 0) + 32 * q + __ffs(bal) - 1;
      }
      if (MW) firstx = first_crossing(w, firstx);
      if (firstx >= 0 || nsl == NS || nz < 32) break;
    }
    kbl = firstx >= 0 ? firstx : nz;
    hbl = firstx >= 0 ? lvl(w, hmin_l, firstx, BC_HBL) : -g.zm[nz - 1];

    KPP_MARK(4);   // bldepth
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
    auto match = [&](const T (&dif)[NS], int cell, T* dp_out) {
      T d_m1 = ext_l(w, dif, kn - 1, wz, cell),
        d_0 = ext_l(w, dif, kn, wz, cell + 1),
        d_p1 = ext_l(w, dif, kn + 1, wz, cell + 2);
      T dvdzup = (d_m1 - d_0) / hm_kn;
      T dvdzdn = (d_0 - d_p1) / hm_knp1;
      T dp = T(0.5) * ((T(1) - r_frac) * (dvdzup + k_abs(dvdzup))
                       + r_frac * (dvdzdn + k_abs(dvdzdn)));
      *dp_out = dp;
      return d_0 + dp * delhat;
    };
    T viscp, difsp, diftp;
    T visch = match(difm, BC_MATCH, &viscp);
    T difsh = match(difs, BC_MATCH + 3, &difsp);
    T difth = match(dift, BC_MATCH + 6, &diftp);
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
      enh_m = enh(lvl(w, difm, ki_e, BC_ENH), bm, dkm1_m);
      enh_s = enh(lvl(w, difs, ki_e, BC_ENH + 1), bs, dkm1_s);
      enh_t = enh(lvl(w, dift, ki_e, BC_ENH + 2), bt, dkm1_t);
      enh_g = (T(1) - case_a) * gh;
    }
    // ---- merge boundary layer and interior (kppmix :100-124) ---------------
    KPP_FOR_Q {
      const int k = k0 + 32 * q;
      if (k >= 1 && k < kbl && k <= nz) {
        if (sel_ok && k == ki_e) {
          difm[q] = enh_m;
          difs[q] = enh_s;
          dift[q] = enh_t;
          ghat[q] = enh_g;
        } else {
          T bm, bs, bt, gh;
          blmc(k, &bm, &bs, &bt, &gh);
          difm[q] = bm;
          difs[q] = bs;
          dift[q] = bt;
          ghat[q] = gh;
        }
      }
    }
  } else {
    hbl = -g.zm[nz - 1];
    kbl = nz;
  }
  if (FULL) {   // swfrac (read across levels by bldepth) is dead now
    col_sync<MW>();
    const Row<T, MW> o = w.slot(full_slot(4 + FO_RIG));
    KPP_FOR_Q o[k0 + 32 * q] = rig[q];
  }

  KPP_MARK(5);   // blmix + enhance + merge
  // bottom diffusivity limits + no bottom ghat (verticalmixing :151-159)
  KPP_FOR_Q {
    const int k = k0 + 32 * q;
    if (k >= nz) {
      difm[q] = T(VLIMIT_BOTTOM);
      difs[q] = T(DLIMIT_BOTTOM);
      dift[q] = T(DLIMIT_BOTTOM);
    }
    if (k == nz) ghat[q] = T(0);
  }

  // ---- ocnint: backward-Euler solves (ocnint_mod :19-221) ----------------
  const T hm_sfc = g.hm[0];
  T cu[NS], cc[NS], cl[NS], rhs_t[NS], rhs_s[NS];
  // U / V with semi-implicit Coriolis (:44-72)
  tridcof(w, difm, g, nz, wz, X0, cu, cc, cl);
  const T bot_m = g.tdn[nz] * X0[nz];
  const T fc = dto * f_cor * T(0.5);
  KPP_FOR_Q {
    const int r = k0 + 32 * q;
    T x = UO[r] + fc * (VO[r] + vx[q]);
    if (r == 0) x = x + -dto * wu0x / hm_sfc;
    if (r == nz - 1) x = x + bot_m * UO[nz];
    rhs_t[q] = x;
  }
  pcr_solve<T, 1>(w, cu, cc, cl, rhs_t, rhs_t, nz, wz, X0);
  KPP_FOR_Q {
    const int r = k0 + 32 * q;
    u[q] = r < nz ? rhs_t[q] : (r == nz ? UO[r] : T(0));
  }
  KPP_FOR_Q {
    const int r = k0 + 32 * q;
    T us_r = r < nz ? u[q] : T(0);   // the solve's own rows (0 below nz)
    T x = VO[r] - fc * (UO[r] + us_r);
    if (r == 0) x = x + -dto * wu0y / hm_sfc;
    if (r == nz - 1) x = x + bot_m * VO[nz];
    rhs_t[q] = x;
  }
  pcr_solve<T, 1>(w, cu, cc, cl, rhs_t, rhs_t, nz, wz, X0);
  KPP_FOR_Q {
    const int r = k0 + 32 * q;
    v[q] = r < nz ? rhs_t[q] : (r == nz ? VO[r] : T(0));
  }

  KPP_MARK(6);   // U and V solves
  // temperature (:82-162) and salinity (:164-219).  Without double
  // diffusion dift and difs are equal on every level, and the two
  // systems share one matrix: one PCR then solves both (same arithmetic
  // per system as two solves).
  bool ts_eq = true;
  KPP_FOR_Q ts_eq = ts_eq && difs[q] == dift[q];
  bool same_ts = MW ? __syncthreads_and(ts_eq) : __all_sync(FULLMASK, ts_eq);
  if constexpr (MW == CLUSTER) same_ts = cl_sum(w, !same_ts, BC_AND) == 0;
  tridcof(w, dift, g, nz, wz, X0, cu, cc, cl);
  col_sync<MW>();
  put(X1, ghat, k0);
  put(X2, wxnt, k0);
  col_sync<MW>();
  tridrhs(g, TO, X2, dift, X0, ghat, X1, wx0t, wx0t, dto, nz, wz, k0, rhs_t);
  T fcorr = cv[CS_FCORRP];
  if (P.l_relax_sst && !P.l_fcorr_withz && !P.l_fcorr) {
    T relax_sst = cv[CS_RELAX_SST], sst0 = cv[CS_SST0];
    bool do_rlx = relax_sst > T(1.0e-10);
    T dm_kmixe = ext(g.dm, kbl, wz);
    T to_sfc = TO[0];
    T incr = dto * relax_sst * (sst0 - to_sfc) * dm_kmixe / hm_sfc;
    if (!P.l_relax_calconly && do_rlx && k0 == 0)
      rhs_t[0] = rhs_t[0] + incr;
    fcorr = do_rlx ? relax_sst * (sst0 - to_sfc) * dm_kmixe * rho0 * cp0 : T(0);
  }
  if (P.l_fcorr && !P.l_relax_sst && !P.l_fcorr_withz && k0 == 0)
    rhs_t[0] = rhs_t[0] + dto * cv[CS_FCORR2D] / (rho0 * cp0 * hm_sfc);
  {
    const T relax_ocnt = cv[CS_RELAX_OCNT];
    const Row<T, MW> ocnt = w.slot(B_OCNT);
    const Row<T, MW> fcz = w.slot(B_FCZ);
    KPP_FOR_Q {
      const int r = k0 + 32 * q;
      T tinc = T(0);
      if (P.l_fcorr_withz && !P.l_fcorr)
        tinc = tinc + dto * fcz[r] / (rho[q] * cp[q]);
      if (P.l_relax_ocnt)
        tinc = tinc + dto * relax_ocnt * (ocnt[r] - TO[r]);
      if (r <= nz - 1) rhs_t[q] = rhs_t[q] + tinc;
      if (FULL) {   // own level only
        w.slot(full_slot(4 + FO_TINC))[r] = tinc;
        w.slot(full_slot(4 + FO_OCNTCORR))[r] =
            div_s(tinc * rho[q] * cp[q], P.dto);
      }
    }
  }
  if (!same_ts) {   // the solve overwrites X0..X4
    pcr_solve<T, 1>(w, cu, cc, cl, rhs_t, rhs_t, nz, wz, X0);
    tridcof(w, difs, g, nz, wz, X0, cu, cc, cl);
    col_sync<MW>();
    put(X1, ghat, k0);
    col_sync<MW>();
  }
  // salinity: wXNT(:,2) is identically zero in the reference
  tridrhs(g, SO, Row<T, MW>(), difs, X0, ghat, X1, wx0s, wx0s, dto, nz, wz,
          k0, rhs_s);
  if (P.l_advect) {
    // steady advection corrections (rhsmod modes 1-7, solvers.F90:176-335):
    // each mode's basis is one value over a band of rows
    const int km = kbl;
    const T dm_km = ext(g.dm, km, wz), hm_km = ext(g.hm, km - 1, wz),
            hm_km1 = ext(g.hm, km - 2, wz);
    T c_m[7];
#pragma unroll
    for (int m = 0; m < 7; ++m) c_m[m] = cv[CS_ADV1 + m];
    // mode 2: rows 0..km-2
    T d2 = T(0);
    for (int r = 0; r < nz && r <= km - 2; ++r) d2 = d2 + g.hm[r];
    const T v2 = T(1) / (d2 > T(0) ? d2 : T(1));
    // mode 6: walk from the surface to the seasonal mixed-layer depth
    int hi6, hi7;
    T v6, v7;
    band(g.pfx, T(0), T(P.adv_hm1), dm_km - T(0.5) * (hm_km + hm_km1), 0, nz,
         g, &hi6, &v6);
    // mode 7: walk from row km7-2 to 100 m below
    const int km7 = km > 2 ? km : 2;
    const T pfx_lo = km7 >= 3 ? ext(g.pfx, km7 - 3, wz) : T(0);
    band(g.pfx, pfx_lo, dm_km - T(0.5) * hm_km, T(100.0), km7 - 2, nz, g,
         &hi7, &v7);
    const bool mode4 = P.adv_n1_4 > 0 && P.adv_delta4 > 0.0;
    const T adv = T(P.dto * 0.033);
    KPP_FOR_Q {
      const int r = k0 + 32 * q;
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
      rhs_s[q] = rhs_s[q] + adv * total;
    }
  }
  {
    const T relax_sal = cv[CS_RELAX_SAL];
    const Row<T, MW> sal = w.slot(B_SAL);
    const Row<T, MW> sfcz = w.slot(B_SFCZ);
    KPP_FOR_Q {
      const int r = k0 + 32 * q;
      T sinc = T(0);
      if (P.l_sfcorr_withz) sinc = sinc + dto * sfcz[r];
      if (P.l_relax_sal) sinc = sinc + dto * relax_sal * (sal[r] - SO[r]);
      if (r <= nz - 1) rhs_s[q] = rhs_s[q] + sinc;
      if (FULL) {   // own level only
        w.slot(full_slot(4 + FO_SINC))[r] = sinc;
        w.slot(full_slot(4 + FO_SCORR))[r] = div_s(sinc, P.dto);
      }
    }
  }
  if (same_ts)
    pcr_solve<T, 2>(w, cu, cc, cl, rhs_t, rhs_s, nz, wz, X0);
  else
    pcr_solve<T, 1>(w, cu, cc, cl, rhs_s, rhs_s, nz, wz, X0);
  KPP_FOR_Q {
    const int r = k0 + 32 * q;
    t[q] = r < nz ? rhs_t[q] : (r == nz ? TO[r] : T(0));
    s[q] = r < nz ? rhs_s[q] : (r == nz ? SO[r] : T(0));
  }

  KPP_MARK(7);   // T and S solves
  co->hbl = hbl;
  co->kbl = T(kbl);
  co->rho0 = rho0;
  co->cp0 = cp0;
  if (FULL) {
    col_sync<MW>();   // the old-state and exchange rows are dead now
    KPP_FOR_Q {
      const int k = k0 + 32 * q;
      w.slot(full_slot(0))[k] = u[q];
      w.slot(full_slot(1))[k] = v[q];
      w.slot(full_slot(2))[k] = t[q];
      w.slot(full_slot(3))[k] = s[q];
      w.slot(full_slot(4 + FO_DIFM))[k] = difm[q];
      w.slot(full_slot(4 + FO_DIFS))[k] = difs[q];
      w.slot(full_slot(4 + FO_DIFT))[k] = dift[q];
      w.slot(full_slot(4 + FO_GHAT))[k] = ghat[q];
    }
    if (k0 == 0) {
      T* c16 = w.cv + NSC;
      const T vals[16] = {hbl, T(kbl), rhoh2o, fcorr, wu0x, wu0y, wx0t, wx0s,
                          wx0b, uref_b, vref_b, ustar, T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int i = 0; i < 16; ++i) c16[i] = vals[i];
    }
  }
}

// ---- the whole step for one column (ops/fused_pass.py _step_body) ----------
// The convergence and trap loops run per column: a column's updates
// depend only on that column, so the result equals the plain batch-masked
// loops.
// instability's RMSD sum i: lane i's acc, or (MW) broadcast cell i
template <Spread MW, typename T>
KPP_DEV T rmsd_sum(const T* cell, T acc, int i) {
  if constexpr (MW) return cell[i]; else return __shfl_sync(FULLMASK, acc, i);
}

template <typename T, int NS, Spread MW>
KPP_DEV bool instability(const PassParams& P, const Grid<T>& g,
                         const Col<T, NS, MW>& w, const T (&u)[NS],
                         const T (&v)[NS], const T (&t)[NS], const T (&s)[NS],
                         T* fmul) {
  const int LZ = MW ? w.lzc : 32 * NS;
  const int nz = P.nz, wz = P.wz, k0 = w.lev0();
  const Row<T, MW> X0 = w.slot(B_X0);
  // X1..X4: the four RMSD term rows, consecutive
  const Row<T, MW> X1 = w.slot(B_X1);
  col_sync<MW>();
  put(X0, t, k0);
  col_sync<MW>();
  int nbad = 0;
  KPP_FOR_Q {
    const int k = k0 + 32 * q;
    bool bad = false;
    if (k < nz) {
      T dxv = k_abs(t[q] - (k + 1 < wz ? X0[k + 1] : T(0)));
      bad = k_abs(u[q]) >= T(10) || k_abs(v[q]) >= T(10) || dxv >= T(10);
    }
    nbad += MW ? __syncthreads_count(bad)
               : __popc(__ballot_sync(FULLMASK, bad));
  }
  if constexpr (MW == CLUSTER) nbad = cl_sum(w, nbad, BC_CNT);
  // RMSD terms (d * d * w per level), summed serially in level order
  const Row<T, MW> old[4] = {w.slot(B_UO), w.slot(B_VO), w.slot(B_TO),
                             w.slot(B_SO)};
  KPP_FOR_Q {
    const int k = k0 + 32 * q;
    const T wt = k <= nz ? div_s(g.hm[k], P.dm_nz) : T(0);
    T du = u[q] - old[0][k], dv = v[q] - old[1][k];
    T dt = t[q] - old[2][k], ds = s[q] - old[3][k];
    if constexpr (MW == CLUSTER) {   // a ClRow indexes one row
      X1[k] = du * du * wt;
      (X1 + LZ)[k] = dv * dv * wt;
      (X1 + 2 * LZ)[k] = dt * dt * wt;
      (X1 + 3 * LZ)[k] = ds * ds * wt;
    } else {
      X1[k] = du * du * wt;
      X1[LZ + k] = dv * dv * wt;
      X1[2 * LZ + k] = dt * dt * wt;
      X1[3 * LZ + k] = ds * ds * wt;
    }
  }
  col_sync<MW>();
  T acc = T(0);
  if (k0 < 4) {
    const Row<T, MW> row = X1 + k0 * LZ;
    for (int k = 0; k < wz; ++k) acc = acc + row[k];
  }
  // the four sums: lanes 0..3's by shuffle, or (MW) through broadcast
  // cells after a barrier (rmsd_sum; CLUSTER: every block's cells)
  T* cell = w.cv + NCV + BC_RMSD;
  if constexpr (MW == CLUSTER) {
    if (k0 < 4)
      for (int r = 0; r < w.cb; ++r) *cl_map(cell + k0, r) = acc;
    cl_sync();
  } else if (MW) {
    if (k0 < 4) cell[k0] = acc;
    __syncthreads();
  }
  const bool e0 = k_sqrt(rmsd_sum<MW>(cell, acc, 0)) >= T(P.rmsd_thr[0]);
  const bool e1 = k_sqrt(rmsd_sum<MW>(cell, acc, 1)) >= T(P.rmsd_thr[1]);
  const bool e2 = k_sqrt(rmsd_sum<MW>(cell, acc, 2)) >= T(P.rmsd_thr[2]);
  const bool e3 = k_sqrt(rmsd_sum<MW>(cell, acc, 3)) >= T(P.rmsd_thr[3]);
  const int nex = int(e0) + int(e1) + int(e2) + int(e3);
  const bool blown = nbad > 0;
  const int n = nbad + (blown ? 0 : nex);
  *fmul = k_pow(T(1.01), T(n));
  return blown || e0 || e1 || e2 || e3;
}

// The step's 8 output profiles go to slots 0..7 and colstep to the column
// values (rows 0=hmix, 1=kmix, 2=rho0, 3=cp0, 4=comp_flag, 5=reset_flag,
// 6=f_used, 7=npass, the passes the column ran).
template <typename T, int NS, Spread MW>
KPP_DEV void step_warp(const PassParams& P, const Grid<T>& g,
                       const Col<T, NS, MW>& w) {
  const int nz = P.nz, k0 = w.lev0();
  const T* cv = w.cv;
  const Row<T, MW> U0 = w.slot(B_U);
  const Row<T, MW> V0 = w.slot(B_V);
  const Row<T, MW> T0 = w.slot(B_T);
  const Row<T, MW> S0 = w.slot(B_S);
  T u[NS], v[NS], t[NS], s[NS], ux[NS], vx[NS], tx[NS], sx[NS];
  auto load0 = [&]() {
    KPP_FOR_Q {
      const int k = k0 + 32 * q;
      u[q] = ux[q] = U0[k];
      v[q] = vx[q] = V0[k];
      t[q] = tx[q] = T0[k];
      s[q] = sx[q] = S0[k];
    }
  };
  const bool active = cv[CS_ACTIVE] > T(0.5);
  const T f0 = cv[CS_F];
  T hmixn = T(0), kmixn = T(nz), rho0 = cv[CS_RHO0_IN], cp0 = cv[CS_CP0_IN];
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
      pass_warp<T, false>(P, g, w, u, v, t, s, ux, vx, tx, sx, f_local, &co);
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
    KPP_CLOCK(kpp_t0);
    bool comp_n = instability(P, g, w, u, v, t, s, &fmul);
    KPP_MARK(8);   // instability check
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
  // each thread writes its own levels: slots 0..3 are read at own level
  // only
  KPP_FOR_Q {
    const int k = k0 + 32 * q;
    w.slot(B_U)[k] = u[q];
    w.slot(B_V)[k] = v[q];
    w.slot(B_T)[k] = t[q];
    w.slot(B_S)[k] = s[q];
    w.slot(B_UX)[k] = ux[q];
    w.slot(B_VX)[k] = vx[q];
    w.slot(B_TX)[k] = tx[q];
    w.slot(B_SX)[k] = sx[q];
  }
  if (k0 == 0) {
    T* c8 = w.cv + NSC;
    c8[0] = hmixn;
    c8[1] = kmixn;
    c8[2] = rho0;
    c8[3] = cp0;
    c8[4] = comp ? T(1) : T(0);
    c8[5] = reset;
    c8[6] = f_used;
    c8[7] = npass;
  }
}

// ---- the block: stage the columns' inputs, run each column, write the
// ---- outputs back ----------------------------------------------------------
// One warp a column: a block of W warps takes W consecutive columns; in
// COL_LANES each level row of a profile moves as one run of W values, in
// Z_LANES warp j moves its own column's levels, lane k % 32 on level k
// (coalesced in both).  A column over CW warps (MW): a block is one
// column, whose threads stage its rows, level k on thread k % (32 CW).  A
// column over a cluster (CLUSTER): block r stages the levels lo = r LB ..
// of the column's rows, level lo + k on thread k % (32 CW), and every
// block the colscal rows.  In Z_LANES a column's levels are contiguous, so
// the MW and CLUSTER staging reads runs of consecutive values where
// COL_LANES reads one value a level at stride ncol.

template <typename T, int NS, Spread MW> struct Block {
  Grid<T> g;
  T* cols;       // W x warp_stride(NS), or (MW) the column's area
};

template <typename T, int NS, Spread MW>
KPP_DEV Block<T, NS, MW> block_view(const Geometry& G, unsigned char* raw) {
  const int LZ = MW ? 32 * NS * G.cw : 32 * NS;
  T* sm = reinterpret_cast<T*>(raw);
  Block<T, NS, MW> b;
  b.g.zm = sm;
  b.g.hm = sm + LZ;
  b.g.dm = sm + 2 * LZ;
  b.g.tdn = sm + 3 * LZ;
  b.g.tup = sm + 4 * LZ;
  b.g.pfx = sm + 5 * LZ;
  b.g.arefT = sm + 6 * LZ;
  b.g.arefG = nullptr;
  if constexpr (MW == CLUSTER) {   // the column's area, then hi of its LZ
    b.cols = sm;
    b.g.hi = reinterpret_cast<const int*>(sm + NB * LZ + NCV + NBC_CL);
    return b;
  }
  if (MW) {   // aref always, and (grid_dev) the grid rows, in device memory
    b.cols = sm + (G.grid_dev ? 0 : 6) * LZ;
    b.g.hi = reinterpret_cast<const int*>(b.cols + col_stride(LZ));
    return b;
  }
  const bool dev = NS >= AREF_DEV_MIN_NS && G.aref_dev;
  b.cols = sm + (6 + (dev ? 0 : G.kref)) * LZ;
  b.g.hi = reinterpret_cast<const int*>(b.cols + G.warps * warp_stride(NS));
  return b;
}

// This thread's place in the staging loops: column j of the block and
// level rows k0 + 32 q, q < NS (a block has 32 threads per column); MW:
// j = 0 and rows k0 + kstep q, kstep = 32 CW, the block's threads
// (CLUSTER: of the block's slice of the column, block_lo)
struct Stager {
  int j, k0, kstep;
  bool col_ok;
  size_t col;
};

// CLUSTER: the first level of this block's slice of the column: LZ, the
// levels a block holds, times the block's rank in its cluster
KPP_DEV int block_lo(const Geometry& G, int LZ) {
  return LZ * int(blockIdx.x % G.cb);
}

// rows k0 + 32 m (MW: k0 + kstep m) of one input array, through the
// read-only path; ``stride`` is the distance of its rows (COL_LANES:
// ncol) or of its columns (Z_LANES: WZ for a profile, NSC for colscal)
template <Spread MW, Layout L, typename T, int NS>
KPP_DEV void fetch(const Stager& st, const T* src, int rows, int stride,
                   T (&v)[NS]) {
  KPP_FOR_Q {
    const int k = st.k0 + (MW ? st.kstep : 32) * q;
    if constexpr (L == Z_LANES)
      v[q] = (st.col_ok && k < rows) ? __ldg(src + st.col * stride + k)
                                     : T(0);
    else
      v[q] = (st.col_ok && k < rows) ? __ldg(src + size_t(k) * stride
                                             + st.col)
                                     : T(0);
  }
}

template <Spread MW, typename T, int NS>
KPP_DEV void stash(const Stager& st, T* dst, int rows, const T (&v)[NS]) {
  KPP_FOR_Q {
    const int k = st.k0 + (MW ? st.kstep : 32) * q;
    if (st.col_ok && k < rows) dst[k] = v[q];
  }
}

// rows k0 + 32 m (MW: k0 + kstep m) of one output array (``stride`` as
// in fetch: ncol, or WZ for a profile and 8 or 16 for the column outputs)
template <int NS, Spread MW, Layout L, typename T>
KPP_DEV void stage_out(const Stager& st, T* dst, const T* src, int rows,
                       int stride) {
  KPP_FOR_Q {
    const int k = st.k0 + (MW ? st.kstep : 32) * q;
    if constexpr (L == Z_LANES) {
      if (st.col_ok && k < rows) dst[st.col * stride + k] = src[k];
    } else {
      if (st.col_ok && k < rows) dst[size_t(k) * stride + st.col] = src[k];
    }
  }
}

// CLUSTER: load this block's slice of the column's inputs (levels lo ..
// lo + LZ - 1 of each profile into its slots, the colscal rows into the
// column values, as every block does) and its levels' row extents; aref
// and the grid rows are read from device memory
template <typename T, bool STEP, int NS, Layout L>
KPP_DEV Block<T, NS, CLUSTER> load_cluster(const PassParams& P,
                                           const Geometry& G,
                                           const Inputs<T>& in,
                                           unsigned char* raw,
                                           Stager* st_out) {
  const int LZ = 32 * NS * G.cw;
  Block<T, NS, CLUSTER> b = block_view<T, NS, CLUSTER>(G, raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int wz = P.wz, nc = P.ncol, lzc = LZ * G.cb;
  // this block's first level; its slice of every profile starts lo rows
  // down (Z_LANES: lo values into each column); ps: the profiles' stride
  const int lo = block_lo(G, LZ);
  const size_t off = L == Z_LANES ? size_t(lo) : size_t(lo) * nc;
  const int ps = L == Z_LANES ? wz : nc;
  const T* gt = in.grid_t;         // the tile of the column's levels
  b.g.zm = gt;
  b.g.hm = gt + lzc;
  b.g.dm = gt + 2 * lzc;
  b.g.tdn = gt + 3 * lzc;
  b.g.tup = gt + 4 * lzc;
  b.g.pfx = gt + 5 * lzc;
  int* hi = const_cast<int*>(b.g.hi);
  for (int k = tid; k < LZ; k += nt)
    hi[k] = lo + k < wz ? in.ref_hi[lo + k] : -1;
  b.g.hi = hi - lo;                // indexed by the column's level
  b.g.arefG = in.aref_t;
  Stager st;
  st.j = 0;
  st.k0 = tid;
  st.kstep = nt;
  st.col = size_t(blockIdx.x / G.cb);
  st.col_ok = st.col < size_t(nc);
  T* wb = b.cols;
  constexpr int NFIRST = STEP ? 4 : 8, NPROF = NFIRST + 6;
  T v[NPROF][NS], cs[NS];
#pragma unroll
  for (int i = 0; i < NPROF; ++i) {
    const int src = i < NFIRST ? IN_U + i : IN_UO + (i - NFIRST);
    fetch<CLUSTER, L>(st, in.p[src] + off, wz - lo, ps, v[i]);
  }
  fetch<CLUSTER, L>(st, in.p[IN_COLSCAL], NSC, L == Z_LANES ? NSC : nc, cs);
#pragma unroll
  for (int i = 0; i < NPROF; ++i) {
    const int slot = i < NFIRST ? B_U + i : B_UO + (i - NFIRST);
    stash<CLUSTER>(st, wb + slot * LZ, wz - lo, v[i]);
  }
  stash<CLUSTER>(st, wb + NB * LZ, NSC, cs);
  const int fslot[4] = {B_OCNT, B_SAL, B_FCZ, B_SFCZ};
  const bool fon[4] = {bool(P.l_relax_ocnt), bool(P.l_relax_sal),
                       bool(P.l_fcorr_withz), bool(P.l_sfcorr_withz)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!fon[i]) continue;
    fetch<CLUSTER, L>(st, in.p[IN_OCNT + i] + off, wz - lo, ps, v[i]);
    stash<CLUSTER>(st, wb + fslot[i] * LZ, wz - lo, v[i]);
  }
  *st_out = st;
  return b;
}

// Load the grid rows (unless they are read from device memory), aref's
// nonzero columns (likewise) and the block's column inputs
// (profiles into their slots, colscal into the column values).  The loads
// of the profiles every launch stages are all issued before their stores
// to shared memory, so they are in flight together.
template <typename T, bool STEP, int NS, Spread MW, Layout L>
KPP_DEV Block<T, NS, MW> load_block(const PassParams& P, const Geometry& G,
                                    const Inputs<T>& in, unsigned char* raw,
                                    Stager* st_out) {
  if constexpr (MW == CLUSTER)
    return load_cluster<T, STEP, NS, L>(P, G, in, raw, st_out);
  const int LZ = MW ? 32 * NS * G.cw : 32 * NS;
  Block<T, NS, MW> b = block_view<T, NS, MW>(G, raw);
  const int tid = threadIdx.x, nt = blockDim.x, W = MW ? 1 : G.warps;
  const int wz = P.wz, nc = P.ncol;
  T* sm = reinterpret_cast<T*>(raw);
  if (MW && G.grid_dev) {   // the wrapper's tile, padded as below
    const T* gt = in.grid_t;
    b.g.zm = gt;
    b.g.hm = gt + LZ;
    b.g.dm = gt + 2 * LZ;
    b.g.tdn = gt + 3 * LZ;
    b.g.tup = gt + 4 * LZ;
    b.g.pfx = gt + 5 * LZ;
    for (int k = tid; k < LZ; k += nt)
      const_cast<int*>(b.g.hi)[k] = k < wz ? in.ref_hi[k] : -1;
  } else {
    for (int k = tid; k < LZ; k += nt) {
      const bool in_z = k < wz;
      sm[k] = in_z ? in.p[IN_ZM][k] : T(0);
      sm[LZ + k] = in_z ? in.p[IN_HM][k] : T(1);
      sm[2 * LZ + k] = in_z ? in.p[IN_DM][k] : T(0);
      sm[3 * LZ + k] = in_z ? in.p[IN_TDN][k] : T(0);
      sm[4 * LZ + k] = in_z ? in.p[IN_TUP][k] : T(0);
      sm[5 * LZ + k] = (in_z && P.l_advect) ? in.p[IN_PFX][k] : T(0);
      const_cast<int*>(b.g.hi)[k] = in_z ? in.ref_hi[k] : -1;
    }
  }
  if (MW || (NS >= AREF_DEV_MIN_NS && G.aref_dev)) {
    b.g.arefG = in.aref_t;
  } else {
    T* arefT = sm + 6 * LZ;
    for (int i = tid; i < G.kref * LZ; i += nt) {
      const int k = i / LZ, n = i - k * LZ;
      arefT[i] = n < wz ? in.p[IN_AREF][n * wz + k] : T(0);
    }
  }
  Stager st;
  if constexpr (L == Z_LANES && MW == WARP) {   // warp j: its own column
    st.j = tid >> 5;
    st.k0 = tid & 31;
  } else {
    st.j = tid % W;
    st.k0 = tid / W;
  }
  st.kstep = nt;
  st.col = size_t(blockIdx.x) * W + st.j;
  st.col_ok = st.col < size_t(nc);
  T* wb = b.cols + st.j * warp_stride(NS);
  // u..sx (pass) or u0..s0 (step), then uo..so, swdk, swfrac: input i
  // goes to slot i, and slots 0..13 match IN_U..IN_SWFRAC
  constexpr int NFIRST = STEP ? 4 : 8, NPROF = NFIRST + 6;
  T v[NPROF][NS], cs[NS];
#pragma unroll
  for (int i = 0; i < NPROF; ++i) {
    const int src = i < NFIRST ? IN_U + i : IN_UO + (i - NFIRST);
    fetch<MW, L>(st, in.p[src], wz, L == Z_LANES ? wz : nc, v[i]);
  }
  fetch<MW, L>(st, in.p[IN_COLSCAL], NSC, L == Z_LANES ? NSC : nc, cs);
#pragma unroll
  for (int i = 0; i < NPROF; ++i) {
    const int slot = i < NFIRST ? B_U + i : B_UO + (i - NFIRST);
    stash<MW>(st, wb + slot * LZ, wz, v[i]);
  }
  stash<MW>(st, wb + NB * LZ, NSC, cs);
  // forcing profiles only under their flags (else the inputs are dummies)
  const int fslot[4] = {B_OCNT, B_SAL, B_FCZ, B_SFCZ};
  const bool fon[4] = {bool(P.l_relax_ocnt), bool(P.l_relax_sal),
                       bool(P.l_fcorr_withz), bool(P.l_sfcorr_withz)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!fon[i]) continue;
    fetch<MW, L>(st, in.p[IN_OCNT + i], wz, L == Z_LANES ? wz : nc, v[i]);
    stash<MW>(st, wb + fslot[i] * LZ, wz, v[i]);
  }
  *st_out = st;
  return b;
}

// the column of warp wi (MW: the block's column, whose warp wi holds
// levels 128 wi .. 128 wi + 127)
template <typename T, int NS, Spread MW>
KPP_DEV Col<T, NS, MW> col_of(const Block<T, NS, MW>& b, const Geometry& G,
                              int wi, int lane) {
  const int LZ = MW ? 32 * NS * G.cw : 32 * NS;
  Col<T, NS, MW> w;
  w.b = MW ? b.cols : b.cols + wi * warp_stride(NS);
  w.cv = w.b + NB * LZ;
  w.lane = lane;
  if constexpr (MW == CLUSTER) {   // block r holds levels r LZ ..
    w.k0 = block_lo(G, LZ) + 32 * NS * wi + lane;
    w.lzc = LZ * G.cb;
    w.lb = LZ;
    w.cb = G.cb;
    w.mg = unsigned((0x100000000ull + LZ - 1) / LZ);
  } else if constexpr (MW) {   // (one warp: lev0() is the lane itself)
    w.k0 = 32 * NS * wi + lane;
    w.lzc = LZ;
  }
  return w;
}

// does warp wi of this block have a column (MW: the block's; CLUSTER:
// the cluster's)
template <Spread MW>
KPP_DEV bool has_column(const PassParams& P, const Geometry& G, int wi) {
  if constexpr (MW == CLUSTER)
    return size_t(blockIdx.x / G.cb) < size_t(P.ncol);
  return MW ? size_t(blockIdx.x) < size_t(P.ncol)
            : size_t(blockIdx.x) * G.warps + wi < size_t(P.ncol);
}

// CLUSTER: write this block's levels lo.. of the outputs (the full
// pass's, or the fast pass's and the step's 8), and from block 0 (lo =
// 0) the column values
template <typename T, bool FULL, int NS, Layout L>
KPP_DEV void store_cluster(const PassParams& P, const Geometry& G,
                           const Stager& st, const Block<T, NS, CLUSTER>& b,
                           const Outputs<T>& out) {
  const int LZ = 32 * NS * G.cw, lo = block_lo(G, LZ);
  const int wz = P.wz - lo, nc = P.ncol, ncv = lo ? 0 : FULL ? 16 : 8;
  const size_t off = L == Z_LANES ? size_t(lo) : size_t(lo) * nc;
  // the profiles' and the column outputs' strides
  const int ps = L == Z_LANES ? P.wz : nc;
  const int cvs = L == Z_LANES ? (FULL ? 16 : 8) : nc;
  const T* wb = b.cols;
  if (FULL) {
#pragma unroll
    for (int i = 0; i < 4 + N_FO; ++i) {
      if (i == 4 + FO_COLOUT)
        stage_out<NS, CLUSTER, L>(st, out.p[i], wb + NB * LZ + NSC, ncv,
                                  cvs);
      else
        stage_out<NS, CLUSTER, L>(st, out.p[i] + off,
                                  wb + full_slot(i) * LZ, wz, ps);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      stage_out<NS, CLUSTER, L>(st, out.p[i] + off, wb + (B_U + i) * LZ, wz,
                                ps);
    stage_out<NS, CLUSTER, L>(st, out.p[8], wb + NB * LZ + NSC, ncv, cvs);
  }
}

// fused pass over one block of columns (the body of fused_pass_kernel)
template <typename T, bool FULL, int NS, Spread MW, Layout L = COL_LANES>
KPP_DEV void pass_block(const PassParams& P, const Geometry& G,
                        const Inputs<T>& in, const Outputs<T>& out,
                        unsigned char* raw) {
  const int LZ = MW ? 32 * NS * G.cw : 32 * NS;
  KPP_CLOCK(kpp_b0);
  Stager st;
  const Block<T, NS, MW> b = load_block<T, false, NS, MW, L>(P, G, in, raw,
                                                             &st);
  if constexpr (MW == CLUSTER)
    cl_sync();
  else
    __syncthreads();
  KPP_BMARK(10);   // staging in
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (has_column<MW>(P, G, wi)) {
    const Col<T, NS, MW> w = col_of(b, G, wi, lane);
    const int k0 = MW ? w.k0 : lane;
    T u[NS], v[NS], t[NS], s[NS], ux[NS], vx[NS], tx[NS], sx[NS];
    KPP_FOR_Q {
      const int k = k0 + 32 * q;
      u[q] = w.slot(B_U)[k];
      v[q] = w.slot(B_V)[k];
      t[q] = w.slot(B_T)[k];
      s[q] = w.slot(B_S)[k];
      ux[q] = w.slot(B_UX)[k];
      vx[q] = w.slot(B_VX)[k];
      tx[q] = w.slot(B_TX)[k];
      sx[q] = w.slot(B_SX)[k];
    }
    ColOut<T> co;
    pass_warp<T, FULL>(P, b.g, w, u, v, t, s, ux, vx, tx, sx, w.cv[CS_F], &co);
    if (!FULL) {
      KPP_FOR_Q {
        const int k = k0 + 32 * q;
        w.slot(B_U)[k] = u[q];
        w.slot(B_V)[k] = v[q];
        w.slot(B_T)[k] = t[q];
        w.slot(B_S)[k] = s[q];
        w.slot(B_UX)[k] = ux[q];
        w.slot(B_VX)[k] = vx[q];
        w.slot(B_TX)[k] = tx[q];
        w.slot(B_SX)[k] = sx[q];
      }
      if (k0 == 0) {
        T* c8 = w.cv + NSC;
        c8[0] = co.hbl;
        c8[1] = co.kbl;
        c8[2] = co.rho0;
        c8[3] = co.cp0;
        c8[4] = c8[5] = c8[6] = c8[7] = T(0);
      }
    }
  }
  KPP_BMARK(11);   // the warp's column
  if constexpr (MW == CLUSTER)
    cl_sync();    // past it no block reads another's shared memory
  else
    __syncthreads();
  KPP_BMARK(12);   // waiting for the block's slowest warp
  if constexpr (MW == CLUSTER) {
    store_cluster<T, FULL, NS, L>(P, G, st, b, out);
  } else {
  const int wz = P.wz, nc = P.ncol;
  const T* wb = b.cols + st.j * warp_stride(NS);
  if (FULL) {
#pragma unroll
    for (int i = 0; i < 4 + N_FO; ++i) {
      if (i == 4 + FO_COLOUT)
        stage_out<NS, MW, L>(st, out.p[i], wb + NB * LZ + NSC, 16,
                             L == Z_LANES ? 16 : nc);
      else
        stage_out<NS, MW, L>(st, out.p[i], wb + full_slot(i) * LZ, wz,
                             L == Z_LANES ? wz : nc);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      stage_out<NS, MW, L>(st, out.p[i], wb + (B_U + i) * LZ, wz,
                           L == Z_LANES ? wz : nc);
    stage_out<NS, MW, L>(st, out.p[8], wb + NB * LZ + NSC, 8,
                         L == Z_LANES ? 8 : nc);
  }
  }
  KPP_BMARK(13);   // write-back
}

// whole step over one block of columns (the body of fused_step_kernel)
template <typename T, int NS, Spread MW, Layout L = COL_LANES>
KPP_DEV void step_block(const PassParams& P, const Geometry& G,
                        const Inputs<T>& in, const Outputs<T>& out,
                        unsigned char* raw) {
  const int LZ = MW ? 32 * NS * G.cw : 32 * NS;
  KPP_CLOCK(kpp_b0);
  Stager st;
  const Block<T, NS, MW> b = load_block<T, true, NS, MW, L>(P, G, in, raw,
                                                            &st);
  if constexpr (MW == CLUSTER)
    cl_sync();
  else
    __syncthreads();
  KPP_BMARK(10);   // staging in
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a land column's warp (MW: block) goes straight to the write-back
  // (step_warp skips its loops); a warp past ncol has no column
  if (has_column<MW>(P, G, wi))
    step_warp<T, NS>(P, b.g, col_of(b, G, wi, lane));
  KPP_BMARK(11);   // the warp's column
  if constexpr (MW == CLUSTER)
    cl_sync();    // past it no block reads another's shared memory
  else
    __syncthreads();
  KPP_BMARK(12);   // waiting for the block's slowest warp
  if constexpr (MW == CLUSTER) {
    store_cluster<T, false, NS, L>(P, G, st, b, out);
  } else {
  const int wz = P.wz, nc = P.ncol;
  const T* wb = b.cols + st.j * warp_stride(NS);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    stage_out<NS, MW, L>(st, out.p[i], wb + (B_U + i) * LZ, wz,
                         L == Z_LANES ? wz : nc);
  stage_out<NS, MW, L>(st, out.p[8], wb + NB * LZ + NSC, 8,
                       L == Z_LANES ? 8 : nc);
  }
  KPP_BMARK(13);   // write-back
}

}  // namespace kpp
