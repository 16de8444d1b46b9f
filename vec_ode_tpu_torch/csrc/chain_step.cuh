// The chain-exponential step of one tile of trajectories of a modulated
// operator A(t) = sum_k c_k(t) M_k, as a device function that every thread
// of a block calls together. Shared by the per-step kernel
// (chain_expmv.cu, K4) and the whole-loop kernel (fused_loop.cu, whose
// chain step this is: the counterpart of
// vec_ode_tpu/ops/pallas_loop.py:make_chain_step_builder, K5).
//
// It computes what vec_ode_tpu/ops/pallas_expmv.py:_make_kernel and
// make_chain_step_builder's step compute: C <= 2 chains of R <= MAX_R
// sequential exponentials, y_c = e^{A_{c,R-1}} ... e^{A_{c,0}} x, in this
// order:
//   1. the coefficient rows of the declared recipe from the node samples
//      g (J, tile, K0) and dt (ops/expmv.py:chain_rows): midpoint dt g;
//      Magnus-4 w1_k = (dt/2)(g1_k + g2_k), w2_jk = (b2 dt dt)(g1_j g2_k -
//      g1_k g2_j) over the pairs j < k (ops/expmv.py:pairs_of order),
//      chain 0 = [w1, w2] and, for C = 2, chain 1 = [w1, 0];
//      Magnus-6 the Magnus-4 rows of the three Yoshida sub-intervals over
//      (ln_i dt), and for C = 2 chain 1 = [the full interval's row,
//      identity, identity]; CFM dt sum_j alpha_ij g_j (zero alphas left
//      out, j in order) and for C = 2 the alpha_err rows, padded with zero
//      rows. Zero columns and zero rows are still run (a NaN state still
//      gives a NaN error and a reject); the declared identity rows are
//      skipped;
//   2. the scaling: per trajectory, chain and row the bound
//      sum_k |c_k| ||M_k||_1 gives the least s >= 0 with bound/theta <= 2^s
//      (at most max_sq; s = 0 for a non-finite bound), and the row is
//      divided by 2^s (ops/expmv.py:scale_rows);
//   3. per chain, its rows in order, each 2^s passes of the degree-m
//      Taylor polynomial on the running state: each term is one
//      (rows, D) @ (D, KP*D) product with MT = [M_0^T | ... |
//      M_{KP-1}^T], the KP actions combined with the row's coefficients in
//      k order and divided by the term's index. Within a row, trajectories
//      that have finished their passes are masked while the block runs to
//      its largest count; row r + 1 starts when the whole block has
//      finished row r;
//   4. the error: chain1 - chain0, or for magnus4_fast
//      sum_{k >= K0} w2_k (M_k y) on the advanced state; measured as
//      numerics.cuh's ErrNorm (scaled_error, weight row, l2 or max, post).
// A row whose dt is 0 runs one pass with zero coefficients per exponential
// and returns x exactly.
//
// Basis terms: 1 to MAX_K0 = 8 (K' <= 36 working terms with the Magnus
// commutators), one product body for every K': per basis term one (RM, CN)
// product tile term @ M_k^T (gemm_tile.cuh: tile_fma, or tile_fma_n for
// up to four terms side by side from a resident basis), folded at once
// into w = cs_0 y_0, w = w + cs_k y_k in k order (mul_rn, add_rn), then
// divided by the term's index. Each output element is one FMA chain from
// zero in j order in one thread, so the bits do not depend on the launch
// shape: K4's tiled route, K4's cluster route and the loop kernel's K5
// all run this body and give the same results.
//
// Layout. A block owns a tile of rows and the columns [c0, c0 + dc) of
// them: all D columns, or on K4's cluster route (CLUSTER) the block's
// slice of a tile that a cluster of N blocks shares. Each thread owns RM
// rows x CN contiguous columns of that slice and keeps them of the
// chain's running sum in registers across the chain's exponentials. The
// Taylor term of the whole tile lives in shared memory transposed, (D,
// tile), so that a thread's rows at one contraction index are one load;
// the basis columns the block needs come through a PanelRing (resident
// when they fit, else streamed from L2 by cp.async). A new term is
// published into the block's term buffer, on the cluster route into every
// block's copy through distributed shared memory, with one barrier (a
// cluster barrier) before it is read; two term buffers alternate where no
// ring barrier separates the reads of one term from the writes of the
// next. x and x_out are (rows, D) in device memory (K4) or shared memory
// (K5); the node samples, the per-row coefficients and pass counts of
// every (chain, exponential) are in shared memory, the same in every block
// of a cluster.
//
// Precision. Products accumulate by IEEE FMA in the state's type, never
// TF32. The nodes, the recipe's coefficient arithmetic, the bound, the
// weighted sum of the KP actions and the scaled_error denominator are
// written with explicitly rounded operations (no contraction), in the
// plain twin's order, the Python constants folded in f64 by the wrapper
// and rounded once here; the pass count comes from frexp, exactly. Build
// without --use_fast_math.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "gemm_tile.cuh"

namespace vec_ode {

constexpr int MAX_K0 = 8;     // basis terms (ops/expmv.py: MAX_K0)
constexpr int MAX_KP = 36;    // working terms: K0 + K0 (K0 - 1) / 2
constexpr int MAX_R = 4;      // exponentials per chain (ops/expmv.py: MAX_R)
constexpr int MAX_NODES = 8;  // quadrature nodes per step (ops/expmv.py: MAX_NODES)
constexpr int RECIPE_MIDPOINT = 0, RECIPE_MAGNUS4 = 1, RECIPE_MAGNUS4_FAST = 2,
              RECIPE_MAGNUS6 = 3, RECIPE_CFM = 4;
// the parameter array of ops/expmv.py:chain_params: a 16-value header, then
// fixed-size blocks at these offsets
constexpr int P_NORMS = 16, P_SUB = P_NORMS + MAX_KP, P_NODES = P_SUB + 9,
              P_ALPHA = P_NODES + MAX_NODES, P_ALPHA_ERR = P_ALPHA + MAX_R * MAX_NODES,
              P_FORM = P_ALPHA_ERR + MAX_R * MAX_NODES;

__device__ __forceinline__ float frexp_full(float a, int* e) { return frexpf(a, e); }
__device__ __forceinline__ double frexp_full(double a, int* e) { return frexp(a, e); }

template <typename T>
struct ChainParams {
  int K0, KP, recipe, C, R, J, m, max_sq, n_err;
  int form_kind, cheb_n;          // FORM_COEFF or FORM_CHEB; the series' length
  T theta;
  T c_mid, b2;                    // ops/expmv.py: _C_MID, _B2 in the state's type
  T cheb_mid, cheb_inv;           // ChebForm: lo + hi and 1 / (hi - lo), folded in f64
  T norms[MAX_KP];                // ||M_k||_1
  T sub[3][3];                    // Magnus-6 sub-interval i: off + ln/2, c_mid ln, ln
  T nodes[MAX_NODES];             // CFM: c_j
  T alpha[MAX_R][MAX_NODES];      // CFM: the main chain's rows
  T alpha_err[MAX_R][MAX_NODES];  // CFM: the comparison chain's n_err rows
  T form[MAX_K0][4];              // c_k(t) = a + b t + c cos(w t): a, b, c, w (loop kernel)
  const T* cheb;                  // ChebForm: (K0, cheb_n) in device memory (loop kernel)
};

// Parses the float64 parameter array of ops/expmv.py:chain_params (its
// _P_* offsets); the Chebyshev table's device pointer is set by the caller.
template <typename T>
ChainParams<T> parse_chain_params(const double* c) {
  ChainParams<T> p{};
  p.K0 = (int)c[0], p.KP = (int)c[1], p.recipe = (int)c[2], p.C = (int)c[3];
  p.R = (int)c[4], p.J = (int)c[5], p.m = (int)c[6], p.max_sq = (int)c[7];
  p.theta = (T)c[8], p.c_mid = (T)c[9], p.b2 = (T)c[10], p.n_err = (int)c[11];
  p.form_kind = (int)c[12], p.cheb_n = (int)c[13], p.cheb_mid = (T)c[14], p.cheb_inv = (T)c[15];
  for (int k = 0; k < MAX_KP; ++k) p.norms[k] = (T)c[P_NORMS + k];
  for (int i = 0; i < 3; ++i)
    for (int f = 0; f < 3; ++f) p.sub[i][f] = (T)c[P_SUB + 3 * i + f];
  for (int j = 0; j < MAX_NODES; ++j) p.nodes[j] = (T)c[P_NODES + j];
  for (int i = 0; i < MAX_R; ++i)
    for (int j = 0; j < MAX_NODES; ++j) {
      p.alpha[i][j] = (T)c[P_ALPHA + MAX_NODES * i + j];
      p.alpha_err[i][j] = (T)c[P_ALPHA_ERR + MAX_NODES * i + j];
    }
  for (int k = 0; k < MAX_K0; ++k)
    for (int f = 0; f < 4; ++f) p.form[k][f] = (T)c[P_FORM + 4 * k + f];
  p.cheb = nullptr;
  return p;
}

// Whether the parameters are ones the kernels take (the wrapper checks
// them first).
template <typename T>
bool chain_params_ok(const ChainParams<T>& p) {
  const bool plain = p.recipe == RECIPE_MIDPOINT || p.recipe == RECIPE_CFM;
  const int kp = plain ? p.K0 : p.K0 + p.K0 * (p.K0 - 1) / 2;
  bool shape = false;
  switch (p.recipe) {
    case RECIPE_MIDPOINT: shape = p.C == 1 && p.R == 1 && p.J == 1; break;
    case RECIPE_MAGNUS4: shape = (p.C == 1 || p.C == 2) && p.R == 1 && p.J == 2; break;
    case RECIPE_MAGNUS4_FAST: shape = p.C == 1 && p.R == 1 && p.J == 2; break;
    case RECIPE_MAGNUS6:
      shape = (p.C == 1 || p.C == 2) && p.R == 3 && p.J == (p.C == 2 ? 8 : 6);
      break;
    case RECIPE_CFM:
      shape = p.R >= 1 && p.R <= MAX_R && p.J >= 1 && p.J <= MAX_NODES &&
              ((p.C == 1 && p.n_err == 0) || (p.C == 2 && p.n_err >= 1 && p.n_err <= p.R));
      break;
    default: break;
  }
  const bool form = p.form_kind == FORM_COEFF || (p.form_kind == FORM_CHEB && p.cheb_n >= 1);
  return shape && form && p.K0 >= 1 && p.K0 <= MAX_K0 && p.KP == kp && p.m >= 1 &&
         p.max_sq >= 0 && p.max_sq <= 30;
}

// The declared identity rows, which the step skips (ops/expmv.py:
// identity_rows): the Magnus-6 comparison chain's rows 1 and 2.
template <typename T>
__host__ __device__ __forceinline__ bool identity_row(const ChainParams<T>& p, int c, int r) {
  return p.recipe == RECIPE_MAGNUS6 && c == 1 && r >= 1;
}

// Rows per block of the loop kernel's chain step: the largest power of two
// up to 256 whose threads ((tile / rm) x ceil(D / 4), and one per row)
// stay within max_threads, whose (tile, D) slots (x, y, the Taylor term)
// take at most 96 KB and whose whole shared memory smem_of(tile) fits the
// device's max_smem, halved further while the batch gives fewer than two
// blocks per SM, down to 16 rows. The rows' results do not depend on it.
template <typename T, class SmemOf>
inline int chain_tile(int B, int D, int n_sm, int rm, int max_threads, size_t max_smem,
                      SmemOf smem_of) {
  const int ncg = gemm_dp(D) / GEMM_CN;
  int tile = 256;
  while (tile > rm && (tile > max_threads || (tile / rm) * ncg > max_threads ||
                       3 * (size_t)tile * D * sizeof(T) > 96 * 1024 ||
                       smem_of(tile) > max_smem))
    tile /= 2;
  while (tile > 16 && (B + tile - 1) / tile < 2 * n_sm) tile /= 2;
  return tile;
}

// The step's scratch in shared memory, byte offsets of each region (each
// 16-byte aligned), in this order: the Taylor term transposed (D, tile),
// twice where the term alternates between two buffers (nbuf; the first
// buffer then takes the error vector (tile, D)); the basis (PanelRing:
// ring_bytes); the scaled rows (C R, tile, K'); the unscaled rows (tile,
// K'), magnus4_fast only (the others build each row in place in its scaled
// slot); the node samples (J, tile, K0); dt (tile), where the launcher
// keeps it here; the pass counts (C R, tile). ops/expmv.py:chain_smem_bytes
// mirrors it.
template <typename T>
struct ChainLayout {
  size_t term, ring, cs, rows, g, dt, npass, total;
  int nbuf;
  __host__ __device__ ChainLayout(int tile, int D, int dc, const ChainParams<T>& p, bool cluster,
                                  bool with_dt) {
    const size_t nr = (size_t)p.C * p.R, kp = (size_t)p.KP;
    nbuf = cluster || ring_resident<T>(D, p.KP, dc) ? 2 : 1;
    size_t at = 0;
    term = at, at += align16((size_t)nbuf * D * tile * sizeof(T));
    ring = at, at += align16(ring_bytes<T>(D, p.KP, dc));
    cs = at, at += align16(nr * tile * kp * sizeof(T));
    rows = cs;
    if (p.recipe == RECIPE_MAGNUS4_FAST) rows = at, at += align16((size_t)tile * kp * sizeof(T));
    g = at, at += align16((size_t)p.J * tile * p.K0 * sizeof(T));
    dt = at;
    if (with_dt) at += align16((size_t)tile * sizeof(T));
    npass = at, at += align16(nr * tile * sizeof(int));
    total = at;
  }
};

// The regions of a ChainLayout at `base`.
template <typename T>
struct ChainSmem {
  T* term;     // nbuf x (D, tile): the Taylor term, transposed
  T* g;        // (J, tile, K0): the coefficients at the nodes
  T* rows;     // (C R, tile, K'): the unscaled rows (magnus4_fast), else cs
  T* cs;       // (C R, tile, K'): the scaled rows
  T* ring;     // the basis (PanelRing)
  T* dt;       // (tile): dt, where the launcher keeps it here
  int* npass;  // (C R, tile): 2^s per row, 0 for rows past the batch
  int nbuf;

  __device__ ChainSmem(unsigned char* base, const ChainLayout<T>& L)
      : term(reinterpret_cast<T*>(base + L.term)),
        g(reinterpret_cast<T*>(base + L.g)),
        rows(reinterpret_cast<T*>(base + L.rows)),
        cs(reinterpret_cast<T*>(base + L.cs)),
        ring(reinterpret_cast<T*>(base + L.ring)),
        dt(reinterpret_cast<T*>(base + L.dt)),
        npass(reinterpret_cast<int*>(base + L.npass)),
        nbuf(L.nbuf) {}
};

// Node nd of a step from t over dt (ops/expmv.py:node_times): tm = t + dt/2
// (midpoint); tm -/+ c_mid dt (Magnus-4, and Magnus-6's nodes 6 and 7);
// Magnus-6's sub-interval i = nd / 2: tm_i -/+ (c_mid ln_i) dt with
// tm_i = t + (off_i + ln_i / 2) dt; CFM t + c_j dt.
template <typename T>
__device__ __forceinline__ T node_time(const ChainParams<T>& p, int nd, T t, T dt) {
  if (p.recipe == RECIPE_CFM) return add_rn(t, mul_rn(p.nodes[nd], dt));
  if (p.recipe == RECIPE_MAGNUS6 && nd < 6) {
    const int i = nd / 2;
    const T tm = add_rn(t, mul_rn(p.sub[i][0], dt));
    const T off = mul_rn(p.sub[i][1], dt);
    return nd % 2 == 0 ? sub_rn(tm, off) : add_rn(tm, off);
  }
  const T tm = add_rn(t, mul_rn(T(0.5), dt));
  if (p.recipe == RECIPE_MIDPOINT) return tm;
  const T off = mul_rn(p.c_mid, dt);
  return nd % 2 == 0 ? sub_rn(tm, off) : add_rn(tm, off);
}

// c_k(t), k < K0, of the declared Chebyshev form (ops/forms.py:
// ChebForm.sample) into out[k]: numerics.cuh's cheb_series of each term at
// u = cheb_arg(t).
template <typename T>
__device__ __forceinline__ void cheb_at(const ChainParams<T>& p, T t, T* out) {
  const T u = cheb_arg(t, p.cheb_mid, p.cheb_inv);
  for (int k = 0; k < p.K0; ++k) out[k] = cheb_series(p.cheb + (size_t)k * p.cheb_n, p.cheb_n, u);
}

// Fills sm.g with the declared form (a CoeffForm or a ChebForm, by
// p.form_kind) at the recipe's J nodes of each row. One thread per row;
// the caller synchronises before the step reads it.
template <typename T>
__device__ void sample_form(const T* __restrict__ t_rows, const T* __restrict__ dt_rows,
                            const ChainSmem<T>& sm, int tile, const ChainParams<T>& p) {
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    const T t = t_rows[lr], dt = dt_rows[lr];
    for (int nd = 0; nd < p.J; ++nd) {
      const T tn = node_time(p, nd, t, dt);
      T* g = sm.g + ((size_t)nd * tile + lr) * p.K0;
      if (p.form_kind == FORM_CHEB)
        cheb_at(p, tn, g);
      else
        for (int k = 0; k < p.K0; ++k) g[k] = form_at(p.form[k], tn);
    }
  }
}

// 2^s for a row's 1-norm bound: the least s >= 0 with bound / theta <= 2^s,
// at most max_sq, s = 0 for a non-finite bound (ops/expmv.py:scale_rows),
// found exactly with frexp.
template <typename T>
__device__ __forceinline__ int pass_count(T bound, const ChainParams<T>& p) {
  const T ratio = bound / p.theta;
  int s = 0;
  if (isfinite(bound) && ratio > T(1)) {
    int e = 0;
    const T mant = frexp_full(ratio, &e);
    s = e - (mant == T(0.5) ? 1 : 0);
    s = s < 0 ? 0 : (s > p.max_sq ? p.max_sq : s);
  }
  return 1 << s;
}

// The Magnus-4 row [w1, w2] over the node samples ga, gb and the step dts:
// w1_k = (dts/2)(ga_k + gb_k), then w2_jk = (b2 dts dts)(ga_j gb_k - ga_k
// gb_j) over every commutator pair in ops/expmv.py:pairs_of order ((0, 1),
// (0, 2), ..., (1, 2), ...); for K0 = 1 no pair.
template <typename T>
__device__ __forceinline__ void m4_row(const T* ga, const T* gb, T dts, T b2, int K0, T* row) {
  const T hdt = mul_rn(T(0.5), dts);
#pragma unroll
  for (int k = 0; k < K0; ++k) row[k] = mul_rn(hdt, add_rn(ga[k], gb[k]));
  const T bdd = mul_rn(mul_rn(b2, dts), dts);
  int at = K0;
#pragma unroll
  for (int j = 0; j < K0; ++j)
#pragma unroll
    for (int k = j + 1; k < K0; ++k)
      row[at++] = mul_rn(bdd, sub_rn(mul_rn(ga[j], gb[k]), mul_rn(ga[k], gb[j])));
}


// Row r of chain c of trajectory lr into row[0 .. K'), unscaled (zero where
// the recipe has a zero row); g holds the node samples (J, tile, K0), dt
// the row's step.
template <typename T>
__device__ __forceinline__ void chain_row(const ChainParams<T>& p, int c, int r, const T* g,
                                          int tile, int lr, T dt, T* row) {
  const int KP = p.KP, K0 = p.K0;
  for (int k = 0; k < KP; ++k) row[k] = T(0);
  const T* g0 = g + (size_t)lr * K0;  // node nd at g0 + nd * gs
  const size_t gs = (size_t)tile * K0;
  switch (p.recipe) {
    case RECIPE_MIDPOINT:
      for (int k = 0; k < KP; ++k) row[k] = mul_rn(dt, g0[k]);
      break;
    case RECIPE_CFM: {
      if (c == 1 && r >= p.n_err) break;  // a zero pad row
      const T* a = c == 0 ? p.alpha[r] : p.alpha_err[r];
      for (int k = 0; k < KP; ++k) {
        T acc = T(0);
        bool any = false;
        for (int j = 0; j < p.J; ++j) {
          if (a[j] == T(0)) continue;
          const T term = mul_rn(a[j], g0[j * gs + k]);
          acc = any ? add_rn(acc, term) : term;
          any = true;
        }
        row[k] = any ? mul_rn(dt, acc) : T(0);
      }
      break;
    }
    case RECIPE_MAGNUS6:
      if (c == 0)
        m4_row(g0 + 2 * r * gs, g0 + (2 * r + 1) * gs, mul_rn(p.sub[r][2], dt), p.b2, K0, row);
      else if (r == 0)
        m4_row(g0 + 6 * gs, g0 + 7 * gs, dt, p.b2, K0, row);
      break;
    default:  // Magnus-4; its comparison chain has zero commutator columns
      m4_row(g0, g0 + gs, dt, p.b2, K0, row);
      if (c == 1)
        for (int k = K0; k < KP; ++k) row[k] = T(0);
  }
}

// Steps 1-2 of the note, one thread per trajectory: every (chain,
// exponential) row, built in place in its sm.rows slot, its bound sum_k
// |c_k| ||M_k||_1, its pass count into sm.npass and, divided by the
// count, the row into sm.cs (the same slot but for magnus4_fast); rows
// past `rows` are zero and run no pass. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void chain_rows_setup(const T* __restrict__ dt_rows,
                                                 const ChainSmem<T>& sm, int rows, int tile,
                                                 const ChainParams<T>& p) {
  const int kp = p.KP;
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    const bool ok = lr < rows;
    const T dt = ok ? dt_rows[lr] : T(0);
    for (int c = 0; c < p.C; ++c)
      for (int r = 0; r < p.R; ++r) {
        const size_t cr = (size_t)c * p.R + r;
        // magnus4_fast (C = R = 1) keeps its one unscaled row apart
        T* row = sm.rows + (cr * tile + lr) * kp;
        chain_row(p, c, r, sm.g, tile, lr, dt, row);
        T bound = T(0);
        for (int k = 0; k < kp; ++k) {
          if (!ok) row[k] = T(0);
          const T term = mul_rn(fabs(row[k]), p.norms[k]);
          bound = k == 0 ? term : add_rn(bound, term);
        }
        const int n_pass = pass_count(bound, p);
        const T scale = T(1) / T(n_pass);  // exact
        for (int k = 0; k < kp; ++k) sm.cs[(cr * tile + lr) * kp + k] = row[k] * scale;
        sm.npass[cr * tile + lr] = ok && !identity_row(p, c, r) ? n_pass : 0;
      }
  }
  __syncthreads();
}

// One chain step of a tile (see the note above); every thread of the block
// (every block of the cluster, CLUSTER) calls it. Before the call sm.g
// holds the node samples of rows < `rows` and dt_rows is written; x (rows,
// D) is read and x_out (rows, D) written, both row-major with rows of D,
// in device or shared memory; err_out (rows,) gets the error measure, zero
// without an error estimate (by the cluster's first block only). The block
// owns columns [c0, c0 + dc) and needs (tile / RM) * ceil(dc / CN) threads
// or more; on the cluster route every block of the cluster runs the same
// rows. ring streams or holds the basis columns the block needs, and the
// step leaves it at the start of a term (the loop kernel's next step goes
// on with it).
template <typename T, int RM, int CN, bool CLUSTER>
__device__ void chain_step_tile(const T* __restrict__ dt_rows, const T* x, T* x_out,
                                T* __restrict__ err_out, const ChainSmem<T>& sm,
                                PanelRing<T>& ring, int rows, int tile, int D, int c0, int dc,
                                const ChainParams<T>& p, const ErrNorm<T>& en) {
  namespace cg = cooperative_groups;
  const int ncl = (dc + CN - 1) / CN;  // the block's column groups
  const int tid = threadIdx.x;
  const bool active = tid < (tile / RM) * ncl;
  const int col0 = c0 + (tid % ncl) * CN, lr0 = (tid / ncl) * RM;
  const int cend = c0 + dc;
  const int kp = p.KP, K0 = p.K0, C = p.C, R = p.R;
  const bool fast = p.recipe == RECIPE_MAGNUS4_FAST;
  const bool dbl = sm.nbuf == 2;
  const size_t tsz = (size_t)D * tile;
  int nblk = 1, rank = 0;
  if constexpr (CLUSTER) {
    nblk = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }

  // a barrier of every thread that reads what the others wrote
  auto xsync = [&]() {
    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };

  // 1-2. the rows, their bounds and pass counts (the same in every block)
  chain_rows_setup(dt_rows, sm, rows, tile, p);
  if constexpr (CLUSTER) xsync();  // every block of the cluster has started

  // v into term buffer b of the block (of every block of the cluster)
  auto publish = [&](const T (&v)[RM][CN], int b) {
    if (!active) return;
    for (int blk = 0; blk < nblk; ++blk) {
      T* dst = sm.term + b * tsz;
      if constexpr (CLUSTER) dst = cg::this_cluster().map_shared_rank(dst, blk);
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int k = 0; k < CN; ++k)
          if (col0 + k < cend) dst[(size_t)(col0 + k) * tile + lr0 + q] = v[q][k];
    }
  };
  // a new term: with one buffer once every read of the old one is done,
  // read after the next ring barrier; with two into the other buffer,
  // then the barrier
  int cur = 0;
  auto put_term = [&](const T (&v)[RM][CN]) {
    if (dbl) {
      publish(v, cur ^ 1);
      xsync();
      cur ^= 1;
    } else {
      __syncthreads();
      publish(v, cur);
    }
  };

  // the products of one Taylor term: y_b = term @ M_b^T panel by panel,
  // folded at once into w in b order (b from b0; cf the row's
  // coefficients); w = 0 where no b >= b0. Streamed, every thread takes
  // every panel of the stream; resident, a microtile of fewer than 8
  // outputs (the cluster route's) runs KB basis terms' chains side by side
  // and folds them in order.
  T acc[RM][CN], w[RM][CN];
  auto fold = [&](int b, int b0, const T* cf, const T (&yv)[RM][CN]) {
#pragma unroll
    for (int q = 0; q < RM; ++q) {
      const T cq = cf[(size_t)(lr0 + q) * kp + b];
#pragma unroll
      for (int k = 0; k < CN; ++k) {
        const T part = mul_rn(cq, yv[q][k]);
        w[q][k] = b == b0 ? part : add_rn(w[q][k], part);
      }
    }
  };
  constexpr int KB = RM * CN < 8 ? 4 : 1;
  auto block = [&](auto nb, int b, int b0, const T* cf) {
    constexpr int N = decltype(nb)::value;
    if (!active || b + N <= b0) return;
    T yv[N][RM][CN];
#pragma unroll
    for (int n = 0; n < N; ++n) tile_zero<T, RM, CN>(yv[n]);
    tile_fma_n<T, RM, CN, N>(sm.term + cur * tsz + lr0, tile, ring.panel(b) + (col0 - c0),
                             ring.stage, ring.DP, D, yv);
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (b + n >= b0) fold(b + n, b0, cf, yv[n]);
  };
  auto products = [&](int b0, const T* cf) {
    tile_zero<T, RM, CN>(w);
    if (ring.resident) {
      int b = 0;
      for (; b + KB <= kp; b += KB) block(std::integral_constant<int, KB>{}, b, b0, cf);
      if constexpr (KB > 1) {
        const int left = kp - b;
        if (left == 1) block(std::integral_constant<int, 1>{}, b, b0, cf);
        if (left == 2) block(std::integral_constant<int, 2>{}, b, b0, cf);
        if (left == 3) block(std::integral_constant<int, 3>{}, b, b0, cf);
      }
      return;
    }
    const T* term = sm.term + cur * tsz;
    for (int b = 0; b < kp; ++b) {
      T yv[RM][CN];
      tile_zero<T, RM, CN>(yv);
      for (int j0 = 0; j0 < D; j0 += ring.jc) {
        const T* st = ring.acquire();
        if (active && b >= b0)
          tile_fma<T, RM, false, CN>(term + (size_t)j0 * tile + lr0, tile, st + (col0 - c0),
                                     ring.DP, ring.rows_of(j0), yv);
      }
      if (active && b >= b0) fold(b, b0, cf, yv);
    }
  };

  // 3. the chains: per chain its rows in order on the running sum
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < CN; ++k)
        acc[q][k] = active && lr0 + q < rows && col0 + k < cend
                        ? x[(size_t)(lr0 + q) * D + col0 + k] : T(0);
    for (int r = 0; r < R; ++r) {
      if (identity_row(p, c, r)) continue;  // e^0 = I: skipped, as the JAX kernels do
      const size_t cr = (size_t)c * R + r;
      int np[RM], np_max = 0;
#pragma unroll
      for (int q = 0; q < RM; ++q) np[q] = active ? sm.npass[cr * tile + lr0 + q] : 0;
      for (int lr = 0; lr < tile; ++lr) np_max = max(np_max, sm.npass[cr * tile + lr]);
      // the block runs to the tile's largest count, masking finished rows
      for (int pass = 0; pass < np_max; ++pass) {
        put_term(acc);  // the pass's start state
        for (int kk = 1; kk <= p.m; ++kk) {
          products(0, sm.cs + cr * tile * kp);
          if (active) {
            const T div = T(kk);
#pragma unroll
            for (int q = 0; q < RM; ++q)
#pragma unroll
              for (int k = 0; k < CN; ++k) {
                const T nt = w[q][k] / div;
                w[q][k] = nt;
                if (pass < np[q]) acc[q][k] = acc[q][k] + nt;
              }
          }
          put_term(w);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int k = 0; k < CN; ++k) {
          if (col0 + k >= cend || lr0 + q >= rows) continue;
          const size_t e = (size_t)(lr0 + q) * D + col0 + k;
          if (c == 0)
            x_out[e] = acc[q][k];
          else  // chain 1 - chain 0 (the thread wrote that element itself)
            acc[q][k] = acc[q][k] - x_out[e];
        }
    }
  }
  if (C == 1 && !fast) {
    if (rank == 0)
      for (int lr = tid; lr < rows; lr += blockDim.x) err_out[lr] = T(0);
    return;
  }

  // 4. the error vector dv (in acc) and its measure
  if (fast) {  // dv = sum_{k >= K0} w2_k (M_k y) on y, k in order
    put_term(acc);  // y, zero past the batch
    products(K0, sm.rows);
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < CN; ++k) acc[q][k] = w[q][k];
  }
  // dv into the first term buffer of the first block, row-major (tile, D),
  // once every read of the term is done; then chain_err_measure there
  xsync();
  T* dv = sm.term;
  if constexpr (CLUSTER) dv = cg::this_cluster().map_shared_rank(dv, 0);
  if (active) {
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < CN; ++k)
        if (col0 + k < cend) dv[(size_t)(lr0 + q) * D + col0 + k] = acc[q][k];
  }
  xsync();
  if (rank == 0) chain_err_measure(sm.term, x, x_out, err_out, rows, D, en);
}

}  // namespace vec_ode
