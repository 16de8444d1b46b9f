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
//      rk_step.cuh's ErrNorm (scaled_error, weight row, l2 or max, post).
// A row whose dt is 0 runs one pass with zero coefficients per exponential
// and returns x exactly.
//
// Basis terms: 1 to MAX_K0 = 8 (K' <= 36 working terms with the Magnus
// commutators). chain_step_tile has two bodies for the products of a
// Taylor term: the register body for K0 <= 2 (K' <= 3) and, past it, the
// k-outer body, one basis term at a time in the same order and rounding.
// K4 runs the register body from here and, for K0 > 2, its own tiled
// many-term body (chain_expmv.cu, the same rows prologue and the same
// bits); the loop kernel's K5 runs both bodies here.
//
// Layout. Each thread owns RT rows x CT columns (columns cg, cg + ncg, ...),
// as in rk_step.cuh, and keeps that part of the chain's running sum in
// registers across the chain's exponentials; the Taylor term of the whole
// tile lives in shared memory (one (tile, D) slot), and the basis is read
// from device memory (L2) at each term: 3 x 128 x 128 values are 196 KB in
// f32 and 393 KB in f64, too large for shared memory beside the state. x
// and x_out are (tile, D) slots in shared memory; the node samples, the
// per-row coefficients and pass counts of every (chain, exponential) too.
//
// Precision. Products accumulate by IEEE FMA in the state's type, never
// TF32. The nodes, the recipe's coefficient arithmetic, the bound, the
// weighted sum of the KP actions and the scaled_error denominator are
// written with explicitly rounded operations (no contraction), in the
// plain twin's order, the Python constants folded in f64 by the wrapper
// and rounded once here; the pass count comes from frexp, exactly. Build
// without --use_fast_math.

#pragma once

#include "rk_step.cuh"

namespace vec_ode {

constexpr int MAX_K0 = 8;     // basis terms (ops/expmv.py: MAX_K0)
constexpr int MAX_KP = 36;    // working terms: K0 + K0 (K0 - 1) / 2
constexpr int MAX_R = 4;      // exponentials per chain (ops/expmv.py: MAX_R)
constexpr int MAX_NODES = 8;  // quadrature nodes per step (ops/expmv.py: MAX_NODES)
constexpr int RECIPE_MIDPOINT = 0, RECIPE_MAGNUS4 = 1, RECIPE_MAGNUS4_FAST = 2,
              RECIPE_MAGNUS6 = 3, RECIPE_CFM = 4;
constexpr int FORM_COEFF = 0, FORM_CHEB = 1;  // the declared form (ops/expmv.py: FORMS)
// The register body (template value KP = K') holds all K' products of a
// Taylor term (y[KP][RT][CT]) and runs the launches with K0 <= REG_K0 (K'
// <= 3); every launch with more basis terms runs the k-outer body
// (template value KP_DYN), which reads K' at run time.
constexpr int REG_K0 = 2, KP_DYN = 0;
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

// The stride of the node samples in shared memory, for the code that
// writes them and the code that reads them: the launch's K0 in the k-outer
// body; REG_K0 in the register body, whose registers (ptxas) move when the
// stride does.
template <int KP, typename T>
__host__ __device__ __forceinline__ int g_stride(const ChainParams<T>& p) {
  return KP == KP_DYN ? p.K0 : REG_K0;
}

// K' of a launch: the register body's template value, else the
// parameters'.
template <int KP, typename T>
__host__ __device__ __forceinline__ int kp_of(const ChainParams<T>& p) {
  return KP == KP_DYN ? p.KP : KP;
}

// K0 of a launch: the register body's from its K' (1 -> 1, 2 and 3 -> 2),
// known at compile time; else the parameters'.
template <int KP, typename T>
__host__ __device__ __forceinline__ int k0_of(const ChainParams<T>& p) {
  return KP == KP_DYN ? p.K0 : (KP == 1 ? 1 : 2);
}

// The declared identity rows, which the step skips (ops/expmv.py:
// identity_rows): the Magnus-6 comparison chain's rows 1 and 2.
template <typename T>
__host__ __device__ __forceinline__ bool identity_row(const ChainParams<T>& p, int c, int r) {
  return p.recipe == RECIPE_MAGNUS6 && c == 1 && r >= 1;
}

// The device's opt-in shared memory per block and SM count, read once.
inline cudaError_t device_limits(int* dev, int* max_smem, int* n_sm) {
  static int max_smem_of[MAX_DEVICES], n_sm_of[MAX_DEVICES];
  cudaError_t st = cudaGetDevice(dev);
  if (st != cudaSuccess) return st;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (max_smem_of[*dev] == 0) {
    st = cudaDeviceGetAttribute(&max_smem_of[*dev], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                *dev);
    if (st != cudaSuccess) return st;
    st = cudaDeviceGetAttribute(&n_sm_of[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (st != cudaSuccess) return st;
  }
  *max_smem = max_smem_of[*dev];
  *n_sm = n_sm_of[*dev];
  return cudaSuccess;
}

// Rows per block of a chain-step kernel: the largest power of two up to
// 256 whose threads ((R / rt) x ceil(D / CT), and one per row) stay within
// max_threads, whose three (R, D) slots (x, y, the Taylor term) take at
// most 96 KB and whose whole shared memory smem_of(R) (with the per-row
// coefficient rows, C R K' of them: 2 x 6 x 36 for Magnus-6 at K0 = 8)
// fits the device's max_smem, halved further while the batch gives fewer
// than two blocks per SM, down to 16 rows. The rows' results do not depend
// on it. For K' <= 3 the shared-memory test never binds below the 96 KB
// one, so those tiles are what they were.
template <typename T, class SmemOf>
inline int chain_tile(int B, int D, int n_sm, int rt, int max_threads, size_t max_smem,
                      SmemOf smem_of) {
  const int ncg = (D + CT - 1) / CT;
  int tile = 256;
  while (tile > rt && (tile > max_threads || (tile / rt) * ncg > max_threads ||
                       3 * (size_t)tile * D * sizeof(T) > 96 * 1024 ||
                       smem_of(tile) > max_smem))
    tile /= 2;
  while (tile > 16 && (B + tile - 1) / tile < 2 * n_sm) tile /= 2;
  return tile;
}

// The scratch the step needs in shared memory, carved from one block of T.
template <typename T>
struct ChainSmem {
  T* term;     // (tile, D): the Taylor term; then the error partials
  T* g;        // (J, tile, gs): the coefficients at the nodes (gs: g_stride)
  T* rows;     // (C R, tile, K'): the unscaled coefficient rows
  T* cs;       // (C R, tile, K'): the scaled rows
  int* npass;  // (C R, tile): 2^s per row, 0 for rows past the batch

  __host__ __device__ static size_t elems(int tile, int D, int KP, int gs,
                                          const ChainParams<T>& p) {
    const size_t nr = (size_t)p.C * p.R;
    const size_t ints = nr * tile * sizeof(int);
    return (size_t)tile * D + (size_t)p.J * tile * gs + 2 * nr * tile * KP +
           (ints + sizeof(T) - 1) / sizeof(T);
  }
  __device__ static ChainSmem carve(T* base, int tile, int D, int KP, int gs,
                                    const ChainParams<T>& p) {
    const size_t nr = (size_t)p.C * p.R;
    ChainSmem s;
    s.term = base;
    s.g = s.term + (size_t)tile * D;
    s.rows = s.g + (size_t)p.J * tile * gs;
    s.cs = s.rows + nr * tile * KP;
    s.npass = reinterpret_cast<int*>(s.cs + nr * tile * KP);
    return s;
  }
};

// c_k(t) of the declared form, its terms added in the order a, b t,
// c cos(w t), the zero ones left out (ops/expmv.py:CoeffForm.sample).
template <typename T>
__device__ __forceinline__ T form_at(const T* f, T t) {
  T col = T(0);
  bool any = false;
  if (f[0] != T(0)) {
    col = f[0];
    any = true;
  }
  if (f[1] != T(0)) {
    const T bt = mul_rn(f[1], t);
    col = any ? add_rn(col, bt) : bt;
    any = true;
  }
  if (f[2] != T(0)) {
    const T ct = mul_rn(f[2], cos_full(mul_rn(f[3], t)));
    col = any ? add_rn(col, ct) : ct;
  }
  return col;
}

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

// c_k(t), k < K0, of the declared Chebyshev form (ops/expmv.py:
// ChebForm.sample) into out[k]: u = (2 t - (lo + hi)) (1 / (hi - lo)), then
// per term Clenshaw over its series c_0 .. c_{n-1}: b1, b2 = ((2 u) b1 -
// b2) + c_j, b1 for j = n - 1 .. 1, and c_k = (u b1 - b2) + c_0. No term
// is skipped (u 0 still carries a NaN), every operation rounded on its own.
template <typename T>
__device__ __forceinline__ void cheb_at(const ChainParams<T>& p, T t, T* out) {
  const T u = mul_rn(sub_rn(mul_rn(T(2), t), p.cheb_mid), p.cheb_inv);
  const T u2 = mul_rn(T(2), u);
  const int n = p.cheb_n;
  for (int k = 0; k < p.K0; ++k) {
    const T* c = p.cheb + (size_t)k * n;
    T b1 = T(0), b2 = T(0);
    for (int j = n - 1; j >= 1; --j) {
      const T nb = add_rn(sub_rn(mul_rn(u2, b1), b2), c[j]);
      b2 = b1;
      b1 = nb;
    }
    out[k] = add_rn(sub_rn(mul_rn(u, b1), b2), c[0]);
  }
}

// Fills sm.g with the declared form (a CoeffForm or a ChebForm, by
// p.form_kind) at the recipe's J nodes of each row. One thread per row;
// the caller synchronises before the step reads it.
template <int KP, typename T>
__device__ void sample_form(const T* __restrict__ t_rows, const T* __restrict__ dt_rows,
                            const ChainSmem<T>& sm, int tile, const ChainParams<T>& p) {
  const int gs = g_stride<KP>(p);
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    const T t = t_rows[lr], dt = dt_rows[lr];
    for (int nd = 0; nd < p.J; ++nd) {
      const T tn = node_time(p, nd, t, dt);
      T* g = sm.g + ((size_t)nd * tile + lr) * gs;
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

// The error measure of each row from the thread's part of the error vector
// dv (acc): rk_step.cuh's ErrNorm (scaled_error against x and x_out, the
// weight row, l2 or a NaN-propagating max, post), reduced over the
// column groups in order through the term slot, into err_out.
template <typename T, int RT>
__device__ __forceinline__ void chain_err_measure(const T (&acc)[RT][CT], const T* x,
                                                  const T* x_out, T* __restrict__ err_out,
                                                  T* term, int rows, int D, bool active, int rg,
                                                  int cg, const ErrNorm<T>& en) {
  const int ncg = (D + CT - 1) / CT;
  const int tid = threadIdx.x;
  T part[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) part[q] = T(0);
  if (active) {
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int lr = rg * RT + q;
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        const int col = cg + k * ncg;
        if (col >= D || lr >= rows) continue;
        const size_t e = (size_t)lr * D + col;
        T v = acc[q][k];
        if (en.scaled)
          v = v / add_rn(en.atol, mul_rn(en.rtol, nan_max(fabs(x[e]), fabs(x_out[e]))));
        if (en.w_row != nullptr) v = v * en.w_row[col];
        part[q] = en.kind_max ? nan_max(fabs(v), part[q]) : part[q] + v * v;
      }
    }
  }
  __syncthreads();  // the term slot is free: it takes the partials
  T* red = term;  // (tile, ncg)
  if (active) {
#pragma unroll
    for (int q = 0; q < RT; ++q) red[(rg * RT + q) * ncg + cg] = part[q];
  }
  __syncthreads();
  for (int lr = tid; lr < rows; lr += blockDim.x) {
    T a = T(0);
    for (int g = 0; g < ncg; ++g) {
      const T pv = red[lr * ncg + g];
      a = en.kind_max ? nan_max(pv, a) : a + pv;
    }
    T norm = en.kind_max ? a : sqrt_full(a);
    if (en.scaled) norm = norm * en.rtol;
    if (en.post != T(1)) norm = norm * en.post;
    err_out[lr] = norm;
  }
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
// the recipe has a zero row); g holds the node samples (J, tile, gs), dt
// the row's step. KP is the body's template value: the register body's
// loops have K' and K0 known at compile time (row then lives in registers).
template <int KP_, typename T>
__device__ __forceinline__ void chain_row(const ChainParams<T>& p, int c, int r, const T* g,
                                          int tile, int lr, T dt, T* row) {
  const int KP = kp_of<KP_>(p), K0 = k0_of<KP_>(p);
#pragma unroll
  for (int k = 0; k < KP; ++k) row[k] = T(0);
  const T* g0 = g + (size_t)lr * g_stride<KP_>(p);  // node nd at g0 + nd * gs
  const size_t gs = (size_t)tile * g_stride<KP_>(p);
  switch (p.recipe) {
    case RECIPE_MIDPOINT:
#pragma unroll
      for (int k = 0; k < KP; ++k) row[k] = mul_rn(dt, g0[k]);
      break;
    case RECIPE_CFM: {
      if (c == 1 && r >= p.n_err) break;  // a zero pad row
      const T* a = c == 0 ? p.alpha[r] : p.alpha_err[r];
#pragma unroll
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
#pragma unroll
        for (int k = 0; k < KP; ++k)
          if (k >= p.K0) row[k] = T(0);
  }
}

// Steps 1-2 of the note, one thread per trajectory: every (chain,
// exponential) row, its bound sum_k |c_k| ||M_k||_1, its pass count into
// sm.npass and the row into sm.rows and, divided by the count, sm.cs; rows
// past `rows` are zero and run no pass. The register body builds a row in
// registers, the k-outer body in place in sm.rows. Ends with a barrier.
template <int KP, typename T>
__device__ __forceinline__ void chain_rows_setup(const T* __restrict__ dt_rows,
                                                 const ChainSmem<T>& sm, int rows, int tile,
                                                 const ChainParams<T>& p) {
  constexpr bool KOUTER = KP == KP_DYN;
  const int kp = kp_of<KP>(p);
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    const bool ok = lr < rows;
    const T dt = ok ? dt_rows[lr] : T(0);
    for (int c = 0; c < p.C; ++c)
      for (int r = 0; r < p.R; ++r) {
        const size_t cr = (size_t)c * p.R + r;
        T reg[KOUTER ? 1 : KP];
        T* row = KOUTER ? sm.rows + (cr * tile + lr) * kp : reg;
        chain_row<KP>(p, c, r, sm.g, tile, lr, dt, row);
        T bound = T(0);
#pragma unroll
        for (int k = 0; k < kp; ++k) {
          if (!ok) row[k] = T(0);
          const T term = mul_rn(fabs(row[k]), p.norms[k]);
          bound = k == 0 ? term : add_rn(bound, term);
        }
        const int n_pass = pass_count(bound, p);
        const T scale = T(1) / T(n_pass);  // exact
#pragma unroll
        for (int k = 0; k < kp; ++k) {
          if (!KOUTER) sm.rows[(cr * tile + lr) * kp + k] = row[k];
          sm.cs[(cr * tile + lr) * kp + k] = row[k] * scale;
        }
        sm.npass[cr * tile + lr] = ok && !identity_row(p, c, r) ? n_pass : 0;
      }
  }
  __syncthreads();
}

// The body of chain_products. FULL: every column of the thread lies inside
// the row (D a multiple of CT), so the basis loads carry no bounds check
// and a thread's loads of one j go out together.
template <bool FULL, typename T, int RT, int KP>
__device__ __forceinline__ void chain_products_body(const T* trow, const T* __restrict__ mt,
                                                    int D, int cg, int ncg,
                                                    T (&y)[KP][RT][CT]) {
  const size_t ld = (size_t)KP * D;
#pragma unroll 2
  for (int j = 0; j < D; ++j) {
    T xv[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) xv[q] = trow[(size_t)q * D + j];
    const T* mrow = mt + (size_t)j * ld;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      T mv[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = cg + c * ncg;
        mv[c] = (FULL || col < D) ? __ldg(mrow + (size_t)k * D + col) : T(0);
      }
#pragma unroll
      for (int q = 0; q < RT; ++q)
#pragma unroll
        for (int c = 0; c < CT; ++c) y[k][q][c] = fma_full(xv[q], mv[c], y[k][q][c]);
    }
  }
}

// y_k[q][c] = sum_j term[row q][j] M_k[col c][j] for the thread's RT rows and
// CT columns, k < KP, from the (tile, D) slot `term` and MT (D, KP*D): the
// register body's products of a Taylor term.
template <typename T, int RT, int KP>
__device__ __forceinline__ void chain_products(const T* term, const T* __restrict__ mt, int D,
                                               int rg, int cg, int ncg, T (&y)[KP][RT][CT]) {
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int q = 0; q < RT; ++q)
#pragma unroll
      for (int c = 0; c < CT; ++c) y[k][q][c] = T(0);
  const T* trow = term + (size_t)(rg * RT) * D;
  if (D % CT == 0)
    chain_products_body<true, T, RT, KP>(trow, mt, D, cg, ncg, y);
  else
    chain_products_body<false, T, RT, KP>(trow, mt, D, cg, ncg, y);
}

// y[q][c] = sum_j term[row q][j] M_k[col c][j] for one basis term: mk =
// MT + k D, rows of ld = K' D values (chain_products_body's order).
template <bool FULL, typename T, int RT>
__device__ __forceinline__ void chain_product_one(const T* trow, const T* __restrict__ mk,
                                                  size_t ld, int D, int cg, int ncg,
                                                  T (&y)[RT][CT]) {
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int c = 0; c < CT; ++c) y[q][c] = T(0);
#pragma unroll 2
  for (int j = 0; j < D; ++j) {
    T xv[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) xv[q] = trow[(size_t)q * D + j];
    const T* mrow = mk + (size_t)j * ld;
    T mv[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = cg + c * ncg;
      mv[c] = (FULL || col < D) ? __ldg(mrow + col) : T(0);
    }
#pragma unroll
    for (int q = 0; q < RT; ++q)
#pragma unroll
      for (int c = 0; c < CT; ++c) y[q][c] = fma_full(xv[q], mv[c], y[q][c]);
  }
}

// The k-outer body's product of basis term k (K' read at run time).
template <typename T, int RT>
__device__ __forceinline__ void chain_product_k(const T* term, const T* __restrict__ mt, int k,
                                                int KP, int D, int rg, int cg, int ncg,
                                                T (&y)[RT][CT]) {
  const T* trow = term + (size_t)(rg * RT) * D;
  const size_t ld = (size_t)KP * D;
  if (D % CT == 0)
    chain_product_one<true, T, RT>(trow, mt + (size_t)k * D, ld, D, cg, ncg, y);
  else
    chain_product_one<false, T, RT>(trow, mt + (size_t)k * D, ld, D, cg, ncg, y);
}

// One chain step of a tile (see the note above); every thread of the block
// calls it. Before the call sm.g holds the node samples of rows < `rows`,
// and dt_rows, x are written; the block needs (tile / RT) * ceil(D / CT)
// threads or more. Writes x_out (rows, D) and err_out (rows,), err_out zero
// without an error estimate. x and x_out are (tile, D) slots in shared
// memory whose rows past `rows` are zero.
//
// Two bodies for the products of a Taylor term, chosen by the template
// value KP. The register body (KP = K' <= 3) keeps all K' products in
// registers (y[KP][RT][CT]) and combines them after the barrier. The
// k-outer body (KP == KP_DYN, K' up to MAX_KP read at run time; at K' = 36
// y would be 576 values a thread) takes one (RT, CT) product tile term @
// M_k^T per basis term and folds it at once into w = cs_0 y_0, w = w +
// cs_k y_k: the same k order and rounding, so the same results bit for
// bit; the term's rows are read from shared memory K' times per term.
template <typename T, int RT, int KP>
__device__ void chain_step_tile(const T* __restrict__ dt_rows, const T* x, T* x_out,
                                T* __restrict__ err_out, const ChainSmem<T>& sm, int rows,
                                int tile, int D, const T* __restrict__ mt,
                                const ChainParams<T>& p, const ErrNorm<T>& en) {
  constexpr bool KOUTER = KP == KP_DYN;
  const int ncg = (D + CT - 1) / CT;
  const int items = (tile / RT) * ncg;
  const int tid = threadIdx.x;
  const bool active = tid < items;
  const int cg = tid % ncg;
  const int rg = tid / ncg;
  const int K0 = p.K0, C = p.C, R = p.R;
  const int kp = kp_of<KP>(p);
  const bool fast = p.recipe == RECIPE_MAGNUS4_FAST;
  const bool has_err = C == 2 || fast;

  // 1-2. the rows, their bounds and pass counts
  chain_rows_setup<KP>(dt_rows, sm, rows, tile, p);

  // 3. the chains: per chain its rows in order on the running sum
  T acc[RT][CT];
  T y[KOUTER ? 1 : KP][RT][CT];  // the register body's K' products; the k-outer body's one
  T w[RT][CT];                   // the k-outer body's combination
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int lr = rg * RT + q;
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        const int col = cg + k * ncg;
        acc[q][k] = (active && col < D) ? x[(size_t)lr * D + col] : T(0);
      }
    }
    for (int r = 0; r < R; ++r) {
      if (identity_row(p, c, r)) continue;  // e^0 = I: skipped, as the JAX kernels do
      const size_t cr = (size_t)c * R + r;
      int np[RT];
#pragma unroll
      for (int q = 0; q < RT; ++q) np[q] = active ? sm.npass[cr * tile + rg * RT + q] : 0;
      for (int pass = 0;; ++pass) {
        bool mine = false;
        if (active) {
#pragma unroll
          for (int q = 0; q < RT; ++q) {
            mine = mine || np[q] > pass;
#pragma unroll
            for (int k = 0; k < CT; ++k) {
              const int col = cg + k * ncg;
              if (col < D) sm.term[(size_t)(rg * RT + q) * D + col] = acc[q][k];
            }
          }
        }
        // the pass's start state is written; go on while any row has passes
        if (!__syncthreads_or(mine)) break;
        for (int kk = 1; kk <= p.m; ++kk) {
          if constexpr (KOUTER) {
            if (active) {
              for (int b = 0; b < kp; ++b) {
                chain_product_k<T, RT>(sm.term, mt, b, kp, D, rg, cg, ncg, y[0]);
#pragma unroll
                for (int q = 0; q < RT; ++q) {
                  const T cq = sm.cs[(cr * tile + rg * RT + q) * kp + b];
#pragma unroll
                  for (int k = 0; k < CT; ++k) {
                    const T part = mul_rn(cq, y[0][q][k]);
                    w[q][k] = b == 0 ? part : add_rn(w[q][k], part);
                  }
                }
              }
            }
          } else {
            if (active) chain_products<T, RT, KP>(sm.term, mt, D, rg, cg, ncg, y);
          }
          __syncthreads();  // every read of the term is done
          if (active) {
            const T div = T(kk);
#pragma unroll
            for (int q = 0; q < RT; ++q) {
              const int lr = rg * RT + q;
              const T* cq = sm.cs + (cr * tile + lr) * kp;
#pragma unroll
              for (int k = 0; k < CT; ++k) {
                const int col = cg + k * ncg;
                if (col >= D) continue;
                T wv;
                if constexpr (KOUTER) {
                  wv = w[q][k];
                } else {
                  wv = mul_rn(cq[0], y[0][q][k]);
#pragma unroll
                  for (int b = 1; b < KP; ++b) wv = add_rn(wv, mul_rn(cq[b], y[b][q][k]));
                }
                const T nt = wv / div;
                sm.term[(size_t)lr * D + col] = nt;
                if (pass < np[q]) acc[q][k] = acc[q][k] + nt;
              }
            }
          }
          __syncthreads();  // the new term is written
        }
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int lr = rg * RT + q;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          if (col >= D || lr >= rows) continue;
          if (c == 0)
            x_out[(size_t)lr * D + col] = acc[q][k];
          else  // chain 1 - chain 0 (the thread wrote that element itself)
            acc[q][k] = acc[q][k] - x_out[(size_t)lr * D + col];
        }
      }
    }
  }
  if (!has_err) {
    for (int lr = tid; lr < rows; lr += blockDim.x) err_out[lr] = T(0);
    return;
  }

  // 4. the error vector dv (in acc) and its measure
  if (fast) {  // dv = sum_{k >= K0} w2_k (M_k y) on y, k in order
    if (active) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int lr = rg * RT + q;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          if (col < D) sm.term[(size_t)lr * D + col] = lr < rows ? x_out[(size_t)lr * D + col] : T(0);
        }
      }
    }
    __syncthreads();
    if (active) {
      if constexpr (KOUTER) {  // one product per k
#pragma unroll
        for (int q = 0; q < RT; ++q)
#pragma unroll
          for (int k = 0; k < CT; ++k) acc[q][k] = T(0);
        for (int b = K0; b < kp; ++b) {
          chain_product_k<T, RT>(sm.term, mt, b, kp, D, rg, cg, ncg, y[0]);
#pragma unroll
          for (int q = 0; q < RT; ++q) {
            const T rq = sm.rows[(size_t)(rg * RT + q) * kp + b];
#pragma unroll
            for (int k = 0; k < CT; ++k) {
              const T part = mul_rn(rq, y[0][q][k]);
              acc[q][k] = b == K0 ? part : add_rn(acc[q][k], part);
            }
          }
        }
      } else {  // one product on y
        chain_products<T, RT, KP>(sm.term, mt, D, rg, cg, ncg, y);
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          const T* rq = sm.rows + (size_t)(rg * RT + q) * KP;
#pragma unroll
          for (int k = 0; k < CT; ++k) {
            T dv = T(0);
            bool any = false;
#pragma unroll
            for (int b = 0; b < KP; ++b) {
              if (b < K0) continue;
              const T part = mul_rn(rq[b], y[b][q][k]);
              dv = any ? add_rn(dv, part) : part;
              any = true;
            }
            acc[q][k] = dv;
          }
        }
      }
    }
  }
  chain_err_measure<T, RT>(acc, x, x_out, err_out, sm.term, rows, D, active, rg, cg, en);
}

}  // namespace vec_ode
