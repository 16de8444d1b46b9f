// The reversible adjoint's kernels for modulated linear ODEs, written by
// hand for Hopper (sm_90a). They replace three Pallas TPU kernels of
// vec_ode_tpu/ops/pallas_expmv.py:
//   K6 adjoint_bwd_pallas (pallas_call at :474): one reverse row with
//      per-lane rows c (B, K'), one squaring count per lane;
//   K7 adjoint_sweep_fwd_pallas (:566): all R rows of a fixed-step forward,
//      y = e^{A_{R-1}} ... e^{A_0} x, rows c_all (R, K') shared by the batch;
//   K8 adjoint_sweep_bwd_pallas (:643): the whole reverse sweep, a0 and the
//      coefficient cotangents of every row.
// K6 runs adjoint_row.cuh's adjoint_row_tile (its note has what it
// computes, the layout and the precision rules). In K7 and K8 each block
// carries its trajectories through all R rows in one launch; the rows are
// shared, so every block takes the same count per row (one per row,
// ops/adjoint.py, not the TPU kernels' single count over all rows) and no
// row waits masked. K8 writes one batch-summed (R, K') partial per block,
// which the wrapper sums in block order: no atomics, so the gradients do
// not change from run to run.
//
// What bounds them: FP32 (or FP64) FMA throughput, by the work the rows
// need, once each shared row's exponent is formed. K7 and K8 form it.
//
// K7's design. The rows are shared by the batch, so the function needs
// the exponent once per row: y = e^{A_{R-1}} ... e^{A_0} x with A_r =
// sum_k c_{r,k} 2^-s_r W_k formed once (K' D^2 operations) and then one
// (D, D) action per Taylor term, 17.34 GFLOP for the path's 256 rows
// (0.26 ms at the FP32 rate: FMA throughput bounds it), not
// the 51.5 GFLOP of K' actions per term that the TPU kernel and K7's
// first version ran. (The function needs less still, 9.76 GFLOP: each
// row's Taylor polynomial formed as a matrix, then one action a pass;
// chip_smoke.py:adj_flops counts the least route for the bound. That
// route is not built.) That version took 30.33 ms at 256 x 64c on an H100
// (80 GB, 700 W; 0.9% of its bound, the library's matrix_exp + products
// 9.33 ms): 128 blocks of two
// trajectories, two warps per SM, K' dependent chains of L2 loads per
// term, then a block barrier. This one:
//   - forms A_r^T = sum_k cs_k W_k^T in shared memory, in the twin's k
//     order with explicitly rounded operations (bit for bit the twin's
//     matrix), and runs 2^s_r passes of the degree-m Taylor polynomial,
//     each term one (tile, D) @ (D, D) product from that copy through
//     gemm_tile.cuh's register microtile (RM rows x 4 columns a thread;
//     the term row-major in rows of DP + 4 values, so its 16-byte stores
//     and the broadcast loads meet no bank conflict);
//   - at small tiles splits the contraction into ks groups (up to 8, of
//     at least 16 indices), each an FMA chain over its own indices, whose
//     partial products group 0 adds in group order: at B = 256 a block of
//     two trajectories runs 4 groups, 256 threads, where one chain over
//     all 128 indices left each thread waiting on its loads;
//   - forms A_{r+1} in a second buffer while row r runs: producer warps
//     (SWEEP_PRODUCER_WARPS) read the basis with 16-byte loads and
//     accumulate in k order, the consumer warps synchronise among
//     themselves on a named barrier, and the block meets once per row.
//     Memory does not grow with R: two (D, D) buffers a block.
// The launcher picks the plan by shape: both buffers (SWEEP_DOUBLE) where
// 2 D^2 values fit beside the term (f32 up to D = 128 and a bit more,
// f64 up to 90); one buffer formed between rows (SWEEP_SINGLE, f64 at
// D = 128, f32 up to ~230); else panels of A_r formed at every term from
// the basis (SWEEP_PANEL, D = 512: the basis is read per term, as the old
// design did, but the products are one action a term). Trajectories per
// block: the largest power of two up to 64 that leaves at least n_sm / 2
// blocks (2 at B = 256, 32 at 4096), so every SM gets work; of the tiles
// measured on an H100 these were the fastest at both batches. The result
// does not depend on the tile but for the contraction groups' summation
// order (rounding).

// K8's design. A reverse row over the shared row c_r computes, per
// trajectory, x_n = e^{-A} x, a_n = e^{A^T} a and cbar_k = <a, u_k> with
// u_k = D_{W_k} e^{A} x_n (adjoint_row.cuh's note). The first version ran
// it per trajectory as K6 does: K' basis actions per chain and term, so
// K'^2 + 3K' actions a term (18 at K' = 3), two trajectories a block, the
// basis streamed from L2 for 8 chain rows (68.78 ms at 256 x 64c and
// 645.24 ms at 4096 on an H100 80 GB, 700 W, 5.5x behind the library's
// matrix_exp there). The rows are shared, so this one forms
//   A_r^T = sum_k cs_k W_k^T
// once per row and block in shared memory (form_rows: the twin's k
// order, explicitly rounded, bit for bit ops/adjoint.py:_exponent, the
// matrix K7 forms) and runs every chain from that one buffer:
//   1. phase 1, the x chain: each Taylor term one product with -A^T
//      (negation is exact), the term row-major, the buffer read by rows
//      (a thread's 4 contiguous columns, one 16-byte load per index);
//   2. phase 2, side by side: each u_k chain one product with A^T plus
//      2^-s W_k w; the w chain's K' actions W_k w, which also give A w
//      combined in k order, from mt's rows streamed through a ring of
//      cp.async stages (MtRing: at 256 trajectories each block's 192 KB
//      of mt a term, read by every thread from L2 with one load in
//      flight, had made the stream a third of the kernel's time); the a
//      chain one product with A, the same buffer read transposed (a
//      thread's columns strided by ncg, 16-byte loads along the
//      contraction index; rows of AS = DP or DP + 4 values, AS / 4 odd,
//      so that the rows a warp reads fall in different banks);
//   3. cbar_k = <a, u_k> per trajectory over its columns, then over the
//      column groups and the block's trajectories in order.
// That is 2K' + 2 (D, D) actions a term per trajectory (8 at K' = 3), no
// K'^2 term: 139.5 GFLOP at the path's 256 x 64c. The function needs
// less, 36.8 GFLOP (chip_smoke.py:adj_flops, the bound): cbar is summed
// over the batch, so cbar_k = <W_k, L>, L one adjoint Frechet chain of
// the row's polynomial in the direction G = sum_b a_b x_b^T per row (3
// (D, D) products a term), and the x and a chains one action a pass from
// the polynomials formed as matrices. That route is not built (ROADMAP).
// Each thread owns an item, RM rows x 4 columns of one chain
// (K' u items and an a item per row group), its products and running
// sums in registers; the terms, the w chain's actions and running sum
// and the state sit in shared memory, and the w chain's combination is
// one elementwise pass by every thread (in the a items' registers it had
// cost a third of the kernel's time). Two barriers a term and one per
// stage of the ring. At small tiles the contraction is
// split into groups (as in K7), each an FMA chain over its own indices
// whose partial products the item's owner adds in group order: ks groups
// in phase 2, and in phase 1, whose x chain has a quarter of the items,
// as many as the block's threads hold. Each output element is a fixed
// sequence of FMA chains, so the result does not change from run to run;
// the tile sets the groups, so the bits differ between shapes.
// The launcher picks the shape: BWD_BUFFER (the exponent and the ring in
// shared memory, the exponent formed between rows; f32 up to D ~ 200,
// f64 ~ 140 but at K' = 6) or else BWD_PANEL (panels of A^T and A formed
// from mt and ms at every term and mt read from L2, as K7's SWEEP_PANEL;
// D = 512); trajectories per block the largest power of two up to
// BWD_MAX_TILE that leaves n_sm / 2 blocks, halved while the block does
// not fit (2 a block at B = 256, with 2 rows a thread and 4 groups, and
// 16 at 4096, with 4 rows a thread, for D = 128, K' = 3 in f32: 512
// threads); a block of up to BWD_WIDE_THREADS threads where one
// trajectory needs more (D > 292 with K' + 1 chains). ops/adjoint.py:
// bwd_plan mirrors it.

#include "adjoint_row.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace vec_ode;

template <typename T>
AdjParams<T> parse(int KP, const double* norms, int m, double theta, int max_sq) {
  AdjParams<T> p{};
  p.KP = KP, p.m = m, p.max_sq = max_sq, p.theta = (T)theta;
  for (int k = 0; k < KP && k < ADJ_MAX_KP; ++k) p.norms[k] = (T)norms[k];
  return p;
}

inline bool params_ok(int B, int D, int KP, int m, int max_sq) {
  return B >= 1 && D >= 1 && D <= MAX_WIDTH && KP >= 1 && KP <= ADJ_MAX_KP && m >= 1 &&
         max_sq >= 0 && max_sq <= 30;
}

// Loads rows [row0, row0 + rows) of src (B, D) into the (tile, D) slot dst,
// zeros past them.
template <typename T>
__device__ void load_tile(T* dst, const T* __restrict__ src, long row0, int rows, int tile,
                          int D) {
  for (size_t e = threadIdx.x; e < (size_t)tile * D; e += blockDim.x)
    dst[e] = e < (size_t)rows * D ? src[row0 * D + e] : T(0);
}

template <typename T>
__device__ void store_tile(T* __restrict__ dst, const T* src, long row0, int rows, int D) {
  for (size_t e = threadIdx.x; e < (size_t)rows * D; e += blockDim.x) dst[row0 * D + e] = src[e];
}

// The scaling of each trajectory's own row of c (B, KP); rows past the
// batch get no passes.
template <typename T>
__device__ void scale_tile(const T* __restrict__ c, long row0, int rows, int tile,
                           const AdjSmem<T>& s, const AdjParams<T>& p) {
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    T row[ADJ_MAX_KP];
    const bool ok = lr < rows;
    for (int k = 0; k < p.KP; ++k) row[k] = ok ? c[(row0 + lr) * p.KP + k] : T(0);
    adj_scale_row(row, ok, lr, s, p);
  }
}

// narrow blocks: up to 128 registers a thread, two blocks per SM
#define ADJ_BOUNDS(WIDE) \
  __launch_bounds__((WIDE) ? ADJ_MAX_THREADS : ADJ_NARROW_THREADS, (WIDE) ? 1 : 2)

template <typename T, int KP, bool WIDE>
__global__ void ADJ_BOUNDS(WIDE)
adjoint_bwd_kernel(const T* __restrict__ c, const T* __restrict__ x, const T* __restrict__ a,
                   const T* __restrict__ mt, const T* __restrict__ ms, T* __restrict__ xn,
                   T* __restrict__ an, T* __restrict__ cb, int B, int D, int tile,
                   AdjParams<T> p) {
  extern __shared__ unsigned char smem_raw[];
  const AdjSmem<T> s = AdjSmem<T>::carve(reinterpret_cast<T*>(smem_raw), tile, D, KP);
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  load_tile(s.x, x, row0, rows, tile, D);
  load_tile(s.a, a, row0, rows, tile, D);
  scale_tile(c, row0, rows, tile, s, p);
  __syncthreads();
  adjoint_row_tile<T, KP>(s, rows, tile, D, mt, ms, p.m);
  store_tile(xn, s.x, row0, rows, D);
  store_tile(an, s.an, row0, rows, D);
  for (int i = threadIdx.x; i < rows * KP; i += blockDim.x) cb[row0 * KP + i] = s.cbr[i];
}

// K7's plans (see the note above).
constexpr int SWEEP_DOUBLE = 0, SWEEP_SINGLE = 1, SWEEP_PANEL = 2;
constexpr int SWEEP_PRODUCER_WARPS = 4;  // SWEEP_DOUBLE: the warps forming A_{r+1}
constexpr int SWEEP_MAX_TILE = 64;

// K7's term rows in shared memory: DP + 4 values, so that the rows a warp
// reads at one contraction index fall in different banks.
__host__ __device__ inline int sweep_ts(int D) { return gemm_dp(D) + GEMM_CN; }

// K7's shared memory, byte offsets (16-byte aligned): the exponent (D, DP)
// or, for SWEEP_PANEL, one panel of it (jc, DP); the second exponent
// (SWEEP_DOUBLE); the term, row-major (tile, TS); the partial products of
// the ks - 1 later contraction groups (ks - 1, tile, TS).
// ops/adjoint.py:sweep_plan mirrors it.
template <typename T>
struct SweepLayout {
  size_t a0, a1, term, red, total;
  __host__ __device__ SweepLayout(int plan, int tile, int ks, int D) {
    const size_t row = (size_t)gemm_dp(D) * sizeof(T), trow = (size_t)sweep_ts(D) * sizeof(T);
    size_t at = 0;
    a0 = at, at += align16((plan == SWEEP_PANEL ? gemm_jc<T>(D) : D) * row);
    a1 = at;
    if (plan == SWEEP_DOUBLE) at += align16(D * row);
    term = at, at += align16(tile * trow);
    red = at, at += align16((size_t)(ks - 1) * tile * trow);
    total = at;
  }
};

// A shared row's scaling (adj_scale_row's rule): the scaled row into cs,
// returns 2^s.
template <typename T>
__device__ __forceinline__ int sweep_row(const T* __restrict__ c, const AdjParams<T>& p,
                                         T (&cs)[ADJ_MAX_KP]) {
  T bound = T(0);
#pragma unroll
  for (int k = 0; k < ADJ_MAX_KP; ++k) {
    if (k >= p.KP) break;
    const T term = mul_rn(fabs(c[k]), p.norms[k]);
    bound = k == 0 ? term : add_rn(bound, term);
  }
  const T ratio = bound / p.theta;
  int e2 = 0;
  if (isfinite(bound) && ratio > T(1)) {
    int e = 0;
    const T mant = frexp_full(ratio, &e);
    e2 = e - (mant == T(0.5) ? 1 : 0);
    e2 = e2 < 0 ? 0 : (e2 > p.max_sq ? p.max_sq : e2);
  }
  const int n_pass = 1 << e2;
  const T scale = T(1) / T(n_pass);  // exact
#pragma unroll
  for (int k = 0; k < ADJ_MAX_KP; ++k) cs[k] = k < p.KP ? c[k] * scale : T(0);
  return n_pass;
}

template <typename T, int N>
__device__ __forceinline__ void ldg_vec(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x, v[1] = d.y;
  }
}

// Rows [j0, j0 + jn) of A^T = sum_k cs_k W_k^T (row j of each of mt's K'
// blocks, combined in k order with explicitly rounded operations, as the
// twin's _exponent) into dst (row stride DP), by threads t, t + nt, ...;
// 16-byte loads where D allows.
template <typename T>
__device__ void form_rows(T* dst, int DP, const T (&cs)[ADJ_MAX_KP], int kp,
                          const T* __restrict__ mt, int D, int j0, int jn, int t, int nt) {
  const size_t ld = (size_t)kp * D;
  constexpr int V = 16 / sizeof(T);
  if (D % V == 0 && (size_t)mt % 16 == 0) {
    const int per = D / V;
#pragma unroll 2
    for (int e = t; e < jn * per; e += nt) {
      const int jj = e / per, i = (e - jj * per) * V;
      const T* src = mt + (size_t)(j0 + jj) * ld + i;
      T v[ADJ_MAX_KP][V], a[V];
#pragma unroll
      for (int k = 0; k < ADJ_MAX_KP; ++k)
        if (k < kp) ldg_vec<T, V>(src + (size_t)k * D, v[k]);
#pragma unroll
      for (int u = 0; u < V; ++u) a[u] = mul_rn(cs[0], v[0][u]);
#pragma unroll
      for (int k = 1; k < ADJ_MAX_KP; ++k)
        if (k < kp) {
#pragma unroll
          for (int u = 0; u < V; ++u) a[u] = add_rn(a[u], mul_rn(cs[k], v[k][u]));
        }
#pragma unroll
      for (int u = 0; u < V; ++u) dst[(size_t)jj * DP + i + u] = a[u];
    }
  } else {
    for (int e = t; e < jn * D; e += nt) {
      const int jj = e / D, i = e - jj * D;
      const T* src = mt + (size_t)(j0 + jj) * ld + i;
      T a = mul_rn(cs[0], __ldg(src));
#pragma unroll
      for (int k = 1; k < ADJ_MAX_KP; ++k)
        if (k < kp) a = add_rn(a, mul_rn(cs[k], __ldg(src + (size_t)k * D)));
      dst[(size_t)jj * DP + i] = a;
    }
  }
}

// K7 (see the note above): the first nc threads run the products. Thread
// t < ks * per (per = tile / RM * DP / 4) owns rows [rg RM, rg RM + RM) and
// columns [cg 4, cg 4 + 4) of the tile (t mod per = rg DP / 4 + cg) over
// contraction group kg = t / per, j in [kg dk, kg dk + dk); group 0 adds
// the later groups' partial products in group order and keeps the state.
// Under SWEEP_DOUBLE the warps past nc form the next row's exponent.
template <typename T, int RM>
__global__ void __launch_bounds__(GEMM_THREADS + 32 * SWEEP_PRODUCER_WARPS, 1)
adjoint_sweep_gemm_kernel(const T* __restrict__ c_all, int R, const T* __restrict__ x,
                          const T* __restrict__ mt, T* __restrict__ y, int B, int D, int tile,
                          int ks, int nc, int plan, AdjParams<T> p) {
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  const SweepLayout<T> L(plan, tile, ks, D);
  T* const a0 = reinterpret_cast<T*>(sweep_smem + L.a0);
  T* const a1 = reinterpret_cast<T*>(sweep_smem + L.a1);
  T* term = reinterpret_cast<T*>(sweep_smem + L.term);
  T* red = reinterpret_cast<T*>(sweep_smem + L.red);
  const int DP = gemm_dp(D), TS = sweep_ts(D), ncg = DP / GEMM_CN, kp = p.KP;
  const int jc = gemm_jc<T>(D), per = (tile / RM) * ncg, dk = (D + ks - 1) / ks;
  const int tid = threadIdx.x;
  const bool consumer = tid < nc;
  const bool active = tid < per * ks;
  const int kg = tid / per, col0 = (tid % per % ncg) * GEMM_CN, lr0 = (tid % per / ncg) * RM;
  const bool owner = active && kg == 0;
  const int j_lo = kg * dk < D ? kg * dk : D, j_hi = j_lo + dk < D ? j_lo + dk : D;
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  // the consumers' own barrier (named barrier 1), the producers not in it
  auto bar = [&]() { asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory"); };

  T acc[RM][GEMM_CN], yv[RM][GEMM_CN];
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int k = 0; k < GEMM_CN; ++k)
      acc[q][k] = owner && lr0 + q < rows && col0 + k < D
                      ? x[(row0 + lr0 + q) * D + col0 + k] : T(0);
  auto put_term = [&]() {  // acc's new term yv, row-major
    if (!owner) return;
#pragma unroll
    for (int q = 0; q < RM; ++q) sts_vec4(term + (size_t)(lr0 + q) * TS + col0, yv[q]);
  };

  T cs[ADJ_MAX_KP];
  int np = R > 0 ? sweep_row(c_all, p, cs) : 0;
  if (plan != SWEEP_PANEL && R > 0) form_rows(a0, DP, cs, kp, mt, D, 0, D, tid, blockDim.x);
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    if (!consumer) {  // SWEEP_DOUBLE's producers: A_{r+1} while row r runs
      if (r + 1 < R) {
        T cn[ADJ_MAX_KP];
        sweep_row(c_all + (size_t)(r + 1) * kp, p, cn);
        form_rows((r & 1) ? a0 : a1, DP, cn, kp, mt, D, 0, D, tid - nc, blockDim.x - nc);
      }
    } else {
      const T* A = plan == SWEEP_DOUBLE && (r & 1) ? a1 : a0;
      for (int pass = 0; pass < np; ++pass) {
#pragma unroll
        for (int q = 0; q < RM; ++q)
#pragma unroll
          for (int k = 0; k < GEMM_CN; ++k) yv[q][k] = acc[q][k];
        put_term();
        bar();
        for (int kk = 1; kk <= p.m; ++kk) {
          tile_zero<T, RM>(yv);
          if (plan == SWEEP_PANEL) {  // ks = 1
            for (int j0 = 0; j0 < D; j0 += jc) {
              const int jn = D - j0 < jc ? D - j0 : jc;
              form_rows(a0, DP, cs, kp, mt, D, j0, jn, tid, nc);
              bar();
              if (active)
                tile_fma<T, RM, true>(term + (size_t)lr0 * TS + j0, TS, a0 + col0, DP, jn, yv);
              bar();
            }
          } else if (active && j_hi > j_lo) {
            tile_fma<T, RM, true>(term + (size_t)lr0 * TS + j_lo, TS, A + (size_t)j_lo * DP + col0,
                            DP, j_hi - j_lo, yv);
          }
          if (active && kg > 0) {
#pragma unroll
            for (int q = 0; q < RM; ++q)
              sts_vec4(red + ((size_t)(kg - 1) * tile + lr0 + q) * TS + col0, yv[q]);
          }
          bar();  // every read of the term is done; the partials are written
          if (owner) {
            const T div = T(kk);
            for (int g = 1; g < ks; ++g) {
#pragma unroll
              for (int q = 0; q < RM; ++q) {
                T pv[GEMM_CN];
                lds_vec<T, GEMM_CN>(red + ((size_t)(g - 1) * tile + lr0 + q) * TS + col0, pv);
#pragma unroll
                for (int k = 0; k < GEMM_CN; ++k) yv[q][k] = yv[q][k] + pv[k];
              }
            }
#pragma unroll
            for (int q = 0; q < RM; ++q)
#pragma unroll
              for (int k = 0; k < GEMM_CN; ++k) {
                yv[q][k] = yv[q][k] / div;
                acc[q][k] = acc[q][k] + yv[q][k];
              }
          }
          put_term();
          bar();  // the new term is written, the partials read
        }
      }
    }
    if (r + 1 < R) {
      np = sweep_row(c_all + (size_t)(r + 1) * kp, p, cs);
      if (plan == SWEEP_SINGLE) {  // every read of A_r is done: A_{r+1} in its place
        __syncthreads();
        form_rows(a0, DP, cs, kp, mt, D, 0, D, tid, blockDim.x);
      }
    }
    __syncthreads();  // A_{r+1} is formed; row r is done with A_r
  }
  if (owner) {
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < GEMM_CN; ++k)
        if (lr0 + q < rows && col0 + k < D) y[(row0 + lr0 + q) * D + col0 + k] = acc[q][k];
  }
}

// K8's plans and limits (see the note above).
constexpr int BWD_BUFFER = 0, BWD_PANEL = 1;
constexpr int BWD_THREADS = 512;        // up to 128 registers a thread
constexpr int BWD_WIDE_THREADS = 1024;  // one trajectory's K' + 1 chains at D > 292
constexpr int BWD_MAX_TILE = 64;
constexpr int BWD_MAX_GROUPS = 8;       // contraction groups
constexpr int BWD_STAGES = 3;           // BWD_BUFFER: stages of mt's ring
constexpr int BWD_RING_BYTES = 24576;   // one stage at most, but for 4 rows a group

template <typename T>
__host__ __device__ constexpr int bwd_rm_max() { return sizeof(T) == 4 ? 4 : 2; }

// The exponent buffer's row: DP values where DP / 4 is odd, else DP + 4,
// so that the transposed read (a warp's threads on consecutive rows, 16
// bytes each) meets no bank conflict.
__host__ __device__ inline int bwd_as(int D) {
  const int dp = gemm_dp(D);
  return (dp / GEMM_CN) % 2 ? dp : dp + GEMM_CN;
}

// K8's slab rows: DP values where a warp's threads hold one row (D >
// 124), else DP + 4, so that rows a warp writes at once fall in
// different banks.
__host__ __device__ inline int bwd_ts(int D) {
  return gemm_dp(D) / GEMM_CN >= 32 ? gemm_dp(D) : gemm_dp(D) + GEMM_CN;
}

// Rows of mt a stage of BWD_BUFFER's ring carries: a multiple of 4 up to
// 32 whose K' blocks of DP values fill at most BWD_RING_BYTES, and at
// least 4 for each of the ks contraction groups.
template <typename T>
__host__ __device__ inline int bwd_jw(int D, int KP, int ks) {
  int jw = BWD_RING_BYTES / (KP * gemm_dp(D) * (int)sizeof(T)) / 4 * 4;
  jw = jw > 32 ? 32 : jw;
  return jw < 4 * ks ? 4 * ks : jw;
}

// Contraction rows a group of `groups` takes: a multiple of 4.
__host__ __device__ inline int bwd_dk(int n, int groups) {
  return ((n + groups - 1) / groups + 3) / 4 * 4;
}

// K8's shared memory, byte offsets (16-byte aligned): the exponent A_r^T
// (D, AS) or, for BWD_PANEL, one panel of A^T rows and one of A rows (jc,
// DP) each; then slabs of (tile, TS) values: the state x, the cotangent
// a, the K' u terms, the a term, the w term, the w chain's K' actions,
// its running sum, and the later contraction groups' partial products
// ((ks - 1) (2 K' + 1) slabs in phase 2; phase 1's ks1 - 1 start at the
// second u slab); for BWD_BUFFER last the ring of mt's rows, BWD_STAGES
// stages of (jw, K' DP). ops/adjoint.py:bwd_smem_bytes mirrors it.
template <typename T>
struct BwdLayout {
  size_t ab, pa, x, a, tu, ta, tw, yw, sw, red, ring, stage, total, slab;
  __host__ __device__ BwdLayout(int plan, int tile, int KP, int D, int ks, int ks1) {
    slab = align16((size_t)tile * bwd_ts(D) * sizeof(T));
    const size_t panel = align16((size_t)gemm_jc<T>(D) * gemm_dp(D) * sizeof(T));
    stage = plan == BWD_PANEL
                ? 0
                : align16((size_t)bwd_jw<T>(D, KP, ks) * KP * gemm_dp(D) * sizeof(T));
    int nred = (ks - 1) * (2 * KP + 1);
    if (ks1 - 1 - (2 * KP + 2) > nred) nred = ks1 - 1 - (2 * KP + 2);
    size_t at = 0;
    ab = at, at += plan == BWD_PANEL ? panel : align16((size_t)D * bwd_as(D) * sizeof(T));
    pa = at, at += plan == BWD_PANEL ? panel : 0;
    x = at, at += slab;
    a = at, at += slab;
    tu = at, at += KP * slab;
    ta = at, at += slab;
    tw = at, at += slab;
    yw = at, at += KP * slab;
    sw = at, at += slab;
    red = at, at += nred * slab;
    ring = at, at += BWD_STAGES * stage;
    total = at;
  }
};

// BWD_BUFFER's stream of mt's rows (D, K' D) through BWD_STAGES stages in
// shared memory, jw rows a stage, each row K' blocks of DP values (the
// pads stay zero): rows 0 .. D - 1 in order, again for every Taylor term,
// so a later term's first copies overlap this one's products. Every
// thread copies (cp.async) and waits; acquire() returns the next stage
// once every thread's copy of it has landed and reissues the stage every
// thread has finished with (the barrier).
template <typename T>
struct MtRing {
  const T* mt;
  T* base;
  size_t stage;
  int D, DP, kp, jw, npan;
  bool vec;  // 16-byte copies: D a multiple of 4, mt 16-byte aligned
  int nj = 0, ns = 0, cs = 0;

  __device__ MtRing(const T* mt_, T* base_, size_t stage_, int D_, int kp_, int jw_, bool vec_)
      : mt(mt_), base(base_), stage(stage_), D(D_), DP(gemm_dp(D_)), kp(kp_), jw(jw_),
        npan((D_ + jw_ - 1) / jw_), vec(vec_) {}

  __device__ void issue() {
    const int j0 = nj * jw, jn = D - j0 < jw ? D - j0 : jw, ld = kp * D;
    T* dst = base + (size_t)ns * stage;
    const T* src = mt + (size_t)j0 * ld;
    if (vec) {  // DP = D: the stage's rows are mt's
      constexpr int V = 16 / sizeof(T);
      for (int i = threadIdx.x; i < jn * ld / V; i += blockDim.x)
        cp_async<16>(dst + (size_t)i * V, src + (size_t)i * V);
    } else {
      for (int i = threadIdx.x; i < jn * ld; i += blockDim.x) {
        const int jj = i / ld, r = i - jj * ld, k = r / D;
        cp_async<sizeof(T)>(dst + ((size_t)jj * kp + k) * DP + (r - k * D), src + i);
      }
    }
    cp_async_commit();
    if (++nj == npan) nj = 0;
    if (++ns == BWD_STAGES) ns = 0;
  }
  __device__ void prologue() {
    for (int i = 0; i < BWD_STAGES - 1; ++i) issue();
  }
  __device__ const T* acquire() {
    cp_async_wait<BWD_STAGES - 2>();
    __syncthreads();
    issue();
    const T* st = base + (size_t)cs * stage;
    if (++cs == BWD_STAGES) cs = 0;
    return st;
  }
};

// K8's a item's strided columns, as the column map of the kernel's slab
// accessors (put, get, add); an int there is 4 contiguous columns
struct ACols {};
template <typename C>
constexpr bool is_acols = false;
template <>
constexpr bool is_acols<ACols> = true;

template <typename T>
__device__ __forceinline__ void ldg4(const T* p, T (&v)[GEMM_CN]) {
  if constexpr (sizeof(T) == 4) {
    ldg_vec<T, 4>(p, v);
  } else {
    T lo[2], hi[2];
    ldg_vec<T, 2>(p, lo);
    ldg_vec<T, 2>(p + 2, hi);
    v[0] = lo[0], v[1] = lo[1], v[2] = hi[0], v[3] = hi[1];
  }
}

// y[q][c] = fma(L[q LS + j], b_j[c], y[q][c]) for j = 0 .. jn - 1 in
// order: RM rows of a row-major term (L at the first row and contraction
// index, 16-byte aligned) against 4 columns of a right operand, whose row
// j load(j, b_j) reads (smem_rows, ldg_rows).
template <typename T, int RM, typename Load>
__device__ __forceinline__ void mm_rows(const T* L, int LS, int jn, const Load& load,
                                        T (&y)[RM][GEMM_CN]) {
  int j = 0;
#pragma unroll 1
  for (; j + 4 <= jn; j += 4) {
    T lv[RM][4];
#pragma unroll
    for (int q = 0; q < RM; ++q) lds_vec<T, 4>(L + (size_t)q * LS + j, lv[q]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      T bv[GEMM_CN];
      load(j + u, bv);
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int c = 0; c < GEMM_CN; ++c) y[q][c] = fma_full(lv[q][u], bv[c], y[q][c]);
    }
  }
  for (; j < jn; ++j) {
    T bv[GEMM_CN];
    load(j, bv);
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int c = 0; c < GEMM_CN; ++c) y[q][c] = fma_full(L[(size_t)q * LS + j], bv[c], y[q][c]);
  }
}

// mm_rows' right operands: 4 contiguous columns (B at the first column of
// row 0, BS values a row) in shared memory, or in device memory with
// 16-byte loads where vec, else the ncol < 4 columns that exist (zeros
// past them).
template <typename T>
__device__ __forceinline__ auto smem_rows(const T* B, int BS) {
  return [=](int j, T (&bv)[GEMM_CN]) { lds_vec<T, GEMM_CN>(B + (size_t)j * BS, bv); };
}

template <typename T>
__device__ __forceinline__ auto ldg_rows(const T* __restrict__ B, size_t BS, bool vec, int ncol) {
  return [=](int j, T (&bv)[GEMM_CN]) {
    const T* src = B + (size_t)j * BS;
    if (vec) {
      ldg4(src, bv);
    } else {
#pragma unroll
      for (int c = 0; c < GEMM_CN; ++c) bv[c] = c < ncol ? __ldg(src + c) : T(0);
    }
  };
}

// y[q][i] = fma(L[q LS + j], A[crow_i AS + j], y[q][i]) for j = 0 .. D - 1
// in order: the product with the transpose of the buffer A (rows crow_i,
// 16-byte loads along j).
template <typename T, int RM>
__device__ __forceinline__ void mm_dot(const T* L, int LS, const T* A, int AS,
                                       const int (&crow)[GEMM_CN], int D, T (&y)[RM][GEMM_CN]) {
  int j = 0;
#pragma unroll 1
  for (; j + 4 <= D; j += 4) {
    T lv[RM][4], bv[GEMM_CN][4];
#pragma unroll
    for (int q = 0; q < RM; ++q) lds_vec<T, 4>(L + (size_t)q * LS + j, lv[q]);
#pragma unroll
    for (int i = 0; i < GEMM_CN; ++i) lds_vec<T, 4>(A + (size_t)crow[i] * AS + j, bv[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int i = 0; i < GEMM_CN; ++i) y[q][i] = fma_full(lv[q][u], bv[i][u], y[q][i]);
  }
  for (; j < D; ++j)
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int i = 0; i < GEMM_CN; ++i)
        y[q][i] = fma_full(L[(size_t)q * LS + j], A[(size_t)crow[i] * AS + j], y[q][i]);
}

// K8 (see the note above). Phase 2: thread t < ks (K' + 1) per, per =
// tile / RM * ncg, is contraction group t / ((K' + 1) per) of item (g,
// rows [lr0, lr0 + RM), column group cg): the u_g chain and W_g w for
// g < K', the a chain and w's running sum for g = K'. Phase 1: thread
// t < ks1 per is group t / per of an x item. Group 0 owns an item's
// running sums and adds the later groups' partial products in group
// order.
template <typename T, int RM, int NT>
__global__ void __launch_bounds__(NT, 1)
adjoint_sweep_bwd_kernel(const T* __restrict__ c_all, int R, const T* __restrict__ x,
                         const T* __restrict__ a, const T* __restrict__ mt,
                         const T* __restrict__ ms, T* __restrict__ a0, T* __restrict__ part,
                         int B, int D, int tile, int plan, int ks, int ks1, AdjParams<T> p) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int kp = p.KP;
  const BwdLayout<T> L(plan, tile, kp, D, ks, ks1);
  auto at = [&](size_t off) { return reinterpret_cast<T*>(bwd_smem + off); };
  T* const ab = at(L.ab);  // A_r^T (D, AS), or a panel of its rows (jc, DP)
  T* const pa = at(L.pa);  // BWD_PANEL: the panel's rows of A
  T* const X = at(L.x);    // x, x_n after phase 1
  T* const Aa = at(L.a);   // a, a_n at the end of the row
  T* const Tu = at(L.tu);  // the u_k terms; the x term in phase 1
  T* const Ta = at(L.ta);
  T* const Tw = at(L.tw);
  T* const Yw = at(L.yw);  // W_k w (group 0's); then cbar's partials (K', tile, ncg)
  T* const Sw = at(L.sw);  // w's running sum
  T* const R1 = at(L.red);  // later groups' A u_k and A^T a: (ks - 1, K' + 1) slabs
  const size_t slab = L.slab / sizeof(T);
  T* const R2 = R1 + (size_t)(ks - 1) * (kp + 1) * slab;  // their W_k w: (ks - 1, K')
  T* const P1 = Tu + slab;  // phase 1's later groups' partial products
  const bool panel = plan == BWD_PANEL;
  const int DP = gemm_dp(D), TS = bwd_ts(D), AS = bwd_as(D), ncg = DP / GEMM_CN;
  const int jc = panel ? gemm_jc<T>(D) : D, BS = panel ? DP : AS;
  const int tid = threadIdx.x, nt = blockDim.x, per = tile / RM * ncg;
  const int nitem = (kp + 1) * per;
  // phase 2's item and group
  const int kg = tid / nitem, it = tid % nitem;
  const int g = kg < ks ? it / per : kp + 1;
  const int lr0 = it % per / ncg * RM, cg = it % per % ncg, col0 = cg * GEMM_CN;
  const bool is_u = g < kp, is_a = g == kp, own = kg == 0;
  const size_t off = (size_t)lr0 * TS;
  // phase 1's
  const int kg1 = tid / per;
  const bool on1 = kg1 < ks1, own1 = kg1 == 0;
  const size_t off1 = (size_t)(tid % per / ncg * RM) * TS;
  const int col1 = tid % per % ncg * GEMM_CN;
  const int dk1 = bwd_dk(D, ks1), lo1 = kg1 * dk1 < D ? kg1 * dk1 : D;
  const int hi1 = lo1 + dk1 < D ? lo1 + dk1 : D;
  const int dk2 = bwd_dk(D, ks), lo2 = kg * dk2 < D ? kg * dk2 : D;
  const int hi2 = lo2 + dk2 < D ? lo2 + dk2 : D;
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  const bool vec = D % GEMM_CN == 0 && (size_t)mt % 16 == 0;
  // the a item's columns: strided for the transposed read of the buffer,
  // contiguous over BWD_PANEL's rows of A
  int acol[GEMM_CN], crow[GEMM_CN];
#pragma unroll
  for (int i = 0; i < GEMM_CN; ++i) {
    acol[i] = panel ? col0 + i : cg + i * ncg;
    crow[i] = acol[i] < D ? acol[i] : 0;
  }
  T* const tu = Tu + (size_t)(is_u ? g : 0) * slab;  // this item's u slab

  // every value starts at zero: the pads past D stay zero
  for (size_t i = tid; i < L.total / sizeof(T); i += nt) at(0)[i] = T(0);
  __syncthreads();
  MtRing<T> ring(mt, at(L.ring), L.stage / sizeof(T), D, kp, bwd_jw<T>(D, kp, ks), vec);
  if (!panel) ring.prologue();
  for (size_t e = tid; e < (size_t)rows * D; e += nt) {
    const size_t lr = e / D, c = e - lr * D;
    X[lr * TS + c] = x[row0 * D + e];
    Aa[lr * TS + c] = a[row0 * D + e];
  }

  T y1[RM][GEMM_CN], y2[RM][GEMM_CN], acc[RM][GEMM_CN];
  // an item's values in a slab from row offset o: 4 contiguous columns
  // from c0 (16-byte accesses), or the a item's strided columns acol
  // (ACols{}; zero stored past D)
  auto ld_row = [&](const T* src, auto c0, T (&v)[GEMM_CN]) {
    if constexpr (is_acols<decltype(c0)>) {
#pragma unroll
      for (int i = 0; i < GEMM_CN; ++i) v[i] = src[acol[i]];
    } else {
      lds_vec<T, GEMM_CN>(src + c0, v);
    }
  };
  auto put = [&](T* dst, size_t o, auto c0, const T (&v)[RM][GEMM_CN]) {
#pragma unroll
    for (int q = 0; q < RM; ++q) {
      T* d = dst + o + (size_t)q * TS;
      if constexpr (is_acols<decltype(c0)>) {
#pragma unroll
        for (int i = 0; i < GEMM_CN; ++i) d[acol[i]] = acol[i] < D ? v[q][i] : T(0);
      } else {
        sts_vec4(d + c0, v[q]);
      }
    }
  };
  auto get = [&](const T* src, size_t o, auto c0, T (&v)[RM][GEMM_CN]) {
#pragma unroll
    for (int q = 0; q < RM; ++q) ld_row(src + o + (size_t)q * TS, c0, v[q]);
  };
  auto add = [&](const T* src, size_t o, auto c0, T (&v)[RM][GEMM_CN]) {
#pragma unroll
    for (int q = 0; q < RM; ++q) {
      T pv[GEMM_CN];
      ld_row(src + o + (size_t)q * TS, c0, pv);
#pragma unroll
      for (int c = 0; c < GEMM_CN; ++c) v[q][c] = v[q][c] + pv[c];
    }
  };
  T cs[ADJ_MAX_KP];
  // The products of one Taylor term over the exponent: body(j0, jn, Bt)
  // with Bt its row j0 (row stride BS); BWD_PANEL forms the panels of rows
  // [j0, j0 + jn) first (of A^T, and of A when with_a).
  auto over_exponent = [&](bool with_a, auto&& body) {
    if (!panel) {
      body(0, D, ab);
      return;
    }
    for (int j0 = 0; j0 < D; j0 += jc) {
      const int jn = D - j0 < jc ? D - j0 : jc;
      __syncthreads();  // every read of the last panels is done
      form_rows(ab, DP, cs, kp, mt, D, j0, jn, tid, nt);
      if (with_a) form_rows(pa, DP, cs, kp, ms, D, j0, jn, tid, nt);
      __syncthreads();
      body(j0, jn, ab);
    }
  };

  for (int r = R - 1; r >= 0; --r) {
    const int np = sweep_row(c_all + (size_t)r * kp, p, cs);
    const T sc = T(1) / T(np);  // 2^-s, exact
    __syncthreads();  // the last row's a_n and cbar reads are done
    if (!panel) form_rows(ab, AS, cs, kp, mt, D, 0, D, tid, nt);

    // phase 1: x_n = e^{-A} x
    if (own1) get(X, off1, col1, acc);
    for (int pass = 0; pass < np; ++pass) {
      if (own1) put(Tu, off1, col1, acc);
      __syncthreads();  // the pass's start term (and the exponent) is written
      for (int kk = 1; kk <= p.m; ++kk) {
        tile_zero<T, RM>(y1);
        over_exponent(false, [&](int j0, int jn, const T* Bt) {
          if (!on1) return;
          if (panel)
            mm_rows<T, RM>(Tu + off1 + j0, TS, jn, smem_rows(Bt + col1, BS), y1);
          else if (hi1 > lo1)
            mm_rows<T, RM>(Tu + off1 + lo1, TS, hi1 - lo1,
                           smem_rows(ab + (size_t)lo1 * AS + col1, AS), y1);
        });
        if (on1 && !own1) put(P1 + (size_t)(kg1 - 1) * slab, off1, col1, y1);
        __syncthreads();  // every read of the term is done, the partials written
        if (own1) {
          for (int q = 1; q < ks1; ++q) add(P1 + (size_t)(q - 1) * slab, off1, col1, y1);
          const T rj = T(1) / T(kk);
#pragma unroll
          for (int q = 0; q < RM; ++q)
#pragma unroll
            for (int c = 0; c < GEMM_CN; ++c) {
              y1[q][c] = -y1[q][c] * rj;
              acc[q][c] = acc[q][c] + y1[q][c];
            }
          put(Tu, off1, col1, y1);
        }
        __syncthreads();  // the new term is written
      }
    }
    if (own1) put(X, off1, col1, acc);
    __syncthreads();  // x_n is written

    // phase 2: u_k from u = 0, w from x_n; a_n from a
    if (own && is_u) tile_zero<T, RM>(acc);
    if (own && is_a) get(Aa, off, ACols{}, acc);
    for (int e = tid; e < tile * D; e += nt) Sw[e / D * TS + e % D] = X[e / D * TS + e % D];
    for (int pass = 0; pass < np; ++pass) {
      if (own && is_u) put(tu, off, col0, acc);
      if (own && is_a) put(Ta, off, ACols{}, acc);
      __syncthreads();  // Sw is written (pass 0), or the last term's
      for (int e = tid; e < tile * D; e += nt) Tw[e / D * TS + e % D] = Sw[e / D * TS + e % D];
      __syncthreads();  // the pass's start terms are written
      for (int kk = 1; kk <= p.m; ++kk) {
        // W_g w: from the ring of mt's rows, each group its share of a
        // stage's rows (BWD_PANEL: from L2, one group)
        tile_zero<T, RM>(y2);
        if (panel) {
          if (is_u)
            mm_rows<T, RM>(Tw + off, TS, D,
                           ldg_rows(mt + (size_t)g * D + col0, (size_t)kp * D, vec, D - col0), y2);
        } else {
          for (int j0 = 0; j0 < D; j0 += ring.jw) {
            const T* st = ring.acquire();
            const int jn = D - j0 < ring.jw ? D - j0 : ring.jw, sub = bwd_dk(jn, ks);
            const int lo = kg * sub < jn ? kg * sub : jn, hi = lo + sub < jn ? lo + sub : jn;
            if (is_u && hi > lo)
              mm_rows<T, RM>(Tw + off + j0 + lo, TS, hi - lo,
                             smem_rows(st + (size_t)lo * kp * DP + (size_t)g * DP + col0, kp * DP),
                             y2);
          }
        }
        if (is_u) put(own ? Yw + (size_t)g * slab : R2 + ((size_t)(kg - 1) * kp + g) * slab, off,
                      col0, y2);
        // A u_g, and A^T a
        tile_zero<T, RM>(y1);
        over_exponent(true, [&](int j0, int jn, const T* Bt) {
          if (is_u) {
            if (panel)
              mm_rows<T, RM>(tu + off + j0, TS, jn, smem_rows(Bt + col0, BS), y1);
            else if (hi2 > lo2)
              mm_rows<T, RM>(tu + off + lo2, TS, hi2 - lo2,
                             smem_rows(ab + (size_t)lo2 * AS + col0, AS), y1);
          } else if (is_a) {
            if (panel)
              mm_rows<T, RM>(Ta + off + j0, TS, jn, smem_rows(pa + col0, DP), y1);
            else if (hi2 > lo2)
              mm_dot<T, RM>(Ta + off + lo2, TS, ab + lo2, AS, crow, hi2 - lo2, y1);
          }
        });
        if (!own && is_u) put(R1 + ((size_t)(kg - 1) * (kp + 1) + g) * slab, off, col0, y1);
        if (!own && is_a) put(R1 + ((size_t)(kg - 1) * (kp + 1) + kp) * slab, off, ACols{}, y1);
        __syncthreads();  // every read of the terms is done, the partials written
        const T rj = T(1) / T(kk);  // the term's scale, RN(1/j)
        if (own && is_u) {
          get(Yw + (size_t)g * slab, off, col0, y2);
          for (int q = 1; q < ks; ++q) {
            add(R1 + ((size_t)(q - 1) * (kp + 1) + g) * slab, off, col0, y1);
            add(R2 + ((size_t)(q - 1) * kp + g) * slab, off, col0, y2);
          }
#pragma unroll
          for (int q = 0; q < RM; ++q)
#pragma unroll
            for (int c = 0; c < GEMM_CN; ++c) {
              y1[q][c] = add_rn(y1[q][c], mul_rn(sc, y2[q][c])) * rj;
              acc[q][c] = acc[q][c] + y1[q][c];
            }
          put(tu, off, col0, y1);
        } else if (own && is_a) {
          for (int q = 1; q < ks; ++q)
            add(R1 + ((size_t)(q - 1) * (kp + 1) + kp) * slab, off, ACols{}, y1);
#pragma unroll
          for (int q = 0; q < RM; ++q)
#pragma unroll
            for (int i = 0; i < GEMM_CN; ++i) {
              y1[q][i] = y1[q][i] * rj;
              acc[q][i] = acc[q][i] + y1[q][i];
            }
          put(Ta, off, ACols{}, y1);
        }
        // w' = (A w) RN(1/j), A w = sum_k cs_k W_k w in k order, each W_k w
        // summed over the groups in order: elementwise, by every thread
        for (int e = tid; e < tile * D; e += nt) {
          const size_t o = (size_t)(e / D) * TS + e % D;
          T w = T(0);
          for (int k = 0; k < kp; ++k) {
            T yk = Yw[(size_t)k * slab + o];
            for (int h = 1; h < ks; ++h) yk = yk + R2[((size_t)(h - 1) * kp + k) * slab + o];
            w = k == 0 ? mul_rn(cs[0], yk) : add_rn(w, mul_rn(cs[k], yk));
          }
          w = w * rj;
          Tw[o] = w;
          Sw[o] = Sw[o] + w;
        }
        __syncthreads();  // the new terms are written
      }
    }

    // cbar_k = <a, u_k>: per u item over its columns, then over the column
    // groups and the block's trajectories in order
    T* const red = Yw;  // (K', tile, ncg)
    if (own && is_u) {
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        T sum = T(0);
#pragma unroll
        for (int c = 0; c < GEMM_CN; ++c)
          if (col0 + c < D) sum = add_rn(sum, mul_rn(Aa[off + (size_t)q * TS + col0 + c], acc[q][c]));
        red[((size_t)g * tile + lr0 + q) * ncg + cg] = sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < kp * tile; i += nt) {  // per trajectory, into Sw
      const T* pr = red + (size_t)i * ncg;
      T ck = T(0);
      for (int c = 0; c < ncg; ++c) ck = add_rn(ck, pr[c]);
      Sw[i] = ck;
    }
    __syncthreads();
    for (int k = tid; k < kp; k += nt) {
      T sum = T(0);
      for (int lr = 0; lr < rows; ++lr) sum = add_rn(sum, Sw[(size_t)k * tile + lr]);
      part[((size_t)blockIdx.x * R + r) * kp + k] = sum;
    }
    if (own && is_a) put(Aa, off, ACols{}, acc);  // a_n is the next row's cotangent
  }
  cp_async_wait<0>();
  __syncthreads();
  for (size_t e = tid; e < (size_t)rows * D; e += nt) {
    const size_t lr = e / D;
    a0[row0 * D + e] = Aa[lr * TS + (e - lr * D)];
  }
}

// K6's launch geometry.
template <typename T>
struct Geometry {
  int tile, blocks, threads;
  size_t smem;
};

template <typename T>
int geometry(int B, int D, int KP, Geometry<T>* g) {
  int dev = 0, max_smem = 0, n_sm = 0;
  const cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  g->tile = adj_tile<T>(B, D, KP, n_sm, max_smem);
  const int ncg = (D + CT - 1) / CT;
  const int items = (KP + 1) * g->tile * ncg;
  g->threads = (items + 31) / 32 * 32;
  g->smem = adj_smem_bytes<T>(g->tile, D, KP);
  g->blocks = (B + g->tile - 1) / g->tile;
  if (g->threads > ADJ_MAX_THREADS || g->smem > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int KP, bool WIDE>
int launch_bwd(const Geometry<T>& g, const void* c, const void* x, const void* a,
               const void* mt, const void* ms, void* xn, void* an, void* cb, int B, int D,
               const AdjParams<T>& p, void* stream) {
  const int rc = allow_smem(adjoint_bwd_kernel<T, KP, WIDE>, g.smem);
  if (rc != 0) return rc;
  adjoint_bwd_kernel<T, KP, WIDE><<<g.blocks, g.threads, g.smem, (cudaStream_t)stream>>>(
      (const T*)c, (const T*)x, (const T*)a, (const T*)mt, (const T*)ms, (T*)xn, (T*)an, (T*)cb,
      B, D, g.tile, p);
  return (int)cudaGetLastError();
}

template <typename T, int KP>
int run_bwd(const void* c, const void* x, const void* a, const void* mt, const void* ms,
            void* xn, void* an, void* cb, int B, int D, const AdjParams<T>& p, void* stream) {
  Geometry<T> g;
  const int rc = geometry<T>(B, D, KP, &g);
  if (rc != 0) return rc;
  return g.threads > ADJ_NARROW_THREADS
             ? launch_bwd<T, KP, true>(g, c, x, a, mt, ms, xn, an, cb, B, D, p, stream)
             : launch_bwd<T, KP, false>(g, c, x, a, mt, ms, xn, an, cb, B, D, p, stream);
}

// K7's launch shape (see the note above): trajectories per block (the
// largest power of two up to SWEEP_MAX_TILE leaving n_sm / 2 blocks),
// rows per thread (the least power of two up to 8 in f32, 4 in
// f64, that keeps the product threads within GEMM_THREADS), the plan (the
// first of SWEEP_DOUBLE, SWEEP_SINGLE, SWEEP_PANEL whose shared memory
// fits), the tile halved while none does. ops/adjoint.py:sweep_plan
// mirrors it.
struct SweepShape {
  int plan, tile, rm, ks, nc, threads, blocks;
  size_t smem;
};

template <typename T>
int sweep_shape(int B, int D, int n_sm, size_t max_smem, SweepShape* s) {
  const int ncg = gemm_dp(D) / GEMM_CN, rm_max = sizeof(T) == 4 ? 8 : 4;
  int tile = SWEEP_MAX_TILE;
  while (tile > 1 && (B + tile - 1) / tile < n_sm / 2) tile /= 2;
  for (;;) {
    int rm = 1;
    while (rm < rm_max && rm < tile && (tile / rm) * ncg > GEMM_THREADS) rm *= 2;
    const int per = (tile / rm) * ncg;
    if (per <= GEMM_THREADS) {
      for (int plan = SWEEP_DOUBLE; plan <= SWEEP_PANEL; ++plan) {
        int ks = 1;  // contraction groups: up to 8 of at least 16 indices each
        while (plan != SWEEP_PANEL && ks < 8 && 2 * ks * per <= GEMM_THREADS && D >= 32 * ks)
          ks *= 2;
        const size_t smem = SweepLayout<T>(plan, tile, ks, D).total;
        if (smem > max_smem) continue;
        s->plan = plan, s->tile = tile, s->rm = rm, s->ks = ks, s->smem = smem;
        s->nc = (ks * per + 31) / 32 * 32;
        s->threads = s->nc + (plan == SWEEP_DOUBLE ? 32 * SWEEP_PRODUCER_WARPS : 0);
        s->blocks = (B + tile - 1) / tile;
        return 0;
      }
    }
    if (tile == 1) return (int)cudaErrorInvalidValue;
    tile /= 2;
  }
}

template <typename T, int RM>
int launch_sweep_fwd(const SweepShape& s, const void* c_all, int R, const void* x,
                     const void* mt, void* y, int B, int D, const AdjParams<T>& p, void* stream) {
  const int rc = allow_smem(adjoint_sweep_gemm_kernel<T, RM>, s.smem);
  if (rc != 0) return rc;
  adjoint_sweep_gemm_kernel<T, RM><<<s.blocks, s.threads, s.smem, (cudaStream_t)stream>>>(
      (const T*)c_all, R, (const T*)x, (const T*)mt, (T*)y, B, D, s.tile, s.ks, s.nc, s.plan,
      p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_sweep_fwd(const void* c_all, int R, const void* x, const void* mt, void* y, int B,
                  int D, const AdjParams<T>& p, void* stream) {
  int dev = 0, max_smem = 0, n_sm = 0;
  const cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  SweepShape s;
  const int rc = sweep_shape<T>(B, D, n_sm, (size_t)max_smem, &s);
  if (rc != 0) return rc;
  switch (s.rm) {
    case 1: return launch_sweep_fwd<T, 1>(s, c_all, R, x, mt, y, B, D, p, stream);
    case 2: return launch_sweep_fwd<T, 2>(s, c_all, R, x, mt, y, B, D, p, stream);
    case 4: return launch_sweep_fwd<T, 4>(s, c_all, R, x, mt, y, B, D, p, stream);
    default:
      if constexpr (sizeof(T) == 4)
        return launch_sweep_fwd<T, 8>(s, c_all, R, x, mt, y, B, D, p, stream);
      return (int)cudaErrorInvalidValue;
  }
}

// K8's launch shape (see the note above): the first plan of BWD_BUFFER,
// BWD_PANEL with a tile that fits; the tile from the batch (the largest
// power of two up to BWD_MAX_TILE leaving n_sm / 2 blocks), halved while
// the block (BWD_THREADS; BWD_WIDE_THREADS at one trajectory) or its
// shared memory does not fit; rows per thread RM the tile's, at most 4 in
// f32 and 2 in f64; for BWD_BUFFER ks contraction groups in phase 2 (doubled
// while the block stays within its threads and each group keeps 32
// indices, halved while their scratch does not fit) and ks1 in phase 1
// (as many as the block's threads hold, up to BWD_MAX_GROUPS).
// ops/adjoint.py:bwd_plan mirrors it.
struct BwdShape {
  int plan, tile, rm, ks, ks1, threads, blocks, bound;
  size_t smem;
};

template <typename T>
int bwd_shape(int B, int D, int KP, int n_sm, size_t max_smem, BwdShape* s) {
  const int ncg = gemm_dp(D) / GEMM_CN;
  int start = BWD_MAX_TILE;
  while (start > 1 && (B + start - 1) / start < n_sm / 2) start /= 2;
  for (int plan = BWD_BUFFER; plan <= BWD_PANEL; ++plan) {
    for (int tile = start;; tile /= 2) {
      const int rm = tile < bwd_rm_max<T>() ? tile : bwd_rm_max<T>();
      const int cap = BWD_THREADS;
      const int per = tile / rm * ncg, items = (KP + 1) * per;
      int ks = 1;
      while (plan == BWD_BUFFER && ks < BWD_MAX_GROUPS && 2 * ks * items <= cap && D >= 64 * ks)
        ks *= 2;
      for (; ks >= 1; ks /= 2) {  // fewer groups where their scratch does not fit
        const int threads = (ks * items + 31) / 32 * 32;
        int ks1 = plan == BWD_BUFFER ? threads / per : 1;
        ks1 = ks1 > BWD_MAX_GROUPS ? BWD_MAX_GROUPS : ks1;
        const int bound = threads <= cap ? cap : BWD_WIDE_THREADS;
        const size_t smem = BwdLayout<T>(plan, tile, KP, D, ks, ks1).total;
        if (smem <= max_smem && (threads <= cap || (tile == 1 && threads <= BWD_WIDE_THREADS))) {
          *s = BwdShape{plan, tile, rm, ks, ks1, threads, (B + tile - 1) / tile, bound, smem};
          return 0;
        }
      }
      if (tile == 1) break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_shape_here(int B, int D, int KP, BwdShape* s) {
  int dev = 0, max_smem = 0, n_sm = 0;
  const cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  return bwd_shape<T>(B, D, KP, n_sm, (size_t)max_smem, s);
}

template <typename T, int RM, int NT>
int launch_sweep_bwd(const BwdShape& s, const void* c_all, int R, const void* x, const void* a,
                     const void* mt, const void* ms, void* a0, void* part, int B, int D,
                     const AdjParams<T>& p, void* stream) {
  const int rc = allow_smem(adjoint_sweep_bwd_kernel<T, RM, NT>, s.smem);
  if (rc != 0) return rc;
  adjoint_sweep_bwd_kernel<T, RM, NT><<<s.blocks, s.threads, s.smem, (cudaStream_t)stream>>>(
      (const T*)c_all, R, (const T*)x, (const T*)a, (const T*)mt, (const T*)ms, (T*)a0, (T*)part,
      B, D, s.tile, s.plan, s.ks, s.ks1, p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_sweep_bwd(const void* c_all, int R, const void* x, const void* a, const void* mt,
                  const void* ms, void* a0, void* part, int B, int D, const AdjParams<T>& p,
                  void* stream) {
  BwdShape s;
  const int rc = bwd_shape_here<T>(B, D, p.KP, &s);
  if (rc != 0) return rc;
#define ARGS s, c_all, R, x, a, mt, ms, a0, part, B, D, p, stream
  if (s.bound == BWD_WIDE_THREADS) return launch_sweep_bwd<T, 1, BWD_WIDE_THREADS>(ARGS);
  if (s.rm == 1) return launch_sweep_bwd<T, 1, BWD_THREADS>(ARGS);
  if (s.rm == 2) return launch_sweep_bwd<T, 2, BWD_THREADS>(ARGS);
  if constexpr (sizeof(T) == 4) {
    if (s.rm == 4) return launch_sweep_bwd<T, 4, BWD_THREADS>(ARGS);
  }
  return (int)cudaErrorInvalidValue;
#undef ARGS
}

// Dispatches f<KP>() over the instantiated working-basis sizes.
#define ADJ_DISPATCH(KP, CALL)                           \
  switch (KP) {                                          \
    case 1: return CALL(1);                              \
    case 2: return CALL(2);                              \
    case 3: return CALL(3);                              \
    case 4: return CALL(4);                              \
    case 5: return CALL(5);                              \
    case 6: return CALL(6);                              \
    default: return (int)cudaErrorInvalidValue;          \
  }

template <typename T>
int bwd(const void* c, const void* x, const void* a, const void* mt, const void* ms, void* xn,
        void* an, void* cb, int B, int D, int KP, const double* norms, int m, double theta,
        int max_sq, void* stream) {
  if (!params_ok(B, D, KP, m, max_sq)) return (int)cudaErrorInvalidValue;
  const AdjParams<T> p = parse<T>(KP, norms, m, theta, max_sq);
#define CALL(K) run_bwd<T, K>(c, x, a, mt, ms, xn, an, cb, B, D, p, stream)
  ADJ_DISPATCH(KP, CALL)
#undef CALL
}

template <typename T>
int sweep_fwd(const void* c_all, int R, const void* x, const void* mt, void* y, int B, int D,
              int KP, const double* norms, int m, double theta, int max_sq, void* stream) {
  if (!params_ok(B, D, KP, m, max_sq) || R < 0) return (int)cudaErrorInvalidValue;
  return run_sweep_fwd<T>(c_all, R, x, mt, y, B, D, parse<T>(KP, norms, m, theta, max_sq),
                          stream);
}

template <typename T>
int sweep_bwd(const void* c_all, int R, const void* x, const void* a, const void* mt,
              const void* ms, void* a0, void* part, int B, int D, int KP, const double* norms,
              int m, double theta, int max_sq, void* stream) {
  if (!params_ok(B, D, KP, m, max_sq) || R < 0) return (int)cudaErrorInvalidValue;
  return run_sweep_bwd<T>(c_all, R, x, a, mt, ms, a0, part, B, D,
                          parse<T>(KP, norms, m, theta, max_sq), stream);
}

}  // namespace

extern "C" {

// The blocks K8 launches for B trajectories of width D over K' = KP terms
// in elements of elem_bytes (4 or 8): it writes one (R, KP) partial per
// block. Negative on an error.
int vec_ode_adjoint_blocks(int B, int D, int KP, int elem_bytes) {
  if (!params_ok(B, D, KP, 1, 0) || (elem_bytes != 4 && elem_bytes != 8)) return -1;
  BwdShape s;
  const int rc = elem_bytes == 4 ? bwd_shape_here<float>(B, D, KP, &s)
                                 : bwd_shape_here<double>(B, D, KP, &s);
  return rc != 0 ? -rc : s.blocks;
}

// K6: c (B, KP) per-lane rows, x and a (B, D), mt = [W_0^T | ...] and
// ms = [W_0 | ...] (D, KP*D); writes xn, an (B, D) and cb (B, KP). norms:
// the KP values ||W_k||_1 in host memory.
int vec_ode_adjoint_bwd_f32(const void* c, const void* x, const void* a, const void* mt,
                            const void* ms, void* xn, void* an, void* cb, int B, int D, int KP,
                            const double* norms, int m, double theta, int max_sq, void* stream) {
  return bwd<float>(c, x, a, mt, ms, xn, an, cb, B, D, KP, norms, m, theta, max_sq, stream);
}

int vec_ode_adjoint_bwd_f64(const void* c, const void* x, const void* a, const void* mt,
                            const void* ms, void* xn, void* an, void* cb, int B, int D, int KP,
                            const double* norms, int m, double theta, int max_sq, void* stream) {
  return bwd<double>(c, x, a, mt, ms, xn, an, cb, B, D, KP, norms, m, theta, max_sq, stream);
}

// K7: c_all (R, KP) rows, x (B, D); writes y (B, D).
int vec_ode_adjoint_sweep_fwd_f32(const void* c_all, int R, const void* x, const void* mt,
                                  void* y, int B, int D, int KP, const double* norms, int m,
                                  double theta, int max_sq, void* stream) {
  return sweep_fwd<float>(c_all, R, x, mt, y, B, D, KP, norms, m, theta, max_sq, stream);
}

int vec_ode_adjoint_sweep_fwd_f64(const void* c_all, int R, const void* x, const void* mt,
                                  void* y, int B, int D, int KP, const double* norms, int m,
                                  double theta, int max_sq, void* stream) {
  return sweep_fwd<double>(c_all, R, x, mt, y, B, D, KP, norms, m, theta, max_sq, stream);
}

// K8: c_all (R, KP), x and a (B, D) the final state and its cotangent;
// writes a0 (B, D) and part (blocks, R, KP), blocks from
// vec_ode_adjoint_blocks(B, D, KP, sizeof(T)).
int vec_ode_adjoint_sweep_bwd_f32(const void* c_all, int R, const void* x, const void* a,
                                  const void* mt, const void* ms, void* a0, void* part, int B,
                                  int D, int KP, const double* norms, int m, double theta,
                                  int max_sq, void* stream) {
  return sweep_bwd<float>(c_all, R, x, a, mt, ms, a0, part, B, D, KP, norms, m, theta, max_sq,
                          stream);
}

int vec_ode_adjoint_sweep_bwd_f64(const void* c_all, int R, const void* x, const void* a,
                                  const void* mt, const void* ms, void* a0, void* part, int B,
                                  int D, int KP, const double* norms, int m, double theta,
                                  int max_sq, void* stream) {
  return sweep_bwd<double>(c_all, R, x, a, mt, ms, a0, part, B, D, KP, norms, m, theta, max_sq,
                           stream);
}

}  // extern "C"
