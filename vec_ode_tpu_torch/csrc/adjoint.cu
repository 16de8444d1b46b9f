// The reversible adjoint's kernels for modulated linear ODEs, written by
// hand for Hopper (sm_90a). They replace three Pallas TPU kernels of
// vec_ode_tpu/ops/pallas_expmv.py:
//   K6 adjoint_bwd_pallas (pallas_call at :474): one reverse row with
//      per-lane rows c (B, K'), one squaring count per lane;
//   K7 adjoint_sweep_fwd_pallas (:566): all R rows of a fixed-step forward,
//      y = e^{A_{R-1}} ... e^{A_0} x, rows c_all (R, K') shared by the batch;
//   K8 adjoint_sweep_bwd_pallas (:643): the whole reverse sweep, a0 and the
//      coefficient cotangents of every row.
// The reverse row is adjoint_row.cuh's adjoint_row_tile (its note has what
// it computes, the layout and the precision rules); K7 runs its forward
// chain alone. In K7 and K8 each block carries its trajectories through
// all R rows in one launch; the rows are shared, so every block takes the
// same count per row (one per row, ops/adjoint.py, not the TPU kernels'
// single count over all rows) and no row waits masked. K8 writes one
// batch-summed (R, K') partial per block, which the wrapper sums in block
// order: no atomics, so the gradients do not change from run to run.
//
// What bounds them: FP32 (or FP64) FMA throughput, by the work the rows
// need. At the path's 256 trajectories of 64-dim complex (D = 128) with
// K' = 3 in f32: the backward runs the a-chain and the K'^2 + K' Fréchet
// actions per term (six chains' worth at K' = 3; the Pallas kernel's
// K'^2 + 2K' would be seven), 312.9 GFLOP with the combinations and cbar,
// 4.67 ms at the card's 67 TFLOP/s FP32 (non-tensor) rate. K6 and K8: a
// block takes two trajectories (adj_tile), a row's K' + 1 Fréchet chains
// side by side in K' + 1 thread groups, blocks of up to 256 threads at
// 128 registers a thread, the basis read from L2 at every term.
//
// K7's design. The rows are shared by the batch, so the function needs
// the exponent once per row: y = e^{A_{R-1}} ... e^{A_0} x with A_r =
// sum_k c_{r,k} 2^-s_r W_k formed once (K' D^2 operations) and then one
// (D, D) action per Taylor term, 17.34 GFLOP for the path's 256 rows
// (0.26 ms at the FP32 rate: FMA throughput bounds it), not
// the 51.5 GFLOP of K' actions per term that the TPU kernel and K7's
// first version ran. That version took 30.33 ms at 256 x 64c on an H100
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

// The scaling of row `c` (shared by the tile, or lane lr's own) for every
// trajectory of the tile; rows past the batch get no passes.
template <typename T>
__device__ void scale_tile(const T* __restrict__ c, bool per_lane, long row0, int rows, int tile,
                           const AdjSmem<T>& s, const AdjParams<T>& p) {
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    T row[ADJ_MAX_KP];
    const bool ok = lr < rows;
    for (int k = 0; k < p.KP; ++k)
      row[k] = !ok ? T(0) : per_lane ? c[(row0 + lr) * p.KP + k] : c[k];
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
  const AdjSmem<T> s = AdjSmem<T>::carve(reinterpret_cast<T*>(smem_raw), tile, D, KP, true);
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  load_tile(s.x, x, row0, rows, tile, D);
  load_tile(s.a, a, row0, rows, tile, D);
  scale_tile(c, true, row0, rows, tile, s, p);
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

template <typename T, int KP, bool WIDE>
__global__ void ADJ_BOUNDS(WIDE)
adjoint_sweep_bwd_kernel(const T* __restrict__ c_all, int R, const T* __restrict__ x,
                         const T* __restrict__ a, const T* __restrict__ mt,
                         const T* __restrict__ ms, T* __restrict__ a0, T* __restrict__ part,
                         int B, int D, int tile, AdjParams<T> p) {
  extern __shared__ unsigned char smem_raw[];
  AdjSmem<T> s = AdjSmem<T>::carve(reinterpret_cast<T*>(smem_raw), tile, D, KP, true);
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  load_tile(s.x, x, row0, rows, tile, D);
  load_tile(s.a, a, row0, rows, tile, D);
  for (int r = R - 1; r >= 0; --r) {
    scale_tile(c_all + (size_t)r * KP, false, row0, rows, tile, s, p);
    __syncthreads();
    adjoint_row_tile<T, KP>(s, rows, tile, D, mt, ms, p.m);
    // this block's batch sum of cbar for row r, trajectories in order
    for (int k = threadIdx.x; k < KP; k += blockDim.x) {
      T sum = T(0);
      for (int lr = 0; lr < rows; ++lr) sum = add_rn(sum, s.cbr[(size_t)lr * KP + k]);
      part[((size_t)blockIdx.x * R + r) * KP + k] = sum;
    }
    // a_n is the next row's cotangent
    T* t = s.a;
    s.a = s.an;
    s.an = t;
    __syncthreads();
  }
  store_tile(a0, s.a, row0, rows, D);
}

// Launch geometry and the shared-memory opt-in.
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
  g->tile = adj_tile<T>(B, D, KP, true, n_sm, max_smem);
  const int ncg = (D + CT - 1) / CT;
  const int items = adj_groups(KP, true) * g->tile * ncg;
  g->threads = (items + 31) / 32 * 32;
  g->smem = adj_smem_bytes<T>(g->tile, D, KP, true);
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

template <typename T, int KP, bool WIDE>
int launch_sweep_bwd(const Geometry<T>& g, const void* c_all, int R, const void* x,
                     const void* a, const void* mt, const void* ms, void* a0, void* part, int B,
                     int D, const AdjParams<T>& p, void* stream) {
  const int rc = allow_smem(adjoint_sweep_bwd_kernel<T, KP, WIDE>, g.smem);
  if (rc != 0) return rc;
  adjoint_sweep_bwd_kernel<T, KP, WIDE><<<g.blocks, g.threads, g.smem, (cudaStream_t)stream>>>(
      (const T*)c_all, R, (const T*)x, (const T*)a, (const T*)mt, (const T*)ms, (T*)a0,
      (T*)part, B, D, g.tile, p);
  return (int)cudaGetLastError();
}

template <typename T, int KP>
int run_sweep_bwd(const void* c_all, int R, const void* x, const void* a, const void* mt,
                  const void* ms, void* a0, void* part, int B, int D, const AdjParams<T>& p,
                  void* stream) {
  Geometry<T> g;
  const int rc = geometry<T>(B, D, KP, &g);
  if (rc != 0) return rc;
  return g.threads > ADJ_NARROW_THREADS
             ? launch_sweep_bwd<T, KP, true>(g, c_all, R, x, a, mt, ms, a0, part, B, D, p,
                                             stream)
             : launch_sweep_bwd<T, KP, false>(g, c_all, R, x, a, mt, ms, a0, part, B, D, p,
                                              stream);
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
  const AdjParams<T> p = parse<T>(KP, norms, m, theta, max_sq);
#define CALL(K) run_sweep_bwd<T, K>(c_all, R, x, a, mt, ms, a0, part, B, D, p, stream)
  ADJ_DISPATCH(KP, CALL)
#undef CALL
}

}  // namespace

extern "C" {

// The blocks K8 launches for B trajectories of width D over K' = KP terms
// in elements of elem_bytes (4 or 8): it writes one (R, KP) partial per
// block. Negative on an error.
int vec_ode_adjoint_blocks(int B, int D, int KP, int elem_bytes) {
  if (!params_ok(B, D, KP, 1, 0) || (elem_bytes != 4 && elem_bytes != 8)) return -1;
  int rc;
  int blocks = 0;
  if (elem_bytes == 4) {
    Geometry<float> g;
    rc = geometry<float>(B, D, KP, &g);
    blocks = g.blocks;
  } else {
    Geometry<double> g;
    rc = geometry<double>(B, D, KP, &g);
    blocks = g.blocks;
  }
  return rc != 0 ? -rc : blocks;
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
