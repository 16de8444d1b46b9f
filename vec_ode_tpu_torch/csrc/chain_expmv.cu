// One chain-exponential step for an ensemble of trajectories of a
// modulated operator A(t) = sum_k c_k(t) M_k, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel vec_ode_tpu/ops/pallas_expmv.py:
// _make_kernel, launched by fused_chain_apply (pallas_call at :211), for
// the steppers' declared row recipes: midpoint, Magnus-4 with its order-2
// comparison chain, Magnus-4 with fast_error (one exponential per chain),
// Magnus-6 (three Yoshida sub-interval exponentials; the comparison chain
// a full-interval Magnus-4 row and two identity rows, skipped) and
// commutator-free Magnus over a declared table (R <= 4 alpha rows over
// J <= 8 nodes; the comparison chain padded with zero rows), over 1 to 8
// basis terms (K' <= 36 working terms with the Magnus commutators: the
// step's register body for K0 <= 2, K' <= 3, its k-outer body past it).
// It reads the coefficients sampled at the recipe's nodes, (J, B, K0), dt (B,) and the
// widened state x (B, D), and writes y (B, D) and the per-row error norm
// (B,). The step itself is the device function chain_step_tile of
// chain_step.cuh, which the whole-loop kernel (fused_loop.cu) runs too;
// the header's note has what it computes, the layout and the precision
// rules. Rows per block: chain_tile in the header (at B = 16384, D = 128:
// 32 rows, 256 threads, 512 blocks).
//
// What bounds it: FP32 FMA throughput. One Magnus-4 step at 16384 x 64
// complex in f32 is two chains x m = 8 terms x (B x 128 x 384 x 2) =
// about 25.8 GFLOP per Taylor pass against 8 MB in and 8 MB out, 0.38 ms
// per pass at the card's 67 TFLOP/s FP32 (non-tensor) rate; an adaptive
// Magnus-6 step runs four such exponentials, a CFM-4 step three at
// K' = 2 and one zero pad row; at K0 = 8 a Magnus-4 term is 36 products
// where K0 = 2 has 3. TF32 must not enter: the error norm is a
// difference of two chains near rounding level.
//
// Two bodies. K0 <= 2 (K' <= 3) runs chain_step.cuh's register body
// (chain_expmv_kernel: 4 x 4 per thread, the basis read from L2 at every
// term; 32 rows a block at 16384 x 128). K0 > 2 (K' from 4 to 36) runs
// the many-term body, chain_gemm_kernel below, which computes what the
// header's k-outer body computes (the loop kernel's K5 still runs that
// one) as a tiled SIMT GEMM. On an H100 (80 GB, 700 W) the k-outer body
// took 362 ms a launch at K' = 36 (2.95 TFLOP/s, 4.4% of its bound) and
// 15.4 ms at K' = 6: per basis term each thread streamed the (128, 128)
// slab from L2 with 4 __ldg per 16 FMAs, and each of its 512 blocks of 32
// rows read the whole 2.4 MB basis at every Taylor term, nothing
// overlapping the loads with the FMAs. The many-term body:
//   1. a larger tile: 64 rows a block in f32 (256 threads, 8 x 4 outputs
//      each; gemm_tile_of), 32 in f64 (4 x 4 each: the f64 registers), so
//      each basis value in shared memory serves twice the rows;
//   2. the basis through shared memory: the term's product with M_k^T
//      runs over panels of JC contraction rows (32 at D = 128 in f32, 16
//      KB), streamed by cp.async through a ring of three panels
//      (gemm_tile.cuh: PanelRing), the copy of panel p + 2 in flight while
//      panel p is multiplied; the periodic stream runs across terms,
//      rows and chains;
//   3. a register microtile fed from shared memory: the term is held
//      transposed, so a thread's 8 rows and 4 columns are three 16-byte
//      loads for 32 FMAs per contraction index (gemm_tile.cuh: tile_fma).
// Each element's j order (one FMA chain from zero) and the fold's k order
// (mul_rn, add_rn) are the k-outer body's, so the results are the same
// bit for bit; the error reduction runs over the same column groups in the
// same order. Shared memory at D = 128 in f32, 64 rows: the term 32 KB, the
// ring 48 KB, the scaled rows C R x 64 x K' (18 KB for the Magnus-4 pair
// at K' = 36, 55 KB for Magnus-6), the node samples, the pass counts: at
// most 153 KB; the state and the result stay in device memory (read once
// per chain, written once). A larger tile runs to its slowest row's pass
// count; chip_smoke.py prints the masked share of the old tile and the new.
// A 128-row tile (16 x 4 a thread, the running sum moved to shared memory
// to free registers) ran slower on the card: more rows wait masked, and
// the registers sit at the limit; a deeper ring (4 or 5 panels) did not
// move the time. Advancing the ring's position by counters, not by
// dividing it out per panel, did.
//
// Tensor cores in an FP32-emulating form, TMA, persistent blocks and
// regrouping rows by pass count are later work.

#include "chain_step.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace vec_ode;

constexpr int RT = 4;  // rows per thread, as in the loop kernel
constexpr int MAX_THREADS = 256;

template <typename T, int KP>
__global__ void __launch_bounds__(MAX_THREADS)
chain_expmv_kernel(const T* __restrict__ g, const T* __restrict__ dt, const T* __restrict__ x,
                   const T* __restrict__ mt, T* __restrict__ y, T* __restrict__ err, int B,
                   int D, int tile, ChainParams<T> p, ErrNorm<T> en) {
  extern __shared__ unsigned char smem_raw[];
  const size_t n = (size_t)tile * D;
  const int kp = kp_of<KP>(p), gs = g_stride<KP>(p);
  T* scratch = reinterpret_cast<T*>(smem_raw);
  T* xs = scratch + ChainSmem<T>::elems(tile, D, kp, gs, p);  // x (tile, D)
  T* ys = xs + n;                                             // y (tile, D)
  T* s_dt = ys + n;                                           // dt (tile)
  const ChainSmem<T> sm = ChainSmem<T>::carve(scratch, tile, D, kp, gs, p);

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  const int K0 = p.K0;

  for (size_t e = tid; e < n; e += blockDim.x)
    xs[e] = e < (size_t)rows * D ? x[row0 * D + e] : T(0);
  for (int lr = tid; lr < tile; lr += blockDim.x) {
    s_dt[lr] = lr < rows ? dt[row0 + lr] : T(0);
    for (int nd = 0; nd < p.J; ++nd)
      for (int k = 0; k < K0; ++k)
        sm.g[((size_t)nd * tile + lr) * gs + k] =
            lr < rows ? g[((size_t)nd * B + row0 + lr) * K0 + k] : T(0);
  }
  __syncthreads();
  chain_step_tile<T, RT, KP>(s_dt, xs, ys, err + row0, sm, rows, tile, D, mt, p, en);
  __syncthreads();
  for (size_t e = tid; e < (size_t)rows * D; e += blockDim.x) y[row0 * D + e] = ys[e];
}

template <typename T, int KP>
int run(const ChainParams<T>& p, const ErrNorm<T>& en, const void* g, const void* dt,
        const void* x, const void* mt, void* y, void* err, int B, int D, void* stream) {
  static size_t smem_allowed[MAX_DEVICES];
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  auto smem_of = [&](int tl) {
    return (ChainSmem<T>::elems(tl, D, kp_of<KP>(p), g_stride<KP>(p), p) +
            2 * (size_t)tl * D + tl) * sizeof(T);
  };
  const int tile = chain_tile<T>(B, D, n_sm, RT, MAX_THREADS, (size_t)max_smem, smem_of);
  const int ncg = (D + CT - 1) / CT;
  const int items = (tile / RT) * ncg;
  const size_t smem = smem_of(tile);
  if (items > MAX_THREADS || smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const int threads = ((items > tile ? items : tile) + 31) / 32 * 32;
  if (smem > smem_allowed[dev]) {
    st = cudaFuncSetAttribute(chain_expmv_kernel<T, KP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
    smem_allowed[dev] = smem;
  }
  const int blocks = (B + tile - 1) / tile;
  chain_expmv_kernel<T, KP><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)dt, (const T*)x, (const T*)mt, (T*)y, (T*)err, B, D, tile, p, en);
  return (int)cudaGetLastError();
}

// Rows per thread of the many-term body.
template <typename T>
constexpr int gemm_rm() {
  return sizeof(T) == 4 ? GEMM_RM_F32 : GEMM_RM_F64;
}

// The many-term body's shared memory, byte offsets of each region (each
// 16-byte aligned), in this order: the term transposed (D, tile), then the
// error vector (tile, D); the ring of GEMM_STAGES panels (jc, DP); the
// scaled rows (C R, tile, K'); the unscaled rows (tile, K'), magnus4_fast
// only (the others build each row in place in its scaled slot); the node
// samples (J, tile, K0); dt (tile); the pass counts (C R, tile).
// ops/expmv.py:gemm_smem_bytes mirrors it.
template <typename T>
struct GemmLayout {
  size_t term, ring, cs, rows, g, dt, npass, total;
  __host__ __device__ GemmLayout(int tile, int D, const ChainParams<T>& p) {
    const size_t nr = (size_t)p.C * p.R, kp = (size_t)p.KP;
    size_t at = 0;
    term = at, at += align16((size_t)D * tile * sizeof(T));
    ring = at, at += align16((size_t)GEMM_STAGES * gemm_jc<T>(D) * gemm_dp(D) * sizeof(T));
    cs = at, at += align16(nr * tile * kp * sizeof(T));
    rows = cs;
    if (p.recipe == RECIPE_MAGNUS4_FAST) rows = at, at += align16((size_t)tile * kp * sizeof(T));
    g = at, at += align16((size_t)p.J * tile * p.K0 * sizeof(T));
    dt = at, at += align16((size_t)tile * sizeof(T));
    npass = at, at += align16(nr * tile * sizeof(int));
    total = at;
  }
};

// The many-term body (K0 > 2; see the note above): chain_step_tile's
// k-outer body as a tiled SIMT GEMM. Thread t owns rows [rg RM, rg RM +
// RM) and columns [cg 4, cg 4 + 4) of the tile, cg = t mod DP / 4.
template <typename T, int RM>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
chain_gemm_kernel(const T* __restrict__ g, const T* __restrict__ dt, const T* __restrict__ x,
                  const T* __restrict__ mt, T* __restrict__ y, T* __restrict__ err, int B, int D,
                  int tile, ChainParams<T> p, ErrNorm<T> en) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  const GemmLayout<T> L(tile, D, p);
  T* termT = reinterpret_cast<T*>(gemm_smem + L.term);
  ChainSmem<T> sm;
  sm.term = termT;
  sm.g = reinterpret_cast<T*>(gemm_smem + L.g);
  sm.cs = reinterpret_cast<T*>(gemm_smem + L.cs);
  sm.rows = reinterpret_cast<T*>(gemm_smem + L.rows);
  sm.npass = reinterpret_cast<int*>(gemm_smem + L.npass);
  T* s_dt = reinterpret_cast<T*>(gemm_smem + L.dt);
  PanelRing<T> ring(mt, reinterpret_cast<T*>(gemm_smem + L.ring), D, p.KP, gemm_jc<T>(D));

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  const int K0 = p.K0, kp = p.KP, C = p.C, R = p.R;
  const int ncg = ring.DP / GEMM_CN;
  const bool active = tid < (tile / RM) * ncg;
  const int col0 = (tid % ncg) * GEMM_CN, lr0 = (tid / ncg) * RM;
  const bool fast = p.recipe == RECIPE_MAGNUS4_FAST;

  ring.prologue();  // the basis' first panels land while the rows are built
  for (int lr = tid; lr < tile; lr += blockDim.x) {
    s_dt[lr] = lr < rows ? dt[row0 + lr] : T(0);
    for (int nd = 0; nd < p.J; ++nd)
      for (int k = 0; k < K0; ++k)
        sm.g[((size_t)nd * tile + lr) * K0 + k] =
            lr < rows ? g[((size_t)nd * B + row0 + lr) * K0 + k] : T(0);
  }
  __syncthreads();
  chain_rows_setup<KP_DYN>(s_dt, sm, rows, tile, p);

  // the products of one Taylor term: y_b = term @ M_b^T panel by panel,
  // folded at once into w in b order (b from b0; cf the row's
  // coefficients), every thread taking every panel of the stream
  T acc[RM][GEMM_CN], yv[RM][GEMM_CN], w[RM][GEMM_CN];
  auto products = [&](int b0, const T* cf, size_t cf_stride) {
    for (int b = 0; b < kp; ++b) {
      tile_zero<T, RM>(yv);
      for (int j0 = 0; j0 < D; j0 += ring.jc) {
        const T* st = ring.acquire();
        if (active && b >= b0)
          tile_fma<T, RM, false>(termT + (size_t)j0 * tile + lr0, tile, st + col0,
                                 ring.DP, ring.rows_of(j0), yv);
      }
      if (active && b >= b0) {
#pragma unroll
        for (int q = 0; q < RM; ++q) {
          const T cq = cf[(size_t)(lr0 + q) * cf_stride + b];
#pragma unroll
          for (int k = 0; k < GEMM_CN; ++k) {
            const T part = mul_rn(cq, yv[q][k]);
            w[q][k] = b == b0 ? part : add_rn(w[q][k], part);
          }
        }
      }
    }
  };
  auto put_term = [&](const T (&v)[RM][GEMM_CN]) {
    if (!active) return;
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < GEMM_CN; ++k)
        if (col0 + k < D) termT[(size_t)(col0 + k) * tile + lr0 + q] = v[q][k];
  };

  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < GEMM_CN; ++k)
        acc[q][k] = active && lr0 + q < rows && col0 + k < D
                        ? x[(row0 + lr0 + q) * D + col0 + k] : T(0);
    for (int r = 0; r < R; ++r) {
      if (identity_row(p, c, r)) continue;  // e^0 = I: skipped, as the JAX kernels do
      const size_t cr = (size_t)c * R + r;
      int np[RM];
#pragma unroll
      for (int q = 0; q < RM; ++q) np[q] = active ? sm.npass[cr * tile + lr0 + q] : 0;
      for (int pass = 0;; ++pass) {
        bool mine = false;
#pragma unroll
        for (int q = 0; q < RM; ++q) mine = mine || np[q] > pass;
        put_term(acc);
        // the pass's start state is written; go on while any row has passes
        if (!__syncthreads_or(mine)) break;
        for (int kk = 1; kk <= p.m; ++kk) {
          products(0, sm.cs + cr * tile * kp, kp);
          __syncthreads();  // every read of the term is done
          if (active) {
            const T div = T(kk);
#pragma unroll
            for (int q = 0; q < RM; ++q)
#pragma unroll
              for (int k = 0; k < GEMM_CN; ++k) {
                const T nt = w[q][k] / div;
                w[q][k] = nt;
                if (pass < np[q]) acc[q][k] = acc[q][k] + nt;
              }
          }
          put_term(w);  // the next acquire() is the barrier before it is read
        }
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int k = 0; k < GEMM_CN; ++k) {
          if (col0 + k >= D || lr0 + q >= rows) continue;
          const long e = (row0 + lr0 + q) * D + col0 + k;
          if (c == 0)
            y[e] = acc[q][k];
          else  // chain 1 - chain 0 (the thread wrote that element itself)
            acc[q][k] = acc[q][k] - y[e];
        }
    }
  }
  if (C == 1 && !fast) {
    for (int lr = tid; lr < rows; lr += blockDim.x) err[row0 + lr] = T(0);
    cp_async_wait<0>();
    return;
  }
  if (fast) {  // dv = sum_{k >= K0} w2_k (M_k y) on y, k in order
    put_term(acc);  // y, zero past the batch
    products(K0, sm.rows, kp);
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < GEMM_CN; ++k) acc[q][k] = w[q][k];
  }
  // the error vector dv (acc) into the term's slot, row-major; then per row
  // chain_err_measure's reduction, column groups in the same order (K4
  // declares no scaled_error)
  __syncthreads();
  T* dv = termT;
  if (active) {
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < GEMM_CN; ++k)
        if (col0 + k < D) dv[(size_t)(lr0 + q) * D + col0 + k] = acc[q][k];
  }
  __syncthreads();
  for (int lr = tid; lr < rows; lr += blockDim.x) {
    T a = T(0);
    for (int cgp = 0; cgp < ncg; ++cgp) {
      T part = T(0);
      for (int k = 0; k < CT; ++k) {
        const int col = cgp + k * ncg;
        if (col >= D) continue;
        T v = dv[(size_t)lr * D + col];
        if (en.w_row != nullptr) v = v * en.w_row[col];
        part = en.kind_max ? nan_max(fabs(v), part) : part + v * v;
      }
      a = en.kind_max ? nan_max(part, a) : a + part;
    }
    T norm = en.kind_max ? a : sqrt_full(a);
    if (en.post != T(1)) norm = norm * en.post;
    err[row0 + lr] = norm;
  }
  cp_async_wait<0>();  // the stream's last speculative panels
}

// Rows per block of the many-term body: the largest power of two up to
// 128 whose product threads (tile / RM) x DP / 4 fit GEMM_THREADS and
// whose shared memory fits the device's max_smem, halved while the batch
// gives fewer blocks than SMs, down to 16 (at B = 16384, D = 128: 64 rows
// in f32, 32 in f64). The rows' results do not depend on it.
// ops/expmv.py:gemm_tile mirrors it.
template <typename T>
int gemm_tile_of(int B, int D, const ChainParams<T>& p, int n_sm, size_t max_smem) {
  constexpr int RM = gemm_rm<T>();
  const int ncg = gemm_dp(D) / GEMM_CN;
  int tile = 128;
  while (tile > RM &&
         ((tile / RM) * ncg > GEMM_THREADS || GemmLayout<T>(tile, D, p).total > max_smem))
    tile /= 2;
  while (tile > 16 && (B + tile - 1) / tile < n_sm) tile /= 2;
  return tile;
}

template <typename T>
int run_gemm(const ChainParams<T>& p, const ErrNorm<T>& en, const void* g, const void* dt,
             const void* x, const void* mt, void* y, void* err, int B, int D, void* stream) {
  constexpr int RM = gemm_rm<T>();
  static size_t smem_allowed[MAX_DEVICES];
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  const int tile = gemm_tile_of<T>(B, D, p, n_sm, (size_t)max_smem);
  const size_t smem = GemmLayout<T>(tile, D, p).total;
  const int items = (tile / RM) * (gemm_dp(D) / GEMM_CN);
  if (tile < RM || items > GEMM_THREADS || smem > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  const int threads = (items + 31) / 32 * 32;
  if (smem > smem_allowed[dev]) {
    st = cudaFuncSetAttribute(chain_gemm_kernel<T, RM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
    smem_allowed[dev] = smem;
  }
  const int blocks = (B + tile - 1) / tile;
  chain_gemm_kernel<T, RM><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)dt, (const T*)x, (const T*)mt, (T*)y, (T*)err, B, D, tile, p, en);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const void* dt, const void* x, const void* mt, void* y, void* err,
           int B, int D, const double* chain, const void* w_row, double post, int kind_max,
           void* stream) {
  if (B <= 0 || D <= 0 || D > MAX_WIDTH || g == nullptr) return (int)cudaErrorInvalidValue;
  const ChainParams<T> p = parse_chain_params<T>(chain);
  if (!chain_params_ok(p)) return (int)cudaErrorInvalidValue;
  const ErrNorm<T> en{(const T*)w_row, (T)post, kind_max, 0, T(0), T(0)};
  if (p.K0 > REG_K0) return run_gemm<T>(p, en, g, dt, x, mt, y, err, B, D, stream);
  switch (p.KP) {
    case 1: return run<T, 1>(p, en, g, dt, x, mt, y, err, B, D, stream);
    case 2: return run<T, 2>(p, en, g, dt, x, mt, y, err, B, D, stream);
    case 3: return run<T, 3>(p, en, g, dt, x, mt, y, err, B, D, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One chain step of every row: g (J, B, K0) the coefficients at the
// recipe's J nodes, dt (B,), x (B, D), mt = [M_0^T | ... ] (D, KP*D);
// writes y (B, D) and err (B,). chain: the float64 parameters of
// ops/expmv.py:chain_params, in host memory; w_row, post, kind_max declare
// the error norm.
int vec_ode_chain_expmv_f32(const void* g, const void* dt, const void* x, const void* mt,
                            void* y, void* err, int B, int D, const double* chain,
                            const void* w_row, double post, int kind_max, void* stream) {
  return launch<float>(g, dt, x, mt, y, err, B, D, chain, w_row, post, kind_max, stream);
}

int vec_ode_chain_expmv_f64(const void* g, const void* dt, const void* x, const void* mt,
                            void* y, void* err, int B, int D, const double* chain,
                            const void* w_row, double post, int kind_max, void* stream) {
  return launch<double>(g, dt, x, mt, y, err, B, D, chain, w_row, post, kind_max, stream);
}

}  // extern "C"
