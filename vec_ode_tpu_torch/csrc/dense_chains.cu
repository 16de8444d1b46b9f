// Per-trajectory dense exponential chains, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel vec_ode_tpu/ops/pallas_dense.py:
// fused_dense_chain_apply (pallas_call at :254): one step of the generic
// exponential integrators (Magnus-2/4/6, commutator-free Magnus, the split
// solvers), whose operator callback gives every trajectory its own dense
// samples M_q = A_b(t_q), so nothing is shared across the batch. For each
// trajectory b, from its n_nodes samples (D, D), its dt and its state row
// x (D,), it
//   1. builds the exponents of C in {1, 2} chains from the declared chain
//      table (ops/dense_chains.py:ChainTable, in place of the Pallas
//      kernel's traced chain_builder callback):
//        W = dt * sum_q lin[q] M_q  +  sum_k (g_k dt dt) (M_p M_q - M_q M_p);
//   2. for each exponent: the 1-norm, the squaring count s (the least
//      s >= 0 with norm / theta <= 2^s, found with frexp, at most
//      max_squarings, 0 for a non-finite norm), As = W 2^-s, the degree-m
//      Taylor polynomial by Paterson-Stockmeyer (m = 8 or 12, five
//      products), then s squarings;
//   3. applies the propagators in order, y = P[0][R0-1] ... P[0][0] x, and
//      with C = 2 writes err = || P[1][..] x - y ||: the l2 norm, or a
//      declared WeightedNorm (a weight per column, l2 or max, a post
//      factor), as the other kernels of the package take it.
//
// Design. One trajectory per block, a persistent grid striding over the
// batch: the squaring count is then uniform within a block, so no row
// waits masked for another. The live matrices of one exponential (As, its
// powers, two accumulators) are six (D, D) buffers, 384 KB at D = 128 in
// f32: more than a block's shared memory, so they live in a per-block
// scratch in global memory (the wrapper allocates it; one block per
// multiprocessor is resident at this register count, so on an H100 the
// 132 blocks' scratch is 51 MB in f32, about what its L2 holds), and each
// product runs tile by tile through shared memory: a 128 x 128 output
// tile, depth 8, 8 x 8 accumulators per thread, the next depth slice
// fetched into registers while the current one is multiplied. A block is
// only eight warps, so what it loads from global memory must be in flight
// together: full tiles and whole batches of the passes between the
// products take paths without bounds checks (a check per entry serialises
// the loads) and in 16-byte vectors; the edges keep the checked paths.
//
// What bounds it: FP32 (or FP64) FMA throughput. A Magnus-4 pair at D = 128
// is 12 products of 2 D^3 = 50 MFLOP per trajectory against 128 KB of
// samples read. No TF32, no fast math: the error is the difference of two
// propagated states. Every sum has a fixed order, so a launch is
// deterministic. A NaN sample stays in its trajectory: blocks share nothing.
// No loop waits on convergence; the longest runs max_squarings products.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_NODES = 8;       // operator samples per trajectory
constexpr int MAX_EXPONENTS = 12;  // exponents over both chains
constexpr int MAX_COMMS = 12;      // commutator terms over all exponents
constexpr int MAX_DIM = 256;       // D: one thread per column, THREADS wide
constexpr int THREADS = 256;
constexpr int BT = 128;            // output tile of a product, rows and cols
constexpr int BK = 8;              // its depth slice
constexpr int LD = BT + 4;         // padded row of a slice in shared memory
constexpr int N_BUF = 6;           // (D, D) scratch buffers per block
constexpr int TABLE_HEAD = 8;      // scalars before the lin rows

// 1 / k!, k <= 12
__device__ const double FACT_INV[13] = {
    1.0,
    1.0,
    1.0 / 2.0,
    1.0 / 6.0,
    1.0 / 24.0,
    1.0 / 120.0,
    1.0 / 720.0,
    1.0 / 5040.0,
    1.0 / 40320.0,
    1.0 / 362880.0,
    1.0 / 3628800.0,
    1.0 / 39916800.0,
    1.0 / 479001600.0,
};

// the chain table as the kernel reads it (parse_table)
struct Table {
  int n_nodes, n_chains, n_exp[2], m, max_squarings, n_comm;
  double theta;
  double lin[MAX_EXPONENTS][MAX_NODES];
  int comm_exp[MAX_COMMS], comm_p[MAX_COMMS], comm_q[MAX_COMMS];
  double comm_g[MAX_COMMS];
};

// NaN-propagating max (torch.amax)
template <typename T>
__device__ inline T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

__device__ inline void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ inline void load4(const double* p, double* o) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ inline void store4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// One depth slice k0 of a product's operands into registers: A's (BT, BK)
// block and B's (BK, BT) block, four entries of each per thread. FULL (the
// tile and the slice lie inside the matrices, D a multiple of 4): one
// 4-vector of A's row tid / 2 and one of B's row tid / 32, loaded without a
// bounds check so that nothing serialises them. Otherwise entry by entry,
// entries outside D reading as 0.
template <typename T, bool FULL>
__device__ inline void fetch_slice(const T* A, const T* B, int D, int i0, int j0, int k0, T* ra,
                                   T* rb) {
  const int tid = threadIdx.x;
  if (FULL) {
    load4(A + (size_t)(i0 + tid / 2) * D + k0 + (tid % 2) * 4, ra);
    load4(B + (size_t)(k0 + tid / 32) * D + j0 + (tid % 32) * 4, rb);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * THREADS;
      const int arow = i0 + e / BK, ak = k0 + e % BK;
      ra[l] = (arow < D && ak < D) ? A[(size_t)arow * D + ak] : T(0);
      const int bk = k0 + e / BT, bcol = j0 + e % BT;
      rb[l] = (bk < D && bcol < D) ? B[(size_t)bk * D + bcol] : T(0);
    }
  }
}

// ... and from the registers into shared memory: As[kk][row] (A's block
// transposed) and Bs[kk][col]
template <typename T, bool FULL>
__device__ inline void stash_slice(T* As, T* Bs, const T* ra, const T* rb) {
  const int tid = threadIdx.x;
  if (FULL) {
#pragma unroll
    for (int l = 0; l < 4; ++l) As[((tid % 2) * 4 + l) * LD + tid / 2] = ra[l];
    store4(Bs + (tid / 32) * LD + (tid % 32) * 4, rb);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * THREADS;
      As[(e % BK) * LD + e / BK] = ra[l];
      Bs[(e / BT) * LD + e % BT] = rb[l];
    }
  }
}

// The (BT, BT) output tile at (i0, j0) of C = alpha (A @ B) + beta Base.
// FULL as in fetch_slice; then the tile's Base entries are loaded and its
// results stored as 4-vectors, a few rows at a time.
template <typename T, bool FULL>
__device__ inline void gemm_tile(const T* A, const T* B, T* C, int D, int i0, int j0, T alpha,
                                 const T* Base, T beta, T* As, T* Bs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  T ra[4], rb[4];
  fetch_slice<T, FULL>(A, B, D, i0, j0, 0, ra, rb);
  stash_slice<T, FULL>(As, Bs, ra, rb);
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) fetch_slice<T, FULL>(A, B, D, i0, j0, k0 + BK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[8], b[8];
      load4(As + kk * LD + ty * 4, a);
      load4(As + kk * LD + 64 + ty * 4, a + 4);
      load4(Bs + kk * LD + tx * 4, b);
      load4(Bs + kk * LD + 64 + tx * 4, b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
    if (more) {
      stash_slice<T, FULL>(As, Bs, ra, rb);
      __syncthreads();
    }
  }
  if (FULL) {
    // ER of the thread's eight rows at a time: their Base entries in flight
    // together, within the registers the accumulators leave
    constexpr int ER = sizeof(T) == 4 ? 4 : 2;
#pragma unroll
    for (int part = 0; part < 8 / ER; ++part) {
      T base[ER][8];
      if (Base != nullptr) {
#pragma unroll
        for (int i = 0; i < ER; ++i) {
          const int ai = part * ER + i;
          const T* row =
              Base + (size_t)(i0 + (ai / 4) * 64 + ty * 4 + ai % 4) * D + j0 + tx * 4;
          load4(row, base[i]);
          load4(row + 64, base[i] + 4);
        }
      }
#pragma unroll
      for (int i = 0; i < ER; ++i) {
        const int ai = part * ER + i;
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = alpha * acc[ai][j];
          if (Base != nullptr) v[j] += beta * base[i][j];
        }
        T* row = C + (size_t)(i0 + (ai / 4) * 64 + ty * 4 + ai % 4) * D + j0 + tx * 4;
        store4(row, v);
        store4(row + 64, v + 4);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (r >= D) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (c >= D) continue;
        T v = alpha * acc[i][j];
        if (Base != nullptr) v += beta * Base[(size_t)r * D + c];
        C[(size_t)r * D + c] = v;
      }
    }
  }
}

// C = alpha (A @ B) + beta Base for (D, D) row-major matrices, by the whole
// block, all 16-byte aligned. Base may be null (no second term) or C
// itself; A and B may be the same matrix but neither may be C. As, Bs:
// BK * LD values each of shared memory. The sum over the depth runs in
// ascending order on either path. Ends with a block barrier, so C may be
// read at once.
template <typename T>
__device__ __noinline__ void gemm(const T* A, const T* B, T* C, int D, T alpha, const T* Base,
                                  T beta, T* As, T* Bs) {
  for (int i0 = 0; i0 < D; i0 += BT) {
    for (int j0 = 0; j0 < D; j0 += BT) {
      if (i0 + BT <= D && j0 + BT <= D && D % BK == 0)
        gemm_tile<T, true>(A, B, C, D, i0, j0, alpha, Base, beta, As, Bs);
      else
        gemm_tile<T, false>(A, B, C, D, i0, j0, alpha, Base, beta, As, Bs);
      __syncthreads();
    }
  }
}

// The passes over a (D, D) matrix between the products are bound by memory
// latency (a block is eight warps), so each thread keeps VEC_ODE_EW entries
// (8 floats or 4 doubles, the same registers) in flight: it loads them all,
// then computes and stores. Entry u of the batch at base is idx = base +
// u * THREADS; WHOLE batches (every entry below n) carry no bounds check,
// which would serialise the loads.
#define VEC_ODE_EW (32 / (int)sizeof(T))
#define VEC_ODE_ENTRIES(u, idx)                                                  \
  _Pragma("unroll") for (int u = 0, idx = base; u < VEC_ODE_EW;                  \
                         ++u, idx += THREADS) if (WHOLE || idx < n)
// runs BATCH<T, WHOLE>(base, n, ...) over all batches, then a block barrier
#define VEC_ODE_PASS(BATCH, ...)                                                 \
  for (int base = threadIdx.x; base < n; base += THREADS * VEC_ODE_EW) {         \
    if (base + (VEC_ODE_EW - 1) * THREADS < n)                                   \
      BATCH<T, true>(base, n, __VA_ARGS__);                                      \
    else                                                                         \
      BATCH<T, false>(base, n, __VA_ARGS__);                                     \
  }                                                                              \
  __syncthreads()

// W = dt * sum_q lin[q] M_q over the nonzero lin, summed in node order
template <typename T, bool WHOLE>
__device__ inline void exponent_batch(int base, int n, const T* __restrict__ ops,
                                      long long stride_q, const T* lin, T dt,
                                      T* __restrict__ W) {
  T acc[VEC_ODE_EW];
  VEC_ODE_ENTRIES(u, idx) {
    bool first = true;
    acc[u] = T(0);
#pragma unroll
    for (int q = 0; q < MAX_NODES; ++q) {
      if (lin[q] == T(0)) continue;
      const T term = lin[q] * ops[(size_t)q * stride_q + idx];
      acc[u] = first ? term : acc[u] + term;
      first = false;
    }
  }
  VEC_ODE_ENTRIES(u, idx) W[idx] = dt * acc[u];
}

// W = W + coef * A
template <typename T, bool WHOLE>
__device__ inline void add_scaled_batch(int base, int n, T* __restrict__ W,
                                        const T* __restrict__ A, T coef) {
  T w[VEC_ODE_EW], a[VEC_ODE_EW];
  VEC_ODE_ENTRIES(u, idx) {
    w[u] = W[idx];
    a[u] = A[idx];
  }
  VEC_ODE_ENTRIES(u, idx) W[idx] = w[u] + coef * a[u];
}

// W = W * scale
template <typename T, bool WHOLE>
__device__ inline void scale_batch(int base, int n, T* W, T scale) {
  T w[VEC_ODE_EW];
  VEC_ODE_ENTRIES(u, idx) w[u] = W[idx];
  VEC_ODE_ENTRIES(u, idx) W[idx] = w[u] * scale;
}

// block(j) of the Paterson-Stockmeyer form at one entry: c[4j] I + c[4j+1]
// As + c[4j+2] A2 + c[4j+3] A3, summed left to right
template <typename T>
__device__ inline T ps_block(int j, bool diag, T as, T a2, T a3) {
  T v = diag ? (T)FACT_INV[4 * j] : T(0);
  v = v + (T)FACT_INV[4 * j + 1] * as;
  v = v + (T)FACT_INV[4 * j + 2] * a2;
  return v + (T)FACT_INV[4 * j + 3] * a3;
}

// out0 = block(j0) (+ c4 A4 if A4), and out1 = block(j1) if out1. Entry
// idx = r D + c lies on the diagonal iff D + 1 divides it.
template <typename T, bool WHOLE>
__device__ inline void ps_blocks_batch(int base, int n, const T* __restrict__ As,
                                       const T* __restrict__ A2, const T* __restrict__ A3,
                                       const T* __restrict__ A4, T c4, int j0,
                                       T* __restrict__ out0, int j1, T* __restrict__ out1,
                                       int D) {
  T as[VEC_ODE_EW], a2[VEC_ODE_EW], a3[VEC_ODE_EW], a4[VEC_ODE_EW];
  VEC_ODE_ENTRIES(u, idx) {
    as[u] = As[idx];
    a2[u] = A2[idx];
    a3[u] = A3[idx];
    a4[u] = A4 != nullptr ? A4[idx] : T(0);
  }
  VEC_ODE_ENTRIES(u, idx) {
    const bool diag = idx % (D + 1) == 0;
    const T b0 = ps_block<T>(j0, diag, as[u], a2[u], a3[u]);
    out0[idx] = A4 != nullptr ? b0 + c4 * a4[u] : b0;
    if (out1 != nullptr) out1[idx] = ps_block<T>(j1, diag, as[u], a2[u], a3[u]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_chains_kernel(const T* __restrict__ node_ops, long long stride_b, long long stride_q,
                    const T* __restrict__ dt, const T* __restrict__ x, T* __restrict__ y,
                    T* __restrict__ err, T* scratch, int B, int D, Table tb,
                    const T* __restrict__ w_row, T post, int kind_max) {
  __shared__ __align__(16) T As[BK * LD];
  __shared__ __align__(16) T Bs[BK * LD];
  __shared__ T xs[MAX_DIM], v[MAX_DIM], v2[MAX_DIM], ymain[MAX_DIM], red[THREADS];
  __shared__ int s_sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = D * D;        // D <= MAX_DIM: fits an int
  T* const buf = scratch + (size_t)blockIdx.x * N_BUF * n;
  T* const W = buf;           // the exponent, then As
  T* const A2 = buf + n;      // also the commutator
  T* const A3 = buf + 2 * n;
  T* const A4 = buf + 3 * n;
  T* const X = buf + 4 * n;
  T* const Y = buf + 5 * n;
  const T theta = (T)tb.theta;
  // the column sums of the norm: groups of rows per column, THREADS
  // partial sums in all
  const int n_grp = THREADS / D > 0 ? THREADS / D : 1;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* const ops = node_ops + (size_t)b * stride_b;
    const T dtb = dt[b];
    if (tid < D) xs[tid] = x[(size_t)b * D + tid];
    __syncthreads();

    int e = 0;  // the exponent's index over both chains
    for (int c = 0; c < tb.n_chains; ++c) {
      if (tid < D) v[tid] = xs[tid];
      __syncthreads();
      for (int r = 0; r < tb.n_exp[c]; ++r, ++e) {
        // 1. the exponent: W = dt * sum_q lin[q] M_q over the nonzero lin
        T lin[MAX_NODES];
#pragma unroll
        for (int q = 0; q < MAX_NODES; ++q) lin[q] = q < tb.n_nodes ? (T)tb.lin[e][q] : T(0);
        VEC_ODE_PASS(exponent_batch, ops, stride_q, lin, dtb, W);
        // ... plus (g dt dt) (M_p M_q - M_q M_p) for its commutator terms
        for (int k = 0; k < tb.n_comm; ++k) {
          if (tb.comm_exp[k] != e) continue;
          const T* Mp = ops + (size_t)tb.comm_p[k] * stride_q;
          const T* Mq = ops + (size_t)tb.comm_q[k] * stride_q;
          gemm<T>(Mp, Mq, A2, D, T(1), nullptr, T(0), As, Bs);
          gemm<T>(Mq, Mp, A2, D, T(-1), A2, T(1), As, Bs);
          VEC_ODE_PASS(add_scaled_batch, W, A2, ((T)tb.comm_g[k] * dtb) * dtb);
        }

        // 2. the 1-norm (largest column sum) and the squaring count
        // (group g of column c sums rows g, g + n_grp, ...; then the
        // groups in order)
        T colsum = T(0);
        if (tid < n_grp * D) {
          const int c = tid % D;
#pragma unroll 8
          for (int i = tid / D; i < D; i += n_grp) colsum += fabs(W[i * D + c]);
        }
        red[tid] = colsum;
        __syncthreads();
        colsum = T(0);
        if (tid < D) {
          for (int g = 0; g < n_grp; ++g) colsum += red[g * D + tid];
          if (!isfinite(colsum)) colsum = (T)INFINITY;
        }
        __syncthreads();
        red[tid] = colsum;
        __syncthreads();
        for (int h = THREADS / 2; h > 0; h >>= 1) {
          if (tid < h) red[tid] = fmax(red[tid], red[tid + h]);
          __syncthreads();
        }
        if (tid == 0) {
          const T ratio = red[0] / theta;
          int s = 0;
          if (isfinite(ratio) && ratio > T(1)) {
            int ex;
            const T mant = frexp(ratio, &ex);
            s = ex - (mant == T(0.5) ? 1 : 0);
            s = s < 0 ? 0 : (s > tb.max_squarings ? tb.max_squarings : s);
          }
          s_sh = s;
        }
        __syncthreads();
        const int s = s_sh;
        if (s > 0) {
          const T scale = ldexp(T(1), -s);  // exact
          VEC_ODE_PASS(scale_batch, W, scale);
        }

        // the Taylor polynomial T_m(As) by Paterson-Stockmeyer
        gemm<T>(W, W, A2, D, T(1), nullptr, T(0), As, Bs);
        gemm<T>(A2, W, A3, D, T(1), nullptr, T(0), As, Bs);
        gemm<T>(A3, W, A4, D, T(1), nullptr, T(0), As, Bs);
        T* P;
        if (tb.m == 12) {
          // X = B2 + c12 A4, Y = B1; Y = A4 X + Y; X = B0; X = A4 Y + X
          VEC_ODE_PASS(ps_blocks_batch, W, A2, A3, A4, (T)FACT_INV[12], 2, X, 1, Y, D);
          gemm<T>(A4, X, Y, D, T(1), Y, T(1), As, Bs);
          VEC_ODE_PASS(ps_blocks_batch, W, A2, A3, (const T*)nullptr, T(0), 0, X, 0,
                       (T*)nullptr, D);
          gemm<T>(A4, Y, X, D, T(1), X, T(1), As, Bs);
          P = X;
        } else {
          // m = 8: X = B1 + c8 A4, Y = B0; Y = A4 X + Y
          VEC_ODE_PASS(ps_blocks_batch, W, A2, A3, A4, (T)FACT_INV[8], 1, X, 0, Y, D);
          gemm<T>(A4, X, Y, D, T(1), Y, T(1), As, Bs);
          P = Y;
        }
        // s squarings, between X and Y
        for (int i = 0; i < s; ++i) {
          T* const Q = P == X ? Y : X;
          gemm<T>(P, P, Q, D, T(1), nullptr, T(0), As, Bs);
          P = Q;
        }

        // 3. v <- P v: a warp per row, lanes over the columns
        for (int i = warp; i < D; i += THREADS / 32) {
          T part = T(0);
          for (int j = lane; j < D; j += 32) part += P[(size_t)i * D + j] * v[j];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
          if (lane == 0) v2[i] = part;
        }
        __syncthreads();
        if (tid < D) v[tid] = v2[tid];
        __syncthreads();
      }
      if (c == 0) {
        if (tid < D) {
          y[(size_t)b * D + tid] = v[tid];
          ymain[tid] = v[tid];
        }
        if (tb.n_chains == 1 && tid == 0) err[b] = T(0);
      } else {
        // the declared norm of the chains' difference: a weight per
        // column, then l2 or a NaN-propagating max, then the post factor
        T dv = T(0);
        if (tid < D) {
          dv = v[tid] - ymain[tid];
          if (w_row != nullptr) dv = dv * w_row[tid];
        }
        red[tid] = kind_max ? fabs(dv) : dv * dv;
        __syncthreads();
        for (int h = THREADS / 2; h > 0; h >>= 1) {
          if (tid < h)
            red[tid] = kind_max ? nan_max(red[tid], red[tid + h]) : red[tid] + red[tid + h];
          __syncthreads();
        }
        if (tid == 0) {
          T norm = kind_max ? red[0] : sqrt(red[0]);
          if (post != T(1)) norm = norm * post;
          err[b] = norm;
        }
      }
      __syncthreads();
    }
  }
}

// the flat table of ops/dense_chains.py:ChainTable.kernel_array: n_nodes,
// n_chains, n_exp[0], n_exp[1], m, max_squarings, theta, n_comm, then a lin
// row of n_nodes values per exponent, then (exponent, p, q, g) per
// commutator term. False for a table the kernel does not take.
bool parse_table(const double* t, int len, Table* tb) {
  if (t == nullptr || len < TABLE_HEAD) return false;
  tb->n_nodes = (int)t[0];
  tb->n_chains = (int)t[1];
  tb->n_exp[0] = (int)t[2];
  tb->n_exp[1] = (int)t[3];
  tb->m = (int)t[4];
  tb->max_squarings = (int)t[5];
  tb->theta = t[6];
  tb->n_comm = (int)t[7];
  if (tb->n_nodes < 1 || tb->n_nodes > MAX_NODES) return false;
  if (tb->n_chains < 1 || tb->n_chains > 2) return false;
  if (tb->n_exp[0] < 1 || tb->n_exp[1] < 0 || (tb->n_chains == 2) != (tb->n_exp[1] > 0))
    return false;
  const int n_exp = tb->n_exp[0] + tb->n_exp[1];
  if (n_exp > MAX_EXPONENTS || tb->n_comm < 0 || tb->n_comm > MAX_COMMS) return false;
  if ((tb->m != 8 && tb->m != 12) || tb->max_squarings < 0 || tb->max_squarings > 64 ||
      !(tb->theta > 0.0))
    return false;
  if (len != TABLE_HEAD + n_exp * tb->n_nodes + 4 * tb->n_comm) return false;
  const double* p = t + TABLE_HEAD;
  for (int e = 0; e < MAX_EXPONENTS; ++e)
    for (int q = 0; q < MAX_NODES; ++q)
      tb->lin[e][q] = (e < n_exp && q < tb->n_nodes) ? p[e * tb->n_nodes + q] : 0.0;
  p += n_exp * tb->n_nodes;
  for (int k = 0; k < MAX_COMMS; ++k) {
    const bool in = k < tb->n_comm;
    tb->comm_exp[k] = in ? (int)p[4 * k] : -1;
    tb->comm_p[k] = in ? (int)p[4 * k + 1] : 0;
    tb->comm_q[k] = in ? (int)p[4 * k + 2] : 0;
    tb->comm_g[k] = in ? p[4 * k + 3] : 0.0;
    if (in && (tb->comm_exp[k] < 0 || tb->comm_exp[k] >= n_exp || tb->comm_p[k] < 0 ||
               tb->comm_p[k] >= tb->n_nodes || tb->comm_q[k] < 0 || tb->comm_q[k] >= tb->n_nodes))
      return false;
  }
  return true;
}

// blocks of the persistent grid: as many as the card keeps resident, at
// most one per trajectory; negative: a CUDA error code
template <typename T>
int grid_blocks(int B) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st == cudaSuccess) st = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_chains_kernel<T>, THREADS, 0);
  if (st != cudaSuccess) return -(int)st;
  if (B < 1 || n_sm < 1) return -(int)cudaErrorInvalidValue;
  const long long g = (long long)n_sm * (per_sm < 1 ? 1 : per_sm);
  return (int)(B < g ? B : g);
}

template <typename T>
int launch(const void* node_ops, long long stride_b, long long stride_q, const void* dt,
           const void* x, void* y, void* err, void* scratch, int n_blocks, int B, int D,
           const double* table, int table_len, const void* w_row, double post, int kind_max,
           void* stream) {
  Table tb;
  if (B <= 0 || D <= 0 || D > MAX_DIM || n_blocks < 1 || n_blocks > B || scratch == nullptr ||
      !parse_table(table, table_len, &tb))
    return (int)cudaErrorInvalidValue;
  dense_chains_kernel<T><<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)node_ops, stride_b, stride_q, (const T*)dt, (const T*)x, (T*)y, (T*)err,
      (T*)scratch, B, D, tb, (const T*)w_row, (T)post, kind_max);
  return (int)cudaGetLastError();
}

#undef VEC_ODE_EW
#undef VEC_ODE_ENTRIES
#undef VEC_ODE_PASS

}  // namespace

extern "C" {

// The blocks a launch over B trajectories takes: the wrapper sizes the
// scratch, n_blocks * 6 * D * D values, with it. Negative: a CUDA error.
int vec_ode_dense_chains_blocks_f32(int B) { return grid_blocks<float>(B); }
int vec_ode_dense_chains_blocks_f64(int B) { return grid_blocks<double>(B); }

// One step of every trajectory: node_ops the operator samples, sample q of
// trajectory b a contiguous (D, D) block at b * stride_b + q * stride_q
// (in values); dt (B,), x (B, D); writes y (B, D) and err (B,), 0 where
// the table has one chain. table: the float64 values of
// ops/dense_chains.py:ChainTable.kernel_array, in host memory. w_row: D
// weights in device memory in the state's type, or null; post and kind_max
// (0: l2, 1: max) complete the declared error norm.
int vec_ode_dense_chains_f32(const void* node_ops, long long stride_b, long long stride_q,
                             const void* dt, const void* x, void* y, void* err, void* scratch,
                             int n_blocks, int B, int D, const double* table, int table_len,
                             const void* w_row, double post, int kind_max, void* stream) {
  return launch<float>(node_ops, stride_b, stride_q, dt, x, y, err, scratch, n_blocks, B, D,
                       table, table_len, w_row, post, kind_max, stream);
}

int vec_ode_dense_chains_f64(const void* node_ops, long long stride_b, long long stride_q,
                             const void* dt, const void* x, void* y, void* err, void* scratch,
                             int n_blocks, int B, int D, const double* table, int table_len,
                             const void* w_row, double post, int kind_max, void* stream) {
  return launch<double>(node_ops, stride_b, stride_q, dt, x, y, err, scratch, n_blocks, B, D,
                        table, table_len, w_row, post, kind_max, stream);
}

}  // extern "C"
