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
//   1. forms the exponents of C in {1, 2} chains from the declared chain
//      table (ops/dense_chains.py:ChainTable, in place of the Pallas
//      kernel's traced chain_builder callback), once each, in shared
//      memory:
//        W = dt * sum_q lin[q] M_q  +  sum_k (g_k dt dt) (M_p M_q - M_q M_p);
//   2. for each exponent: the 1-norm and the squaring count s (the least
//      s >= 0 with norm / theta <= 2^s, found with frexp, at most
//      max_squarings; 0 for a NaN norm, max_squarings for an infinite
//      one), then one of two routes, chosen from (s, m, D) alone
//      (takes_actions, mirrored in ops/dense_chains.py):
//      * actions: 2^s passes of the degree-m Taylor polynomial of
//        2^-s W on the running vector, a matrix-vector product a term
//        from the resident W (term = (2^-s W term) / j, summed), while
//        2^s m 2 D^2 < (products of the formed route) 2 D^3, e.g. s <= 6
//        at D = 128 and m = 12;
//      * formed (large s): T_m(2^-s W) by Paterson-Stockmeyer (five
//        products at m = 12, four at m = 8), s squarings, then one
//        matrix-vector product, through a scratch in global memory;
//      both apply (T_m(2^-s W))^{2^s} and differ by rounding only;
//   3. chain 0 gives y; with C = 2 it writes err = || chain 1 - y ||: the
//      l2 norm, or a declared WeightedNorm (a weight per column, l2 or max,
//      a post factor), as the other kernels of the package take it.
//
// What bounds it: FP32 (FP64) FMAs. A step of the generic Magnus-4 path
// (two nodes, one commutator, two exponents at s = 0, D = 128) needs the
// commutator's two products of 2 D^3 and 24 matrix-vector products of
// 2 D^2, ~9.2 MFLOP per trajectory against 128 KB of samples read.
//
// Design. A persistent grid of clusters (plan: dense_plan), each cluster
// one trajectory at a time; a cluster of cs blocks holds W's rows in
// shared memory, ceil(D / cs) rows a block, cs the least of 1, 2, 4, 8
// whose layout fits (1 at D = 128 in f32 and f64, 2 at D = 256 in f32,
// 4 in f64). The products of a block's rows (the commutators, and on the
// formed route every product) run through one routine: chunks of up to
// 64 rows, RM x 4 outputs a thread (gemm_tile.cuh's tile_fma microtile),
// panels of 8 contraction indices of both operands streamed from global
// memory through two stages of shared memory, each panel brought in while
// the previous one is multiplied. The left operand goes in transposed, so
// that a thread's RM rows at one index are one or two 16-byte loads;
// cp.async (as in gemm_tile.cuh's PanelRing) copies without transposing,
// so the left panels are staged through registers; the right panels go by
// cp.async. A commutator entry is one FMA chain: the panels in order, in
// each M_p M_q's indices, then -M_q M_p's. The matrix-vector products
// read W's rows in
// 16-byte loads, TPR threads a row (a butterfly sum over them), each
// writing its row's value into every block of the cluster (distributed
// shared memory); one cluster barrier a Taylor term, two term buffers in
// turn. A block's shared memory at D = 128 in f32 is ~97 KB, two blocks an
// SM. No global scratch is touched on the actions route; the formed route
// keeps six (D, D) buffers a cluster in global memory (the wrapper
// allocates them), its products ordered by cluster barriers.
//
// No TF32, no fast math: the error is the difference of two propagated
// states. Every sum has a fixed order and every block of a cluster
// computes the norm and s identically, so a launch is deterministic. A NaN
// sample stays in its trajectory: clusters share nothing. No loop waits on
// convergence; the longest runs 2^s m matrix-vector products with
// 2^s m < (5 + s) D, or max_squarings products.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace {

using namespace vec_ode;
namespace cg = cooperative_groups;

constexpr int MAX_NODES = 8;       // operator samples per trajectory
constexpr int MAX_EXPONENTS = 12;  // exponents over both chains
constexpr int MAX_COMMS = 12;      // commutator terms over all exponents
constexpr int MAX_DIM = 256;       // D
constexpr int THREADS = 256;
constexpr int JC = 8;              // contraction indices a panel of a product
constexpr int MAX_RC = 64;         // rows a chunk of a product at most
constexpr int MAX_CLUSTER = 8;     // blocks a cluster at most (the portable limit)
constexpr int RM_F32 = 8, RM_F64 = 4;  // product rows a thread
constexpr int N_BUF = 6;           // (D, D) scratch buffers a cluster, formed route
constexpr int N_VEC = 5;           // (D,) vectors a block: two terms, v, the sum, chain 0
constexpr int FU = 4;              // rows a thread forms at a time
constexpr int TABLE_HEAD = 8;      // scalars before the lin rows

template <typename T>
__host__ __device__ constexpr int rm_of() {
  return sizeof(T) == 4 ? RM_F32 : RM_F64;
}
// blocks an SM the launch bounds keep registers for
template <typename T>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

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

// Products of the formed route: Paterson-Stockmeyer's (A^2, A^3, A^4 and
// two more at m = 12, one more at m = 8), before the squarings.
__host__ __device__ inline int ps_products(int m) { return m == 12 ? 5 : 4; }

// The route rule (ops/dense_chains.py: takes_actions): the Taylor actions
// while their 2^s m products of 2 D^2 cost less than the formed route's
// (ps_products(m) + s) products of 2 D^3. Integer arithmetic.
__host__ __device__ inline bool takes_actions(int s, int m, int D) {
  return s < 31 && (1LL << s) * m < (long long)(ps_products(m) + s) * D;
}

// A launch's shape (ops/dense_chains.py: dense_plan mirrors it): the
// cluster, the rows of W a block holds, the products' chunks and the
// shared memory a block, carved at the byte offsets given.
struct Plan {
  int cs;               // blocks a cluster (1: no cluster)
  int rows;             // rows of W a block owns, ceil(D / cs)
  int dpr;              // D rounded up to 4: the vectors, a panel's right operand
  int dp;               // W's row in shared memory: a multiple of 128 bytes + 32
  int ncg, nrg, rc, rcp;  // a product: column groups, row groups, rows a chunk, padded
  int tpr;              // threads a row of a matrix-vector product
  size_t off_ring, off_vec, off_colpart, off_red, off_s, smem;
};

template <typename T>
Plan plan_with(int D, int cs) {
  constexpr int e = (int)sizeof(T), RM = rm_of<T>();
  Plan p;
  p.cs = cs;
  p.rows = (D + cs - 1) / cs;
  p.dpr = gemm_dp(D);
  // rows 32 bytes past a multiple of 128: the 16-byte loads of a quarter
  // warp (TPR = 2: four rows, two column groups each) meet no conflict
  p.dp = (D + 128 / e - 1) / (128 / e) * (128 / e) + 32 / e;
  p.ncg = p.dpr / GEMM_CN;
  int nrg = THREADS / p.ncg;
  if (nrg > MAX_RC / RM) nrg = MAX_RC / RM;
  const int need = (p.rows + RM - 1) / RM;
  if (nrg > need) nrg = need;
  p.nrg = nrg;
  p.rc = nrg * RM;
  p.rcp = p.rc + 4;  // the transposed left panel's row: 16-byte aligned, stores spread over banks
  const int per_row = THREADS / p.rows;
  int tpr = 1;
  while (tpr * 2 <= per_row && tpr < 32) tpr *= 2;
  p.tpr = tpr;
  size_t off = align16((size_t)p.rows * p.dp * e);
  p.off_ring = off;
  off += align16((size_t)2 * 2 * JC * (p.rcp + p.dpr) * e);  // two stages of two products
  p.off_vec = off;
  off += align16((size_t)N_VEC * p.dpr * e);
  p.off_colpart = off;
  off += align16((size_t)cs * p.dpr * e);
  p.off_red = off;
  off += align16((size_t)THREADS * e);
  p.off_s = off;  // the squaring count, an int
  p.smem = off + 16;
  return p;
}

// The least cluster whose blocks' layout fits max_smem; cs = 0: none.
template <typename T>
Plan dense_plan(int D, size_t max_smem) {
  for (int cs = 1; cs <= MAX_CLUSTER && cs <= D; cs *= 2) {
    const Plan p = plan_with<T>(D, cs);
    if (p.smem <= max_smem) return p;
  }
  Plan none = {};
  return none;
}

// Clusters of the persistent grid: what the SMs hold by shared memory,
// at most min_blocks an SM, at most one per trajectory.
template <typename T>
int grid_clusters(const Plan& p, int B, int n_sm, int smem_sm, int reserved) {
  int per_sm = (int)((size_t)smem_sm / (p.smem + (size_t)reserved));
  if (per_sm > min_blocks<T>()) per_sm = min_blocks<T>();
  if (per_sm < 1) per_sm = 1;
  long long g = (long long)n_sm * per_sm / p.cs;
  if (g < 1) g = 1;
  return (int)(B < g ? B : g);
}

template <bool CLUSTER>
__device__ __forceinline__ void sync_all() {
  if constexpr (CLUSTER)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// p in block r of the cluster (p itself without a cluster)
template <bool CLUSTER, typename T>
__device__ __forceinline__ T* peer(T* p, int r) {
  if constexpr (CLUSTER)
    return cg::this_cluster().map_shared_rank(p, (unsigned)r);
  else
    return p;
}

// four values of global memory at p (16-byte aligned) in 16-byte loads
template <typename T>
__device__ __forceinline__ void ldg_vec4(const T* p, T (&v)[GEMM_CN]) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
}

template <typename T>
struct Smem {
  T *W, *ring, *t0, *t1, *v, *acc, *ymain, *colpart, *red;
  int* s;
  __device__ Smem(unsigned char* base, const Plan& p) {
    W = reinterpret_cast<T*>(base);
    ring = reinterpret_cast<T*>(base + p.off_ring);
    T* vec = reinterpret_cast<T*>(base + p.off_vec);
    t0 = vec;
    t1 = vec + p.dpr;
    v = vec + 2 * p.dpr;
    acc = vec + 3 * p.dpr;
    ymain = vec + 4 * p.dpr;
    colpart = reinterpret_cast<T*>(base + p.off_colpart);
    red = reinterpret_cast<T*>(base + p.off_red);
    s = reinterpret_cast<int*>(base + p.off_s);
  }
};

// y[q][c] = fma(a[j * as + q], b[j * bs + c], y[q][c]) for j = 0 .. jn - 1
// in order: tile_fma's microtile (gemm_tile.cuh) with the index loop
// unrolled by four, not eight, so that the operands of few indices are in
// registers at once (the launch bounds leave 128 registers in f32)
template <typename T, int RM>
__device__ __forceinline__ void panel_fma(const T* a, int as, const T* b, int bs, int jn,
                                          T (&y)[RM][GEMM_CN]) {
#pragma unroll 4
  for (int j = 0; j < jn; ++j) {
    T av[RM], bv[GEMM_CN];
    lds_vec<T, RM>(a + (size_t)j * as, av);
    lds_vec<T, GEMM_CN>(b + (size_t)j * bs, bv);
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int c = 0; c < GEMM_CN; ++c) y[q][c] = fma_full(av[q], bv[c], y[q][c]);
  }
}

// out(i, c, value) for the rows [r_lo, r_hi) of A0 B0, or with NEG of
// A0 B0 - A1 B1 as one FMA chain an entry (the panels in order, in each
// A0 B0's indices, then -A1 B1's: A1's panel goes in negated, which is
// exact); A and B (D, D) row-major in global memory, written by no one
// during the call. Chunks of p.rc rows; panels
// of JC contraction indices through two stages of the ring: the right
// operands' rows copied by cp.async (16-byte copies where D is a multiple
// of 4 and both B are 16-byte aligned), the left operands' fetched into
// registers and stored transposed (cp.async cannot transpose), each while
// the previous panel is multiplied; one block barrier a panel. Thread t
// owns RM rows (row group t / ncg) and four columns (t % ncg) of a chunk.
// Ends with a block barrier. Not inlined: its registers are then its own
// and not the kernel's bookkeeping's too (fewer spills in f32; 6% faster
// on an H100 at 4096 trajectories).
template <typename T, bool NEG, typename Out>
__device__ __noinline__ void rows_product(const T* A0, const T* B0, const T* A1, const T* B1, int D,
                             int r_lo, int r_hi, const Plan& p, T* ring, Out out) {
  constexpr int RM = rm_of<T>(), NP = NEG ? 2 : 1, V = 16 / (int)sizeof(T);
  constexpr int LR = THREADS / JC, LK = MAX_RC / LR;  // left rows a sweep; sweeps
  const int tid = threadIdx.x, cgi = tid % p.ncg, rg = tid / p.ncg;
  const bool computes = rg < p.nrg;
  const size_t lt = (size_t)JC * p.rcp, rt = (size_t)JC * p.dpr, stage = 2 * (lt + rt);
  const int npan = (D + JC - 1) / JC;
  const int li = tid / JC, lj = tid % JC;
  const bool vec16 = D % GEMM_CN == 0 && (size_t)B0 % 16 == 0 &&
                     (!NEG || (size_t)B1 % 16 == 0);
  const int chunks = p.dpr / V;  // 16-byte copies a right row (vec16)
  // the right operands' rows j0 .. j0 + JC - 1 into stage st, rows past D zero
  auto copy_right = [&](T* st, int j0) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const T* Bm = n == 0 ? B0 : B1;
      T* R = st + 2 * lt + n * rt;
      if (vec16) {
        for (int e = tid; e < JC * chunks; e += THREADS) {
          const int jj = e / chunks, g = e - jj * chunks;
          T* dst = R + (size_t)jj * p.dpr + g * V;
          if (j0 + jj < D) {
            cp_async<16>(dst, Bm + (size_t)(j0 + jj) * D + g * V);
          } else {
#pragma unroll
            for (int u = 0; u < V; ++u) dst[u] = T(0);
          }
        }
      } else if (tid < p.dpr) {
#pragma unroll
        for (int jj = 0; jj < JC; ++jj) {
          T* dst = R + (size_t)jj * p.dpr + tid;
          if (j0 + jj < D && tid < D)
            cp_async<sizeof(T)>(dst, Bm + (size_t)(j0 + jj) * D + tid);
          else
            *dst = T(0);
        }
      }
    }
    cp_async_commit();
  };
  for (int c0 = r_lo; c0 < r_hi; c0 += p.rc) {
    const int nr = r_hi - c0 < p.rc ? r_hi - c0 : p.rc;
    T lv[NP][LK];
    auto fetch_left = [&](int j0) {
      const int j = j0 + lj;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const T* A = n == 0 ? A0 : A1;
#pragma unroll
        for (int k = 0; k < LK; ++k) {
          const int i = li + k * LR;
          lv[n][k] = (i < nr && j < D) ? A[(size_t)(c0 + i) * D + j] : T(0);
        }
      }
    };
    auto stash_left = [&](T* st) {
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int k = 0; k < LK; ++k) {
          const int i = li + k * LR;
          if (i < p.rc) st[n * lt + (size_t)lj * p.rcp + i] = n == 1 ? -lv[n][k] : lv[n][k];
        }
      }
    };
    T y[RM][GEMM_CN];
    tile_zero<T, RM>(y);
    copy_right(ring, 0);
    fetch_left(0);
    stash_left(ring);
    cp_async_wait<0>();
    __syncthreads();
    for (int pn = 0; pn < npan; ++pn) {
      const bool more = pn + 1 < npan;
      T* const nxt = ring + (size_t)((pn + 1) & 1) * stage;
      if (more) {
        copy_right(nxt, (pn + 1) * JC);
        fetch_left((pn + 1) * JC);
      }
      const T* st = ring + (size_t)(pn & 1) * stage;
      if (computes) {
        const int jn = D - pn * JC < JC ? D - pn * JC : JC;
#pragma unroll
        for (int n = 0; n < NP; ++n)
          panel_fma<T, RM>(st + n * lt + rg * RM, p.rcp, st + 2 * lt + n * rt + cgi * GEMM_CN,
                           p.dpr, jn, y);
      }
      if (more) stash_left(nxt);
      cp_async_wait<0>();
      __syncthreads();
    }
    if (computes) {
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        const int i = c0 + rg * RM + q;
#pragma unroll
        for (int c = 0; c < GEMM_CN; ++c) {
          const int col = cgi * GEMM_CN + c;
          if (i < r_hi && col < D) out(i, col, y[q][c]);
        }
      }
    }
  }
  __syncthreads();
}

// out[r_lo + i], in every block of the cluster, = sum_c W_s[i][c] t[c] for
// the block's `own` rows, divided by div where div > 0: p.tpr threads a
// row, each over the four-column groups h, h + tpr, ... (a 16-byte load
// of the row and one of t; four FMA chains, one per column of a group,
// summed in order), then a butterfly sum over the row's lanes. The
// padding columns of W_s and t are zero.
template <typename T, bool CLUSTER>
__device__ void matvec(const T* Ws, const Plan& p, int own, int r_lo, const T* t, T* out,
                       int div) {
  const int tid = threadIdx.x, h = tid % p.tpr, per = THREADS / p.tpr, ng = p.dpr / GEMM_CN;
  for (int base = 0; base < own; base += per) {
    const int i = base + tid / p.tpr;
    T part = T(0);
    if (i < own) {
      const T* row = Ws + (size_t)i * p.dp;
      T pc[GEMM_CN] = {};
      for (int g = h; g < ng; g += p.tpr) {
        T w[GEMM_CN], x[GEMM_CN];
        lds_vec<T, GEMM_CN>(row + GEMM_CN * g, w);
        lds_vec<T, GEMM_CN>(t + GEMM_CN * g, x);
#pragma unroll
        for (int c = 0; c < GEMM_CN; ++c) pc[c] = fma_full(w[c], x[c], pc[c]);
      }
      part = add_rn(add_rn(add_rn(pc[0], pc[1]), pc[2]), pc[3]);
    }
    for (int o = p.tpr / 2; o > 0; o >>= 1)
      part = add_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (i < own && h == 0) {
      const T val = div > 0 ? part / T(div) : part;
      for (int r = 0; r < p.cs; ++r) peer<CLUSTER>(out, r)[r_lo + i] = val;
    }
  }
}

// block(j) of the Paterson-Stockmeyer form at one entry: c[4j] I + c[4j+1]
// As + c[4j+2] A2 + c[4j+3] A3, summed left to right, each product rounded
// (ops/expm.taylor_ps)
template <typename T>
__device__ inline T ps_block(int j, bool diag, T as, T a2, T a3) {
  T v = diag ? (T)FACT_INV[4 * j] : T(0);
  v = add_rn(v, mul_rn((T)FACT_INV[4 * j + 1], as));
  v = add_rn(v, mul_rn((T)FACT_INV[4 * j + 2], a2));
  return add_rn(v, mul_rn((T)FACT_INV[4 * j + 3], a3));
}

template <typename T, bool CLUSTER>
__global__ void __launch_bounds__(THREADS, min_blocks<T>())
dense_chains_kernel(const T* __restrict__ node_ops, long long stride_b, long long stride_q,
                    const T* __restrict__ dt, const T* __restrict__ x, T* __restrict__ y,
                    T* __restrict__ err, T* scratch, int B, int D, Table tb,
                    const T* __restrict__ w_row, T post, int kind_max, Plan p) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  const Smem<T> sm(dense_smem, p);

  const int tid = threadIdx.x;
  int rank = 0, cid = blockIdx.x;
  if constexpr (CLUSTER) {
    rank = (int)cg::this_cluster().block_rank();
    cid = blockIdx.x / p.cs;
  }
  const int n_clusters = gridDim.x / p.cs;
  const int r_lo = rank * p.rows < D ? rank * p.rows : D;
  const int r_hi = r_lo + p.rows < D ? r_lo + p.rows : D;
  const int own = r_hi - r_lo;
  const size_t n = (size_t)D * D;
  T* const buf = scratch + (size_t)cid * N_BUF * n;  // the formed route's
  const T theta = (T)tb.theta;
  // the column sums of the norm: groups of rows per column
  const int n_grp = THREADS / D;
  // the samples in 16-byte loads: every row of every sample 16-byte aligned
  const bool vec_ops = D % GEMM_CN == 0 && (size_t)node_ops % 16 == 0 &&
                       (stride_b * (long long)sizeof(T)) % 16 == 0 &&
                       (stride_q * (long long)sizeof(T)) % 16 == 0;

  // the term buffers' padding stays zero; every block of the cluster has
  // started before the first remote write
  if (tid < p.dpr) sm.t0[tid] = sm.t1[tid] = sm.acc[tid] = T(0);
  sync_all<CLUSTER>();

  for (int b = cid; b < B; b += n_clusters) {
    const T* const ops = node_ops + (size_t)b * stride_b;
    const T dtb = dt[b];
    int e = 0;  // the exponent's index over both chains
    for (int c = 0; c < tb.n_chains; ++c) {
      if (tid < p.dpr) sm.v[tid] = tid < D ? x[(size_t)b * D + tid] : T(0);
      __syncthreads();
      for (int r = 0; r < tb.n_exp[c]; ++r, ++e) {
        // 1. the exponent's rows: dt * sum_q lin[q] M_q over the nonzero
        // lin, summed in node order; zero in the padding columns. Thread t
        // takes the four columns t % ncg of rows t / ncg, + rps, ..., FU
        // rows at a time, their loads in flight together (the samples'
        // first reads come from device memory): 16-byte loads where D is a
        // multiple of 4 and the samples are 16-byte aligned
        T lin[MAX_NODES];
#pragma unroll
        for (int q = 0; q < MAX_NODES; ++q) lin[q] = q < tb.n_nodes ? (T)tb.lin[e][q] : T(0);
        {
          const int rps = THREADS / p.ncg, g4 = tid % p.ncg * GEMM_CN;
          for (int i0 = tid / p.ncg; i0 < own && tid < rps * p.ncg; i0 += FU * rps) {
            T a[FU][GEMM_CN];
            bool first = true;
#pragma unroll
            for (int q = 0; q < MAX_NODES; ++q) {
              if (lin[q] == T(0)) continue;
              const T* src = ops + (size_t)q * stride_q + (size_t)r_lo * D + g4;
              T v[FU][GEMM_CN];
#pragma unroll
              for (int u = 0; u < FU; ++u) {
                const int i = i0 + u * rps;
                if (i < own && vec_ops) {
                  ldg_vec4(src + (size_t)i * D, v[u]);
                } else {
#pragma unroll
                  for (int c = 0; c < GEMM_CN; ++c)
                    v[u][c] = (i < own && g4 + c < D) ? src[(size_t)i * D + c] : T(0);
                }
              }
#pragma unroll
              for (int u = 0; u < FU; ++u)
#pragma unroll
                for (int c = 0; c < GEMM_CN; ++c) {
                  const T term = mul_rn(lin[q], v[u][c]);
                  a[u][c] = first ? term : add_rn(a[u][c], term);
                }
              first = false;
            }
#pragma unroll
            for (int u = 0; u < FU; ++u) {
              const int i = i0 + u * rps;
              if (i >= own) continue;
              T w[GEMM_CN];
#pragma unroll
              for (int c = 0; c < GEMM_CN; ++c)
                w[c] = g4 + c < D ? mul_rn(dtb, first ? T(0) : a[u][c]) : T(0);
              sts_vec(sm.W + (size_t)i * p.dp + g4, w);
            }
          }
        }
        __syncthreads();
        // ... plus (g dt dt) (M_p M_q - M_q M_p) for its commutator terms
        for (int k = 0; k < tb.n_comm; ++k) {
          if (tb.comm_exp[k] != e) continue;
          const T* Mp = ops + (size_t)tb.comm_p[k] * stride_q;
          const T* Mq = ops + (size_t)tb.comm_q[k] * stride_q;
          const T coef = mul_rn(mul_rn((T)tb.comm_g[k], dtb), dtb);
          T* const Ws = sm.W;
          const int dp = p.dp;
          rows_product<T, true>(Mp, Mq, Mq, Mp, D, r_lo, r_hi, p, sm.ring,
                                [=](int i, int col, T v) {
                                  T* w = Ws + (size_t)(i - r_lo) * dp + col;
                                  *w = add_rn(*w, mul_rn(coef, v));
                                });
        }

        // 2. the 1-norm (largest column sum): group g of a column sums the
        // block's rows g, g + n_grp, ...; then the groups in order, then
        // the cluster's blocks in rank order; a NaN column sum propagates
        T colsum = T(0);
        if (tid < n_grp * D) {
          const int col = tid % D;
          for (int i = tid / D; i < own; i += n_grp)
            colsum = add_rn(colsum, fabs(sm.W[(size_t)i * p.dp + col]));
        }
        sm.red[tid] = colsum;
        __syncthreads();
        if (tid < D) {
          T part = sm.red[tid];
          for (int g = 1; g < n_grp; ++g) part = add_rn(part, sm.red[g * D + tid]);
          for (int q = 0; q < p.cs; ++q) peer<CLUSTER>(sm.colpart, q)[rank * p.dpr + tid] = part;
        }
        sync_all<CLUSTER>();
        T tot = T(0);
        if (tid < D) {
          tot = sm.colpart[tid];
          for (int q = 1; q < p.cs; ++q) tot = add_rn(tot, sm.colpart[q * p.dpr + tid]);
        }
        sm.red[tid] = tot;
        __syncthreads();
        for (int hh = THREADS / 2; hh > 0; hh >>= 1) {
          if (tid < hh) sm.red[tid] = nan_max(sm.red[tid], sm.red[tid + hh]);
          __syncthreads();
        }
        if (tid == 0) {
          const T ratio = sm.red[0] / theta;
          int s = 0;
          if (isinf(ratio)) {
            s = tb.max_squarings;
          } else if (ratio > T(1)) {  // false for NaN: s = 0
            int ex;
            const T mant = frexp(ratio, &ex);
            s = ex - (mant == T(0.5) ? 1 : 0);
            s = s < 0 ? 0 : (s > tb.max_squarings ? tb.max_squarings : s);
          }
          *sm.s = s;
        }
        __syncthreads();
        const int s = *sm.s;
        const T scale = ldexp(T(1), -s);  // exact

        if (takes_actions(s, tb.m, D)) {
          // 3a. 2^s passes of T_m(2^-s W) on v: term = (As term) / j
          if (s > 0) {
            for (int idx = tid; idx < own * p.dpr; idx += THREADS) {
              const int i = idx / p.dpr, col = idx - i * p.dpr;
              sm.W[(size_t)i * p.dp + col] = mul_rn(sm.W[(size_t)i * p.dp + col], scale);
            }
            __syncthreads();
          }
          const long long n_pass = 1LL << s;
          for (long long pass = 0; pass < n_pass; ++pass) {
            if (tid < D) sm.t0[tid] = sm.acc[tid] = sm.v[tid];
            __syncthreads();
            for (int j = 1; j <= tb.m; ++j) {
              const T* tin = (j & 1) ? sm.t0 : sm.t1;
              T* tout = (j & 1) ? sm.t1 : sm.t0;
              matvec<T, CLUSTER>(sm.W, p, own, r_lo, tin, tout, j);
              sync_all<CLUSTER>();
              if (tid < D) sm.acc[tid] = add_rn(sm.acc[tid], tout[tid]);
            }
            __syncthreads();
            if (tid < D) sm.v[tid] = sm.acc[tid];
            __syncthreads();
          }
        } else {
          // 3b. formed: As = 2^-s W, T_m(As) by Paterson-Stockmeyer, s
          // squarings, each block its rows, the cluster's blocks ordered
          // by barriers; then P's rows back into W_s and one product
          T* const As = buf;
          T* const A2 = buf + n;
          T* const A3 = buf + 2 * n;
          T* const A4 = buf + 3 * n;
          T* const X = buf + 4 * n;
          T* const Y = buf + 5 * n;
          for (int idx = tid; idx < own * D; idx += THREADS) {
            const int i = idx / D, col = idx - i * D;
            As[(size_t)(r_lo + i) * D + col] = mul_rn(sm.W[(size_t)i * p.dp + col], scale);
          }
          sync_all<CLUSTER>();
          auto store = [=](T* C) {
            return [=](int i, int col, T v) { C[(size_t)i * D + col] = v; };
          };
          auto accumulate = [=](T* C) {
            return [=](int i, int col, T v) {
              T* cp = C + (size_t)i * D + col;
              *cp = add_rn(*cp, v);
            };
          };
          rows_product<T, false>(As, As, nullptr, nullptr, D, r_lo, r_hi, p, sm.ring, store(A2));
          sync_all<CLUSTER>();
          rows_product<T, false>(A2, As, nullptr, nullptr, D, r_lo, r_hi, p, sm.ring, store(A3));
          sync_all<CLUSTER>();
          rows_product<T, false>(A3, As, nullptr, nullptr, D, r_lo, r_hi, p, sm.ring, store(A4));
          sync_all<CLUSTER>();
          // m = 12: X = B2 + c12 A4, Y = B1; Y = A4 X + Y; X = B0;
          // X = A4 Y + X. m = 8: X = B1 + c8 A4, Y = B0; Y = A4 X + Y.
          const bool m12 = tb.m == 12;
          const T c_top = (T)FACT_INV[m12 ? 12 : 8];
          for (int idx = tid; idx < own * D; idx += THREADS) {
            const int i = r_lo + idx / D, col = idx % D;
            const size_t at = (size_t)i * D + col;
            const bool diag = i == col;
            X[at] = add_rn(ps_block<T>(m12 ? 2 : 1, diag, As[at], A2[at], A3[at]),
                           mul_rn(c_top, A4[at]));
            Y[at] = ps_block<T>(m12 ? 1 : 0, diag, As[at], A2[at], A3[at]);
          }
          sync_all<CLUSTER>();
          rows_product<T, false>(A4, X, nullptr, nullptr, D, r_lo, r_hi, p, sm.ring,
                                 accumulate(Y));
          sync_all<CLUSTER>();
          T* P = Y;
          if (m12) {
            for (int idx = tid; idx < own * D; idx += THREADS) {
              const int i = r_lo + idx / D, col = idx % D;
              const size_t at = (size_t)i * D + col;
              X[at] = ps_block<T>(0, i == col, As[at], A2[at], A3[at]);
            }
            sync_all<CLUSTER>();
            rows_product<T, false>(A4, Y, nullptr, nullptr, D, r_lo, r_hi, p, sm.ring,
                                   accumulate(X));
            sync_all<CLUSTER>();
            P = X;
          }
          for (int it = 0; it < s; ++it) {
            T* const Q = P == X ? Y : X;
            rows_product<T, false>(P, P, nullptr, nullptr, D, r_lo, r_hi, p, sm.ring, store(Q));
            sync_all<CLUSTER>();
            P = Q;
          }
          for (int idx = tid; idx < own * p.dpr; idx += THREADS) {
            const int i = idx / p.dpr, col = idx - i * p.dpr;
            sm.W[(size_t)i * p.dp + col] = col < D ? P[(size_t)(r_lo + i) * D + col] : T(0);
          }
          __syncthreads();
          matvec<T, CLUSTER>(sm.W, p, own, r_lo, sm.v, sm.t0, 0);
          sync_all<CLUSTER>();
          if (tid < D) sm.v[tid] = sm.t0[tid];
          __syncthreads();
        }
      }
      if (c == 0) {
        if (tid < D) {
          if (rank == 0) y[(size_t)b * D + tid] = sm.v[tid];
          sm.ymain[tid] = sm.v[tid];
        }
        if (tb.n_chains == 1 && tid == 0 && rank == 0) err[b] = T(0);
      } else {
        // the declared norm of the chains' difference: a weight per
        // column, then l2 or a NaN-propagating max, then the post factor
        T dv = T(0);
        if (tid < D) {
          dv = sm.v[tid] - sm.ymain[tid];
          if (w_row != nullptr) dv = dv * w_row[tid];
        }
        sm.red[tid] = kind_max ? fabs(dv) : dv * dv;
        __syncthreads();
        for (int hh = THREADS / 2; hh > 0; hh >>= 1) {
          if (tid < hh)
            sm.red[tid] = kind_max ? nan_max(sm.red[tid], sm.red[tid + hh])
                                   : sm.red[tid] + sm.red[tid + hh];
          __syncthreads();
        }
        if (tid == 0 && rank == 0) {
          T norm = kind_max ? sm.red[0] : sqrt(sm.red[0]);
          if (post != T(1)) norm = norm * post;
          err[b] = norm;
        }
      }
      __syncthreads();
    }
  }
  // no block leaves while another of its cluster may still write into it
  sync_all<CLUSTER>();
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
  const double* q = t + TABLE_HEAD;
  for (int e = 0; e < MAX_EXPONENTS; ++e)
    for (int k = 0; k < MAX_NODES; ++k)
      tb->lin[e][k] = (e < n_exp && k < tb->n_nodes) ? q[e * tb->n_nodes + k] : 0.0;
  q += n_exp * tb->n_nodes;
  for (int k = 0; k < MAX_COMMS; ++k) {
    const bool in = k < tb->n_comm;
    tb->comm_exp[k] = in ? (int)q[4 * k] : -1;
    tb->comm_p[k] = in ? (int)q[4 * k + 1] : 0;
    tb->comm_q[k] = in ? (int)q[4 * k + 2] : 0;
    tb->comm_g[k] = in ? q[4 * k + 3] : 0.0;
    if (in && (tb->comm_exp[k] < 0 || tb->comm_exp[k] >= n_exp || tb->comm_p[k] < 0 ||
               tb->comm_p[k] >= tb->n_nodes || tb->comm_q[k] < 0 || tb->comm_q[k] >= tb->n_nodes))
      return false;
  }
  return true;
}

// the card's limits, read once per device
struct Limits {
  int max_smem, n_sm, smem_sm, reserved;
};

cudaError_t limits_of(int* dev, Limits* out) {
  static Limits seen[MAX_DEVICES];
  cudaError_t st = cudaGetDevice(dev);
  if (st != cudaSuccess) return st;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Limits& l = seen[*dev];
  if (l.n_sm == 0) {
    Limits q;
    st = cudaDeviceGetAttribute(&q.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (st == cudaSuccess)
      st = cudaDeviceGetAttribute(&q.n_sm, cudaDevAttrMultiProcessorCount, *dev);
    if (st == cudaSuccess)
      st = cudaDeviceGetAttribute(&q.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, *dev);
    if (st == cudaSuccess)
      st = cudaDeviceGetAttribute(&q.reserved, cudaDevAttrReservedSharedMemoryPerBlock, *dev);
    if (st != cudaSuccess) return st;
    l = q;
  }
  *out = l;
  return cudaSuccess;
}

// The plan of a launch over B trajectories of width D: out[0..7] = blocks
// a cluster, rows a block, rows a product chunk, W's padded row, threads a
// matrix-vector row, shared memory a block (bytes), clusters of the grid,
// scratch values the wrapper allocates. A CUDA error code, or 0.
template <typename T>
int plan_query(int B, int D, long long* out) {
  if (B < 1 || D < 1 || D > MAX_DIM || out == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  Limits l;
  const cudaError_t st = limits_of(&dev, &l);
  if (st != cudaSuccess) return (int)st;
  const Plan p = dense_plan<T>(D, (size_t)l.max_smem);
  if (p.cs == 0) return (int)cudaErrorInvalidValue;
  const int g = grid_clusters<T>(p, B, l.n_sm, l.smem_sm, l.reserved);
  const long long vals[8] = {p.cs, p.rows, p.rc, p.dp, p.tpr, (long long)p.smem, g,
                             (long long)g * N_BUF * D * D};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

template <typename T, bool CLUSTER>
int run(const Plan& p, int g, int dev, const T* node_ops, long long stride_b, long long stride_q,
        const T* dt, const T* x, T* y, T* err, T* scratch, int B, int D, const Table& tb,
        const T* w_row, T post, int kind_max, void* stream) {
  static size_t smem_allowed[MAX_DEVICES];
  auto kernel = dense_chains_kernel<T, CLUSTER>;
  if (p.smem > smem_allowed[dev]) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (st != cudaSuccess) return (int)st;
    smem_allowed[dev] = p.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g * p.cs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  const cudaError_t st = cudaLaunchKernelEx(&cfg, kernel, node_ops, stride_b, stride_q, dt, x, y,
                                            err, scratch, B, D, tb, w_row, post, kind_max, p);
  if (st != cudaSuccess) return (int)st;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* node_ops, long long stride_b, long long stride_q, const void* dt,
           const void* x, void* y, void* err, void* scratch, long long scratch_len, int B, int D,
           const double* table, int table_len, const void* w_row, double post, int kind_max,
           void* stream) {
  Table tb;
  if (B <= 0 || D <= 0 || D > MAX_DIM || scratch == nullptr ||
      !parse_table(table, table_len, &tb))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  Limits l;
  const cudaError_t st = limits_of(&dev, &l);
  if (st != cudaSuccess) return (int)st;
  const Plan p = dense_plan<T>(D, (size_t)l.max_smem);
  if (p.cs == 0) return (int)cudaErrorInvalidValue;
  const int g = grid_clusters<T>(p, B, l.n_sm, l.smem_sm, l.reserved);
  if (scratch_len < (long long)g * N_BUF * D * D) return (int)cudaErrorInvalidValue;
  if (p.cs > 1)
    return run<T, true>(p, g, dev, (const T*)node_ops, stride_b, stride_q, (const T*)dt,
                        (const T*)x, (T*)y, (T*)err, (T*)scratch, B, D, tb, (const T*)w_row,
                        (T)post, kind_max, stream);
  return run<T, false>(p, g, dev, (const T*)node_ops, stride_b, stride_q, (const T*)dt,
                       (const T*)x, (T*)y, (T*)err, (T*)scratch, B, D, tb, (const T*)w_row,
                       (T)post, kind_max, stream);
}

}  // namespace

extern "C" {

// The plan of a launch (plan_query): out[8] as there. 0 or a CUDA error.
int vec_ode_dense_chains_plan_f32(int B, int D, long long* out) {
  return plan_query<float>(B, D, out);
}
int vec_ode_dense_chains_plan_f64(int B, int D, long long* out) {
  return plan_query<double>(B, D, out);
}

// One step of every trajectory: node_ops the operator samples, sample q of
// trajectory b a contiguous (D, D) block at b * stride_b + q * stride_q
// (in values, any alignment); dt (B,), x (B, D); writes y (B, D) and err
// (B,), 0 where the table has one chain. scratch: scratch_len values, at
// least the plan's (out[7]), for the formed route. table: the float64
// values of ops/dense_chains.py:ChainTable.kernel_array, in host memory.
// w_row: D weights in device memory in the state's type, or null; post
// and kind_max (0: l2, 1: max) complete the declared error norm.
int vec_ode_dense_chains_f32(const void* node_ops, long long stride_b, long long stride_q,
                             const void* dt, const void* x, void* y, void* err, void* scratch,
                             long long scratch_len, int B, int D, const double* table,
                             int table_len, const void* w_row, double post, int kind_max,
                             void* stream) {
  return launch<float>(node_ops, stride_b, stride_q, dt, x, y, err, scratch, scratch_len, B, D,
                       table, table_len, w_row, post, kind_max, stream);
}

int vec_ode_dense_chains_f64(const void* node_ops, long long stride_b, long long stride_q,
                             const void* dt, const void* x, void* y, void* err, void* scratch,
                             long long scratch_len, int B, int D, const double* table,
                             int table_len, const void* w_row, double post, int kind_max,
                             void* stream) {
  return launch<double>(node_ops, stride_b, stride_q, dt, x, y, err, scratch, scratch_len, B, D,
                        table, table_len, w_row, post, kind_max, stream);
}

}  // extern "C"
