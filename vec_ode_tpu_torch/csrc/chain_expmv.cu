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
// basis terms (K' <= 36 working terms with the Magnus commutators).
// It reads the coefficients sampled at the recipe's nodes, (J, B, K0), dt (B,) and the
// widened state x (B, D), and writes y (B, D) and the per-row error norm
// (B,). The step itself is the device function chain_step_tile of
// chain_step.cuh, which the whole-loop kernel (fused_loop.cu) runs too;
// the header's note has what it computes, the layout and the precision
// rules.
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
// Two launch routes of the one body, chosen by chain_plan below (no
// option picks one; both give the same bits, so the choice changes only
// the time):
//  * tiled: a block owns a tile of rows and every column: 64 rows in f32
//    (256 threads, 8 x 4 outputs each), 32 in f64 (4 x 4: the f64
//    registers), the basis streamed through a ring of three panels of JC
//    contraction rows (32 at D = 128 in f32, 16 KB; gemm_tile.cuh:
//    PanelRing), the copy of panel p + 2 in flight while panel p is
//    multiplied, or resident where it fits the ring's 48 KB (D <= 64 at
//    K' = 3 in f32). At B = 16384, D = 128: 256 blocks.
//  * cluster: where the tiled plan gives fewer blocks than SMs (B = 256,
//    D = 128: 16 blocks for 132 SMs, and each Taylor term's 98 304 FMAs a
//    row a long chain on 16 SMs), each tile runs on a thread-block cluster
//    of N <= 4 blocks, each owning D / N columns of all the tile's rows
//    with 1 x 2 outputs a thread, its columns of every M_k^T resident in
//    its shared memory (48 KB at D = 128, K' = 3, N = 4 in f32; streamed
//    through its own ring where they do not fit), up to four basis terms'
//    chains side by side (gemm_tile.cuh: tile_fma_n). After each term
//    every block writes its slice of the new term into every block's copy
//    (distributed shared memory), then one cluster barrier; the error
//    vector is gathered in the first block and reduced there in the tiled
//    route's order. At B = 256, D = 128: tiles of 4 rows, 64 clusters of
//    4, 256 blocks of 64 threads. On an H100 clusters of 4 ran 6-11%
//    faster than clusters of 8 at 256 (2: 2x slower), 16-row tiles, 1 x 4
//    and 2 x 2 outputs a thread slower (tools/compare_parent.py against
//    variant builds).
//
// Tensor cores in an FP32-emulating form (3xTF32 changes the bits; TF32
// must not enter), f64 DMMA (another summation order), TMA, persistent
// blocks and regrouping rows by pass count are later work.

#include "chain_step.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace vec_ode;

constexpr int CLUSTER_MAX = 4;                 // blocks a cluster (8 is the portable limit)
constexpr int CLUSTER_RM = 1, CLUSTER_CN = 2;  // the cluster route's outputs a thread
constexpr int CLUSTER_TILE = 16;               // rows a cluster at most

// Rows per thread of the tiled route.
template <typename T>
constexpr int gemm_rm() {
  return sizeof(T) == 4 ? GEMM_RM_F32 : GEMM_RM_F64;
}

// K4's launch: the route, blocks per tile (the cluster's size, 1 tiled),
// rows per tile, the columns a block owns (the last block of a cluster
// fewer where they do not divide D), threads and shared memory a block.
struct ChainPlan {
  int cluster, n, tile, dc, threads;
  size_t smem;
};

// The plan (see the note above). Tiled: the largest power of two up to 128
// rows whose threads (tile / RM) x DP / 4 fit GEMM_THREADS and whose shared
// memory fits max_smem, halved while the batch gives fewer blocks than
// SMs, down to 16. If that still gives fewer blocks than SMs, the cluster
// route: dc = ceil(D / CLUSTER_MAX) columns a block (rounded up to
// CLUSTER_CN), N = ceil(D / dc) >= 2 blocks a tile, and tiles of the largest power of two up
// to CLUSTER_TILE rows that fits, halved while the clusters' blocks are
// fewer than SMs. ops/expmv.py:chain_plan mirrors it.
template <typename T>
ChainPlan chain_plan(int B, int D, const ChainParams<T>& p, int n_sm, size_t max_smem) {
  constexpr int RM = gemm_rm<T>();
  const int ncg = gemm_dp(D) / GEMM_CN;
  int tile = 128;
  while (tile > RM && ((tile / RM) * ncg > GEMM_THREADS ||
                       ChainLayout<T>(tile, D, D, p, false, true).total > max_smem))
    tile /= 2;
  while (tile > 16 && (B + tile - 1) / tile < n_sm) tile /= 2;
  const int per = (D + CLUSTER_MAX - 1) / CLUSTER_MAX;
  const int dc = (per + CLUSTER_CN - 1) / CLUSTER_CN * CLUSTER_CN;
  const int n = (D + dc - 1) / dc;
  if ((B + tile - 1) / tile >= n_sm || n < 2)
    return ChainPlan{0, 1, tile, D, ((tile / RM) * ncg + 31) / 32 * 32,
                     ChainLayout<T>(tile, D, D, p, false, true).total};
  const int ncl = (dc + CLUSTER_CN - 1) / CLUSTER_CN;
  int ct = CLUSTER_TILE;
  while (ct > CLUSTER_RM && ((ct / CLUSTER_RM) * ncl > GEMM_THREADS ||
                             ChainLayout<T>(ct, D, dc, p, true, true).total > max_smem))
    ct /= 2;
  while (ct > CLUSTER_RM && (B + ct - 1) / ct * n < n_sm) ct /= 2;
  return ChainPlan{1, n, ct, dc, ((ct / CLUSTER_RM) * ncl + 31) / 32 * 32,
                   ChainLayout<T>(ct, D, dc, p, true, true).total};
}

// One tile of rows (CLUSTER: one block of the tile's cluster, owning the
// columns [rank dc, rank dc + dc) clipped to D). Thread t owns rows
// [lr0, lr0 + RM) and CN columns from col0 of them (chain_step_tile).
template <typename T, int RM, int CN, bool CLUSTER>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
chain_expmv_kernel(const T* __restrict__ g, const T* __restrict__ dt, const T* __restrict__ x,
                   const T* __restrict__ mt, T* __restrict__ y, T* __restrict__ err, int B,
                   int D, int tile, int dc, ChainParams<T> p, ErrNorm<T> en) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const ChainLayout<T> L(tile, D, dc, p, CLUSTER, true);
  const ChainSmem<T> sm(chain_smem, L);
  int t = blockIdx.x, rank = 0;
  if constexpr (CLUSTER) {
    const auto cluster = cooperative_groups::this_cluster();
    rank = (int)cluster.block_rank();
    t = blockIdx.x / (int)cluster.num_blocks();
  }
  const int c0 = rank * dc, dcb = D - c0 < dc ? D - c0 : dc;
  PanelRing<T> ring(mt, sm.ring, D, p.KP, c0, dcb, dc);
  const long row0 = (long)t * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  const int K0 = p.K0;

  ring.prologue();  // streamed: the basis' first panels land while the rows are built
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    sm.dt[lr] = lr < rows ? dt[row0 + lr] : T(0);
    for (int nd = 0; nd < p.J; ++nd)
      for (int k = 0; k < K0; ++k)
        sm.g[((size_t)nd * tile + lr) * K0 + k] =
            lr < rows ? g[((size_t)nd * B + row0 + lr) * K0 + k] : T(0);
  }
  __syncthreads();
  chain_step_tile<T, RM, CN, CLUSTER>(sm.dt, x + row0 * D, y + row0 * D, err + row0, sm, ring,
                                      rows, tile, D, c0, dcb, p, en);
  ring.drain();  // the stream's last speculative panels
}

template <typename T, int RM, int CN, bool CLUSTER>
int run(const ChainPlan& pl, const ChainParams<T>& p, const ErrNorm<T>& en, const void* g,
        const void* dt, const void* x, const void* mt, void* y, void* err, int B, int D, int dev,
        void* stream) {
  static size_t smem_allowed[MAX_DEVICES];
  auto kernel = chain_expmv_kernel<T, RM, CN, CLUSTER>;
  if (pl.smem > smem_allowed[dev]) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (st != cudaSuccess) return (int)st;
    smem_allowed[dev] = pl.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((B + pl.tile - 1) / pl.tile) * pl.n));
  cfg.blockDim = dim3((unsigned)pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  const cudaError_t st = cudaLaunchKernelEx(&cfg, kernel, (const T*)g, (const T*)dt, (const T*)x,
                                            (const T*)mt, (T*)y, (T*)err, B, D, pl.tile, pl.dc,
                                            p, en);
  if (st != cudaSuccess) return (int)st;
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
  int dev = 0, max_smem = 0, n_sm = 0;
  const cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  const ChainPlan pl = chain_plan<T>(B, D, p, n_sm, (size_t)max_smem);
  if (pl.threads > GEMM_THREADS || pl.smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (pl.cluster)
    return run<T, CLUSTER_RM, CLUSTER_CN, true>(pl, p, en, g, dt, x, mt, y, err, B, D, dev,
                                                stream);
  return run<T, gemm_rm<T>(), GEMM_CN, false>(pl, p, en, g, dt, x, mt, y, err, B, D, dev, stream);
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
