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
// difference of two chains near rounding level. This first version is a
// plain SIMT kernel reading the basis from L2 at every term; tensor cores
// (in an FP32-emulating form), TMA, persistent blocks and regrouping rows
// by pass count are later work.

#include "chain_step.cuh"

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

template <typename T>
int launch(const void* g, const void* dt, const void* x, const void* mt, void* y, void* err,
           int B, int D, const double* chain, const void* w_row, double post, int kind_max,
           void* stream) {
  if (B <= 0 || D <= 0 || D > MAX_WIDTH || g == nullptr) return (int)cudaErrorInvalidValue;
  const ChainParams<T> p = parse_chain_params<T>(chain);
  if (!chain_params_ok(p)) return (int)cudaErrorInvalidValue;
  const ErrNorm<T> en{(const T*)w_row, (T)post, kind_max, 0, T(0), T(0)};
  if (p.K0 > REG_K0) return run<T, KP_DYN>(p, en, g, dt, x, mt, y, err, B, D, stream);
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
