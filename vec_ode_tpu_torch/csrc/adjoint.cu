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
// K' = 3 in f32, one Taylor term of one chain is 256 x 128 x 384 x 2 =
// 25.2 MFLOP: the forward's 256 rows x 8 terms are 51.5 GFLOP, 0.77 ms at
// the card's 67 TFLOP/s FP32 (non-tensor) rate; the backward adds the
// a-chain and the K'^2 + K' Fréchet actions per term (six chains' worth at
// K' = 3; the Pallas kernel's K'^2 + 2K' would be seven), 312.9 GFLOP with
// the combinations and cbar, 4.67 ms. Occupancy at that batch: a block
// takes two trajectories (adj_tile), so 128 blocks fill the SMs, and a
// row's K' + 1 Fréchet chains run side by side in K' + 1 thread groups of
// the block; blocks of up to 256 threads keep 128 registers a thread. This
// first version is a plain SIMT kernel reading the basis from L2 at every
// term and latency-bound at this batch (two warps per SM in K7); tensor
// cores in an FP32-emulating form, basis reuse across more trajectories
// per block and more threads per trajectory are later work.

#include "adjoint_row.cuh"

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

template <typename T, int KP>
__global__ void ADJ_BOUNDS(false)
adjoint_sweep_fwd_kernel(const T* __restrict__ c_all, int R, const T* __restrict__ x,
                         const T* __restrict__ mt, T* __restrict__ y, int B, int D, int tile,
                         AdjParams<T> p) {
  extern __shared__ unsigned char smem_raw[];
  const AdjSmem<T> s = AdjSmem<T>::carve(reinterpret_cast<T*>(smem_raw), tile, D, KP, false);
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  load_tile(s.x, x, row0, rows, tile, D);
  for (int r = 0; r < R; ++r) {
    scale_tile(c_all + (size_t)r * KP, false, row0, rows, tile, s, p);
    __syncthreads();
    adj_state_chains<T, KP>(s, tile, D, mt, nullptr, p.m, T(1), false);
  }
  store_tile(y, s.x, row0, rows, D);
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
int geometry(int B, int D, int KP, bool frechet, Geometry<T>* g) {
  int dev = 0, max_smem = 0, n_sm = 0;
  const cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  g->tile = adj_tile<T>(B, D, KP, frechet, n_sm, max_smem);
  const int ncg = (D + CT - 1) / CT;
  const int items = adj_groups(KP, frechet) * g->tile * ncg;
  g->threads = (items + 31) / 32 * 32;
  g->smem = adj_smem_bytes<T>(g->tile, D, KP, frechet);
  g->blocks = (B + g->tile - 1) / g->tile;
  if (g->threads > (frechet ? ADJ_MAX_THREADS : ADJ_NARROW_THREADS) ||
      g->smem > (size_t)max_smem)
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
  const int rc = geometry<T>(B, D, KP, true, &g);
  if (rc != 0) return rc;
  return g.threads > ADJ_NARROW_THREADS
             ? launch_bwd<T, KP, true>(g, c, x, a, mt, ms, xn, an, cb, B, D, p, stream)
             : launch_bwd<T, KP, false>(g, c, x, a, mt, ms, xn, an, cb, B, D, p, stream);
}

template <typename T, int KP>
int run_fwd(const void* c_all, int R, const void* x, const void* mt, void* y, int B, int D,
            const AdjParams<T>& p, void* stream) {
  Geometry<T> g;
  int rc = geometry<T>(B, D, KP, false, &g);
  if (rc == 0) rc = allow_smem(adjoint_sweep_fwd_kernel<T, KP>, g.smem);
  if (rc != 0) return rc;
  adjoint_sweep_fwd_kernel<T, KP><<<g.blocks, g.threads, g.smem, (cudaStream_t)stream>>>(
      (const T*)c_all, R, (const T*)x, (const T*)mt, (T*)y, B, D, g.tile, p);
  return (int)cudaGetLastError();
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
  const int rc = geometry<T>(B, D, KP, true, &g);
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
  const AdjParams<T> p = parse<T>(KP, norms, m, theta, max_sq);
#define CALL(K) run_fwd<T, K>(c_all, R, x, mt, y, B, D, p, stream)
  ADJ_DISPATCH(KP, CALL)
#undef CALL
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
    rc = geometry<float>(B, D, KP, true, &g);
    blocks = g.blocks;
  } else {
    Geometry<double> g;
    rc = geometry<double>(B, D, KP, true, &g);
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
