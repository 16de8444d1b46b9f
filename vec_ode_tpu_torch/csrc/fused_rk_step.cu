// One whole embedded explicit Runge-Kutta step for an ensemble of
// trajectories of dx/dt = (M0 + cos(w t) M1) x, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel vec_ode_tpu/ops/pallas_rk.py:_make_kernel,
// launched by vec_ode_tpu/ops/pallas_rk.py:fused_rk_step. It computes the
// same function: every stage K_i = f(t + c_i dt, x + dt sum_j a_ij K_j),
// with both operator actions of a stage in one pass over the operators;
// the advance x + dt sum_j b_j K_j (minus the error when advance_lower);
// the embedded error dt sum_j (b_j - b_err_j) K_j; and its per-trajectory
// norm: l2, or a declared WeightedNorm (a weight row, l2 or max, a post
// factor; pallas_rk.py:119-129). The tableau arrives as data (up to 7
// stages), so RKF45, DOPRI5, BOSH32 and Cash-Karp share this one kernel.
// Without b_err the error norm is zero. The step itself is the device
// function rk_step_tile of rk_step.cuh, which the whole-loop kernel
// (fused_loop.cu) runs too; the header's note has the layout and the
// precision rules.
//
// Blocks. One block takes a tile of rows; the stage inputs and all s
// stage values stay in shared memory (s slots of tile x D) and never reach
// device memory. The block writes only x_out (B, D) and err_out (B,). Each
// thread owns RT = 8 rows x CT = 4 columns. The ragged last tile is
// masked; any D up to MAX_WIDTH is taken (the wrapper raises above it).
//
// What bounds it: FP32 FMA throughput. A step at 16384 x 64 complex is
// 6 stages x (B * 128 * 256 * 2) = about 6.4 GFLOP against 8 MB in and
// 8 MB out: 0.096 ms at the card's 67 TFLOP/s FP32 (non-tensor) rate.
// TF32 would be faster but must not enter an error estimate: at
// rtol = 1e-8 in f32 the embedded error (~1e-9 per component) sits near
// rounding level.
//
// This first version is a plain SIMT kernel with one block of <= 256
// threads per tile. Making it fast (mma or wgmma in 3xTF32 or another
// FP32-emulating form, TMA loads of the operators, a persistent block per
// SM) is later work.

#include "rk_step.cuh"

namespace {

using namespace vec_ode;

constexpr int RT = 8;            // rows per thread
constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE = 64;     // rows per block

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
fused_rk_step_kernel(const T* __restrict__ t, const T* __restrict__ dt,
                     const T* __restrict__ x, const T* __restrict__ mt,
                     T* __restrict__ x_out, T* __restrict__ err_out,
                     int B, int D, int tile, Tableau<T> tab, int s,
                     int has_err, int advance_lower, T w, ErrNorm<T> en) {
  extern __shared__ unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // s slots of (tile, D)
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  rk_step_tile<T, RT>(t + row0, dt + row0, x + row0 * D, x_out + row0 * D, err_out + row0, ks,
                      rows, tile, D, mt, tab, s, has_err, advance_lower, w, en);
}

template <typename T>
int launch(const void* t, const void* dt, const void* x, const void* mt,
           void* x_out, void* err_out, int B, int D, const double* tab_in,
           int s, int has_err, int advance_lower, double w, const void* w_row,
           double post, int kind_max, void* stream) {
  if (B <= 0 || D <= 0 || D > MAX_WIDTH || s <= 0 || s > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  Tableau<T> tab;
  for (int i = 0; i < MAX_STAGES; ++i) {
    for (int j = 0; j < MAX_STAGES; ++j) tab.a[i][j] = (T)tab_in[i * MAX_STAGES + j];
    tab.b[i] = (T)tab_in[MAX_STAGES * MAX_STAGES + i];
    tab.db[i] = (T)tab_in[MAX_STAGES * MAX_STAGES + MAX_STAGES + i];
    tab.c[i] = (T)tab_in[MAX_STAGES * MAX_STAGES + 2 * MAX_STAGES + i];
  }
  const ErrNorm<T> en{(const T*)w_row, (T)post, kind_max, 0, T(0), T(0)};
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  // per device, kept across launches: the opt-in shared-memory limit, and
  // the dynamic shared memory this instantiation has been allowed so far
  static int max_smem_of[MAX_DEVICES];
  static size_t smem_allowed[MAX_DEVICES];
  if (max_smem_of[dev] == 0) {
    st = cudaDeviceGetAttribute(&max_smem_of[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (st != cudaSuccess) return (int)st;
  }
  const int max_smem = max_smem_of[dev];

  // the largest tile whose thread count and stage slots fit one block
  const int ncg = (D + CT - 1) / CT;
  int tile = MAX_TILE;
  auto smem_of = [&](int tl) { return (size_t)s * tl * D * sizeof(T); };
  while (tile > RT && ((tile / RT) * ncg > MAX_THREADS || smem_of(tile) > (size_t)max_smem))
    tile /= 2;
  const int items = (tile / RT) * ncg;
  if (items > MAX_THREADS || smem_of(tile) > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const int threads = ((items + 31) / 32) * 32;
  const size_t smem = smem_of(tile);
  if (smem > smem_allowed[dev]) {
    st = cudaFuncSetAttribute(fused_rk_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (st != cudaSuccess) return (int)st;
    smem_allowed[dev] = smem;
  }
  const int blocks = (B + tile - 1) / tile;
  fused_rk_step_kernel<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)t, (const T*)dt, (const T*)x, (const T*)mt, (T*)x_out, (T*)err_out, B, D, tile, tab,
      s, has_err, advance_lower, (T)w, en);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tab: MAX_STAGES*MAX_STAGES values of a, then b, b - b_err and c, each
// MAX_STAGES long, zero-padded, row-major, in float64 host memory.
// w_row: D weights in device memory in the state's type, or null; post
// and kind_max (0: l2, 1: max) complete the declared error norm.
int vec_ode_fused_rk_step_f32(const void* t, const void* dt, const void* x, const void* mt,
                              void* x_out, void* err_out, int B, int D, const double* tab,
                              int s, int has_err, int advance_lower, double w,
                              const void* w_row, double post, int kind_max, void* stream) {
  return launch<float>(t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err, advance_lower, w,
                       w_row, post, kind_max, stream);
}

int vec_ode_fused_rk_step_f64(const void* t, const void* dt, const void* x, const void* mt,
                              void* x_out, void* err_out, int B, int D, const double* tab,
                              int s, int has_err, int advance_lower, double w,
                              const void* w_row, double post, int kind_max, void* stream) {
  return launch<double>(t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err, advance_lower, w,
                        w_row, post, kind_max, stream);
}

}  // extern "C"
