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
// l2 norm. The tableau arrives as data (up to 7 stages), so RKF45, DOPRI5,
// BOSH32 and Cash-Karp share this one kernel. Without b_err the error norm
// is zero.
//
// Layout. Rows are trajectories, the state is the widened real pair
// [re | im] of width D = 2d, and each stage is the row product x M^T. The
// wrapper passes MT = [M0^T | M1^T], a (D, 2D) row-major matrix, so that
// for a fixed contraction index j the threads of a warp read consecutive
// columns. One block takes a tile of rows; the stage inputs and all s
// stage values stay in shared memory (s slots of tile x D) and never reach
// device memory. The block writes only x_out (B, D) and err_out (B,).
// Each thread owns RT rows x CT columns (columns cg, cg + ncg, ...), so
// every operator value it loads serves RT rows and every stage value
// serves 2*CT products. The ragged last tile is masked; any D up to
// MAX_WIDTH is taken (the wrapper raises above it).
//
// What bounds it: FP32 FMA throughput. A step at 16384 x 64 complex is
// 6 stages x (B * 128 * 256 * 2) = about 6.4 GFLOP against 8 MB in and
// 8 MB out. All accumulation is IEEE FMA in the state's type, never TF32:
// at rtol = 1e-8 in f32 the embedded error (~1e-9 per component) sits near
// rounding level. The time node t + c_i dt and the drive argument w t are
// rounded separately (no contraction) and cos is the full-precision one,
// as in the plain torch step; build without --use_fast_math.
//
// This first version is a plain SIMT kernel with one block of <= 256
// threads per tile. Making it fast (mma or wgmma in 3xTF32 or another
// FP32-emulating form, TMA loads of the operators, a persistent block per
// SM) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_STAGES = 7;
constexpr int RT = 8;            // rows per thread
constexpr int CT = 4;            // columns per thread
constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE = 64;     // rows per block
constexpr int MAX_WIDTH = 512;   // widened state width D = 2d (ops/fused_rk.py: MAX_WIDTH)
constexpr int MAX_DEVICES = 64;

template <typename T>
struct Tableau {
  T a[MAX_STAGES][MAX_STAGES];
  T b[MAX_STAGES];
  T db[MAX_STAGES];  // b - b_err
  T c[MAX_STAGES];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float cos_full(float a) { return cosf(a); }
__device__ __forceinline__ double cos_full(double a) { return cos(a); }
__device__ __forceinline__ float fma_full(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_full(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_full(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_full(double a) { return sqrt(a); }

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
fused_rk_step_kernel(const T* __restrict__ t, const T* __restrict__ dt,
                     const T* __restrict__ x, const T* __restrict__ mt,
                     T* __restrict__ x_out, T* __restrict__ err_out,
                     int B, int D, int tile, Tableau<T> tab, int s,
                     int has_err, int advance_lower, T w) {
  extern __shared__ unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // s slots of (tile, D)
  const size_t slot = (size_t)tile * D;
  const int ncg = (D + CT - 1) / CT;
  const int items = (tile / RT) * ncg;
  const int tid = threadIdx.x;
  const bool active = tid < items;
  const int cg = tid % ncg;
  const int rg = tid / ncg;
  const long row0 = (long)blockIdx.x * tile;

  T tr[RT], dtr[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const long r = row0 + rg * RT + q;
    const bool ok = active && r < B;
    tr[q] = ok ? t[r] : T(0);
    dtr[q] = ok ? dt[r] : T(0);
  }

  for (int i = 0; i < s; ++i) {
    T* xi = ks + i * slot;
    // stage input x + dt * sum_j a_ij K_j into slot i (zero-weight terms
    // skipped, the sum taken in stage order, as the plain step does)
    if (active) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int lr = rg * RT + q;
        const long r = row0 + lr;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          if (col >= D) continue;
          const T xv = r < B ? x[r * D + col] : T(0);
          T acc = T(0);
          bool any = false;
          for (int j = 0; j < i; ++j) {
            const T aij = tab.a[i][j];
            if (aij == T(0)) continue;
            const T term = aij * ks[j * slot + (size_t)lr * D + col];
            acc = any ? acc + term : term;
            any = true;
          }
          xi[(size_t)lr * D + col] = any ? xv + dtr[q] * acc : xv;
        }
      }
    }
    __syncthreads();

    // both operator actions: y0 = x_i M0^T, y1 = x_i M1^T
    T y0[RT][CT], y1[RT][CT];
#pragma unroll
    for (int q = 0; q < RT; ++q)
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        y0[q][k] = T(0);
        y1[q][k] = T(0);
      }
    if (active) {
      const T* xrow = xi + (size_t)(rg * RT) * D;
#pragma unroll 4
      for (int j = 0; j < D; ++j) {
        T xv[RT];
#pragma unroll
        for (int q = 0; q < RT; ++q) xv[q] = xrow[(size_t)q * D + j];
        const T* mrow = mt + (size_t)j * 2 * D;
        T m0[CT], m1[CT];
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          m0[k] = col < D ? __ldg(mrow + col) : T(0);
          m1[k] = col < D ? __ldg(mrow + D + col) : T(0);
        }
#pragma unroll
        for (int q = 0; q < RT; ++q)
#pragma unroll
          for (int k = 0; k < CT; ++k) {
            y0[q][k] = fma_full(xv[q], m0[k], y0[q][k]);
            y1[q][k] = fma_full(xv[q], m1[k], y1[q][k]);
          }
      }
    }
    __syncthreads();  // every read of slot i is done

    // K_i = y0 + u(t_i) y1 replaces the stage input in slot i
    if (active) {
      const T ci = tab.c[i];
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        // the first node is t itself, as in the plain step
        const T ti = i == 0 ? tr[q] : add_rn(tr[q], mul_rn(ci, dtr[q]));
        const T u = cos_full(mul_rn(w, ti));
        const int lr = rg * RT + q;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          if (col < D) ks[i * slot + (size_t)lr * D + col] = y0[q][k] + u * y1[q][k];
        }
      }
    }
    __syncthreads();
  }

  // advance, embedded error and the per-row partial sums of err^2
  T part[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) part[q] = T(0);
  if (active) {
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int lr = rg * RT + q;
      const long r = row0 + lr;
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        const int col = cg + k * ncg;
        if (col >= D || r >= B) continue;
        const size_t e = (size_t)lr * D + col;
        T sb = T(0), se = T(0);
        bool anyb = false, anye = false;
        for (int j = 0; j < s; ++j) {
          const T kj = ks[j * slot + e];
          if (tab.b[j] != T(0)) {
            const T term = tab.b[j] * kj;
            sb = anyb ? sb + term : term;
            anyb = true;
          }
          if (has_err && tab.db[j] != T(0)) {
            const T term = tab.db[j] * kj;
            se = anye ? se + term : term;
            anye = true;
          }
        }
        const T xv = x[r * D + col];
        const T xb = xv + dtr[q] * sb;
        T out = xb;
        if (has_err) {
          const T err = dtr[q] * se;
          if (advance_lower) out = xb - err;
          part[q] += err * err;
        }
        x_out[r * D + col] = out;
      }
    }
  }
  __syncthreads();  // the stage slots are free: slot 0 takes the partials
  T* red = ks;      // (tile, ncg)
  if (active) {
#pragma unroll
    for (int q = 0; q < RT; ++q) red[(rg * RT + q) * ncg + cg] = part[q];
  }
  __syncthreads();
  for (int lr = tid; lr < tile && row0 + lr < B; lr += blockDim.x) {
    T acc = T(0);
    for (int g = 0; g < ncg; ++g) acc += red[lr * ncg + g];
    err_out[row0 + lr] = has_err ? sqrt_full(acc) : T(0);
  }
}

template <typename T>
int launch(const void* t, const void* dt, const void* x, const void* mt,
           void* x_out, void* err_out, int B, int D, const double* tab_in,
           int s, int has_err, int advance_lower, double w, void* stream) {
  if (B <= 0 || D <= 0 || D > MAX_WIDTH || s <= 0 || s > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  Tableau<T> tab;
  for (int i = 0; i < MAX_STAGES; ++i) {
    for (int j = 0; j < MAX_STAGES; ++j) tab.a[i][j] = (T)tab_in[i * MAX_STAGES + j];
    tab.b[i] = (T)tab_in[MAX_STAGES * MAX_STAGES + i];
    tab.db[i] = (T)tab_in[MAX_STAGES * MAX_STAGES + MAX_STAGES + i];
    tab.c[i] = (T)tab_in[MAX_STAGES * MAX_STAGES + 2 * MAX_STAGES + i];
  }
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
      s, has_err, advance_lower, (T)w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tab: MAX_STAGES*MAX_STAGES values of a, then b, b - b_err and c, each
// MAX_STAGES long, zero-padded, row-major, in float64 host memory.
int vec_ode_fused_rk_step_f32(const void* t, const void* dt, const void* x, const void* mt,
                              void* x_out, void* err_out, int B, int D, const double* tab,
                              int s, int has_err, int advance_lower, double w, void* stream) {
  return launch<float>(t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err, advance_lower, w,
                       stream);
}

int vec_ode_fused_rk_step_f64(const void* t, const void* dt, const void* x, const void* mt,
                              void* x_out, void* err_out, int B, int D, const double* tab,
                              int s, int has_err, int advance_lower, double w, void* stream) {
  return launch<double>(t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err, advance_lower, w,
                        stream);
}

}  // extern "C"
