// The embedded Runge-Kutta step of one tile of trajectories of
// dx/dt = (M0 + cos(w t) M1) x, as a device function that every thread of
// a block calls together. Shared by the per-step kernel (fused_rk_step.cu,
// K1) and the whole-loop kernel (fused_loop.cu, K2, whose step this is:
// the counterpart of vec_ode_tpu/ops/pallas_loop.py:make_rk_step_builder,
// K3).
//
// It computes what vec_ode_tpu/ops/pallas_rk.py:_make_kernel computes:
// every stage K_i = f(t + c_i dt, x + dt sum_j a_ij K_j), with both
// operator actions of a stage in one pass over MT = [M0^T | M1^T] (a
// (D, 2D) row-major matrix, so for a fixed contraction index the threads
// of a warp read consecutive columns); the advance x + dt sum_j b_j K_j
// (minus the error when advance_lower); the embedded error
// dt sum_j (b_j - b_err_j) K_j; and its per-row measure ErrNorm:
// optionally divided by atol + rtol max(|x|, |x_next|) (scaled_error),
// multiplied by a weight row, reduced by l2 or max, then multiplied by
// rtol (scaled_error) and by post (WeightedNorm rms), in that order, as
// make_rk_step_builder does.
//
// Layout. The tile's rows are trajectories of width D = 2d ([re | im]).
// The stage inputs and all s stage values live in ks, s slots of
// (tile, D) in shared memory; x and x_out may be in device or shared
// memory (generic pointers), t_rows and dt_rows too. Each thread owns RT
// rows x CT columns (columns cg, cg + ncg, ...), so every operator value
// it loads serves RT rows and every stage value serves 2*CT products.
// Rows at or past `rows` are computed on zeros and never written.
//
// Precision. Accumulation is IEEE FMA in the state's type, never TF32.
// The node t + c_i dt, the drive argument w t and the scaled_error
// denominator atol + rtol*m are rounded step by step (no contraction),
// cos is the full-precision one, and max and min propagate NaN as
// jnp.maximum and torch.maximum do (fmax would drop a NaN error and
// accept a step the controller must reject). Build without
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>

namespace vec_ode {

constexpr int MAX_STAGES = 7;
constexpr int MAX_WIDTH = 512;  // widened state width D = 2d (ops/fused_rk.py: MAX_WIDTH)
constexpr int CT = 4;           // columns per thread
constexpr int MAX_DEVICES = 64;

template <typename T>
struct Tableau {
  T a[MAX_STAGES][MAX_STAGES];
  T b[MAX_STAGES];
  T db[MAX_STAGES];  // b - b_err
  T c[MAX_STAGES];
};

// the per-row error measure of the step (see the note above)
template <typename T>
struct ErrNorm {
  const T* w_row;  // (D,) weights in device memory, or nullptr
  T post;          // multiplies the reduced norm (1 for l2 and max)
  int kind_max;    // 0: l2, 1: max
  int scaled;      // scaled_error: divide by atol + rtol max(|x|, |x_next|)
  T atol, rtol;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float cos_full(float a) { return cosf(a); }
__device__ __forceinline__ double cos_full(double a) { return cos(a); }
__device__ __forceinline__ float pow_full(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_full(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float fma_full(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_full(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_full(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_full(double a) { return sqrt(a); }

template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double eps_of<double>() { return DBL_EPSILON; }

template <typename T>
__device__ __forceinline__ bool is_nan(T a) { return a != a; }
// NaN-propagating max / min / clip (jnp.maximum, torch.clamp semantics)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (is_nan(a) || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (is_nan(a) || a < b) ? a : b; }
template <typename T>
__device__ __forceinline__ T nan_clip(T a, T lo, T hi) { return nan_min(nan_max(a, lo), hi); }

// One embedded RK step of a tile; every thread of the block calls it (it
// synchronises the block). ks: s slots of (tile, D) in shared memory; the
// block needs (tile / RT) * ceil(D / CT) threads or more. Writes x_out
// (rows, D) and err_out (rows,); err_out is zero without an embedded pair.
template <typename T, int RT>
__device__ void rk_step_tile(const T* __restrict__ t_rows, const T* __restrict__ dt_rows,
                             const T* __restrict__ x, T* __restrict__ x_out,
                             T* __restrict__ err_out, T* ks, int rows, int tile, int D,
                             const T* __restrict__ mt, const Tableau<T>& tab, int s,
                             int has_err, int advance_lower, T w, const ErrNorm<T>& en) {
  const size_t slot = (size_t)tile * D;
  const int ncg = (D + CT - 1) / CT;
  const int items = (tile / RT) * ncg;
  const int tid = threadIdx.x;
  const bool active = tid < items;
  const int cg = tid % ncg;
  const int rg = tid / ncg;

  T tr[RT], dtr[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int lr = rg * RT + q;
    const bool ok = active && lr < rows;
    tr[q] = ok ? t_rows[lr] : T(0);
    dtr[q] = ok ? dt_rows[lr] : T(0);
  }

  for (int i = 0; i < s; ++i) {
    T* xi = ks + i * slot;
    // stage input x + dt * sum_j a_ij K_j into slot i (zero-weight terms
    // skipped, the sum taken in stage order, as the plain step does)
    if (active) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int lr = rg * RT + q;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          if (col >= D) continue;
          const T xv = lr < rows ? x[(size_t)lr * D + col] : T(0);
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

  // advance, embedded error and the per-row partial l2 sums or maxima
  T part[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) part[q] = T(0);
  if (active) {
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int lr = rg * RT + q;
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        const int col = cg + k * ncg;
        if (col >= D || lr >= rows) continue;
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
        const T xv = x[e];
        const T xb = xv + dtr[q] * sb;
        T out = xb;
        if (has_err) {
          const T err = dtr[q] * se;
          if (advance_lower) out = xb - err;
          T v = err;
          if (en.scaled)
            v = v / add_rn(en.atol, mul_rn(en.rtol, nan_max(fabs(xv), fabs(out))));
          if (en.w_row != nullptr) v = v * en.w_row[col];
          part[q] = en.kind_max ? nan_max(fabs(v), part[q]) : part[q] + v * v;
        }
        x_out[e] = out;
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
  for (int lr = tid; lr < rows; lr += blockDim.x) {
    T acc = T(0);
    for (int g = 0; g < ncg; ++g) {
      const T p = red[lr * ncg + g];
      acc = en.kind_max ? nan_max(p, acc) : acc + p;
    }
    T norm = T(0);
    if (has_err) {
      norm = en.kind_max ? acc : sqrt_full(acc);
      if (en.scaled) norm = norm * en.rtol;
      if (en.post != T(1)) norm = norm * en.post;
    }
    err_out[lr] = norm;
  }
}

}  // namespace vec_ode
