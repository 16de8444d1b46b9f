// What every kernel body of the port shares: the width and stage limits,
// the tableau and error-norm declarations, the explicitly rounded
// operations, NaN-propagating max / min, the device's limits, and the
// per-row error measure that the RK step (rk_step.cuh) and the chain step
// (chain_step.cuh) both end with.
//
// Precision. mul_rn / add_rn / sub_rn round each operation on its own, so
// that nvcc's default --fmad contracts nothing the plain twins round
// twice; cos, pow and sqrt are the full-precision ones; max and min
// propagate NaN as jnp.maximum and torch.maximum do (fmax would drop a
// NaN error and accept a step the controller must reject). Build without
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>

namespace vec_ode {

constexpr int MAX_STAGES = 7;
constexpr int MAX_WIDTH = 512;  // widened state width D = 2d (ops/fused_rk.py: MAX_WIDTH)
constexpr int CT = 4;           // columns of a column group of the error measure
constexpr int MAX_DEVICES = 64;

template <typename T>
struct Tableau {
  T a[MAX_STAGES][MAX_STAGES];
  T b[MAX_STAGES];
  T db[MAX_STAGES];  // b - b_err
  T c[MAX_STAGES];
};

// The tableau from the float64 layout of ops/fused_rk.py:_tableau_array:
// a (MAX_STAGES x MAX_STAGES, row-major), then b, b - b_err and c.
template <typename T>
Tableau<T> parse_tableau(const double* in) {
  Tableau<T> tab;
  for (int i = 0; i < MAX_STAGES; ++i) {
    for (int j = 0; j < MAX_STAGES; ++j) tab.a[i][j] = (T)in[i * MAX_STAGES + j];
    tab.b[i] = (T)in[MAX_STAGES * MAX_STAGES + i];
    tab.db[i] = (T)in[MAX_STAGES * MAX_STAGES + MAX_STAGES + i];
    tab.c[i] = (T)in[MAX_STAGES * MAX_STAGES + 2 * MAX_STAGES + i];
  }
  return tab;
}

// the per-row error measure of a step: optionally divided by atol + rtol
// max(|x|, |x_next|) (scaled_error), multiplied by a weight row, reduced
// by l2 or max, then multiplied by rtol (scaled_error) and by post
// (WeightedNorm rms), in that order, as make_rk_step_builder does
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

// The declared forms a kernel samples in-kernel (ops/forms.py: FORMS): the
// chain steps (chain_step.cuh) take K0 of them as coefficient functions,
// the RK step (rk_step.cuh) one as its drive u(t).
constexpr int FORM_COEFF = 0, FORM_CHEB = 1;

// f(t) = a + b t + c cos(w t) of a CoeffForm term f = (a, b, c, w), its
// terms added in the order a, b t, c cos(w t), the zero ones left out
// (ops/forms.py:CoeffForm.sample).
template <typename T>
__device__ __forceinline__ T form_at(const T* f, T t) {
  T col = T(0);
  bool any = false;
  if (f[0] != T(0)) {
    col = f[0];
    any = true;
  }
  if (f[1] != T(0)) {
    const T bt = mul_rn(f[1], t);
    col = any ? add_rn(col, bt) : bt;
    any = true;
  }
  if (f[2] != T(0)) {
    const T ct = mul_rn(f[2], cos_full(mul_rn(f[3], t)));
    col = any ? add_rn(col, ct) : ct;
  }
  return col;
}

// A ChebForm's argument u = (2 t - (lo + hi)) (1 / (hi - lo)) from its
// folded mid = lo + hi and inv = 1 / (hi - lo) (ops/forms.py:ChebForm).
template <typename T>
__device__ __forceinline__ T cheb_arg(T t, T mid, T inv) {
  return mul_rn(sub_rn(mul_rn(T(2), t), mid), inv);
}

// One term's Chebyshev series c_0 .. c_{n-1} at u by Clenshaw in
// ChebForm.sample's order: b1, b2 = ((2 u) b1 - b2) + c_j, b1 for j = n - 1
// .. 1, then (u b1 - b2) + c_0. No term is skipped (u 0 still carries a
// NaN), every operation rounded on its own.
template <typename T>
__device__ __forceinline__ T cheb_series(const T* c, int n, T u) {
  const T u2 = mul_rn(T(2), u);
  T b1 = T(0), b2 = T(0);
  for (int j = n - 1; j >= 1; --j) {
    const T nb = add_rn(sub_rn(mul_rn(u2, b1), b2), c[j]);
    b2 = b1;
    b1 = nb;
  }
  return add_rn(sub_rn(mul_rn(u, b1), b2), c[0]);
}

// The RK step's declared drive u(t): a one-term CoeffForm (f = a, b, c, w)
// or a one-term ChebForm (its n coefficients in device memory, mid and
// inv folded in float64 and rounded once). From the 8 float64 values
// [kind, n, a, b, c, w, mid, inv] of ops/fused_rk.py:kernel_drive.
template <typename T>
struct Drive {
  int kind, n;
  T f[4];
  T mid, inv;
  const T* cheb;
};

template <typename T>
Drive<T> parse_drive(const double* d, const void* cheb) {
  Drive<T> dr{};
  dr.kind = (int)d[0], dr.n = (int)d[1];
  for (int i = 0; i < 4; ++i) dr.f[i] = (T)d[2 + i];
  dr.mid = (T)d[6], dr.inv = (T)d[7];
  dr.cheb = (const T*)cheb;
  return dr;
}

// Whether the launcher can run the drive (a ChebForm needs its table).
template <typename T>
bool drive_ok(const Drive<T>& dr) {
  return dr.kind == FORM_COEFF || (dr.kind == FORM_CHEB && dr.n >= 1 && dr.cheb != nullptr);
}

template <typename T>
__device__ __forceinline__ T drive_at(const Drive<T>& dr, T t) {
  if (dr.kind == FORM_CHEB) return cheb_series(dr.cheb, dr.n, cheb_arg(t, dr.mid, dr.inv));
  return form_at(dr.f, t);
}

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

// The device's opt-in shared memory per block and SM count, read once.
inline cudaError_t device_limits(int* dev, int* max_smem, int* n_sm) {
  static int max_smem_of[MAX_DEVICES], n_sm_of[MAX_DEVICES];
  cudaError_t st = cudaGetDevice(dev);
  if (st != cudaSuccess) return st;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (max_smem_of[*dev] == 0) {
    st = cudaDeviceGetAttribute(&max_smem_of[*dev], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                *dev);
    if (st != cudaSuccess) return st;
    st = cudaDeviceGetAttribute(&n_sm_of[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (st != cudaSuccess) return st;
  }
  *max_smem = max_smem_of[*dev];
  *n_sm = n_sm_of[*dev];
  return cudaSuccess;
}

// The error measure of each row lr < rows from the error vector dv
// (tile, D) in shared memory: ErrNorm (scaled_error against x and x_out,
// the weight row, l2 or a NaN-propagating max, post), column group cg of
// ceil(D / CT) summing columns cg, cg + ncg, ... in order, then the groups
// in order, into err_out. The groups' partial sums are taken in parallel
// (a warp reads consecutive columns) and left in dv's column cg of their
// row, which no other group reads; after a barrier one thread a row sums
// them. Every thread of the block calls it; dv is overwritten.
template <typename T>
__device__ __forceinline__ void chain_err_measure(T* dv, const T* x, const T* x_out,
                                                  T* __restrict__ err_out, int rows, int D,
                                                  const ErrNorm<T>& en) {
  const int ncg = (D + CT - 1) / CT;
  for (int it = threadIdx.x; it < rows * ncg; it += blockDim.x) {
    const int lr = it / ncg, cg = it % ncg;
    T part = T(0);
    for (int k = 0; k < CT; ++k) {
      const int col = cg + k * ncg;
      if (col >= D) continue;
      const size_t e = (size_t)lr * D + col;
      T v = dv[e];
      if (en.scaled)
        v = v / add_rn(en.atol, mul_rn(en.rtol, nan_max(fabs(x[e]), fabs(x_out[e]))));
      if (en.w_row != nullptr) v = v * en.w_row[col];
      part = en.kind_max ? nan_max(fabs(v), part) : part + v * v;
    }
    dv[(size_t)lr * D + cg] = part;
  }
  __syncthreads();
  for (int lr = threadIdx.x; lr < rows; lr += blockDim.x) {
    T a = T(0);
    for (int cg = 0; cg < ncg; ++cg) {
      const T part = dv[(size_t)lr * D + cg];
      a = en.kind_max ? nan_max(part, a) : a + part;
    }
    T norm = en.kind_max ? a : sqrt_full(a);
    if (en.scaled) norm = norm * en.rtol;
    if (en.post != T(1)) norm = norm * en.post;
    err_out[lr] = norm;
  }
}

}  // namespace vec_ode
