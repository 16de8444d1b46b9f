// One whole embedded explicit Runge-Kutta step for an ensemble of
// trajectories of dx/dt = (M0 + u(t) M1) x, written by hand for Hopper
// (sm_90a), with u a declared drive: a one-term CoeffForm (cos(w t) is
// (0, 0, 1, w)) or a one-term ChebForm (numerics.cuh: Drive).
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
// (fused_loop.cu) runs too, with the same bits; the header's note has the
// layout and the precision rules.
//
// The plan (rk_plan below; ops/fused_rk.py:rk_plan mirrors it; no option
// picks any of it):
//  * outputs a thread: f32 with at most 6 stages 4 x 4, its stage values
//    in registers; f32 with 7 stages 2 x 4, in registers; f64 2 x 4, in
//    its own region of shared memory;
//  * rows a block: the largest power of two up to 128 whose microtiles
//    fill at most 256 threads and whose shared memory fits, halved while
//    the batch gives fewer tiles than SMs, down to 8;
//  * the operator MT = [M0^T | M1^T] resident in shared memory where the
//    block's shared memory holds it at that tile (D = 128 in f32: 128 KB
//    of panels and 32 KB of term buffers at 32 rows), each block then
//    persistent: one block an SM, looping over tiles, the operator loaded
//    once; else streamed from L2 through the ring (three panels of 16 KB),
//    one block a tile.
// At B = 16384, d = 64 in f32 (RKF45): 32 rows, 256 threads, the operator
// resident, 132 blocks over 512 tiles.
//
// What bounds it: FP32 FMA throughput. A step at 16384 x 64 complex is
// 6 stages x (B * 128 * 256 * 2) = about 6.4 GFLOP against 8 MB in and
// 8 MB out: 0.096 ms at the card's 67 TFLOP/s FP32 (non-tensor) rate.
// TF32 must not enter an error estimate: at rtol = 1e-8 in f32 the
// embedded error (~1e-9 per component) sits near rounding level.

#include "rk_step.cuh"

namespace {

using namespace vec_ode;

constexpr int RK_MAX_TILE = 128;  // rows a block at most
constexpr int RK_MIN_TILE = 8;    // rows a block at least where the batch is small
constexpr int RK_RM_REG = 4;      // f32, s <= RK_KS_REG: rows a thread
constexpr int RK_KS_REG = 6;      // stages in registers at RK_RM_REG
constexpr int RK_RM = 2;          // otherwise: rows a thread

// K1's launch: rows a thread, stages in registers (0: in shared memory),
// rows a tile, threads and blocks, shared memory a block, the operator
// resident.
struct RKPlan {
  int rm, ks, tile, threads, blocks;
  size_t smem;
  int resident;
};

// The plan (see the note above).
template <typename T>
RKPlan rk_plan(int B, int D, int s, int n_sm, size_t max_smem) {
  const bool reg4 = sizeof(T) == 4 && s <= RK_KS_REG;
  const int rm = reg4 ? RK_RM_REG : RK_RM;
  const int ks = sizeof(T) == 4 ? (reg4 ? RK_KS_REG : MAX_STAGES) : 0;
  const int ncl = gemm_dp(D) / GEMM_CN;
  auto smem_of = [&](int tl, bool res) { return RKLayout<T>(tl, D, s, ks == 0, res).total; };
  int tile = RK_MAX_TILE;
  while (tile > rm && ((tile / rm) * ncl > GEMM_THREADS || smem_of(tile, false) > max_smem))
    tile /= 2;
  const int floor_ = rm > RK_MIN_TILE ? rm : RK_MIN_TILE;
  while (tile > floor_ && (B + tile - 1) / tile < n_sm) tile /= 2;
  const int n_tiles = (B + tile - 1) / tile;
  const bool res = smem_of(tile, true) <= max_smem;
  return RKPlan{rm, ks, tile, ((tile / rm) * ncl + 31) / 32 * 32,
                res ? (n_tiles < n_sm ? n_tiles : n_sm) : n_tiles, smem_of(tile, res), res};
}

// Blocks take tiles blockIdx.x, blockIdx.x + gridDim.x, ... (one each
// where the operator streams), the operator kept across them.
template <typename T, int RM, int KS>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
fused_rk_step_kernel(const T* __restrict__ t, const T* __restrict__ dt,
                     const T* __restrict__ x, const T* __restrict__ mt,
                     T* __restrict__ x_out, T* __restrict__ err_out, int B, int D, int tile,
                     int resident, Tableau<T> tab, int s, int has_err, int advance_lower,
                     Drive<T> dr, ErrNorm<T> en) {
  extern __shared__ __align__(16) unsigned char rk_smem[];
  const RKLayout<T> L(tile, D, s, KS == 0, resident != 0);
  PanelRing<T> ring(mt, reinterpret_cast<T*>(rk_smem + L.ring), D, 2, 0, D, D, resident != 0);
  ring.prologue();
  const int n_tiles = (B + tile - 1) / tile;
  for (int tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const long row0 = (long)tl * tile;
    const int rows = (int)(B - row0 < tile ? B - row0 : tile);
    rk_step_tile<T, RM, KS>(t + row0, dt + row0, x + row0 * D, x_out + row0 * D, err_out + row0,
                            rk_smem, L, ring, rows, tile, D, tab, s, has_err, advance_lower, dr,
                            en);
  }
  ring.drain();
}

template <typename T, int RM, int KS>
int run(const RKPlan& pl, const void* t, const void* dt, const void* x, const void* mt,
        void* x_out, void* err_out, int B, int D, const Tableau<T>& tab, int s, int has_err,
        int advance_lower, const Drive<T>& dr, const ErrNorm<T>& en, int dev, void* stream) {
  static size_t smem_allowed[MAX_DEVICES];
  auto kernel = fused_rk_step_kernel<T, RM, KS>;
  if (pl.smem > smem_allowed[dev]) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (st != cudaSuccess) return (int)st;
    smem_allowed[dev] = pl.smem;
  }
  kernel<<<pl.blocks, pl.threads, pl.smem, (cudaStream_t)stream>>>(
      (const T*)t, (const T*)dt, (const T*)x, (const T*)mt, (T*)x_out, (T*)err_out, B, D, pl.tile,
      pl.resident, tab, s, has_err, advance_lower, dr, en);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int D, int s) {
  return B > 0 && D > 0 && D <= MAX_WIDTH && s > 0 && s <= MAX_STAGES;
}

template <typename T>
int plan_here(int B, int D, int s, RKPlan* pl, int* dev) {
  int max_smem = 0, n_sm = 0;
  const cudaError_t st = device_limits(dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  *pl = rk_plan<T>(B, D, s, n_sm, (size_t)max_smem);
  if (pl->threads > GEMM_THREADS || pl->smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch(const void* t, const void* dt, const void* x, const void* mt,
           void* x_out, void* err_out, int B, int D, const double* tab_in,
           int s, int has_err, int advance_lower, const double* drive, const void* cheb,
           const void* w_row, double post, int kind_max, void* stream) {
  const Drive<T> dr = parse_drive<T>(drive, cheb);
  if (!shape_ok(B, D, s) || !drive_ok(dr)) return (int)cudaErrorInvalidValue;
  const Tableau<T> tab = parse_tableau<T>(tab_in);
  const ErrNorm<T> en{(const T*)w_row, (T)post, kind_max, 0, T(0), T(0)};
  RKPlan pl;
  int dev = 0;
  const int rc = plan_here<T>(B, D, s, &pl, &dev);
  if (rc != 0) return rc;
  if constexpr (sizeof(T) == 4) {
    if (pl.rm == RK_RM_REG)
      return run<T, RK_RM_REG, RK_KS_REG>(pl, t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err,
                                          advance_lower, dr, en, dev, stream);
    return run<T, RK_RM, MAX_STAGES>(pl, t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err,
                                     advance_lower, dr, en, dev, stream);
  } else {
    return run<T, RK_RM, 0>(pl, t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err,
                            advance_lower, dr, en, dev, stream);
  }
}

}  // namespace

extern "C" {

// tab: MAX_STAGES*MAX_STAGES values of a, then b, b - b_err and c, each
// MAX_STAGES long, zero-padded, row-major, in float64 host memory.
// drive: the 8 float64 values [kind, n, a, b, c, w, mid, inv] of the
// declared drive (numerics.cuh: parse_drive) in host memory; cheb: a
// ChebForm's n coefficients in device memory in the state's type (null for
// a CoeffForm). w_row: D weights in device memory in the state's type, or
// null; post and kind_max (0: l2, 1: max) complete the declared error norm.
int vec_ode_fused_rk_step_f32(const void* t, const void* dt, const void* x, const void* mt,
                              void* x_out, void* err_out, int B, int D, const double* tab,
                              int s, int has_err, int advance_lower, const double* drive,
                              const void* cheb, const void* w_row, double post, int kind_max,
                              void* stream) {
  return launch<float>(t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err, advance_lower, drive,
                       cheb, w_row, post, kind_max, stream);
}

int vec_ode_fused_rk_step_f64(const void* t, const void* dt, const void* x, const void* mt,
                              void* x_out, void* err_out, int B, int D, const double* tab,
                              int s, int has_err, int advance_lower, const double* drive,
                              const void* cheb, const void* w_row, double post, int kind_max,
                              void* stream) {
  return launch<double>(t, dt, x, mt, x_out, err_out, B, D, tab, s, has_err, advance_lower, drive,
                        cheb, w_row, post, kind_max, stream);
}

// K1's plan on the current card for B rows of width D and s stages in
// elements of elem_bytes: out[0..6] = rows a thread, stages in registers,
// rows a tile, threads, blocks, shared memory a block, resident
// (ops/fused_rk.py: RK_PLAN_KEYS). 0, or the CUDA error.
int vec_ode_fused_rk_plan(int B, int D, int s, int elem_bytes, long long* out) {
  if (!shape_ok(B, D, s) || (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  RKPlan pl;
  int dev = 0;
  const int rc = elem_bytes == 4 ? plan_here<float>(B, D, s, &pl, &dev)
                                 : plan_here<double>(B, D, s, &pl, &dev);
  if (rc != 0) return rc;
  const long long v[7] = {pl.rm, pl.ks, pl.tile, pl.threads, pl.blocks, (long long)pl.smem,
                          pl.resident};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
