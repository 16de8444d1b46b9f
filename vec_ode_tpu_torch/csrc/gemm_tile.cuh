// Tiled SIMT products for Hopper (sm_90a), shared by K4's many-term body
// (chain_expmv.cu) and K7 (adjoint.cu): a Taylor term of a tile of
// trajectories is a (tile, D) @ (D, D) product whose right operand sits in
// shared memory, either streamed through a ring of panels (K4: the basis
// M_k^T, slab by slab) or formed there once per row (K7: the row's
// exponent).
//
// Layout. The right operand is row-major with a padded row of DP =
// ceil(D / 4) * 4 values, so that a thread's GEMM_CN = 4 columns are one
// 16-byte load (two for f64). A thread owns an RM x 4 tile of the product
// and, per contraction index j, reads RM + 4 values from shared memory for
// 4 RM FMAs. K4 holds the term transposed, termT[j * tile + row], so that a
// thread's RM rows at one j are contiguous (8 x 4: 32 FMAs per three
// 16-byte loads); K7 holds it row-major, where its
// 16-byte stores of a new term meet no bank conflict. The threads of a
// warp share their rows (a broadcast) and read consecutive columns.
//
// Precision. Each element of a product is the IEEE FMA chain over j in
// increasing order from zero, in the state's type: what the per-element
// loops of chain_step.cuh compute, so a panel split of j changes no bit.
// Never TF32; build without --use_fast_math.

#pragma once

#include "rk_step.cuh"

namespace vec_ode {

constexpr int GEMM_THREADS = 256;          // product threads a block at most
constexpr int GEMM_CN = 4;                 // columns per thread, contiguous
constexpr int GEMM_PANEL_BYTES = 16384;    // one panel of the ring
constexpr int GEMM_STAGES = 3;             // panels in flight and in use
constexpr int GEMM_MAX_JC = 32;            // contraction rows per panel at most
constexpr int GEMM_RM_F32 = 8, GEMM_RM_F64 = 4;  // K4's rows per thread

// The padded row of a right operand in shared memory.
__host__ __device__ inline int gemm_dp(int D) { return (D + GEMM_CN - 1) / GEMM_CN * GEMM_CN; }

// Contraction rows of a panel: GEMM_PANEL_BYTES of padded rows, a
// multiple of 8, from 8 to GEMM_MAX_JC.
template <typename T>
__host__ __device__ inline int gemm_jc(int D) {
  int jc = GEMM_PANEL_BYTES / (gemm_dp(D) * (int)sizeof(T)) / 8 * 8;
  return jc < 8 ? 8 : (jc > GEMM_MAX_JC ? GEMM_MAX_JC : jc);
}

// Bytes rounded up to 16, so that every carved region stays 16-byte aligned.
__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// N values from shared memory at p, in 16-byte loads where N values fill
// them (p aligned to them).
template <typename T, int N>
__device__ __forceinline__ void lds_vec(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) * N % 16 == 0) {
    constexpr int per = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += per) {
      if constexpr (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + i);
        v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
      } else {
        const double2 d = *reinterpret_cast<const double2*>(p + i);
        v[i] = d.x, v[i + 1] = d.y;
      }
    }
  } else if constexpr (sizeof(T) == 4 && N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// y[q][c] = fma(a_q(j), b[j * bs + c], y[q][c]) for j = 0 .. jn - 1 in
// order: a thread's RM rows of the term against its 4 columns of the right
// operand (b = its first column). The term is transposed (ROWS false: a_q(j)
// = a[j * as + q], a thread's rows one or two 16-byte loads) or row-major
// (ROWS true: a_q(j) = a[q * as + j]); a points at the thread's first row
// at the first contraction index.
template <typename T, int RM, bool ROWS>
__device__ __forceinline__ void tile_fma(const T* a, int as, const T* b, int bs, int jn,
                                         T (&y)[RM][GEMM_CN]) {
  auto step = [&](int j) {
    T av[RM], bv[GEMM_CN];
    if constexpr (ROWS) {
#pragma unroll
      for (int q = 0; q < RM; ++q) av[q] = a[(size_t)q * as + j];
    } else {
      lds_vec<T, RM>(a + (size_t)j * as, av);
    }
    lds_vec<T, GEMM_CN>(b + (size_t)j * bs, bv);
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int c = 0; c < GEMM_CN; ++c) y[q][c] = fma_full(av[q], bv[c], y[q][c]);
  };
  int j = 0;
  for (; j + 8 <= jn; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) step(j + u);
  }
  for (; j < jn; ++j) step(j);
}

// v[0 .. 3] to shared memory at p (16-byte aligned), in 16-byte stores.
template <typename T>
__device__ __forceinline__ void sts_vec4(T* p, const T (&v)[GEMM_CN]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  }
}

template <typename T, int RM>
__device__ __forceinline__ void tile_zero(T (&y)[RM][GEMM_CN]) {
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int c = 0; c < GEMM_CN; ++c) y[q][c] = T(0);
}

// cp.async: BYTES (4, 8 or 16) from global to shared memory, no registers
// on the way; 16-byte copies bypass L1 (.cg).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(g), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The periodic stream of panels of MT = [M_0^T | ... | M_{KP-1}^T] (D,
// KP*D) through a ring of GEMM_STAGES panels in shared memory: the stream
// runs over blocks b = 0 .. KP - 1 and, in each, panels of jc contraction
// rows j0 = 0, jc, ..., so every Taylor term takes the same KP * npan
// panels in order (k outer, j inner) and the copy of a later term's first
// panels overlaps this term's last. Every thread of the block copies and
// waits; positions advance by counters (no division per panel), a
// thread's copies by a fixed stride of blockDim.
template <typename T>
struct PanelRing {
  static constexpr int V = 16 / sizeof(T);  // values a 16-byte copy moves
  const T* mt;
  T* ring;
  size_t ld;     // KP * D
  int D, DP, kp, jc, npan;
  size_t stage;  // jc * DP values
  bool vec16;    // 16-byte copies: D a multiple of V, mt 16-byte aligned
  int chunks;    // copies per contraction row
  int jj0, ci0, djj, dci;  // this thread's first copy, the stride between its copies
  int nb = 0, nj = 0, ns = 0;  // the next panel to issue: block, panel index, stage
  int cs = 0;                  // the stage of the next panel to acquire

  __device__ PanelRing(const T* mt_, T* ring_, int D_, int kp_, int jc_)
      : mt(mt_), ring(ring_), ld((size_t)kp_ * D_), D(D_), DP(gemm_dp(D_)), kp(kp_), jc(jc_),
        npan((D_ + jc_ - 1) / jc_), stage((size_t)jc_ * gemm_dp(D_)) {
    vec16 = D % V == 0 && ((size_t)mt % 16) == 0;
    chunks = vec16 ? D / V : D;
    jj0 = threadIdx.x / chunks, ci0 = threadIdx.x % chunks;
    djj = blockDim.x / chunks, dci = blockDim.x % chunks;
  }
  __device__ int rows_of(int j0) const { return D - j0 < jc ? D - j0 : jc; }

  // The next panel of the stream into its stage.
  __device__ void issue() {
    const int j0 = nj * jc, jn = rows_of(j0);
    T* dst = ring + (size_t)ns * stage;
    const T* src = mt + (size_t)j0 * ld + (size_t)nb * D;
    int jj = jj0, ci = ci0;
    if (vec16) {
      while (jj < jn) {
        cp_async<16>(dst + (size_t)jj * DP + ci * V, src + (size_t)jj * ld + ci * V);
        jj += djj, ci += dci;
        if (ci >= chunks) ci -= chunks, ++jj;
      }
    } else {
      while (jj < jn) {
        cp_async<sizeof(T)>(dst + (size_t)jj * DP + ci, src + (size_t)jj * ld + ci);
        jj += djj, ci += dci;
        if (ci >= chunks) ci -= chunks, ++jj;
      }
    }
    cp_async_commit();
    if (++nj == npan) {
      nj = 0;
      if (++nb == kp) nb = 0;
    }
    if (++ns == GEMM_STAGES) ns = 0;
  }
  // The first GEMM_STAGES - 1 panels.
  __device__ void prologue() {
    for (int p = 0; p < GEMM_STAGES - 1; ++p) issue();
  }
  // The next panel of the stream once every thread's copy of it has
  // landed; then the copy of the panel GEMM_STAGES - 1 further on goes into
  // the stage the previous panel used, which every thread has finished
  // with (the barrier).
  __device__ const T* acquire() {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    issue();
    const T* s = ring + (size_t)cs * stage;
    if (++cs == GEMM_STAGES) cs = 0;
    return s;
  }
};

}  // namespace vec_ode
