// Tiled SIMT products for Hopper (sm_90a), shared by K4 and the loop
// kernel's chain step K5 (chain_step.cuh), by the RK step of K1 and of the
// loop kernel (K3, rk_step.cuh), by K6 (adjoint_row.cuh) and by K7
// (adjoint.cu): a Taylor term or a stage input of a tile of trajectories
// is a (tile, D) @ (D, D) product whose right operand sits in shared
// memory, either a basis M_k^T (K4, K5, K6; [M0^T | M1^T] for the RK step:
// resident, loaded once, or streamed through a ring of panels, slab by
// slab) or formed there once per row (K7: the row's exponent).
//
// Layout. The right operand is row-major with a padded row of DP =
// ceil(width / 4) * 4 values, so that a thread's CN <= 4 columns are one
// load of 8 or 16 bytes (two for f64 at CN = 4). A thread owns an RM x CN
// tile of the product and, per contraction index j, reads RM + CN values
// from shared memory for RM CN FMAs. K4 and K5 hold the term transposed,
// termT[j * tile + row], so that a thread's RM rows at one j are
// contiguous (8 x 4: 32 FMAs per three 16-byte loads); K7 holds it
// row-major, where its 16-byte stores of a new term meet no bank
// conflict. The threads of a warp share their rows (a broadcast) and read
// consecutive columns.
//
// Precision. Each element of a product is the IEEE FMA chain over j in
// increasing order from zero, in the state's type, so a panel split of j
// changes no bit. Never TF32; build without --use_fast_math.

#pragma once

#include "numerics.cuh"

namespace vec_ode {

constexpr int GEMM_THREADS = 256;          // product threads a block at most
constexpr int GEMM_CN = 4;                 // columns per thread, contiguous
constexpr int GEMM_PANEL_BYTES = 16384;    // one panel of the ring
constexpr int GEMM_STAGES = 3;             // panels in flight and in use
constexpr int GEMM_MAX_JC = 32;            // contraction rows per panel at most
constexpr int GEMM_RM_F32 = 8, GEMM_RM_F64 = 4;  // K4's tiled rows per thread

// The padded row of a right operand in shared memory.
__host__ __device__ inline int gemm_dp(int D) { return (D + GEMM_CN - 1) / GEMM_CN * GEMM_CN; }

// Contraction rows of a panel of a right operand `width` columns wide:
// GEMM_PANEL_BYTES of padded rows, a multiple of 8, from 8 to GEMM_MAX_JC.
template <typename T>
__host__ __device__ inline int gemm_jc(int width) {
  int jc = GEMM_PANEL_BYTES / (gemm_dp(width) * (int)sizeof(T)) / 8 * 8;
  return jc < 8 ? 8 : (jc > GEMM_MAX_JC ? GEMM_MAX_JC : jc);
}

// The basis slice of a block (dc of each M_k^T's D columns, K' terms)
// stays resident in shared memory, loaded once, when it takes no more
// than the ring would; else it streams through the ring.
template <typename T>
__host__ __device__ inline bool ring_resident(int D, int kp, int dc) {
  return (size_t)kp * D * gemm_dp(dc) * sizeof(T) <=
         (size_t)GEMM_STAGES * GEMM_PANEL_BYTES;
}

// Bytes of the basis in shared memory: the resident slice or the ring.
template <typename T>
__host__ __device__ inline size_t ring_bytes(int D, int kp, int dc) {
  return ring_resident<T>(D, kp, dc)
             ? (size_t)kp * D * gemm_dp(dc) * sizeof(T)
             : (size_t)GEMM_STAGES * gemm_jc<T>(dc) * gemm_dp(dc) * sizeof(T);
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
// order: a thread's RM rows of the term against its CN columns of the
// right operand (b = its first column). The term is transposed (ROWS
// false: a_q(j) = a[j * as + q], a thread's rows one or two 16-byte loads)
// or row-major (ROWS true: a_q(j) = a[q * as + j]); a points at the
// thread's first row at the first contraction index.
template <typename T, int RM, bool ROWS, int CN = GEMM_CN>
__device__ __forceinline__ void tile_fma(const T* a, int as, const T* b, int bs, int jn,
                                         T (&y)[RM][CN]) {
  auto step = [&](int j) {
    T av[RM], bv[CN];
    if constexpr (ROWS) {
#pragma unroll
      for (int q = 0; q < RM; ++q) av[q] = a[(size_t)q * as + j];
    } else {
      lds_vec<T, RM>(a + (size_t)j * as, av);
    }
    lds_vec<T, CN>(b + (size_t)j * bs, bv);
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int c = 0; c < CN; ++c) y[q][c] = fma_full(av[q], bv[c], y[q][c]);
  };
  int j = 0;
  for (; j + 8 <= jn; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) step(j + u);
  }
  for (; j < jn; ++j) step(j);
}

// tile_fma for N right operands at once, b + n * bn (n < N), each with its
// own products y[n]: one load of the term's rows serves N operands, and a
// thread runs N * RM * CN independent chains (more in flight where the
// microtile is small). Each y[n][q][c] is the same FMA chain as tile_fma's.
template <typename T, int RM, int CN, int N>
__device__ __forceinline__ void tile_fma_n(const T* a, int as, const T* b, size_t bn, int bs,
                                           int jn, T (&y)[N][RM][CN]) {
  auto step = [&](int j) {
    T av[RM];
    lds_vec<T, RM>(a + (size_t)j * as, av);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      T bv[CN];
      lds_vec<T, CN>(b + n * bn + (size_t)j * bs, bv);
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int c = 0; c < CN; ++c) y[n][q][c] = fma_full(av[q], bv[c], y[n][q][c]);
    }
  };
  int j = 0;
  for (; j + 8 <= jn; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) step(j + u);
  }
  for (; j < jn; ++j) step(j);
}

// v[0 .. N) to shared memory at p, in 16-byte stores where N values fill
// them (p aligned to them), else 8-byte (two f32) or single stores.
template <typename T, int N>
__device__ __forceinline__ void sts_vec(T* p, const T (&v)[N]) {
  if constexpr (sizeof(T) * N % 16 == 0) {
    constexpr int per = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += per) {
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      else
        *reinterpret_cast<double2*>(p + i) = make_double2(v[i], v[i + 1]);
    }
  } else if constexpr (sizeof(T) == 4 && N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <typename T, int RM, int CN = GEMM_CN>
__device__ __forceinline__ void tile_zero(T (&y)[RM][CN]) {
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int c = 0; c < CN; ++c) y[q][c] = T(0);
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

// The basis of a chain step in shared memory: columns [c0, c0 + dc) of
// every M_k^T of MT = [M_0^T | ... | M_{KP-1}^T] (D, KP*D), the block's
// slice (all D columns but on K4's cluster route, where the last block of
// a cluster may own fewer than the `width` its layout holds), read as
// panels of jc contraction rows in the order every Taylor term takes them:
// k outer, j inner, KP * npan panels a term.
//  * resident (ring_resident at `width`): all KP panels of D rows, loaded
//    once by prologue(), read through panel(b) with no barrier;
//  * streamed: a ring of GEMM_STAGES panels taken in turn by acquire(),
//    the copy of panel p + 2 in flight while panel p is multiplied; the
//    periodic stream runs on across terms, rows, chains and (in the loop
//    kernel) steps.
// Every thread of the block copies and waits; positions advance by
// counters (no division per panel), a thread's copies by a fixed stride
// of blockDim. Padding columns of a panel are never written.
template <typename T>
struct PanelRing {
  static constexpr int V = 16 / sizeof(T);  // values a 16-byte copy moves
  const T* mt;
  T* ring;
  size_t ld;      // KP * D
  int D, DP, kp, jc, npan, nst;  // DP: the slice's padded row; nst: stages
  size_t stage;   // jc * DP values
  bool resident;
  bool vec16;     // 16-byte copies: the slice's rows 16-byte aligned
  int chunks;     // copies per contraction row
  int jj0, ci0, djj, dci;  // this thread's first copy, the stride between its copies
  int nb = 0, nj = 0, ns = 0;  // the next panel to issue: block, panel index, stage
  int cs = 0;                  // the stage of the next panel to acquire

  __device__ PanelRing(const T* mt_, T* ring_, int D_, int kp_, int c0, int dc, int width)
      : PanelRing(mt_, ring_, D_, kp_, c0, dc, width, ring_resident<T>(D_, kp_, width)) {}
  // resident_: the caller's plan decides (the RK step keeps [M0^T | M1^T]
  // resident wherever its block's shared memory holds it)
  __device__ PanelRing(const T* mt_, T* ring_, int D_, int kp_, int c0, int dc, int width,
                       bool resident_)
      : mt(mt_ + c0), ring(ring_), ld((size_t)kp_ * D_), D(D_), DP(gemm_dp(width)), kp(kp_) {
    resident = resident_;
    jc = resident ? D_ : gemm_jc<T>(width);
    npan = (D_ + jc - 1) / jc;
    nst = resident ? kp_ : GEMM_STAGES;
    stage = (size_t)jc * DP;
    vec16 = D % V == 0 && c0 % V == 0 && dc % V == 0 && ((size_t)mt_ % 16) == 0;
    chunks = vec16 ? dc / V : dc;
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
    if (++ns == nst) ns = 0;
  }
  // Resident: the whole slice, landed and visible to the block. Streamed:
  // the first GEMM_STAGES - 1 panels, in flight.
  __device__ void prologue() {
    if (resident) {
      for (int p = 0; p < kp; ++p) issue();
      cp_async_wait<0>();
      __syncthreads();
      return;
    }
    for (int p = 0; p < GEMM_STAGES - 1; ++p) issue();
  }
  // Streamed: the next panel of the stream, once every thread's copy of it
  // has landed; then the copy of the panel GEMM_STAGES - 1 further on goes
  // into the stage the previous panel used, which every thread has
  // finished with (the barrier).
  __device__ const T* acquire() {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    issue();
    const T* s = ring + (size_t)cs * stage;
    if (++cs == nst) cs = 0;
    return s;
  }
  // Resident: panel b (all D rows of M_b^T's slice).
  __device__ const T* panel(int b) const { return ring + (size_t)b * stage; }
  // The stream's last speculative copies, before the block exits.
  __device__ void drain() { cp_async_wait<0>(); }
};

}  // namespace vec_ode
