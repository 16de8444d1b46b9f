// K6's body: one reverse row of the reversible adjoint with per-lane rows
// for a tile of lanes (trajectories), as a device function that every
// thread of a block (of a thread-block cluster) calls together; the
// counterpart of vec_ode_tpu/ops/pallas_expmv.py:_adjoint_row_chains, run
// by adjoint.cu's K6 kernel on both of its launch routes. K7 and K8 share
// only the parameters and the scaling rule below.
//
// What a row computes, per lane, with A = sum_k c_k W_k over the working
// basis (K' = KP terms):
//   x_n = e^{-A} x,  a_n = e^{A^T} a,  cbar_k = <a, D_{W_k} e^{A} x_n>.
// Scaling: one count s per lane from sum_k |c_k| ||W_k||_1 (adj_scale_rows;
// the Fréchet direction adds nothing to it); A_s = 2^-s A, N = 2^s passes,
// P = T_m(A_s) and Q = T_m(-A_s) the degree-m Taylor polynomials.
//
// The pairing route. D_V(P^N) = sum_{p<N} P^{N-1-p} (D_V P) P^p, and with
// the Taylor terms alpha_i = (A_s^T)^i z / i! of a pass start z and t_l =
// A_s^l v / l! of v,
//   <z, D_V P v> = sum_{i + l <= m - 1} i! l! / (i + l + 1)! <alpha_i, V t_l>.
// The a chain's pass j starts at z_j = (P^T)^j a. It is paired with v =
// y_{j+1}, the x chain's state after j + 1 passes of Q, which stands for
// P^{N-1-j} x_n up to the Taylor remainder (P Q = I to below the type's
// eps at the port's (m, theta); for N = 1 the pairing is exact). The t
// chain from y_{j+1} is the x chain's own pass j + 1: its terms are
// (-1)^l t_l and its K' actions W_k t_l up to sign, bit for bit. So a row
// runs N + 1 stages: stage p runs the x chain's pass p from y_p and, for
// p >= 1, the a chain's pass p - 1 from z_{p-1}, and pairs them; the x
// chain's last pass (p = N) only pairs, its state stays y_N = x_n. A
// Taylor term costs K' actions a chain (W_k v through MT = [W_0^T | ...],
// W_k^T v through MS = [W_0 | ...]), 2K' a stage: where the K' + 1
// Fréchet chains of the JAX kernel ran K'^2 + 3K' a term.
// Each pair is taken when its later term arrives: at term step s (the
// actions of term s - 1) the x side pairs W_k T^x_{s-1} with alpha_i for i
// <= min(s - 2, m - s), the a side W_k^T alpha_{s-1} with t_l for l <=
// min(s - 1, m - s), each side first combining the stored vectors it
// pairs with into one g (coefficients in index order, explicitly rounded),
// so a pass keeps only the first H = floor((m - 1) / 2) + 1 terms of each
// chain, and each pairing is one dot product of g with an action per k.
// Lanes that have finished their passes are masked while the tile runs to
// its largest count.
//
// Layout. The tile's 2L chain rows (rows < L the lanes' x chains, the rest
// their a chains) share every basis panel: a Taylor term is one (2L, D)
// product per k over gemm_tile.cuh's microtile, the term transposed in
// shared memory (D, 2L), two term buffers alternating; a thread owns RM
// rows of one chain x CN columns, its chain's running sum in registers.
// The basis comes through a PairRing: each stage (or, resident, each
// block) carries the same rows of W_k^T and of W_k, so that x rows and a
// rows run side by side. On the cluster route each block owns a slice of
// the columns, publishes its slice of each new term into every block's
// term buffer (distributed shared memory) and meets the cluster at one
// barrier a term. The first H terms of each chain (hist) stay in the
// block at its own columns. Each thread keeps its partial inner products
// (K' x RM) in local memory; at the end they are summed over the block's
// column groups in order, x rows then a rows, then over the cluster's
// blocks in rank order, and scaled by 2^-s: no atomics, the same bits run
// to run.
//
// Precision. Products accumulate by IEEE FMA in the state's type, never
// TF32; the K' actions are combined in k order with explicitly rounded
// operations and divided by the term's index, as the twin
// ops/adjoint.py:torch_adjoint_row does. Build without --use_fast_math.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "chain_step.cuh"
#include "gemm_tile.cuh"

namespace vec_ode {

constexpr int ROW_MAX_KP = MAX_KP;     // K6, K7 and K8 (ops/adjoint.py: ROW_MAX_KP)
constexpr int ROW_MAX_LANES = 32;      // lanes a tiled block at most
constexpr int ROW_CLUSTER_MAX = 4;     // blocks a cluster
constexpr int ROW_CLUSTER_LANES = 8;   // lanes a cluster at most
constexpr int ROW_CLUSTER_RM = 1, ROW_CLUSTER_CN = 2;  // the cluster route's outputs a thread
constexpr int ROW_STAGE_BYTES = 16384;  // a stage of the streamed PairRing, both panels

template <typename T>
struct AdjParams {
  int KP, m, max_sq;
  T theta;
  T norms[MAX_KP];  // ||W_k||_1
};

// The tiled route's chain rows a thread.
template <typename T>
__host__ __device__ constexpr int row_rm() {
  return sizeof(T) == 4 ? 4 : 2;
}

// The terms of each chain a pass keeps for the pairing.
__host__ __device__ inline int row_hist(int m) { return (m - 1) / 2 + 1; }

// Contraction rows of a stage of the streamed PairRing: a multiple of 4 up
// to 32 whose two panels (width columns each) fill ROW_STAGE_BYTES, at
// least 4.
template <typename T>
__host__ __device__ inline int pair_jc(int width) {
  const int jc = ROW_STAGE_BYTES / (2 * gemm_dp(width) * (int)sizeof(T)) / 4 * 4;
  return jc < 4 ? 4 : (jc > 32 ? 32 : jc);
}

// Bytes of the PairRing: both operands' slices resident where one takes
// no more than gemm_tile.cuh's ring, else GEMM_STAGES stages.
template <typename T>
__host__ __device__ inline size_t pair_ring_bytes(int D, int kp, int width) {
  return ring_resident<T>(D, kp, width)
             ? 2 * (size_t)kp * D * gemm_dp(width) * sizeof(T)
             : (size_t)GEMM_STAGES * 2 * pair_jc<T>(width) * gemm_dp(width) * sizeof(T);
}

// K6's shared memory, byte offsets (16-byte aligned): two term buffers (D,
// 2L) (at the end the column groups' partial sums); the first H terms of
// each chain at the block's columns (H, 2L, DP of the slice); the
// PairRing; the scaled rows (L, K'); the block's sums of cbar (L, K');
// the pairing coefficients (m, m); 2^-s (L); the pass counts (L).
// ops/adjoint.py:row_smem_bytes mirrors it.
template <typename T>
struct RowLayout {
  size_t term, hist, ring, cs, blk, coef, scl, np, total;
  __host__ __device__ RowLayout(int lanes, int D, int width, int kp, int m) {
    const size_t r2 = 2 * (size_t)lanes;
    size_t at = 0;
    term = at, at += align16(2 * (size_t)D * r2 * sizeof(T));
    hist = at, at += align16((size_t)row_hist(m) * r2 * gemm_dp(width) * sizeof(T));
    ring = at, at += align16(pair_ring_bytes<T>(D, kp, width));
    cs = at, at += align16((size_t)lanes * kp * sizeof(T));
    blk = at, at += align16((size_t)lanes * kp * sizeof(T));
    coef = at, at += align16((size_t)m * m * sizeof(T));
    scl = at, at += align16((size_t)lanes * sizeof(T));
    np = at, at += align16((size_t)lanes * sizeof(int));
    total = at;
  }
};

template <typename T>
struct RowSmem {
  T *term, *hist, *ring, *cs, *blk, *coef, *scl;
  int* np;
  __device__ RowSmem(unsigned char* base, const RowLayout<T>& L)
      : term(reinterpret_cast<T*>(base + L.term)),
        hist(reinterpret_cast<T*>(base + L.hist)),
        ring(reinterpret_cast<T*>(base + L.ring)),
        cs(reinterpret_cast<T*>(base + L.cs)),
        blk(reinterpret_cast<T*>(base + L.blk)),
        coef(reinterpret_cast<T*>(base + L.coef)),
        scl(reinterpret_cast<T*>(base + L.scl)),
        np(reinterpret_cast<int*>(base + L.np)) {}
};

// The basis of a row in shared memory: columns [c0, c0 + dc) of every
// W_k^T (MT) and of every W_k (MS), each (D, KP*D), read as panels of jc
// contraction rows, k outer, j inner, KP * npan a term; a stage carries the
// same rows of both, the MT panel first, the MS panel `half` values on.
//  * resident (ring_resident at `width`): all of both slices, loaded once
//    by prologue(), block b's panels at panel(b, .);
//  * streamed: GEMM_STAGES stages taken in turn by acquire(), as
//    gemm_tile.cuh's PanelRing (which this mirrors for two operands).
// Every thread copies and waits; padding columns are never written.
template <typename T>
struct PairRing {
  static constexpr int V = 16 / sizeof(T);
  const T* mt;
  const T* ms;
  T* ring;
  size_t ld;      // KP * D
  int D, DP, kp, jc, npan, nst;
  size_t stride;  // values from one stage (resident: block) to the next
  size_t half;    // from a stage's MT panel to its MS panel
  bool resident, vec16;
  int chunks, jj0, ci0, djj, dci;
  int nb = 0, nj = 0, ns = 0, cs = 0;

  __device__ PairRing(const T* mt_, const T* ms_, T* ring_, int D_, int kp_, int c0, int dc,
                      int width)
      : mt(mt_ + c0), ms(ms_ + c0), ring(ring_), ld((size_t)kp_ * D_), D(D_),
        DP(gemm_dp(width)), kp(kp_) {
    resident = ring_resident<T>(D_, kp_, width);
    jc = resident ? D_ : pair_jc<T>(width);
    npan = (D_ + jc - 1) / jc;
    nst = resident ? kp_ : GEMM_STAGES;
    stride = resident ? (size_t)D_ * DP : 2 * (size_t)jc * DP;
    half = resident ? (size_t)kp_ * D_ * DP : (size_t)jc * DP;
    vec16 = D % V == 0 && c0 % V == 0 && dc % V == 0 && ((size_t)mt_ % 16) == 0 &&
            ((size_t)ms_ % 16) == 0;
    chunks = vec16 ? dc / V : dc;
    jj0 = threadIdx.x / chunks, ci0 = threadIdx.x % chunks;
    djj = blockDim.x / chunks, dci = blockDim.x % chunks;
  }
  __device__ int rows_of(int j0) const { return D - j0 < jc ? D - j0 : jc; }

  __device__ void issue() {
    const int j0 = nj * jc, jn = rows_of(j0);
    T* dst = ring + (size_t)ns * stride;
    const size_t off = (size_t)j0 * ld + (size_t)nb * D;
    const T* sx = mt + off;
    const T* sa = ms + off;
    int jj = jj0, ci = ci0;
    if (vec16) {
      while (jj < jn) {
        const size_t d = (size_t)jj * DP + ci * V, s = (size_t)jj * ld + ci * V;
        cp_async<16>(dst + d, sx + s);
        cp_async<16>(dst + half + d, sa + s);
        jj += djj, ci += dci;
        if (ci >= chunks) ci -= chunks, ++jj;
      }
    } else {
      while (jj < jn) {
        const size_t d = (size_t)jj * DP + ci, s = (size_t)jj * ld + ci;
        cp_async<sizeof(T)>(dst + d, sx + s);
        cp_async<sizeof(T)>(dst + half + d, sa + s);
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
  __device__ void prologue() {
    if (resident) {
      for (int p = 0; p < kp; ++p) issue();
      cp_async_wait<0>();
      __syncthreads();
      return;
    }
    for (int p = 0; p < GEMM_STAGES - 1; ++p) issue();
  }
  __device__ const T* acquire() {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    issue();
    const T* s = ring + (size_t)cs * stride;
    if (++cs == nst) cs = 0;
    return s;
  }
  // Resident: block b's panel of MT (a = false) or of MS.
  __device__ const T* panel(int b, bool a) const {
    return ring + (size_t)b * stride + (a ? half : 0);
  }
  __device__ void drain() { cp_async_wait<0>(); }
};

// The scaling of each lane's own row of c (B, KP) by the port's rule: the
// least s >= 0 with bound / theta <= 2^s, at most max_sq, s = 0 for a
// non-finite bound; the scaled row into cs, 2^-s into scl, 2^s into np (0
// for lanes past the batch). One thread per lane.
template <typename T>
__device__ void adj_scale_rows(const T* __restrict__ c, int rows, int lanes, const RowSmem<T>& s,
                               const AdjParams<T>& p) {
  for (int lr = threadIdx.x; lr < lanes; lr += blockDim.x) {
    const bool ok = lr < rows;
    const T* cr = c + (size_t)(ok ? lr : 0) * p.KP;
    T bound = T(0);
    for (int k = 0; k < p.KP; ++k) {
      const T term = mul_rn(fabs(ok ? cr[k] : T(0)), p.norms[k]);
      bound = k == 0 ? term : add_rn(bound, term);
    }
    const T ratio = bound / p.theta;
    int e2 = 0;
    if (isfinite(bound) && ratio > T(1)) {
      int e = 0;
      const T mant = frexp_full(ratio, &e);
      e2 = e - (mant == T(0.5) ? 1 : 0);
      e2 = e2 < 0 ? 0 : (e2 > p.max_sq ? p.max_sq : e2);
    }
    const int n_pass = 1 << e2;
    const T scale = T(1) / T(n_pass);  // exact
    for (int k = 0; k < p.KP; ++k) s.cs[(size_t)lr * p.KP + k] = (ok ? cr[k] : T(0)) * scale;
    s.scl[lr] = scale;
    s.np[lr] = ok ? n_pass : 0;
  }
}

// The pairing coefficients c(i, l) = i! l! / (i + l + 1)! = 1 / ((i + l +
// 1) C(i + l, i)) for i + l < m into coef[i m + l], once a block: each
// denominator exact in double, rounded once to T, then one IEEE division
// (the twin's _pair_coef).
template <typename T>
__device__ void pair_coefs(T* coef, int m) {
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int i = e / m, l = e % m;
    double bin = 1.0;
    for (int u = 1; u <= i; ++u) bin = bin * (double)(l + u) / (double)u;
    coef[e] = i + l < m ? T(1) / T((double)(i + l + 1) * bin) : T(0);
  }
}

// One reverse row of the tile (see the note above); every thread of the
// block (of every block of the cluster, CLUSTER) calls it. Before the call
// the ring's prologue is issued and the scaled rows, 2^-s and the pass
// counts of the tile's lanes are in shared memory, the same in every block
// of a cluster. x, a (rows, D) are read, xn, an (rows, D) and cb (rows,
// K') written (cb by the cluster's first block). The block owns the
// columns [c0, c0 + dc) (width: the slice its layout holds) and needs (2L
// / RM) * ceil(dc / CN) threads or more.
template <typename T, int RM, int CN, bool CLUSTER>
__device__ void adjoint_row_tile(const T* __restrict__ x, const T* __restrict__ a,
                                 T* __restrict__ xn, T* __restrict__ an, T* __restrict__ cb,
                                 const RowSmem<T>& sm, PairRing<T>& ring, int rows, int lanes,
                                 int D, int c0, int dc, int width, int m, int kp) {
  namespace cg = cooperative_groups;
  const int r2 = 2 * lanes;
  const int ncl = (dc + CN - 1) / CN;  // the block's column groups
  const int tid = threadIdx.x;
  const bool active = tid < (r2 / RM) * ncl;
  const int cg_ = tid % ncl;
  const int lc0 = cg_ * CN, col0 = c0 + lc0, lr0 = (tid / ncl) * RM;
  const int cend = c0 + dc;
  const bool is_x = lr0 < lanes;
  const int ln0 = is_x ? lr0 : lr0 - lanes;  // the lane of the thread's first row
  const int H = row_hist(m), HS = gemm_dp(width);
  const size_t tsz = (size_t)D * r2, hsz = (size_t)r2 * HS;
  int nblk = 1, rank = 0;
  if constexpr (CLUSTER) {
    nblk = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  auto xsync = [&]() {
    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  if constexpr (CLUSTER) cg::this_cluster().sync();  // every block has started
  // v as term s into buffer buf of every block, and as the chain's stored
  // term s (s < H) into this block's hist, zeros past the columns
  auto publish = [&](const T (&v)[RM][CN], int buf, int s) {
    if (!active) return;
    for (int blk = 0; blk < nblk; ++blk) {
      T* dst = sm.term + buf * tsz;
      if constexpr (CLUSTER) dst = cg::this_cluster().map_shared_rank(dst, blk);
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int k = 0; k < CN; ++k)
          if (col0 + k < cend) dst[(size_t)(col0 + k) * r2 + lr0 + q] = v[q][k];
    }
    if (s < H) {
      T* h = sm.hist + s * hsz + (size_t)lr0 * HS + lc0;
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int k = 0; k < CN; ++k) h[(size_t)q * HS + k] = col0 + k < cend ? v[q][k] : T(0);
    }
  };

  T acc[RM][CN], w[RM][CN], g[RM][CN];
  const T* src = is_x ? x : a;
  int np[RM];
#pragma unroll
  for (int q = 0; q < RM; ++q) {
    np[q] = active ? sm.np[ln0 + q] : 0;
#pragma unroll
    for (int k = 0; k < CN; ++k)
      acc[q][k] = active && ln0 + q < rows && col0 + k < cend
                      ? src[(size_t)(ln0 + q) * D + col0 + k] : T(0);
  }
  int np_max = 0;
  for (int lr = 0; lr < lanes; ++lr) np_max = max(np_max, sm.np[lr]);
  T part[MAX_KP][RM];  // this thread's partial cbar, local memory
  for (int b = 0; b < kp; ++b)
#pragma unroll
    for (int q = 0; q < RM; ++q) part[b][q] = T(0);
  const T sgn = is_x ? T(-1) : T(1);  // x: e^{-A}

  int cur = 0;
  for (int p = 0; p <= np_max; ++p) {
    const bool a_on = p >= 1;                   // the a chain's pass p - 1 runs
    const bool work = active && (is_x || a_on);  // this thread's products run
    bool upd[RM], pair[RM];
#pragma unroll
    for (int q = 0; q < RM; ++q) {
      upd[q] = is_x ? p < np[q] : (a_on && p - 1 < np[q]);
      pair[q] = a_on && p <= np[q];
    }
    publish(acc, cur ^ 1, 0);  // the pass starts: y_p and z_{p-1}
    xsync();
    cur ^= 1;
    for (int s = 1; s <= m; ++s) {
      // g: the stored terms of the other chain this step pairs with
      const int top = is_x ? min(s - 2, m - s) : min(s - 1, m - s);
      const bool pairs = work && a_on && top >= 0;
      if (pairs) {
        const T* hs = sm.hist + (size_t)(is_x ? lr0 + lanes : lr0 - lanes) * HS + lc0;
        for (int h = 0; h <= top; ++h) {
          // x side: c(h, s-1) alpha_h; a side: c(s-1, h) t_h, t_h = (-1)^h T^x_h
          T coef = sm.coef[is_x ? h * m + s - 1 : (s - 1) * m + h];
          if (!is_x && (h & 1)) coef = -coef;
#pragma unroll
          for (int q = 0; q < RM; ++q) {
            T v[CN];
            lds_vec<T, CN>(hs + h * hsz + (size_t)q * HS, v);
#pragma unroll
            for (int k = 0; k < CN; ++k) {
              const T t = mul_rn(coef, v[k]);
              g[q][k] = h == 0 ? t : add_rn(g[q][k], t);
            }
          }
        }
        if (is_x && ((s - 1) & 1)) {  // W_k t_{s-1} = (-1)^{s-1} W_k T^x_{s-1}
#pragma unroll
          for (int q = 0; q < RM; ++q)
#pragma unroll
            for (int k = 0; k < CN; ++k) g[q][k] = -g[q][k];
        }
      }
      // the K' actions of term s - 1: each folded at once into w in k order
      // and, where this step pairs, dotted with g into part
      auto fold = [&](int b, const T (&yv)[RM][CN]) {
#pragma unroll
        for (int q = 0; q < RM; ++q) {
          const T cq = sgn * sm.cs[(size_t)(ln0 + q) * kp + b];
#pragma unroll
          for (int k = 0; k < CN; ++k) {
            const T t = mul_rn(cq, yv[q][k]);
            w[q][k] = b == 0 ? t : add_rn(w[q][k], t);
          }
          if (pairs && pair[q]) {
            T d = part[b][q];
#pragma unroll
            for (int k = 0; k < CN; ++k)
              if (col0 + k < cend) d = fma_full(g[q][k], yv[q][k], d);
            part[b][q] = d;
          }
        }
      };
      tile_zero<T, RM, CN>(w);
      const T* tm = sm.term + cur * tsz + lr0;
      if (ring.resident) {
        constexpr int KB = RM * CN < 8 ? 4 : 1;
        auto block = [&](auto nb, int b) {
          constexpr int N = decltype(nb)::value;
          T yv[N][RM][CN];
#pragma unroll
          for (int n = 0; n < N; ++n) tile_zero<T, RM, CN>(yv[n]);
          tile_fma_n<T, RM, CN, N>(tm, r2, ring.panel(b, !is_x) + lc0, ring.stride, ring.DP, D,
                                   yv);
#pragma unroll
          for (int n = 0; n < N; ++n) fold(b + n, yv[n]);
        };
        if (work) {
          int b = 0;
          for (; b + KB <= kp; b += KB) block(std::integral_constant<int, KB>{}, b);
          if constexpr (KB > 1) {
            const int left = kp - b;
            if (left == 1) block(std::integral_constant<int, 1>{}, b);
            if (left == 2) block(std::integral_constant<int, 2>{}, b);
            if (left == 3) block(std::integral_constant<int, 3>{}, b);
          }
        }
      } else {
        for (int b = 0; b < kp; ++b) {
          T yv[RM][CN];
          tile_zero<T, RM, CN>(yv);
          for (int j0 = 0; j0 < D; j0 += ring.jc) {
            const T* st = ring.acquire();
            if (work)
              tile_fma<T, RM, false, CN>(tm + (size_t)j0 * r2, r2,
                                         st + (is_x ? 0 : ring.half) + lc0, ring.DP,
                                         ring.rows_of(j0), yv);
          }
          if (work) fold(b, yv);
        }
      }
      // the new term w / s
      if (work) {
        const T div = T(s);
#pragma unroll
        for (int q = 0; q < RM; ++q)
#pragma unroll
          for (int k = 0; k < CN; ++k) {
            const T nt = w[q][k] / div;
            w[q][k] = nt;
            if (upd[q]) acc[q][k] = acc[q][k] + nt;
          }
      }
      if (s < m) {
        publish(w, cur ^ 1, s);
        cur ^= 1;
      }
      xsync();  // the new term is written; every read of the old one and of hist done
    }
  }

  // cbar: per lane and k over the block's column groups in order, x row
  // then a row, into blk; then (CLUSTER) over the blocks in rank order
  T* red = sm.term;  // (2L, ncl)
  for (int b = 0; b < kp; ++b) {
    if (active) {
#pragma unroll
      for (int q = 0; q < RM; ++q) red[(size_t)(lr0 + q) * ncl + cg_] = part[b][q];
    }
    __syncthreads();
    for (int lr = tid; lr < lanes; lr += blockDim.x) {
      T sum = T(0);
      for (int c = 0; c < ncl; ++c) sum = add_rn(sum, red[(size_t)lr * ncl + c]);
      for (int c = 0; c < ncl; ++c) sum = add_rn(sum, red[(size_t)(lanes + lr) * ncl + c]);
      sm.blk[(size_t)lr * kp + b] = sum;
    }
    __syncthreads();
  }
  if constexpr (CLUSTER) cg::this_cluster().sync();  // every block's sums are written
  if (rank == 0) {
    for (int e = tid; e < rows * kp; e += blockDim.x) {
      T sum = sm.blk[e];
      for (int blk = 1; blk < nblk; ++blk) {
        const T* other = sm.blk;
        if constexpr (CLUSTER) other = cg::this_cluster().map_shared_rank(sm.blk, blk);
        sum = add_rn(sum, other[e]);
      }
      cb[e] = mul_rn(sm.scl[e / kp], sum);  // 2^-s: exact
    }
  }
  if (active) {
    T* dst = is_x ? xn : an;
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int k = 0; k < CN; ++k)
        if (ln0 + q < rows && col0 + k < cend)
          dst[(size_t)(ln0 + q) * D + col0 + k] = acc[q][k];
  }
  if constexpr (CLUSTER) cg::this_cluster().sync();  // no block leaves while the first reads
}

}  // namespace vec_ode
