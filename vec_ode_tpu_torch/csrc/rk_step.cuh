// The embedded Runge-Kutta step of one tile of trajectories of
// dx/dt = (M0 + u(t) M1) x, with a declared drive u (numerics.cuh: Drive),
// as a device function that every thread of
// a block calls together. Shared by the per-step kernel (fused_rk_step.cu,
// K1) and the whole-loop kernel (fused_loop.cu, K2, whose step this is:
// the counterpart of vec_ode_tpu/ops/pallas_loop.py:make_rk_step_builder,
// K3).
//
// It computes what vec_ode_tpu/ops/pallas_rk.py:_make_kernel computes:
// every stage K_i = y0 + u_i y1 with y0 = x_i M0^T, y1 = x_i M1^T at the
// stage input x_i = x + dt sum_{j<i} a_ij K_j and u_i = u(t_i),
// t_i = t + c_i dt (t itself at stage 0), u a one-term CoeffForm (a + b t +
// c cos(w t); the cos(w t) drive is (0, 0, 1, w), whose zero terms the
// sampler leaves out) or a one-term ChebForm read from device memory; the advance x + dt sum_j b_j K_j
// (minus the error when advance_lower); the embedded error
// dt sum_j (b_j - b_err_j) K_j; and its per-row measure ErrNorm
// (numerics.cuh: chain_err_measure, which the chain step ends with too).
//
// Layout. A thread owns RM rows x CN = 4 contiguous columns of the tile and
// keeps every stage value K_j of its outputs to itself: in registers
// (KS > 0: up to KS stages, the plan's choice for f32) or in a region of
// shared memory that only that thread touches ([stage][row][thread][4],
// no barrier). The stage input is formed at the thread's outputs and is
// the only value other threads read: it is published transposed, (D,
// tile), into one of two term buffers that alternate, with one block
// barrier a stage, and read as the left operand of the stage's two
// products (gemm_tile.cuh) against MT = [M0^T | M1^T] (two panels of
// D x DP): resident in shared memory, loaded once per block, both read
// with one load of the stage's rows (tile_fma_n<2>), or streamed from L2
// through the ring of panels (M0^T, then M1^T, each in slabs of jc
// contraction rows; one term buffer, the ring's barriers ordering it). A
// warp spans wc column groups (the largest power of two up to 8 dividing
// DP / 4) x 32 / wc row groups, row groups fastest, so that a load of the
// operator serves 32 / wc row groups, a load of the stage's rows wc column
// groups, and a thread's RM rows of a column are one store of the stage
// input. u_i is computed once a row and stage, before the stage's
// barrier, into one of two slots that alternate.
// After the last stage the error vector goes row-major (tile, D) into the
// first term buffer, where chain_err_measure reduces it one row a thread.
// Rows at or past `rows` are computed on zeros and never written;
// padding columns are computed and never written.
//
// Precision. Each element of a product is one IEEE FMA chain over j in
// increasing order from zero in the state's type (never TF32), so the
// panel split and the launch shape change no bit: K1 and K2 give the same
// bits on the same rows. Everything else is rounded as the plain twin
// (ops/fused_rk.py:torch_rk_step) rounds it, with mul_rn / add_rn /
// sub_rn: term = a_ij K_j, acc = acc + term (zero a_ij skipped, j in
// order), x_i = x + dt acc; t_i = t + c_i dt, u_i = u(t_i) (numerics.cuh:
// drive_at, the full cosine, ChebForm by Clenshaw); K_i = y0 + u_i y1; x_b = x + dt (b_0 K_0 + ...), err = dt
// (db_0 K_0 + ...), x_out = x_b - err. A NaN row stays in its row and
// gives a NaN error. Build without --use_fast_math.

#pragma once

#include <type_traits>
#include <utility>

#include "gemm_tile.cuh"

namespace vec_ode {

// The warp's column groups: the largest power of two up to 8 that divides
// the ncl column groups of 4 (ops/fused_rk.py: rk_wc).
__host__ __device__ inline int rk_wc(int ncl) {
  int wc = 1;
  while (wc < 8 && ncl % (2 * wc) == 0) wc *= 2;
  return wc;
}

// The shared memory of the RK step, byte offsets of each region (each
// 16-byte aligned): the term buffers (nbuf x (D, tile): two with the
// operator resident, one streamed; the first takes the error vector), the
// operator (two resident panels of D x DP, or the ring), the drive (two
// slots of tile values) and, without registers for them (kshared), the
// stage values (s x tile x DP). ops/fused_rk.py:rk_smem_bytes mirrors it.
template <typename T>
struct RKLayout {
  size_t term, ring, u, ks, total;
  int nbuf;
  __host__ __device__ RKLayout(int tile, int D, int s, bool kshared, bool resident) {
    const size_t dp = gemm_dp(D);
    nbuf = resident ? 2 : 1;
    size_t at = 0;
    term = at, at += align16((size_t)nbuf * D * tile * sizeof(T));
    ring = at;
    at += align16(resident ? 2 * D * dp * sizeof(T)
                           : (size_t)GEMM_STAGES * gemm_jc<T>(D) * dp * sizeof(T));
    u = at, at += align16(2 * (size_t)tile * sizeof(T));
    ks = at;
    if (kshared) at += align16((size_t)s * tile * dp * sizeof(T));
    total = at;
  }
};

// The outputs of this thread: rows [lr0, lr0 + RM) and columns [col0,
// col0 + 4) of the tile; item: its index among the (tile / RM) x DP / 4
// microtiles (the block's threads, rounded up to a warp, cover them all).
struct RKThread {
  int lr0, col0, item;
  bool active;
};

template <int RM>
__device__ __forceinline__ RKThread rk_thread(int tile, int D) {
  const int ncl = gemm_dp(D) / GEMM_CN, ngr = tile / RM;
  const int wc = rk_wc(ncl), ncb = ncl / wc;
  const int rgs = 32 / wc < ngr ? 32 / wc : ngr;
  const int tid = threadIdx.x;
  const int t1 = tid / rgs, t2 = t1 / wc;
  const int cg = (t2 % ncb) * wc + t1 % wc, rg = (t2 / ncb) * rgs + tid % rgs;
  return RKThread{rg * RM, cg * GEMM_CN, rg * ncl + cg, rg < ngr};
}

// u(t_i) of the declared drive at stage i's node t_i = t + c_i dt (t
// itself at the first stage), rounded as the twin: the one place the step
// reads its drive.
template <typename T>
__device__ __forceinline__ T rk_drive(const Drive<T>& dr, T t, T dt, T ci, int i) {
  const T ti = i == 0 ? t : add_rn(t, mul_rn(ci, dt));
  return drive_at(dr, ti);
}

// A stage index, from a constant (stage_switch) or at run time.
template <int I>
__device__ __forceinline__ constexpr int stage_of(std::integral_constant<int, I>) {
  return I;
}
__device__ __forceinline__ constexpr int stage_of(int i) { return i; }

// f(std::integral_constant<int, i>) for i < N: a stage index as a constant,
// so that registers indexed by it stay registers.
template <class F, int... I>
__device__ __forceinline__ void stage_switch_(int i, F& f, std::integer_sequence<int, I...>) {
  ((i == I ? (f(std::integral_constant<int, I>{}), 0) : 0), ...);
}
template <int N, class F>
__device__ __forceinline__ void stage_switch(int i, F& f) {
  stage_switch_(i, f, std::make_integer_sequence<int, N>{});
}

// One embedded RK step of a tile (see the note above); every thread of
// the block calls it. t_rows, dt_rows (rows,), x and x_out (rows, D) may be
// in device or shared memory; err_out (rows,) gets the error measure, zero
// without an embedded pair. scratch holds the layout L; ring streams or
// holds MT (two terms of the PanelRing) and is left at the start of a
// stage, so that the next tile or step goes on with it. KS > 0 keeps the
// stage values in registers and needs s <= KS. The block needs
// (tile / RM) x DP / 4 threads or more.
template <typename T, int RM, int KS>
__device__ void rk_step_tile(const T* __restrict__ t_rows, const T* __restrict__ dt_rows,
                             const T* x, T* x_out, T* __restrict__ err_out,
                             unsigned char* scratch, const RKLayout<T>& L, PanelRing<T>& ring,
                             int rows, int tile, int D, const Tableau<T>& tab, int s, int has_err,
                             int advance_lower, const Drive<T>& dr, const ErrNorm<T>& en) {
  constexpr int CN = GEMM_CN;
  constexpr int JN = KS > 0 ? KS : MAX_STAGES;  // stages a loop over j may reach
  const RKThread th = rk_thread<RM>(tile, D);
  const size_t tsz = (size_t)D * tile;
  const int items = (tile / RM) * (gemm_dp(D) / CN);
  T* term = reinterpret_cast<T*>(scratch + L.term);
  T* su = reinterpret_cast<T*>(scratch + L.u);
  T* kss = reinterpret_cast<T*>(scratch + L.ks);

  // this thread's rows' dt, its outputs of x
  T dtr[RM], xv[RM][CN];
#pragma unroll
  for (int q = 0; q < RM; ++q) {
    const int lr = th.lr0 + q;
    const bool ok = th.active && lr < rows;
    dtr[q] = ok ? dt_rows[lr] : T(0);
#pragma unroll
    for (int c = 0; c < CN; ++c)
      xv[q][c] = ok && th.col0 + c < D ? x[(size_t)lr * D + th.col0 + c] : T(0);
  }

  // the stage values at this thread's outputs
  T kr[KS > 0 ? KS : 1][RM][CN];
  auto kslot = [&](int j, int q) { return kss + (((size_t)j * RM + q) * items + th.item) * CN; };
  auto kload = [&](int j, int q, T (&v)[CN]) {
    if constexpr (KS > 0) {
#pragma unroll
      for (int c = 0; c < CN; ++c) v[c] = kr[j][q][c];
    } else {
      lds_vec<T, CN>(kslot(j, q), v);
    }
  };

  // the stage input into term buffer b, transposed: a thread's RM rows of
  // a column in one store
  auto publish = [&](const T (&v)[RM][CN], int b) {
    if (!th.active) return;
    T* dst = term + b * tsz + th.lr0;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      if (th.col0 + c >= D) break;
      T col[RM];
#pragma unroll
      for (int q = 0; q < RM; ++q) col[q] = v[q][c];
      sts_vec(dst + (size_t)(th.col0 + c) * tile, col);
    }
  };
  int cur = 0;
  T xin[RM][CN];
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int c = 0; c < CN; ++c) xin[q][c] = xv[q][c];

  for (int i = 0; i < s; ++i) {
    // u_i = u(t_i) once a row, read after the barrier below
    T* sui = su + (i & 1) * tile;
    for (int lr = threadIdx.x; lr < tile; lr += blockDim.x)
      sui[lr] = lr < rows ? rk_drive(dr, t_rows[lr], dt_rows[lr], tab.c[i], i) : T(0);
    // (b) publish the stage input: into the other buffer, then the barrier;
    // with one buffer after the barrier, read after the ring's next one
    if (L.nbuf == 2) {
      publish(xin, cur ^ 1);
      __syncthreads();
      cur ^= 1;
    } else {
      __syncthreads();
      publish(xin, 0);
    }
    // (c) y0 = x_i M0^T, y1 = x_i M1^T
    T y[2][RM][CN];
#pragma unroll
    for (int b = 0; b < 2; ++b) tile_zero<T, RM, CN>(y[b]);
    const T* tm = term + cur * tsz + th.lr0;
    if (ring.resident) {
      if (th.active)
        tile_fma_n<T, RM, CN, 2>(tm, tile, ring.panel(0) + th.col0, ring.stage, ring.DP, D, y);
    } else {
#pragma unroll
      for (int b = 0; b < 2; ++b)
        for (int j0 = 0; j0 < D; j0 += ring.jc) {
          const T* st = ring.acquire();
          if (th.active)
            tile_fma<T, RM, false, CN>(tm + (size_t)j0 * tile, tile, st + th.col0, ring.DP,
                                       ring.rows_of(j0), y[b]);
        }
    }
    // (d, e) K_i = y0 + u_i y1, kept; (a) the next stage's input
    T u[RM];
#pragma unroll
    for (int q = 0; q < RM; ++q) u[q] = th.active ? sui[th.lr0 + q] : T(0);
    auto tail = [&](auto I) {
      if (!th.active) return;  // no outputs, no stage values
      const int si = stage_of(I);
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        T kv[CN];
#pragma unroll
        for (int c = 0; c < CN; ++c) kv[c] = add_rn(y[0][q][c], mul_rn(u[q], y[1][q][c]));
        if constexpr (KS > 0) {
#pragma unroll
          for (int c = 0; c < CN; ++c) kr[si][q][c] = kv[c];
        } else {
          sts_vec(kslot(si, q), kv);
        }
      }
      const int nx = si + 1;
      if (nx >= s) return;
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        T acc[CN];
        bool any = false;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          if (j >= nx) break;
          const T aij = tab.a[nx][j];
          if (aij == T(0)) continue;
          T kj[CN];
          kload(j, q, kj);
#pragma unroll
          for (int c = 0; c < CN; ++c) {
            const T t_ = mul_rn(aij, kj[c]);
            acc[c] = any ? add_rn(acc[c], t_) : t_;
          }
          any = true;
        }
#pragma unroll
        for (int c = 0; c < CN; ++c)
          xin[q][c] = any ? add_rn(xv[q][c], mul_rn(dtr[q], acc[c])) : xv[q][c];
      }
    };
    if constexpr (KS > 0)
      stage_switch<KS>(i, tail);
    else
      tail(i);
  }

  // the advance and the error vector at this thread's outputs
  T ev[RM][CN];
#pragma unroll
  for (int q = 0; q < RM; ++q) {
    if (!th.active) break;
    T sb[CN], se[CN];
    bool anyb = false, anye = false;
#pragma unroll
    for (int c = 0; c < CN; ++c) sb[c] = se[c] = T(0);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      if (j >= s) break;
      const T bj = tab.b[j], dbj = has_err ? tab.db[j] : T(0);
      if (bj == T(0) && dbj == T(0)) continue;
      T kj[CN];
      kload(j, q, kj);
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        if (bj != T(0)) {
          const T t_ = mul_rn(bj, kj[c]);
          sb[c] = anyb ? add_rn(sb[c], t_) : t_;
        }
        if (dbj != T(0)) {
          const T t_ = mul_rn(dbj, kj[c]);
          se[c] = anye ? add_rn(se[c], t_) : t_;
        }
      }
      anyb = anyb || bj != T(0);
      anye = anye || dbj != T(0);
    }
    const int lr = th.lr0 + q;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const T xb = add_rn(xv[q][c], mul_rn(dtr[q], sb[c]));
      ev[q][c] = mul_rn(dtr[q], se[c]);
      const T out = has_err && advance_lower ? sub_rn(xb, ev[q][c]) : xb;
      if (lr < rows && th.col0 + c < D) x_out[(size_t)lr * D + th.col0 + c] = out;
    }
  }

  // every read of the term buffers is done: the error vector into the first
  __syncthreads();
  if (!has_err) {
    for (int lr = threadIdx.x; lr < rows; lr += blockDim.x) err_out[lr] = T(0);
    return;
  }
  if (th.active) {
#pragma unroll
    for (int q = 0; q < RM; ++q)
#pragma unroll
      for (int c = 0; c < CN; ++c)
        if (th.col0 + c < D) term[(size_t)(th.lr0 + q) * D + th.col0 + c] = ev[q][c];
  }
  __syncthreads();
  chain_err_measure(term, x, x_out, err_out, rows, D, en);
}

}  // namespace vec_ode
