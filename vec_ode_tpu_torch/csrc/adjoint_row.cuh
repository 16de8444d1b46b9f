// One reverse row of the reversible adjoint with per-lane rows for a tile
// of trajectories, as device functions that every thread of a block calls
// together: the counterpart of
// vec_ode_tpu/ops/pallas_expmv.py:_adjoint_row_chains, run by the
// single-row kernel K6 of adjoint.cu (the reverse sweep K8 shares the rows
// of the batch and forms their exponents instead; adjoint.cu's note).
//
// With A = sum_k c_k W_k over the working basis (K' = KP terms), scaled by
// 2^-s (ops/adjoint.py: one count per lane from sum_k |c_k| ||W_k||_1; the
// Fréchet direction adds nothing to it), a row computes
//   1. x_n = e^{-A} x and a_n = e^{A^T} a: 2^s passes of the degree-m
//      Taylor polynomial each, side by side in two thread groups;
//   2. u_k = D_{W_k} e^{A} x_n for every k by the block-triangular
//      recurrence: per Taylor term u_k' = (A u_k + 2^-s W_k w) / j and
//      w' = (A w) / j from w = x_n, u_k = 0; KP + 1 thread groups, one per
//      chain, and the w group's K' actions W_k w serve both A w and the
//      direction terms, so a term costs K'^2 + K' actions;
//   3. cbar_k = <a, u_k> per trajectory, summed over its columns in a
//      fixed order.
// Every lane has its own row, so no exponent is shared: every action of a
// Taylor term is chain_step.cuh's product chain_products (one (rows, D) @
// (D, KP*D) product; MT = [W_0^T | ...] for W v and MS = [W_0 | ...] for
// W^T v), the KP actions combined in k order with explicitly rounded
// operations and divided by the term's index, as the twin
// ops/adjoint.py:torch_adjoint_row does. Trajectories that have finished
// their passes are masked while the block runs to its largest count.
//
// Layout. Each thread owns one trajectory (RT = 1) and CT columns of one
// chain (thread group); the chains' running sums stay in registers, their
// Taylor terms in shared memory (one (tile, D) slot each), and the basis
// streams from device memory (L2) at every term, as in K4. Per trajectory
// the row keeps x, a, a_n, the KP + 1 terms and the w group's KP actions
// in shared memory: (2 KP + 4) D values.
//
// Precision. IEEE FMA in the state's type inside the products, explicitly
// rounded combination (no contraction), IEEE division; never TF32, never
// --use_fast_math.

#pragma once

#include "chain_step.cuh"

namespace vec_ode {

constexpr int ADJ_MAX_KP = 6;         // ops/adjoint.py: MAX_KP
// Blocks of at most ADJ_NARROW_THREADS threads keep up to 128 registers a
// thread (the products spill under the 64 of a 1024-thread block); only a
// trajectory whose chains need more threads (K' + 1 groups of ceil(D / CT),
// up to 896) takes a wide block.
constexpr int ADJ_NARROW_THREADS = 256;
constexpr int ADJ_MAX_THREADS = 1024;
constexpr int ADJ_MAX_TILE = 8;

template <typename T>
struct AdjParams {
  int KP, m, max_sq;
  T theta;
  T norms[ADJ_MAX_KP];  // ||W_k||_1
};

// The scratch of one tile in shared memory, carved from one block of T.
template <typename T>
struct AdjSmem {
  T* x;     // (tile, D): the state, x_n after the row
  T* a;     // (tile, D): the cotangent a (a_{n+1})
  T* an;    // (tile, D): a_n
  T* term;  // (G, tile, D): each chain's Taylor term
  T* prod;  // (KP, tile, D): the w group's actions; then cbar partials
  T* cs;    // (tile, KP): the scaled rows
  T* scl;   // (tile): 2^-s
  T* cbr;   // (tile, KP): cbar per trajectory
  int* np;  // (tile): 2^s, 0 for rows past the batch

  __host__ __device__ static size_t elems(int tile, int D, int KP) {
    const size_t slots = 3 + (KP + 1) + KP;
    const size_t ints = (size_t)tile * sizeof(int);
    return slots * tile * D + 2 * (size_t)tile * KP + tile + (ints + sizeof(T) - 1) / sizeof(T);
  }
  __device__ static AdjSmem carve(T* base, int tile, int D, int KP) {
    AdjSmem s;
    const size_t n = (size_t)tile * D;
    s.x = base;
    s.a = s.x + n;
    s.an = s.a + n;
    s.term = s.an + n;
    s.prod = s.term + (size_t)(KP + 1) * n;
    s.cs = s.prod + (size_t)KP * n;
    s.scl = s.cs + (size_t)tile * KP;
    s.cbr = s.scl + tile;
    s.np = reinterpret_cast<int*>(s.cbr + (size_t)tile * KP);
    return s;
  }
};

// Bytes of shared memory a block takes.
template <typename T>
inline size_t adj_smem_bytes(int tile, int D, int KP) {
  return AdjSmem<T>::elems(tile, D, KP) * sizeof(T);
}

// Trajectories per block: the largest power of two up to ADJ_MAX_TILE
// whose threads (KP + 1 groups x tile x ceil(D / CT)) fit a narrow block
// (a wide one where one trajectory needs more) and whose shared memory
// fits, halved while the batch gives fewer than n_sm / 2 blocks (at B =
// 256, D = 128, K' = 3: 2 trajectories, 128 blocks). The results do not
// depend on it.
template <typename T>
inline int adj_tile(int B, int D, int KP, int n_sm, int max_smem) {
  const int ncg = (D + CT - 1) / CT;
  const int G = KP + 1;
  const long limit = G * ncg <= ADJ_NARROW_THREADS ? ADJ_NARROW_THREADS : ADJ_MAX_THREADS;
  int tile = ADJ_MAX_TILE;
  while (tile > 1 && ((long)G * tile * ncg > limit ||
                      adj_smem_bytes<T>(tile, D, KP) > (size_t)max_smem))
    tile /= 2;
  while (tile > 1 && (B + tile - 1) / tile < n_sm / 2) tile /= 2;
  return tile;
}

// The scaling of one row c (KP values) by the port's rule: the least s >= 0
// with bound / theta <= 2^s, at most max_sq, s = 0 for a non-finite bound.
// Writes the scaled row, 2^-s and 2^s (0 when !ok) for trajectory lr.
template <typename T>
__device__ void adj_scale_row(const T* c, bool ok, int lr, const AdjSmem<T>& s,
                              const AdjParams<T>& p) {
  T bound = T(0);
  for (int k = 0; k < p.KP; ++k) {
    const T term = mul_rn(fabs(c[k]), p.norms[k]);
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
  for (int k = 0; k < p.KP; ++k) s.cs[(size_t)lr * p.KP + k] = c[k] * scale;
  s.scl[lr] = scale;
  s.np[lr] = ok ? n_pass : 0;
}

// Where a thread sits: its chain (group), trajectory and column group.
struct AdjLane {
  int grp, lr, cg, ncg;
  __device__ AdjLane(int tile, int D) {
    ncg = (D + CT - 1) / CT;
    const int per = tile * ncg;
    grp = threadIdx.x / per;
    const int r = threadIdx.x % per;
    lr = r / ncg;
    cg = r % ncg;
  }
};

// sum_k sgn c_k y_k in k order, explicitly rounded.
template <typename T, int KP>
__device__ __forceinline__ T adj_combine(const T* c, T sgn, const T (&y)[KP][1][CT], int col) {
  T w = mul_rn(sgn * c[0], y[0][0][col]);
#pragma unroll
  for (int b = 1; b < KP; ++b) w = add_rn(w, mul_rn(sgn * c[b], y[b][0][col]));
  return w;
}

// Phase 1: group 0 takes x to e^{-A} x in place (MT), group 1 takes a to
// e^{A^T} a into s.an (MS). Every thread calls it.
template <typename T, int KP>
__device__ void adj_state_chains(const AdjSmem<T>& s, int tile, int D, const T* __restrict__ mt,
                                 const T* __restrict__ ms, int m) {
  const AdjLane ln(tile, D);
  const bool in = ln.grp <= 1;
  const bool is_x = ln.grp == 0;
  T* slot = s.term + (size_t)(in ? ln.grp : 0) * tile * D;
  const T* mat = is_x ? mt : ms;
  const T* src = is_x ? s.x : s.a;
  const T sgn = is_x ? T(-1) : T(1);
  const int my_np = in ? s.np[ln.lr] : 0;
  const T* cq = s.cs + (size_t)(in ? ln.lr : 0) * KP;
  const size_t row = (size_t)ln.lr * D;
  T acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const int col = ln.cg + c * ln.ncg;
    acc[c] = (in && col < D) ? src[row + col] : T(0);
  }
  for (int pass = 0;; ++pass) {
    if (in) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = ln.cg + c * ln.ncg;
        if (col < D) slot[row + col] = acc[c];
      }
    }
    // the pass's start state is written; go on while any row has passes
    if (!__syncthreads_or(in && my_np > pass)) break;
    for (int kk = 1; kk <= m; ++kk) {
      T y[KP][1][CT];
      if (in) chain_products<T, 1, KP>(slot, mat, D, ln.lr, ln.cg, ln.ncg, y);
      __syncthreads();  // every read of the terms is done
      if (in) {
        const T div = T(kk);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int col = ln.cg + c * ln.ncg;
          if (col >= D) continue;
          const T nt = adj_combine<T, KP>(cq, sgn, y, c) / div;
          slot[row + col] = nt;
          if (pass < my_np) acc[c] = acc[c] + nt;
        }
      }
      __syncthreads();  // the new terms are written
    }
  }
  if (in) {
    T* dst = is_x ? s.x : s.an;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = ln.cg + c * ln.ncg;
      if (col < D) dst[row + col] = acc[c];
    }
  }
  __syncthreads();
}

// Phases 2 and 3: the Fréchet chains from w = x_n (s.x) and cbar_k =
// <a, u_k> into s.cbr. Every thread calls it.
template <typename T, int KP>
__device__ void adj_frechet(const AdjSmem<T>& s, int rows, int tile, int D,
                            const T* __restrict__ mt, int m) {
  const AdjLane ln(tile, D);
  const bool in = ln.grp <= KP;
  const bool is_w = ln.grp == KP;
  const size_t n = (size_t)tile * D;
  T* slot = s.term + (size_t)(in ? ln.grp : 0) * n;
  const int my_np = in ? s.np[ln.lr] : 0;
  const T* cq = s.cs + (size_t)(in ? ln.lr : 0) * KP;
  const T sc = in ? s.scl[ln.lr] : T(0);
  const size_t row = (size_t)ln.lr * D;
  const T* dir = s.prod + (size_t)(in && !is_w ? ln.grp : 0) * n;
  T acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const int col = ln.cg + c * ln.ncg;
    acc[c] = (is_w && col < D) ? s.x[row + col] : T(0);
  }
  for (int pass = 0;; ++pass) {
    if (in) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = ln.cg + c * ln.ncg;
        if (col < D) slot[row + col] = acc[c];
      }
    }
    if (!__syncthreads_or(in && my_np > pass)) break;
    for (int kk = 1; kk <= m; ++kk) {
      T y[KP][1][CT];
      if (in) chain_products<T, 1, KP>(slot, mt, D, ln.lr, ln.cg, ln.ncg, y);
      if (is_w) {  // W_k w for the direction terms of every u_k
#pragma unroll
        for (int k = 0; k < KP; ++k)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const int col = ln.cg + c * ln.ncg;
            if (col < D) s.prod[k * n + row + col] = y[k][0][c];
          }
      }
      __syncthreads();  // every read of the terms is done, the actions written
      if (in) {
        const T div = T(kk);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int col = ln.cg + c * ln.ncg;
          if (col >= D) continue;
          T w = adj_combine<T, KP>(cq, T(1), y, c);
          if (!is_w) w = add_rn(w, mul_rn(sc, dir[row + col]));
          const T nt = w / div;
          slot[row + col] = nt;
          if (pass < my_np) acc[c] = acc[c] + nt;
        }
      }
      __syncthreads();  // the new terms are written
    }
  }
  // cbar_k = <a, u_k>: per thread over its columns, then over the column
  // groups in order; the action slots take the partials
  T part = T(0);
  const bool is_u = in && !is_w && ln.lr < rows;
  if (is_u) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = ln.cg + c * ln.ncg;
      if (col < D) part = add_rn(part, mul_rn(s.a[row + col], acc[c]));
    }
  }
  T* red = s.prod;  // (KP, tile, ncg)
  if (in && !is_w) red[((size_t)ln.grp * tile + ln.lr) * ln.ncg + ln.cg] = part;
  __syncthreads();
  for (int i = threadIdx.x; i < KP * tile; i += blockDim.x) {
    const int k = i / tile, lr = i % tile;
    const T* pr = red + ((size_t)k * tile + lr) * ln.ncg;
    T sum = T(0);
    for (int g = 0; g < ln.ncg; ++g) sum = add_rn(sum, pr[g]);
    s.cbr[(size_t)lr * KP + k] = sum;
  }
  __syncthreads();
}

// One reverse row of the tile (see the note above): x -> x_n in s.x, a_n in
// s.an, cbar in s.cbr; s.a is left as it was. Before the call s.x, s.a,
// s.cs, s.scl and s.np hold the tile's rows (zeros and np = 0 past `rows`).
template <typename T, int KP>
__device__ void adjoint_row_tile(const AdjSmem<T>& s, int rows, int tile, int D,
                                 const T* __restrict__ mt, const T* __restrict__ ms, int m) {
  adj_state_chains<T, KP>(s, tile, D, mt, ms, m);
  adj_frechet<T, KP>(s, rows, tile, D, mt, m);
}

}  // namespace vec_ode
