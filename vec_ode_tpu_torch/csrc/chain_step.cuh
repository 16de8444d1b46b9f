// The chain-exponential step of one tile of trajectories of a modulated
// operator A(t) = sum_k c_k(t) M_k, as a device function that every thread
// of a block calls together. Shared by the per-step kernel
// (chain_expmv.cu, K4) and the whole-loop kernel (fused_loop.cu, whose
// chain step this is: the counterpart of
// vec_ode_tpu/ops/pallas_loop.py:make_chain_step_builder, K5).
//
// It computes what vec_ode_tpu/ops/pallas_expmv.py:_make_kernel and
// make_chain_step_builder's step compute, for one exponential per chain
// (R = 1) and C <= 2 chains, in this order:
//   1. the coefficient rows of the declared recipe from the node samples
//      g (n_nodes, tile, K0) and dt: midpoint dt g; Magnus-4
//      w1_k = (dt/2)(g1_k + g2_k), w2_jk = (b2 dt dt)(g1_j g2_k - g1_k g2_j),
//      chain 0 = [w1, w2] and, for C = 2, chain 1 = [w1, 0] (the zero
//      commutator columns are still multiplied, so a NaN state still gives
//      a NaN error and a reject);
//   2. the scaling: per trajectory and chain row the bound
//      sum_k |c_k| ||M_k||_1 gives the least s >= 0 with bound/theta <= 2^s
//      (at most max_sq; s = 0 for a non-finite bound), and the row is
//      divided by 2^s (ops/expmv.py:scale_rows);
//   3. 2^s passes of the degree-m Taylor polynomial per row: each term is
//      one (rows, D) @ (D, KP*D) product with MT = [M_0^T | ... |
//      M_{KP-1}^T], the KP actions combined with the row's coefficients in
//      k order and divided by the term's index. Rows that have finished
//      their passes are masked while the block runs to its largest count;
//   4. the error: chain1 - chain0, or for magnus4_fast
//      sum_{k >= K0} w2_k (M_k y) on the advanced state; measured as
//      rk_step.cuh's ErrNorm (scaled_error, weight row, l2 or max, post).
// A row whose dt is 0 runs one pass with zero coefficients and returns x
// exactly.
//
// Layout. Each thread owns RT rows x CT columns (columns cg, cg + ncg, ...),
// as in rk_step.cuh, and keeps that part of the chain's running sum in
// registers; the Taylor term of the whole tile lives in shared memory (one
// (tile, D) slot), and the basis is read from device memory (L2) at each
// term: 3 x 128 x 128 values are 196 KB in f32 and 393 KB in f64, too
// large for shared memory beside the state. x and x_out are (tile, D)
// slots in shared memory; the per-row coefficients and pass counts too.
//
// Precision. Products accumulate by IEEE FMA in the state's type, never
// TF32. The recipe's coefficient arithmetic, the bound, the weighted sum
// of the KP actions and the scaled_error denominator are written with
// explicitly rounded operations (no contraction), in the plain twin's
// order; the pass count comes from frexp, exactly. Build without
// --use_fast_math.

#pragma once

#include "rk_step.cuh"

namespace vec_ode {

constexpr int MAX_K0 = 2;  // basis terms (ops/expmv.py: MAX_K0)
constexpr int MAX_KP = 3;  // working terms: K0 + K0 (K0 - 1) / 2
constexpr int RECIPE_MIDPOINT = 0, RECIPE_MAGNUS4 = 1, RECIPE_MAGNUS4_FAST = 2;

__device__ __forceinline__ float frexp_full(float a, int* e) { return frexpf(a, e); }
__device__ __forceinline__ double frexp_full(double a, int* e) { return frexp(a, e); }

template <typename T>
struct ChainParams {
  int K0, KP, recipe, C, m, max_sq;
  T theta;
  T c_mid, b2;         // ops/expmv.py: _C_MID, _B2 in the state's type
  T norms[MAX_KP];     // ||M_k||_1
  T form[MAX_K0][4];   // c_k(t) = a + b t + c cos(w t): a, b, c, w (loop kernel)
};

// Parses the float64 parameter array of ops/expmv.py:chain_params.
template <typename T>
ChainParams<T> parse_chain_params(const double* c, bool with_form) {
  ChainParams<T> p{};
  p.K0 = (int)c[0], p.KP = (int)c[1], p.recipe = (int)c[2], p.C = (int)c[3];
  p.m = (int)c[4], p.max_sq = (int)c[5];
  p.theta = (T)c[6], p.c_mid = (T)c[7], p.b2 = (T)c[8];
  for (int k = 0; k < p.KP && k < MAX_KP; ++k) p.norms[k] = (T)c[9 + k];
  if (with_form)
    for (int k = 0; k < p.K0 && k < MAX_K0; ++k)
      for (int f = 0; f < 4; ++f) p.form[k][f] = (T)c[9 + p.KP + 4 * k + f];
  return p;
}

// Whether the parameters are ones the kernels take (the wrapper checks
// them first).
template <typename T>
bool chain_params_ok(const ChainParams<T>& p) {
  const int kp = p.recipe == RECIPE_MIDPOINT ? p.K0 : p.K0 + p.K0 * (p.K0 - 1) / 2;
  return p.K0 >= 1 && p.K0 <= MAX_K0 && p.KP == kp && p.m >= 1 && p.max_sq >= 0 &&
         p.max_sq <= 30 && p.recipe >= 0 && p.recipe <= 2 &&
         (p.C == 1 || (p.C == 2 && p.recipe == RECIPE_MAGNUS4));
}

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

// Rows per block of a chain-step kernel: the largest power of two up to
// 256 whose threads ((R / rt) x ceil(D / CT), and one per row) stay within
// max_threads and whose three (R, D) slots (x, y, the Taylor term) take at
// most 96 KB, halved further while the batch gives fewer than two blocks
// per SM, down to 16 rows. The rows' results do not depend on it.
template <typename T>
inline int chain_tile(int B, int D, int n_sm, int rt, int max_threads) {
  const int ncg = (D + CT - 1) / CT;
  int tile = 256;
  while (tile > rt && (tile > max_threads || (tile / rt) * ncg > max_threads ||
                       3 * (size_t)tile * D * sizeof(T) > 96 * 1024))
    tile /= 2;
  while (tile > 16 && (B + tile - 1) / tile < 2 * n_sm) tile /= 2;
  return tile;
}

// The scratch the step needs in shared memory, carved from one block of T.
template <typename T>
struct ChainSmem {
  T* term;     // (tile, D): the Taylor term; then the error partials
  T* g;        // (2, tile, MAX_K0): the coefficients at the nodes
  T* rows;     // (2, tile, KP): the unscaled coefficient rows
  T* cs;       // (2, tile, KP): the scaled rows
  int* npass;  // (2, tile): 2^s per chain row, 0 for rows past the batch

  __host__ __device__ static size_t elems(int tile, int D, int KP) {
    const size_t ints = 2 * (size_t)tile * sizeof(int);
    return (size_t)tile * D + 2 * (size_t)tile * MAX_K0 + 4 * (size_t)tile * KP +
           (ints + sizeof(T) - 1) / sizeof(T);
  }
  __device__ static ChainSmem carve(T* base, int tile, int D, int KP) {
    ChainSmem s;
    s.term = base;
    s.g = s.term + (size_t)tile * D;
    s.rows = s.g + 2 * (size_t)tile * MAX_K0;
    s.cs = s.rows + 2 * (size_t)tile * KP;
    s.npass = reinterpret_cast<int*>(s.cs + 2 * (size_t)tile * KP);
    return s;
  }
};

// c_k(t) of the declared form, its terms added in the order a, b t,
// c cos(w t), the zero ones left out (ops/expmv.py:CoeffForm.sample).
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

// Fills sm.g with the declared form at the recipe's nodes of each row:
// tm = t + dt/2, and for Magnus-4 tm -/+ c_mid dt (ops/expmv.py:node_times).
// One thread per row; the caller synchronises before the step reads it.
template <typename T>
__device__ void sample_form(const T* __restrict__ t_rows, const T* __restrict__ dt_rows,
                            const ChainSmem<T>& sm, int tile, const ChainParams<T>& p) {
  for (int lr = threadIdx.x; lr < tile; lr += blockDim.x) {
    const T t = t_rows[lr], dt = dt_rows[lr];
    const T tm = add_rn(t, mul_rn(T(0.5), dt));
    const int n_nodes = p.recipe == RECIPE_MIDPOINT ? 1 : 2;
    for (int nd = 0; nd < n_nodes; ++nd) {
      T tn = tm;
      if (n_nodes == 2) {
        const T off = mul_rn(p.c_mid, dt);
        tn = nd == 0 ? sub_rn(tm, off) : add_rn(tm, off);
      }
      for (int k = 0; k < p.K0; ++k)
        sm.g[((size_t)nd * tile + lr) * MAX_K0 + k] = form_at(p.form[k], tn);
    }
  }
}

// y_k[q][c] = sum_j term[row q][j] M_k[col c][j] for the thread's RT rows and
// CT columns, k < KP, from the (tile, D) slot `term` and MT (D, KP*D).
template <typename T, int RT, int KP>
__device__ __forceinline__ void chain_products(const T* term, const T* __restrict__ mt, int D,
                                               int rg, int cg, int ncg, T (&y)[KP][RT][CT]) {
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int q = 0; q < RT; ++q)
#pragma unroll
      for (int c = 0; c < CT; ++c) y[k][q][c] = T(0);
  const T* trow = term + (size_t)(rg * RT) * D;
  const size_t ld = (size_t)KP * D;
#pragma unroll 2
  for (int j = 0; j < D; ++j) {
    T xv[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) xv[q] = trow[(size_t)q * D + j];
    const T* mrow = mt + (size_t)j * ld;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      T mv[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = cg + c * ncg;
        mv[c] = col < D ? __ldg(mrow + (size_t)k * D + col) : T(0);
      }
#pragma unroll
      for (int q = 0; q < RT; ++q)
#pragma unroll
        for (int c = 0; c < CT; ++c) y[k][q][c] = fma_full(xv[q], mv[c], y[k][q][c]);
    }
  }
}

// One chain step of a tile (see the note above); every thread of the block
// calls it. Before the call sm.g holds the node samples of rows < `rows`,
// and dt_rows, x are written; the block needs (tile / RT) * ceil(D / CT)
// threads or more. Writes x_out (rows, D) and err_out (rows,), err_out zero
// without an error estimate. x and x_out are (tile, D) slots in shared
// memory whose rows past `rows` are zero.
template <typename T, int RT, int KP>
__device__ void chain_step_tile(const T* __restrict__ dt_rows, const T* x, T* x_out,
                                T* __restrict__ err_out, const ChainSmem<T>& sm, int rows,
                                int tile, int D, const T* __restrict__ mt,
                                const ChainParams<T>& p, const ErrNorm<T>& en) {
  const int ncg = (D + CT - 1) / CT;
  const int items = (tile / RT) * ncg;
  const int tid = threadIdx.x;
  const bool active = tid < items;
  const int cg = tid % ncg;
  const int rg = tid / ncg;
  const int K0 = p.K0, C = p.C;
  const bool fast = p.recipe == RECIPE_MAGNUS4_FAST;
  const bool has_err = C == 2 || fast;

  // 1-2. the rows, their bounds and pass counts, one thread per row
  for (int lr = tid; lr < tile; lr += blockDim.x) {
    const bool ok = lr < rows;
    const T dt = ok ? dt_rows[lr] : T(0);
    const T* g1 = sm.g + (size_t)lr * MAX_K0;
    const T* g2 = sm.g + ((size_t)tile + lr) * MAX_K0;
    T row[2][KP];
    if (p.recipe == RECIPE_MIDPOINT) {
#pragma unroll
      for (int k = 0; k < KP; ++k) row[0][k] = row[1][k] = ok ? mul_rn(dt, g1[k]) : T(0);
    } else {
      const T hdt = mul_rn(T(0.5), dt);
      const T bdd = mul_rn(mul_rn(p.b2, dt), dt);
      int q = K0;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k >= K0) continue;
        const T w1 = ok ? mul_rn(hdt, add_rn(g1[k], g2[k])) : T(0);
        row[0][k] = row[1][k] = w1;
      }
      for (int j = 0; j < K0; ++j)
        for (int k = j + 1; k < K0; ++k, ++q) {
          const T w2 = ok ? mul_rn(bdd, sub_rn(mul_rn(g1[j], g2[k]), mul_rn(g1[k], g2[j])))
                          : T(0);
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            if (kk == q) {
              row[0][kk] = w2;
              row[1][kk] = T(0);
            }
        }
    }
    for (int c = 0; c < C; ++c) {
      T bound = T(0);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const T term = mul_rn(fabs(row[c][k]), p.norms[k]);
        bound = k == 0 ? term : add_rn(bound, term);
      }
      const T ratio = bound / p.theta;
      int s = 0;
      if (isfinite(bound) && ratio > T(1)) {
        int e = 0;
        const T mant = frexp_full(ratio, &e);
        s = e - (mant == T(0.5) ? 1 : 0);
        s = s < 0 ? 0 : (s > p.max_sq ? p.max_sq : s);
      }
      const int n_pass = 1 << s;
      const T scale = T(1) / T(n_pass);  // exact
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        sm.rows[((size_t)c * tile + lr) * KP + k] = row[c][k];
        sm.cs[((size_t)c * tile + lr) * KP + k] = row[c][k] * scale;
      }
      sm.npass[c * tile + lr] = ok ? n_pass : 0;
    }
  }
  __syncthreads();

  // 3. the chains
  T acc[RT][CT];
  T y[KP][RT][CT];
  for (int c = 0; c < C; ++c) {
    int np[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int lr = rg * RT + q;
      np[q] = active ? sm.npass[c * tile + lr] : 0;
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        const int col = cg + k * ncg;
        acc[q][k] = (active && col < D) ? x[(size_t)lr * D + col] : T(0);
      }
    }
    for (int pass = 0;; ++pass) {
      bool mine = false;
      if (active) {
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          mine = mine || np[q] > pass;
#pragma unroll
          for (int k = 0; k < CT; ++k) {
            const int col = cg + k * ncg;
            if (col < D) sm.term[(size_t)(rg * RT + q) * D + col] = acc[q][k];
          }
        }
      }
      // the pass's start state is written; go on while any row has passes
      if (!__syncthreads_or(mine)) break;
      for (int kk = 1; kk <= p.m; ++kk) {
        if (active) chain_products<T, RT, KP>(sm.term, mt, D, rg, cg, ncg, y);
        __syncthreads();  // every read of the term is done
        if (active) {
          const T div = T(kk);
#pragma unroll
          for (int q = 0; q < RT; ++q) {
            const int lr = rg * RT + q;
            const T* cq = sm.cs + ((size_t)c * tile + lr) * KP;
#pragma unroll
            for (int k = 0; k < CT; ++k) {
              const int col = cg + k * ncg;
              if (col >= D) continue;
              T w = mul_rn(cq[0], y[0][q][k]);
#pragma unroll
              for (int b = 1; b < KP; ++b) w = add_rn(w, mul_rn(cq[b], y[b][q][k]));
              const T nt = w / div;
              sm.term[(size_t)lr * D + col] = nt;
              if (pass < np[q]) acc[q][k] = acc[q][k] + nt;
            }
          }
        }
        __syncthreads();  // the new term is written
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int lr = rg * RT + q;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          if (col >= D || lr >= rows) continue;
          if (c == 0)
            x_out[(size_t)lr * D + col] = acc[q][k];
          else  // chain 1 - chain 0 (the thread wrote that element itself)
            acc[q][k] = acc[q][k] - x_out[(size_t)lr * D + col];
        }
      }
    }
  }
  if (!has_err) {
    for (int lr = tid; lr < rows; lr += blockDim.x) err_out[lr] = T(0);
    return;
  }

  // 4. the error vector dv (in acc) and its measure
  if (fast) {  // dv = sum_{k >= K0} w2_k (M_k y): one product on y
    if (active) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int lr = rg * RT + q;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const int col = cg + k * ncg;
          if (col < D) sm.term[(size_t)lr * D + col] = lr < rows ? x_out[(size_t)lr * D + col] : T(0);
        }
      }
    }
    __syncthreads();
    if (active) {
      chain_products<T, RT, KP>(sm.term, mt, D, rg, cg, ncg, y);
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const T* rq = sm.rows + (size_t)(rg * RT + q) * KP;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          T dv = T(0);
          bool any = false;
#pragma unroll
          for (int b = 0; b < KP; ++b) {
            if (b < K0) continue;
            const T part = mul_rn(rq[b], y[b][q][k]);
            dv = any ? add_rn(dv, part) : part;
            any = true;
          }
          acc[q][k] = dv;
        }
      }
    }
  }
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
        T v = acc[q][k];
        if (en.scaled)
          v = v / add_rn(en.atol, mul_rn(en.rtol, nan_max(fabs(x[e]), fabs(x_out[e]))));
        if (en.w_row != nullptr) v = v * en.w_row[col];
        part[q] = en.kind_max ? nan_max(fabs(v), part[q]) : part[q] + v * v;
      }
    }
  }
  __syncthreads();  // the term slot is free: it takes the partials
  T* red = sm.term;  // (tile, ncg)
  if (active) {
#pragma unroll
    for (int q = 0; q < RT; ++q) red[(rg * RT + q) * ncg + cg] = part[q];
  }
  __syncthreads();
  for (int lr = tid; lr < rows; lr += blockDim.x) {
    T a = T(0);
    for (int g = 0; g < ncg; ++g) {
      const T pv = red[lr * ncg + g];
      a = en.kind_max ? nan_max(pv, a) : a + pv;
    }
    T norm = en.kind_max ? a : sqrt_full(a);
    if (en.scaled) norm = norm * en.rtol;
    if (en.post != T(1)) norm = norm * en.post;
    err_out[lr] = norm;
  }
}

}  // namespace vec_ode
