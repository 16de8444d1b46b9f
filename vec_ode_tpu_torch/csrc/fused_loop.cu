// The whole driver loop for an ensemble of trajectories of a linear system
// with shared operators, written by hand for Hopper (sm_90a): the
// modulated-linear RK stepper dx/dt = (M0 + u(t) M1) x with a declared
// drive u (a one-term CoeffForm or ChebForm), or the
// modulated exponential steppers (exponential midpoint, Magnus-4, Magnus-6,
// commutator-free Magnus over a declared table) on A(t) = sum_k c_k(t) M_k.
//
// Replaces the Pallas TPU kernel vec_ode_tpu/ops/pallas_loop.py:
// _make_loop_kernel, launched by fused_loop_chunk (pallas_call at :1135),
// with the step of make_rk_step_builder (:890) or make_chain_step_builder
// (:680) inside it. The step is a template argument: RKLoopStep runs
// rk_step.cuh's rk_step_tile, which the per-step kernel K1 runs too (the
// same bits on the same rows, t and dt);
// ChainLoopStep samples the declared coefficient form at the step's nodes
// and runs chain_step.cuh's chain_step_tile, which the per-step kernel K4
// runs too. Per trajectory the kernel runs driver iterations as
// _make_loop_kernel.iteration (:268-551) does, row for row: the save-grid
// consult (chk_t, the end tolerance, the compensated remaining time),
// dt = min(h, rem) on stepping rows, the step with its error measure (l2,
// a declared WeightedNorm, or scaled_error), the controller (I, or PI
// with the I-term after a reject, the NaN guard) or, with adaptive = 0,
// fixed steps (every stepping row accepts and h changes only at the
// grid-hit restore, :316 and :499-502), the interior save at a grid hit,
// the compensated (TwoSum + Fast2Sum) or plain time advance, the
// step-size update with the grid-hit restore, and status, event, counters
// and reject streak in the same order; with EXTRA (a template switch,
// so that the instantiations without it are the code they were) the
// events (:354-449) and dense output (:455-474) below. Not here: traced
// event callables (a kernel runs declared forms), the lane-packed group
// mode and windowed saves (TPU layout).
//
// Events. Per declared event e (kind lin: g = sum_j w_j y_j - c, quad:
// g = sum_j w_j y_j^2 - c) the block evaluates g at every row's trial
// state with a row reduction over D in a fixed order (column group cg of
// ceil(D / 4) sums columns cg, cg + ncg, ... ; then the groups in order;
// the plain twin sums in the same order) into the step's free scratch;
// thread r then runs row r's crossing test (direction filtered), the
// regula-falsi search as step control (a search vetoes the accept and
// retries with h = max(clip(theta_min, 0.1, 0.9) dt, t_tol / 4); the
// pre-search h is restored after the locate; search iterations are not
// rejects), records the first K crossings' times in their slots, counts
// every crossing and stops the row with DONE_EVENT at a terminal n-th
// crossing. g_prev, the located times, the counter and the found flags
// live in device memory (the carries, read and written in place by
// thread r), the search flag and h_entry in thread r's registers; the
// first crossing's state is a lerp written straight to device memory in
// the element pass. No cap on the number of events.
//
// Dense output (n_grid == 2, the grid cursor starting past t0): an
// accepted step that crosses a dense time t_j (t_j > t + tol_j, t_j <=
// t_new + tol_j, tol_j = 4 eps max(1, |t_j|), t_new the compensated hi
// word when time is compensated) records (t, dt) in row r's slot j and
// its entry and exit states straight to device memory; the Hermite
// interpolant is evaluated afterwards (ops/fused_loop.py). No cap on the
// number of dense times.
//
// Blocks. One block owns a tile of R trajectories and loops until no row
// of its tile is RUNNING (__syncthreads_or), or for `iters` iterations
// when iters > 0 (chunked). ctl.max_steps bounds every row. Between
// iterations nothing leaves the block: its rows' state x, the trial state
// y and the step's scratch (the RK step's stage input, its operator and,
// in f64, its stage values; the chain step's Taylor term, basis and
// per-row coefficients) live in shared memory, and the
// per-row scalars (t, h, prev_h, err_prev, t_lo, tgt, status, event,
// counters, streak) in the registers of thread r of the block, which runs
// row r's controller. The grid point comes from device memory, chk_t =
// t_grid[min(tgt, n_grid - 1)], and interior saves go straight into the
// (n_grid - 2, B, D) buffer in device memory at their grid-hit iterations
// (no cap, no window). The ragged last tile is masked. The carries are
// read at entry and written back at exit.
//
// Choice of R, RK step (rk_loop_plan below, mirrored by ops/fused_loop.py:
// rk_loop_plan): RK_LOOP_RM = 2 rows x 4 contiguous columns a thread, the
// stage values in registers in f32 and in the thread's own shared memory
// in f64; R from chain_tile as for the chain step (below) over the RK
// step's shared memory with the operator streamed; the operator
// [M0^T | M1^T] then resident where the block's shared memory holds it at
// that R (D = 128 in f32: 128 KB), else streamed through the ring from
// step to step. At B = 2048 and 16 384, d = 64, RKF45: R = 16, 256
// threads, the operator resident in f32 (about 161 KB a block), streamed
// in f64.
// Chain step: the largest power of two up to 256 rows whose threads
// (R / 4 x ceil(D / 4): CHAIN_RM = 4 rows x 4 contiguous columns a thread)
// stay within 256 and whose three (R, D) slots (x, y, the Taylor term)
// take at most 96 KB, halved further while the batch gives fewer than two
// blocks per SM (down to 16 rows): at B = 16384, D = 128 that is R = 32
// (256 threads, 512 blocks; in f32 the term, x and y 48 KB and the basis
// ring 48 KB, about 99 KB a block, two blocks an SM), at D = 4 R = 32 too
// (8 threads in one warp, 512 blocks, the basis resident), so that every
// SM holds blocks; one slow row holds its tile either way. The chain step
// keeps its basis ring (or resident basis) from one step to the next.
//
// What bounds it: FP32 FMA throughput. RK: each iteration of each row is
// 6 stages x 128 x 256 x 2 = 393 216 FLOP at d = 64 (RKF45). Magnus-4:
// each Taylor term of each row is 128 x 384 x 2 = 98 304 FLOP, m = 8 terms
// per pass in f32, one or more passes per exponential, two chains (an
// adaptive Magnus-6 step: four exponentials at K' = 3, the comparison
// chain's two identity rows skipped; CFM-4: three at K' = 2 and a zero
// pad row). The loop touches device memory only for its carries, the
// operators (from L2) and its saves. At B = 2048 it also has too few
// blocks to fill the card (one slow row holds its whole tile), so latency,
// not throughput, is likely to bound it; making it fast is later work.
// With events a tile runs until its slowest row's bracket searches end:
// on the DrivenDense paths (64c, three located crossings, t_tol 1e-5)
// twice the plain solve's iterations for a sixth more row-iterations. g
// itself is 2 D (lin) or 3 D (quad) operations a row-iteration.
//
// Precision. The time arithmetic is written with explicitly rounded
// operations (__fadd_rn, __fsub_rn, __fmul_rn and the f64 ones): the
// compensated time is a TwoSum + Fast2Sum whose residual word would vanish
// under contraction. The controller's power is powf / pow (not __powf and
// not exp(log)); build without --use_fast_math.

#include "chain_step.cuh"
#include "rk_step.cuh"

namespace {

using namespace vec_ode;

constexpr int RK_LOOP_RM = 2;                // rows per thread in the RK step
constexpr int CHAIN_RM = 4;                  // rows per thread in the chain step
constexpr int MAX_THREADS = 256;
constexpr int N_F = 5;                       // t, h, prev_h, err_norm, t_lo
constexpr int N_I = 8;                       // tgt, status, event, n_acc, n_rej, n_it, streak, bits

// status and event codes (vec_ode_tpu_torch/driver.py)
constexpr int RUNNING = 0, DONE = 1, ERR_MAX_STEPS = 2, ERR_STALLED = 3, ERR_BAD_GRID = 4,
              DONE_EVENT = 5;
constexpr int EVT_NONE = 0, EVT_STEP = 1, EVT_CHKPT = 2, EVT_REJECT = 3, EVT_END = 4;

template <typename T>
struct Ctl {
  T rtol, alpha, inv_order, min_f, max_f, min_dt, max_dt, k_i, k_p, inv_pi_order;
  int max_steps, max_streak, pi, comp, strict;
};

// A step keeps a State across the block's iterations (start() at entry,
// finish() at exit), its scratch in shared memory (scratch_bytes, a
// multiple of 16) and needs items(tile, D) threads.
//
// The RK step: rk_step_tile at RK_LOOP_RM x 4 outputs a thread, the stage
// values in registers (KS stages, f32) or in the thread's own shared
// memory (KS = 0, f64). Its State is the operator's PanelRing (resident or
// streamed), started once and carried from step to step.
template <typename T, int KS>
struct RKLoopStep {
  const T* mt;
  Tableau<T> tab;
  int s, advance_lower;
  Drive<T> dr;  // the declared drive u(t)
  int resident;

  using State = PanelRing<T>;
  __host__ __device__ RKLayout<T> layout(int tile, int D) const {
    return RKLayout<T>(tile, D, s, KS == 0, resident != 0);
  }
  __host__ __device__ size_t scratch_bytes(int tile, int D) const {
    return layout(tile, D).total;
  }
  __host__ __device__ int items(int tile, int D) const {
    return (tile / RK_LOOP_RM) * (gemm_dp(D) / GEMM_CN);
  }
  __device__ State start(unsigned char* scratch, int tile, int D) const {
    State ring(mt, reinterpret_cast<T*>(scratch + layout(tile, D).ring), D, 2, 0, D, D,
               resident != 0);
    ring.prologue();
    return ring;
  }
  __device__ void finish(State& ring) const { ring.drain(); }
  __device__ void operator()(State& ring, const T* s_t, const T* s_dt, T* xs, T* ys, T* s_err,
                             unsigned char* scratch, int rows, int tile, int D,
                             const ErrNorm<T>& en) const {
    rk_step_tile<T, RK_LOOP_RM, KS>(s_t, s_dt, xs, ys, s_err, scratch, layout(tile, D), ring,
                                    rows, tile, D, tab, s, 1, advance_lower, dr, en);
  }
};

// The chain step: the declared form (CoeffForm or ChebForm) sampled at
// the recipe's nodes, then chain_step_tile over the K' working terms of
// the parameters, C chains of R exponentials, CHAIN_RM x 4 outputs a
// thread. Its State is the basis ring (resident or streamed), started
// once and carried from step to step.
template <typename T>
struct ChainLoopStep {
  const T* mt;
  ChainParams<T> p;

  using State = PanelRing<T>;
  __host__ __device__ ChainLayout<T> layout(int tile, int D) const {
    return ChainLayout<T>(tile, D, D, p, false, false);
  }
  __host__ __device__ size_t scratch_bytes(int tile, int D) const {
    return layout(tile, D).total;
  }
  __host__ __device__ int items(int tile, int D) const {
    return (tile / CHAIN_RM) * (gemm_dp(D) / GEMM_CN);
  }
  __device__ State start(unsigned char* scratch, int tile, int D) const {
    State ring(mt, reinterpret_cast<T*>(scratch + layout(tile, D).ring), D, p.KP, 0, D, D);
    ring.prologue();
    return ring;
  }
  __device__ void finish(State& ring) const { ring.drain(); }
  __device__ void operator()(State& ring, const T* s_t, const T* s_dt, T* xs, T* ys, T* s_err,
                             unsigned char* scratch, int rows, int tile, int D,
                             const ErrNorm<T>& en) const {
    const ChainSmem<T> sm(scratch, layout(tile, D));
    sample_form(s_t, s_dt, sm, tile, p);
    __syncthreads();
    chain_step_tile<T, CHAIN_RM, GEMM_CN, false>(s_dt, xs, ys, s_err, sm, ring, rows, tile, D,
                                                 0, D, p, en);
  }
};

// The events and the dense output (ops/fused_loop.py: EventCarry,
// DenseCarry; n_ev = 0 / n_dense = 0: off). Row r's entries of the
// carries are read and written by thread r only.
template <typename T>
struct LoopExtra {
  int n_ev, K, record_y, has_ttol;
  T t_tol;
  const T* rows;   // (E, D) the events' weight rows
  const T* par;    // (E, 4): kind (0 lin, 1 quad), direction, terminal n, offset c
  T* g_prev;       // (B, E) g at the current point
  T* t_ev;         // (B, E, K) located times
  int* count;      // (B, E) crossings counted
  int* found;      // (B, E) 0 / 1
  int* searching;  // (B,) 0 / 1
  T* h_entry;      // (B,) the pre-search step size
  T* y_ev;         // (E, B, D) the first crossing's state, or nullptr
  T* g_new;        // (B, E) scratch: g at the trial point
  T* th_rec;       // (B, E) scratch: theta of a state to record, else -1
  int n_dense;
  const T* dense_t;  // (n,) the dense times
  T* td;             // (B, n) the crossing step's t, inf until crossed
  T* dtd;            // (B, n) its dt
  T* dx;             // (2n, B, D) its entry (2j) and exit (2j + 1) states
};

// g of every event at the trial states ys of the tile's rows into
// ex.g_new, reduced over D in the twin's order (ops/fused_loop.py:
// row_reduce); red: (tile, ceil(D / CT)) of free scratch, each entry one
// thread's sum. Every thread of the block calls it.
template <typename T>
__device__ void event_values(const T* ys, T* red, int rows, int tile, int D, long row0,
                             const LoopExtra<T>& ex) {
  const int ncg = (D + CT - 1) / CT;
  const int tid = threadIdx.x;
  for (int e = 0; e < ex.n_ev; ++e) {
    const T* w = ex.rows + (size_t)e * D;
    const bool quad = ex.par[e * 4] != T(0);
    for (int it = tid; it < tile * ncg; it += blockDim.x) {
      const int lr = it / ncg, cg = it % ncg;
      T part = T(0);
      for (int k = 0; k < CT; ++k) {
        const int col = cg + k * ncg;
        if (col >= D || lr >= rows) continue;
        const T y = ys[(size_t)lr * D + col];
        part = add_rn(part, mul_rn(quad ? mul_rn(y, y) : y, w[col]));
      }
      red[it] = part;
    }
    __syncthreads();
    if (tid < rows) {
      T acc = red[tid * ncg];
      for (int g = 1; g < ncg; ++g) acc = add_rn(acc, red[tid * ncg + g]);
      ex.g_new[(row0 + tid) * ex.n_ev + e] = sub_rn(acc, ex.par[e * 4 + 3]);
    }
    __syncthreads();
  }
}

// Row r's crossing of event e over the trial step (events.event_step):
// whether it crossed in the event's direction, and theta.
template <typename T>
__device__ __forceinline__ bool crossing(const LoopExtra<T>& ex, long r, int e, T* theta) {
  const T gp = ex.g_prev[r * ex.n_ev + e], gn = ex.g_new[r * ex.n_ev + e];
  const bool rising = gp < T(0) && gn >= T(0);
  const bool falling = gp > T(0) && gn <= T(0);
  const T dir = ex.par[e * 4 + 1];
  const T denom = gp - gn;
  *theta = nan_clip(gp / (denom == T(0) ? T(1) : denom), T(0), T(1));
  return dir > T(0) ? rising : (dir < T(0) ? falling : (rising || falling));
}

// Whether dense time j lies in (t, t_new] (dense._dense_step's test).
template <typename T>
__device__ __forceinline__ bool crosses(T tg, T t, T t_new, T four_eps) {
  const T tol = mul_rn(four_eps, nan_max(T(1), fabs(tg)));
  return tg > add_rn(t, tol) && tg <= add_rn(t_new, tol);
}

template <typename T, class Step, bool EXTRA>
__global__ void __launch_bounds__(MAX_THREADS)
fused_loop_kernel(const T* __restrict__ t_grid, int n_grid, const T* __restrict__ fs_in,
                  const int* __restrict__ ist_in, const T* __restrict__ x_in,
                  T* __restrict__ fs_out, int* __restrict__ ist_out, T* __restrict__ x_out,
                  T* __restrict__ saves, int B, int D, int tile, Step step, ErrNorm<T> en,
                  Ctl<T> ctl, int iters, int adaptive, LoopExtra<T> ex) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t n = (size_t)tile * D;
  unsigned char* scratch = smem_raw;                                // the step's scratch
  T* xs = reinterpret_cast<T*>(smem_raw + step.scratch_bytes(tile, D));  // the state x (tile, D)
  T* ys = xs + n;                                       // the trial state y (tile, D)
  T* s_t = ys + n;                                      // per row: t, dt, err measure
  T* s_dt = s_t + tile;
  T* s_err = s_dt + tile;
  T* s_tnew = s_err + tile;  // EXTRA: the row's post-advance time (dense output)
  // bit 0: advance; with EXTRA bit 1: record event states, bit 2: dense
  // endpoints; >> SHIFT: save slot + 1
  constexpr int SHIFT = EXTRA ? 3 : 1;
  int* s_act = reinterpret_cast<int*>(s_tnew + (EXTRA ? tile : 0));

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)(B - row0 < tile ? B - row0 : tile);
  const bool own = tid < rows;  // thread tid runs row tid's controller

  for (size_t e = tid; e < n; e += blockDim.x)
    xs[e] = e < (size_t)rows * D ? x_in[row0 * D + e] : T(0);
  T t = T(0), h = T(0), prev_h = T(0), err_prev = T(0), t_lo = T(0);
  int tgt = 0, status = DONE, event = EVT_NONE, n_acc = 0, n_rej = 0, n_it = 0, streak = 0;
  if (own) {
    const T* f = fs_in + (row0 + tid) * N_F;
    t = f[0], h = f[1], prev_h = f[2], err_prev = f[3], t_lo = f[4];
    const int* q = ist_in + (row0 + tid) * N_I;
    tgt = q[0], status = q[1], event = q[2], n_acc = q[3], n_rej = q[4], n_it = q[5];
    streak = q[6];
  }
  const long r = row0 + tid;
  int searching = 0;
  T h_entry = T(0);
  if (EXTRA && own && ex.n_ev > 0) searching = ex.searching[r], h_entry = ex.h_entry[r];
  const T eps = eps_of<T>();
  const T four_eps = T(4) * eps;  // exact: a power of two
  auto state = step.start(scratch, tile, D);

  for (int it = 0;; ++it) {
    // also the barrier between one iteration's updates and the next's reads
    const bool any_running = __syncthreads_or(own && status == RUNNING);
    if (!any_running || (iters > 0 && it >= iters)) break;

    // consult the save grid (pallas_loop.py:291-312)
    const bool running = own && status == RUNNING;
    bool at_grid = false, is_end = false, is_chk = false, bad = false, stepping = false;
    T dt = T(0);
    if (own) {
      const T chk_t = t_grid[tgt < n_grid - 1 ? tgt : n_grid - 1];
      const T tol = ctl.strict ? eps : mul_rn(four_eps, nan_max(T(1), fabs(chk_t)));
      const T rem = sub_rn(sub_rn(chk_t, t), t_lo);
      at_grid = fabs(rem) <= tol;
      const bool past_end = tgt >= n_grid - 1;
      is_end = running && at_grid && past_end;
      is_chk = running && at_grid && !past_end;
      bad = running && !at_grid && rem < T(0);
      stepping = running && !at_grid && !bad;
      dt = stepping ? nan_min(h, rem) : T(0);
    }
    if (tid < tile) {
      s_t[tid] = t;
      s_dt[tid] = dt;
    }
    __syncthreads();

    step(state, s_t, s_dt, xs, ys, s_err, scratch, rows, tile, D, en);
    __syncthreads();
    if (EXTRA && ex.n_ev > 0)
      event_values(ys, reinterpret_cast<T*>(scratch), rows, tile, D, row0, ex);

    // controller and bookkeeping, one thread per row (pallas_loop.py:316-539)
    int act = 0;
    if (own) {
      const T err = s_err[tid];
      T new_h = h;
      bool accept = true;  // fixed steps: every stepping row accepts
      if (adaptive) {
        const T f = ctl.rtol / err;
        T fp;
        if (ctl.pi) {
          T f_prev = ctl.rtol / err_prev;
          if (!(isfinite(f_prev) && f_prev > T(0))) f_prev = f;
          T ratio = nan_clip(f / f_prev, T(1e-8), T(1e8));
          if (is_nan(ratio)) ratio = T(1);
          const T fp_pi =
              mul_rn(mul_rn(ctl.alpha, pow_full(f, ctl.k_i)), pow_full(ratio, ctl.k_p));
          const T fp_rej = mul_rn(ctl.alpha, pow_full(f, ctl.inv_pi_order));
          fp = streak > 0 ? fp_rej : fp_pi;
        } else {
          fp = mul_rn(ctl.alpha, pow_full(f, ctl.inv_order));
        }
        fp = nan_clip(fp, ctl.min_f, ctl.max_f);
        const bool bad_f = is_nan(f);
        if (bad_f) fp = ctl.min_f;
        new_h = nan_clip(mul_rn(fp, h), ctl.min_dt, ctl.max_dt);
        accept = !bad_f && f > T(1);
      }

      // events (pallas_loop.py:354-449)
      bool search = false, restore = false, term_hit = false, rec_y = false;
      T h_ovr = T(0);
      if (EXTRA && ex.n_ev > 0) {
        bool any_active = false;
        T theta_min = T(1);
        for (int e = 0; e < ex.n_ev; ++e) {
          T th;
          const bool act_e = crossing(ex, r, e, &th) && stepping && accept &&
                             ex.count[r * ex.n_ev + e] < ex.K;
          theta_min = nan_min(theta_min, act_e ? th : T(1));
          any_active = any_active || act_e;
        }
        const T tol_ev = ex.has_ttol ? ex.t_tol
                                     : mul_rn(T(64) * eps, nan_max(T(1), fabs(t)));
        const bool tight = dt <= tol_ev;
        const bool locate = any_active && tight;
        search = any_active && !tight;
        h_ovr = nan_max(mul_rn(nan_clip(theta_min, T(0.1), T(0.9)), dt), mul_rn(T(0.25), tol_ev));
        if (search && !searching) h_entry = dt;
        restore = locate && searching;
        searching = (searching || search) && !locate;
        const bool adv_ev = stepping && accept && !search;
        for (int e = 0; e < ex.n_ev; ++e) {
          T th;
          const long i = r * ex.n_ev + e;
          const int cnt = ex.count[i];
          const bool crossed = crossing(ex, r, e, &th);
          const bool rec = crossed && stepping && accept && cnt < ex.K && locate;
          if (rec) {
            ex.t_ev[i * ex.K + cnt] = add_rn(t, mul_rn(th, dt));
            ex.found[i] = 1;
            const int term_n = (int)ex.par[e * 4 + 2];
            if (term_n > 0 && cnt + 1 >= term_n) term_hit = true;
          }
          if (ex.record_y && locate) {  // the FIRST crossing's state only
            const bool ry = rec && cnt == 0;
            ex.th_rec[i] = ry ? th : T(-1);
            rec_y = rec_y || ry;
          }
          if (adv_ev) ex.g_prev[i] = ex.g_new[i];
          if (crossed && adv_ev) ex.count[i] = cnt + 1;
        }
        accept = accept && !search;
      }

      const bool adv = stepping && accept;
      const bool rej = stepping && !accept;
      const bool true_rej = rej && !search;  // search iterations are not rejects
      const bool hit = at_grid && running;

      // dense output (pallas_loop.py:455-474), against the pre-advance t
      bool dense_rec = false;
      if (EXTRA && ex.n_dense > 0 && adv) {
        T t_new;
        if (ctl.comp) {  // the compensated hi word
          const T s_ = add_rn(t, dt);
          const T bp = sub_rn(s_, t);
          const T e_lo = add_rn(sub_rn(t, sub_rn(s_, bp)), sub_rn(dt, bp));
          t_new = add_rn(s_, add_rn(t_lo, e_lo));
        } else {
          t_new = add_rn(t, dt);
        }
        for (int j = 0; j < ex.n_dense; ++j) {
          if (!crosses(ex.dense_t[j], t, t_new, four_eps)) continue;
          ex.td[r * ex.n_dense + j] = t;
          ex.dtd[r * ex.n_dense + j] = dt;
          dense_rec = true;
        }
        s_tnew[tid] = t_new;
      }

      // the interior save slot of a grid hit: the state before the advance
      const int slot = (hit && tgt >= 1 && tgt <= n_grid - 2) ? tgt - 1 : -1;
      if (adv) {
        if (ctl.comp) {  // driver.comp_time_advance
          const T s_ = add_rn(t, dt);
          const T bp = sub_rn(s_, t);
          const T e_lo = add_rn(sub_rn(t, sub_rn(s_, bp)), sub_rn(dt, bp));
          T lo = add_rn(t_lo, e_lo);
          const T hi = add_rn(s_, lo);
          lo = sub_rn(lo, sub_rn(hi, s_));
          t = hi;
          t_lo = lo;
        } else {
          t = add_rn(t, dt);
        }
      }
      if (stepping && adaptive) {
        prev_h = h;
        h = new_h;
      }
      if (hit) {
        h = prev_h;
        tgt += 1;
      }
      if (EXTRA) {  // the search's h, then the locate's restore
        if (search) h = h_ovr;
        if (restore) h = h_entry, prev_h = h_entry;
      }
      if (is_end) status = DONE;
      if (bad) status = ERR_BAD_GRID;
      n_it += running ? 1 : 0;
      if (status == RUNNING && n_it >= ctl.max_steps) status = ERR_MAX_STEPS;
      if (EXTRA && term_hit) status = DONE_EVENT;
      streak = true_rej ? streak + 1 : (adv ? 0 : streak);
      if (ctl.max_streak > 0 && status == RUNNING && streak >= ctl.max_streak)
        status = ERR_STALLED;
      event = is_end ? EVT_END : is_chk ? EVT_CHKPT : rej ? EVT_REJECT : adv ? EVT_STEP : EVT_NONE;
      if (stepping && adaptive) err_prev = err;
      n_acc += adv ? 1 : 0;
      n_rej += true_rej ? 1 : 0;
      act = (adv ? 1 : 0) | (rec_y ? 2 : 0) | (dense_rec ? 4 : 0) | ((slot + 1) << SHIFT);
    }
    if (tid < tile) s_act[tid] = act;
    __syncthreads();

    // the save, the event states and dense endpoints, then the advance,
    // element by element
    for (size_t e = tid; e < (size_t)rows * D; e += blockDim.x) {
      const int row = (int)(e / D);
      const int a = s_act[row];
      if (a >> SHIFT) saves[((size_t)((a >> SHIFT) - 1) * B + row0) * D + e] = xs[e];
      if (EXTRA && (a & 2)) {
        for (int ev = 0; ev < ex.n_ev; ++ev) {
          const T th = ex.th_rec[(row0 + row) * ex.n_ev + ev];
          if (th != T(-1))
            ex.y_ev[((size_t)ev * B + row0) * D + e] = add_rn(xs[e], mul_rn(th, sub_rn(ys[e], xs[e])));
        }
      }
      if (EXTRA && (a & 4)) {
        for (int j = 0; j < ex.n_dense; ++j) {
          if (!crosses(ex.dense_t[j], s_t[row], s_tnew[row], four_eps)) continue;
          ex.dx[((size_t)(2 * j) * B + row0) * D + e] = xs[e];
          ex.dx[((size_t)(2 * j + 1) * B + row0) * D + e] = ys[e];
        }
      }
      if (a & 1) xs[e] = ys[e];
    }
  }

  step.finish(state);
  if (own) {
    T* f = fs_out + (row0 + tid) * N_F;
    f[0] = t, f[1] = h, f[2] = prev_h, f[3] = err_prev, f[4] = t_lo;
    int* q = ist_out + (row0 + tid) * N_I;
    q[0] = tgt, q[1] = status, q[2] = event, q[3] = n_acc, q[4] = n_rej, q[5] = n_it;
    q[6] = streak, q[7] = 0;
    if (EXTRA && ex.n_ev > 0) ex.searching[r] = searching, ex.h_entry[r] = h_entry;
  }
  for (size_t e = tid; e < (size_t)rows * D; e += blockDim.x) x_out[row0 * D + e] = xs[e];
}

// The controller as the kernel reads it. c: rtol, atol, alpha, 1/order,
// min_factor, max_factor, min_dt, max_dt, 0.7/pi_order, 0.4/pi_order,
// 1/pi_order, max_steps, max_reject_streak, pi, time_compensated,
// strict_end_test, scaled_error
template <typename T>
Ctl<T> parse_ctl(const double* c) {
  return Ctl<T>{(T)c[0],    (T)c[2],    (T)c[3],    (T)c[4],    (T)c[5],
                (T)c[6],    (T)c[7],    (T)c[8],    (T)c[9],    (T)c[10],
                (int)c[11], (int)c[12], (int)c[13], (int)c[14], (int)c[15]};
}

template <typename T>
ErrNorm<T> parse_norm(const void* w_row, double post, int kind_max, const double* c) {
  return ErrNorm<T>{(const T*)w_row, (T)post, kind_max, (int)c[16], (T)c[1], (T)c[0]};
}

// The events and dense output. ptr: 15 device pointers (rows, par, g_prev,
// t_ev, count, found, searching, h_entry, y_ev, g_new, th_rec, dense_t,
// td, dtd, dx); par: n_ev, K, record_y, has_ttol, t_tol, n_dense; both in
// host memory, both null when neither is on. Returns false for arguments
// the kernel does not take.
template <typename T>
bool parse_extra(const void* const* ptr, const double* par, int n_grid, LoopExtra<T>* ex) {
  *ex = LoopExtra<T>{};
  if (par == nullptr) return true;
  if (ptr == nullptr) return false;
  ex->n_ev = (int)par[0], ex->K = (int)par[1], ex->record_y = (int)par[2];
  ex->has_ttol = (int)par[3], ex->t_tol = (T)par[4], ex->n_dense = (int)par[5];
  ex->rows = (const T*)ptr[0], ex->par = (const T*)ptr[1];
  ex->g_prev = (T*)ptr[2], ex->t_ev = (T*)ptr[3], ex->count = (int*)ptr[4];
  ex->found = (int*)ptr[5], ex->searching = (int*)ptr[6], ex->h_entry = (T*)ptr[7];
  ex->y_ev = (T*)ptr[8], ex->g_new = (T*)ptr[9], ex->th_rec = (T*)ptr[10];
  ex->dense_t = (const T*)ptr[11], ex->td = (T*)ptr[12], ex->dtd = (T*)ptr[13];
  ex->dx = (T*)ptr[14];
  if (ex->n_ev < 0 || ex->n_dense < 0) return false;
  if (ex->n_ev > 0) {
    if (ex->K < 1) return false;
    for (int i = 0; i < 11; ++i)
      if (ptr[i] == nullptr && !(i == 8 && !ex->record_y)) return false;
  }
  if (ex->n_dense > 0) {
    if (n_grid != 2) return false;  // free-running: the grid is [t0, tf]
    for (int i = 11; i < 15; ++i)
      if (ptr[i] == nullptr) return false;
  }
  return true;
}

// The shared memory of a block of `tile` rows.
template <typename T, class Step>
size_t loop_smem(const Step& step, int tile, int D, bool extra) {
  return step.scratch_bytes(tile, D) +
         (2 * (size_t)tile * D + (extra ? 4 : 3) * (size_t)tile) * sizeof(T) + tile * sizeof(int);
}

// Launches the loop kernel with `step` over tiles of `tile` rows.
template <typename T, class Step, bool EXTRA>
int run(const Step& step, int tile, const void* t_grid, int n_grid, const void* fs_in,
        const void* ist_in, const void* x_in, void* fs_out, void* ist_out, void* x_out,
        void* saves, int B, int D, const ErrNorm<T>& en, const Ctl<T>& ctl, int iters,
        int adaptive, const LoopExtra<T>& ex, int dev, int max_smem, void* stream) {
  static size_t smem_allowed[MAX_DEVICES];
  const int items = step.items(tile, D);
  const size_t smem = loop_smem<T>(step, tile, D, EXTRA);
  if (items > MAX_THREADS || smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const int threads = ((items > tile ? items : tile) + 31) / 32 * 32;
  if (smem > smem_allowed[dev]) {
    cudaError_t st = cudaFuncSetAttribute(fused_loop_kernel<T, Step, EXTRA>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
    smem_allowed[dev] = smem;
  }
  const int blocks = (B + tile - 1) / tile;
  fused_loop_kernel<T, Step, EXTRA><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)t_grid, n_grid, (const T*)fs_in, (const int*)ist_in, (const T*)x_in, (T*)fs_out,
      (int*)ist_out, (T*)x_out, (T*)saves, B, D, tile, step, en, ctl, iters, adaptive, ex);
  return (int)cudaGetLastError();
}

// run with EXTRA where the events or the dense output are on.
template <typename T, class Step>
int run_any(const Step& step, int tile, const void* t_grid, int n_grid, const void* fs_in,
            const void* ist_in, const void* x_in, void* fs_out, void* ist_out, void* x_out,
            void* saves, int B, int D, const ErrNorm<T>& en, const Ctl<T>& ctl, int iters,
            int adaptive, const LoopExtra<T>& ex, int dev, int max_smem, void* stream) {
  if (ex.n_ev > 0 || ex.n_dense > 0)
    return run<T, Step, true>(step, tile, t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out,
                              x_out, saves, B, D, en, ctl, iters, adaptive, ex, dev, max_smem,
                              stream);
  return run<T, Step, false>(step, tile, t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out,
                             x_out, saves, B, D, en, ctl, iters, adaptive, ex, dev, max_smem,
                             stream);
}

// The RK step's plan in the loop kernel: rows a thread, stages in
// registers (0: in shared memory), rows a block, threads, shared memory a
// block with the events / dense switch `extra`, the operator resident.
struct RKLoopPlan {
  int rm, ks, tile, threads;
  size_t smem;
  int resident;
};

template <typename T, int KS>
RKLoopPlan rk_loop_plan(const RKLoopStep<T, KS>& step, int B, int D, int n_sm, int max_smem,
                        bool extra) {
  RKLoopStep<T, KS> res = step, str = step;
  res.resident = 1, str.resident = 0;
  const int tile = chain_tile<T>(B, D, n_sm, RK_LOOP_RM, MAX_THREADS, (size_t)max_smem,
                                 [&](int tl) { return loop_smem<T>(str, tl, D, true); });
  const bool r = loop_smem<T>(res, tile, D, true) <= (size_t)max_smem;
  const int items = step.items(tile, D);
  return RKLoopPlan{RK_LOOP_RM, KS, tile, ((items > tile ? items : tile) + 31) / 32 * 32,
                    loop_smem<T>(r ? res : str, tile, D, extra), r};
}

// The RK step of the loop kernel in the state's type.
template <typename T>
using RKStepOf = RKLoopStep<T, sizeof(T) == 4 ? MAX_STAGES : 0>;

template <typename T>
int launch(const void* t_grid, int n_grid, const void* fs_in, const void* ist_in,
           const void* x_in, void* fs_out, void* ist_out, void* x_out, void* saves, int B, int D,
           const void* mt, const double* tab_in, int s, int advance_lower, const double* drive,
           const void* cheb, const void* w_row, double post, int kind_max, const double* c, int iters,
           int adaptive, const void* const* ex_ptr, const double* ex_par, void* stream) {
  LoopExtra<T> ex;
  if (B <= 0 || D <= 0 || D > MAX_WIDTH || s <= 0 || s > MAX_STAGES || n_grid < 2 || iters < 0 ||
      !parse_extra<T>(ex_ptr, ex_par, n_grid, &ex))
    return (int)cudaErrorInvalidValue;
  RKStepOf<T> step;
  step.mt = (const T*)mt;
  step.tab = parse_tableau<T>(tab_in);
  step.s = s, step.advance_lower = advance_lower;
  step.dr = parse_drive<T>(drive, cheb);
  if (!drive_ok(step.dr)) return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  const RKLoopPlan pl = rk_loop_plan(step, B, D, n_sm, max_smem, true);
  step.resident = pl.resident;
  return run_any<T>(step, pl.tile, t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out, x_out,
                    saves, B, D, parse_norm<T>(w_row, post, kind_max, c), parse_ctl<T>(c), iters,
                    adaptive, ex, dev, max_smem, stream);
}

template <typename T>
int launch_chain(const void* t_grid, int n_grid, const void* fs_in, const void* ist_in,
                 const void* x_in, void* fs_out, void* ist_out, void* x_out, void* saves, int B,
                 int D, const void* mt, const double* chain, const void* cheb,
                 const void* w_row, double post, int kind_max, const double* c, int iters,
                 int adaptive, const void* const* ex_ptr, const double* ex_par, void* stream) {
  LoopExtra<T> ex;
  if (B <= 0 || D <= 0 || D > MAX_WIDTH || n_grid < 2 || iters < 0 ||
      !parse_extra<T>(ex_ptr, ex_par, n_grid, &ex))
    return (int)cudaErrorInvalidValue;
  ChainParams<T> p = parse_chain_params<T>(chain);
  p.cheb = (const T*)cheb;
  if (!chain_params_ok(p) || (p.form_kind == FORM_CHEB && cheb == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  const ChainLoopStep<T> step{(const T*)mt, p};
  const int tile = chain_tile<T>(B, D, n_sm, CHAIN_RM, MAX_THREADS, (size_t)max_smem,
                                 [&](int tl) { return loop_smem<T>(step, tl, D, true); });
  return run_any<T>(step, tile, t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out, x_out,
                    saves, B, D, parse_norm<T>(w_row, post, kind_max, c), parse_ctl<T>(c), iters,
                    adaptive, ex, dev, max_smem, stream);
}

}  // namespace

extern "C" {

// Advances every row of the carries (fs (B, 5), ist (B, 8) int32, x (B, D))
// by `iters` driver iterations, or until it leaves RUNNING when iters == 0,
// writing fs_out, ist_out and x_out; saves ((n_grid - 2), B, D) is updated
// in place. The RK step: tab, drive and cheb as for the per-step kernel;
// w_row, post, kind_max declare the error norm; ctl: the 17 float64 values of
// parse_ctl, in host memory; adaptive = 0 takes fixed steps; ex_ptr and
// ex_par: the events and dense output of parse_extra (null: off), whose
// carries are updated in place.
int vec_ode_fused_loop_f32(const void* t_grid, int n_grid, const void* fs_in, const void* ist_in,
                           const void* x_in, void* fs_out, void* ist_out, void* x_out,
                           void* saves, int B, int D, const void* mt, const double* tab, int s,
                           int advance_lower, const double* drive, const void* cheb,
                           const void* w_row, double post, int kind_max, const double* ctl,
                           int iters, int adaptive, const void* const* ex_ptr,
                           const double* ex_par, void* stream) {
  return launch<float>(t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out, x_out, saves, B, D,
                       mt, tab, s, advance_lower, drive, cheb, w_row, post, kind_max, ctl, iters,
                       adaptive, ex_ptr, ex_par, stream);
}

int vec_ode_fused_loop_f64(const void* t_grid, int n_grid, const void* fs_in, const void* ist_in,
                           const void* x_in, void* fs_out, void* ist_out, void* x_out,
                           void* saves, int B, int D, const void* mt, const double* tab, int s,
                           int advance_lower, const double* drive, const void* cheb,
                           const void* w_row, double post, int kind_max, const double* ctl,
                           int iters, int adaptive, const void* const* ex_ptr,
                           const double* ex_par, void* stream) {
  return launch<double>(t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out, x_out, saves, B, D,
                        mt, tab, s, advance_lower, drive, cheb, w_row, post, kind_max, ctl, iters,
                        adaptive, ex_ptr, ex_par, stream);
}

// The same loop with the chain step: mt = [M_0^T | ... ] (D, KP*D), chain:
// the float64 parameters of ops/expmv.py:chain_params with the declared
// form; cheb: a ChebForm's (K0, n) series in the state's type in device
// memory (null for a CoeffForm).
int vec_ode_fused_loop_chain_f32(const void* t_grid, int n_grid, const void* fs_in,
                                 const void* ist_in, const void* x_in, void* fs_out,
                                 void* ist_out, void* x_out, void* saves, int B, int D,
                                 const void* mt, const double* chain, const void* cheb,
                                 const void* w_row, double post, int kind_max, const double* ctl,
                                 int iters, int adaptive, const void* const* ex_ptr,
                                 const double* ex_par, void* stream) {
  return launch_chain<float>(t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out, x_out, saves,
                             B, D, mt, chain, cheb, w_row, post, kind_max, ctl, iters, adaptive,
                             ex_ptr, ex_par, stream);
}

int vec_ode_fused_loop_chain_f64(const void* t_grid, int n_grid, const void* fs_in,
                                 const void* ist_in, const void* x_in, void* fs_out,
                                 void* ist_out, void* x_out, void* saves, int B, int D,
                                 const void* mt, const double* chain, const void* cheb,
                                 const void* w_row, double post, int kind_max, const double* ctl,
                                 int iters, int adaptive, const void* const* ex_ptr,
                                 const double* ex_par, void* stream) {
  return launch_chain<double>(t_grid, n_grid, fs_in, ist_in, x_in, fs_out, ist_out, x_out, saves,
                              B, D, mt, chain, cheb, w_row, post, kind_max, ctl, iters, adaptive,
                              ex_ptr, ex_par, stream);
}

// The RK step's plan in the loop kernel on the current card for B rows of
// width D and s stages in elements of elem_bytes, with the events / dense
// switch `extra`: out[0..5] = rows a thread, stages in registers, rows a
// block, threads, shared memory a block, resident (ops/fused_loop.py:
// RK_LOOP_PLAN_KEYS). 0, or the CUDA error.
int vec_ode_fused_loop_rk_plan(int B, int D, int s, int elem_bytes, int extra, long long* out) {
  if (B <= 0 || D <= 0 || D > MAX_WIDTH || s <= 0 || s > MAX_STAGES ||
      (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, n_sm = 0;
  const cudaError_t st = device_limits(&dev, &max_smem, &n_sm);
  if (st != cudaSuccess) return (int)st;
  RKLoopPlan pl;
  if (elem_bytes == 4) {
    RKStepOf<float> step{};
    step.s = s;
    pl = rk_loop_plan(step, B, D, n_sm, max_smem, extra != 0);
  } else {
    RKStepOf<double> step{};
    step.s = s;
    pl = rk_loop_plan(step, B, D, n_sm, max_smem, extra != 0);
  }
  const long long v[6] = {pl.rm, pl.ks, pl.tile, pl.threads, (long long)pl.smem, pl.resident};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
