// Kernel A: the restarted PDHG solve of the relaxed EG market, one launch
// a solve, one thread block a problem.
//
// Replaces the JAX package's jitted single-device loop
// shockwave_tpu/solver/eg_pdhg.py::_pdhg_core (:121-500, axis_name None):
// prox_primal (:184), _dual_threshold / proj_dual (:208-240),
// project_budget (:241), objective (:261), the restart-to-average cycle
// with primal-weight rebalancing, best-iterate tracking and the stall stop
// (:376-470), welfare_fill (:287) and the summed-delta acceptance
// (:471-500). Its plain PyTorch version, op for op, is
// shockwave_tpu_torch/solver/eg_pdhg.py::_pdhg_core; the wrapper is
// ../eg_pdhg.py::pdhg.
//
// Contract:
//   packed   [P][10][slots] f32: active, priorities, completed, total,
//            epoch_dur, remaining, nworkers, switch_bonus, s0, then the
//            scalars num_gpus, round_duration, future_rounds, regularizer,
//            tol, stall_rel in the first entries of row 9;
//   scratch  [P][ROWS][slots] f32, per-job state of the solve (global
//            instantiations only; resident ones keep it in shared memory);
//   out      [P][slots + 8] f32: best s, then best objective, cycles,
//            iterations, restarts, residual, residual0, converged,
//            welfare_filled;
//   stats    [P][4] int64: block barriers passed, dual projections
//            bisected, budget projections bisected, welfare fills bisected.
// Block b reads lane b of packed, uses lane b's scratch and writes lane
// b's rows of out and stats, and no block reads gridDim: a lane of a grid
// of P problems (the cells market's and the what-if fleet's) returns the
// bits of its own one-problem launch.
//
// What bounds it: neither bytes nor operations. A step is ~400 flops a job
// over ~70 bytes of per-job state, but it carries 1 to 31 dependent global
// reductions (the budget dual, and the dual projection's bisection when the
// makespan cap binds), a cycle 40 steps plus two movement steps, a 60-step
// budget projection and the objective, and the welfare fill 80 more. Each
// reduction is one block barrier (eg_common.cuh), so the solve is a chain
// of barriers. What the design does about it:
//  - the whole solve is one launch; every control decision (lax.cond in
//    proj_dual, restart-to-average, the while-loop test, the stall counter,
//    fill_wins) is block-uniform after its reduction; fused reductions
//    share one barrier;
//  - each bisection walks L levels a barrier (eg::bisect): 60 / 30 / 80
//    steps take ceil(60 / L) / ceil(30 / L) / ceil(80 / L) barriers, and a
//    projection or fill whose answer does not need its bisection skips it;
//  - up to 2048 slots the 24 per-job rows (96 B a job) live in shared
//    memory, so a pass between two barriers reads no L2;
//  - warps that own no slot return at the start (eg_common.cuh), so a
//    small problem's reductions cost its own warps only; there the tree
//    pays (ops/eg_pdhg.py::LEVELS: 2 levels up to 512 slots).
// Barriers: 7 + 47 c + ceil(60/L) b + ceil(30/L) d + ceil(80/L) f, for c
// cycles, b budget projections, d dual projections and f fills bisected
// (b = c + 1 and f = 1 in the sequential structure, where L = 1).
//
// Float32 throughout, as the JAX package. Built with -fmad=false
// (ops/_build.py): every product rounds before its sum, as each eager
// PyTorch op of the plain version does, so the kernel and its plain
// version on the card differ only in the order of their sums. Every
// instantiation takes the sums in the same order, so all of them return
// the same bits.

#include "eg_common.cuh"

namespace {

using eg::EPS;
using eg::THREADS;
using eg::clip;

enum Row {
  // per-job constants
  S_MAX, Q, A_, BETA, XCAP, BONUS, REM_SH, W, WHAT, NQB, ACTIVE, REMAINING,
  // per-job state
  S, Y, SC, YC, SS, SY, S2, Y2, SF, BEST_S, NMIN, HI,
  ROWS
};

constexpr int PROX_BISECT = 30;
constexpr int DUAL_BISECT = 30;
constexpr int FILL_BISECT = 80;
constexpr int STALL_CYCLES = 3;
constexpr int DIAG = 8;
constexpr int STATS = 4;

struct Problem {
  float* st;  // row r of slot j at st[r * slots + j]
  int slots;
  float dur, k, budget, cap, bhat, C, wmin, max_s_max;
  __device__ __forceinline__ float* row(int r) const { return st + r * slots; }
};

// Bisections run, for the stats row.
struct Counts {
  long long duals, projections, fills;
};

// One PDHG step from (s_in, y_in, lam) into (s_out, y_out); the outputs
// may alias the inputs (each thread owns its slots). With `accumulate`,
// the new iterate is added to the running sums SS and SY. Returns lam_new.
template <class K>
__device__ float pdhg_step(const Problem& p, const float* s_in, const float* y_in, float* s_out,
                           float* y_out, float lam, float tau, float sigma, bool accumulate,
                           eg::Reducer& red, Counts& n) {
  const int t = threadIdx.x;
  const float *what_r = p.row(WHAT), *xcap_r = p.row(XCAP), *nqb_r = p.row(NQB),
              *a_r = p.row(A_), *beta_r = p.row(BETA), *bonus_r = p.row(BONUS),
              *s_max_r = p.row(S_MAX), *rem_r = p.row(REM_SH), *active = p.row(ACTIVE);
  float v[3] = {0.0f, 0.0f, -INFINITY};  // sum yv, sum what * sbar, max yv
  for (int j = t; j < p.slots; j += THREADS) {
    const float s = s_in[j], what = what_r[j];
    const float x0 = s + tau * (y_in[j] - lam * what);
    // prox_primal: bisection on the sign of the 1-D subproblem's derivative.
    const float xcap = xcap_r[j], nqb = nqb_r[j], ae = a_r[j] + EPS, beta = beta_r[j],
                bonus = bonus_r[j];
    float lo = 0.0f, hi = s_max_r[j];
    for (int it = 0; it < PROX_BISECT; ++it) {
      const float mid = 0.5f * (lo + hi);
      float slope = mid < xcap ? nqb / (ae + beta * mid) : 0.0f;
      slope = slope - (mid < 1.0f ? bonus : 0.0f);
      const bool neg = (mid - x0) + tau * slope < 0.0f;
      lo = neg ? mid : lo;
      hi = neg ? hi : mid;
    }
    const float s_new = 0.5f * (lo + hi);
    const float sbar = 2.0f * s_new - s;
    const float yv = fmaxf(y_in[j] + sigma * (rem_r[j] - sbar), 0.0f) * active[j];
    s_out[j] = s_new;
    y_out[j] = yv;
    v[0] += yv;
    v[1] += what * sbar;
    v[2] = fmaxf(v[2], yv);
  }
  red.template reduce<2, 1>(v);
  if (v[0] > p.cap) {
    // proj_dual: the smallest threshold whose clipped load fits the cap.
    float lo = 0.0f, hi = v[2];
    eg::bisect<K::LEVELS, eg::Halve>(lo, hi, DUAL_BISECT, p.cap, p.slots, red, [&](int j) {
      const float y = y_out[j];
      return [=](float mid) { return fmaxf(y - mid, 0.0f); };
    });
    const float theta = 0.5f * (lo + hi);
    for (int j = t; j < p.slots; j += THREADS) y_out[j] = fmaxf(y_out[j] - theta, 0.0f);
    ++n.duals;
  }
  if (accumulate) {
    float *ss = p.row(SS), *sy = p.row(SY);
    for (int j = t; j < p.slots; j += THREADS) {
      ss[j] += s_out[j];
      sy[j] += y_out[j];
    }
  }
  return fmaxf(lam + sigma * (v[1] - p.bhat), 0.0f);
}

// Fixed-point residual of one step from (s, y, lam): (res, dp, dd).
template <class K>
__device__ void movement(const Problem& p, const float* s, const float* y, float lam, float tau,
                         float sigma, float (&out)[3], eg::Reducer& red, Counts& n) {
  float *s2 = p.row(S2), *y2 = p.row(Y2);
  const float l2 = pdhg_step<K>(p, s, y, s2, y2, lam, tau, sigma, false, red, n);
  float v[2] = {0.0f, 0.0f};
  for (int j = threadIdx.x; j < p.slots; j += THREADS) {
    const float ds = s2[j] - s[j], dy = y2[j] - y[j];
    v[0] += ds * ds;
    v[1] += dy * dy;
  }
  red.template reduce<2, 0>(v);
  const float dl = l2 - lam;
  const float dp = sqrtf(v[0]), dd = sqrtf(v[1] + dl * dl);
  out[0] = sqrtf(dp * dp + dd * dd);
  out[1] = dp;
  out[2] = dd;
}

// The exact relaxed objective at s (maximization form).
__device__ float objective(const Problem& p, const float* s, eg::Reducer& red) {
  const float *a_r = p.row(A_), *beta_r = p.row(BETA), *xcap_r = p.row(XCAP), *q_r = p.row(Q),
              *bonus_r = p.row(BONUS), *rem = p.row(REMAINING);
  float v[3] = {0.0f, 0.0f, -INFINITY};
  for (int j = threadIdx.x; j < p.slots; j += THREADS) {
    const float x = s[j];
    const float progress = a_r[j] + beta_r[j] * fminf(x, xcap_r[j]);
    v[0] += q_r[j] * logf(progress + EPS);
    v[1] += bonus_r[j] * fminf(x, 1.0f);
    v[2] = fmaxf(v[2], rem[j] - p.dur * x);
  }
  red.template reduce<2, 1>(v);
  return (v[0] + v[1]) - p.k * fmaxf(p.C, v[2]);
}

// One job of welfare_fill: its allocation at budget dual lam.
struct FillJob {
  float w, w_safe, gain, A, bonus, beta_safe, xcap, n_min, hi;

  __device__ __forceinline__ float s(float lam) const {
    const float lw = lam * w_safe;
    const float raw_w = (gain / lw - A - EPS) / beta_safe;
    const float raw_b = (gain / fmaxf(lw - bonus, 1e-30f) - A - EPS) / beta_safe;
    const float s_lam =
        raw_w >= 1.0f ? raw_w
                      : (lw <= bonus ? 1.0f : fminf(clip(raw_b, 0.0f, 1.0f), fmaxf(xcap, 0.0f)));
    return clip(s_lam, n_min, hi);
  }
};

__device__ __forceinline__ FillJob fill_job(const Problem& p, int j) {
  FillJob f;
  f.w = p.row(W)[j];
  f.w_safe = f.w > 0.0f ? f.w : 1.0f;
  f.gain = p.row(Q)[j] * p.row(BETA)[j];
  f.A = p.row(A_)[j];
  f.bonus = p.row(BONUS)[j];
  f.beta_safe = fmaxf(p.row(BETA)[j], 1e-20f);
  f.xcap = p.row(XCAP)[j];
  f.n_min = p.row(NMIN)[j];
  f.hi = p.row(HI)[j];
  return f;
}

// Closed-form KKT water-fill of the residual budget from s into SF.
template <class K>
__device__ void welfare_fill(const Problem& p, const float* s, eg::Reducer& red, Counts& n) {
  const int t = threadIdx.x;
  const float* rem = p.row(REMAINING);
  float m = -INFINITY;
  for (int j = t; j < p.slots; j += THREADS) m = fmaxf(m, rem[j] - p.dur * s[j]);
  const float M = fmaxf(p.C, red.max(m));
  float v[3] = {0.0f, -INFINITY, -INFINITY};  // sum w * hi, max dens_min, max bonus / w_safe
  for (int j = t; j < p.slots; j += THREADS) {
    const float s_max = p.row(S_MAX)[j], xcap = p.row(XCAP)[j], bonus = p.row(BONUS)[j],
                w = p.row(W)[j];
    const float n_min = clip(ceilf((rem[j] - M) / p.dur - 1e-4f), 0.0f, s_max);
    float hi = fmaxf(fminf(xcap, s_max), n_min);
    hi = fmaxf(hi, bonus > 0.0f ? fminf(1.0f, s_max) : 0.0f);
    p.row(NMIN)[j] = n_min;
    p.row(HI)[j] = hi;
    const float w_safe = w > 0.0f ? w : 1.0f;
    const float gain = p.row(Q)[j] * p.row(BETA)[j];
    v[0] += w * hi;
    v[1] = fmaxf(v[1], gain / (((p.row(A_)[j] + EPS) + p.row(BETA)[j] * n_min) * w_safe));
    v[2] = fmaxf(v[2], bonus / w_safe);
  }
  red.template reduce<1, 2>(v);
  float lo = 1e-30f, hi = 2.0f * fmaxf(fmaxf(v[1], v[2]), 1e-30f);
  const bool all_hi = v[0] <= p.budget;
  // Where every job fits at its upper bound the fill is that bound, and
  // the bisection's answer goes unread.
  if (K::SEQUENTIAL || !all_hi) {
    eg::bisect<K::LEVELS, eg::Geometric>(lo, hi, FILL_BISECT, p.budget, p.slots, red,
                                         [&](int j) {
                                           const FillJob f = fill_job(p, j);
                                           return [=](float mid) { return f.w * f.s(mid); };
                                         });
    ++n.fills;
  }
  float* sf = p.row(SF);
  for (int j = t; j < p.slots; j += THREADS) sf[j] = all_hi ? p.row(HI)[j] : fill_job(p, j).s(hi);
}

__device__ __forceinline__ void copy(const float* src, float* dst, int slots) {
  for (int j = threadIdx.x; j < slots; j += THREADS) dst[j] = src[j];
}

template <int L, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    pdhg_kernel(const float* __restrict__ packed, float* scratch, float* out, long long* stats,
                int slots, int max_cycles, int inner_iters) {
  using K = eg::Config<L, RESIDENT>;
  __shared__ eg::Shared sh;
  EG_DYNAMIC_SHARED(dynamic);
  // Outside the sequential structure the warps that own no slot return
  // here, and the reductions synchronise the others alone.
  const int warps = K::SEQUENTIAL ? eg::WARPS : eg::active_warps(slots);
  if ((int)(threadIdx.x >> 5) >= warps) return;
  eg::Reducer red(sh, warps);
  Counts n{0, 0, 0};
  const int t = threadIdx.x;
  const float* in = packed + (size_t)blockIdx.x * 10 * slots;
  const float *active = in, *priorities = in + slots, *completed = in + 2 * slots,
              *total = in + 3 * slots, *epoch_dur_in = in + 4 * slots,
              *remaining = in + 5 * slots, *nworkers = in + 6 * slots,
              *switch_bonus = in + 7 * slots, *s0 = in + 8 * slots, *scal = in + 9 * slots;
  const float num_gpus = scal[0], round_duration = scal[1], R = scal[2], k = scal[3],
              tol = scal[4], stall_rel = scal[5];
  Problem p;
  p.st = RESIDENT ? dynamic : scratch + (size_t)blockIdx.x * ROWS * slots;
  p.slots = slots;

  const float dur = fmaxf(round_duration, EPS);
  p.dur = dur;
  p.k = k;
  // Global sums the per-job coefficients need: active jobs, |w|^2, the
  // lateness floor, the largest cap and the least positive weight.
  {
    float v[5] = {0.0f, 0.0f, -INFINITY, -INFINITY, -INFINITY};
    for (int j = t; j < slots; j += THREADS) {
      const float a = active[j];
      const float need_sec = fmaxf(total[j] - completed[j], 0.0f) * fmaxf(epoch_dur_in[j], EPS);
      const float w = a * nworkers[j];
      const bool fits = nworkers[j] <= num_gpus && a > 0.0f;
      v[0] += a;
      v[1] += w * w;
      v[2] = fmaxf(v[2], a > 0.0f ? remaining[j] - need_sec : 0.0f);
      v[3] = fmaxf(v[3], fits ? R : 0.0f);
      v[4] = fmaxf(v[4], w > 0.0f ? -w : -INFINITY);
    }
    red.template reduce<2, 3>(v);
    const float num_active = fmaxf(v[0], 1.0f);
    p.C = fmaxf(v[2], 0.0f);
    p.max_s_max = v[3];
    p.wmin = -v[4];
    p.budget = num_gpus * R;
    const float wnorm = sqrtf(fmaxf(v[1], EPS));
    p.bhat = p.budget / wnorm;
    p.cap = k * dur;
    for (int j = t; j < slots; j += THREADS) {
      const float a = active[j];
      const float total_ep = fmaxf(total[j], EPS), epoch_dur = fmaxf(epoch_dur_in[j], EPS);
      const bool fits = nworkers[j] <= num_gpus && a > 0.0f;
      const float q = a * priorities[j] / (num_active * R);
      const float beta = dur / (epoch_dur * total_ep);
      const float need_sec = fmaxf(total[j] - completed[j], 0.0f) * epoch_dur;
      const float w = a * nworkers[j];
      const float s_max = fits ? R : 0.0f;
      p.row(S_MAX)[j] = s_max;
      p.row(Q)[j] = q;
      p.row(A_)[j] = completed[j] / total_ep;
      p.row(BETA)[j] = beta;
      p.row(XCAP)[j] = need_sec / dur;
      p.row(BONUS)[j] = a * switch_bonus[j];
      p.row(REM_SH)[j] = (remaining[j] - p.C) / dur;
      p.row(W)[j] = w;
      p.row(WHAT)[j] = w / wnorm;
      p.row(NQB)[j] = -q * beta;
      p.row(ACTIVE)[j] = a;
      p.row(REMAINING)[j] = remaining[j];
      p.row(S)[j] = clip(s0[j], 0.0f, s_max);
      p.row(Y)[j] = 0.0f;
    }
  }
  float lam = 0.0f;
  n.projections += eg::project_budget<K>(p.row(S), p.row(W), p.row(S_MAX), p.row(BEST_S), slots,
                                         p.budget, p.wmin, p.max_s_max, red);
  float best_obj = objective(p, p.row(BEST_S), red);
  float omega;
  {
    const float* s_max = p.row(S_MAX);
    float m = 0.0f;
    for (int j = t; j < slots; j += THREADS) m += s_max[j] * s_max[j];
    omega = sqrtf(red.sum(m) + 1.0f) / (p.cap + 1.0f);
  }
  const float inv = (float)(1.0 / inner_iters);
  const float sqrt2 = (float)1.4142135623730951;
  float res = INFINITY, res0 = INFINITY;
  int restarts = 0, cycle = 0, stall = 0;
  bool done = false;
  while (cycle < max_cycles && !done) {
    const float tau = 0.95f * omega / sqrt2;
    const float sigma = 0.95f / (omega * sqrt2);
    for (int j = t; j < slots; j += THREADS) {
      p.row(SC)[j] = p.row(S)[j];
      p.row(YC)[j] = p.row(Y)[j];
      p.row(SS)[j] = 0.0f;
      p.row(SY)[j] = 0.0f;
    }
    float l_c = lam, sl = 0.0f;
    for (int it = 0; it < inner_iters; ++it) {
      l_c = pdhg_step<K>(p, p.row(SC), p.row(YC), p.row(SC), p.row(YC), l_c, tau, sigma, true,
                         red, n);
      sl = sl + l_c;
    }
    for (int j = t; j < slots; j += THREADS) {
      p.row(SS)[j] = p.row(SS)[j] * inv;
      p.row(SY)[j] = p.row(SY)[j] * inv;
    }
    const float l_a = sl * inv;
    float mc[3], ma[3];
    movement<K>(p, p.row(SC), p.row(YC), l_c, tau, sigma, mc, red, n);
    movement<K>(p, p.row(SS), p.row(SY), l_a, tau, sigma, ma, red, n);
    // Restart-to-average when the cycle's average is closer to a fixed
    // point than the last iterate.
    const bool use_avg = ma[0] < mc[0];
    copy(p.row(use_avg ? SS : SC), p.row(S), slots);
    copy(p.row(use_avg ? SY : YC), p.row(Y), slots);
    lam = use_avg ? l_a : l_c;
    res = fminf(ma[0], mc[0]);
    const float dp = use_avg ? ma[1] : mc[1], dd = use_avg ? ma[2] : mc[2];
    omega = clip(sqrtf(omega * dd / fmaxf(dp, 1e-12f)), 1e-4f, 1e4f);
    n.projections += eg::project_budget<K>(p.row(S), p.row(W), p.row(S_MAX), p.row(SF), slots,
                                           p.budget, p.wmin, p.max_s_max, red);
    const float obj = objective(p, p.row(SF), red);
    const bool better = obj > best_obj;
    const bool improved = obj > best_obj + stall_rel * (1.0f + fabsf(best_obj));
    float v[2] = {0.0f, 0.0f};
    for (int j = t; j < slots; j += THREADS) {
      const float s = p.row(S)[j], y = p.row(Y)[j];
      v[0] += s * s;
      v[1] += y * y;
      if (better) p.row(BEST_S)[j] = p.row(SF)[j];
    }
    red.template reduce<2, 0>(v);
    const float denom = (1.0f + sqrtf(v[0])) + sqrtf(v[1] + lam * lam);
    best_obj = fmaxf(obj, best_obj);
    if (cycle == 0) res0 = res;
    restarts += use_avg;
    stall = improved ? 0 : stall + 1;
    ++cycle;
    done = res <= tol * denom || stall >= STALL_CYCLES;
  }

  // Exact welfare tail, kept when the summed per-job delta improves the
  // objective and the fill stays within the budget.
  welfare_fill<K>(p, p.row(BEST_S), red, n);
  float v[4] = {0.0f, 0.0f, -INFINITY, -INFINITY};
  for (int j = t; j < slots; j += THREADS) {
    const float sf = p.row(SF)[j], sp = p.row(BEST_S)[j];
    const float A = p.row(A_)[j], beta = p.row(BETA)[j], xcap = p.row(XCAP)[j];
    const float prog_new = A + beta * fminf(sf, xcap), prog_old = A + beta * fminf(sp, xcap);
    v[0] += p.row(Q)[j] * (logf(prog_new + EPS) - logf(prog_old + EPS)) +
            p.row(BONUS)[j] * (fminf(sf, 1.0f) - fminf(sp, 1.0f));
    v[1] += p.row(W)[j] * sf;
    v[2] = fmaxf(v[2], p.row(REMAINING)[j] - dur * sf);
    v[3] = fmaxf(v[3], p.row(REMAINING)[j] - dur * sp);
  }
  red.template reduce<2, 2>(v);
  const float delta = v[0] - k * (fmaxf(p.C, v[2]) - fmaxf(p.C, v[3]));
  const bool fill_wins = delta > 0.0f && v[1] <= p.budget * (float)(1.0 + 1e-6);
  float* o = out + (size_t)blockIdx.x * (slots + DIAG);
  for (int j = t; j < slots; j += THREADS) o[j] = fill_wins ? p.row(SF)[j] : p.row(BEST_S)[j];
  if (t == 0) {
    o[slots + 0] = fill_wins ? best_obj + delta : best_obj;
    o[slots + 1] = (float)cycle;
    o[slots + 2] = (float)(cycle * inner_iters);
    o[slots + 3] = (float)restarts;
    o[slots + 4] = res;
    o[slots + 5] = res0;
    o[slots + 6] = done ? 1.0f : 0.0f;
    o[slots + 7] = fill_wins ? 1.0f : 0.0f;
    long long* st = stats + (size_t)blockIdx.x * STATS;
    st[0] = red.barriers;
    st[1] = n.duals;
    st[2] = n.projections;
    st[3] = n.fills;
  }
}

// Per-job state in shared memory: bytes of dynamic shared memory.
int resident_bytes(int slots) { return ROWS * slots * (int)sizeof(float); }

template <int L, bool RESIDENT>
int launch(const float* packed, float* scratch, float* out, long long* stats, int problems,
           int slots, int max_cycles, int inner_iters, cudaStream_t stream) {
  const int bytes = RESIDENT ? resident_bytes(slots) : 0;
  if (RESIDENT) {
    const cudaError_t e = cudaFuncSetAttribute(
        pdhg_kernel<L, RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  pdhg_kernel<L, RESIDENT><<<problems, THREADS, bytes, stream>>>(packed, scratch, out, stats,
                                                                  slots, max_cycles, inner_iters);
  return cudaGetLastError();
}

using Launch = int (*)(const float*, float*, float*, long long*, int, int, int, int,
                       cudaStream_t);
// The instantiations a build holds: the wrapper's (../eg_pdhg.py::BUILT,
// levels chosen per band on an H100) and the sequential one; every one
// with -DEG_ALL_LEVELS (bench_sim --first-order --levels, the host tests).
constexpr bool built(int L, bool resident) {
#ifdef EG_ALL_LEVELS
  return true;
#else
  return L == 1 || (L == 2 && resident);
#endif
}

template <int L, bool RESIDENT>
constexpr Launch entry() {
  if constexpr (built(L, RESIDENT)) return launch<L, RESIDENT>;
  return nullptr;
}

// Every instantiation, by [resident][levels - 1]; null where not built.
const Launch LAUNCH[2][eg::MAX_LEVELS] = {
    {entry<1, false>(), entry<2, false>(), entry<3, false>(), entry<4, false>(), entry<5, false>()},
    {entry<1, true>(), entry<2, true>(), entry<3, true>(), entry<4, true>(), entry<5, true>()},
};

template <int N>
int probe(float* out, int warps, int iters, cudaStream_t stream) {
  eg::barrier_probe<N><<<1, THREADS, 0, stream>>>(out, warps, iters);
  return cudaGetLastError();
}

}  // namespace

// Floats of global per-job state one problem of `slots` job slots takes
// in a global instantiation.
extern "C" int eg_pdhg_state_floats(int slots) { return ROWS * slots; }

// Shared memory a resident instantiation's block takes at `slots`.
extern "C" int eg_pdhg_shared_bytes(int slots) {
  return resident_bytes(slots) + (int)sizeof(eg::Shared);
}

extern "C" int eg_pdhg(const void* packed, void* scratch, void* out, void* stats, int problems,
                       int slots, int max_cycles, int inner_iters, int levels, int resident,
                       void* stream) {
  if (problems <= 0 || slots < 6 || max_cycles < 0 || inner_iters <= 0 || levels < 1 ||
      levels > eg::MAX_LEVELS || (resident && eg_pdhg_shared_bytes(slots) > eg::MAX_SHARED) ||
      (!resident && scratch == nullptr))
    return cudaErrorInvalidValue;
  const Launch launch_it = LAUNCH[resident ? 1 : 0][levels - 1];
  if (launch_it == nullptr) return cudaErrorInvalidValue;
  return launch_it(
      static_cast<const float*>(packed), static_cast<float*>(scratch), static_cast<float*>(out),
      static_cast<long long*>(stats), problems, slots, max_cycles, inner_iters,
      static_cast<cudaStream_t>(stream));
}

// `iters` empty fused reductions of `values` values (1, or a tree's 2^L -
// 1) among `warps` warps of one block, for the per-barrier floor.
extern "C" int eg_barrier_probe(void* out, int values, int warps, int iters, void* stream) {
  if (warps < 1 || warps > eg::WARPS || iters < 0) return cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (values) {
    case 1: return probe<1>(o, warps, iters, s);
    case 3: return probe<3>(o, warps, iters, s);
    case 7: return probe<7>(o, warps, iters, s);
    case 15: return probe<15>(o, warps, iters, s);
    case 31: return probe<31>(o, warps, iters, s);
    default: return cudaErrorInvalidValue;
  }
}
