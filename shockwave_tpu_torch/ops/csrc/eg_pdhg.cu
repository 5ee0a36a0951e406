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
//   scratch  [P][SCRATCH][slots] f32, per-job state of the solve;
//   out      [P][slots + 8] f32: best s, then best objective, cycles,
//            iterations, restarts, residual, residual0, converged,
//            welfare_filled;
//   barriers [P] int64: block barriers the solve passed.
//
// What bounds it: neither bytes nor operations. A step is ~400 flops a job
// over ~70 bytes of per-job state, but it carries 1 to 31 dependent global
// reductions (the budget dual, and the dual projection's bisection when the
// makespan cap binds), a cycle 40 steps plus two movement steps, a 60-step
// budget projection and the objective, and the welfare fill 80 more. Each
// reduction is one block barrier (eg_common.cuh), so the solve is a chain
// of thousands of barriers; the state stays in L2. What the design does
// about it: the whole solve is one launch, every control decision
// (lax.cond in proj_dual, restart-to-average, the while-loop test, the
// stall counter, fill_wins) is block-uniform after its reduction, and
// fused reductions share one barrier.
//
// Float32 throughout, as the JAX package. Built with -fmad=false
// (ops/_build.py): every product rounds before its sum, as each eager
// PyTorch op of the plain version does, so the kernel and its plain
// version on the card differ only in the order of their sums.

#include "eg_common.cuh"

namespace {

using eg::EPS;
using eg::THREADS;
using eg::clip;

enum Row {
  // per-job constants
  S_MAX, Q, A_, BETA, XCAP, BONUS, REM_SH, W, WHAT, NQB,
  // per-job state
  S, Y, SC, YC, SS, SY, S2, Y2, SF, BEST_S, NMIN, HI,
  SCRATCH
};

constexpr int PROX_BISECT = 30;
constexpr int DUAL_BISECT = 30;
constexpr int FILL_BISECT = 80;
constexpr int STALL_CYCLES = 3;
constexpr int DIAG = 8;

struct Problem {
  const float *active, *remaining;
  float* row[SCRATCH];
  int slots;
  float dur, k, budget, cap, bhat, C, wmin, max_s_max;
};

// One PDHG step from (s_in, y_in, lam) into (s_out, y_out); the outputs
// may alias the inputs (each thread owns its slots). With `accumulate`,
// the new iterate is added to the running sums SS and SY. Returns lam_new.
__device__ float pdhg_step(const Problem& p, const float* s_in, const float* y_in, float* s_out,
                           float* y_out, float lam, float tau, float sigma, bool accumulate,
                           eg::Reducer& red) {
  const int t = threadIdx.x;
  float* const* r = p.row;
  float v[3] = {0.0f, 0.0f, -INFINITY};  // sum yv, sum what * sbar, max yv
  for (int j = t; j < p.slots; j += THREADS) {
    const float s = s_in[j], what = r[WHAT][j];
    const float x0 = s + tau * (y_in[j] - lam * what);
    // prox_primal: bisection on the sign of the 1-D subproblem's derivative.
    const float xcap = r[XCAP][j], nqb = r[NQB][j], ae = r[A_][j] + EPS, beta = r[BETA][j],
                bonus = r[BONUS][j];
    float lo = 0.0f, hi = r[S_MAX][j];
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
    const float yv = fmaxf(y_in[j] + sigma * (r[REM_SH][j] - sbar), 0.0f) * p.active[j];
    s_out[j] = s_new;
    y_out[j] = yv;
    v[0] += yv;
    v[1] += what * sbar;
    v[2] = fmaxf(v[2], yv);
  }
  red.reduce<2, 1>(v);
  if (v[0] > p.cap) {
    // proj_dual: the smallest threshold whose clipped load fits the cap.
    float lo = 0.0f, hi = v[2];
    for (int it = 0; it < DUAL_BISECT; ++it) {
      const float mid = 0.5f * (lo + hi);
      float load = 0.0f;
      for (int j = t; j < p.slots; j += THREADS) load += fmaxf(y_out[j] - mid, 0.0f);
      const bool over = red.sum(load) > p.cap;
      lo = over ? mid : lo;
      hi = over ? hi : mid;
    }
    const float theta = 0.5f * (lo + hi);
    for (int j = t; j < p.slots; j += THREADS) y_out[j] = fmaxf(y_out[j] - theta, 0.0f);
  }
  if (accumulate) {
    for (int j = t; j < p.slots; j += THREADS) {
      r[SS][j] += s_out[j];
      r[SY][j] += y_out[j];
    }
  }
  return fmaxf(lam + sigma * (v[1] - p.bhat), 0.0f);
}

// Fixed-point residual of one step from (s, y, lam): (res, dp, dd).
__device__ void movement(const Problem& p, const float* s, const float* y, float lam, float tau,
                         float sigma, float (&out)[3], eg::Reducer& red) {
  float* const* r = p.row;
  const float l2 = pdhg_step(p, s, y, r[S2], r[Y2], lam, tau, sigma, false, red);
  float v[2] = {0.0f, 0.0f};
  for (int j = threadIdx.x; j < p.slots; j += THREADS) {
    const float ds = r[S2][j] - s[j], dy = r[Y2][j] - y[j];
    v[0] += ds * ds;
    v[1] += dy * dy;
  }
  red.reduce<2, 0>(v);
  const float dl = l2 - lam;
  const float dp = sqrtf(v[0]), dd = sqrtf(v[1] + dl * dl);
  out[0] = sqrtf(dp * dp + dd * dd);
  out[1] = dp;
  out[2] = dd;
}

// The exact relaxed objective at s (maximization form).
__device__ float objective(const Problem& p, const float* s, eg::Reducer& red) {
  float* const* r = p.row;
  float v[3] = {0.0f, 0.0f, -INFINITY};
  for (int j = threadIdx.x; j < p.slots; j += THREADS) {
    const float x = s[j];
    const float progress = r[A_][j] + r[BETA][j] * fminf(x, r[XCAP][j]);
    v[0] += r[Q][j] * logf(progress + EPS);
    v[1] += r[BONUS][j] * fminf(x, 1.0f);
    v[2] = fmaxf(v[2], p.remaining[j] - p.dur * x);
  }
  red.reduce<2, 1>(v);
  return (v[0] + v[1]) - p.k * fmaxf(p.C, v[2]);
}

// welfare_fill's allocation at budget dual lam for job j.
__device__ __forceinline__ float s_of(const Problem& p, int j, float lam) {
  float* const* r = p.row;
  const float w = r[W][j];
  const float w_safe = w > 0.0f ? w : 1.0f;
  const float gain = r[Q][j] * r[BETA][j], A = r[A_][j], bonus = r[BONUS][j];
  const float beta_safe = fmaxf(r[BETA][j], 1e-20f);
  const float lw = lam * w_safe;
  const float raw_w = (gain / lw - A - EPS) / beta_safe;
  const float raw_b = (gain / fmaxf(lw - bonus, 1e-30f) - A - EPS) / beta_safe;
  const float s_lam =
      raw_w >= 1.0f
          ? raw_w
          : (lw <= bonus ? 1.0f : fminf(clip(raw_b, 0.0f, 1.0f), fmaxf(r[XCAP][j], 0.0f)));
  return clip(s_lam, r[NMIN][j], r[HI][j]);
}

// Closed-form KKT water-fill of the residual budget from s into SF.
__device__ void welfare_fill(const Problem& p, const float* s, eg::Reducer& red) {
  float* const* r = p.row;
  const int t = threadIdx.x;
  float m = -INFINITY;
  for (int j = t; j < p.slots; j += THREADS) m = fmaxf(m, p.remaining[j] - p.dur * s[j]);
  const float M = fmaxf(p.C, red.max(m));
  float v[3] = {0.0f, -INFINITY, -INFINITY};  // sum w * hi, max dens_min, max bonus / w_safe
  for (int j = t; j < p.slots; j += THREADS) {
    const float s_max = r[S_MAX][j], xcap = r[XCAP][j], bonus = r[BONUS][j], w = r[W][j];
    const float n_min = clip(ceilf((p.remaining[j] - M) / p.dur - 1e-4f), 0.0f, s_max);
    float hi = fmaxf(fminf(xcap, s_max), n_min);
    hi = fmaxf(hi, bonus > 0.0f ? fminf(1.0f, s_max) : 0.0f);
    r[NMIN][j] = n_min;
    r[HI][j] = hi;
    const float w_safe = w > 0.0f ? w : 1.0f;
    const float gain = r[Q][j] * r[BETA][j];
    v[0] += w * hi;
    v[1] = fmaxf(v[1], gain / (((r[A_][j] + EPS) + r[BETA][j] * n_min) * w_safe));
    v[2] = fmaxf(v[2], bonus / w_safe);
  }
  red.reduce<1, 2>(v);
  float lo = 1e-30f, hi = 2.0f * fmaxf(fmaxf(v[1], v[2]), 1e-30f);
  for (int it = 0; it < FILL_BISECT; ++it) {
    const float mid = sqrtf(lo * hi);
    float load = 0.0f;
    for (int j = t; j < p.slots; j += THREADS) load += r[W][j] * s_of(p, j, mid);
    const bool over = red.sum(load) > p.budget;
    lo = over ? mid : lo;
    hi = over ? hi : mid;
  }
  const bool all_hi = v[0] <= p.budget;
  for (int j = t; j < p.slots; j += THREADS) r[SF][j] = all_hi ? r[HI][j] : s_of(p, j, hi);
}

__device__ __forceinline__ void copy(const float* src, float* dst, int slots) {
  for (int j = threadIdx.x; j < slots; j += THREADS) dst[j] = src[j];
}

__global__ void __launch_bounds__(THREADS, 1)
    pdhg_kernel(const float* __restrict__ packed, float* scratch, float* out,
                long long* barriers, int slots, int max_cycles, int inner_iters) {
  __shared__ float red_buf[2][eg::WARPS][eg::MAX_FUSED];
  eg::Reducer red{red_buf, 0, 0};
  const int t = threadIdx.x;
  const float* in = packed + (size_t)blockIdx.x * 10 * slots;
  const float *active = in, *priorities = in + slots, *completed = in + 2 * slots,
              *total = in + 3 * slots, *epoch_dur_in = in + 4 * slots,
              *remaining = in + 5 * slots, *nworkers = in + 6 * slots,
              *switch_bonus = in + 7 * slots, *s0 = in + 8 * slots, *scal = in + 9 * slots;
  const float num_gpus = scal[0], round_duration = scal[1], R = scal[2], k = scal[3],
              tol = scal[4], stall_rel = scal[5];
  Problem p;
  p.active = active;
  p.remaining = remaining;
  p.slots = slots;
  for (int i = 0; i < SCRATCH; ++i) p.row[i] = scratch + ((size_t)blockIdx.x * SCRATCH + i) * slots;
  float* const* r = p.row;

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
    red.reduce<2, 3>(v);
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
      r[S_MAX][j] = fits ? R : 0.0f;
      r[Q][j] = q;
      r[A_][j] = completed[j] / total_ep;
      r[BETA][j] = beta;
      r[XCAP][j] = need_sec / dur;
      r[BONUS][j] = a * switch_bonus[j];
      r[REM_SH][j] = (remaining[j] - p.C) / dur;
      r[W][j] = w;
      r[WHAT][j] = w / wnorm;
      r[NQB][j] = -q * beta;
      r[S][j] = clip(s0[j], 0.0f, r[S_MAX][j]);
      r[Y][j] = 0.0f;
    }
  }
  float lam = 0.0f;
  eg::project_budget(r[S], r[W], r[S_MAX], r[BEST_S], slots, p.budget, p.wmin, p.max_s_max, red);
  float best_obj = objective(p, r[BEST_S], red);
  float omega;
  {
    float m = 0.0f;
    for (int j = t; j < slots; j += THREADS) m += r[S_MAX][j] * r[S_MAX][j];
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
      r[SC][j] = r[S][j];
      r[YC][j] = r[Y][j];
      r[SS][j] = 0.0f;
      r[SY][j] = 0.0f;
    }
    float l_c = lam, sl = 0.0f;
    for (int it = 0; it < inner_iters; ++it) {
      l_c = pdhg_step(p, r[SC], r[YC], r[SC], r[YC], l_c, tau, sigma, true, red);
      sl = sl + l_c;
    }
    for (int j = t; j < slots; j += THREADS) {
      r[SS][j] = r[SS][j] * inv;
      r[SY][j] = r[SY][j] * inv;
    }
    const float l_a = sl * inv;
    float mc[3], ma[3];
    movement(p, r[SC], r[YC], l_c, tau, sigma, mc, red);
    movement(p, r[SS], r[SY], l_a, tau, sigma, ma, red);
    // Restart-to-average when the cycle's average is closer to a fixed
    // point than the last iterate.
    const bool use_avg = ma[0] < mc[0];
    copy(use_avg ? r[SS] : r[SC], r[S], slots);
    copy(use_avg ? r[SY] : r[YC], r[Y], slots);
    lam = use_avg ? l_a : l_c;
    res = fminf(ma[0], mc[0]);
    const float dp = use_avg ? ma[1] : mc[1], dd = use_avg ? ma[2] : mc[2];
    omega = clip(sqrtf(omega * dd / fmaxf(dp, 1e-12f)), 1e-4f, 1e4f);
    eg::project_budget(r[S], r[W], r[S_MAX], r[SF], slots, p.budget, p.wmin, p.max_s_max, red);
    const float obj = objective(p, r[SF], red);
    const bool better = obj > best_obj;
    const bool improved = obj > best_obj + stall_rel * (1.0f + fabsf(best_obj));
    float v[2] = {0.0f, 0.0f};
    for (int j = t; j < slots; j += THREADS) {
      v[0] += r[S][j] * r[S][j];
      v[1] += r[Y][j] * r[Y][j];
      if (better) r[BEST_S][j] = r[SF][j];
    }
    red.reduce<2, 0>(v);
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
  welfare_fill(p, r[BEST_S], red);
  float v[4] = {0.0f, 0.0f, -INFINITY, -INFINITY};
  for (int j = t; j < slots; j += THREADS) {
    const float sf = r[SF][j], sp = r[BEST_S][j];
    const float A = r[A_][j], beta = r[BETA][j], xcap = r[XCAP][j];
    const float prog_new = A + beta * fminf(sf, xcap), prog_old = A + beta * fminf(sp, xcap);
    v[0] += r[Q][j] * (logf(prog_new + EPS) - logf(prog_old + EPS)) +
            r[BONUS][j] * (fminf(sf, 1.0f) - fminf(sp, 1.0f));
    v[1] += r[W][j] * sf;
    v[2] = fmaxf(v[2], remaining[j] - dur * sf);
    v[3] = fmaxf(v[3], remaining[j] - dur * sp);
  }
  red.reduce<2, 2>(v);
  const float delta = v[0] - k * (fmaxf(p.C, v[2]) - fmaxf(p.C, v[3]));
  const bool fill_wins = delta > 0.0f && v[1] <= p.budget * (float)(1.0 + 1e-6);
  float* o = out + (size_t)blockIdx.x * (slots + DIAG);
  for (int j = t; j < slots; j += THREADS) o[j] = fill_wins ? r[SF][j] : r[BEST_S][j];
  if (t == 0) {
    o[slots + 0] = fill_wins ? best_obj + delta : best_obj;
    o[slots + 1] = (float)cycle;
    o[slots + 2] = (float)(cycle * inner_iters);
    o[slots + 3] = (float)restarts;
    o[slots + 4] = res;
    o[slots + 5] = res0;
    o[slots + 6] = done ? 1.0f : 0.0f;
    o[slots + 7] = fill_wins ? 1.0f : 0.0f;
    barriers[blockIdx.x] = red.barriers;
  }
}

}  // namespace

// Floats of per-job scratch one problem of `slots` job slots takes.
extern "C" int eg_pdhg_scratch_floats(int slots) { return SCRATCH * slots; }

extern "C" int eg_pdhg(const void* packed, void* scratch, void* out, void* barriers, int problems,
                       int slots, int max_cycles, int inner_iters, void* stream) {
  if (problems <= 0 || slots < 6 || max_cycles < 0 || inner_iters <= 0)
    return cudaErrorInvalidValue;
  pdhg_kernel<<<problems, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<float*>(scratch), static_cast<float*>(out),
      static_cast<long long*>(barriers), slots, max_cycles, inner_iters);
  return cudaGetLastError();
}
