// Kernel B: the relaxed projected-gradient (Adam) solve of the EG program,
// one launch a solve, one thread block a problem.
//
// Replaces the JAX package's jitted loop
// shockwave_tpu/solver/eg_jax.py::solve_relaxed (:121-205) with _project
// (:46) and jax.grad of _objective (:75-117): 256 Adam steps with a cosine
// step size and an annealed logsumexp temperature on the makespan term,
// each step re-projected onto the budget-box polytope by a 60-step
// bisection, keeping the best iterate by the true objective. Its plain
// PyTorch version, op for op, is
// shockwave_tpu_torch/solver/eg_relaxed.py::solve_relaxed; the wrapper is
// ../eg_relaxed.py::relaxed.
//
// The gradient is written out in the order of jax.grad's reverse pass
// (solver/eg_relaxed.py::_grad), and like jax.grad it gives half the
// derivative to each side where a min or max ties: min(s, 1) at s = 1, the
// planned-epochs cap at the cap, max(0, lateness) at zero lateness.
//
// Contract:
//   packed   [P][9][slots] f32: active, priorities, completed, total,
//            epoch_dur, remaining, nworkers, switch_bonus, then the scalars
//            num_gpus, round_duration, future_rounds, regularizer, half_lr
//            (0.05 R) and s_init (R / 2) in the first entries of row 8;
//   scratch  [P][SCRATCH][slots] f32, per-job state;
//   out      [P][slots + 2] f32: best s, its objective, the steps run;
//   barriers [P] int64: block barriers the solve passed.
//
// What bounds it: a step is ~1,000 flops a job over ~60 bytes of per-job
// state, but 64 dependent global reductions (the logsumexp's max and sum,
// the projection's 61, the objective's one), each a block barrier
// (eg_common.cuh): 256 steps are a chain of ~16k barriers, with the state
// in L2. The design keeps the whole solve in one launch with the step's
// control scalars (temperature, step size, bias corrections) computed by
// every thread alike.
//
// Float32 throughout, built with -fmad=false (ops/_build.py), as kernel A.

#include "eg_common.cuh"

namespace {

using eg::EPS;
using eg::THREADS;
using eg::clip;

enum Row { W, S_MAX, S, M, V, BEST_S, Z, SCRATCH };

constexpr int DIAG = 2;

struct Problem {
  const float *active, *priorities, *completed, *total, *epoch_dur, *remaining, *switch_bonus;
  float rd, R, reg, num_active;
};

// d min(x, y) / dx and d max(x, y) / dx as jax.grad takes them.
__device__ __forceinline__ float d_min(float x, float y) {
  return x < y ? 1.0f : (x == y ? 0.5f : 0.0f);
}
__device__ __forceinline__ float d_max(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

// The hard-max objective at s (maximization form).
__device__ float objective(const Problem& p, const float* s, int slots, eg::Reducer& red) {
  float v[3] = {0.0f, 0.0f, -INFINITY};
  for (int j = threadIdx.x; j < slots; j += THREADS) {
    const float a = p.active[j], ed = fmaxf(p.epoch_dur[j], EPS), x = s[j];
    const float planned = fminf(x * p.rd / ed, fmaxf(p.total[j] - p.completed[j], 0.0f));
    const float progress = (p.completed[j] + planned) / p.total[j];
    v[0] += a * p.priorities[j] * logf(progress + EPS);
    v[1] += a * p.switch_bonus[j] * fminf(x, 1.0f);
    v[2] = fmaxf(v[2], a * fmaxf(0.0f, p.remaining[j] - ed * planned));
  }
  red.reduce<2, 1>(v);
  const float welfare = v[0] / (fmaxf(p.num_active, 1.0f) * p.R) + v[1];
  return welfare - p.reg * v[2];
}

__global__ void __launch_bounds__(THREADS, 1)
    relaxed_kernel(const float* __restrict__ packed, float* scratch, float* out,
                   long long* barriers, int slots, int num_steps) {
  __shared__ float red_buf[2][eg::WARPS][eg::MAX_FUSED];
  eg::Reducer red{red_buf, 0, 0};
  const int t = threadIdx.x;
  const float* in = packed + (size_t)blockIdx.x * 9 * slots;
  Problem p;
  p.active = in;
  p.priorities = in + slots;
  p.completed = in + 2 * slots;
  p.total = in + 3 * slots;
  p.epoch_dur = in + 4 * slots;
  p.remaining = in + 5 * slots;
  const float* nworkers = in + 6 * slots;
  p.switch_bonus = in + 7 * slots;
  const float* scal = in + 8 * slots;
  const float num_gpus = scal[0], half_lr = scal[4], s_init = scal[5];
  p.rd = scal[1];
  p.R = scal[2];
  p.reg = scal[3];
  float* r[SCRATCH];
  for (int i = 0; i < SCRATCH; ++i) r[i] = scratch + ((size_t)blockIdx.x * SCRATCH + i) * slots;

  const float budget = num_gpus * p.R;
  float lateness_scale, wmin, max_s_max;
  {
    float v[4] = {0.0f, -INFINITY, -INFINITY, -INFINITY};
    for (int j = t; j < slots; j += THREADS) {
      const float a = p.active[j];
      const bool fits = nworkers[j] <= num_gpus && a > 0.0f;
      const float w = a * nworkers[j];
      r[W][j] = w;
      r[S_MAX][j] = fits ? p.R : 0.0f;
      r[S][j] = s_init;
      r[M][j] = 0.0f;
      r[V][j] = 0.0f;
      v[0] += a;
      v[1] = fmaxf(v[1], p.remaining[j] * a);
      v[2] = fmaxf(v[2], w > 0.0f ? -w : -INFINITY);
      v[3] = fmaxf(v[3], r[S_MAX][j]);
    }
    red.reduce<1, 3>(v);
    p.num_active = v[0];
    lateness_scale = fmaxf(v[1], 1.0f);
    wmin = -v[2];
    max_s_max = v[3];
  }
  const float tau0 = 0.05f * lateness_scale;
  const float ratio = 1.0f / tau0;
  eg::project_budget(r[S], r[W], r[S_MAX], r[S], slots, budget, wmin, max_s_max, red);
  for (int j = t; j < slots; j += THREADS) r[BEST_S][j] = r[S][j];
  float best_obj = objective(p, r[S], slots, red);
  const float ct_welfare = 1.0f / (fmaxf(p.num_active, 1.0f) * p.R);
  const float steps = (float)num_steps, pi = (float)3.141592653589793;

  for (int i = 0; i < num_steps; ++i) {
    const float i_f = (float)i;
    const float tau = tau0 * powf(ratio, i_f / steps);
    // Gradient of the tau-smoothed objective: the logsumexp's max, then
    // its sum, then the per-job chain.
    float zmax = -INFINITY;
    for (int j = t; j < slots; j += THREADS) {
      const float ed = fmaxf(p.epoch_dur[j], EPS);
      const float planned =
          fminf(r[S][j] * p.rd / ed, fmaxf(p.total[j] - p.completed[j], 0.0f));
      const float z = p.active[j] * fmaxf(0.0f, p.remaining[j] - ed * planned) / tau;
      r[Z][j] = z;
      zmax = fmaxf(zmax, z);
    }
    zmax = red.max(zmax);
    float sumexp = 0.0f;
    for (int j = t; j < slots; j += THREADS) sumexp += expf(r[Z][j] - zmax);
    sumexp = red.sum(sumexp);
    const float ct_lse = -p.reg * tau;
    const float b1c = 1.0f - powf(0.9f, i_f + 1.0f), b2c = 1.0f - powf(0.999f, i_f + 1.0f);
    const float lr = half_lr * (1.0f + cosf(pi * i_f / steps));
    for (int j = t; j < slots; j += THREADS) {
      const float a = p.active[j], ed = fmaxf(p.epoch_dur[j], EPS), s = r[S][j];
      const float ga = s * p.rd / ed, gb = fmaxf(p.total[j] - p.completed[j], 0.0f);
      const float planned = fminf(ga, gb);
      const float u = (p.completed[j] + planned) / p.total[j] + EPS;
      const float ct_planned_w = ct_welfare * (a * p.priorities[j]) / u / p.total[j];
      const float x = p.remaining[j] - ed * planned;
      const float e = expf(r[Z][j] - zmax);
      const float ct_late = ct_lse / sumexp * e / tau;
      const float ct_x = ct_late * a * d_max(x, 0.0f);
      const float ct_planned = ct_planned_w + -(ct_x * ed);
      float g = ct_planned * d_min(ga, gb) / ed * p.rd;
      g = g + a * p.switch_bonus[j] * d_min(s, 1.0f);
      // Adam with bias correction and the cosine step size.
      const float m = 0.9f * r[M][j] + 0.1f * g;
      const float v = 0.999f * r[V][j] + 0.001f * g * g;
      r[M][j] = m;
      r[V][j] = v;
      const float m_hat = m / b1c, v_hat = v / b2c;
      r[S][j] = s + lr * m_hat / (sqrtf(v_hat) + 1e-8f);
    }
    eg::project_budget(r[S], r[W], r[S_MAX], r[S], slots, budget, wmin, max_s_max, red);
    const float val = objective(p, r[S], slots, red);
    if (val > best_obj) {
      best_obj = val;
      for (int j = t; j < slots; j += THREADS) r[BEST_S][j] = r[S][j];
    }
  }
  float* o = out + (size_t)blockIdx.x * (slots + DIAG);
  for (int j = t; j < slots; j += THREADS) o[j] = r[BEST_S][j];
  if (t == 0) {
    o[slots] = best_obj;
    o[slots + 1] = (float)num_steps;
    barriers[blockIdx.x] = red.barriers;
  }
}

}  // namespace

// Floats of per-job scratch one problem of `slots` job slots takes.
extern "C" int eg_relaxed_scratch_floats(int slots) { return SCRATCH * slots; }

extern "C" int eg_relaxed(const void* packed, void* scratch, void* out, void* barriers,
                          int problems, int slots, int num_steps, void* stream) {
  if (problems <= 0 || slots < 6 || num_steps < 0) return cudaErrorInvalidValue;
  relaxed_kernel<<<problems, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<float*>(scratch), static_cast<float*>(out),
      static_cast<long long*>(barriers), slots, num_steps);
  return cudaGetLastError();
}
