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
//   scratch  [P][ROWS][slots] f32, per-job state (global instantiations
//            only; resident ones keep it in shared memory);
//   out      [P][slots + 2] f32: best s, its objective, the steps run;
//   stats    [P][4] int64: block barriers passed, 0, budget projections
//            bisected, 0 (the layout of kernel A's).
//
// What bounds it: a step is ~1,000 flops a job over ~60 bytes of per-job
// state, but 64 dependent global reductions in the sequential structure
// (the logsumexp's max and sum, the projection's 61, the objective's one),
// each a block barrier (eg_common.cuh): 256 steps are a chain of ~16k
// barriers. What the design does about it:
//  - the whole solve is one launch, with the step's control scalars
//    (temperature, step size, bias corrections) computed by every thread
//    alike;
//  - the projection's 60 bisection steps walk L levels a barrier
//    (eg::bisect), and a projection whose clipped point fits the budget
//    skips them;
//  - the logsumexp's max needs no reduction of its own: step i+1's z is
//    a max(0, x) / tau over the projected s whose a max(0, x) the
//    objective of step i has just maximised, and a correctly rounded
//    division by tau > 0 is monotone, so zmax = fl(max / tau) exactly;
//  - up to 2048 slots the 14 per-job rows (56 B a job) live in shared
//    memory;
//  - warps that own no slot return at the start (eg_common.cuh), and the
//    tree then pays (ops/eg_relaxed.py::LEVELS).
// A step then passes 3 + ceil(60/L) barriers when its projection bisects,
// 3 when not; the sequential structure (L = 1, state in global memory)
// passes 64. Barriers: 3 + 3 n + ceil(60/L) b for n steps and b projections
// bisected, and 63 + 64 n sequentially.
//
// Float32 throughout, built with -fmad=false (ops/_build.py), as kernel A;
// every instantiation returns the same bits.

#include "eg_common.cuh"

namespace {

using eg::EPS;
using eg::THREADS;
using eg::clip;

enum Row {
  // the inputs a step rereads
  ACTIVE, PRIORITIES, COMPLETED, TOTAL, EPOCH_DUR, REMAINING, SWITCH_BONUS,
  // per-job state
  W, S_MAX, S, M, V, BEST_S, Z,
  ROWS
};

constexpr int DIAG = 2;
constexpr int STATS = 4;

struct Problem {
  float* st;  // row r of slot j at st[r * slots + j]
  int slots;
  float rd, R, reg, num_active;
  __device__ __forceinline__ float* row(int r) const { return st + r * slots; }
};

// d min(x, y) / dx and d max(x, y) / dx as jax.grad takes them.
__device__ __forceinline__ float d_min(float x, float y) {
  return x < y ? 1.0f : (x == y ? 0.5f : 0.0f);
}
__device__ __forceinline__ float d_max(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

// The hard-max objective at s (maximization form); `umax` receives the
// max over jobs of a max(0, lateness), the makespan term before its
// regularizer.
__device__ float objective(const Problem& p, const float* s, eg::Reducer& red, float& umax) {
  const float *active = p.row(ACTIVE), *epoch_dur = p.row(EPOCH_DUR), *total = p.row(TOTAL),
              *completed = p.row(COMPLETED), *priorities = p.row(PRIORITIES),
              *switch_bonus = p.row(SWITCH_BONUS), *remaining = p.row(REMAINING);
  float v[3] = {0.0f, 0.0f, -INFINITY};
  for (int j = threadIdx.x; j < p.slots; j += THREADS) {
    const float a = active[j], ed = fmaxf(epoch_dur[j], EPS), x = s[j];
    const float planned = fminf(x * p.rd / ed, fmaxf(total[j] - completed[j], 0.0f));
    const float progress = (completed[j] + planned) / total[j];
    v[0] += a * priorities[j] * logf(progress + EPS);
    v[1] += a * switch_bonus[j] * fminf(x, 1.0f);
    v[2] = fmaxf(v[2], a * fmaxf(0.0f, remaining[j] - ed * planned));
  }
  red.template reduce<2, 1>(v);
  umax = v[2];
  const float welfare = v[0] / (fmaxf(p.num_active, 1.0f) * p.R) + v[1];
  return welfare - p.reg * v[2];
}

template <int L, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    relaxed_kernel(const float* __restrict__ packed, float* scratch, float* out,
                   long long* stats, int slots, int num_steps) {
  using K = eg::Config<L, RESIDENT>;
  __shared__ eg::Shared sh;
  EG_DYNAMIC_SHARED(dynamic);
  // Outside the sequential structure the warps that own no slot return
  // here, and the reductions synchronise the others alone.
  const int warps = K::SEQUENTIAL ? eg::WARPS : eg::active_warps(slots);
  if ((int)(threadIdx.x >> 5) >= warps) return;
  eg::Reducer red(sh, warps);
  long long projections = 0;
  const int t = threadIdx.x;
  const float* in = packed + (size_t)blockIdx.x * 9 * slots;
  const float* nworkers = in + 6 * slots;
  const float* scal = in + 8 * slots;
  const float num_gpus = scal[0], half_lr = scal[4], s_init = scal[5];
  Problem p;
  p.st = RESIDENT ? dynamic : scratch + (size_t)blockIdx.x * ROWS * slots;
  p.slots = slots;
  p.rd = scal[1];
  p.R = scal[2];
  p.reg = scal[3];
  float *w_r = p.row(W), *s_max_r = p.row(S_MAX), *s_r = p.row(S), *m_r = p.row(M),
        *v_r = p.row(V), *best_r = p.row(BEST_S), *z_r = p.row(Z);

  const float budget = num_gpus * p.R;
  float lateness_scale, wmin, max_s_max;
  {
    float v[4] = {0.0f, -INFINITY, -INFINITY, -INFINITY};
    for (int j = t; j < slots; j += THREADS) {
      // Rows 0-5 and 7 of the input (nworkers, row 6, is read only here).
      for (int r = ACTIVE; r <= REMAINING; ++r) p.row(r)[j] = in[r * slots + j];
      p.row(SWITCH_BONUS)[j] = in[7 * slots + j];
      const float a = p.row(ACTIVE)[j];
      const bool fits = nworkers[j] <= num_gpus && a > 0.0f;
      const float w = a * nworkers[j];
      w_r[j] = w;
      s_max_r[j] = fits ? p.R : 0.0f;
      s_r[j] = s_init;
      m_r[j] = 0.0f;
      v_r[j] = 0.0f;
      v[0] += a;
      v[1] = fmaxf(v[1], p.row(REMAINING)[j] * a);
      v[2] = fmaxf(v[2], w > 0.0f ? -w : -INFINITY);
      v[3] = fmaxf(v[3], s_max_r[j]);
    }
    red.template reduce<1, 3>(v);
    p.num_active = v[0];
    lateness_scale = fmaxf(v[1], 1.0f);
    wmin = -v[2];
    max_s_max = v[3];
  }
  const float tau0 = 0.05f * lateness_scale;
  const float ratio = 1.0f / tau0;
  projections += eg::project_budget<K>(s_r, w_r, s_max_r, s_r, slots, budget, wmin, max_s_max, red);
  for (int j = t; j < slots; j += THREADS) best_r[j] = s_r[j];
  float umax;
  float best_obj = objective(p, s_r, red, umax);
  const float ct_welfare = 1.0f / (fmaxf(p.num_active, 1.0f) * p.R);
  const float steps = (float)num_steps, pi = (float)3.141592653589793;
  const float *active = p.row(ACTIVE), *priorities = p.row(PRIORITIES),
              *completed = p.row(COMPLETED), *total = p.row(TOTAL),
              *epoch_dur = p.row(EPOCH_DUR), *remaining = p.row(REMAINING),
              *switch_bonus = p.row(SWITCH_BONUS);

  for (int i = 0; i < num_steps; ++i) {
    const float i_f = (float)i;
    const float tau = tau0 * powf(ratio, i_f / steps);
    // Gradient of the tau-smoothed objective: the logsumexp's max, then
    // its sum, then the per-job chain.
    float zmax;
    if (K::SEQUENTIAL) {
      zmax = -INFINITY;
      for (int j = t; j < slots; j += THREADS) {
        const float ed = fmaxf(epoch_dur[j], EPS);
        const float planned = fminf(s_r[j] * p.rd / ed, fmaxf(total[j] - completed[j], 0.0f));
        const float z = active[j] * fmaxf(0.0f, remaining[j] - ed * planned) / tau;
        z_r[j] = z;
        zmax = fmaxf(zmax, z);
      }
      zmax = red.max(zmax);
    } else {
      zmax = umax / tau;
    }
    float sumexp = 0.0f;
    for (int j = t; j < slots; j += THREADS) {
      float z;
      if (K::SEQUENTIAL) {
        z = z_r[j];
      } else {
        const float ed = fmaxf(epoch_dur[j], EPS);
        const float planned = fminf(s_r[j] * p.rd / ed, fmaxf(total[j] - completed[j], 0.0f));
        z = active[j] * fmaxf(0.0f, remaining[j] - ed * planned) / tau;
        z_r[j] = z;
      }
      sumexp += expf(z - zmax);
    }
    sumexp = red.sum(sumexp);
    const float ct_lse = -p.reg * tau;
    const float b1c = 1.0f - powf(0.9f, i_f + 1.0f), b2c = 1.0f - powf(0.999f, i_f + 1.0f);
    const float lr = half_lr * (1.0f + cosf(pi * i_f / steps));
    for (int j = t; j < slots; j += THREADS) {
      const float a = active[j], ed = fmaxf(epoch_dur[j], EPS), s = s_r[j];
      const float ga = s * p.rd / ed, gb = fmaxf(total[j] - completed[j], 0.0f);
      const float planned = fminf(ga, gb);
      const float u = (completed[j] + planned) / total[j] + EPS;
      const float ct_planned_w = ct_welfare * (a * priorities[j]) / u / total[j];
      const float x = remaining[j] - ed * planned;
      const float e = expf(z_r[j] - zmax);
      const float ct_late = ct_lse / sumexp * e / tau;
      const float ct_x = ct_late * a * d_max(x, 0.0f);
      const float ct_planned = ct_planned_w + -(ct_x * ed);
      float g = ct_planned * d_min(ga, gb) / ed * p.rd;
      g = g + a * switch_bonus[j] * d_min(s, 1.0f);
      // Adam with bias correction and the cosine step size.
      const float m = 0.9f * m_r[j] + 0.1f * g;
      const float v = 0.999f * v_r[j] + 0.001f * g * g;
      m_r[j] = m;
      v_r[j] = v;
      const float m_hat = m / b1c, v_hat = v / b2c;
      s_r[j] = s + lr * m_hat / (sqrtf(v_hat) + 1e-8f);
    }
    projections +=
        eg::project_budget<K>(s_r, w_r, s_max_r, s_r, slots, budget, wmin, max_s_max, red);
    const float val = objective(p, s_r, red, umax);
    if (val > best_obj) {
      best_obj = val;
      for (int j = t; j < slots; j += THREADS) best_r[j] = s_r[j];
    }
  }
  float* o = out + (size_t)blockIdx.x * (slots + DIAG);
  for (int j = t; j < slots; j += THREADS) o[j] = best_r[j];
  if (t == 0) {
    o[slots] = best_obj;
    o[slots + 1] = (float)num_steps;
    long long* st = stats + (size_t)blockIdx.x * STATS;
    st[0] = red.barriers;
    st[1] = 0;
    st[2] = projections;
    st[3] = 0;
  }
}

// Per-job state in shared memory: bytes of dynamic shared memory.
int resident_bytes(int slots) { return ROWS * slots * (int)sizeof(float); }

template <int L, bool RESIDENT>
int launch(const float* packed, float* scratch, float* out, long long* stats, int problems,
           int slots, int num_steps, cudaStream_t stream) {
  const int bytes = RESIDENT ? resident_bytes(slots) : 0;
  if (RESIDENT) {
    const cudaError_t e = cudaFuncSetAttribute(
        relaxed_kernel<L, RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  relaxed_kernel<L, RESIDENT><<<problems, THREADS, bytes, stream>>>(packed, scratch, out, stats,
                                                                     slots, num_steps);
  return cudaGetLastError();
}

using Launch = int (*)(const float*, float*, float*, long long*, int, int, int, cudaStream_t);
// The instantiations a build holds: the wrapper's (../eg_relaxed.py::BUILT,
// levels chosen per band on an H100) and the sequential one; every one
// with -DEG_ALL_LEVELS (bench_sim --first-order --levels, the host tests).
constexpr bool built(int L, bool resident) {
#ifdef EG_ALL_LEVELS
  return true;
#else
  return L <= 2;
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

}  // namespace

// Floats of global per-job state one problem of `slots` job slots takes
// in a global instantiation.
extern "C" int eg_relaxed_state_floats(int slots) { return ROWS * slots; }

// Shared memory a resident instantiation's block takes at `slots`.
extern "C" int eg_relaxed_shared_bytes(int slots) {
  return resident_bytes(slots) + (int)sizeof(eg::Shared);
}

extern "C" int eg_relaxed(const void* packed, void* scratch, void* out, void* stats,
                          int problems, int slots, int num_steps, int levels, int resident,
                          void* stream) {
  if (problems <= 0 || slots < 6 || num_steps < 0 || levels < 1 || levels > eg::MAX_LEVELS ||
      (resident && eg_relaxed_shared_bytes(slots) > eg::MAX_SHARED) ||
      (!resident && scratch == nullptr))
    return cudaErrorInvalidValue;
  const Launch launch_it = LAUNCH[resident ? 1 : 0][levels - 1];
  if (launch_it == nullptr) return cudaErrorInvalidValue;
  return launch_it(
      static_cast<const float*>(packed), static_cast<float*>(scratch), static_cast<float*>(out),
      static_cast<long long*>(stats), problems, slots, num_steps,
      static_cast<cudaStream_t>(stream));
}
