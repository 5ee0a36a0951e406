// Host-native EG planning solver: the same placement-aware greedy as
// shockwave_tpu/solver/eg_jax.py::solve_greedy, in C++ for scheduler head
// nodes without an accelerator (the reference's GUROBI solve also ran on
// host CPU). Semantics are kept in lock-step with the JAX kernel — the
// test suite cross-checks the two on random instances.
//
// Exposed as a C ABI for ctypes (see shockwave_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Chordal interpolation of log over the breakpoints (piecewise-log
// utility; matches jnp.interp semantics incl. clamping at the ends).
double interp(double x, const double* xs, const double* ys, int n) {
  if (x <= xs[0]) return ys[0];
  if (x >= xs[n - 1]) return ys[n - 1];
  int hi = 1;
  while (xs[hi] < x) ++hi;
  const double t = (x - xs[hi - 1]) / (xs[hi] - xs[hi - 1]);
  return ys[hi - 1] + t * (ys[hi] - ys[hi - 1]);
}

}  // namespace

extern "C" {

// All job arrays have length num_jobs; Y is (num_jobs x future_rounds)
// row-major int8, zero-initialized by the caller. switch_bonus is the
// per-job keep-incumbent bonus (regularizer * relaunch overhead for
// jobs holding workers, 0 otherwise) credited to a job's first granted
// round — the switching-cost term of the extended EG objective.
void eg_greedy_solve(
    int num_jobs,
    int future_rounds,
    const double* priorities,
    const double* completed,
    const double* total,
    const double* epoch_dur,
    const double* remaining,
    const double* nworkers,
    const double* switch_bonus,
    double num_gpus,
    const double* log_bases,
    const double* log_vals,
    int num_bases,
    double round_duration,
    double regularizer,
    int8_t* Y) {
  const int J = num_jobs;
  const int R = future_rounds;
  const double eps = 1e-6;
  const double norm = static_cast<double>(J) * R;

  std::vector<double> n(J, 0.0);
  std::vector<double> free_cap(R, num_gpus);
  std::vector<double> need_epochs(J), dur(J);
  for (int j = 0; j < J; ++j) {
    need_epochs[j] = std::max(total[j] - completed[j], 0.0);
    dur[j] = std::max(epoch_dur[j], eps);
  }

  auto planned_epochs = [&](int j, double nj) {
    return std::min(nj * round_duration / dur[j], need_epochs[j]);
  };
  auto utility = [&](int j, double nj) {
    const double progress = (completed[j] + planned_epochs(j, nj)) / total[j];
    const double bonus = (nj >= 0.5) ? switch_bonus[j] : 0.0;
    return priorities[j] * interp(progress, log_bases, log_vals, num_bases) /
               norm +
           bonus;
  };
  auto lateness = [&](int j, double nj) {
    return std::max(0.0, remaining[j] - dur[j] * planned_epochs(j, nj));
  };

  const long max_grants =
      std::min(static_cast<long>(num_gpus) * R, static_cast<long>(J) * R);

  std::vector<double> ell(J);
  for (long grant = 0; grant < max_grants; ++grant) {
    // Current lateness vector, max and second max.
    double m1 = -1.0, m2 = -1.0;
    for (int j = 0; j < J; ++j) {
      ell[j] = lateness(j, n[j]);
      if (ell[j] >= m1) {
        m2 = m1;
        m1 = ell[j];
      } else if (ell[j] > m2) {
        m2 = ell[j];
      }
    }

    int best_j = -1;
    double best_density = -1e300, best_gain = 0.0;
    for (int j = 0; j < J; ++j) {
      if (nworkers[j] > num_gpus || n[j] + 1.0 > R) continue;
      // Feasible iff some round the job does not occupy has room.
      bool open = false;
      for (int r = 0; r < R; ++r) {
        if (!Y[j * R + r] && free_cap[r] >= nworkers[j]) {
          open = true;
          break;
        }
      }
      if (!open) continue;
      const double welfare_gain = utility(j, n[j] + 1.0) - utility(j, n[j]);
      const double m_excl = (ell[j] >= m1) ? m2 : m1;
      const double new_makespan =
          std::max(m_excl, lateness(j, n[j] + 1.0));
      const double gain = welfare_gain + regularizer * (m1 - new_makespan);
      const double density = gain / nworkers[j];
      if (density > best_density) {
        best_density = density;
        best_gain = gain;
        best_j = j;
      }
    }
    if (best_j < 0 || best_gain <= 1e-12) break;

    // Most-free eligible round, ties -> earliest.
    int best_r = -1;
    double best_score = -1e300;
    for (int r = 0; r < R; ++r) {
      if (Y[best_j * R + r] || free_cap[r] < nworkers[best_j]) continue;
      const double score = free_cap[r] * (R + 1.0) - r;
      if (score > best_score) {
        best_score = score;
        best_r = r;
      }
    }
    Y[best_j * R + best_r] = 1;
    free_cap[best_r] -= nworkers[best_j];
    n[best_j] += 1.0;
  }
}

}  // extern "C"
