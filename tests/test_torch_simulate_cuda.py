"""The port's simulation path with its device solves on a card.

Needs an NVIDIA card, so it skips on a host without one. It imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch; there, without this directory's conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_simulate_cuda.py

The golden metrics of the 12-job trace (tests/test_golden.py) must come
out within 1e-3, and every level solve of the run must have run on the
card. On the seeded parity problems the card's counts must equal the
port's CPU solve (which tests/test_torch_solver.py holds to the JAX
package) and its objectives come within 1e-6 relative. The first-order
kernels (A, PDHG; B, relaxed PGD) must match their plain versions on the
card and repeat bit for bit, and the golden trace under their backends
must give the JAX package's metrics.
"""

import pytest
import torch

from shockwave_tpu_torch.tools import bench_sim


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from shockwave_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(bench_sim.GOLDEN))
def test_golden_metrics_on_the_card(device, policy):
    result = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, policy, 8, device)
    assert bench_sim.check_run(result, bench_sim.GOLDEN[policy]) == []
    if policy == "shockwave_tpu_level":
        assert result["device_solves"] == {"cuda": 16}


@pytest.mark.cuda
def test_level_counts_on_the_card_equal_the_cpu(device):
    problems = bench_sim.parity_problems()
    assert bench_sim.check_device_counts(problems, device) == []


@pytest.mark.cuda
def test_first_order_kernels_match_their_plain_versions(device):
    """Kernels A (PDHG) and B (relaxed PGD) against their plain versions on
    the card, on seeded problems of every check band, within the limits of
    two summation orders (bench_sim.eg_misses), each run twice and bitwise
    equal."""
    from shockwave_tpu_torch.ops import eg_pdhg, eg_relaxed

    eg_pdhg.reset_launch_counts()
    eg_relaxed.reset_launch_counts()
    problems = [bench_sim.seeded_problem(jobs)
                for jobs in bench_sim.EG_CHECK_BANDS]
    bad, _ = bench_sim.check_eg_kernels(problems, device)
    assert bad == []
    assert eg_pdhg.LAUNCHES["eg_pdhg"] == 2 * len(problems)
    assert eg_relaxed.LAUNCHES["eg_relaxed"] == 2 * len(problems)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["shockwave_tpu_pdhg",
                                    "shockwave_tpu_relaxed"])
def test_first_order_golden_runs_on_the_card(device, policy):
    """The golden trace under the first-order backends on the card: the
    JAX package's metrics within 1e-3 (its scripts/simulate.py on the
    trace), every solve a kernel launch."""
    result = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, policy, 8, device)
    assert bench_sim.check_run(result,
                               bench_sim.GOLDEN_FIRST_ORDER[policy]) == []
    backend = policy.rsplit("_", 1)[1]
    solves = result["solves"][backend]
    assert result["launches"]["eg_" + backend] >= solves > 0
