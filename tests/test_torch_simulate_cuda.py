"""The port's simulation path with its level solve on a card.

Needs an NVIDIA card, so it skips on a host without one. It imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch; there, without this directory's conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_simulate_cuda.py

The golden metrics of the 12-job trace (tests/test_golden.py) must come
out within 1e-3, and every level solve of the run must have run on the
card. On the seeded parity problems the card's counts must equal the
port's CPU solve (which tests/test_torch_solver.py holds to the JAX
package) and its objectives come within 1e-6 relative.
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
