"""The MoE MLP in a gang: the global batch is one routing problem. Two
(and four) gloo ranks on the CPU, each a step of ``models/train.py`` on
its shard, against one process on the global batch (the data groups'
draws stacked, the sequence over a mesh of as many places): every step's
loss, balance loss and dropped share, and every parameter after the
steps, within 1e-5; the ranks' parameters equal. Capacity factors under 1
make experts overflow, so a token's place in its bucket, counted across
the ranks, decides what is dropped.
"""

import pytest
import torch

from torch_gang_runs import one_process, spawn_gang, train_argv, train_rank

TOL = 1e-5


def _check(ranks, ref):
    for got in ranks:
        assert torch.tensor(got["steps"]) == pytest.approx(
            torch.tensor(ref["steps"]), rel=TOL, abs=TOL)
        for name, value in ref["params"].items():
            torch.testing.assert_close(got["params"][name], value, rtol=TOL,
                                       atol=TOL, msg=name)
    for name, value in ranks[0]["params"].items():
        assert torch.equal(ranks[1]["params"][name], value), name


@pytest.mark.parametrize("dispatch,capacity", [
    ("grouped", "1.25"), ("grouped", "0.5"), ("dense", "1.25")])
def test_a_two_rank_moe_gang_routes_the_global_batch(dispatch, capacity):
    argv = train_argv("--num_experts", "4", "--seq_len", "32",
                      "--moe_dispatch", dispatch, "--moe_capacity_factor",
                      capacity)
    ranks = spawn_gang(train_rank, 2, argv)
    ref = one_process(argv, data_groups=2)
    _check(ranks, ref)
    if capacity == "0.5":
        assert all(step[2] > 0.1 for step in ref["steps"])  # experts overflow


def test_an_moe_seq_gang_counts_places_across_the_sequence_shards():
    """Two ranks holding the two halves of each row (ring attention): a
    token's place in its expert's bucket counts the earlier rows of both
    ranks and its own row's first half."""
    argv = train_argv("--num_experts", "4", "--seq_len", "64",
                      "--moe_capacity_factor", "0.5", "--attention", "ring",
                      "--seq_parallel", "2")
    ranks = spawn_gang(train_rank, 2, argv)
    assert [(r["data"], r["seq"]) for r in ranks] == [(0, 0), (0, 1)]
    _check(ranks, one_process(argv, data_groups=1, seq_places=2))


def test_a_four_rank_moe_gang_over_data_and_seq():
    argv = train_argv("--num_experts", "4", "--seq_len", "64",
                      "--moe_capacity_factor", "0.75", "--attention",
                      "ulysses", "--seq_parallel", "2")
    ranks = spawn_gang(train_rank, 4, argv)
    ref = one_process(argv, data_groups=2, seq_places=2)
    for got in ranks:
        assert torch.tensor(got["steps"]) == pytest.approx(
            torch.tensor(ref["steps"]), rel=TOL, abs=TOL)
        for name, value in ref["params"].items():
            torch.testing.assert_close(got["params"][name], value, rtol=TOL,
                                       atol=TOL, msg=name)
