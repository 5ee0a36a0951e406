"""The port's physical drivers (``tools/physical_drivers.py``, ``python -m
shockwave_tpu_torch.run_physical --driver card|localhost``) against the
JAX package's ``scripts/drivers/``: the jobs' localization, the phase
report and the overheads it feeds, on the same trace and PHASES text; and
the card driver's loop on the CPU with an ``h100`` agent, a singleton and
a gang whose ranks train over gloo."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest

from shockwave_tpu.core.job import Job as JaxJob
from shockwave_tpu.data import parse_trace as jax_parse_trace
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.data import parse_trace
from shockwave_tpu_torch.tools import physical_drivers as drivers

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = str(ROOT / "traces" / "small_12_dynamic.trace")


def _jax_driver(name):
    sys.path.insert(0, str(ROOT))
    path = ROOT / "scripts" / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _oracle(worker_type, jobs):
    """One rate a job type of ``jobs`` (steps/s), every scale factor."""
    rates = {}
    for i, job in enumerate(jobs):
        rates.setdefault(job.job_type, 3.0 + 7.0 * i)
    return {worker_type: {(jt, sf): {"null": rate * sf}
                          for jt, rate in rates.items()
                          for sf in (1, 2, 4, 8)}}


def _model_and_batch(command):
    words = command.split()
    return (words[words.index("--model") + 1],
            int(words[words.index("--batch_size") + 1]))


@pytest.mark.parametrize("train_s", [60.0, 7.5])
def test_card_localization_matches_the_jax_driver(train_s):
    """Every golden-trace job gets the JAX card driver's steps, batch and
    family; a gang's ranks train on the host's CPU (the command says so),
    a singleton on the card."""
    tpu = _jax_driver("run_physical_tpu")
    jax_jobs, _ = jax_parse_trace(GOLDEN)
    jobs, _ = parse_trace(GOLDEN)
    tpu.localize_jobs(jax_jobs, _oracle(tpu.WORKER_TYPE, jax_jobs), train_s)
    drivers.localize_jobs(jobs, _oracle("h100", jobs), train_s,
                          payload_args="--seed 3")
    assert drivers.GANG_CPU_BATCH == tpu.GANG_CPU_BATCH
    assert drivers.GANG_STEPS == tpu.GANG_STEPS
    gangs = 0
    for ours, theirs in zip(jobs, jax_jobs):
        assert ours.total_steps == theirs.total_steps
        assert (ours.num_steps_arg, ours.mode) == (theirs.num_steps_arg,
                                                  theirs.mode)
        assert ours.working_directory is theirs.working_directory is None
        assert ours.needs_data_dir is theirs.needs_data_dir is False
        assert _model_and_batch(ours.command) == _model_and_batch(
            theirs.command)
        assert "-m shockwave_tpu_torch.models.train" in ours.command
        if ours.scale_factor > 1:
            gangs += 1
            assert "JAX_PLATFORMS=cpu" in theirs.command
            assert ours.command.endswith("--gang_device cpu")
        else:
            assert ours.command.endswith("--seed 3")
    assert gangs == 3


def test_card_localization_raises_as_the_jax_driver():
    tpu = _jax_driver("run_physical_tpu")
    for make, localize, worker in (
            (JaxJob, tpu.localize_jobs, tpu.WORKER_TYPE),
            (Job, drivers.localize_jobs, "h100")):
        bad = make(job_type="ResNet-18", command="x", total_steps=1)
        with pytest.raises(ValueError, match="does not match"):
            localize([bad], {worker: {}}, 60.0)
        missing = make(job_type="LM (batch size 7)", command="x",
                       total_steps=1)
        with pytest.raises(ValueError, match="measured oracle has no"):
            localize([missing], {worker: {}}, 60.0)


def test_localhost_localization_matches_the_jax_driver():
    local = _jax_driver("run_physical_localhost")
    jax_jobs, _ = jax_parse_trace(GOLDEN)
    jobs, _ = parse_trace(GOLDEN)
    local.localize_jobs(jax_jobs)
    drivers.localize_localhost_jobs(jobs)
    assert drivers.FAMILY_STEPS == local.FAMILY_STEPS
    for ours, theirs in zip(jobs, jax_jobs):
        assert ours.total_steps == theirs.total_steps
        assert _model_and_batch(ours.command) == _model_and_batch(
            theirs.command)


PHASES = {
    "job=0_worker=0_round=0.log.stdout":
        "PHASES build=3.2s restore=0.0s first_step_compile=1.1s "
        "train=9.9s save=0.4s\n[ResNet-18] steps=40 loss=2.1 "
        "throughput=4.00 steps/s device=cuda\n",
    "job=0_worker=0_round=2.log.stdout":
        "RESUMED from x at step 40\nPHASES build=2.8s restore=0.6s "
        "first_step_compile=0.9s train=10.2s save=0.5s\n[ResNet-18] "
        "steps=41 loss=2.0 throughput=4.00 steps/s device=cuda\n",
    "job=1_worker=0_round=1.log.stdout":
        "PHASES rendezvous=1.7s build=1.0s restore=0.0s "
        "first_step_compile=0.3s train=2.0s save=0.1s\n[LM] steps=2 "
        "loss=9.2 throughput=1.00 steps/s device=cpu\n",
    "job=2_worker=1_round=1.log.stdout": "a payload that printed nothing\n",
}


def test_phase_report_and_overheads_match_the_jax_driver(tmp_path):
    tpu = _jax_driver("run_physical_tpu")
    common = _jax_driver("physical_common")
    for name, text in PHASES.items():
        (tmp_path / name).write_text(text)
    report = drivers.collect_phase_report(str(tmp_path))
    assert report == tpu.collect_phase_report(str(tmp_path))
    assert report["ResNet-18"]["attempts"] == 2
    assert report["ResNet-18"]["build_mean_s"] == 3.0
    assert report["LM"]["rendezvous_mean_s"] == 1.7
    overheads = drivers.overheads_from_phase_report(report)
    assert overheads == common.overheads_from_phase_report(report)
    assert overheads == {"ResNet-18": 4.8, "LM": 3.1}


def test_run_physical_dispatches_the_driver_modes(capsys):
    from shockwave_tpu_torch import run_physical

    for driver in ("card", "localhost"):
        with pytest.raises(SystemExit) as e:
            run_physical.cli(["--driver", driver, "--help"])
        assert e.value.code == 0
        assert "--round_s" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_physical.cli(["--driver", "tpu"])


def _gang_payload_seconds() -> float:
    """The wall seconds of one process doing a gang rank's work on this
    host as it is loaded now: the ResNet-18 payload at the gang's CPU
    batch for its steps, start-up included."""
    import subprocess
    import time

    started = time.time()
    subprocess.run(
        [sys.executable, "-m", "shockwave_tpu_torch.models.train", "--model",
         "ResNet-18", "--batch_size",
         str(drivers.GANG_CPU_BATCH["ResNet-18"]), "-n",
         str(drivers.GANG_STEPS), "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), check=True,
        capture_output=True, timeout=600)
    return time.time() - started


def test_two_schedulers_on_one_host_give_a_gang_distinct_coordinators():
    """A gang's coordinator port differs across its job's attempts and
    between two schedulers on one host: with the reference's formula two
    card-driver runs at once gave job 1's gang one coordinator in the same
    round, and a rank of one run joined the other's gang (the next test
    then counted three ResNet-18 attempts, not two)."""
    from shockwave_tpu_torch.core.physical import PhysicalScheduler
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.policies import get_policy
    from shockwave_tpu_torch.runtime.testing import free_port

    scheds = [PhysicalScheduler(get_policy("fifo"), port=free_port(),
                                throughputs=generate_oracle())
              for _ in range(2)]
    try:
        first = [s._gang_port(1) for s in scheds]
        assert first[0] != first[1]
        scheds[0]._round_id += 1
        assert scheds[0]._gang_port(1) != first[0]
        assert all(10000 <= s._gang_port(j) < 50000 for s in scheds
                   for j in range(64))
    finally:
        for s in scheds:
            s.shutdown()


# A wall-clock run of real payloads (a few seconds a round).
@pytest.mark.wallclock_retry
def test_card_driver_runs_a_singleton_and_a_gang_on_the_cpu(tmp_path):
    """``run_physical --driver card --device cpu`` on a two-job trace: an
    ``h100`` agent (no spot price, no synthetic speed) with two slots, a
    Recommendation singleton sized from the oracle and a ResNet-18 gang
    whose two ranks train over gloo; both complete with their steps, and
    the summary carries the payloads' phase report, the gang's rendezvous
    included.

    The rounds follow the work: a gang's Done is both ranks' reports,
    merged when the later one lands within the round's completion wait
    (1.5 rounds). A rank's start-up and first step take 4-5 s on an idle
    host but 13 s and more when other test workers load it, which left the
    later rank's report outside 8 s rounds (the gang completed with one
    rank's steps). So a round is 1.6 times one process doing a rank's work
    on the host as it is loaded now, and at least 8 s."""
    from shockwave_tpu_torch import run_physical
    from shockwave_tpu_torch.data.throughputs import stringify_throughputs
    from shockwave_tpu_torch.data.trace import write_trace

    trace = tmp_path / "two.trace"
    jobs = [Job(job_type="Recommendation (batch size 512)", command="x",
                num_steps_arg="-n", total_steps=1000),
            Job(job_type="ResNet-18 (batch size 128)", command="x",
                num_steps_arg="-n", total_steps=1000, scale_factor=2)]
    write_trace(str(trace), jobs, [0.0, 0.0])
    oracle = tmp_path / "oracle.json"
    oracle.write_text(json.dumps(stringify_throughputs(
        {"h100": {("Recommendation (batch size 512)", 1): {"null": 40.0},
                  ("ResNet-18 (batch size 128)", 1): {"null": 10.0},
                  ("ResNet-18 (batch size 128)", 2): {"null": 18.4}}})))
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    round_s = max(8.0, 1.6 * _gang_payload_seconds())
    summary = run_physical.cli(
        ["--driver", "card", "--trace", str(trace), "--oracle", str(oracle),
         "--device", "cpu", "--policy", "shockwave_tpu", "--round_s",
         f"{round_s:.1f}",
         "--train_s", "4", "--time_scale", "1", "--max_rounds", "20",
         "--out", str(tmp_path / "out")])
    assert summary["worker_type"] == "h100"
    assert summary["completed_jobs"] == summary["total_jobs"] == 2
    assert summary["steps_run"] == {"0": 80, "1": 2 * drivers.GANG_STEPS}
    assert summary["worker_exit_code"] == 0 and not summary["timed_out"]
    report = summary["preemption_overhead_phases"]
    assert report["Recommendation"]["attempts"] >= 1
    assert report["ResNet-18"]["attempts"] == 2  # one a rank
    assert "rendezvous_mean_s" in report["ResNet-18"]
    out = tmp_path / "out" / "shockwave_tpu"
    for name in ("summary.json", "round_log.json", "timelines.json"):
        assert (out / name).exists()
    gang_logs = [p.read_text() for p in (out / "run").glob("job=1_*.stdout")]
    losses = {line for text in gang_logs for line in text.splitlines()
              if line.startswith("GANG ")}
    assert len(gang_logs) == 2 and all("device=cpu" in t for t in gang_logs)
    # Both ranks printed the same losses.
    assert len({line.split("losses=")[1] for line in losses}) == 1
