"""The port's leased iterator and dispatcher against the JAX package's.

``ShockwaveIterator`` runs in both packages against the same scripted
lease responses and clock: the steps taken, the lease requests, the
checkpoint calls and the structured log lines must be equal. Both
dispatchers build the same command from the same job dict (the port's
adds the worker's ``--device``, replacing one in the job's command) and
parse a progress log alike; the port's slot-to-card map and its device
rules are held on their own.
"""

import importlib
import re
import sys

import pytest

from shockwave_tpu_torch.runtime import dispatcher as port_dispatcher
from shockwave_tpu_torch.runtime.dispatcher import card_for_slot
from shockwave_tpu_torch.runtime.worker import Worker, resolve_cards

PKG = {"jax": "shockwave_tpu", "port": "shockwave_tpu_torch"}

# (max_steps, max_duration, extra_time) the fake scheduler answers: the
# first lease, then each refresh in turn.
SCRIPTS = {
    "duration_lease_extended_then_expires": [
        (10**9, 2.0, 0.0), (10**9, 2.0, 2.0), (10**9, 4.0, 0.0)],
    "step_agreement": [(10**9, 3.0, 0.0), (57, 3.0, 0.0)],
    "step_lease": [(40, 100.0, 0.0), (40, 100.0, 0.0), (55, 100.0, 0.0)],
    "unreachable_refresh": [(10**9, 2.0, 0.0), "raise", (10**9, 2.0, 0.0)],
}


class ScriptedClient:
    def __init__(self, answers, calls):
        self.answers = list(answers)
        self.calls = calls

    def _next(self):
        answer = self.answers.pop(0) if len(self.answers) > 1 else \
            self.answers[0]
        if answer == "raise":
            raise ConnectionError("scheduler unreachable")
        return answer

    def init(self):
        self.calls.append(("init",))
        return self._next()

    def update_lease(self, steps, duration, max_steps, max_duration):
        self.calls.append(("update", steps, round(duration, 6), max_steps,
                           round(max_duration, 6)))
        return self._next()


def run_iterator(package, script, tmp_path, monkeypatch, steps_wanted):
    pkg = PKG[package]
    iterator = importlib.import_module(f"{pkg}.runtime.iterator")
    client_mod = importlib.import_module(f"{pkg}.runtime.rpc.iterator_client")
    calls, saves = [], []
    answers = SCRIPTS[script]
    monkeypatch.setattr(client_mod, "IteratorRpcClient",
                        lambda *a: ScriptedClient(answers, calls))
    clock = {"t": 100.0}

    class Clock:
        @staticmethod
        def time():
            return clock["t"]

    monkeypatch.setattr(iterator, "time", Clock)
    log = tmp_path / f"{package}-{script}.log"
    monkeypatch.setenv("SHOCKWAVE_JOB_ID", "7")
    monkeypatch.setenv("SHOCKWAVE_WORKER_ID", "2")
    monkeypatch.setenv("SHOCKWAVE_ROUND_ID", "3")
    monkeypatch.setenv("SHOCKWAVE_SCHED_ADDR", "127.0.0.1")
    monkeypatch.setenv("SHOCKWAVE_SCHED_PORT", "1")
    monkeypatch.setenv("SHOCKWAVE_LOG_FILE", str(log))
    it = iterator.ShockwaveIterator(
        range(5), str(tmp_path), save_checkpoint_func=saves.append,
        barrier_fn=lambda: calls.append(("barrier",)))
    taken = []
    for batch in it:
        taken.append(batch)
        clock["t"] += 0.05
        if len(taken) >= steps_wanted:
            it.complete()
            break
    it.save_checkpoint("ckpt")
    lines = [re.sub(r"^\[[^]]*\] ", "", line)
             for line in log.read_text().splitlines()]
    return {"taken": taken, "calls": calls, "saves": saves, "lines": lines,
            "done": it.done}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("steps_wanted", [30, 1000])
def test_iterators_take_the_same_steps(script, steps_wanted, tmp_path,
                                       monkeypatch):
    ref = run_iterator("jax", script, tmp_path, monkeypatch, steps_wanted)
    port = run_iterator("port", script, tmp_path, monkeypatch, steps_wanted)
    assert port == ref
    assert ref["saves"] == ["ckpt"]
    assert any(line.startswith("[PROGRESS]") for line in ref["lines"])


def _job(command="python3 payload.py --lr 0.1", **extra):
    return {"job_id": 4, "job_type": "Transformer (batch size 16)",
            "command": command, "num_steps_arg": "-n", "num_steps": 120,
            "needs_data_dir": False, "working_directory": "", **extra}


def test_dispatchers_build_the_same_command(tmp_path):
    jax_dispatcher = importlib.import_module("shockwave_tpu.runtime.dispatcher")
    ref = jax_dispatcher.Dispatcher(
        10.0, [0, 1], None, "127.0.0.1", 1, str(tmp_path / "jr"),
        str(tmp_path / "jc"))
    for device, cards in (("cpu", None), ("cuda", [0])):
        port = port_dispatcher.Dispatcher(
            10.0, [0, 1], None, "127.0.0.1", 1, str(tmp_path / "pr"),
            str(tmp_path / "pc"), device=device, cards=cards)
        for job in (_job(), _job("python3 x.py %s/data", needs_data_dir=True)):
            want = ref._construct_command(job, "/ck")
            want = want.replace(str(tmp_path / "jr"), str(tmp_path / "pr"))
            assert port._construct_command(job, "/ck") == (
                f"{want} --device {device}")
        # A --device in the job's command gives way to the worker's.
        command = port._construct_command(
            _job("python3 t.py --device cuda --lr 1"), "/ck")
        assert command.count("--device") == 1
        assert command.endswith(f"--device {device}")


def test_dispatchers_parse_a_progress_log_alike(tmp_path):
    jax_dispatcher = importlib.import_module("shockwave_tpu.runtime.dispatcher")
    log = tmp_path / "job.log"
    log.write_text("[t] [LEASE] [INFO] max_steps=10\n"
                   "[t] [PROGRESS] [INFO] steps=12 duration=3.250000\n"
                   "[t] [PROGRESS] [INFO] steps=40 duration=9.500000\n")
    ref = jax_dispatcher.Dispatcher(1, [0], None, "a", 1, str(tmp_path / "a"),
                                    str(tmp_path / "b"))
    port = port_dispatcher.Dispatcher(1, [0], None, "a", 1,
                                      str(tmp_path / "c"), str(tmp_path / "d"),
                                      device="cpu")
    for path in (str(log), str(tmp_path / "missing.log")):
        assert (port._get_steps_and_execution_time(path)
                == ref._get_steps_and_execution_time(path))
    assert port._get_steps_and_execution_time(str(log))[:2] == (40, 9.5)
    assert port_dispatcher._PROGRESS_RE.pattern == \
        jax_dispatcher._PROGRESS_RE.pattern


def test_slots_map_onto_cards():
    assert [card_for_slot(s, [0]) for s in range(4)] == [0, 0, 0, 0]
    assert [card_for_slot(s, [0, 1]) for s in range(4)] == [0, 1, 0, 1]
    assert [card_for_slot(s, [2, 5, 7]) for s in range(4)] == [2, 5, 7, 2]
    with pytest.raises(ValueError):
        card_for_slot(0, [])


def test_the_payload_sees_its_slots_card(tmp_path):
    """The slot's card lands in the payload's CUDA_VISIBLE_DEVICES; a CPU
    worker's payloads see no card."""
    probe = (f"{sys.executable} -c \"import os; "
             "print('CARD=' + os.environ['CUDA_VISIBLE_DEVICES'])\"")
    for device, cards, slot, want in (("cuda", [0], 1, "0"),
                                      ("cuda", [3, 4], 1, "4"),
                                      ("cpu", None, 1, "")):
        d = port_dispatcher.Dispatcher(
            1, [0, 1], None, "127.0.0.1", 1, str(tmp_path / f"r{want}"),
            str(tmp_path / f"c{want}"), device=device, cards=cards)
        d._launch_job({"job_id": 9, "command": probe, "num_steps_arg": "-n",
                       "num_steps": 1}, slot, 0, 0)
        out = (tmp_path / f"r{want}" / "job=9_worker=0_round=0.log.stdout")
        assert f"CARD={want}\n" in out.read_text()


def test_device_rules():
    assert resolve_cards("cpu") == []
    with pytest.raises(ValueError):
        port_dispatcher.Dispatcher(1, [0], None, "a", 1, "/tmp/x", "/tmp/y",
                                   device="cuda", cards=[])
    import torch

    if not torch.cuda.is_available():
        # A cuda worker on a host without a card raises before it
        # registers anywhere.
        with pytest.raises(RuntimeError, match="no card"):
            resolve_cards("cuda")
        with pytest.raises(RuntimeError, match="no card"):
            Worker("v100", 1, "127.0.0.1", 1, 1, "/tmp/x", "/tmp/y")
