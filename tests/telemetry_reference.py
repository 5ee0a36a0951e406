"""The flight-recorder fixture run in both packages, and the comparisons
the telemetry tests share.

The run is the one ``results/flight_recorder/README.md`` records: the
12-job dynamic trace on 2 chips, 60 s rounds, seed 0, the level backend,
every plane on. The port runs in-process (``--device cpu``), the JAX
package in a subprocess on the CPU, as its own CLI. Each dump lands in a
directory of its own; the runs are made once per process.

Fields read from the wall clock differ between any two runs, of either
package, and are compared only for presence: a solve's ``seconds``, a
span's ``wall_s`` and its duration when the virtual clock did not advance
over it, the histograms of planning wall time, and the ``solver_time``
rule's readings.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

from shockwave_tpu_torch.tools.bench_sim import (  # noqa: F401 (shared)
    DETERMINISTIC_RULES,
    WALL_FAMILIES,
    fixture_pins,
    health_alerts,
    metric_differences,
)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "results" / "flight_recorder"
EXPLAIN = ROOT / "results" / "explain"
RUN_ARGS = ["-t", "traces/small_12_dynamic.trace", "-p",
            "shockwave_tpu_level", "-c", "2:0:0", "--seed", "0",
            "--time_per_iteration", "60"]
WALL_FIELDS = frozenset(("seconds", "wall_s"))
TRACE_IDS = frozenset(("trace_id", "span_id", "parent_span_id"))

_RUNS: dict = {}


def _dumps(out: Path) -> dict:
    return {"metrics": out / "metrics.json", "trace": out / "trace.json",
            "log": out / "decisions.jsonl"}


def _plane_args(paths: dict) -> list:
    return ["--metrics-out", str(paths["metrics"]), "--trace-out",
            str(paths["trace"]), "--decision-log", str(paths["log"]),
            "--watchdog"]


def port_run(base: Path) -> dict:
    """The port's fixture run (once per process); returns its dump paths
    and the CLI's result."""
    if "port" not in _RUNS:
        from shockwave_tpu_torch import simulate

        out = Path(base) / "port"
        out.mkdir(parents=True, exist_ok=True)
        paths = _dumps(out)
        cwd = os.getcwd()
        os.chdir(ROOT)
        try:
            result = simulate.main(RUN_ARGS + ["--device", "cpu",
                                               "--no_profile_cache"]
                                   + _plane_args(paths))
        finally:
            os.chdir(cwd)
        _RUNS["port"] = dict(paths, result=result)
    return _RUNS["port"]


def jax_run(base: Path) -> dict:
    """The JAX package's fixture run (once per process), through its CLI
    on the CPU; returns its dump paths."""
    if "jax" not in _RUNS:
        out = Path(base) / "jax"
        out.mkdir(parents=True, exist_ok=True)
        paths = _dumps(out)
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
        proc = subprocess.run(
            [sys.executable, "scripts/simulate.py", *RUN_ARGS,
             *_plane_args(paths)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        _RUNS["jax"] = dict(paths, stdout=proc.stdout)
    return _RUNS["jax"]


def records(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def without_wall(obj, present=None):
    """``obj`` with every wall-clock field dropped; their paths are added
    to ``present`` when it is given."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in WALL_FIELDS:
                if present is not None:
                    present.add(k)
                continue
            out[k] = without_wall(v, present)
        return out
    if isinstance(obj, list):
        return [without_wall(v, present) for v in obj]
    return obj


def trace_events(path) -> list:
    """A trace's events without the causal ids (random per run), the
    wall-clock readings and the wall-clock rule's alerts."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        e = dict(e)
        args = {k: v for k, v in e.get("args", {}).items()
                if k not in TRACE_IDS}
        if "wall_s" in args:
            args.pop("wall_s")
            e.pop("dur", None)
        if e.get("name") == "health" and args.get("rule") == "solver_time":
            continue
        if "args" in e:
            e["args"] = args
        out.append(e)
    return out


if __name__ == "__main__":
    # python tests/telemetry_reference.py capture OUT_DIR: the JAX
    # package's fixture run on the CPU, and its pins.
    import pprint
    import tempfile

    if sys.argv[1:2] != ["capture"]:
        raise SystemExit("usage: telemetry_reference.py capture [OUT_DIR]")
    out = Path(sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp())
    run = jax_run(out)
    pprint.pprint(fixture_pins(run["metrics"], run["trace"]), width=76)
