"""Line-rate ingest soak: a fleet of submitter processes driving the
SubmitJobs front door, with the serving contract held at rate.

    python -m shockwave_tpu_torch.tools.ingest_soak            # the campaign; pricing on the card
    python -m shockwave_tpu_torch.tools.ingest_soak --smoke --device cpu

The port's counterpart of the JAX package's ``scripts/ingest_soak.py``
(``--smoke`` is ``scripts/ci/ingest_smoke.py``: the decode-parity gate,
then 2 hosts of 1500 jobs, batch 64, window 8, 3 faults, a 4000 jobs/s
floor and a 50 ms p99, 6 pricing lanes, 1 rep).

The parent runs an ingest plane: the port's ``scheduler_server.serve``
handler on its socket transport (``runtime/rpc/wiring.py``), the columnar
decode of ``runtime/protobuf/fastwire.py`` and ``_SubmitCoalescer``, which
commits concurrent frames through one ``submit_many``, over an
``AdmissionQueue`` drained every ``--tick-s`` into a counting sink.
``--hosts`` x ``--workers`` child interpreters each open one
``SubmitterClient`` and push their jobs through ``submit_pipelined``
(``--window`` calls in flight) under a seeded client-side chaos plan
(pre-send ``rpc_error``, lost-response ``rpc_drop``, ``rpc_delay``), so
retransmits reach the token ledger. With mixed peers (the default for
more than one host) odd hosts speak the legacy encoding
(``SHOCKWAVE_WIRE_COLUMNAR=0``). The children import neither torch nor
JAX, and clear a start gate together, so neither import time nor spawn
skew lands in the fleet span the rate divides by.

Each of ``--reps`` repetitions (a fresh server, queue and ledger) must
hold the contract, and the best one's rate must reach ``--min-rate``:

- exactly once under chaos: every token's jobs drain once, no job lost
  or admitted twice (the sink's counts against the submitters' manifests,
  the queue's stats, final depth 0), and every injected fault recovered;
- the p99 admission-queue latency (enqueue to drain, from the metrics
  registry's buckets, ``obs.metrics.quantile_from_buckets``) within
  ``--p99-budget-ms``;
- both peer kinds move jobs;
- pricing amortises over lanes: ``--pricing-lanes`` threads racing
  ``PricingCollector.price`` take fewer ``price_batch`` dispatches than
  calls, each a grid of kernel A's lanes on ``--device``, and one
  ``audit=True`` dispatch is bit-identical lane for lane.

The floors (60000 jobs/s and 150 ms at full scale; 4000 jobs/s and 50 ms
for ``--smoke``) are the JAX package's defaults. Writes
``<result_name>`` and each worker's manifest under ``--out``; exits 1 on
any violation.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

MODELS = [("ResNet-18", 32), ("ResNet-50", 64)]
# scripts/ci/ingest_smoke.py's campaign (legacy peers take the columnar
# share: the hardest 50/50 mix).
SMOKE = {"result_name": "ingest_smoke.json", "hosts": 2, "mixed_peers": True,
         "workers": 1, "jobs_per_worker": 1500, "reps": 1,
         "legacy_jobs_per_worker": None, "batch_size": 64, "window": 8,
         "tick_s": 0.005, "chaos": 3, "seed": 0, "min_rate": 4000.0,
         "p99_budget_ms": 50.0, "pricing_lanes": 6}


# -- the decode-parity gate ----------------------------------------------


def parity_requests(num_batches: int = 24, jobs_per_batch: int = 16):
    """``scripts/ci/ingest_smoke.py``'s requests: seeded specs, an invalid
    job type and a zero step count poisoning some batches, and repeated
    tokens that reach the dedup ledger."""
    rng = np.random.default_rng(7)
    requests = []
    for k in range(num_batches):
        specs = []
        for i in range(jobs_per_batch):
            specs.append({
                "job_type": "ResNet-18 (batch size 32)",
                "command": "python3 main.py",
                "total_steps": int(rng.integers(1, 500)),
                "scale_factor": int(rng.integers(1, 4)),
                "mode": "static" if i % 2 else "",
                "priority_weight": float(i % 3),
                "slo": 2.5 if i % 4 == 0 else 0.0,
                "tenant": f"t{i % 2}",
            })
        if k % 6 == 3:  # one bad job poisons the batch: an INVALID ack
            specs[jobs_per_batch // 2]["job_type"] = "not a job type"
        if k % 6 == 4:
            specs[jobs_per_batch // 2]["total_steps"] = 0
        token = f"parity-{k - 1 if k % 5 == 4 else k}"
        requests.append((token, specs))
    return requests


def scalar_request(token, specs):
    """The legacy per-message decode of a request's bytes."""
    from shockwave_tpu_torch.runtime.protobuf import admission_pb2 as adm_pb2

    return adm_pb2.SubmitJobsRequest.FromString(adm_pb2.SubmitJobsRequest(
        token=token, jobs=[adm_pb2.JobSpec(**s) for s in specs],
    ).SerializeToString())


def columnar_request(token, specs):
    """The columnar decode of a negotiated columnar frame."""
    from shockwave_tpu_torch.runtime.protobuf import admission_pb2 as adm_pb2
    from shockwave_tpu_torch.runtime.protobuf import fastwire

    return fastwire.FastSubmitRequest.FromString(adm_pb2.SubmitJobsRequest(
        token=token, jobs_columnar=fastwire.encode_columnar_block(specs),
        wire_caps=fastwire.CAP_COLUMNAR,
    ).SerializeToString())


def drive_handler(requests, decoder):
    """The requests through ``_admission_handlers``' SubmitJobs over a
    fresh queue: (each ack's bytes with ``wire_caps`` masked, the drained
    (token, job) pairs). The caps echo is present exactly when the request
    advertised the columnar capability, the one byte difference the two
    decodes may show."""
    from shockwave_tpu_torch.runtime import admission
    from shockwave_tpu_torch.runtime.rpc.scheduler_server import (
        _admission_handlers,
    )

    queue = admission.build_queue(capacity=4096, retry_delay_s=0.05)

    def submit_jobs_many(reqs):
        outs = queue.submit_many(reqs)
        depth = queue.depth()
        return [(s, r, a, depth) for (s, r, a) in outs]

    handler = _admission_handlers(
        {"submit_jobs_many": submit_jobs_many})["SubmitJobs"]
    acks = []
    for token, specs in requests:
        ack = handler(decoder(token, specs), None)
        ack.wire_caps = 0
        acks.append(ack.SerializeToString())
    return acks, [(token, job) for token, job, _enq in queue.drain()]


def parity_check(num_batches: int = 24, jobs_per_batch: int = 16) -> int:
    """The scalar and the columnar decode through the handler: byte-equal
    acks and equal drained jobs, or 1."""
    requests = parity_requests(num_batches, jobs_per_batch)
    scalar_acks, scalar_jobs = drive_handler(requests, scalar_request)
    columnar_acks, columnar_jobs = drive_handler(requests, columnar_request)
    for k, (a, b) in enumerate(zip(scalar_acks, columnar_acks)):
        if a != b:
            print(f"PARITY VIOLATION: ack {k} differs (scalar={a!r} "
                  f"columnar={b!r})", file=sys.stderr)
            return 1
    if scalar_jobs != columnar_jobs:
        print("PARITY VIOLATION: drained jobs differ between decode paths",
              file=sys.stderr)
        return 1
    print(f"parity: {len(requests)} batches byte-identical acks, "
          f"{len(scalar_jobs)} drained jobs identical across decoders",
          flush=True)
    return 0


# -- a child: one submitter of the fleet -----------------------------------


def submitter_main(worker_id: int, port: int, num_jobs: int, batch_size: int,
                   window: int, seed: int, chaos: int, out_path: str,
                   host_id: int = 0, wire_mode: str = "columnar",
                   start_gate=None) -> None:
    """Runs in a spawned child: ``num_jobs`` jobs through
    ``submit_pipelined`` under a seeded chaos plan, then a manifest
    (token -> expected job count, timings, the fault summary) for the
    parent's exactly-once accounting. ``wire_mode`` "legacy" turns the
    columnar capability off on the client."""
    os.environ["SHOCKWAVE_WIRE_COLUMNAR"] = (
        "0" if wire_mode == "legacy" else "1")
    from shockwave_tpu_torch.data.workload_info import steps_per_epoch
    from shockwave_tpu_torch.runtime import faults
    from shockwave_tpu_torch.runtime.rpc.submitter_client import (
        SubmitterClient,
    )
    from shockwave_tpu_torch.utils.fileio import atomic_write_json

    rng = np.random.default_rng(seed + worker_id)
    events = []
    for i in range(chaos):
        kind = ("rpc_error", "rpc_drop", "rpc_delay")[i % 3]
        events.append(faults.FaultEvent(
            i, kind, method="SubmitJobs",
            delay_s=0.02 if kind == "rpc_delay" else 0.0))
    injector = faults.configure(
        faults.FaultPlan(seed=seed + worker_id, events=events))
    # Wire-shaped spec dicts: a line-rate submitter feeds the client the
    # wire shape directly.
    jobs = []
    for _ in range(num_jobs):
        model, bs = MODELS[int(rng.integers(len(MODELS)))]
        jobs.append({"job_type": f"{model} (batch size {bs})",
                     "command": "python3 main.py",
                     "total_steps": steps_per_epoch(model, bs),
                     "scale_factor": 1, "mode": "static"})
    client = SubmitterClient("127.0.0.1", port,
                             client_id=f"soak-h{host_id}w{worker_id}")
    if start_gate is not None:
        start_gate.wait()
    t0, cpu0 = time.monotonic(), time.process_time()
    tokens = client.submit_pipelined(jobs, batch_size=batch_size,
                                     window=window, close=False)
    t1, cpu1 = time.monotonic(), time.process_time()
    client.close()
    expected = {token: len(jobs[i * batch_size:(i + 1) * batch_size])
                for i, token in enumerate(tokens)}
    summary = injector.summary()
    atomic_write_json(out_path, {
        "worker_id": worker_id,
        "host_id": host_id,
        "wire_mode": wire_mode,
        "expected": expected,
        "jobs": num_jobs,
        "submit_s": round(t1 - t0, 4),
        "submit_cpu_s": round(cpu1 - cpu0, 4),
        "start_s": t0,
        "end_s": t1,
        "faults_applied": summary["applied"],
        "faults_unrecovered": summary["unrecovered"],
    })


class _StdinGate:
    """The fleet's start gate in a child: says it is ready on stdout and
    waits for the parent's word on stdin."""

    @staticmethod
    def wait() -> None:
        sys.stdout.write("ready\n")
        sys.stdout.flush()
        sys.stdin.readline()


def _submitter_child(arguments: str) -> None:
    """A child's entry (``python -c``): ``submitter_main`` on the JSON list
    of its arguments, behind the stdin gate."""
    submitter_main(*json.loads(arguments), start_gate=_StdinGate())


def _start_submitter(*arguments) -> subprocess.Popen:
    """One submitter as a fresh interpreter that imports this module and
    what the submitter needs, not the parent's main module (``spawn``
    would run it again in the child, with its torch)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    code = ("import sys; from shockwave_tpu_torch.tools import ingest_soak; "
            "ingest_soak._submitter_child(sys.argv[1])")
    return subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(list(arguments))], cwd=root,
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


# -- the parent: ingest plane, accounting, pricing -------------------------


def _pricing_market(num_jobs: int = 6, num_gpus: int = 2):
    """A saturated EG market (every incumbent wants the whole window):
    any burst priced against it moves real welfare."""
    from shockwave_tpu_torch.solver.eg_problem import EGProblem

    return EGProblem(
        priorities=np.ones(num_jobs),
        completed_epochs=np.full(num_jobs, 2.0),
        total_epochs=np.full(num_jobs, 20.0),
        epoch_duration=np.full(num_jobs, 60.0),
        remaining_runtime=np.full(num_jobs, 18 * 60.0),
        nworkers=np.ones(num_jobs),
        num_gpus=num_gpus,
        round_duration=120.0,
        future_rounds=8,
        regularizer=1e-3,
        log_bases=np.linspace(0.0, 1.0, num_jobs),
        switch_cost=np.zeros(num_jobs),
        incumbent=np.ones(num_jobs),
    )


def run_pricing_phase(num_lanes: int, device: str = "cuda") -> dict:
    """``num_lanes`` threads race ``PricingCollector.price``, which must
    convoy them into fewer dispatches (each one launch of kernel A's lane
    grid on ``device``); then one ``audit=True`` dispatch must be
    bit-identical to each lane's own solve."""
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.whatif.pricing import (
        AdmissionPricer,
        PricingCollector,
    )

    holder = {"problem": _pricing_market(), "s0": None}
    dispatches = []

    class _CountingPricer(AdmissionPricer):
        def price_batch(self, bursts, audit=False):
            dispatches.append(len(bursts))
            return super().price_batch(bursts, audit=audit)

    pricer = _CountingPricer(lambda: holder, threshold=float("inf"),
                             budget_s=600.0, device=device)
    collector = PricingCollector(pricer, max_lanes=32)

    def burst(n):
        return [Job(job_type="ResNet-18 (batch size 32)", command="x",
                    total_steps=100, scale_factor=2, mode="static",
                    duration=4000.0) for _ in range(n)]

    from shockwave_tpu_torch.ops import eg_pdhg

    launched = eg_pdhg.LAUNCHES["eg_pdhg"]
    results = {}
    barrier = threading.Barrier(num_lanes)

    def caller(k):
        barrier.wait()
        results[k] = collector.price(burst(1 + k % 3))

    threads = [threading.Thread(target=caller, args=(k,))
               for k in range(num_lanes)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    convoy_s = time.monotonic() - t0
    audit_t0 = time.monotonic()
    pricer.price_batch([burst(2), burst(4), burst(1)], audit=True)
    return {
        "lanes_priced": num_lanes,
        "decisions": sorted({d.action for d in results.values()}),
        "dispatches": len(dispatches),
        "max_convoy": max(dispatches) if dispatches else 0,
        "convoy_s": round(convoy_s, 3),
        "audit": dict(pricer.last_batch_audit),
        "audit_s": round(time.monotonic() - audit_t0, 3),
        "device": device,
        # Kernel A's launches (on the card): the dispatches and the audit.
        "kernel_a_launches": eg_pdhg.LAUNCHES["eg_pdhg"] - launched,
    }


def _wire_modes(args) -> list:
    """Each submitter's encoding: odd hosts legacy under mixed peers."""
    modes = []
    for w in range(args.hosts * args.workers):
        host = w // args.workers
        legacy = args.mixed_peers and args.hosts > 1 and host % 2 == 1
        modes.append("legacy" if legacy else "columnar")
    return modes


def run_rep(args, rep: int) -> dict:
    """One repetition: a fresh ingest plane (server, queue, ledger,
    metrics registry), the fleet, and the accounting. The chaos seed
    shifts with the rep."""
    from shockwave_tpu_torch import obs
    from shockwave_tpu_torch.obs.metrics import quantile_from_buckets
    from shockwave_tpu_torch.runtime import admission
    from shockwave_tpu_torch.runtime.rpc import scheduler_server
    from shockwave_tpu_torch.runtime.testing import free_port

    obs.reset()
    obs.configure(metrics=True)
    # No group commit inside the queue: the handler's coalescer already
    # convoys concurrent frames into one submit_many.
    queue = admission.build_queue(capacity=args.capacity, retry_delay_s=0.05,
                                  group_commit=False)

    def submit_jobs_many(requests):
        outs = queue.submit_many(requests)
        depth = queue.depth()
        return [(s, r, a, depth) for (s, r, a) in outs]

    port = free_port()
    server = scheduler_server.serve(port,
                                    {"submit_jobs_many": submit_jobs_many})
    admitted: dict = {}
    stop = threading.Event()

    def drain_loop():
        while not stop.is_set():
            stop.wait(args.tick_s)
            for token, _job, _enq in queue.drain():
                admitted[token] = admitted.get(token, 0) + 1

    drainer = threading.Thread(target=drain_loop, name="ingest-soak-drain",
                               daemon=True)
    drainer.start()

    stem = f"{os.path.splitext(args.result_name)[0]}_rep{rep}"
    modes = _wire_modes(args)
    manifests = [os.path.join(args.out, f"{stem}_worker_{w}.json")
                 for w in range(len(modes))]
    legacy_jobs = (args.legacy_jobs_per_worker
                   if args.legacy_jobs_per_worker is not None
                   else args.jobs_per_worker)
    procs = [_start_submitter(
        w, port, legacy_jobs if modes[w] == "legacy" else args.jobs_per_worker,
        args.batch_size, args.window, args.seed + 997 * rep, args.chaos,
        manifests[w], w // args.workers, modes[w])
        for w in range(len(modes))]
    wall_t0 = time.monotonic()
    try:
        # The start gate: every child has imported and built its jobs.
        for proc in procs:
            proc.stdout.readline()
        server_cpu0 = time.process_time()
        for proc in procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        for proc in procs:
            proc.wait(timeout=600)
        server_cpu_s = time.process_time() - server_cpu0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failures = [p.returncode for p in procs if p.returncode != 0]
    deadline = time.monotonic() + 10.0
    while queue.depth() and time.monotonic() < deadline:
        time.sleep(args.tick_s)
    stop.set()
    drainer.join(timeout=5)
    for token, _job, _enq in queue.drain():
        admitted[token] = admitted.get(token, 0) + 1
    server.stop(0)

    expected: dict = {}
    fault_applied = 0
    unrecovered = []
    spans = []
    submit_cpu = []
    by_mode: dict = {}
    for path in manifests:
        if not os.path.exists(path):
            continue  # its process failed, and says so above
        with open(path) as f:
            m = json.load(f)
        expected.update(m["expected"])
        fault_applied += m["faults_applied"]
        unrecovered.extend(m["faults_unrecovered"])
        spans.append((m["start_s"], m["end_s"]))
        agg = by_mode.setdefault(m["wire_mode"],
                                 {"submitters": 0, "jobs": 0, "submit_s": 0.0})
        agg["submitters"] += 1
        agg["jobs"] += m["jobs"]
        agg["submit_s"] += m["submit_s"]
        submit_cpu.append(m["submit_cpu_s"])
    lost = {t: n for t, n in expected.items() if admitted.get(t, 0) < n}
    double = {t: (expected.get(t, 0), n) for t, n in admitted.items()
              if n != expected.get(t, 0)}
    total_jobs = sum(expected.values())
    # The fleet's rate: the first byte offered to the last response.
    fleet_span_s = (max(e for _, e in spans) - min(s for s, _ in spans)
                    if spans else 0.0)
    rate = total_jobs / max(fleet_span_s, 1e-9)

    snap = obs.get_registry().snapshot()["metrics"]
    latency = snap.get("admission_queue_latency_seconds")
    p50_ms = p99_ms = None
    observed = 0
    if latency and latency["series"]:
        series = latency["series"][0]
        observed = int(series["count"])
        p50, _ = quantile_from_buckets(series["buckets"], 0.5, series["max"])
        p99, _ = quantile_from_buckets(series["buckets"], 0.99, series["max"])
        p50_ms = 1e3 * p50 if p50 is not None else None
        p99_ms = 1e3 * p99 if p99 is not None else None
    stats = queue.summary()
    interop = {mode: {"submitters": agg["submitters"], "jobs": agg["jobs"],
                      "jobs_per_s_per_submitter": round(
                          agg["jobs"] / max(agg["submit_s"], 1e-9), 1)}
               for mode, agg in sorted(by_mode.items())}
    return {
        "rep": rep,
        "total_jobs": total_jobs,
        "fleet_span_s": round(fleet_span_s, 4),
        "submits_per_s": round(rate, 1),
        "wall_s": round(time.monotonic() - wall_t0, 3),
        # CPU seconds of the server's process and of each submitter over
        # the fleet's run: which side the span waits for.
        "server_cpu_s": round(server_cpu_s, 3),
        "submitter_cpu_s": submit_cpu,
        "admitted_observed": observed,
        "queue_p50_ms": round(p50_ms, 3) if p50_ms is not None else None,
        "queue_p99_ms": round(p99_ms, 3) if p99_ms is not None else None,
        "lost": lost,
        "double_admitted": double,
        "deduped_batches": stats["deduped_batches"],
        "faults_applied": fault_applied,
        "faults_unrecovered": unrecovered,
        "interop": interop,
        "admission_summary": stats,
        "process_failures": failures,
        "queue_depth_end": queue.depth(),
        "legacy_jobs_per_worker": legacy_jobs,
    }


def violations_of(args, reps: list, pricing: dict) -> list:
    """Every broken term of the contract (empty when it held)."""
    violations = []
    for r in reps:
        tag = f"rep {r['rep']}: "
        if r["process_failures"]:
            violations.append(tag + "submitter process failed: "
                              f"{r['process_failures']}")
        for mode in sorted(set(_wire_modes(args))):
            if r["interop"].get(mode, {}).get("jobs", 0) <= 0:
                violations.append(tag + f"{mode} peers moved zero jobs")
        if r["lost"]:
            violations.append(tag + f"LOST jobs: {len(r['lost'])} tokens "
                              "short")
        if r["double_admitted"]:
            violations.append(tag + "DOUBLE-ADMITTED jobs: "
                              f"{len(r['double_admitted'])} tokens off")
        if r["queue_depth_end"]:
            violations.append(tag + "queue not drained: "
                              f"depth={r['queue_depth_end']}")
        if r["faults_unrecovered"]:
            violations.append(tag + "unrecovered faults: "
                              f"{r['faults_unrecovered']}")
        if args.chaos and r["faults_applied"] == 0:
            violations.append(tag + "chaos plan never fired")
        if r["queue_p99_ms"] is None:
            violations.append(tag + "no admission latency observed")
        elif r["queue_p99_ms"] > args.p99_budget_ms:
            violations.append(tag + f"p99 admission latency "
                              f"{r['queue_p99_ms']:.1f}ms over the "
                              f"{args.p99_budget_ms:.0f}ms budget")
    best = max(reps, key=lambda r: r["submits_per_s"])
    if best["submits_per_s"] < args.min_rate:
        violations.append(f"best sustained rate {best['submits_per_s']:.0f}/s "
                          f"across {len(reps)} reps under the "
                          f"{args.min_rate:.0f}/s floor")
    if not pricing["audit"].get("bit_identical"):
        violations.append("pricing lane audit not bit-identical: "
                          f"{pricing['audit']}")
    if pricing["dispatches"] >= pricing["lanes_priced"]:
        violations.append(f"pricing convoy never amortized: "
                          f"{pricing['dispatches']} dispatches for "
                          f"{pricing['lanes_priced']} lanes")
    return violations


def run_campaign(args) -> dict:
    """Every rep and the pricing phase; returns the result (its
    ``violations`` empty when the contract held)."""
    os.makedirs(args.out, exist_ok=True)
    reps = []
    for rep in range(max(1, args.reps)):
        r = run_rep(args, rep)
        reps.append(r)
        print(f"rep {rep}: {r['total_jobs']} jobs at "
              f"{r['submits_per_s']:.0f}/s, p99 {r['queue_p99_ms']}ms, "
              f"per peer {r['interop']}", flush=True)
    best = max(reps, key=lambda r: r["submits_per_s"])
    pricing = run_pricing_phase(args.pricing_lanes, args.device)
    return {
        "config": {
            "hosts": args.hosts,
            "workers": args.workers,
            "mixed_peers": bool(args.mixed_peers),
            "jobs_per_worker": args.jobs_per_worker,
            "legacy_jobs_per_worker": best["legacy_jobs_per_worker"],
            "batch_size": args.batch_size,
            "window": args.window,
            "capacity": args.capacity,
            "tick_s": args.tick_s,
            "chaos_per_worker": args.chaos,
            "seed": args.seed,
            "reps": len(reps),
            "min_rate": args.min_rate,
            "p99_budget_ms": args.p99_budget_ms,
            "device": args.device,
            "cpu_count": os.cpu_count(),
        },
        "throughput": {
            "total_jobs": best["total_jobs"],
            "fleet_span_s": best["fleet_span_s"],
            "submits_per_s": best["submits_per_s"],
            "best_rep": best["rep"],
            "per_rep_submits_per_s": [r["submits_per_s"] for r in reps],
            "per_rep_server_cpu_s": [r["server_cpu_s"] for r in reps],
            "per_rep_submitter_cpu_s": [r["submitter_cpu_s"] for r in reps],
            "wall_s": round(sum(r["wall_s"] for r in reps), 3),
        },
        "latency": {
            "admitted_observed": best["admitted_observed"],
            "queue_p50_ms": best["queue_p50_ms"],
            "queue_p99_ms": best["queue_p99_ms"],
            "per_rep_queue_p99_ms": [r["queue_p99_ms"] for r in reps],
        },
        "exactly_once": {
            "lost": {t: n for r in reps for t, n in r["lost"].items()},
            "double_admitted": {t: v for r in reps
                                for t, v in r["double_admitted"].items()},
            "deduped_batches": sum(r["deduped_batches"] for r in reps),
            "faults_applied": sum(r["faults_applied"] for r in reps),
            "faults_unrecovered": [f for r in reps
                                   for f in r["faults_unrecovered"]],
        },
        "interop": best["interop"],
        "pricing": pricing,
        "admission_summary": best["admission_summary"],
        "violations": violations_of(args, reps, pricing),
    }


def main(args) -> int:
    from shockwave_tpu_torch.utils.fileio import atomic_write_json

    if args.smoke:
        rc = parity_check()
        if rc:
            return rc
        for key, value in SMOKE.items():
            setattr(args, key, value)
    result = run_campaign(args)
    out_json = os.path.join(args.out, args.result_name)
    atomic_write_json(out_json, result)
    print(json.dumps(result["throughput"] | result["latency"]))
    if result["violations"]:
        for v in result["violations"]:
            print(f"VIOLATION: {v}", file=sys.stderr)
        return 1
    print(f"OK: {result['throughput']['total_jobs']} jobs at "
          f"{result['throughput']['submits_per_s']:.0f}/s (best of "
          f"{result['config']['reps']} reps), p99 "
          f"{result['latency']['queue_p99_ms']:.1f}ms, exactly-once held "
          f"under {result['exactly_once']['faults_applied']} injected faults "
          f"-> {out_json}")
    return 0


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=str, default="results/ingest_torch")
    parser.add_argument("--result_name", type=str, default="ingest_soak.json")
    parser.add_argument(
        "--hosts", type=int, default=2,
        help="submit hosts; submitter processes = hosts * workers, odd "
        "hosts speak the legacy encoding under --mixed-peers (the default)")
    parser.add_argument("--mixed-peers", dest="mixed_peers",
                        action="store_true", default=True)
    parser.add_argument("--no-mixed-peers", dest="mixed_peers",
                        action="store_false")
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--jobs-per-worker", type=int, default=245760)
    parser.add_argument(
        "--legacy-jobs-per-worker", type=int, default=16384,
        help="jobs a legacy submitter pushes (default: a 1/16 share of the "
        "columnar default, a mostly upgraded fleet)")
    parser.add_argument("--batch-size", type=int, default=1536)
    parser.add_argument("--window", type=int, default=6)
    parser.add_argument("--capacity", type=int, default=131072)
    parser.add_argument("--tick-s", type=float, default=0.005)
    parser.add_argument("--chaos", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--reps", type=int, default=3,
        help="repetitions: the contract must hold in each, and the best "
        "one's rate must reach --min-rate")
    parser.add_argument("--min-rate", type=float, default=60000.0)
    parser.add_argument("--p99-budget-ms", type=float, default=150.0)
    parser.add_argument("--pricing-lanes", type=int, default=8)
    parser.add_argument(
        "--smoke", action="store_true",
        help="the decode-parity gate, then the reduced campaign: 2 hosts "
        "of 1500 jobs, batch 64, window 8, 3 faults, 4000 jobs/s, 50 ms, "
        "6 pricing lanes, 1 rep")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the pricing phase's kernel A runs")
    return parser


if __name__ == "__main__":
    raise SystemExit(main(build_parser().parse_args()))
