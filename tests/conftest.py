"""Test configuration.

Tiers (all green serially; wall-clock tests flake under parallel load):
  pytest -m "not slow"                             # unit tier, ~4 min
  pytest -m slow --ignore=tests/test_runtime.py \
         --ignore=tests/test_multihost.py          # compile-heavy, ~5.5 min
  pytest tests/test_runtime.py tests/test_multihost.py  # wall-clock, ~7 min
Run the wall-clock tier on an otherwise idle machine: its tests use real
rounds/leases and training subprocesses (see the slow marks).

Tests run on CPU with 8 virtual devices so multi-chip sharding logic is
exercised without TPU hardware. Must be set before JAX is imported; the
shared recipe lives in shockwave_tpu.utils.virtual_devices (also used by
__graft_entry__.dryrun_multichip's self-provisioning re-exec).
"""

from shockwave_tpu.utils.virtual_devices import force_cpu_device_env

force_cpu_device_env(8)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, (
    f"expected 8 virtual CPU devices, got {jax.devices()}"
)

# SHOCKWAVE_SANITIZE=threads (the races_smoke CI step): patch write
# tracking onto the lock-owning production classes the static
# shared-state-race pass identifies, BEFORE any test constructs them.
# No-op (and costs nothing) unless the env var names "threads".
from shockwave_tpu.analysis import sanitize as _sanitize  # noqa: E402

if _sanitize.enabled("threads"):
    _sanitize.instrument_for_threads()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running integration tier (subprocess / distributed / "
        "multi-round physical tests); deselect with -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the PyTorch port's CUDA "
        "kernels); skips where torch.cuda.is_available() is False",
    )
    config.addinivalue_line(
        "markers",
        "wallclock_retry(retries=2): bounded auto-retry for the "
        "wall-clock tier, whose tests drive real rounds/leases with "
        "short (seconds-long) rounds and are load-sensitive: under "
        "heavy background load a payload's process startup can eat a "
        "whole round and push a scenario past its failure caps. A "
        "retried flake is reported in the terminal summary; a "
        "deterministic failure still fails after the retries.",
    )


_WALLCLOCK_FLAKES = []

# The retry protocol below reaches into pytest private internals
# (item._initrequest(), _pytest.runner.runtestprotocol). Those were
# validated against these major versions; a different major must be
# re-validated (run the wall-clock tier, check retries reset fixtures
# and reports still land) and added here, NOT silently trusted — a
# behavior change in either API would corrupt retries quietly.
_VALIDATED_PYTEST_MAJORS = (8, 9)


def pytest_terminal_summary(terminalreporter):
    if _WALLCLOCK_FLAKES:
        terminalreporter.section("wallclock flakes (passed on retry)")
        for nodeid, attempts, longreprs in _WALLCLOCK_FLAKES:
            terminalreporter.line(f"{nodeid}: passed on attempt {attempts}")
            # The failed attempts' details would otherwise be discarded
            # with their reports — keep them so a flake's first failure
            # is diagnosable from the summary alone (ADVICE r05).
            for i, longrepr in enumerate(longreprs, start=1):
                terminalreporter.line(
                    f"  -- failed attempt {i} --"
                )
                for line in str(longrepr).splitlines():
                    terminalreporter.line(f"  {line}")


def pytest_runtest_protocol(item, nextitem):
    marker = item.get_closest_marker("wallclock_retry")
    if marker is None:
        return None
    import pytest as _pytest_mod

    major = _pytest_mod.version_tuple[0]
    if major not in _VALIDATED_PYTEST_MAJORS:
        # Explicit raise, not assert: the guard must survive python -O
        # (stripped asserts would silently trust unvalidated private
        # APIs — the exact failure mode it exists to prevent).
        raise RuntimeError(
            f"wallclock_retry uses pytest private APIs "
            f"(item._initrequest, _pytest.runner.runtestprotocol) "
            f"validated only against pytest majors "
            f"{_VALIDATED_PYTEST_MAJORS}; running "
            f"{_pytest_mod.__version__}. Re-validate the retry "
            f"protocol and extend _VALIDATED_PYTEST_MAJORS in "
            f"tests/conftest.py."
        )
    from _pytest.runner import runtestprotocol

    retries = marker.kwargs.get("retries", 2)
    item.ihook.pytest_runtest_logstart(
        nodeid=item.nodeid, location=item.location
    )
    failed_longreprs = []
    for attempt in range(retries + 1):
        reports = runtestprotocol(item, nextitem=nextitem, log=False)
        failed = any(r.failed for r in reports)
        if not failed or attempt == retries:
            for report in reports:
                item.ihook.pytest_runtest_logreport(report=report)
            if not failed and attempt > 0:
                _WALLCLOCK_FLAKES.append(
                    (item.nodeid, attempt + 1, failed_longreprs)
                )
            break
        failed_longreprs.extend(
            r.longrepr for r in reports if r.failed and r.longrepr
        )
        import sys

        print(
            f"\n[wallclock_retry] {item.nodeid} failed attempt "
            f"{attempt + 1}/{retries + 1}; retrying with a fresh "
            "cluster",
            file=sys.stderr,
        )
        # Reset fixture state (the pytest-rerunfailures recipe): without
        # this, _fillfixtures only fills argnames missing from
        # item.funcargs, so the retry would reuse the failed attempt's
        # torn-down fixtures (a shut-down cluster, a dirty tmp_path with
        # the previous attempt's round logs).
        item._initrequest()
    item.ihook.pytest_runtest_logfinish(
        nodeid=item.nodeid, location=item.location
    )
    return True
