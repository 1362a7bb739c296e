"""A cell on several cards: its ranks run as processes of their own
under the port's group (gloo on the CPU), rank 0 reports for all of
them, and a rank that fails or loads JAX ends the run with no result,
at once and with no rank left behind."""

import os
import re
import time

import pytest

import faults
from spmv_bench import run as harness

BENCH = harness.manifest()
GROUPS = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


def _small(cell):
    return harness.cell_files(BENCH, cell)["config"]["small"]


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("cell", GROUPS)
def test_rank_0_reports_every_rank(small, cell):
    chips = harness.cell_files(BENCH, cell)["workload"]["chips"]
    out = small(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == chips
    route = out["route"]
    assert route["processes"] == chips and route["backend"] == "gloo"
    assert len(route["memory_peak_bytes_by_rank"]) == chips
    assert out["device"]["memory_peak_bytes"] == max(
        route["memory_peak_bytes_by_rank"])
    got = out["metrics"]
    assert got["group_start_s"]["value"] > 0
    # A halo exchange, not x gathered whole: rank 0 has one neighbour on
    # another process, and its halo is less than its own rows.
    kib = [v["value"] for k, v in got.items() if k.startswith("exchange_kib")]
    assert kib and 0 < kib[0] * 2**10 < 2 * 4 * 1024


@pytest.mark.parametrize("cell", GROUPS)
def test_a_run_without_the_exchange_is_not_correct(small, cell):
    """Every rank receives zeros for its neighbours' halo rows: the
    solves converge, to the wrong x."""
    out = small(cell, fault=("exchange",))
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["rel_err"]["value"] > harness.cell_files(
        BENCH, cell)["limits"]["rel_err"]


@pytest.mark.parametrize("cell", GROUPS)
def test_a_dead_rank_ends_the_run_at_once(cell):
    """Rank 2 is killed in its set-up: rank 0's watchdog ends the run
    with no result long before the group's 300 s timeout, and every
    rank it started is gone."""
    t0 = time.monotonic()
    done = faults.run_group(cell, 5, 0.3, False, _small(cell),
                            ("exit", 2, 2.0), timeout=300)
    took = time.monotonic() - t0
    assert done.returncode != 0
    assert "correct" not in done.stdout
    assert "rank 2 exited with code -9" in done.stderr, done.stderr[-3000:]
    assert took < 60
    pids = [int(p) for p in re.findall(r"rank \d+ pid (\d+)", done.stderr)]
    assert len(pids) == harness.cell_files(BENCH, cell)["workload"][
        "chips"] - 1
    assert all(_gone(p) for p in pids)


@pytest.mark.parametrize("cell", GROUPS)
def test_a_rank_that_loads_jax_fails_the_run(cell):
    done = faults.run_group(cell, 5, 0.3, False, _small(cell),
                            ("module", 1, "jax"), timeout=300)
    assert done.returncode != 0
    assert "correct" not in done.stdout
    assert "rank 1 loaded jax" in done.stderr, done.stderr[-3000:]


@pytest.mark.parametrize("cell", GROUPS)
def test_the_control_runs_in_one_process(small, cell):
    out = small(cell, seed=3, control=True)
    assert out["device"]["count"] == 1
    assert "processes" not in out["route"]
