"""Whole runs of the harness on the CPU, on the tiny root (conftest.py): a
sound run is correct and prints the result line; each fault planted in
the timed path (controls.py) makes `correct` false."""

from __future__ import annotations

import json

import pytest

from conftest import run_on_cpu

SECONDS = "12"  # a CPU forward at batch 8 takes seconds: the window answers two batches or more


def run_cell(root, workload, *extra):
    rc, out, err = run_on_cpu(root, ["--workload", workload, "--seed", str(2**31 + 12345), "--seconds", SECONDS, *extra])
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload", ["tiny-fib-cell", "tiny-zoo-cell"])
def test_sound_run_is_correct(tiny_root, workload):
    line, err = run_cell(tiny_root, workload)
    assert line["correct"] is True, err
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"proofs_per_s", "verdict_ms_p95", "setup_s"}
    assert line["failed"] == 0 and line["attempted"] >= 16
    assert err.strip().splitlines()[-1].startswith("check challenge_mismatch_lanes 0 limit 0")


def test_traced_run_off_the_card_leaves_out_what_it_cannot_read(tiny_root):
    line, err = run_cell(tiny_root, "tiny-fib-cell", "--trace", "1")
    assert line["correct"] is True, err
    # every per-layer metric reads the profiler's trace or the card's memory,
    # so off the card each reader finds nothing and is left out of the line
    assert line["metrics"] == {}
    assert "breakdown" not in line


@pytest.mark.parametrize("control", ["skip_fri", "stale", "half_batch", "flip_lane"])
def test_planted_fault_is_not_correct(tiny_root, control):
    line, err = run_cell(tiny_root, "tiny-fib-cell", "--control", control)
    assert line["correct"] is False
    assert line["checks"]["verdict_mismatch_lanes"]["value"] > 0
    assert line["checks"]["challenge_mismatch_lanes"]["value"] == 0  # the challenges are read apart
