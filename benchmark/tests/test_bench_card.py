"""On the card (marked `cuda`; skips without one): a short run of each cell
is correct, and the control (controls.skip_fri, a verifier that skips the
FRI opening proof) run at the cell's own size is not. Run there with
`python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py`."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, load

WORKLOADS = [w["name"] for w in load(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


def _run(workload, seed, *extra):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(seed), "--seconds", "3",
                        "--trace", "0", *extra], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_on_the_card(workload):
    line = _run(workload, 2**31 + 5)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(workload):
    line = _run(workload, 2**31 + 6, "--control", "skip_fri")
    assert line["correct"] is False and line["checks"]["verdict_mismatch_lanes"]["value"] > 0
