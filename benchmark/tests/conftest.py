"""Helpers of the benchmark's own tests: the harness's modules on sys.path, the
card marker, and a tiny benchmark root (BENCHMARK.json, a configuration of
each kind proved at degree 3 with 2 query rounds, a traffic mix of batch 8)
that drives a whole run on the CPU."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "tiny-fib": {"model": "fibonacci", "fixture": {"n_arith_rows": 5, "num_query_rounds": 2, "proof_of_work_bits": 4},
                 "proofs": [{"seed": 1, "x0": 1, "x1": 2}, {"seed": 2, "x0": 3, "x1": 7}]},
    "tiny-zoo": {"model": "gate_zoo", "fixture": {"num_query_rounds": 2, "proof_of_work_bits": 4},
                 "proofs": [{"seed": 7}, {"seed": 11}]},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device and nvcc; skips without them")


def load(path):
    with open(path) as f:
        return json.load(f)


def run_on_cpu(root: str, args: list, timeout: int = 900):
    """run.py's run on the CPU in a fresh interpreter, as the harness runs a
    cell but for the look for a chip: (exit code, stdout, stderr)."""
    code = ("import sys, run\n"
            f"sys.exit(run.run(sys.argv[1:], root={root!r}, device='cpu'))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, ROOT]), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True, env=env, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A benchmark root whose cells run on the CPU in seconds a forward."""
    root = tmp_path_factory.mktemp("tiny_bench")
    bench = root / "benchmark"
    for sub in ("configs", "traffic"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), bench / "metrics")
    manifest = copy.deepcopy(load(os.path.join(ROOT, "BENCHMARK.json")))
    traffic = dict(load(os.path.join(BENCH, "traffic", "batch-16384.json")), name="tiny-batch", batch=8, pool=2)
    (bench / "traffic" / "tiny-batch.json").write_text(json.dumps(traffic))
    manifest["configs"], manifest["workloads"] = [], []
    for name, cfg in TINY_CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(dict(cfg, name=name)))
        manifest["workloads"].append({"name": f"{name}-cell", "config": name, "traffic": "tiny-batch", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    # make_proofs.py writes where the tiny root's configurations are read
    shutil.copy(os.path.join(BENCH, "make_proofs.py"), bench / "make_proofs.py")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, str(bench / "make_proofs.py")], check=True, env=env, timeout=600,
                   stdout=subprocess.DEVNULL)
    return str(root)
