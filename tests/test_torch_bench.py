"""The port's benchmark (plonky2_verifier_tpu_torch/bench.py, bench_torch.py)
on the CPU, at a small size: its fixture parameters equal bench.py's, its
batch and stream modes print one JSON line with every field and hold their
gates, a gate that fails makes the script exit non-zero, and without a card
it raises instead of running on the CPU.

bench.py sets P2V_FUSED_HASH when it is imported, and the JAX tests share a
pytest worker with this file, so bench.py is only imported in a child
process. The fixture is the fibonacci circuit of profile_verifier's CPU
test (5 arithmetic rows, 6 queries, PoW 8) through bench.py's own
parameters: BENCH_DEGREE_BITS=3 gives n_arith_rows = 2^3 - 3 = 5."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from plonky2_verifier_tpu_torch import bench
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier
from torch_threads import child_env, one_torch_thread  # noqa: F401  (one_torch_thread: autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"BENCH_MODEL": "fibonacci", "BENCH_DEGREE_BITS": "3", "BENCH_QUERIES": "6", "BENCH_POW_BITS": "8", "BENCH_BATCH": "2"}
# every mode's line (the stream modes replace the step statistics with the stream's fields)
COMMON_FIELDS = {"metric", "value", "unit", "mode", "model", "batch", "degree_bits", "query_rounds", "pow_bits", "poseidon_perms_per_proof",
                 "poseidon_perms_per_sec", "all_verified", "fault_lanes", "faults_rejected", "kernel_launches", "setup_s", "warmup_s",
                 "seed", "device"}
BATCH_FIELDS = {"step_ms_median", "step_ms_p90", "step_ms_min", "step_ms_max", "step_count", "proofs_per_sec", "rejected_lanes",
                "cuda_launches_per_forward", "kernel_ms_per_forward", "idle_share"}
STREAM_FIELDS = {"stream_proofs_per_sec", "rejected", "expected_rejected", "ingest_work_ms_per_proof", "ingest_s", "device_wait_s",
                 "prefetch_hidden_share", "prefetch"}

OVERRIDES = [{}, {"BENCH_DEGREE_BITS": "10"}, {"BENCH_QUERIES": "5"}, {"BENCH_POW_BITS": "3"}, {"BENCH_BATCH": "7"},
             {"BENCH_ITERS": "3"}, {"BENCH_DEGREE_BITS": "14", "BENCH_QUERIES": "40", "BENCH_POW_BITS": "20"}]
CASES = [dict(BENCH_MODEL=m, **o) for m in ("fibonacci", "gate_zoo", "poseidon_chain") for o in OVERRIDES]
BENCH_PY = """
import importlib, json, os, sys
sys.path.insert(0, os.getcwd())
out = []
for env in json.loads(sys.argv[1]):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[k]
    os.environ.update(env)
    import bench
    bench = importlib.reload(bench)
    out.append({"params": bench.fixture_params(), "model": bench.MODEL, "batch": bench.BATCH, "iters": bench.ITERS})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def bench_py_params():
    """bench.py's fixture_params(), MODEL, BATCH and ITERS under every case
    of CASES, read in one child process."""
    env = {k: v for k, v in child_env().items() if not k.startswith("BENCH_")}
    res = subprocess.run([sys.executable, "-c", BENCH_PY, json.dumps(CASES)], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(CASES)), ids=["-".join(f"{k[6:]}={v}" for k, v in c.items()) for c in CASES])
def test_fixture_params_equal_bench_py(bench_py_params, case):
    """The port reads bench.py's variables under the same names and defaults,
    but BENCH_ITERS, whose default is 100 here (bench.py: 10)."""
    env = CASES[case]
    theirs = bench_py_params[case]
    s = bench.settings(env)
    assert bench.fixture_params(s) == theirs["params"]
    assert (s["model"], s["batch"]) == (theirs["model"], theirs["batch"])
    assert s["iters"] == (theirs["iters"] if "BENCH_ITERS" in env else 100)
    assert s["mode"] == "batch"


def test_settings_of_the_stream_modes():
    assert (bench.settings({"BENCH_MODE": "stream"})["batch"], bench.settings({"BENCH_MODE": "stream"})["stream_proofs"]) == (1024, 10_000)
    mesh = bench.settings({"BENCH_MODE": "mesh_stream"})
    assert (mesh["batch"], mesh["stream_proofs"], mesh["corrupt_every"]) == (2048, 8192, 1000)
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.settings({"BENCH_MODE": "serve"})


def test_step_stats_over_a_hundred_calls():
    stats = bench.step_stats(np.arange(1, 101) / 1e3)
    assert stats["step_count"] == 100
    assert stats["step_ms_median"] == pytest.approx(50.5)
    assert stats["step_ms_p90"] == pytest.approx(90.1)
    assert (stats["step_ms_min"], stats["step_ms_max"]) == (pytest.approx(1.0), pytest.approx(100.0))
    with pytest.raises(ValueError):
        bench.step_stats([])


def _small_template():
    return bench._fixture(bench.settings(SMALL))[0]


def test_seeded_faults_take_up_to_half_the_lanes():
    tpl = _small_template()
    faults = bench.seeded_faults(tpl, 1024, 5)
    lanes = [lane for lane, _ in faults]
    assert lanes == sorted(set(lanes)) and len(lanes) == len(bench.FAULTED)
    assert sorted(name for _, name in faults) == sorted(bench.FAULTED)
    assert faults == bench.seeded_faults(tpl, 1024, 5) and faults != bench.seeded_faults(tpl, 1024, 6)
    assert len(bench.seeded_faults(tpl, 2, 0)) == 1 and bench.seeded_faults(tpl, 1, 0) == []


def test_fault_lanes_flip_one_word_of_a_copy():
    arrays = {"a": np.zeros((3, 2, 2), dtype=np.uint64), "b": np.zeros((3,), dtype=np.uint64)}
    mutated = bench.fault_lanes(arrays, 3, [(0, ("a", 3)), (2, "b")])
    assert not arrays["a"].any() and not arrays["b"].any()
    assert mutated["a"].reshape(3, -1)[0, 3] == 1 and int(mutated["a"].sum()) == 1
    assert mutated["b"].tolist() == [0, 0, 1]


def _run(extra_env: dict, *args):
    env = {k: v for k, v in child_env().items() if not k.startswith("BENCH_")}
    env.update(SMALL, **extra_env)
    return subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu", *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_batch_mode_prints_one_line_and_rejects_its_seeded_fault_lane():
    """Batch 2, two timed calls: one JSON line with every field, every call
    accepted, the lane the seed picks rejected and the other accepted."""
    res = _run({"BENCH_ITERS": "2"}, "--warmup", "0", "--seed", "3")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    assert COMMON_FIELDS | BATCH_FIELDS <= set(line), sorted(COMMON_FIELDS | BATCH_FIELDS - set(line))
    assert (line["mode"], line["model"], line["batch"], line["query_rounds"], line["seed"]) == ("batch", "fibonacci", 2, 6, 3)
    assert (line["metric"], line["unit"], line["step_count"], line["device"]) == ("proofs_per_sec", "proofs/s", 2, "cpu")
    assert line["all_verified"] and line["faults_rejected"]
    want = [lane for lane, _ in bench.seeded_faults(_small_template(), 2, 3)]
    assert line["fault_lanes"] == line["rejected_lanes"] == want and len(want) == 1
    assert line["step_ms_min"] <= line["step_ms_median"] <= line["step_ms_p90"] <= line["step_ms_max"]
    assert line["value"] == line["proofs_per_sec"] == pytest.approx(2 / line["step_ms_median"] * 1e3)
    assert line["kernel_launches"] is None and line["idle_share"] is None  # no kernel runs on the CPU: not measured
    assert "vs_baseline" not in line


@pytest.mark.parametrize("verdict", ["accepts-everything", "rejects-everything"])
def test_a_gate_that_fails_makes_the_script_exit_non_zero(monkeypatch, capsys, verdict):
    """A verdict that accepts the faulted lane, or rejects an honest one,
    fails the run: exit 1, no line on stdout."""

    def forward(self, a, queries=None):
        return {"ok": torch.full((a["pow_witness"].shape[0],), verdict == "accepts-everything")}

    monkeypatch.setattr(TorchVerifier, "forward", forward)
    for k, v in dict(SMALL, BENCH_ITERS="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_MODE", raising=False)
    assert bench_torch.main(["--device", "cpu", "--warmup", "0"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "gates failed" in out.err
    assert ("were not rejected exactly" if verdict == "accepts-everything" else "an honest proof was rejected") in out.err


def test_stream_mode_counts_its_faults_after_a_warm_up():
    """Two raw-JSON proofs at batch 2, the second with a flipped pow_witness,
    after a warm-up batch that the metrics do not count."""
    res = _run({"BENCH_MODE": "stream", "BENCH_STREAM_PROOFS": "2", "BENCH_CORRUPT_EVERY": "2"}, "--warmup", "1")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    assert COMMON_FIELDS | STREAM_FIELDS <= set(line), sorted(COMMON_FIELDS | STREAM_FIELDS - set(line))
    assert (line["proofs"], line["accepted"], line["rejected"], line["batches"]) == (2, 1, 1, 1)
    assert line["rejected"] == line["expected_rejected"] == 1 and line["fault_lanes"] == [1]
    assert line["all_verified"] and line["faults_rejected"] and line["prefetch"]
    assert line["warmup_calls"] == 1 and line["warmup_s"] > 0
    assert line["ingest_s"] <= line["ingest_work_s"]


def test_without_a_card_the_bench_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench(bench.settings({}))
    env = {k: v for k, v in child_env().items() if not k.startswith("BENCH_")}
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout == "" and "no CUDA device" in res.stderr
