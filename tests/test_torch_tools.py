"""The port's entry module and tools on the CPU at toy size:
plonky2_verifier_tpu_torch/graft_entry.py (the counterpart of
__graft_entry__.py) and tools/{distributed_dryrun, profile_verifier,
check_hash_kernels, bench_poseidon, lookup_device_check}. With --device cpu
the kernels' plain versions stand in, so each tool's code is walked here and
its checks are held against golden/; times taken here are the host's and are
only checked for presence. Tolerance: none (verdicts, counts, bit-exact
words)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from plonky2_verifier_tpu_torch import graft_entry
from plonky2_verifier_tpu_torch.tools import bench_poseidon, check_hash_kernels, lookup_device_check, profile_verifier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_graft_entry_accepts_all_four_lanes():
    fn, args = graft_entry.entry(device="cpu")
    with torch.no_grad():
        out = fn(*args)
    assert out["ok"].tolist() == [True] * 4
    assert {t.device.type for t in args[0].values()} == {"cpu"}


def test_graft_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_dryrun_multichip_defaults_to_a_card_a_rank():
    """Without device="cpu" every rank needs a card of its own: the parent
    raises before it proves or starts anything."""
    with pytest.raises(RuntimeError, match="need a CUDA card each"):
        graft_entry.dryrun_multichip(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="device must be None"):
        graft_entry.dryrun_multichip(2, device="cuda:0")


def test_dryrun_multichip_four_processes(capsys):
    """2 x 2 gloo processes, 4 heterogeneous lanes, lane 1 with a grinding
    fault and lane 2 with an opening fault: the line of
    __graft_entry__.dryrun_multichip."""
    graft_entry.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == "dryrun_multichip ok: mesh dp=2 qp=2, 4 heterogeneous lanes, 2 accepted, rejected lanes [1, 2] as expected"


def test_distributed_dryrun_two_processes_on_the_cpu(tmp_path):
    out = tmp_path / "report.json"
    cmd = [sys.executable, "-m", "plonky2_verifier_tpu_torch.tools.distributed_dryrun", "--nproc", "2", "--device", "cpu", "--out", str(out)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stdout + res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == json.loads(out.read_text())
    assert report["ok"] and report["mesh"] == {"dp": 1, "qp": 2} and "gloo" in report["transport"]
    assert [p["process"] for p in report["processes"]] == [0, 1]
    for p in report["processes"]:
        assert p["ok"] and p["backend"] == "gloo" and p["device"] == "cpu"
        assert p["n_valid"] == p["batch"] - 1 == 1 and p["rejected_lanes"] == [1]


def test_distributed_dryrun_needs_a_card_of_its_own_for_every_rank():
    """Without --device cpu and --share-card rank r takes card r under NCCL;
    where there are fewer cards than ranks the tool raises before it starts
    one (no rank carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cmd = [sys.executable, "-m", "plonky2_verifier_tpu_torch.tools.distributed_dryrun", "--nproc", "2"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "2 ranks need a CUDA card each and this host has 0" in res.stderr


def test_profile_verifier_stage_times_add_up(capsys):
    assert profile_verifier.main(["--model", "fibonacci6", "--batch", "2", "--device", "cpu"]) == 0
    res = _last_json(capsys)
    assert res["device"].startswith("cpu") and res["device_profile"] is None and "kernel_library_s" not in res
    stages = res["stages_ms"]
    want = ["pi hash", "transcript", "plonk: L0 and partial products", "plonk: selectors and gate program", "plonk: lookup argument",
            "plonk: alpha combination and quotient", "fri: proof of work and reduced openings", "fri: leaf hashes",
            "fri: initial Merkle walks", "fri: combineInitial", "fri: final polynomial"]
    assert list(stages) == want  # the 6-query fibonacci template has no fold step
    assert all(ms >= 0 for ms in stages.values())
    assert 0.95 * res["staged_call_ms"] <= sum(stages.values()) <= res["staged_call_ms"]
    assert sorted(res["inner_ms"]) == ["horner_ext", "inv", "pow_dynamic"]
    assert 0 < sum(res["inner_ms"].values()) < res["staged_call_ms"]
    assert all(res[k] > 0 for k in ("construct_s", "first_call_s", "warm_call_s"))


def test_profile_verifier_names_each_fold_step():
    """A template with a fold step: its Merkle walk and its coset fold are
    stages of their own, and the hook is taken off again."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.ops import field as tf
    from plonky2_verifier_tpu_torch.prover.prove import prove
    from plonky2_verifier_tpu_torch.tools import shape_circuits as sc
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    fx = sc.grid_fixture(*sc.GRID[0])
    tpl = CircuitTemplate(fx.common)
    assert tpl.steps
    v = TorchVerifier(tpl, device="cpu")
    inv = tf.inv
    res = profile_verifier.stage_times(v, v.prepare(flatten_proofs(tpl, [prove(fx)] * 2)))
    for s in range(len(tpl.steps)):
        assert f"fri: step {s} Merkle walk and opened slot" in res["stages_ms"] and f"fri: step {s} coset fold" in res["stages_ms"]
    assert v.on_stage is None and tf.inv is inv


def test_check_hash_kernels_plain_versions_against_golden(capsys):
    assert check_hash_kernels.main(["--device", "cpu", "--random", "64", "--rows", "40"]) == 0
    res = _last_json(capsys)
    assert res["pass"] and "plain versions" in res["device"]
    for k in check_hash_kernels.KERNELS:
        assert res[f"{k}_bit_exact"] is True and res[f"{k}_words"] > 0


def test_check_hash_kernels_reports_a_word_that_differs(capsys, monkeypatch):
    from plonky2_verifier_tpu_torch.ops import poseidon as tp

    monkeypatch.setattr(check_hash_kernels.PlainLibrary, "permutation", lambda self, x, form="auto": tp.permutation_plain(x, self.consts) ^ 1)
    assert check_hash_kernels.main(["--device", "cpu", "--random", "8", "--rows", "8"]) == 1
    res = _last_json(capsys)
    assert res["pass"] is False and res["error"].startswith("permutation KAT")


def test_bench_poseidon_on_the_cpu_names_the_host_clock(capsys):
    assert bench_poseidon.main(["8", "32", "--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [l["batch"] for l in lines] == [8, 32]
    for l in lines:
        assert l["kernel_perms_per_sec"] is None and l["host_plain_perms_per_sec"] > 0 and "host clock" in l["device"]


def test_lookup_device_check_rejects_every_fault_lane_by_lane(capsys, tmp_path):
    out = tmp_path / "lookup.json"
    assert lookup_device_check.main(["--cases", "minimal", "--device", "cpu", "--out", str(out)]) == 0
    report = _last_json(capsys)
    assert report == json.loads(out.read_text())
    assert report["ok"] and report["device"] == "cpu"
    (case,) = report["cases"]
    assert case["case"] == "minimal_lookup" and case["accept"] and case["pass"]
    kinds = {label.split("[")[0] for label in case["rejects"]}
    assert kinds == {"lookup_zs", "lookup_zs_next", "lkp_sel", "lut_wire_mult"}
    assert all(case["rejects"].values()) and case["lanes"] == len(case["rejects"]) + 1


def test_lookup_faults_match_the_jax_tools():
    """The sweep is the one of tools/lookup_device_check.py, label by label."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
    from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof

    with open(os.path.join(ROOT, "tools", "lookup_device_check.py")) as f:
        source = f.read()
    tpl = CircuitTemplate(get_fixture_proof("lookup", **lookup_device_check.CASES["minimal"])[0])
    labels = [label for label, _, _ in lookup_device_check.lookup_faults(tpl)]
    for kind in {label.split("[")[0] for label in labels}:
        assert kind in source, kind
