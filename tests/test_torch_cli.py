"""The port's command line (plonky2_verifier_tpu_torch/__main__.py) on the
CPU against the JAX package's on the same files: the seven cases of
tests/test_cli.py with --device cpu, equal exit codes and counts. The
fixture files are written by the JAX package's CLI. Then `stream` as two
processes under P2V_DISTRIBUTED=1: rank 0 alone prints the summary, with the
one-process counts, and both exit with the code the global counts give.
Tolerance: none."""

import copy
import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from plonky2_verifier_tpu.__main__ import main as ref_main
from plonky2_verifier_tpu_torch.__main__ import main
from torch_threads import child_env, one_torch_thread  # noqa: F401  (one_torch_thread: autouse)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli") / "fib")
    assert ref_main(["fixture", "fibonacci", out, "--queries", "6", "--pow-bits", "4"]) == 0
    return out


def _write_corrupt(prefix, tmp_path, name="bad"):
    with open(f"{prefix}_proof.json") as f:
        bad = copy.deepcopy(json.load(f))
    bad["proof"]["opening_proof"]["pow_witness"] ^= 1
    bad_prefix = str(tmp_path / name)
    for kind in ("common", "vkey"):
        shutil.copy(f"{prefix}_{kind}.json", f"{bad_prefix}_{kind}.json")
    with open(f"{bad_prefix}_proof.json", "w") as f:
        json.dump(bad, f)
    return bad_prefix


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_fixture_writes_the_same_files(prefix, tmp_path):
    out = str(tmp_path / "fib")
    assert main(["fixture", "fibonacci", out, "--queries", "6", "--pow-bits", "4"]) == 0
    for kind in ("common", "vkey", "proof"):
        with open(f"{out}_{kind}.json") as ours, open(f"{prefix}_{kind}.json") as theirs:
            assert ours.read() == theirs.read(), kind


def test_cli_golden_verify_accepts(prefix, capsys):
    assert ref_main(["verify", prefix, "--backend", "golden"]) == 0
    ref_lines = capsys.readouterr().out.splitlines()
    assert main(["verify", prefix, "--backend", "golden"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any("PI hash" in l for l in lines) and any("verified (golden" in l for l in lines)
    # the same diagnostics, line for line, up to the timing in the last one
    assert lines[:-1] == ref_lines[:-1]


def test_cli_golden_verify_rejects_mutation(prefix, tmp_path):
    bad = _write_corrupt(prefix, tmp_path)
    assert main(["verify", bad, "--backend", "golden", "--quiet"]) == ref_main(["verify", bad, "--backend", "golden", "--quiet"]) == 1


def test_cli_torch_verify_accepts_batch(prefix, capsys):
    """The device backend: batch flag, per-lane booleans, exit code from
    ok.all(); the JAX CLI prints the same lines with its own backend name."""
    assert ref_main(["verify", prefix, "--backend", "jax", "--batch", "2"]) == 0
    ref_out = capsys.readouterr().out
    assert main(["verify", prefix, "--batch", "2"] + CPU) == 0  # --backend defaults to torch
    out = capsys.readouterr().out
    assert "verified (torch, batch 2" in out and "2/2" in out
    assert "verified (jax, batch 2" in ref_out and "2/2" in ref_out
    for line in ("plonk equations ok: [True, True]", "fri ok: [True, True]"):
        assert line in out.splitlines() and line in ref_out.splitlines()


def test_cli_torch_verify_rejects_mutation(prefix, tmp_path):
    bad = _write_corrupt(prefix, tmp_path)
    assert main(["verify", bad, "--backend", "torch", "--quiet"] + CPU) == 1
    assert ref_main(["verify", bad, "--backend", "jax", "--quiet"]) == 1


def test_cli_stream_dir(prefix, tmp_path, capsys):
    """`stream` over a directory of proof triples: native raw ingest, batch
    padding, exit code 0 on all-accept."""
    d = tmp_path / "streamdir"
    d.mkdir()
    for kind in ("common", "vkey", "proof"):
        shutil.copy(f"{prefix}_{kind}.json", d / f"fib_{kind}.json")
    args = ["stream", str(d), "--batch", "2", "--repeat", "3", "--quiet"]
    assert ref_main(args) == 0
    ref = _last_json(capsys)
    assert main(args + CPU) == 0
    summary = _last_json(capsys)
    assert summary["proofs"] == 3 and summary["accepted"] == 3 and summary["shapes"] == 1
    assert {k: summary[k] for k in ("shapes", "proofs", "accepted", "rejected")} == {k: ref[k] for k in ("shapes", "proofs", "accepted", "rejected")}
    assert list(summary["per_shape"]) == list(ref["per_shape"])


def test_cli_stream_jsonl_detects_corrupt(prefix, tmp_path, capsys):
    """Manifest mode with a corrupted lane, parsed-dataclass ingest on the
    port's side: the exit code flips on both."""
    bad_prefix = _write_corrupt(prefix, tmp_path, "streambad")
    manifest = tmp_path / "m.jsonl"
    manifest.write_text(
        json.dumps({"prefix": prefix})
        + "\n"
        + json.dumps({f"{kind}_file": f"{bad_prefix}_{kind}.json" for kind in ("common", "vkey", "proof")})
        + "\n"
    )
    args = ["stream", str(manifest), "--batch", "2", "--quiet"]
    assert ref_main(args) == 1
    ref = _last_json(capsys)
    assert main(args + ["--no-raw"] + CPU) == 1
    summary = _last_json(capsys)
    assert summary["proofs"] == 2 and summary["rejected"] == 1
    assert (ref["proofs"], ref["rejected"]) == (2, 1)


def test_cli_stream_empty_dir_is_an_error(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    assert main(["stream", str(d), "--quiet"] + CPU) == ref_main(["stream", str(d), "--quiet"]) == 2


@pytest.mark.parametrize("corrupt", [False, True], ids=["all-accepted", "one-corrupt"])
def test_cli_stream_as_two_processes(prefix, tmp_path, capsys, corrupt):
    """The same command once a rank with P2V_DISTRIBUTED=1 and PyTorch's
    rendezvous variables: each rank verifies half of every batch of 2."""
    d = tmp_path / "streamdir"
    d.mkdir()
    for kind in ("common", "vkey", "proof"):
        shutil.copy(f"{prefix}_{kind}.json", d / f"fib_{kind}.json")
    if corrupt:
        _write_corrupt(prefix, d, "zbad")  # sorts behind fib: lane 1 of the batch, rank 1's
    args = ["stream", str(d), "--batch", "2", "--repeat", "1" if corrupt else "3", "--quiet"] + CPU
    want_rc = main(args)
    want = _last_json(capsys)
    assert want_rc == (1 if corrupt else 0)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = child_env(P2V_DISTRIBUTED="1", MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
        cmd = [sys.executable, "-m", "plonky2_verifier_tpu_torch"] + args
        procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [want_rc, want_rc], outs
    summary = json.loads(outs[0][0].strip().splitlines()[-1])
    assert outs[1][0].strip() == ""  # rank 0 alone prints
    for k in ("shapes", "proofs", "accepted", "rejected"):
        assert summary[k] == want[k], k
    (m,), (w,) = summary["per_shape"].values(), want["per_shape"].values()
    assert [m[k] for k in ("proofs", "accepted", "rejected", "batches")] == [w[k] for k in ("proofs", "accepted", "rejected", "batches")]


@pytest.mark.parametrize("args", [["verify", "PREFIX", "--quiet"], ["stream", "DIR", "--quiet"]])
def test_cli_needs_the_card_unless_told(prefix, tmp_path, args):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    args = [prefix if a == "PREFIX" else str(tmp_path) if a == "DIR" else a for a in args]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)
