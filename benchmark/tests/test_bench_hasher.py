"""A configuration names its Plonky2 GenericConfig, and the hasher it names
reaches the reference, the harness and the yardstick; the committed Poseidon
configurations read as before:

- judge gives the committed configurations' honest proofs, and each one's
  changed circuit digest, the verdicts, challenge words and Poseidon
  permutations it gave before the hasher was a choice, with 0 Keccak-f calls;
- forward_roofline reads the same number as before on a recorded
  observation with no Keccak, and adds K's term where the reference counts
  Keccak-f calls;
- a Keccak configuration's digests (BytesHash<25>, 25 bytes) are read, and
  judge runs its transcript on Keccak with the public inputs' hash on
  Poseidon;
- cell.py takes the key, absent meaning Poseidon, and refuses a name it has no
  hasher for; program.py passes the verifier `generic_config` only for a
  hasher other than Poseidon."""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os

import pytest

from conftest import BENCH, ROOT, load
from run import read_metric

MANIFEST = load(os.path.join(ROOT, "BENCHMARK.json"))
WORKLOADS = {w["config"]: w["name"] for w in MANIFEST["workloads"]}

# judge before the hasher was a choice: ok, eqs_ok, fri_ok, Poseidon
# permutations, the first 16 hex digits of the sha256 of the challenge words'
# JSON; input 0 and 1 the honest proofs, 12 the changed circuit digest
BEFORE = {
    ("fibonacci-std-d12", 0): (True, True, True, 2774, "0ce526d32c76a5b9"),
    ("fibonacci-std-d12", 1): (True, True, True, 2774, "2176856b24be50e7"),
    ("fibonacci-std-d12", 12): (False, False, False, 114, "b26eb438207dab9a"),
    ("gate-zoo-lookup-d12", 0): (True, True, True, 2867, "cec4a8856e32b59f"),
    ("gate-zoo-lookup-d12", 1): (True, True, True, 2867, "342d7abcf7cf9726"),
    ("gate-zoo-lookup-d12", 12): (False, False, False, 123, "91d3ab7a34ba8bd3"),
    ("big-lut-d12", 0): (True, True, True, 2839, "28dafc6a570bb9b3"),
    ("big-lut-d12", 1): (True, True, True, 2839, "f9d506c863bbc5c5"),
    ("big-lut-d12", 12): (False, False, False, 123, "9a51b745aee9ed90"),
}


def _cell(config: str):
    from cell import load_cell

    return load_cell(BENCH, MANIFEST, WORKLOADS[config])


@pytest.mark.parametrize("config", sorted({c for c, _ in BEFORE}))
def test_judge_reads_the_committed_configurations_as_before(config):
    from cell import variants
    from reference import judge

    cell = _cell(config)
    assert cell.generic_config == "PoseidonGoldilocksConfig"
    inputs = variants(cell)
    assert [f["name"] for f in cell.faults].index("circuit_digest") * 2 + 2 == 12
    for (c, i), want in BEFORE.items():
        if c != config:
            continue
        got = judge(cell.common, inputs[i]["vkey"], inputs[i]["proof"], cell.generic_config)
        words = hashlib.sha256(json.dumps(got["challenges"]).encode()).hexdigest()[:16]
        assert (got["ok"], got["eqs_ok"], got["fri_ok"], got["permutations"], words) == want, i
        assert got["keccak_permutations"] == 0


# a traced fibonacci forward at 16,384 on the H100 (busy 66.7 ms a forward)
RECORDED = {"batch": 16384, "perms_per_proof": 2774, "span": {"busy_s_a_forward": 0.0667}}


def test_forward_roofline_is_unchanged_without_keccak_and_adds_k_with_it():
    from yardstick import SECONDS_A_KECCAK, SECONDS_A_PERMUTATION

    before = 100.0 * (2774 * 16384 * SECONDS_A_PERMUTATION) / 0.0667  # the reader as it was
    assert read_metric(BENCH, "forward_roofline", dict(RECORDED, keccak_per_proof=0)) == before
    assert 78.0 < before < 78.2
    with_keccak = read_metric(BENCH, "forward_roofline", dict(RECORDED, keccak_per_proof=1700))
    assert with_keccak == pytest.approx(before + 100.0 * 1700 * 16384 * SECONDS_A_KECCAK / 0.0667, rel=1e-12)
    assert read_metric(BENCH, "forward_roofline", dict(RECORDED, keccak_per_proof=1700, span=None)) is None


def _as_bytes_hash(doc):
    """`doc` with every HashOut {"elements": [4 words]} as a 25-byte array,
    as serde_json writes a BytesHash<25> (made from the words: a stand-in
    for the digests a Keccak proof carries)."""
    if isinstance(doc, dict):
        if set(doc) == {"elements"}:
            return list(b"".join(int(w).to_bytes(8, "little") for w in doc["elements"])[:25])
        return {k: _as_bytes_hash(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_as_bytes_hash(v) for v in doc]
    return doc


def test_a_keccak_configuration_reads_byte_digests_and_hashes_its_transcript_with_keccak():
    from reference import judge, poseidon
    from reference.hashing import HASHERS
    from reference.proof import Common, Proof

    cell = _cell("fibonacci-std-d12")
    p = cell.proofs[0]
    vkey, proof = _as_bytes_hash(copy.deepcopy(p["vkey"])), _as_bytes_hash(copy.deepcopy(p["proof"]))
    read = Proof(Common(cell.common), vkey, proof, HASHERS["KeccakGoldilocksConfig"])
    assert read.circuit_digest == bytes(vkey["circuit_digest"]) and len(read.circuit_digest) == 25
    assert all(isinstance(h, bytes) and len(h) == 25 for h in read.wires_cap + read.constants_sigmas_cap)
    assert isinstance(read.query_rounds[0][0][0][1][0], bytes)  # a sibling of the first initial path

    keccak_run = judge(cell.common, vkey, proof, "KeccakGoldilocksConfig")
    poseidon_run = judge(cell.common, p["vkey"], p["proof"])
    assert keccak_run["ok"] is False  # the digests are no Keccak tree's: FRI fails
    assert keccak_run["keccak_permutations"] > 100  # the transcript's duplexings, 3 Keccak-f calls or more each
    # the public inputs' hash stays Poseidon's (InnerHasher): its permutations and its 4 challenge words
    assert keccak_run["permutations"] == -(-len(p["proof"]["public_inputs"]) // poseidon.RATE)
    assert keccak_run["challenges"][-4:] == poseidon_run["challenges"][-4:]
    assert keccak_run["challenges"][:-4] != poseidon_run["challenges"][:-4]


@pytest.mark.parametrize("named, want", [(None, "PoseidonGoldilocksConfig"),
                                         ("PoseidonGoldilocksConfig", "PoseidonGoldilocksConfig"),
                                         ("KeccakGoldilocksConfig", "KeccakGoldilocksConfig")])
def test_cell_takes_the_generic_config(named, want):
    from cell import generic_config

    cfg = {"name": "c"} if named is None else {"name": "c", "generic_config": named}
    assert generic_config(cfg) == want


@pytest.mark.parametrize("named", ["Blake3GoldilocksConfig", "keccakgoldilocksconfig", ""])
def test_cell_refuses_an_unknown_generic_config_by_name(named, tmp_path):
    from cell import load_cell

    bench = tmp_path / "benchmark"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    cfg = dict(load(os.path.join(BENCH, "configs", "fibonacci-std-d12.json")), generic_config=named)
    (bench / "configs" / "fibonacci-std-d12.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "batch-16384.json").write_text(json.dumps(load(os.path.join(BENCH, "traffic", "batch-16384.json"))))
    with pytest.raises(SystemExit) as refused:
        load_cell(str(bench), MANIFEST, WORKLOADS["fibonacci-std-d12"])
    assert repr(named) in str(refused.value) and "KeccakGoldilocksConfig" in str(refused.value)


@pytest.mark.parametrize("config, hasher, want", [
    ("fibonacci-std-d12", None, {}), ("gate-zoo-lookup-d12", None, {}), ("big-lut-d12", None, {}),
    ("fibonacci-std-d12", "KeccakGoldilocksConfig", {"generic_config": "KeccakGoldilocksConfig"})])
def test_program_passes_the_verifier_a_hasher_only_other_than_poseidon(config, hasher, want, monkeypatch):
    import torch

    import plonky2_verifier_tpu_torch.verifier_torch as verifier_torch
    from program import Program

    made = []

    class StandIn:
        def __init__(self, tpl, **kwargs):
            made.append(kwargs)

        def prepare(self, arrays):
            return {}

    monkeypatch.setattr(verifier_torch, "TorchVerifier", StandIn)
    cell = _cell(config)
    if hasher is not None:
        cell = dataclasses.replace(cell, generic_config=hasher)
    Program(cell, cell.proofs[:1], [], torch.device("cpu"))
    assert made == [dict(device=torch.device("cpu"), **want)]


def test_the_reference_judges_under_the_cells_hasher(monkeypatch):
    import correct

    calls = []

    class Pool:
        def __init__(self, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, args):
            calls.extend(args)
            return [None for _ in args]

    monkeypatch.setattr(correct, "ProcessPoolExecutor", Pool)
    correct.reference({"c": 1}, [{"vkey": "v", "proof": "p"}], "KeccakGoldilocksConfig")
    assert calls == [({"c": 1}, "v", "p", "KeccakGoldilocksConfig")]
