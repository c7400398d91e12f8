"""The plain reference and the faults the traffic plants: the reference
accepts every committed proof and rejects each fault on each proof; its
Poseidon and its field constants are Plonky2's (the permutation's test
vectors, the generators the committed circuits' coset shifts are powers of);
each fault is the one word the port's bench.seeded_faults flips (the same
array and column once flattened); and the reference imports nothing but the
standard library and loads nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT, load

MANIFEST = load(os.path.join(ROOT, "BENCHMARK.json"))
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_accepts_the_proofs_and_rejects_each_fault(workload):
    from cell import load_cell, variants
    from reference import judge

    cell = load_cell(BENCH, MANIFEST, workload)
    n = len(cell.proofs)
    for i, v in enumerate(variants(cell)):
        got = judge(cell.common, v["vkey"], v["proof"])
        assert got["ok"] == (i < n), (i, got)
        assert got["ok"] == (got["eqs_ok"] and got["fri_ok"])


def test_poseidon_is_plonky2s():
    """plonky2/src/hash/poseidon_goldilocks.rs's test vectors for the inputs
    0^12 and 0..12."""
    from reference.poseidon import permute

    assert permute([0] * 12) == [
        0x3c18a9786cb0b359, 0xc4055e3364a246c3, 0x7953db0ab48808f4, 0xc71603f33a1144ca,
        0xd7709673896996dc, 0x46a84e87642f44ed, 0xd032648251ee0b3c, 0x1c687363b207df62,
        0xdf8565563e8045fe, 0x40f5b37ff4254dae, 0xd070f637b431067c, 0x1792b1c4342109d7]
    assert permute(list(range(12))) == [
        0xd64e1e3efc5b8e9e, 0x53666633020aaa47, 0xd40285597c6a8825, 0x613a4f81e81231d2,
        0x414754bfebd051f0, 0xcb1f8980294a023f, 0x6eb2a9e4d54a9d0f, 0x1902bc3af467e056,
        0xf045d5eafdc6021f, 0xe4150f77caaa3be5, 0xc9bfd01d39b50cce, 0x5c0a27fcb0e1459b]


@pytest.mark.parametrize("config", sorted({w["config"] for w in MANIFEST["workloads"]}))
def test_field_generators_are_plonky2s(config):
    """The two-adic generator has order 2^32, and each committed circuit's
    coset shifts k_i are the powers of the multiplicative generator."""
    from reference.field import MULTIPLICATIVE_GROUP_GENERATOR as G, P, POWER_OF_TWO_GENERATOR as R

    assert pow(R, 2**31, P) == P - 1
    k_is = load(os.path.join(BENCH, "data", config, "common.json"))["k_is"]
    assert k_is == [pow(G, i, P) for i in range(len(k_is))]


def test_the_reference_imports_only_the_standard_library():
    ref = os.path.join(BENCH, "reference")
    allowed = {"__future__", "dataclasses", "re"}
    for name in sorted(os.listdir(ref)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= allowed, (name, ast.dump(node))
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] in allowed, (name, node.module)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_fault_is_one_flattened_word(workload):
    from cell import load_cell, variants
    from plonky2_verifier_tpu_torch.bench import lookup_opening_column
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.types import CommonCircuitData, ProofWithPublicInputs, VerifierOnlyCircuitData

    cell = load_cell(BENCH, MANIFEST, workload)
    tpl = CircuitTemplate(CommonCircuitData.from_json(cell.common))
    docs = variants(cell)
    flat = flatten_proofs(tpl, [(VerifierOnlyCircuitData.from_json(d["vkey"]), ProofWithPublicInputs.from_json(d["proof"]))
                                for d in docs])
    n = len(cell.proofs)
    for f, fault in enumerate(cell.faults):
        array, column = ("openings1", lookup_opening_column(tpl)) if fault["name"] == "lookup_opening" else (fault["name"], 0)
        for p in range(n):
            lane = n + f * n + p
            diff = [(k, np.flatnonzero(a[lane].reshape(-1) != a[p].reshape(-1)).tolist()) for k, a in flat.items()]
            diff = [(k, cols) for k, cols in diff if cols]
            assert diff == [(array, [column])], (fault, diff)
            assert flat[array][lane].reshape(-1)[column] == flat[array][p].reshape(-1)[column] ^ np.uint64(1)


def _modules_after(code: str, cwd: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, ROOT]), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=cwd, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cell_run_loads_no_jax(tiny_root):
    """A whole run on the CPU in a fresh interpreter: every module the harness
    and the program load, compared by whole top-level name."""
    code = (f"import run\nrc = run.run(['--workload', 'tiny-zoo-cell', '--seed', '3', '--seconds', '1', '--trace', '1'],"
            f" root={tiny_root!r}, device='cpu')\nassert rc == 0, rc")
    mods = _modules_after(code, ROOT)
    assert "plonky2_verifier_tpu_torch" in mods and "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "plonky2_verifier_tpu"}, mods


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, os\nfrom reference import judge\nfrom cell import load_cell, load_json\n"
            f"m = load_json({os.path.join(ROOT, 'BENCHMARK.json')!r})\n"
            f"c = load_cell({BENCH!r}, m, {WORKLOADS[0]!r})\np = c.proofs[0]\n"
            "assert judge(c.common, p['vkey'], p['proof'])['ok']\n")
    mods = _modules_after(code, BENCH)
    assert not mods & {"plonky2_verifier_tpu_torch", "torch", "jax", "jaxlib", "flax", "plonky2_verifier_tpu"}, mods
    assert "reference" in mods
