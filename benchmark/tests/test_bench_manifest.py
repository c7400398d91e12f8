"""BENCHMARK.json and the files its names lead to: the manifest parses and
keeps to the names and units allowed, every cell's configuration,
traffic, proofs and metric readers are found by name, and the committed
proofs are of the circuit their configuration states."""

from __future__ import annotations

import hashlib
import json
import os
import re

import pytest

from conftest import BENCH, ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load(os.path.join(ROOT, "BENCHMARK.json"))
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
CONFIGS = [c["name"] for c in MANIFEST["configs"]]


def test_manifest_keys_names_and_units():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"] and MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [m["name"] for m in metrics] + WORKLOADS + CONFIGS
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MANIFEST["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    reported = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in reported and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    from cell import load_cell, variants

    cell = load_cell(BENCH, MANIFEST, workload)
    assert cell.config["name"] == cell.workload["config"] and cell.traffic["name"] == cell.workload["traffic"]
    assert len(cell.proofs) >= 2 and len(variants(cell)) == len(cell.proofs) * (1 + len(cell.faults))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]


@pytest.mark.parametrize("config", CONFIGS)
def test_configuration_names_no_generic_config_or_a_known_one(config):
    """A configuration's `generic_config` is absent (PoseidonGoldilocksConfig)
    or one of the two whose hasher the reference has."""
    cfg = load(os.path.join(BENCH, "configs", f"{config}.json"))
    assert cfg.get("generic_config", "PoseidonGoldilocksConfig") in ("PoseidonGoldilocksConfig", "KeccakGoldilocksConfig")


@pytest.mark.parametrize("config", CONFIGS)
def test_committed_proofs_match_their_configuration(config):
    cfg = load(os.path.join(BENCH, "configs", f"{config}.json"))
    data = os.path.join(BENCH, "data", config)
    common, manifest = load(os.path.join(data, "common.json")), load(os.path.join(data, "manifest.json"))
    assert common["config"] == cfg["circuit"]["config"]
    assert common["fri_params"]["degree_bits"] == cfg["circuit"]["degree_bits"]
    assert common["num_lookup_polys"] == cfg["circuit"]["num_lookup_polys"]
    if "gates" in cfg["circuit"]:
        assert common["gates"] == cfg["circuit"]["gates"]
    if "gate_kinds" in cfg["circuit"]:
        assert len({g.split(" ")[0] for g in common["gates"]}) == cfg["circuit"]["gate_kinds"]
    canonical = json.dumps(common, sort_keys=True, separators=(",", ":")).encode()
    assert manifest["common_sha256"] == hashlib.sha256(canonical).hexdigest()
    assert [p["params"] for p in manifest["proofs"]] == [{**cfg["fixture"], **p} for p in cfg["proofs"]]
    pis = set()
    for i in range(len(cfg["proofs"])):
        proof = load(os.path.join(data, f"proof_{i}.json"))
        assert proof["public_inputs"] == manifest["proofs"][i]["public_inputs"]
        assert len(proof["proof"]["opening_proof"]["query_round_proofs"]) == cfg["fixture"]["num_query_rounds"]
        pis.add(tuple(proof["public_inputs"]))
    assert len(pis) == len(cfg["proofs"])


def test_permutation_count_of_the_standard_shape():
    from cell import load_cell
    from reference import judge
    from yardstick import SECONDS_A_PERMUTATION

    cell = load_cell(BENCH, MANIFEST, next(w["name"] for w in MANIFEST["workloads"] if w["config"] == "fibonacci-std-d12"))
    p = cell.proofs[0]
    assert judge(cell.common, p["vkey"], p["proof"])["permutations"] == 2774
    assert abs(SECONDS_A_PERMUTATION - 1.1466e-9) < 1e-13


@pytest.mark.parametrize("workload", WORKLOADS)
def test_seeded_lanes_repeat_for_a_seed_and_move_with_it(workload):
    from cell import load_cell, lane_plans

    cell = load_cell(BENCH, MANIFEST, workload)
    n = len(cell.proofs)
    seed = 2**31 + 977
    a, b, c = lane_plans(cell, seed), lane_plans(cell, seed), lane_plans(cell, seed + 1)
    assert len(a) == cell.traffic["pool"] and all(len(p) == cell.traffic["batch"] for p in a)
    assert all((x == y).all() for x, y in zip(a, b))
    assert any((x != z).any() for x, z in zip(a, c))
    for plan in a:
        faulted = sorted(int(v) for v in plan if v >= n)
        assert len(faulted) == len(cell.faults)
        assert sorted((v - n) // n for v in faulted) == list(range(len(cell.faults)))  # each fault once a batch
