"""A cell's inputs, found by name: its configuration, its traffic mix and the
proofs the configuration's data holds, and the lanes that `--seed` draws.

Layout under the benchmark's directory (`bench_dir`):
  configs/<config>.json   the circuit, its source, the fixture that made the
                          proofs, the guarantees a run is held to, and
                          optionally its Plonky2 `generic_config`
                          (PoseidonGoldilocksConfig where absent)
  traffic/<traffic>.json  batch, batches in flight, pool, faults, loop
  data/<config>/          common.json, vkey_<i>.json, proof_<i>.json
  metrics/<metric>.py     one per-layer metric's reader
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from reference.hashing import HASHERS, POSEIDON_CONFIG

VERDICTS = ("ok", "eqs_ok", "fri_ok")  # a lane's verdicts, as the program reports them


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    common: dict  # the common circuit data's JSON
    proofs: list  # [{"vkey": ..., "proof": ...}], the configuration's honest proofs
    faults: list  # the traffic's faults whose word exists in these proofs
    generic_config: str  # the Plonky2 GenericConfig the proofs were made with, which names their hasher


def find_workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def _resolve(doc, path: str):
    """The container and key of the word at `path` ("a/b/0/..."), or None
    where the document has no such word."""
    keys = [int(k) if k.isdigit() else k for k in path.split("/")]
    node = doc
    try:
        for key in keys[:-1]:
            node = node[key]
        node[keys[-1]]
    except (IndexError, KeyError, TypeError):
        return None
    return node, keys[-1]


def flip_word(doc: dict, path: str) -> dict:
    """`doc` with the low bit of the word at `path` flipped (in place)."""
    node, key = _resolve(doc, path)
    node[key] = int(node[key]) ^ 1
    return doc


def generic_config(config: dict) -> str:
    """The configuration's `generic_config`, PoseidonGoldilocksConfig where
    it names none; a name the reference has no hasher for is refused."""
    name = config.get("generic_config", POSEIDON_CONFIG)
    if name not in HASHERS:
        raise SystemExit(f"configuration {config.get('name')!r}: generic_config {name!r} is none of {sorted(HASHERS)}")
    return name


def load_cell(bench_dir: str, manifest: dict, workload: str) -> Cell:
    w = find_workload(manifest, workload)
    config = load_json(os.path.join(bench_dir, "configs", f"{w['config']}.json"))
    hasher = generic_config(config)
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    if traffic.get("loop") != "closed":
        raise SystemExit(f"traffic {w['traffic']!r}: loop {traffic.get('loop')!r}; this harness runs a closed loop only")
    data = os.path.join(bench_dir, "data", w["config"])
    common = load_json(os.path.join(data, "common.json"))
    proofs = [{"vkey": load_json(os.path.join(data, f"vkey_{i}.json")),
               "proof": load_json(os.path.join(data, f"proof_{i}.json"))} for i in range(len(config["proofs"]))]
    faults = [f for f in traffic["faults"] if _resolve(proofs[0], f["path"]) is not None]
    return Cell(w, config, traffic, common, proofs, faults, hasher)


def variants(cell: Cell) -> list:
    """Every input a lane can hold: the honest proofs, then each fault on
    each proof (fault f on proof p at n + f * n + p, n proofs)."""
    out = list(cell.proofs)
    for f in cell.faults:
        for p in cell.proofs:
            out.append(flip_word(json.loads(json.dumps(p)), f["path"]))
    return out


def lane_plans(cell: Cell, seed: int) -> list:
    """For each batch of the pool, the variant of each lane: every lane an
    honest proof drawn by `seed`, then one lane drawn for each fault, which
    holds that fault on the lane's proof. Every seed gives the same sizes and
    the same number of faults, on other lanes."""
    rng = np.random.default_rng(seed)
    n, batch = len(cell.proofs), cell.traffic["batch"]
    plans = []
    for _ in range(cell.traffic["pool"]):
        plan = rng.integers(0, n, size=batch)
        lanes = rng.choice(batch, size=len(cell.faults), replace=False)
        for f, lane in zip(rng.permutation(len(cell.faults)), lanes):
            plan[lane] = n + int(f) * n + plan[lane]
        plans.append(plan)
    return plans
