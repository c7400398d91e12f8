"""The yardstick of the lookup argument's table work: the least time the H100
can take for the final running-evaluation check of every lookup table.

For each challenge round a lane evaluates each table's polynomial
`get_lut_poly(...).eval(delta)` (plonky2/src/plonk/vanishing_poly.rs): one
coefficient `input + b output` a row of the table, padded with its first row
to whole LookupTableGate rows of num_routed_wires // 3 slots (the degree
that the plain reference's `vanishing.lut_poly_eval` is given). A row costs 2
Goldilocks products and 2 adds, 2 x 16 + 2 x 4 = 40 int32 instructions as
yardstick.py counts them, at its int32 rate; the bytes are the padded table
read once (16 B a row) and, a lane and a round, b and delta read and the
result written (8 + 8 + 16 B), at 3.35 TB/s. The larger is the bound. Every
number comes from the cell's own common.json, never from the program.
"""

from __future__ import annotations

import argparse
import json
import os

from yardstick import INT32_RATE

ROW_INSTRUCTIONS = 2 * 16 + 2 * 4
HBM_BYTES_A_SECOND = 3.35e12
HERE = os.path.dirname(os.path.abspath(__file__))


def padded_rows(common: dict) -> int:
    """The rows of every table, each padded to whole rows of num_routed_wires // 3 slots."""
    slots = common["config"]["num_routed_wires"] // 3
    return sum(-(-len(lut) // slots) * slots for lut in common["luts"])


def row_rounds(common: dict) -> int:
    """Table rows a lane evaluates: the padded rows of every table, each challenge round."""
    return padded_rows(common) * common["config"]["num_challenges"]


def least_seconds(common: dict, batch: int) -> float:
    ops = row_rounds(common) * batch * ROW_INSTRUCTIONS / INT32_RATE
    words = padded_rows(common) * 16 + batch * common["config"]["num_challenges"] * (8 + 8 + 16)
    return max(ops, words / HBM_BYTES_A_SECOND)


def cell_common(argv, root: str = os.path.dirname(HERE)):
    """The common.json of the cell that `argv`'s --workload names, found as
    run.py finds it (BENCHMARK.json, then the configuration's data), or None
    where argv names no cell of the benchmark."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    name = ap.parse_known_args(argv)[0].workload
    try:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            manifest = json.load(f)
        config = next(w["config"] for w in manifest["workloads"] if w["name"] == name)
        with open(os.path.join(root, "benchmark", "data", config, "common.json")) as f:
            return json.load(f)
    except (OSError, StopIteration, ValueError):
        return None
