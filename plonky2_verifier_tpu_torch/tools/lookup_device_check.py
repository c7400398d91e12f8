"""Full-template check of the lookup argument on the card, the counterpart
of tools/lookup_device_check.py.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.lookup_device_check
      [--cases minimal standard] [--device cpu] [--out FILE]

A minimal lookup circuit (8-entry table, 6 uses) and the standard `lookup`
fixture both verify through TorchVerifier, and a fault sweep over the
lookup-relevant arrays must reject lane by lane: every lookup_zs and
lookup_zs_next opening, every lookup-selector constant column, and a wire
that carries a table row. The sweep is one batch: lane k carries fault k
alone and the last lane is intact, so a fault that leaked into another lane,
or an accepted fault, shows in the verdict vector. Mirrors
Plonk/Lookups.hs:45-132 at the template level; tests/test_torch_lookup.py
holds `_lookup_checks` against golden/ and the JAX module word by word.

Prints one JSON line; exit code 0 iff every case passes. No file is written
unless --out names one.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..compiler import CircuitTemplate, flatten_proofs
from ..models.cache import get_fixture_proof
from ..ops.field import resolve_device
from ..verifier_torch import TorchVerifier

CASES = {
    "minimal": {"table_size": 8, "n_lookups": 6, "num_query_rounds": 2, "proof_of_work_bits": 2},
    "standard": {"table_size": 37, "n_lookups": 50, "num_query_rounds": 8, "proof_of_work_bits": 8},
}


def lookup_faults(tpl):
    """(label, array, index within a lane) of every fault of the sweep."""
    lz_off = tpl.n_const_cols + tpl.n_sigmas + tpl.num_wires + tpl.n_zs + tpl.n_pp + tpl.n_quot
    faults = [(f"lookup_zs[{i}]", "openings1", (lz_off + i, 0)) for i in range(tpl.n_lookup)]
    faults += [(f"lookup_zs_next[{i}]", "openings2", (tpl.n_zs + i, 0)) for i in range(tpl.n_lookup)]
    faults += [(f"lkp_sel[{i}]", "openings1", (tpl.n_gate_selectors + i, 0)) for i in range(tpl.n_lookup_selectors)]
    # a wire opening in the table-row region (the first triple's multiplicity)
    faults.append(("lut_wire_mult", "openings1", (tpl.n_const_cols + tpl.n_sigmas + 2, 0)))
    return faults


def run_case(name: str, common, vkey, pwp, device) -> dict:
    tpl = CircuitTemplate(common)
    v = TorchVerifier(tpl, device=device)
    faults = lookup_faults(tpl)
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * (len(faults) + 1))
    for lane, (_, array, index) in enumerate(faults):
        arrays[array][(lane,) + index] ^= np.uint64(1)
    t0 = time.time()
    with torch.no_grad():
        ok = v.to_host(v(v.prepare(arrays)))
    first_call_s = round(time.time() - t0, 3)
    rejects = {label: not bool(ok[lane]) for lane, (label, _, _) in enumerate(faults)}
    accept = bool(ok[-1])
    return {
        "case": name,
        "degree_bits": tpl.degree_bits,
        "num_queries": tpl.num_queries,
        "n_lookup": tpl.n_lookup,
        "n_lookup_selectors": tpl.n_lookup_selectors,
        "lanes": len(faults) + 1,
        "accept": accept,
        "first_call_s": first_call_s,
        "rejects": rejects,
        "pass": accept and all(rejects.values()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.lookup_device_check")
    p.add_argument("--cases", nargs="+", choices=sorted(CASES), default=["minimal", "standard"])
    p.add_argument("--device", default=None, help="without it the CUDA card, and an error where there is none")
    p.add_argument("--out", default=None, help="also write the report to this file")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cases = [run_case(f"{name}_lookup", *get_fixture_proof("lookup", **CASES[name]), device) for name in args.cases]
    report = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "ok": all(c["pass"] for c in cases),
        "cases": cases,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
