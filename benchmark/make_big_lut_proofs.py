"""Make the honest proofs of the big-lut-d12 configuration, once, on the CPU.

    python3 benchmark/make_big_lut_proofs.py [--out DIR]

The configuration's "fixture" and each entry of its "proofs" (the looked-up
inputs) are the arguments of the port's `big_lut_fixture`
(plonky2_verifier_tpu_torch/models/lookup.py). Each proof is made by the
repository's own prover in a process of its own and written in
make_proofs.py's layout into DIR/big-lut-d12/ (default: benchmark/data/):
common.json, vkey_<i>.json, proof_<i>.json and manifest.json. A proof of the
65,536-row table at degree 12 takes some minutes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import sys
import time

from make_proofs import HERE, ROOT, _canonical

CONFIG = "big-lut-d12"


def prove_one(params: dict) -> dict:
    """Build and prove one fixture; returns its three JSON documents."""
    sys.path.insert(0, ROOT)
    from plonky2_verifier_tpu_torch.models.lookup import big_lut_fixture
    from plonky2_verifier_tpu_torch.prover.prove import prove

    t0 = time.perf_counter()
    fx = big_lut_fixture(**params)
    vkey, pwp = prove(fx)
    return {"common": fx.common.to_json(), "vkey": vkey.to_json(), "proof": pwp.to_json(),
            "prove_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "data"))
    args = ap.parse_args(argv)
    with open(os.path.join(HERE, "configs", f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    params = [{**cfg["fixture"], **extra} for extra in cfg["proofs"]]
    with multiprocessing.get_context("spawn").Pool(len(params)) as pool:
        results = pool.map(prove_one, params)
    if len({_canonical(r["common"]) for r in results}) != 1:
        raise SystemExit(f"{CONFIG}: the proofs do not share one circuit")
    if len({tuple(r["proof"]["public_inputs"]) for r in results}) != len(results):
        raise SystemExit(f"{CONFIG}: two proofs have the same public inputs")
    out = os.path.join(args.out, CONFIG)
    os.makedirs(out, exist_ok=True)
    common = results[0]["common"]
    with open(os.path.join(out, "common.json"), "w") as f:
        json.dump(common, f)
    manifest = {"config": CONFIG, "common_sha256": hashlib.sha256(_canonical(common)).hexdigest(), "proofs": []}
    for i, (p, r) in enumerate(zip(params, results)):
        for kind in ("vkey", "proof"):
            with open(os.path.join(out, f"{kind}_{i}.json"), "w") as f:
                json.dump(r[kind], f)
        manifest["proofs"].append({"index": i, "params": p, "public_inputs": r["proof"]["public_inputs"],
                                   "prove_s": round(r["prove_s"], 1)})
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"{CONFIG}: {len(results)} proofs in {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
