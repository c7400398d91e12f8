"""Make the honest proofs that a configuration's cells verify, once, on the CPU.

    python3 benchmark/make_proofs.py [--out DIR] [CONFIG ...]

For each configuration named (default: every file in benchmark/configs/) it
builds the fixture that the file's "model" and "fixture" name, once for each
entry of its "proofs" (the circuit's seed and, for fibonacci, the public
inputs x0 and x1), proves each with the repository's own prover in a process
of its own, and writes into DIR/<config>/ (default: benchmark/data/):

    common.json          the common circuit data, the same for every proof
    vkey_<i>.json        proof i's verifier key
    proof_<i>.json       proof i with its public inputs
    manifest.json        for each proof the parameters and seed that made it

No benchmark run proves anything: the runs read these files. Proving a
degree-12 circuit takes some minutes a proof.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def prove_one(model: str, params: dict) -> dict:
    """Build and prove one fixture; returns its three JSON documents."""
    sys.path.insert(0, ROOT)
    from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
    from plonky2_verifier_tpu_torch.models.gate_zoo import gate_zoo_fixture
    from plonky2_verifier_tpu_torch.prover.prove import prove

    build = {"fibonacci": fibonacci_fixture, "gate_zoo": gate_zoo_fixture}[model]
    t0 = time.perf_counter()
    fx = build(**params)
    vkey, pwp = prove(fx)
    return {"common": fx.common.to_json(), "vkey": vkey.to_json(), "proof": pwp.to_json(),
            "prove_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "data"))
    ap.add_argument("configs", nargs="*")
    args = ap.parse_args(argv)
    names = args.configs or sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "configs")) if f.endswith(".json"))
    jobs = []
    for name in names:
        with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        for i, extra in enumerate(cfg["proofs"]):
            jobs.append((name, i, cfg["model"], {**cfg["fixture"], **extra}))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        results = pool.starmap(prove_one, [(model, params) for _, _, model, params in jobs])
    for name in names:
        mine = [(i, params, r) for (n, i, _, params), r in zip(jobs, results) if n == name]
        commons = {_canonical(r["common"]) for _, _, r in mine}
        if len(commons) != 1:
            raise SystemExit(f"{name}: the proofs do not share one circuit")
        pis = [tuple(r["proof"]["public_inputs"]) for _, _, r in mine]
        if len(set(pis)) != len(pis):
            raise SystemExit(f"{name}: two proofs have the same public inputs")
        out = os.path.join(args.out, name)
        os.makedirs(out, exist_ok=True)
        common = mine[0][2]["common"]
        with open(os.path.join(out, "common.json"), "w") as f:
            json.dump(common, f)
        manifest = {"config": name, "common_sha256": hashlib.sha256(_canonical(common)).hexdigest(), "proofs": []}
        for i, params, r in mine:
            for kind in ("vkey", "proof"):
                with open(os.path.join(out, f"{kind}_{i}.json"), "w") as f:
                    json.dump(r[kind], f)
            manifest["proofs"].append({"index": i, "params": params, "public_inputs": r["proof"]["public_inputs"],
                                       "prove_s": round(r["prove_s"], 1)})
        with open(os.path.join(out, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        print(f"{name}: {len(mine)} proofs in {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
