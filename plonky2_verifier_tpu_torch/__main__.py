"""Command line of the PyTorch port: the reference's end-to-end entry point.

Mirrors `src/testmain.hs:24-63` — read `{prefix}_common.json`,
`{prefix}_vkey.json`, `{prefix}_proof.json`, print the public-input hash,
opening-set sizes, per-stage booleans, and the verdict — with a batch/device
dimension the reference doesn't have, plus a fixture generator standing in
for the reference's gitignored `json/` corpus (SURVEY §4). The counterpart
of plonky2_verifier_tpu/__main__.py, with the same lines and exit codes.

    python -m plonky2_verifier_tpu_torch verify PREFIX [--backend torch|golden]
        [--batch N] [--quiet] [--device cpu]
    python -m plonky2_verifier_tpu_torch fixture MODEL OUT_PREFIX
        [--queries N] [--pow-bits N] [--degree-bits N]
    python -m plonky2_verifier_tpu_torch stream PATH [--batch N] [--repeat N]
        [--no-raw] [--workers N] [--quiet] [--device cpu]

`verify --backend torch` and `stream` run on the CUDA card and fail where
there is none; `--device cpu` runs them on the CPU (every kernel's plain
version).

`stream` drives the mixed-shape BucketedStreamVerifier over many proof
triples without writing Python: PATH is either a directory (every
`X_common.json` with sibling `X_vkey.json`/`X_proof.json` is one item) or
a .jsonl manifest whose lines are {"prefix": "..."} or {"common_file":
..., "vkey_file": ..., "proof_file": ...}. vkey/proof JSON go through the
native C++ ingest as raw bytes (never json.loads'd on the host) unless
--no-raw.

With P2V_DISTRIBUTED=1 and PyTorch's MASTER_ADDR, MASTER_PORT, WORLD_SIZE
and RANK in the environment, `stream` is one process of several, one a
device (parallel.stream.init_distributed): start it once a rank with the same
arguments. Every rank reads the same items and verifies its share of every
batch; rank 0 prints the summary, and every rank exits with the code that
the global counts give.

Exit code 0 iff every proof verifies, 1 on a rejection, 2 when `stream`
finds no proof triple.
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_verify(args) -> int:
    from .types import load_common, load_proof, load_vkey

    common = load_common(f"{args.prefix}_common.json")
    vkey = load_vkey(f"{args.prefix}_vkey.json")
    pwp = load_proof(f"{args.prefix}_proof.json")

    if not args.quiet:  # the testmain.hs:40-52 diagnostics
        from .golden.hashing import sponge

        o = pwp.proof.openings
        print(f"gates: {[str(g) for g in common.gates]}")
        print(f"public inputs: {pwp.public_inputs}")
        print(f"PI hash: {list(sponge(pwp.public_inputs))}")
        for name in (
            "constants", "plonk_sigmas", "wires", "plonk_zs", "plonk_zs_next",
            "partial_products", "quotient_polys", "lookup_zs", "lookup_zs_next",
        ):
            print(f"openings.{name}: {len(getattr(o, name))}")

    if args.backend == "golden":
        from .golden.challenges import proof_challenges
        from .golden.fri import check_fri_proof
        from .golden.plonk import check_combined_plonk_equations

        t0 = time.time()
        ch = proof_challenges(common, vkey, pwp)
        eqs = check_combined_plonk_equations(common, pwp, ch)
        fri_ok = check_fri_proof(common, vkey, pwp.proof, ch)
        ok = all(eqs) and fri_ok
        if not args.quiet:
            print(f"plonk equations per round: {eqs}")
            print(f"fri ok: {fri_ok}")
        print(f"verified (golden, {time.time() - t0:.2f}s): {ok}")
        return 0 if ok else 1

    import torch

    from .compiler import CircuitTemplate, flatten_proofs
    from .verifier_torch import TorchVerifier

    tpl = CircuitTemplate(common)
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * args.batch)
    v = TorchVerifier(tpl, device=args.device)
    t0 = time.time()
    with torch.no_grad():
        out = v(v.prepare(arrays))
    eqs = out["eqs_ok"].cpu().numpy()
    fri = out["fri_ok"].cpu().numpy()
    ok = v.to_host(out)
    dt = time.time() - t0
    if not args.quiet:
        print(f"plonk equations ok: {eqs.tolist()}")
        print(f"fri ok: {fri.tolist()}")
    print(
        f"verified (torch, batch {args.batch}, {dt:.2f}s incl. copy to the device and kernel load): "
        f"{int(ok.sum())}/{args.batch}"
    )
    return 0 if bool(ok.all()) else 1


def _cmd_fixture(args) -> int:
    import json

    from .models.cache import get_fixture_proof

    params = {"num_query_rounds": args.queries, "proof_of_work_bits": args.pow_bits}
    if args.degree_bits:
        if args.model == "fibonacci":
            params["n_arith_rows"] = (1 << args.degree_bits) - 3
        elif args.model == "gate_zoo":
            params["target_degree_bits"] = args.degree_bits
    common, vkey, pwp = get_fixture_proof(args.model, **params)
    for obj, kind in [(common, "common"), (vkey, "vkey"), (pwp, "proof")]:
        path = f"{args.out_prefix}_{kind}.json"
        with open(path, "w") as f:
            json.dump(obj.to_json(), f)
        print(f"wrote {path}")
    return 0


def _stream_items(path: str):
    """Yield (common, vkey, proof) stream items from a dir or .jsonl manifest;
    vkey/proof stay raw bytes (the native single-pass ingest parses them)."""
    import glob
    import json
    import os

    from .types import load_common

    def triple(prefix):
        common = load_common(f"{prefix}_common.json")
        with open(f"{prefix}_vkey.json", "rb") as f:
            vk = f.read()
        with open(f"{prefix}_proof.json", "rb") as f:
            pf = f.read()
        return common, vk, pf

    if os.path.isdir(path):
        for c in sorted(glob.glob(os.path.join(path, "*_common.json"))):
            prefix = c[: -len("_common.json")]
            if os.path.exists(f"{prefix}_vkey.json") and os.path.exists(f"{prefix}_proof.json"):
                yield triple(prefix)
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            spec = json.loads(line)
            if "prefix" in spec:
                yield triple(spec["prefix"])
            else:
                common = load_common(spec["common_file"])
                with open(spec["vkey_file"], "rb") as vf:
                    vk = vf.read()
                with open(spec["proof_file"], "rb") as pf_:
                    pf = pf_.read()
                yield common, vk, pf


def _cmd_stream(args) -> int:
    from .parallel import init_distributed, make_mesh

    if not init_distributed(device=args.device):
        return _stream(args, None)
    import torch.distributed as dist

    try:
        return _stream(args, make_mesh())
    finally:
        dist.destroy_process_group()


def _stream(args, mesh) -> int:
    import json

    from .parallel import BucketedStreamVerifier

    quiet = args.quiet or (mesh is not None and mesh.rank != 0)
    bsv = BucketedStreamVerifier(
        batch=args.batch, mesh=mesh, raw_json=not args.no_raw, ingest_workers=args.workers, device=args.device
    )
    items = list(_stream_items(args.path))
    if not items:
        print(f"no proof triples found under {args.path}", file=sys.stderr)
        return 2
    if args.repeat > 1:
        items = items * args.repeat
    if args.no_raw:
        # parsed-dataclass path: vkey/proof must become objects
        from .types import ProofWithPublicInputs, VerifierOnlyCircuitData

        items = [
            (c, VerifierOnlyCircuitData.from_json(json.loads(vk)), ProofWithPublicInputs.from_json(json.loads(pf)))
            for c, vk, pf in items
        ]

    def progress(key, m):
        if not quiet:
            print(f"{key} {m.line()}", flush=True)

    per_shape = bsv.run(items, on_batch=progress)
    total = {"shapes": len(per_shape), "proofs": 0, "accepted": 0, "rejected": 0}
    for key, m in per_shape.items():
        total["proofs"] += m.proofs
        total["accepted"] += m.accepted
        total["rejected"] += m.rejected
    if mesh is None or mesh.rank == 0:
        print(json.dumps({**total, "per_shape": {k: m.snapshot() for k, m in per_shape.items()}}))
    return 0 if total["rejected"] == 0 and total["proofs"] > 0 else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m plonky2_verifier_tpu_torch", description=__doc__)
    device_help = "the device to run on; without it the CUDA card, and an error where there is none"
    sub = p.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("verify", help="verify {prefix}_{common,vkey,proof}.json")
    pv.add_argument("prefix")
    pv.add_argument("--backend", choices=("torch", "golden"), default="torch")
    pv.add_argument("--batch", type=int, default=1)
    pv.add_argument("--quiet", action="store_true")
    pv.add_argument("--device", default=None, help=device_help)
    pv.set_defaults(fn=_cmd_verify)

    pf = sub.add_parser("fixture", help="generate + prove a fixture circuit")
    pf.add_argument("model", choices=("fibonacci", "gate_zoo", "lookup", "multi_lookup", "poseidon_chain"))
    pf.add_argument("out_prefix")
    pf.add_argument("--queries", type=int, default=8)
    pf.add_argument("--pow-bits", type=int, default=8)
    pf.add_argument("--degree-bits", type=int, default=0)
    pf.set_defaults(fn=_cmd_fixture)

    ps = sub.add_parser("stream", help="stream-verify many proof triples (mixed shapes ok)")
    ps.add_argument("path", help="directory of *_{common,vkey,proof}.json or a .jsonl manifest")
    ps.add_argument("--batch", type=int, default=256)
    ps.add_argument("--repeat", type=int, default=1, help="cycle the item list N times")
    ps.add_argument("--workers", type=int, default=0, help="ingest threads (0 = host cores, over the processes on this host)")
    ps.add_argument("--no-raw", action="store_true", help="parsed-dataclass ingest instead of native")
    ps.add_argument("--quiet", action="store_true")
    ps.add_argument("--device", default=None, help=device_help)
    ps.set_defaults(fn=_cmd_stream)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
