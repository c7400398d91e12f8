"""A/B the host proof-ingest paths: JSON bytes -> flattened uint64 arrays.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.bench_ingest [n_proofs] [--workers N]

Paths compared on the standard proof shape (degree 2^12, 28 queries):
- python: json.loads -> types.from_json -> compiler.flatten.flatten_proofs
- native: plonky2_verifier_tpu_torch.native (C++ parser, no interpreter lock) x 1 thread
- native x N threads (N = --workers, by default the host's cores)

Asserts that all three give equal arrays and prints one JSON line with the
milliseconds a proof of each. It needs no device: the ingest is host code.
"""

import argparse
import json
import os
import time

from .stream_verify import STANDARD


def bench(tpl, vkey, pwp, n: int, workers: int = 0) -> dict:
    """Ingest `n` copies of one proof through each path, assert equal arrays,
    and return the times. Without a toolchain the native entries are absent
    and "native" says so."""
    from ..compiler import flatten_proofs
    from ..native import flatten_proof_jsons, get_fastload
    from ..types import ProofWithPublicInputs, VerifierOnlyCircuitData

    vk_b = json.dumps(vkey.to_json()).encode()
    pf_b = json.dumps(pwp.to_json()).encode()
    pairs = [(vk_b, pf_b)] * n

    t0 = time.time()
    objs = [
        (VerifierOnlyCircuitData.from_json(json.loads(vk)), ProofWithPublicInputs.from_json(json.loads(pf)))
        for vk, pf in pairs
    ]
    ref = flatten_proofs(tpl, objs)
    t_py = time.time() - t0

    results = {"n": n, "proof_json_bytes": len(pf_b), "vkey_json_bytes": len(vk_b)}
    results["python_ms_per_proof"] = round(t_py / n * 1000, 3)

    if get_fastload() is None:
        results["native"] = "unavailable (no toolchain)"
        return results

    def timed(k):
        t0 = time.time()
        got = flatten_proof_jsons(tpl, pairs, workers=k)
        dt = time.time() - t0
        if sorted(got) != sorted(ref):
            raise AssertionError(f"native arrays {sorted(got)} != python arrays {sorted(ref)}")
        for name in ref:
            if got[name].shape != ref[name].shape or not (got[name] == ref[name]).all():
                raise AssertionError(f"native ingest ({k} workers) differs from flatten_proofs in {name}")
        return dt

    threads = workers or os.cpu_count() or 1
    t_n1, t_nk = timed(0), timed(threads)
    results.update(
        native_ms_per_proof=round(t_n1 / n * 1000, 3),
        native_threads=threads,
        native_mt_ms_per_proof=round(t_nk / n * 1000, 3),
        speedup_1t=round(t_py / t_n1, 1),
        speedup_mt=round(t_py / t_nk, 1),
        python_proofs_per_sec=round(n / t_py, 1),
        native_mt_proofs_per_sec=round(n / t_nk, 1),
    )
    return results


def main(argv=None):
    from ..compiler import CircuitTemplate
    from ..models.cache import get_fixture_proof

    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.bench_ingest")
    p.add_argument("n_proofs", type=int, nargs="?", default=64)
    p.add_argument("--workers", type=int, default=0, help="threads of the threaded run (0 = host cores)")
    args = p.parse_args(argv)
    common, vkey, pwp = get_fixture_proof("fibonacci", **STANDARD)
    print(json.dumps(bench(CircuitTemplate(common), vkey, pwp, args.n_proofs, args.workers)))


if __name__ == "__main__":
    main()
