"""Stream-verify N >> batch proofs with rolling metrics.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.stream_verify [n_proofs] [batch]
      [--no-raw] [--sync] [--corrupt-every N] [--device cpu]

Streams `n_proofs` standard-shape proofs (cached fixture, with a deterministic
sprinkling of corrupted ones to prove the verdict path is live) through
StreamVerifier, prints a rolling metrics line per batch and one final JSON
line. By default the proofs are raw JSON byte pairs that go through the
native C++ ingest; --no-raw streams parsed dataclasses. The final
poseidon_perms_per_sec is the measured proofs/s times the analytic FRI.md
permutation count. --sync drives the synchronous form (submit / flush on
the calling thread, no prefetch thread), to measure what the prefetch of
run() hides. Runs on the CUDA card unless given --device cpu.

Under P2V_DISTRIBUTED=1 with MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK
(parallel.stream.init_distributed; --backend gloo where the ranks share one
card) it is one rank of a dp mesh: start it once a rank with the same
arguments, and every rank's last line holds the global counts.
"""

import argparse
import copy
import json

STANDARD = {"n_arith_rows": 4093, "num_query_rounds": 28, "proof_of_work_bits": 16}  # the tools' one copy


def proof_stream(vkey, pwp, n: int, corrupt_every: int, raw: bool):
    """`n` copies of one proof as StreamVerifier items, every
    `corrupt_every`-th (0: none) with a flipped pow_witness; raw JSON byte
    pairs or parsed objects. Returns (iterator, rejections to expect)."""
    bad = copy.deepcopy(pwp)
    bad.proof.opening_proof.pow_witness ^= 1
    if raw:
        vk = json.dumps(vkey.to_json()).encode()
        good, bad = json.dumps(pwp.to_json()).encode(), json.dumps(bad.to_json()).encode()
    else:
        vk, good = vkey, pwp

    def items():
        for i in range(n):
            corrupt = corrupt_every and i % corrupt_every == corrupt_every - 1
            yield (vk, bad if corrupt else good)

    return items(), (n // corrupt_every if corrupt_every else 0)


def stream_rank(items, batch: int, dp: int, qp: int, raw: bool, device, common=None, warm_up=None) -> dict:
    """One rank's run of a stream over a dp x qp mesh, to be called by every
    rank of an initialised process group with the same arguments: `items`
    through StreamVerifier (the template of `common`) or, without `common`,
    (common, vkey, proof) triples through BucketedStreamVerifier. Returns
    the rank and the counts {"proofs", "accepted", "rejected", "batches"},
    per shape key in the bucketed form; the StreamVerifier form adds its
    final snapshot, ingest times and, on the card, the kernels' launches over
    the stream. `warm_up` (the StreamVerifier form): a group of `batch` items
    verified before the stream, outside its metrics and counts. The stream's
    counterpart of parallel.verify_sharded: a target for parallel.run_ranks,
    whose children import the module that holds it, so it lives in the
    package."""
    from ..compiler import CircuitTemplate
    from ..parallel import BucketedStreamVerifier, StreamVerifier, make_mesh

    mesh = make_mesh(dp, qp)
    counts = lambda m: {k: getattr(m, k) for k in ("proofs", "accepted", "rejected", "batches")}
    if common is None:
        per_shape = BucketedStreamVerifier(batch, mesh=mesh, raw_json=raw, device=device).run(items)
        return {"rank": mesh.rank, "per_shape": {k: counts(m) for k, m in per_shape.items()}}
    sv = StreamVerifier(CircuitTemplate(common), batch, mesh=mesh, raw_json=raw, device=device)
    warm_up_s = sv.warm_up(warm_up) if warm_up is not None else 0.0
    lib = None
    if sv.device.type == "cuda":
        from .. import kernels

        lib = kernels.load()
        lib.reset_launches()
    m = sv.run(items)
    return {"rank": mesh.rank, "ingest_workers": sv.ingest_workers, **counts(m), "snapshot": m.snapshot(), "warm_up_s": warm_up_s,
            "ingest_work_s": sv.ingest_work_s, "ingest_s": m.ingest_s, "device_wait_s": m.device_wait_s,
            "launches": dict(lib.launches) if lib is not None else None}


def main(argv=None):
    import torch

    from ..compiler import CircuitTemplate
    from ..models.cache import get_fixture_proof
    from ..parallel import StreamVerifier, init_distributed, make_mesh

    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.stream_verify")
    p.add_argument("n_proofs", type=int, nargs="?", default=10_000)
    p.add_argument("batch", type=int, nargs="?", default=512)
    p.add_argument("--no-raw", action="store_true", help="parsed dataclasses instead of raw JSON through the native ingest")
    p.add_argument("--sync", action="store_true", help="submit / flush on the calling thread instead of run()'s prefetch")
    p.add_argument("--corrupt-every", type=int, default=1000, help="flip pow_witness in every N-th proof (0: none)")
    p.add_argument("--device", default=None, help="without it the CUDA card, and an error where there is none")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None, help="the process group's, under P2V_DISTRIBUTED=1")
    args = p.parse_args(argv)

    distributed = init_distributed(backend=args.backend, device=args.device)
    mesh = make_mesh() if distributed else None
    common, vkey, pwp = get_fixture_proof("fibonacci", **STANDARD)
    sv = StreamVerifier(CircuitTemplate(common), args.batch, mesh=mesh, raw_json=not args.no_raw, device=args.device)
    stream, expected = proof_stream(vkey, pwp, args.n_proofs, args.corrupt_every, not args.no_raw)

    def progress(m):
        line = m.snapshot()
        line["rolling_proofs_per_sec"] = round(m.rolling_rate(), 1)
        print(json.dumps(line), flush=True)

    try:
        if args.sync:
            for group, live in sv._batches(stream):
                sv.submit(group, live, progress)
            sv.flush(progress)
        else:
            sv.run(stream, on_batch=progress)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()
    final = sv.metrics.snapshot()
    final["expected_rejected"] = expected
    final["raw_ingest"] = not args.no_raw
    final["prefetch"] = not args.sync
    final["distributed"] = distributed
    if mesh is not None:
        final["mesh"] = dict(mesh.shape, rank=mesh.rank)
    final["ingest_work_s"] = round(sv.ingest_work_s, 3)  # on both threads; ingest_s is what the caller paid
    final["device"] = torch.cuda.get_device_name(sv.device) if sv.device.type == "cuda" else str(sv.device)
    print(json.dumps(final))
    if final["rejected"] != expected:
        raise AssertionError(f"verdict path miscounted: {final['rejected']} rejected, {expected} expected")


if __name__ == "__main__":
    main()
