#!/usr/bin/env python3
"""Benchmark of the PyTorch port: batched Plonky2 proof verification on one
CUDA card, the counterpart of bench.py (which measures the JAX package).

Run from the repository root:
  python3 bench_torch.py [--device cpu] [--seed N] [--warmup N] [--sync]

Prints ONE JSON line:
  {"metric": "proofs_per_sec", "value": N, "unit": "proofs/s", "mode": ...,
   "step_ms_median": ..., "step_ms_p90": ..., "all_verified": true, ...}

BENCH_MODE (batch, stream, mesh_stream), BENCH_MODEL, BENCH_BATCH,
BENCH_DEGREE_BITS, BENCH_QUERIES, BENCH_POW_BITS, BENCH_ITERS,
BENCH_STREAM_PROOFS and BENCH_CORRUPT_EVERY pick the workload;
plonky2_verifier_tpu_torch/bench.py says what each mode measures and what
its line holds. Exits 0 only when every gate held (honest proofs accepted,
the seeded faults rejected on exactly their lanes); otherwise it writes the
line and what failed to stderr, prints no result and exits 1. Runs on the
card unless given --device cpu, and raises where there is none.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    from plonky2_verifier_tpu_torch import bench

    p = argparse.ArgumentParser(prog="python3 bench_torch.py")
    p.add_argument("--device", default=None, help="without it the CUDA card, and an error where there is none")
    p.add_argument("--seed", type=int, default=0, help="picks the faulted lanes of the batch mode's gate")
    p.add_argument("--warmup", type=int, default=2, help="untimed calls before the timed ones (a stream: 0 for no warm-up batch)")
    p.add_argument("--sync", action="store_true", help="the stream mode through submit / flush instead of run()'s prefetch")
    args = p.parse_args(argv)

    with contextlib.redirect_stdout(sys.stderr):  # a kernel build's report: the result is the one line on stdout
        line = bench.bench(bench.settings(), device=args.device, seed=args.seed, warmup=args.warmup, sync=args.sync)
    failed = bench.gate_failures(line)
    if failed:
        print(json.dumps(line), file=sys.stderr)
        print("bench_torch: gates failed: " + "; ".join(failed), file=sys.stderr)
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
