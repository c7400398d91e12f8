"""Throughput of the batched Poseidon-12 permutation: the plain PyTorch
version against the CUDA kernel (csrc/permutation.cu), the counterpart of
tools/bench_poseidon.py.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.bench_poseidon [batch ...]
      [--iters N] [--device cpu]

Prints one JSON line a batch with permutations a second of both, the
kernel's form the launcher picked being timed beside its two forms, and
the card's name and power limit. Both are first held bit-exact against each
other and, on a few rows, against golden/. Times are CUDA-event times of
`--iters` launches after a warm-up (the plain version: 2 calls, it is an
eager chain of thousands of launches). With --device cpu only the plain
version runs, on the host's clock, and the line says so: no figure of such
a run is a device's.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..golden import poseidon as gp
from ..ops import field as tf
from ..ops import poseidon as tp

BATCHES = [1 << 12, 1 << 15, 1 << 18, 1 << 20]


def card_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]


def event_ms(fn, iters: int, warmup: int = 1) -> float:
    """Milliseconds a call of `fn`, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.bench_poseidon")
    p.add_argument("batches", type=int, nargs="*", default=BATCHES)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default=None, help="without it the CUDA card, and an error where there is none")
    args = p.parse_args(argv)

    device = tf.resolve_device(args.device)
    consts = tp.PoseidonConstants(device)
    rng = np.random.default_rng(0)
    on_card = device.type == "cuda"
    if on_card:
        from .. import kernels

        lib, card = kernels.load(), card_name_and_limit()
    for b in args.batches:
        states = rng.integers(0, tf.P, size=(b, 12), dtype=np.uint64)
        x = tf.from_u64(states, device)
        plain = tp.permutation_plain(x, consts)
        golden = np.array([gp.permutation([int(v) for v in s]) for s in states[:4]], dtype=np.uint64)
        if not np.array_equal(tf.to_u64(plain[:4]), golden):
            raise AssertionError(f"batch {b}: the plain permutation differs from golden/")
        line = {"batch": b}
        if on_card:
            if not torch.equal(lib.permutation(x), plain):
                raise AssertionError(f"batch {b}: the kernel differs from the plain version")
            plain_ms = event_ms(lambda: tp.permutation_plain(x, consts), 2)
            ms = {form: event_ms(lambda: lib.permutation(x, form), args.iters, 3) for form in ("auto", "thread", "split")}
            line.update({
                "plain_perms_per_sec": round(b / plain_ms * 1e3, 1),
                "kernel_perms_per_sec": round(b / ms["auto"] * 1e3, 1),
                "speedup": round(plain_ms / ms["auto"], 3),
                "kernel_ms": {form: round(t, 6) for form, t in ms.items()},
                "plain_ms": round(plain_ms, 6),
                "device": card,
            })
        else:
            plain_ms = _host_ms(lambda: tp.permutation_plain(x, consts), 1)
            line.update({
                "host_plain_perms_per_sec": round(b / plain_ms * 1e3, 1),
                "kernel_perms_per_sec": None,
                "device": f"{device} (host clock; the kernel runs only on the card)",
            })
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
