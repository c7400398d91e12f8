#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: build the Poseidon
kernels, hold each against its plain PyTorch version and the golden model,
time both, then verify a batch of 1024 standard-shape fibonacci proofs
through TorchVerifier and check verdicts and transcripts, and then batches
of 512 and 1024 proofs of the gate-zoo circuit (all 16 gate kinds and the
lookup argument) the same way.

Run from the repository root:  python3 chip_smoke.py

Phases (any failed check raises, so the last line is printed only on
success):
1. device: needs CUDA; prints nvidia-smi's name and power limit;
2. build: compiles csrc/*.cu with nvcc (kernels.load) and prints seconds;
3. kernel checks: each kernel bit-exact against its *_plain version on the
   card, on the known-answer state, the p-edge band, 2^20 + 37 random states
   (the permutation in both of its forms, a state per thread and a state per
   half-warp), every sponge width and every path length used, plus rows
   against golden/; the grouped sponge entry point on every width mixed in
   one launch (row counts that are no multiple of the block, an empty
   segment, the edge band) against its plain version, against the
   one-matrix entry point and against golden/; the transcript-scan entry
   point against the plain loop on a real schedule at batch 1, 5 and 1024,
   and lane 0 against golden/;
4. main path: the standard fixture (degree 12, 28 queries, PoW 16), batch
   1024, all accepted; lane 0's transcript equal to golden; six single-array
   mutations rejected on exactly their lanes; a 4-lane heterogeneous batch
   accepted with every lane's transcript equal to golden; over the main-path
   run the scan was launched at least once and the sponge and Merkle kernels
   more than zero times (the sponge twice: the public-input hash and one
   grouped launch for every leaf hash);
5. kernel times at the main path's shapes (batch 1024), kernel and plain,
   each pair also compared bit for bit, each beside its bound (the integer
   work W of csrc/poseidon.cuh over the card's int32 rate at its maximum SM
   clock, or the bytes over 3.35 TB/s, whichever is larger); the
   permutation's step time in both forms at n = 64 ... 16384; the grouped
   sponge launch over the six row matrices of one verifier call, at the
   fibonacci path's widths and at the gate zoo's, beside the same matrices
   hashed one launch each;
6. timing: 5 verifier calls after warm-up -> proofs/s, step ms, and the
   transcript alone;
7. second path: the gate-zoo fixture with lookups (degree 12, 28 queries,
   PoW 16; proved by a child process that starts with phase 2 and is waited
   for here), at batch 512 and 1024: all accepted, lane 0's transcript
   (the lookup deltas among it) equal to golden, seven single-array
   mutations (one a lookup opening inside openings1) rejected on exactly
   their lanes through verify_batch, the launch counters set to 0 before the
   first call and read after it, then step ms and proofs/s.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.

With --sass it also prints the SASS instructions one permutation executes
(kernels.sass_instruction_count; needs cuobjdump), a cross-check of the
kernels' distance from W.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024
DEVICE = None  # the card; a rehearsal on the CPU sets "cpu" with a stand-in kernel library
STANDARD = {"n_arith_rows": 4093, "num_query_rounds": 28, "proof_of_work_bits": 16}
ZOO = {"target_degree_bits": 12, "num_query_rounds": 28, "proof_of_work_bits": 16}  # the gate-zoo shape
ZOO_BATCHES = [512, 1024]
TIMED_CALLS = 5
ZOO_TIMED_CALLS = 3
P = 0xFFFFFFFF00000001
EDGE = [0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P, 2**64 - 1]  # the last two are not canonical
SPONGE_WIDTHS = [0, 1, 3, 7, 8, 9, 16, 20, 32, 83, 135]
PATH_LENS = [0, 1, 3, 7, 11]
N_RANDOM = (1 << 20) + 37  # random permutation states, not a multiple of the block
MUTATED = ["openings1", "pow_witness", "leaves_1", "final_poly", "public_inputs", "circuit_digest"]
SCAN_BATCHES = [1, 5, 1024]
STEP_SIZES = [64, 1024, 4096, 16384]
# The yardstick (csrc/poseidon.cuh): W 32-bit integer instructions a
# permutation, over SMs x 64 int32 lanes x the maximum SM clock; bytes over
# the H100's 3.35 TB/s beside it.
W_INSTRUCTIONS = 19180
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * INT32_LANES_PER_SM * float(clock) * 1e6
    print(f"bound: {sms} SMs x {INT32_LANES_PER_SM} int32 lanes x {clock} MHz (clocks.max.sm) = {rate:.4e} instructions/s; "
          f"W = {W_INSTRUCTIONS} a permutation -> {W_INSTRUCTIONS / rate * 1e9:.4f} ns a permutation")
    return smi, rate


def bound_ms(permutations: int, n_bytes: int, rate: float):
    """(bound ms, "operations" or "bytes"): the larger of the integer work
    over the card's int32 rate and the bytes over its memory rate."""
    ops_ms = permutations * W_INSTRUCTIONS / rate * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _rand(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _max_abs_err(got: np.ndarray, want: np.ndarray) -> int:
    bad = got != want
    if not bad.any():
        return 0
    return max(abs(int(x) - int(y)) for x, y in zip(got[bad][:1000], want[bad][:1000]))


class KernelCheck:
    """Accumulates one kernel's comparison results."""

    def __init__(self, name):
        self.name = name
        self.max_abs_err = 0
        self.cases = 0

    def compare(self, got, want, what: str):
        from plonky2_verifier_tpu_torch.ops.field import to_u64

        got = to_u64(got)
        if not isinstance(want, np.ndarray):
            want = to_u64(want)
        if got.shape != want.shape:
            raise AssertionError(f"{self.name} {what}: shape {got.shape} != {want.shape}")
        err = _max_abs_err(got, want)
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += got.size
        if err:
            raise AssertionError(f"{self.name} {what}: {int((got != want).sum())} words differ, max |err| {err}")


def _golden_scan_lane(data_row, ov_idx, ov_mask):
    """The transcript scan of one lane in Python ints (golden/poseidon.py)."""
    from plonky2_verifier_tpu_torch.golden import poseidon as gp

    state, states = [0] * 12, []
    for idx, mask in zip(ov_idx, ov_mask):
        state = gp.permutation([int(data_row[i]) if m else s for i, m, s in zip(idx, mask, state)])
        states.append(state)
    return np.array(states, dtype=np.uint64)


def check_kernels(lib, consts):
    import torch

    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
    from plonky2_verifier_tpu_torch.golden import hashing as gh
    from plonky2_verifier_tpu_torch.golden import poseidon as gp
    from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
    from plonky2_verifier_tpu_torch.ops import field as tf
    from plonky2_verifier_tpu_torch.ops import hash as th
    from plonky2_verifier_tpu_torch.ops import poseidon as tp
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    rng = np.random.default_rng(2024)
    dev = consts.rc.device
    checks = {k: KernelCheck(k) for k in ("permutation", "sponge_rows", "merkle_fold")}

    # permutation: both forms, and the form the launcher picks
    c = checks["permutation"]
    edge = np.array(EDGE, dtype=np.uint64)
    band = np.concatenate(
        [np.repeat(edge[:, None], 12, axis=1), edge[rng.integers(0, len(EDGE), size=(4096, 12))]]
    )
    cases = [("edge band", band), (f"random {N_RANDOM}", _rand(rng, (N_RANDOM, 12))), ("random 37", _rand(rng, (37, 12)))]
    for form in ("thread", "split", "auto"):
        kat = lib.permutation(tf.from_u64(np.arange(12, dtype=np.uint64).reshape(1, 12), dev), form)
        c.compare(kat, np.array([gp.KAT_OUTPUT], dtype=np.uint64), f"KAT ({form})")
        for what, states in cases:
            x = tf.from_u64(states, dev)
            got = lib.permutation(x, form)
            c.compare(got, tp.permutation_plain(x, consts), f"{what} ({form})")
            golden = np.array([gp.permutation([int(v) for v in s]) for s in states[:8]], dtype=np.uint64)
            c.compare(got[:8], golden, f"{what} ({form}) vs golden")

    # the scan entry point on a real schedule (the 6-query fibonacci template's)
    sched = TorchVerifier(CircuitTemplate(fibonacci_fixture(num_query_rounds=6).common), device=dev)
    ov_idx, ov_mask = sched._ov_idx, sched._ov_mask
    for B in SCAN_BATCHES:
        data_np = _rand(rng, (B, sched.tpl.schedule.n_data))
        data_np[0, :4] = np.array([P, 2**64 - 1, P - 1, 0], dtype=np.uint64)  # proof words need not be canonical
        data = tf.from_u64(data_np, dev)
        want = tp.permutation_scan_plain(data, ov_idx, ov_mask, consts)
        golden = _golden_scan_lane(data_np[0], ov_idx.cpu().numpy(), ov_mask.cpu().numpy())
        for form in ("thread", "split", "auto"):
            got = lib.permutation_scan(data, ov_idx, ov_mask, form)
            c.compare(got, want, f"scan B={B} ({form})")
            c.compare(got[:, 0], golden, f"scan B={B} ({form}) lane 0 vs golden")

    # sponge: one matrix a launch
    c = checks["sponge_rows"]
    for width in SPONGE_WIDTHS:
        rows_np = _rand(rng, (4099, width))
        rows = tf.from_u64(rows_np, dev)
        got = lib.sponge_rows(rows, width)
        c.compare(got, th.sponge_rows_plain(rows, width, consts), f"width {width}")
        golden = np.array([gh.sponge([int(v) for v in r]) for r in rows_np[:4]], dtype=np.uint64).reshape(4, 4)
        c.compare(got[:4], golden, f"width {width} vs golden")

    # sponge, grouped: every width mixed in one launch, row counts that are
    # no multiple of the block, an empty segment, and the edge band
    sizes = [4099, 31, 1, 33, 0, 64, 1000, 32, 7, 2049, 513]
    group_np = [_rand(rng, (n, w)) for n, w in zip(sizes, SPONGE_WIDTHS)]
    group_np += [edge[rng.integers(0, len(EDGE), size=(777, w))] for w in (135, 20, 9)]
    group = [tf.from_u64(x, dev) for x in group_np]
    if len(group) > lib.max_segments:
        raise AssertionError(f"{len(group)} segments do not fit one launch of {lib.max_segments}")
    before = lib.launches["sponge_rows_grouped"]
    got = lib.sponge_rows_grouped(group)
    if lib.launches["sponge_rows_grouped"] != before + 1:
        raise AssertionError("the mixed group took more than one launch")
    want = th.sponge_rows_grouped_plain(group, consts)
    for x_np, x, g, w in zip(group_np, group, got, want):
        what = f"grouped segment {x_np.shape}"
        c.compare(g, w, what)
        c.compare(g, lib.sponge_rows(x, x.shape[1]), f"{what} vs sponge_rows")
        k = min(4, x_np.shape[0])
        golden = np.array([gh.sponge([int(v) for v in r]) for r in x_np[:k]], dtype=np.uint64).reshape(k, 4)
        c.compare(g[:k], golden, f"{what} vs golden")
    # more matrices than one launch takes
    many = [tf.from_u64(_rand(rng, (5 + k, 1 + k)), dev) for k in range(lib.max_segments + 3)]
    for g, w in zip(lib.sponge_rows_grouped(many), th.sponge_rows_grouped_plain(many, consts)):
        c.compare(g, w, f"grouped beyond one launch {tuple(g.shape)}")

    # merkle: path lengths, and sizes on both sides of one wave of blocks
    c = checks["merkle_fold"]
    for L, n in [(L, 4099) for L in PATH_LENS] + [(2, 1), (2, 31), (1, 200003)]:
        dig_np = _rand(rng, (n, 4))
        idx_np = rng.integers(0, 1 << 32, size=n, dtype=np.int64)  # bits above L set
        sib_np = _rand(rng, (n, L, 4))
        dig_np[0], sib_np[0, :, 0] = np.array([P, 2**64 - 1, P - 1, 0], dtype=np.uint64), np.uint64(P)  # not canonical
        dig, idx, sib = tf.from_u64(dig_np, dev), torch.from_numpy(idx_np).to(dev), tf.from_u64(sib_np, dev)
        got = lib.merkle_fold(dig, idx, sib)
        c.compare(got, th.merkle_fold_plain(dig, idx, sib, L, consts), f"L={L} n={n}")
        golden = np.array(
            [gh.reconstruct_merkle_root(tuple(int(v) for v in dig_np[i]), int(idx_np[i]), [tuple(int(v) for v in s) for s in sib_np[i]])[1] for i in range(min(n, 4))],
            dtype=np.uint64,
        )
        c.compare(got[: min(n, 4)], golden, f"L={L} n={n} vs golden")
    for c in checks.values():
        print(f"check {c.name}: {c.cases} words bit-exact against plain and golden")
    return checks


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(lib, consts, v, dev, checks, rate, zoo_tpl):
    """Kernel and plain times at the main path's shapes, each pair also held
    bit-exact against each other, each beside its bound; returns, per kernel,
    the times of its largest main-path call and prints every shape. The
    grouped sponge launch is timed at the main path's six matrices and at
    those of `zoo_tpl`, the second path's template."""
    import torch

    from plonky2_verifier_tpu_torch.ops import field as tf
    from plonky2_verifier_tpu_torch.ops import hash as th
    from plonky2_verifier_tpu_torch.ops import poseidon as tp

    rng = np.random.default_rng(7)
    tpl = v.tpl
    B, Q = BATCH, tpl.num_queries

    def measure(name, what, kernel, plain, iters, permutations, n_bytes, plain_iters=2):
        checks[name].compare(kernel(), plain(), what)
        ms, plain_ms = _time_ms(kernel, iters, 2), _time_ms(plain, plain_iters, plain_iters - 1)
        b_ms, by = bound_ms(permutations, n_bytes, rate)
        print(f"time {name} {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; "
              f"{permutations} permutations, {n_bytes} bytes = {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), share of bound {b_ms / ms:.3f}")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}

    out = {}
    # the transcript scan on the main path's own data and schedule
    data = v._transcript_data(dev, torch.zeros_like(dev["circuit_digest"])).contiguous()
    ov_idx, ov_mask = v._ov_idx, v._ov_mask
    n_perms = ov_idx.shape[0]
    scan_bytes = data.numel() * 8 + ov_idx.numel() * 9 + n_perms * B * 96
    out["permutation"] = measure(
        "permutation", f"scan ({B}, {data.shape[1]}) x {n_perms} steps",
        lambda: lib.permutation_scan(data, ov_idx, ov_mask), lambda: tp.permutation_scan_plain(data, ov_idx, ov_mask, consts),
        20, n_perms * B, scan_bytes, plain_iters=1,
    )
    for form in ("thread", "split"):
        checks["permutation"].compare(lib.permutation_scan(data, ov_idx, ov_mask, form), lib.permutation_scan(data, ov_idx, ov_mask), f"scan form {form}")
        print(f"time permutation scan ({B}) form {form}: {_time_ms(lambda: lib.permutation_scan(data, ov_idx, ov_mask, form), 10, 2):.4f} ms")

    # one step, in both forms and as the launcher picks
    for n in STEP_SIZES:
        x = tf.from_u64(_rand(rng, (n, 12)), "cuda")
        if n == B:
            out["permutation"]["step"] = measure("permutation", f"({n}, 12)", lambda: lib.permutation(x), lambda: tp.permutation_plain(x, consts), 200, n, n * 192)
        forms = {form: _time_ms(lambda: lib.permutation(x, form), 200, 5) for form in ("thread", "split", "auto")}
        print(f"time permutation step n={n}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in forms.items())
              + f", bound {bound_ms(n, n * 192, rate)[0]:.5f} ms")

    def leaf_shapes(t):
        return [(B * t.num_queries, w) for w in t.oracle_widths] + [(B * t.num_queries, 2 << st["arity_bits"]) for st in t.steps]

    for n, w in [(B, tpl.n_pi)] + leaf_shapes(tpl):
        rows = tf.from_u64(_rand(rng, (n, w)), "cuda")
        res = measure("sponge_rows", f"({n}, {w})", lambda: lib.sponge_rows(rows, w), lambda: th.sponge_rows_plain(rows, w, consts), 20, n * -(-w // 8), n * (w + 4) * 8)
        if w == max(tpl.oracle_widths):
            widest = res
    # every leaf hash of one verifier call in one launch, beside one launch a matrix
    for name, t in [("the main path", tpl), ("the gate-zoo path", zoo_tpl)]:
        shapes = leaf_shapes(t)
        group = [tf.from_u64(_rand(rng, shape), "cuda") for shape in shapes]
        res = measure(
            "sponge_rows", f"grouped, {name}: {shapes}",
            lambda: torch.cat(lib.sponge_rows_grouped(group)), lambda: torch.cat(th.sponge_rows_grouped_plain(group, consts)),
            20, sum(n * -(-w // 8) for n, w in shapes), sum(n * (w + 4) * 8 for n, w in shapes), plain_iters=1,
        )
        apart = _time_ms(lambda: [lib.sponge_rows(rows, rows.shape[1]) for rows in group], 20, 2)
        print(f"time sponge_rows grouped, {name}: the same matrices one launch each {apart:.4f} ms")
        if t is tpl:
            out["sponge_rows"] = dict(res, widest=widest)

    paths = [(B * 4 * Q, tpl.initial_path_len)] + [(B * Q, st["path_len"]) for st in tpl.steps]
    for n, L in paths:
        dig = tf.from_u64(_rand(rng, (n, 4)), "cuda")
        idx = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.int64)).cuda()
        sib = tf.from_u64(_rand(rng, (n, L, 4)), "cuda")
        res = measure("merkle_fold", f"({n}, L={L})", lambda: lib.merkle_fold(dig, idx, sib), lambda: th.merkle_fold_plain(dig, idx, sib, L, consts), 20, n * L, n * (72 + 32 * L))
        if L == tpl.initial_path_len:
            out["merkle_fold"] = res
    return out


def _transcript_equals_golden(common, dbg, lane, vkey, pwp):
    from plonky2_verifier_tpu_torch.golden.challenges import proof_challenges
    from plonky2_verifier_tpu_torch.golden.hashing import sponge
    from plonky2_verifier_tpu_torch.ops.field import to_u64

    ch = proof_challenges(common, vkey, pwp)
    u = lambda t: [int(v) for v in np.atleast_1d(to_u64(t[lane]))]
    got = {
        "zeta": (u(dbg["zeta"][0])[0], u(dbg["zeta"][1])[0]),
        "betas": [u(b)[0] for b in dbg["betas"]],
        "gammas": [u(g)[0] for g in dbg["gammas"]],
        "alphas": [u(a)[0] for a in dbg["alphas"]],
        "deltas": [tuple(u(x)[0] for x in d) for d in dbg["deltas"]],
        "fri_alpha": (u(dbg["fri_alpha"][0])[0], u(dbg["fri_alpha"][1])[0]),
        "pow_response": u(dbg["pow_response"])[0],
        "query_indices": u(dbg["query_indices"]),
        "pi_hash": tuple(u(dbg["pi_hash"])),
    }
    want = {
        "zeta": tuple(ch.zeta),
        "betas": list(ch.betas),
        "gammas": list(ch.gammas),
        "alphas": list(ch.alphas),
        "deltas": [(d.a, d.b, d.alpha, d.delta) for d in ch.deltas],
        "fri_alpha": tuple(ch.fri.alpha),
        "pow_response": ch.fri.pow_response,
        "query_indices": list(ch.fri.query_indices),
        "pi_hash": tuple(sponge(pwp.public_inputs)),
    }
    for k in want:
        if got[k] != want[k]:
            raise AssertionError(f"lane {lane}: {k} differs from golden: {got[k]} != {want[k]}")


def _check_launches(launches, what: str):
    """The scan once, the Merkle walk at least once, and the sponge twice:
    the public-input hash and one grouped launch for every leaf hash."""
    if launches["permutation_scan"] < 1 or launches["merkle_fold"] <= 0:
        raise AssertionError(f"a kernel was not launched on {what}: {launches}")
    if (launches["sponge_rows"], launches["sponge_rows_grouped"]) != (1, 1):
        raise AssertionError(f"{what} should launch the sponge twice (one matrix, one group): {launches}")


def _check_mutations(tpl, arrays, batch: int, names):
    """Lane k gets one u64 of array names[k] flipped (a (name, column) pair
    flips that column's first word); exactly those lanes must be rejected,
    through the one-call entry point."""
    from plonky2_verifier_tpu_torch.verifier_torch import verify_batch

    mutated = {k: a.copy() for k, a in arrays.items()}
    for lane, name in enumerate(names):
        name, column = name if isinstance(name, tuple) else (name, 0)
        mutated[name].reshape(batch, -1)[lane, column] ^= np.uint64(1)
    out_m = verify_batch(tpl, mutated, device=DEVICE)["ok"]
    rejected = sorted(int(i) for i in np.flatnonzero(~out_m))
    print(f"mutations {names}: rejected lanes {rejected}")
    if rejected != list(range(len(names))):
        raise AssertionError("mutated lanes are not exactly the rejected ones")


def main_path(lib):
    import torch

    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
    from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
    from plonky2_verifier_tpu_torch.prover.prove import prove
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    t = time.time()
    common, vkey, pwp = get_fixture_proof("fibonacci", **STANDARD)
    tpl = CircuitTemplate(common)
    print(f"fixture: {time.time() - t:.1f} s (degree_bits {tpl.degree_bits}, {tpl.num_queries} queries, PoW {tpl.pow_bits})")
    t = time.time()
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * BATCH)
    print(f"flatten_proofs x{BATCH}: {time.time() - t:.1f} s, {sum(a.nbytes for a in arrays.values())} bytes")

    v = TorchVerifier(tpl, debug=True, device=DEVICE)
    dev = v.prepare(arrays)
    torch.cuda.synchronize()

    lib.reset_launches()
    t = time.time()
    out = v(dev)
    torch.cuda.synchronize()
    first_s = time.time() - t
    launches = dict(lib.launches)
    print(f"main path: first call {first_s:.3f} s, launches {launches}")
    n_ok = int(out["ok"].sum())
    print(f"accepted {n_ok}/{BATCH} (eqs_ok {int(out['eqs_ok'].sum())}, fri_ok {int(out['fri_ok'].sum())})")
    if n_ok != BATCH:
        raise AssertionError("standard batch not fully accepted")
    _check_launches(launches, "the main path")
    _transcript_equals_golden(common, out["debug"], 0, vkey, pwp)
    print("lane 0 transcript equals golden")
    _check_mutations(tpl, arrays, BATCH, MUTATED)

    fx0 = fibonacci_fixture(num_query_rounds=6)
    tpl6 = CircuitTemplate(fx0.common)
    lanes = [prove(fibonacci_fixture(num_query_rounds=6, x0=a, x1=b)) for a, b in [(1, 2), (3, 5), (10, 11), (7, 1)]]
    v6 = TorchVerifier(tpl6, debug=True, device=DEVICE)
    out6 = v6(v6.prepare(flatten_proofs(tpl6, lanes)))
    if not bool(out6["ok"].all()):
        raise AssertionError(f"heterogeneous batch rejected: {out6['ok']}")
    for lane, (vk, pw) in enumerate(lanes):
        _transcript_equals_golden(fx0.common, out6["debug"], lane, vk, pw)
    print("heterogeneous 4-lane batch accepted; every lane's transcript equals golden")
    return v, dev, launches


def time_main_path(v, dev, batch: int, iters: int, warmup: int = 2):
    import torch

    for _ in range(warmup):
        v(dev)
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(iters):
        out = v(dev)
    torch.cuda.synchronize()
    step = (time.time() - t) / iters
    if not bool(out["ok"].all()):
        raise AssertionError("timed batch not fully accepted")
    print(f"step_ms {step * 1e3:.3f}")
    print(f"proofs_per_s {batch / step:.1f}")
    print(f"batch {batch}")

    # transcript alone (one scan launch plus the slicing of its states)
    pi_hash = torch.zeros_like(dev["circuit_digest"])
    data = v._transcript_data(dev, pi_hash)
    print(f"transcript_ms {_time_ms(lambda: v._run_transcript(data), 20, 2):.3f}")
    return step


ZOO_PROVER = """
import sys, time
sys.path.insert(0, {root!r})
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
t = time.time()
get_fixture_proof("gate_zoo", **{params!r})
print(f"{{time.time() - t:.1f}}")
"""


def start_zoo_prover():
    """A child process that proves the gate-zoo fixture into the fixture
    cache while this process builds, checks and drives the first path."""
    code = ZOO_PROVER.format(root=ROOT, params=ZOO)
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def zoo_fixture(prover=None):
    """The gate-zoo template and proof; waits for `prover` first, if given."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
    from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof

    t = time.time()
    if prover is not None:
        out, err = prover.communicate()
        if prover.returncode != 0:
            raise RuntimeError(f"proving the gate-zoo fixture failed ({prover.returncode}):\n{err}")
        print(f"gate zoo fixture: proved in {out.strip()} s by the child process, waited {time.time() - t:.1f} s for it")
    common, vkey, pwp = get_fixture_proof("gate_zoo", **ZOO)
    tpl = CircuitTemplate(common)
    print(f"gate zoo fixture: {time.time() - t:.1f} s (degree_bits {tpl.degree_bits}, {tpl.num_queries} queries, PoW {tpl.pow_bits}, "
          f"{tpl.num_wires} wires, {len(common.gates)} gates of {len({g.kind for g in common.gates})} kinds, {tpl.n_lookup} lookup openings, "
          f"oracle widths {tpl.oracle_widths})")
    if tpl.n_lookup == 0:
        raise AssertionError("the gate-zoo fixture has no lookups")
    return tpl, common, vkey, pwp


def zoo_path(lib, zoo):
    """The second path: the gate-zoo template with lookups through
    TorchVerifier at each batch of ZOO_BATCHES. Returns the launch counts of
    each batch's first call."""
    import torch

    from plonky2_verifier_tpu_torch.compiler import flatten_proofs
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    tpl, common, vkey, pwp = zoo
    # one u64 flipped in each array, and a lookup opening inside openings1
    lookup_at = 2 * (tpl.n_const_cols + tpl.n_sigmas + tpl.num_wires + tpl.n_zs + tpl.n_pp + tpl.n_quot)
    names = MUTATED + [("openings1", lookup_at)]
    v = TorchVerifier(tpl, debug=True, device=DEVICE)
    counts = {}
    for batch in ZOO_BATCHES:
        arrays = flatten_proofs(tpl, [(vkey, pwp)] * batch)
        dev = v.prepare(arrays)
        torch.cuda.synchronize()
        lib.reset_launches()
        t = time.time()
        out = v(dev)
        torch.cuda.synchronize()
        first_s = time.time() - t
        counts[batch] = launches = dict(lib.launches)
        print(f"gate zoo batch {batch}: first call {first_s:.3f} s, launches {launches}")
        n_ok = int(out["ok"].sum())
        print(f"gate zoo batch {batch}: accepted {n_ok}/{batch} (eqs_ok {int(out['eqs_ok'].sum())}, fri_ok {int(out['fri_ok'].sum())})")
        if n_ok != batch:
            raise AssertionError(f"gate-zoo batch {batch} not fully accepted")
        _check_launches(launches, f"the gate-zoo path at batch {batch}")
        _transcript_equals_golden(common, out["debug"], 0, vkey, pwp)
        print(f"gate zoo batch {batch}: lane 0 transcript equals golden")
        _check_mutations(tpl, arrays, batch, names)
        if ZOO_TIMED_CALLS:
            print(f"gate zoo batch {batch} timing:")
            time_main_path(v, dev, batch, ZOO_TIMED_CALLS, warmup=1)
        del dev, arrays
    return counts


def main():
    smi, rate = device_phase()
    sys.path.insert(0, ROOT)
    import torch

    from plonky2_verifier_tpu_torch import kernels
    from plonky2_verifier_tpu_torch.ops.poseidon import PoseidonConstants

    prover = start_zoo_prover()
    try:
        t = time.time()
        lib = kernels.load()
        print(f"build_s {time.time() - t:.1f}")
        consts = PoseidonConstants()

        checks = check_kernels(lib, consts)
        v, dev, launches = main_path(lib)
        zoo = zoo_fixture(prover)
    finally:
        if prover.poll() is None:
            prover.kill()
            prover.wait()
    times = time_kernels(lib, consts, v, dev, checks, rate, zoo[0])
    time_main_path(v, dev, BATCH, TIMED_CALLS)
    del dev
    zoo_launches = zoo_path(lib, zoo)
    if "--sass" in sys.argv[1:]:
        counts = kernels.sass_instruction_count()
        top = sorted(counts.items(), key=lambda kv: -kv[1])
        print(f"sass: {sum(counts.values())} instructions in one thread-form permutation "
              f"(W = {W_INSTRUCTIONS}): " + ", ".join(f"{k} {n}" for k, n in top))
    for what, n in [("the main path", launches)] + [(f"the gate-zoo path at batch {b}", n) for b, n in zoo_launches.items()]:
        print(f"launches on {what}: " + ", ".join(f"{k} {n[k]}" for k in kernels.COUNTERS))
    print(f"card: {smi}")

    sources = {"permutation": "permutation.cu", "sponge_rows": "sponge.cu", "merkle_fold": "merkle.cu"}
    replaces = {
        "permutation": "plonky2_verifier_tpu/ops/pallas_poseidon.py:122",
        "sponge_rows": "plonky2_verifier_tpu/ops/pallas_hash.py:112",
        "merkle_fold": "plonky2_verifier_tpu/ops/pallas_hash.py:171",
    }
    entry_points = {
        "permutation": ("permutation", "permutation_scan"),
        "sponge_rows": ("sponge_rows", "sponge_rows_grouped"),
        "merkle_fold": ("merkle_fold",),
    }
    rows = []
    for name in kernels.KERNELS:
        tm = times[name]
        row = {
            "name": name,
            "route": "cuda",
            "source": f"plonky2_verifier_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            # a kernel's entry points count together; the first path's run
            "launches": sum(launches[k] for k in entry_points[name]),
            "max_abs_err": checks[name].max_abs_err,
            "ms": round(tm["ms"], 6),
            "plain_ms": round(tm["plain_ms"], 6),
            "bound_ms": round(tm["bound_ms"], 6),
            "bound_by": tm["bound_by"],
            "library_ms": None,  # no PyTorch operator computes Poseidon over Goldilocks
        }
        for b, n in zoo_launches.items():
            row[f"launches_zoo_{b}"] = sum(n[k] for k in entry_points[name])
        # beside the launch the main path makes: one (1024, 12) permutation
        # step beside the scan, the widest single matrix beside the grouped sponge
        for extra in ("step", "widest"):
            if extra in tm:
                row.update({f"{extra}_{k}": round(x, 6) if isinstance(x, float) else x for k, x in tm[extra].items()})
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
