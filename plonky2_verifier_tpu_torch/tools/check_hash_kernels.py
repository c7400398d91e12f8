"""Bit-exactness check of the port's CUDA kernels on the card: the three
hash kernels, the counterpart of tools/check_hash_kernels.py, then the
field kernels and the gate program (tools/check_field_kernels.py).

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.check_hash_kernels [--device cpu]
      [--random N] [--rows N]

Holds, against the plain PyTorch versions and the golden (Python-int) model:
- the Poseidon-12 permutation in both of its forms (a state per thread, a
  state per half-warp) and as the launcher picks: the reference's
  known-answer test, the p-edge band (non-canonical words among it) and
  `--random` random states; the transcript-scan entry point on a real
  schedule at several batch sizes, lane 0 against golden/;
- the row sponge over every leaf-row width in use, one matrix a launch, and
  the grouped entry point on every width mixed in one launch (row counts
  that are no multiple of the block, an empty segment, the edge band, more
  matrices than one launch takes);
- the Merkle path walk over every path length in use, sibling ordering by
  index bit, sizes on both sides of one wave of blocks;
- the extension Horner sum, the Fermat inversion, the exponentiations, the
  levelized gate program, the FRI coset folds, L0 with the partial products
  and the lookup argument (`check_field_kernels.check_field_kernels`).

Prints one JSON line; exit code 0 iff every word is bit-exact. chip_smoke.py
calls `check_kernels` for its kernel phase. With --device cpu the plain
versions stand in for the kernels (PlainLibrary), so the run holds them
against golden/ alone and needs no card.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..golden import hashing as gh
from ..golden import poseidon as gp
from ..ops import field as tf
from ..ops import hash as th
from ..ops import poseidon as tp
from ..kernels import horner_segments
from .check_field_kernels import (check_field_kernels, coset_fold_rows_plain, gate_filter_rows_plain, golden_packed_program, horner_split_plain,
                                  inv_grouped_split_plain, lookup_checks_rows_plain, partial_products_rows_plain, pow_grouped_rows_plain,
                                  pow_rows_plain)

P = tf.P
EDGE = [0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P, 2**64 - 1]  # the last two are not canonical
SPONGE_WIDTHS = [0, 1, 3, 7, 8, 9, 16, 20, 32, 83, 135]
PATH_LENS = [0, 1, 3, 7, 11]
N_RANDOM = (1 << 20) + 37  # random permutation states, not a multiple of the block
N_ROWS = 4099
SCAN_BATCHES = [1, 5, 1024]
KERNELS = ("permutation", "sponge_rows", "merkle_fold", "horner", "inv", "pow", "gate_program", "coset_fold", "partial_products",
           "lookup_checks", "gate_filter")


def rand_words(rng, shape) -> np.ndarray:
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
        got = tf.to_u64(got)
        if not isinstance(want, np.ndarray):
            want = tf.to_u64(want)
        if got.shape != want.shape:
            raise AssertionError(f"{self.name} {what}: shape {got.shape} != {want.shape}")
        err = _max_abs_err(got, want)
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += got.size
        if err:
            raise AssertionError(f"{self.name} {what}: {int((got != want).sum())} words differ, max |err| {err}")


def new_checks():
    return {k: KernelCheck(k) for k in KERNELS}


class PlainLibrary:
    """The plain versions behind the kernel library's interface, for a run
    without a card: no forms, and a "launch" is a call. The Horner sum and
    the gate program run in the kernels' own order (horner_split_plain, the
    packed program in Python ints), as do the grouped inversion and
    exponentiation (inv_grouped_split_plain, pow_grouped_rows_plain), the
    coset folds, the partial products, the lookup argument and the gate
    filter (coset_fold_rows_plain, partial_products_rows_plain,
    lookup_checks_rows_plain, gate_filter_rows_plain)."""

    max_segments = 16
    sms = 132  # the H100's, for the Horner segment rule

    def __init__(self, consts):
        self.consts = consts
        self.launches = {"sponge_rows_grouped": 0, "horner": 0, "inv": 0, "inv_grouped": 0, "pow": 0, "pow_grouped": 0, "gate_program": 0,
                         "coset_fold": 0, "partial_products": 0, "lookup_checks": 0, "gate_filter": 0}

    def permutation(self, state, form="auto"):
        return tp.permutation_plain(state, self.consts)

    def permutation_scan(self, data, ov_idx, ov_mask, form="auto"):
        return tp.permutation_scan_plain(data, ov_idx, ov_mask, self.consts)

    def sponge_rows(self, rows, width):
        return th.sponge_rows_plain(rows, width, self.consts)

    def sponge_rows_grouped(self, rows_list):
        self.launches["sponge_rows_grouped"] += 1
        return th.sponge_rows_grouped_plain(rows_list, self.consts)

    def merkle_fold(self, digest, index, sibs):
        return th.merkle_fold_plain(digest, index, sibs, sibs.shape[1], self.consts)

    def horner(self, v_re, v_im, p_re, p_im, v_rep=1, p_rep=1):
        if v_re.shape[0]:
            self.launches["horner"] += 1
        n, k = v_re.shape[0] * v_rep, v_re.shape[1]
        return horner_split_plain(v_re, v_im, p_re, p_im, v_rep, p_rep, horner_segments(n, k, self.sms))

    def inv(self, a):
        if a.numel():
            self.launches["inv"] += 1
        return tf.inv_plain(a)

    def inv_grouped(self, a):
        if a.numel():
            self.launches["inv_grouped"] += 1
        return inv_grouped_split_plain(a)

    def pow_grouped(self, idx, gens, exts):
        out = pow_grouped_rows_plain(idx, gens, exts)  # raises, uncounted, where the library refuses
        self.launches["pow_grouped"] += any(x.numel() for x in out[0]) or any(re.numel() for re, _ in out[1])
        return out

    def pow(self, b_re, b_im, exponent, n_bits=0, b_rep=1):
        out = pow_rows_plain(b_re, b_im, exponent, n_bits, b_rep)  # raises, uncounted, where the library refuses
        self.launches["pow"] += bool(b_re.shape[0])
        return out

    def gate_program(self, inputs, packed, form="auto"):
        if any(re is not None and re.shape[0] for _, re, _ in inputs):
            self.launches["gate_program"] += 1
        return golden_packed_program(inputs, packed)

    def coset_fold(self, steps):
        out = coset_fold_rows_plain(steps)
        self.launches["coset_fold"] += bool(out.numel())
        return out

    def partial_products(self, *args):
        out = partial_products_rows_plain(*args)
        self.launches["partial_products"] += bool(out[0].numel())
        return out

    def lookup_checks(self, *args):
        out = lookup_checks_rows_plain(*args)
        self.launches["lookup_checks"] += bool(out[0].numel())
        return out

    def gate_filter(self, sels, cons, cols, consts, mask, n_gc):
        out = gate_filter_rows_plain(sels, cons, cols, consts, mask, n_gc)
        self.launches["gate_filter"] += bool(out[0].shape[0] and cols.shape[0])
        return out


def golden_scan_lane(data_row, ov_idx, ov_mask):
    """The transcript scan of one lane in Python ints (golden/poseidon.py)."""
    state, states = [0] * 12, []
    for idx, mask in zip(ov_idx, ov_mask):
        state = gp.permutation([int(data_row[i]) if m else s for i, m, s in zip(idx, mask, state)])
        states.append(state)
    return np.array(states, dtype=np.uint64)


def check_kernels(lib, consts, n_random: int = N_RANDOM, n_rows: int = N_ROWS, scan_batches=SCAN_BATCHES):
    """Every kernel of `lib` (kernels.KernelLibrary, or PlainLibrary) against
    its plain version and golden/; returns the KernelChecks. Raises on the
    first word that differs."""
    from ..compiler import CircuitTemplate
    from ..models.fibonacci import fibonacci_fixture
    from ..verifier_torch import TorchVerifier

    rng = np.random.default_rng(2024)
    dev = consts.rc.device
    forms = ("auto",) if isinstance(lib, PlainLibrary) else ("thread", "split", "auto")
    checks = new_checks()

    # permutation: both forms, and the form the launcher picks
    c = checks["permutation"]
    edge = np.array(EDGE, dtype=np.uint64)
    band = np.concatenate(
        [np.repeat(edge[:, None], 12, axis=1), edge[rng.integers(0, len(EDGE), size=(n_rows - 3, 12))]]
    )
    cases = [("edge band", band), (f"random {n_random}", rand_words(rng, (n_random, 12))), ("random 37", rand_words(rng, (37, 12)))]
    for form in forms:
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
    for B in scan_batches:
        data_np = rand_words(rng, (B, sched.tpl.schedule.n_data))
        data_np[0, :4] = np.array([P, 2**64 - 1, P - 1, 0], dtype=np.uint64)  # proof words need not be canonical
        data = tf.from_u64(data_np, dev)
        want = tp.permutation_scan_plain(data, ov_idx, ov_mask, consts)
        golden = golden_scan_lane(data_np[0], ov_idx.cpu().numpy(), ov_mask.cpu().numpy())
        for form in forms:
            got = lib.permutation_scan(data, ov_idx, ov_mask, form)
            c.compare(got, want, f"scan B={B} ({form})")
            c.compare(got[:, 0], golden, f"scan B={B} ({form}) lane 0 vs golden")

    # sponge: one matrix a launch
    c = checks["sponge_rows"]
    for width in SPONGE_WIDTHS:
        rows_np = rand_words(rng, (n_rows, width))
        rows = tf.from_u64(rows_np, dev)
        got = lib.sponge_rows(rows, width)
        c.compare(got, th.sponge_rows_plain(rows, width, consts), f"width {width}")
        golden = np.array([gh.sponge([int(v) for v in r]) for r in rows_np[:4]], dtype=np.uint64).reshape(4, 4)
        c.compare(got[:4], golden, f"width {width} vs golden")

    # sponge, grouped: every width mixed in one launch, row counts that are
    # no multiple of the block, an empty segment, and the edge band; no
    # matrix above n_rows rows (--rows cuts the CPU run)
    sizes = [min(n, n_rows) for n in [n_rows, 31, 1, 33, 0, 64, 1000, 32, 7, 2049, 513]]
    group_np = [rand_words(rng, (n, w)) for n, w in zip(sizes, SPONGE_WIDTHS)]
    group_np += [edge[rng.integers(0, len(EDGE), size=(min(777, n_rows), w))] for w in (135, 20, 9)]
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
    many = [tf.from_u64(rand_words(rng, (5 + k, 1 + k)), dev) for k in range(lib.max_segments + 3)]
    for g, w in zip(lib.sponge_rows_grouped(many), th.sponge_rows_grouped_plain(many, consts)):
        c.compare(g, w, f"grouped beyond one launch {tuple(g.shape)}")

    # merkle: path lengths, and sizes on both sides of one wave of blocks
    c = checks["merkle_fold"]
    for L, n in [(L, n_rows) for L in PATH_LENS] + [(2, 1), (2, 31), (1, 49 * n_rows)]:
        dig_np = rand_words(rng, (n, 4))
        idx_np = rng.integers(0, 1 << 32, size=n, dtype=np.int64)  # bits above L set
        sib_np = rand_words(rng, (n, L, 4))
        dig_np[0], sib_np[0, :, 0] = np.array([P, 2**64 - 1, P - 1, 0], dtype=np.uint64), np.uint64(P)  # not canonical
        dig, idx, sib = tf.from_u64(dig_np, dev), torch.from_numpy(idx_np).to(dev), tf.from_u64(sib_np, dev)
        got = lib.merkle_fold(dig, idx, sib)
        c.compare(got, th.merkle_fold_plain(dig, idx, sib, L, consts), f"L={L} n={n}")
        golden = np.array(
            [gh.reconstruct_merkle_root(tuple(int(v) for v in dig_np[i]), int(idx_np[i]), [tuple(int(v) for v in s) for s in sib_np[i]])[1] for i in range(min(n, 4))],
            dtype=np.uint64,
        )
        c.compare(got[: min(n, 4)], golden, f"L={L} n={n} vs golden")
    for name in ("permutation", "sponge_rows", "merkle_fold"):
        print(f"check {name}: {checks[name].cases} words bit-exact against plain and golden")
    return check_field_kernels(lib, checks, dev, n_random)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.check_hash_kernels")
    p.add_argument("--device", default=None, help="without it the CUDA card, and an error where there is none")
    p.add_argument("--random", type=int, default=N_RANDOM, help="random permutation states, and words to invert")
    p.add_argument("--rows", type=int, default=N_ROWS, help="rows of each sponge matrix and Merkle batch, at most")
    args = p.parse_args(argv)

    t0 = time.time()
    device = tf.resolve_device(args.device)
    consts = tp.PoseidonConstants(device)
    if device.type == "cuda":
        from .. import kernels

        lib, name = kernels.load(), torch.cuda.get_device_name(device)
    else:
        lib, name = PlainLibrary(consts), f"{device} (the plain versions against golden/ alone)"
    res = {"device": name}
    try:
        checks = check_kernels(lib, consts, args.random, args.rows, [b for b in SCAN_BATCHES if b <= args.rows])
    except AssertionError as e:
        res.update({"pass": False, "error": str(e)})
    else:
        for k, c in checks.items():
            res[f"{k}_bit_exact"] = c.max_abs_err == 0
            res[f"{k}_words"] = c.cases
        res["pass"] = all(c.max_abs_err == 0 for c in checks.values())
    res["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(res))
    return 0 if res["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
