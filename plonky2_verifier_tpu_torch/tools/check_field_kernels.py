"""Bit-exactness check of the two field kernels (csrc/field.cu) on the card:
the extension Horner sum and the Fermat inversion, against their plain
PyTorch versions (`verifier_torch.horner_ext_plain`, `ops/field.inv_plain`)
and the golden (Python-int) model. `tools/check_hash_kernels.py` runs it
after the Poseidon kernels, for its command line and chip_smoke.py's kernel
phase.

Every input mixes random canonical words with the p-edge band and random
words x + p (x < 2^32 - 1): proof words need not be canonical, and the
kernels must give the plain bits for them too.
- inv: `n_random` random words, the band and 4,096 words x + p, flat and as
  (rows, 28); zero words give zero; an empty tensor launches nothing.
- horner: both template flags (base-field values, base-field point) in all
  four combinations, the interleaved openings' column stride of 2, rows
  repeated through v_rep and p_rep (the wrappers' stride-0 rows), widths
  around the 32-column chunk, K = 0 (zeros) and no rows at all (no launch),
  combineInitial's width of 254 on about 2^20 words.
"""

import numpy as np
import torch

from ..golden import field as gf
from ..ops import field as tf
from ..ops.field import GExt
from ..verifier_torch import horner_ext_plain

P = tf.P
EDGE = [0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P, 2**64 - 1]  # the last two are not canonical
N_RANDOM = (1 << 20) + 37
GOLDEN_ROWS = 3
# (rows of values, K, base-field values, base-field point, v_rep, p_rep, interleaved)
HORNER_CASES = [
    (147, 254, True, False, 28, 1, False),  # combineInitial: (B, Q, 254) leaf words, the point a proof's (B,) alpha
    (4116, 254, True, False, 1, 28, False),
    (2053, 254, False, False, 1, 1, True),  # the reduced openings: interleaved (re, im)
    (97, 77, False, True, 5, 1, False),  # horner_scaled: values (B, K) broadcast over r scales
    (511, 16, False, False, 1, 7, False),  # a coset fold
    (140, 8, False, True, 1, 28, True),  # the final polynomial at a base-field x, one polynomial a proof
    (300, 33, True, True, 1, 1, False),
    (65, 1, False, False, 1, 1, False),
    (33, 31, False, False, 3, 1, False),
    (31, 32, True, False, 1, 1, False),
    (37, 0, False, False, 1, 1, False),  # K = 0: zeros
    (0, 5, False, False, 1, 1, False),  # no rows: no launch
]


def words(rng, shape) -> np.ndarray:
    """Random canonical words with the edge band and words x + p among them."""
    out = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = out.reshape(-1)
    k = flat.size // 4
    flat[:k] = np.array(EDGE, dtype=np.uint64)[rng.integers(0, len(EDGE), size=k)]
    flat[k : 2 * k] = rng.integers(0, 2**32 - 1, size=k, dtype=np.uint64) + np.uint64(P)
    rng.shuffle(flat)
    return out


def horner_rows_plain(v_re, v_im, p_re, p_im, v_rep: int = 1, p_rep: int = 1):
    """What `KernelLibrary.horner` computes, by the plain version."""
    g = lambda t, rep: None if t is None else t.repeat_interleave(rep, 0)
    v_re, v_im, p_re, p_im = g(v_re, v_rep), g(v_im, v_rep), g(p_re, p_rep), g(p_im, p_rep)
    out = horner_ext_plain(
        GExt(v_re, torch.zeros_like(v_re) if v_im is None else v_im),
        GExt(p_re, torch.zeros_like(p_re) if p_im is None else p_im),
    )
    return out.re, out.im


def _golden_horner(v_re, v_im, p_re, p_im):
    """One row's sum in Python ints: values (K,), the point a word each."""
    pt = (int(p_re) % P, 0 if p_im is None else int(p_im) % P)
    acc = (0, 0)
    for k in range(len(v_re) - 1, -1, -1):
        acc = gf.eadd((int(v_re[k]) % P, 0 if v_im is None else int(v_im[k]) % P), gf.emul(pt, acc))
    return acc


def check_field_kernels(lib, checks, dev, n_random: int = N_RANDOM):
    """Both field kernels of `lib` (kernels.KernelLibrary, or the CPU run's
    PlainLibrary) into checks["inv"] and checks["horner"]; raises on the
    first word that differs."""
    rng = np.random.default_rng(2026)

    c = checks["inv"]
    a_np = np.concatenate([
        np.array(EDGE, dtype=np.uint64),
        rng.integers(0, 2**32 - 1, size=4096, dtype=np.uint64) + np.uint64(P),
        rng.integers(0, P, size=n_random, dtype=np.uint64),
    ])
    a = tf.from_u64(a_np, dev)
    got = lib.inv(a)
    c.compare(got, tf.inv_plain(a), f"{a_np.size} words")
    head = a_np[: len(EDGE) + 4096 + 64]
    c.compare(got[: head.size], np.array([pow(int(x) % P, P - 2, P) for x in head], dtype=np.uint64), "vs golden")
    grid = a[: min(a.numel() // 28, 1024) * 28].reshape(-1, 28)  # (B, Q) as off_inv's
    c.compare(lib.inv(grid), tf.inv_plain(grid), f"{tuple(grid.shape)}")
    before = lib.launches.get("inv", 0)
    if lib.inv(a[:0]).numel() or lib.launches.get("inv", 0) != before:
        raise AssertionError("inv of no words launched or returned words")

    c = checks["horner"]
    for rows, k, base_v, base_p, v_rep, p_rep, interleaved in HORNER_CASES:
        n = rows * v_rep
        what = (f"({rows} x {v_rep}, {k}) {'base' if base_v else 'ext'} values, {'base' if base_p else 'ext'} point "
                f"x {p_rep}{', interleaved' if interleaved else ''}")
        v_np = words(rng, (rows, k, 2))
        p_np = words(rng, (n // p_rep, 2))
        if interleaved:
            v = tf.from_u64(v_np, dev)
            v_re, v_im = v[..., 0], v[..., 1]  # column stride 2
        else:
            v_re, v_im = tf.from_u64(v_np[..., 0], dev), tf.from_u64(v_np[..., 1], dev)
        if base_v:
            v_re, v_im, v_np[..., 1] = v_re.contiguous(), None, 0
        p_re, p_im = tf.from_u64(p_np[:, 0], dev), None if base_p else tf.from_u64(p_np[:, 1], dev)
        if base_p:
            p_np[:, 1] = 0
        before = lib.launches.get("horner", 0)
        got = lib.horner(v_re, v_im, p_re, p_im, v_rep, p_rep)
        if lib.launches.get("horner", 0) != before + (1 if n else 0):
            raise AssertionError(f"horner {what}: {lib.launches.get('horner', 0) - before} launches")
        want = horner_rows_plain(v_re, v_im, p_re, p_im, v_rep, p_rep)
        for part, g, w in zip(("re", "im"), got, want):
            if g.shape != (n,):
                raise AssertionError(f"horner {what}: {part} has shape {tuple(g.shape)}")
            c.compare(g, w, f"{what} {part}")
        if k == 0 and n and (tf.to_u64(got[0]).any() or tf.to_u64(got[1]).any()):
            raise AssertionError("horner with K = 0 is not zero")
        for row in list(range(0, n, max(n // GOLDEN_ROWS, 1)))[:GOLDEN_ROWS]:
            vr, pr = row // v_rep, row // p_rep
            gold = _golden_horner(v_np[vr, :, 0], None if base_v else v_np[vr, :, 1], p_np[pr, 0], None if base_p else p_np[pr, 1])
            c.compare(torch.stack([got[0][row], got[1][row]]), np.array(gold, dtype=np.uint64), f"{what} row {row} vs golden")
    for name in ("horner", "inv"):
        print(f"check {name}: {checks[name].cases} words bit-exact against plain and golden")
    return checks
