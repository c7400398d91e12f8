"""Vectorized Goldilocks arithmetic on numpy uint64 arrays (host prover tier).

The fixture prover has to evaluate the full constraint system over LDE
domains of 2^15+ points and hash hundreds of thousands of Merkle leaves; the
pure-python golden model (plonky2_verifier_tpu.golden.field) is the bit-exact
oracle but is ~10^4x too slow for that. This module carries the same
semantics (reference: Algebra/Goldilocks.hs:126-184, GoldilocksExt.hs:24-106)
on whole numpy arrays at once:

- elements are canonical (< p) uint64 scalars/arrays,
- multiplication splits into 32-bit halves (the 128-bit product is exact in
  four uint64 partials) and reduces with 2^64 = 2^32 - 1 (mod p), branch-free
  via `np.where`,
- the quadratic extension is a (re, im) pair of arrays with X^2 = 7,
- the radix-2 (I)FFT/coset-LDE vectorizes the butterfly over every column of
  a committed matrix per stage; extension codewords transform componentwise
  (the butterfly is F_p-linear).

Every function is validated bit-exactly against the golden model in
tests/test_np_prover.py, including the p-1..p edge band.
"""

from __future__ import annotations

import functools
from functools import lru_cache
from typing import Tuple

import numpy as np

from ..golden import field as gf


def _wrapping(fn):
    """uint64 wraparound is the point here; silence numpy's 0-d overflow
    warnings (array ops never warn, but scalars route differently)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)

    return wrapper

P = np.uint64(gf.P)
EPS = np.uint64(0xFFFFFFFF)  # 2^32 - 1 == 2^64 mod p
M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
S16 = np.uint64(16)
W = np.uint64(gf.W)

FExtArr = Tuple[np.ndarray, np.ndarray]  # (re, im) arrays


def arr(x) -> np.ndarray:
    """Coerce to a uint64 ndarray (python ints may exceed int64; go via object).

    Never route python ints through np.asarray's default inference: a list
    mixing values above and below 2^63 infers float64 and silently rounds."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint64:
            return x
        if x.dtype.kind in "ui":
            return x.astype(np.uint64)
        raise TypeError(f"cannot coerce {x.dtype} array to field elements")
    if isinstance(x, (np.uint64, np.int64, np.int32, np.uint32)):
        return np.asarray(x, dtype=np.uint64)
    a = np.asarray(x, dtype=np.object_)
    # 0-d object arrays collapse to python ints under %, re-wrap before cast
    return np.asarray(a % gf.P, dtype=np.object_).astype(np.uint64)


def to_ints(x: np.ndarray):
    """uint64 array -> python int list (nested)."""
    return np.asarray(x, dtype=np.uint64).tolist()


# ---------------------------------------------------------------------------
# base field


@_wrapping
def add(a, b) -> np.ndarray:
    a = arr(a)
    b = arr(b)
    c = a + b
    over = c < a
    c = np.where(over, c + EPS, c)  # wrapped past 2^64: += 2^32-1; can't re-wrap
    return np.where(c >= P, c - P, c)


@_wrapping
def sub(a, b) -> np.ndarray:
    a = arr(a)
    b = arr(b)
    d = a - b
    return np.where(a < b, d - EPS, d)  # wrapped below 0: -= 2^32-1 == += p


@_wrapping
def neg(a) -> np.ndarray:
    a = arr(a)
    return np.where(a == 0, a, P - a)


@_wrapping
def _reduce128(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Reduce hi*2^64 + lo mod p to canonical, branch-free."""
    hi_hi = hi >> S32
    hi_lo = hi & M32
    t0 = lo - hi_hi
    t0 = np.where(lo < hi_hi, t0 - EPS, t0)  # borrow: -2^64 == -(2^32-1) mod p
    t1 = hi_lo * EPS  # < 2^64, exact
    r = t0 + t1
    r = np.where(r < t1, r + EPS, r)  # carry: +2^64 == +(2^32-1); can't re-wrap
    return np.where(r >= P, r - P, r)


@_wrapping
def mul(a, b) -> np.ndarray:
    a = arr(a)
    b = arr(b)
    al = a & M32
    ah = a >> S32
    bl = b & M32
    bh = b >> S32
    ll = al * bl  # each partial < 2^64: exact in uint64
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + hl
    carry_mid = (mid < lh).astype(np.uint64)
    lo = ll + (mid << S32)
    c0 = (lo < ll).astype(np.uint64)
    hi = hh + (mid >> S32) + (carry_mid << S32) + c0
    return _reduce128(hi, lo)


def pow_int(a, e: int) -> np.ndarray:
    """a^e for a python-int exponent (vectorized square-and-multiply)."""
    a = arr(a)
    acc = np.broadcast_to(np.uint64(1), a.shape).copy()
    s = a
    while e:
        if e & 1:
            acc = mul(acc, s)
        e >>= 1
        if e:
            s = mul(s, s)
    return acc


def inv(a) -> np.ndarray:
    """Batched Fermat inversion a^(p-2). inv(0) = 0 by pow convention; callers
    must not rely on it (golden raises; see golden.field.finv)."""
    return pow_int(a, gf.P - 2)


def modsum(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Modular sum along an axis via tree folding (uint64 sums would wrap)."""
    a = np.moveaxis(arr(a), axis, 0)
    n = a.shape[0]
    while n > 1:
        half = n // 2
        head = add(a[:half], a[half : 2 * half])
        a = np.concatenate([head, a[2 * half : n]], axis=0) if n & 1 else head
        n = a.shape[0]
    return a[0]


def powers(base: int, n: int) -> np.ndarray:
    """[1, b, ..., b^(n-1)] via log-doubling."""
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    out[0] = np.uint64(1 % gf.P)
    k = 1
    while k < n:
        step = min(k, n - k)
        out[k : k + step] = mul(out[:step], pow_int(np.uint64(base % gf.P), k))
        k += k
    return out


# ---------------------------------------------------------------------------
# quadratic extension: (re, im) arrays, X^2 = 7


def ext(re, im=0) -> FExtArr:
    re = arr(re)
    im = arr(im)
    if im.shape != re.shape:
        im = np.broadcast_to(im, re.shape).copy()
    return (re, im)


def eadd(a: FExtArr, b: FExtArr) -> FExtArr:
    return (add(a[0], b[0]), add(a[1], b[1]))


def esub(a: FExtArr, b: FExtArr) -> FExtArr:
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def emul(a: FExtArr, b: FExtArr) -> FExtArr:
    rr = mul(a[0], b[0])
    ii = mul(a[1], b[1])
    ri = mul(a[0], b[1])
    ir = mul(a[1], b[0])
    return (add(rr, mul(ii, W)), add(ri, ir))


def escale(s, a: FExtArr) -> FExtArr:
    return (mul(s, a[0]), mul(s, a[1]))


def eneg(a: FExtArr) -> FExtArr:
    return (neg(a[0]), neg(a[1]))


def einv(a: FExtArr) -> FExtArr:
    denom = inv(sub(mul(a[0], a[0]), mul(W, mul(a[1], a[1]))))
    return (mul(a[0], denom), neg(mul(a[1], denom)))


def ediv(a: FExtArr, b: FExtArr) -> FExtArr:
    return emul(a, einv(b))


def epow_int(a: FExtArr, e: int) -> FExtArr:
    acc = ext(np.broadcast_to(np.uint64(1), arr(a[0]).shape).copy())
    s = a
    while e:
        if e & 1:
            acc = emul(acc, s)
        e >>= 1
        if e:
            s = emul(s, s)
    return acc


def emodsum(a: FExtArr, axis: int = -1) -> FExtArr:
    return (modsum(a[0], axis), modsum(a[1], axis))


def epowers(base: gf.FExt, n: int) -> FExtArr:
    """[1, b, ..., b^(n-1)] for an extension base, via log-doubling."""
    re = np.empty(n, dtype=np.uint64)
    im = np.empty(n, dtype=np.uint64)
    if n == 0:
        return (re, im)
    re[0], im[0] = 1, 0
    k = 1
    base_t = (arr(base[0]), arr(base[1]))
    while k < n:
        step = min(k, n - k)
        bk = epow_int(base_t, k)
        re[k : k + step], im[k : k + step] = emul((re[:step], im[:step]), bk)
        k += k
    return (re, im)


def ext_to_pairs(a: FExtArr):
    """(re, im) arrays of shape (n,) -> [(int, int), ...]."""
    return list(zip(to_ints(a[0]), to_ints(a[1])))


# ---------------------------------------------------------------------------
# radix-2 FFT over the last axis (vectorized butterflies)


@lru_cache(maxsize=None)
def _bitrev_perm(bits: int) -> np.ndarray:
    n = 1 << bits
    perm = np.zeros(n, dtype=np.int64)
    for k in range(bits):
        perm = (perm << 1) | ((np.arange(n) >> k) & 1)
    return perm


@lru_cache(maxsize=None)
def _twiddles(stage: int, inverse: bool) -> np.ndarray:
    w_m = gf.subgroup_generator(stage)
    if inverse:
        w_m = gf.finv(w_m)
    return powers(w_m, 1 << (stage - 1))


def fft(values: np.ndarray, inverse: bool = False) -> np.ndarray:
    """(...,N) base-field (I)FFT on the 2-adic subgroup, natural order in/out.

    Same semantics as prover.fft.fft (radix-2, decimation in time)."""
    values = arr(values)
    n = values.shape[-1]
    bits = n.bit_length() - 1
    assert 1 << bits == n, "fft length must be a power of two"
    xs = values[..., _bitrev_perm(bits)]
    for s in range(1, bits + 1):
        m = 1 << s
        half = m >> 1
        w = _twiddles(s, inverse)
        y = xs.reshape(values.shape[:-1] + (n // m, m))
        u = y[..., :half]
        t = mul(w, y[..., half:])
        xs = np.concatenate([add(u, t), sub(u, t)], axis=-1).reshape(values.shape)
    if inverse:
        xs = mul(xs, np.uint64(gf.finv(n % gf.P)))
    return xs


def interpolate(values: np.ndarray) -> np.ndarray:
    """Values on subgroup H (natural order) -> coefficients; (...,N)."""
    return fft(values, inverse=True)


def coset_evaluate(coeffs: np.ndarray, shift: int, out_bits: int) -> np.ndarray:
    """Evaluate sum c_i X^i on the coset {shift * eta^j}; (...,C) -> (...,2^out_bits)."""
    coeffs = arr(coeffs)
    n = 1 << out_bits
    c = coeffs.shape[-1]
    assert c <= n
    scaled = mul(coeffs, powers(shift, c))
    if c < n:
        pad = np.zeros(coeffs.shape[:-1] + (n - c,), dtype=np.uint64)
        scaled = np.concatenate([scaled, pad], axis=-1)
    return fft(scaled)


def fft_ext(re: np.ndarray, im: np.ndarray, inverse: bool = False) -> FExtArr:
    """Extension (I)FFT: componentwise (the butterfly is F_p-linear)."""
    return (fft(re, inverse), fft(im, inverse))


def coset_evaluate_ext(a: FExtArr, shift: int, out_bits: int) -> FExtArr:
    return (coset_evaluate(a[0], shift, out_bits), coset_evaluate(a[1], shift, out_bits))
