"""Goldilocks field F_p (p = 2^64 - 2^32 + 1) and its quadratic extension.

Bit-exact executable specification in plain Python integers. This module is
the *oracle* for every TPU kernel in `plonky2_verifier_tpu.ops`: each kernel
is validated against these functions on random inputs including the edge band
near p. (Semantics: reference spec Algebra/Goldilocks.hs:126-184 and
Algebra/GoldilocksExt.hs:24-106.)

The extension is F_p[X]/(X^2 - 7): elements are (real, imag) pairs with
(r1 + i1 X)(r2 + i2 X) = (r1 r2 + 7 i1 i2) + (r1 i2 + r2 i1) X.
"""

from __future__ import annotations

import random
from functools import lru_cache
from typing import Iterable, Sequence

P = 0xFFFF_FFFF_0000_0001  # 2^64 - 2^32 + 1
W = 7  # extension defining constant: X^2 = 7

# Multiplicative generator of F_p^x used by Plonky2 (coset shift for LDEs).
MULT_GEN = 0xC65C18B67785D900
# Generator of the largest 2-adic subgroup (order 2^32).
TWO_ADIC_GEN = 0x64FDD1A46201E246
TWO_ADICITY = 32


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fneg(a: int) -> int:
    return (-a) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fpow(a: int, e: int) -> int:
    if e < 0:
        return fpow(finv(a), -e)
    return pow(a, e, P)


def finv(a: int) -> int:
    # Fermat: a^(p-2). a == 0 maps to 0 only by convention of pow; the
    # reference would loop forever on 0 so callers must not invert 0.
    if a % P == 0:
        raise ZeroDivisionError("inverse of 0 in Goldilocks field")
    return pow(a, P - 2, P)


def fdiv(a: int, b: int) -> int:
    return fmul(a, finv(b))


@lru_cache(maxsize=None)
def roots_of_unity_table() -> tuple[int, ...]:
    """roots[k] = generator of the subgroup of order 2^k, for k = 0..32.

    Built by repeated squaring of the 2-adic generator
    (reference: Algebra/Goldilocks.hs:68-74)."""
    out = [0] * 33
    x = TWO_ADIC_GEN
    for k in range(32, -1, -1):
        out[k] = x
        x = fmul(x, x)
    assert out[0] == 1
    return tuple(out)


def subgroup_generator(log2_size: int) -> int:
    return roots_of_unity_table()[log2_size]


def enumerate_subgroup(log2_size: int) -> list[int]:
    g = subgroup_generator(log2_size)
    out = [1]
    for _ in range((1 << log2_size) - 1):
        out.append(fmul(out[-1], g))
    return out


def rand_f(rng: random.Random | None = None) -> int:
    r = rng or random
    return r.randrange(P)


# ---------------------------------------------------------------------------
# Quadratic extension: elements are 2-tuples (re, im).

FExt = tuple  # (int, int)

EXT_ZERO = (0, 0)
EXT_ONE = (1, 0)


def ext(re: int, im: int = 0) -> FExt:
    return (re % P, im % P)


def from_base(a: int) -> FExt:
    return (a % P, 0)


def eadd(a: FExt, b: FExt) -> FExt:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def esub(a: FExt, b: FExt) -> FExt:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def eneg(a: FExt) -> FExt:
    return ((-a[0]) % P, (-a[1]) % P)


def emul(a: FExt, b: FExt) -> FExt:
    r1, i1 = a
    r2, i2 = b
    return ((r1 * r2 + W * i1 * i2) % P, (r1 * i2 + r2 * i1) % P)


def escale(s: int, a: FExt) -> FExt:
    return ((s * a[0]) % P, (s * a[1]) % P)


def einv(a: FExt) -> FExt:
    r, i = a
    denom = finv((r * r - W * i * i) % P)
    return ((r * denom) % P, (-i * denom) % P)


def ediv(a: FExt, b: FExt) -> FExt:
    return emul(a, einv(b))


def epow(a: FExt, e: int) -> FExt:
    if e < 0:
        return epow(einv(a), -e)
    acc = EXT_ONE
    s = a
    while e:
        if e & 1:
            acc = emul(acc, s)
        s = emul(s, s)
        e >>= 1
    return acc


def flatten_ext(xs: Iterable[FExt]) -> list[int]:
    """[(r, i), ...] -> [r, i, r, i, ...] (Algebra/GoldilocksExt.hs:103-106)."""
    out: list[int] = []
    for r, i in xs:
        out.append(r)
        out.append(i)
    return out


def rand_ext(rng: random.Random | None = None) -> FExt:
    return (rand_f(rng), rand_f(rng))


# ---------------------------------------------------------------------------
# Bit-reversal and power helpers (Algebra/FFT.hs:20-45).


def reverse_bits(n_bits: int, x: int) -> int:
    out = 0
    for k in range(n_bits):
        out |= ((x >> k) & 1) << (n_bits - 1 - k)
    return out


def reverse_index_bits(xs: Sequence) -> list:
    n = len(xs)
    n_bits = n.bit_length() - 1
    if (1 << n_bits) != n:
        raise ValueError("reverse_index_bits: length is not a power of two")
    return [xs[reverse_bits(n_bits, i)] for i in range(n)]


def powers(base_val, n: int, one=1, mul=fmul) -> list:
    """[1, b, b^2, ..., b^(n-1)] for any (one, mul) monoid."""
    out = [one]
    for _ in range(n - 1):
        out.append(mul(out[-1], base_val))
    return out


def reduce_with_powers(alpha: FExt, xs: Sequence[FExt]) -> FExt:
    """sum alpha^i x_i, Horner-style (Algebra/Goldilocks.hs:179-184)."""
    acc = EXT_ZERO
    for x in reversed(xs):
        acc = eadd(x, emul(alpha, acc))
    return acc


def combine_with_powers_of_alpha(alpha: int, xs: Sequence[FExt]) -> FExt:
    """sum alpha^k x_k with a *base-field* alpha (Plonk/Vanishing.hs:52-56)."""
    acc = EXT_ZERO
    for x in reversed(xs):
        acc = eadd(x, escale(alpha, acc))
    return acc
