"""Radix-2 FFT / coset LDE over Goldilocks (host-side, python ints).

Used only by the fixture generator, so clarity beats speed; sizes are
2^3..2^12. Works generically over the base field (ints) or the quadratic
extension (pairs) via a tiny algebra adapter: the twiddles always live in
the base field.
"""

from __future__ import annotations

from typing import List, Sequence

from ..golden import field as gf


class BaseAlg:
    zero = 0

    @staticmethod
    def add(a, b):
        return (a + b) % gf.P

    @staticmethod
    def sub(a, b):
        return (a - b) % gf.P

    @staticmethod
    def scale(s, a):  # base scalar * value
        return (s * a) % gf.P


class ExtAlg:
    zero = (0, 0)

    @staticmethod
    def add(a, b):
        return gf.eadd(a, b)

    @staticmethod
    def sub(a, b):
        return gf.esub(a, b)

    @staticmethod
    def scale(s, a):
        return gf.escale(s, a)


def fft(values: Sequence, alg=BaseAlg, inverse: bool = False) -> List:
    """In-subgroup (I)FFT, natural order in/out. Size must be a power of two."""
    n = len(values)
    bits = n.bit_length() - 1
    assert 1 << bits == n
    xs = gf.reverse_index_bits(list(values))
    for s in range(1, bits + 1):
        m = 1 << s
        w_m = gf.subgroup_generator(s)
        if inverse:
            w_m = gf.finv(w_m)
        for k in range(0, n, m):
            w = 1
            for j in range(m // 2):
                t = alg.scale(w, xs[k + j + m // 2])
                u = xs[k + j]
                xs[k + j] = alg.add(u, t)
                xs[k + j + m // 2] = alg.sub(u, t)
                w = gf.fmul(w, w_m)
    if inverse:
        inv_n = gf.finv(n % gf.P)
        xs = [alg.scale(inv_n, x) for x in xs]
    return xs


def interpolate(values: Sequence, alg=BaseAlg) -> List:
    """Values on the subgroup H (natural order) -> coefficients."""
    return fft(values, alg, inverse=True)


def coset_evaluate(coeffs: Sequence, shift: int, out_bits: int, alg=BaseAlg) -> List:
    """Evaluate sum c_i X^i on the coset {shift * eta^j} of size 2^out_bits."""
    n = 1 << out_bits
    assert len(coeffs) <= n
    sp = 1
    scaled = []
    for c in coeffs:
        scaled.append(alg.scale(sp, c))
        sp = gf.fmul(sp, shift)
    scaled += [alg.zero] * (n - len(coeffs))
    return fft(scaled, alg)


def lde(values: Sequence, rate_bits: int, shift: int = gf.MULT_GEN, alg=BaseAlg) -> List:
    """Low-degree extension: values on H (size N) -> values on shift*K
    (size N * 2^rate_bits)."""
    n = len(values)
    bits = n.bit_length() - 1
    coeffs = interpolate(values, alg)
    return coset_evaluate(coeffs, shift, bits + rate_bits, alg)


def eval_poly(coeffs: Sequence, x, alg_mul, alg_add, zero):
    """Horner evaluation with arbitrary point/coefficient algebra."""
    acc = zero
    for c in reversed(coeffs):
        acc = alg_add(alg_mul(acc, x), c)
    return acc


def eval_poly_ext(coeffs_base: Sequence[int], zeta: gf.FExt) -> gf.FExt:
    """Evaluate a base-coefficient polynomial at an extension point."""
    acc = gf.EXT_ZERO
    for c in reversed(coeffs_base):
        acc = gf.eadd(gf.emul(acc, zeta), gf.from_base(c))
    return acc
