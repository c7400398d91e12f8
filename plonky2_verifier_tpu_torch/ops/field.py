"""Goldilocks field arithmetic on int64 tensors.

An element is an int64 tensor that holds the u64 bit pattern of a canonical
value (< p = 2^64 - 2^32 + 1). int64 is used because this PyTorch build lacks
add, `>>` and `<` on uint64. Three rules keep the arithmetic unsigned:

- `+`, `-` and `*` wrap mod 2^64, so the bit pattern is the u64 result;
- unsigned compares flip the sign bit of both sides first (a 2^63 bias);
- logical right shifts mask off the copies of the sign bit after `>>`.

A 64x64 product is formed from four 32x32 partial products (each exact in a
wrapping int64) and reduced with 2^64 = 2^32 - 1 (mod p), the same reduction
as plonky2_verifier_tpu.ops.field._reduce128. Every result is canonical, so
values are bit-exact against the golden model.

The quadratic extension F_p[X]/(X^2 - 7) is a (re, im) pair of elements
(`GExt`). `inv(0) = 0`, as in the JAX package. `inv`, `pow_dynamic` and
`ext_pow_const` launch a CUDA kernel (csrc/field.cu) for CUDA tensors and
take their `*_plain` versions for CPU tensors, as do their grouped forms,
`inv_grouped` (several tensors inverted in one launch, by the batch trick)
and `pow_grouped` (a forward's powers of fixed generators at exponents
derived from the query indices, and of extension bases at host exponents,
in one launch), which the verifier's forward calls once each; the other ops
are plain PyTorch on any device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..golden.field import P, W, fpow

I64 = torch.int64
M32 = 0xFFFFFFFF
EPSILON = 0xFFFFFFFF  # 2^64 mod p
SIGN = -(1 << 63)  # xor bias for unsigned compares


def signed(v: int) -> int:
    """The int64 whose bit pattern is the u64 `v`."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


P_I64 = signed(P)


# ---------------------------------------------------------------------------
# host boundary


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the CUDA card, and
    raises where there is none (nothing quietly runs on the CPU); anything
    else is taken as given, e.g. "cpu" in the tests."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device (torch.cuda.is_available() is False); pass device="cpu" to run on the CPU'
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def from_u64(x, device) -> torch.Tensor:
    """uint64 numpy array (or values) -> int64 tensor on `device` with the same bits."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(x.view(np.int64).copy()).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def constant(value: int, shape, device) -> torch.Tensor:
    return torch.full(tuple(shape), signed(value % P), dtype=I64, device=device)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=I64, device=device)


# ---------------------------------------------------------------------------
# unsigned helpers


def ult(a, b):
    """a < b as unsigned 64-bit values."""
    return (a ^ SIGN) < (b ^ SIGN)


def uge(a, b):
    return (a ^ SIGN) >= (b ^ SIGN)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bit pattern by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _canonical(s: torch.Tensor) -> torch.Tensor:
    """s < 2^64 -> s mod p, assuming s < 2p."""
    return torch.where(uge(s, P_I64), s - P_I64, s)


# ---------------------------------------------------------------------------
# base field


def add(a, b):
    s = a + b
    # wrapped past 2^64: add 2^64 mod p = 2^32 - 1 (cannot wrap again)
    s = torch.where(ult(s, a), s + EPSILON, s)
    return _canonical(s)


def sub(a, b):
    d = a - b
    # wrapped below 0: the value is a - b + 2^64; subtract 2^32 - 1 (= add p)
    return torch.where(ult(a, b), d - EPSILON, d)


def neg(a):
    return sub(torch.zeros_like(a), a)


def reduce128(lo, hi):
    """(hi * 2^64 + lo) mod p, canonical, for any u64 words lo and hi."""
    hi_hi = shr(hi, 32)
    hi_lo = hi & M32
    t0 = lo - hi_hi
    t0 = torch.where(ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = hi_lo * EPSILON  # < 2^64: (hi_lo << 32) - hi_lo
    t2 = t0 + t1
    t2 = torch.where(ult(t2, t1), t2 + EPSILON, t2)
    return _canonical(t2)


def mul(a, b):
    a0, a1 = a & M32, shr(a, 32)
    b0, b1 = b & M32, shr(b, 32)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = shr(ll, 32) + (lh & M32) + (hl & M32)  # < 3 * 2^32
    lo = (mid << 32) | (ll & M32)
    hi = hh + shr(lh, 32) + shr(hl, 32) + (mid >> 32)
    return reduce128(lo, hi)


def square(a):
    return mul(a, a)


def mul_small(a, c: int):
    """a * c for a small constant c."""
    return mul(a, torch.full_like(a, c))


def pow_const(a, e: int):
    """a^e for a static exponent (square-and-multiply)."""
    if e == 0:
        return torch.ones_like(a)
    acc = None
    s = a
    while e:
        if e & 1:
            acc = s if acc is None else mul(acc, s)
        e >>= 1
        if e:
            s = square(s)
    return acc


def pow_dynamic_plain(base, exponent, n_bits: int):
    """base^exponent for an int64 exponent tensor with exponent < 2^n_bits."""
    acc = torch.ones_like(base)
    s = base
    for k in range(max(n_bits, 1)):
        bit = ((exponent >> k) & 1) == 1
        acc = torch.where(bit, mul(acc, s), acc)
        s = square(s)
    return acc


def pow_dynamic(base, exponent, n_bits: int):
    """pow_dynamic_plain's power: one launch of the CUDA kernel
    (csrc/field.cu) for CUDA tensors, the plain version for CPU tensors. A
    base broadcast over the exponent's shape (a stride-0 `expand`, a scalar)
    is read where it lies."""
    if base.device.type == "cpu":
        return pow_dynamic_plain(base, exponent, n_bits)
    return _pow_kernel(base, None, exponent, max(n_bits, 1)).re


def bit_reverse(idx, bits: int):
    """The low `bits` bits of each int64 index in reverse order."""
    out = torch.zeros_like(idx)
    for k in range(bits):
        out = out | (((idx >> k) & 1) << (bits - 1 - k))
    return out


def inv_plain(a):
    """a^(p-2) by Fermat; inv(0) = 0, as in the JAX package."""
    return pow_const(a, P - 2)


def inv(a):
    """a^(p-2), inv(0) = 0: one launch of the CUDA kernel (csrc/field.cu)
    for a CUDA tensor, inv_plain for a CPU tensor. `ext_inv` and `ext_div`
    reach it through this name."""
    if a.device.type == "cpu":
        return inv_plain(a)
    from .. import kernels

    return kernels.load().inv(a.contiguous())  # the verifier's inputs are (B, Q) at most


def inv_grouped_plain(parts):
    """[inv_plain(a) for a in parts]."""
    return [inv_plain(a) for a in parts]


def inv_grouped(parts):
    """inv of every tensor of `parts` (any shapes): for CUDA tensors one
    launch of the batch inversion (csrc/field.cu p2v_inv_grouped) over all
    their words, the bits of inv_plain; for CPU tensors inv_grouped_plain."""
    if parts[0].device.type == "cpu":
        return inv_grouped_plain(parts)
    return _inv_grouped_kernel(parts)


def _inv_grouped_kernel(parts):
    from .. import kernels

    flat = kernels.load().inv_grouped(torch.cat([a.reshape(-1) for a in parts]))
    return [x.reshape(a.shape) for x, a in zip(flat.split([a.numel() for a in parts]), parts)]


# ---------------------------------------------------------------------------
# quadratic extension, X^2 = 7


@dataclass(frozen=True)
class GExt:
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    def __getitem__(self, idx):
        return GExt(self.re[idx], self.im[idx])

    def reshape(self, *shape):
        return GExt(self.re.reshape(*shape), self.im.reshape(*shape))

    def unsqueeze(self, dim: int):
        return GExt(self.re.unsqueeze(dim), self.im.unsqueeze(dim))

    def expand(self, *shape):
        return GExt(self.re.expand(*shape), self.im.expand(*shape))

    def __add__(self, o):
        return GExt(add(self.re, o.re), add(self.im, o.im))

    def __sub__(self, o):
        return GExt(sub(self.re, o.re), sub(self.im, o.im))


def ext_constant(re: int, im: int = 0, shape=(), *, device) -> GExt:
    return GExt(constant(re, shape, device), constant(im, shape, device))


def ext_zeros(shape, device) -> GExt:
    return GExt(zeros(shape, device), zeros(shape, device))


def ext_from_base(a) -> GExt:
    return GExt(a, torch.zeros_like(a))


def ext_where(mask, a: GExt, b: GExt) -> GExt:
    return GExt(torch.where(mask, a.re, b.re), torch.where(mask, a.im, b.im))


def ext_equal(a: GExt, b: GExt):
    return (a.re == b.re) & (a.im == b.im)


def ext_stack(xs: Sequence[GExt], dim=0) -> GExt:
    return GExt(torch.stack([x.re for x in xs], dim), torch.stack([x.im for x in xs], dim))


def ext_concat(xs: Sequence[GExt], dim=0) -> GExt:
    return GExt(torch.cat([x.re for x in xs], dim), torch.cat([x.im for x in xs], dim))


def escale(s, a: GExt) -> GExt:
    """Base-field scalar times extension element."""
    return GExt(mul(s, a.re), mul(s, a.im))


def emul(a: GExt, b: GExt) -> GExt:
    # (r1 r2 + 7 i1 i2, r1 i2 + r2 i1)
    rr = mul(a.re, b.re)
    ii = mul(a.im, b.im)
    ri = mul(a.re, b.im)
    ir = mul(a.im, b.re)
    return GExt(add(rr, mul_small(ii, W)), add(ri, ir))


def ext_square(a: GExt) -> GExt:
    return emul(a, a)


def ext_norm(a: GExt):
    """re^2 - 7 im^2: a's inverse is its conjugate over this (ext_inv_with)."""
    return sub(mul(a.re, a.re), mul_small(mul(a.im, a.im), W))


def ext_inv_with(a: GExt, norm_inv) -> GExt:
    """a^-1 given inv(ext_norm(a))."""
    return GExt(mul(a.re, norm_inv), neg(mul(a.im, norm_inv)))


def ext_inv(a: GExt) -> GExt:
    return ext_inv_with(a, inv(ext_norm(a)))


def ext_div(a: GExt, b: GExt) -> GExt:
    return emul(a, ext_inv(b))


def ext_pow_const_plain(a: GExt, e: int) -> GExt:
    """a^e by square-and-multiply, unrolled on the host: e = 0 gives (1, 0)
    and e = 1 the input itself, with no product."""
    if e == 0:
        return GExt(torch.ones_like(a.re), torch.zeros_like(a.im))
    acc = None
    s = a
    while e:
        if e & 1:
            acc = s if acc is None else emul(acc, s)
        e >>= 1
        if e:
            s = ext_square(s)
    return acc


def ext_pow_const(a: GExt, e: int) -> GExt:
    """ext_pow_const_plain's power: for CUDA tensors and e >= 2 one launch of
    the CUDA kernel (csrc/field.cu), whose every result is canonical as the
    plain chain's is for e >= 2; e = 0 and e = 1 (the input's own bits, which
    a kernel's product would reduce) and CPU tensors take the plain version,
    with no launch."""
    if a.re.device.type == "cpu" or e < 2:
        return ext_pow_const_plain(a, e)
    return _pow_kernel(a.re, a.im, e, e.bit_length())


def broadcast_rows(t: torch.Tensor, lead: int):
    """t (*lead axes, *tail) -> (rows, rep) with rows (m, *tail) such that row
    i of the flattened lead axes is rows[i // rep]. The trailing lead axes
    that t broadcasts (stride 0 or size 1, as `expand` and `unsqueeze` leave
    them) make up rep and are never copied; `reshape` flattens the rest and
    copies only the axes it cannot merge (the quotient's (B, r) rows of
    openings1: B x r x maxdeg words), and such a copy repeats no row."""
    keep, rep = lead, 1
    while keep and (t.stride(keep - 1) == 0 or t.shape[keep - 1] == 1):
        keep -= 1
        rep *= t.shape[keep]
    rows = t[(slice(None),) * keep + (0,) * (lead - keep)]
    return rows.reshape(math.prod(t.shape[:keep]), *t.shape[lead:]), rep


def _pow_kernel(re, im, exponent, n_bits: int) -> GExt:
    """KernelLibrary.pow on a base (re, im) (im None: a base-field base, and
    the result's im is None) and an exponent tensor broadcast with it, or a
    Python int. Broadcast trailing axes of the base become the kernel's row
    repeat; where the two parts are laid out unlike each other both are
    copied, repeat 1."""
    from .. import kernels

    shape = re.shape
    if isinstance(exponent, torch.Tensor):
        # numpy's broadcast, not torch.broadcast_shapes: that one imports
        # torch.fx's symbolic shapes (sympy) at its first call, seconds of a
        # fresh process's first verifier call on the card
        shape = np.broadcast_shapes(tuple(shape), tuple(exponent.shape))
        re, exponent = re.expand(shape), exponent.expand(shape).reshape(-1)
        im = None if im is None else im.expand(shape)
    b_re, rep = broadcast_rows(re, len(shape))
    b_im = None
    if im is not None:
        b_im, rep_im = broadcast_rows(im, len(shape))
        if (rep_im, b_im.stride()) != (rep, b_re.stride()):
            b_re, b_im, rep = re.reshape(-1).contiguous(), im.reshape(-1).contiguous(), 1
    out_re, out_im = kernels.load().pow(b_re, b_im, exponent, n_bits, rep)
    return GExt(out_re.reshape(shape), None if out_im is None else out_im.reshape(shape))


# ---------------------------------------------------------------------------
# a forward's powers in one launch


@dataclass(frozen=True, eq=False)
class GeneratorPower:
    """One segment of pow_grouped: factor * generator^e for every query
    index, e the bit reversal over `bits` bits of the index shifted right by
    `shift` with its `clear` low bits then cleared. `table` holds
    generator^(2^k) for k < bits (power_table) on the device the kernel
    reads it from."""

    generator: int
    bits: int
    factor: int
    shift: int
    clear: int
    table: torch.Tensor

    def exponent(self, qidx):
        return bit_reverse((qidx >> (self.shift + self.clear)) << self.clear, self.bits)


def power_table(generator: int, bits: int) -> np.ndarray:
    """generator^(2^k) for k < bits, canonical, as uint64 (golden/field.py)."""
    return np.array([fpow(generator, 1 << k) for k in range(bits)], dtype=np.uint64)


def pow_grouped_plain(qidx, gens: Sequence[GeneratorPower], exts):
    """pow_dynamic_plain times the factor for each of `gens` over the query
    indices qidx (an int64 tensor), ext_pow_const_plain for each (base, e) of
    `exts`. Returns ([qidx.shape a gen], [GExt of the base's shape an ext])."""
    out = []
    for g in gens:
        base = constant(g.generator, qidx.shape, qidx.device)
        out.append(mul(constant(g.factor, qidx.shape, qidx.device), pow_dynamic_plain(base, g.exponent(qidx), max(g.bits, 1))))
    return out, [ext_pow_const_plain(base, e) for base, e in exts]


def pow_grouped(qidx, gens: Sequence[GeneratorPower], exts):
    """pow_grouped_plain's powers: for CUDA tensors one launch of the
    grouped exponentiation (csrc/field.cu p2v_pow_grouped; each generator's
    `table` on the card), every power canonical; an ext exponent of 0 or 1
    (the input's own bits at 1) is answered on the host with no launch, as
    ext_pow_const answers it. CPU tensors take the plain version."""
    if qidx.device.type == "cpu":
        return pow_grouped_plain(qidx, gens, exts)
    return _pow_grouped_kernel(qidx, gens, exts)


def _pow_grouped_kernel(qidx, gens: Sequence[GeneratorPower], exts):
    from .. import kernels

    launched, ext_args = [], []
    for k, (base, e) in enumerate(exts):
        if e >= 2:
            re, im = (base.re, base.im) if base.re.dim() == 1 else (base.re.reshape(-1), base.im.reshape(-1))  # (B,): the transcript's
            if re.stride() != im.stride():
                re, im = re.contiguous(), im.contiguous()
            launched.append(k)
            ext_args.append((re, im, e))
    gen_out, ext_out = kernels.load().pow_grouped(qidx if gens else None, [(g.table, g.shift, g.clear, g.factor) for g in gens], ext_args)
    powers = [None if e >= 2 else ext_pow_const_plain(base, e) for base, e in exts]  # e = 0 and 1 on the host
    for k, (re, im) in zip(launched, ext_out):
        shape = exts[k][0].shape
        powers[k] = GExt(re, im) if len(shape) == 1 else GExt(re.reshape(shape), im.reshape(shape))
    return gen_out, powers
