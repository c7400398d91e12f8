"""Plonky2's gates, each one's `eval_unfiltered` at an extension point, as
the gate's file under plonky2/src/gates/ defines it (wire layout and order of
constraints), and `parse_gate`, which reads a gate from the Debug string the
common circuit data's JSON holds.

A gate's `constraints(w, c, pi_hash)` takes the row's wires `w` (Ext), its
constants `c` (Ext) with the selectors already removed, and the public
inputs' hash (4 ints), and returns its constraints (Ext) in the gate's order.
The extension gates evaluate in ExtensionAlgebra (field.Alg) and give both
components of each constraint.
"""

from __future__ import annotations

import re

from . import poseidon
from .field import ONE, ZERO, Alg, Ext, P, inv, primitive_root_of_unity, product

D = 2


class ArithmeticGate:
    """arithmetic_base.rs: output = m0 * m1 * c0 + addend * c1, 4 wires an op."""

    def __init__(self, num_ops):
        self.num_ops = num_ops

    def constraints(self, w, c, pi_hash):
        return [w[4 * i + 3] - (w[4 * i] * w[4 * i + 1] * c[0] + w[4 * i + 2] * c[1]) for i in range(self.num_ops)]


class ArithmeticExtensionGate:
    """arithmetic_extension.rs: the same over the extension, 4 D wires an op."""

    def __init__(self, num_ops):
        self.num_ops = num_ops

    def constraints(self, w, c, pi_hash):
        out = []
        for i in range(self.num_ops):
            m0, m1, add, res = (Alg.of_wires(w, 4 * D * i + k * D) for k in range(4))
            out += (res - ((m0 * m1) * c[0] + add * c[1])).parts()
        return out


class MulExtensionGate:
    """multiplication_extension.rs: output = m0 * m1 * c0, 3 D wires an op."""

    def __init__(self, num_ops):
        self.num_ops = num_ops

    def constraints(self, w, c, pi_hash):
        out = []
        for i in range(self.num_ops):
            m0, m1, res = (Alg.of_wires(w, 3 * D * i + k * D) for k in range(3))
            out += (res - (m0 * m1) * c[0]).parts()
        return out


class BaseSumGate:
    """base_sum.rs: wire 0 is the sum of the limbs (wires 1..) in base B,
    and each limb lies in [0, B)."""

    def __init__(self, num_limbs, base):
        self.num_limbs, self.base = num_limbs, base

    def constraints(self, w, c, pi_hash):
        limbs = w[1:1 + self.num_limbs]
        computed = ZERO
        for limb in reversed(limbs):
            computed = computed * self.base + limb
        return [computed - w[0]] + [product(limb - i for i in range(self.base)) for limb in limbs]


class ConstantGate:
    """constant.rs: wire i equals constant i."""

    def __init__(self, num_consts):
        self.num_consts = num_consts

    def constraints(self, w, c, pi_hash):
        return [c[i] - w[i] for i in range(self.num_consts)]


class PublicInputGate:
    """public_input.rs: wires 0..4 hold the public inputs' hash."""

    def constraints(self, w, c, pi_hash):
        return [w[i] - pi_hash[i] for i in range(4)]


class NoConstraints:
    """noop.rs, lookup.rs, lookup_table.rs: no constraint of their own (the
    lookup argument is checked in the vanishing polynomial)."""

    def constraints(self, w, c, pi_hash):
        return []


class ExponentiationGate:
    """exponentiation.rs: wire 0 the base, 1..=n the power's bits (big-endian),
    n + 1 the output, n + 2.. the intermediate values of square-and-multiply."""

    def __init__(self, num_power_bits):
        self.n = num_power_bits

    def constraints(self, w, c, pi_hash):
        n, base = self.n, w[0]
        bits = w[1:1 + n]
        inter = w[2 + n:2 + 2 * n]
        out = []
        for i in range(n):
            prev = ONE if i == 0 else inter[i - 1] * inter[i - 1]
            bit = bits[n - i - 1]
            out.append(prev * (bit * base + (ONE - bit)) - inter[i])
        out.append(w[1 + n] - inter[n - 1])
        return out


class RandomAccessGate:
    """random_access.rs: per copy, the access index, the claimed element and
    2^bits list items in routed wires, the index's bits after the routed
    wires; the extra constants' wires after the copies."""

    def __init__(self, bits, num_copies, num_extra_constants):
        self.bits, self.num_copies, self.num_extra_constants = bits, num_copies, num_extra_constants

    def constraints(self, w, c, pi_hash):
        size = 1 << self.bits
        routed = (2 + size) * self.num_copies + self.num_extra_constants
        out = []
        for copy in range(self.num_copies):
            start = (2 + size) * copy
            index, claimed = w[start], w[start + 1]
            items = w[start + 2:start + 2 + size]
            bits = w[routed + copy * self.bits:routed + (copy + 1) * self.bits]
            out += [b * (b - ONE) for b in bits]
            rebuilt = ZERO
            for b in reversed(bits):
                rebuilt = rebuilt * 2 + b
            out.append(rebuilt - index)
            for b in bits:
                items = [x + b * (y - x) for x, y in zip(items[0::2], items[1::2])]
            out.append(items[0] - claimed)
        start = (2 + size) * self.num_copies
        out += [c[i] - w[start + i] for i in range(self.num_extra_constants)]
        return out


class _Reducing:
    """reducing.rs / reducing_extension.rs: wires 0..D the output, D..2D
    alpha, 2D..3D the old accumulator, then the coefficients, then the
    accumulators but the last (which is the output);
    acc_i = acc_{i-1} * alpha + coeff_i."""

    coeff_width = None

    def __init__(self, num_coeffs):
        self.num_coeffs = num_coeffs

    def constraints(self, w, c, pi_hash):
        alpha, acc = Alg.of_wires(w, D), Alg.of_wires(w, 2 * D)
        start = 3 * D
        accs_start = start + self.num_coeffs * self.coeff_width
        out = []
        for i in range(self.num_coeffs):
            if self.coeff_width == 1:
                coeff = Alg(w[start + i])
            else:
                coeff = Alg.of_wires(w, start + D * i)
            nxt = Alg.of_wires(w, 0) if i == self.num_coeffs - 1 else Alg.of_wires(w, accs_start + D * i)
            out += (acc * alpha + coeff - nxt).parts()
            acc = nxt
        return out


class ReducingGate(_Reducing):
    coeff_width = 1


class ReducingExtensionGate(_Reducing):
    coeff_width = D


def _mds(state):
    return [sum((x * m for m, x in zip(row, state)), ZERO) for row in poseidon.MDS_ROWS]


class PoseidonMdsGate:
    """poseidon_mds.rs: 12 inputs then 12 outputs, D wires each; the outputs
    are the MDS layer of the inputs in the algebra."""

    def constraints(self, w, c, pi_hash):
        ins = [Alg.of_wires(w, D * i) for i in range(poseidon.WIDTH)]
        out = []
        for r, row in enumerate(poseidon.MDS_ROWS):
            acc = Alg(ZERO)
            for m, x in zip(row, ins):
                acc = acc + x * m
            out += (Alg.of_wires(w, D * (poseidon.WIDTH + r)) - acc).parts()
        return out


class PoseidonGate:
    """poseidon.rs's gate: inputs 0..12, outputs 12..24, the swap bit 24, the
    deltas 25..29, the S-box inputs of full rounds 1..4 of the first half
    (29..65), of the 22 partial rounds (65..87) and of the 4 full rounds of
    the second half (87..135). Constraints: swap binary, each delta, each
    S-box input, each output. The rounds are evaluated here in the plain
    form (poseidon.py); the S-box inputs of the partial rounds are the same
    affine functions of the wires in the gate's fast form."""

    def constraints(self, w, c, pi_hash):
        W_, H, NP = poseidon.WIDTH, poseidon.HALF_N_FULL_ROUNDS, poseidon.N_PARTIAL_ROUNDS
        rc = poseidon.ALL_ROUND_CONSTANTS
        swap = w[2 * W_]
        out = [swap * (swap - ONE)]
        deltas = [w[2 * W_ + 1 + i] for i in range(4)]
        out += [swap * (w[i + 4] - w[i]) - deltas[i] for i in range(4)]
        state = [w[i] + deltas[i] for i in range(4)] + [w[i + 4] - deltas[i] for i in range(4)] + w[8:W_]
        full0 = 2 * W_ + 5
        partial = full0 + W_ * (H - 1)
        full1 = partial + NP
        for r in range(poseidon.N_ROUNDS):
            state = [x + rc[W_ * r + i] for i, x in enumerate(state)]
            if r < H:
                if r:
                    wires = w[full0 + W_ * (r - 1):full0 + W_ * r]
                    out += [s - x for s, x in zip(state, wires)]
                    state = list(wires)
                state = [x ** 7 for x in state]
            elif r < H + NP:
                x = w[partial + r - H]
                out.append(state[0] - x)
                state[0] = x ** 7
            else:
                wires = w[full1 + W_ * (r - H - NP):full1 + W_ * (r - H - NP + 1)]
                out += [s - x for s, x in zip(state, wires)]
                state = [x ** 7 for x in wires]
            state = _mds(state)
        out += [state[i] - w[W_ + i] for i in range(W_)]
        return out


def barycentric_weights(points) -> list:
    """w_i = 1 / prod_{j != i} (x_i - x_j)."""
    out = []
    for i, xi in enumerate(points):
        d = 1
        for j, xj in enumerate(points):
            if j != i:
                d = d * (xi - xj) % P
        out.append(inv(d))
    return out


class CosetInterpolationGate:
    """coset_interpolation.rs: wire 0 the coset shift, then 2^subgroup_bits
    values, the evaluation point, the evaluation value (D wires each), the
    intermediate evaluations and products, the shifted evaluation point. The
    interpolation runs in chunks of `degree` points (the first) and
    `degree - 1` after, each chunk's partial evaluation and product held in
    wires."""

    def __init__(self, subgroup_bits, degree, barycentric_weights_):
        self.bits, self.degree = subgroup_bits, degree
        g = primitive_root_of_unity(subgroup_bits)
        self.domain = [pow(g, i, P) for i in range(1 << subgroup_bits)]
        self.weights = list(barycentric_weights_)
        assert self.weights == barycentric_weights(self.domain), "the gate's weights are not its subgroup's"

    def constraints(self, w, c, pi_hash):
        n = 1 << self.bits
        inter = (n - 2) // (self.degree - 1)
        start_inter = 1 + n * D + 2 * D
        shift = w[0]
        point = Alg.of_wires(w, 1 + n * D)
        shifted = Alg.of_wires(w, start_inter + 2 * D * inter)
        out = (point - shifted * shift).parts()
        values = [Alg.of_wires(w, 1 + D * i) for i in range(n)]

        def partial(lo, hi, ev, prod):
            for x, v, wt in zip(self.domain[lo:hi], values[lo:hi], self.weights[lo:hi]):
                term = shifted - Alg(Ext(x))
                ev, prod = ev * term + (v * wt) * prod, prod * term
            return ev, prod

        ev, prod = partial(0, self.degree, Alg(ZERO), Alg(ONE))
        for i in range(inter):
            ie = Alg.of_wires(w, start_inter + D * i)
            ip = Alg.of_wires(w, start_inter + D * (inter + i))
            out += (ie - ev).parts() + (ip - prod).parts()
            lo = 1 + (self.degree - 1) * (i + 1)
            ev, prod = partial(lo, min(lo + self.degree - 1, n), ie, ip)
        out += (Alg.of_wires(w, 1 + n * D + D) - ev).parts()
        return out


def _fields(s: str) -> dict:
    return {k: (int(v) if v.isdigit() else [int(x) for x in v.strip("[]").split(",") if x.strip()])
            for k, v in re.findall(r"(\w+): (\d+|\[[^\]]*\])", s)}


def parse_gate(s: str):
    """A gate from its Debug string, e.g. "ArithmeticGate { num_ops: 20 }"
    or "BaseSumGate { num_limbs: 63 } + Base: 2"."""
    name = re.match(r"\w+", s).group(0)
    f = _fields(s)
    if name == "ArithmeticGate":
        return ArithmeticGate(f["num_ops"])
    if name == "ArithmeticExtensionGate":
        return ArithmeticExtensionGate(f["num_ops"])
    if name == "MulExtensionGate":
        return MulExtensionGate(f["num_ops"])
    if name == "BaseSumGate":
        return BaseSumGate(f["num_limbs"], f["Base"])
    if name == "ConstantGate":
        return ConstantGate(f["num_consts"])
    if name == "PublicInputGate":
        return PublicInputGate()
    if name in ("NoopGate", "LookupGate", "LookupTableGate"):
        return NoConstraints()
    if name == "ExponentiationGate":
        return ExponentiationGate(f["num_power_bits"])
    if name == "RandomAccessGate":
        return RandomAccessGate(f["bits"], f["num_copies"], f["num_extra_constants"])
    if name == "ReducingGate":
        return ReducingGate(f["num_coeffs"])
    if name == "ReducingExtensionGate":
        return ReducingExtensionGate(f["num_coeffs"])
    if name == "PoseidonMdsGate":
        return PoseidonMdsGate()
    if name == "PoseidonGate":
        return PoseidonGate()
    if name == "CosetInterpolationGate":
        return CosetInterpolationGate(f["subgroup_bits"], f["degree"], f["barycentric_weights"])
    raise ValueError(f"unknown gate {s!r}")
