"""Gate constraint programs: a tiny symbolic eDSL + all 16 Plonky2 gates.

Mirrors the reference spec's two-phase design (Gate/Computation.hs:34-129,
Gate/Constraints.hs:37-108): each gate type compiles *once* into a
"straight-line program" (shared local definitions + committed constraint
expressions), which is then *evaluated many times* on data. That split is
exactly JAX's trace/jit split, so the same programs serve three backends:

- golden verifier: evaluated on python-int extension elements at zeta,
- fixture prover:  evaluated on numpy object arrays over the LDE domain,
- TPU verifier:    traced into jnp ops by the compiler (the AST is the
  jaxpr source), jit once per (gate type, params), vmapped over proofs.

Evaluation is generic over an ``algebra`` adapter providing
add/sub/mul/lit/img/var. Variables index a row's openings:
selectors, lookup selectors, constants, wires, and the public-input hash.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Sequence, Tuple

from .gate_parser import Gate
from .golden import field as gf
from .golden.poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    FAST_PARTIAL_FIRST_ROUND_CONSTANT,
    FAST_PARTIAL_ROUND_CONSTANTS,
    FAST_PARTIAL_ROUND_INITIAL_MATRIX,
    FAST_PARTIAL_ROUND_VS,
    FAST_PARTIAL_ROUND_W_HATS,
)
from .golden.poseidon import mds_matrix

# ---------------------------------------------------------------------------
# Expression AST. Nodes are immutable; variables index into the row.

SEL, LKPSEL, CONST, WIRE, PI, LOCAL = "sel", "lkpsel", "const", "wire", "pi", "local"


class Expr:
    __slots__ = ("op", "args")

    def __init__(self, op: str, args: tuple):
        self.op = op
        self.args = args

    # operator sugar ---------------------------------------------------------
    def __add__(self, other):
        return Expr("add", (self, _coerce(other)))

    def __radd__(self, other):
        return Expr("add", (_coerce(other), self))

    def __sub__(self, other):
        return Expr("sub", (self, _coerce(other)))

    def __rsub__(self, other):
        return Expr("sub", (_coerce(other), self))

    def __mul__(self, other):
        return Expr("mul", (self, _coerce(other)))

    def __rmul__(self, other):
        return Expr("mul", (_coerce(other), self))

    def __neg__(self):
        return lit(0) - self

    def __repr__(self):
        if self.op == "var":
            return f"{self.args[0]}{self.args[1]}"
        if self.op == "lit":
            return str(self.args[0])
        return f"({self.op} {' '.join(map(repr, self.args))})"


def _coerce(x) -> Expr:
    if isinstance(x, Expr):
        return x
    return lit(x)


def lit(c: int) -> Expr:
    return Expr("lit", (c % gf.P,))


def var(kind: str, idx: int) -> Expr:
    return Expr("var", (kind, idx))


def wire(i: int) -> Expr:
    return var(WIRE, i)


def cnst(i: int) -> Expr:
    return var(CONST, i)


def pi_hash(i: int) -> Expr:
    return var(PI, i)


# Simulated extension elements: pairs of expressions with X^2 = 7 arithmetic
# (Gate/Vars.hs:56-57 wireExt; GoldilocksExt Num instance).


class ExtExpr:
    __slots__ = ("re", "im")

    def __init__(self, re: Expr, im: Expr):
        self.re = re
        self.im = im

    def __add__(self, o):
        o = _coerce_ext(o)
        return ExtExpr(self.re + o.re, self.im + o.im)

    def __sub__(self, o):
        o = _coerce_ext(o)
        return ExtExpr(self.re - o.re, self.im - o.im)

    def __mul__(self, o):
        o = _coerce_ext(o)
        return ExtExpr(
            self.re * o.re + lit(gf.W) * self.im * o.im,
            self.re * o.im + o.re * self.im,
        )

    def scale(self, s: Expr):
        return ExtExpr(s * self.re, s * self.im)


def _coerce_ext(x) -> ExtExpr:
    if isinstance(x, ExtExpr):
        return x
    if isinstance(x, Expr):
        return ExtExpr(x, lit(0))
    return ExtExpr(lit(x), lit(0))


def wire_ext(i: int) -> ExtExpr:
    return ExtExpr(wire(i), wire(i + 1))


# ---------------------------------------------------------------------------
# Straight-line programs


@dataclass(frozen=True)
class StraightLine:
    local_defs: Tuple[Expr, ...]  # local_defs[i] defines local var i
    constraints: Tuple[Expr, ...]  # committed constraints (== 0)


class Compute:
    """Builder monad: let_ names an intermediate; commit emits a constraint."""

    def __init__(self):
        self._defs: List[Expr] = []
        self._commits: List[Expr] = []

    def let(self, e: Expr) -> Expr:
        if e.op in ("var", "lit"):
            return e  # trivial exprs are not worth binding (Computation.hs:63-67)
        idx = len(self._defs)
        self._defs.append(e)
        return var(LOCAL, idx)

    def lets(self, es: Sequence[Expr]) -> List[Expr]:
        return [self.let(e) for e in es]

    def commit(self, e: Expr) -> None:
        self._commits.append(_coerce(e))

    def commit_ext(self, e: ExtExpr) -> None:
        self.commit(e.re)
        self.commit(e.im)

    def commit_list(self, es: Sequence[Expr]) -> None:
        for e in es:
            self.commit(e)

    def finish(self) -> StraightLine:
        return StraightLine(tuple(self._defs), tuple(self._commits))


# ---------------------------------------------------------------------------
# Generic evaluation


class EvaluationVars:
    """One row of data for constraint evaluation (Gate/Computation.hs:177-184).

    Fields hold *backend values* (python ext tuples, numpy arrays, or traced
    jnp Goldilocks arrays)."""

    __slots__ = ("selectors", "lkp_selectors", "constants", "wires", "public_inputs_hash")

    def __init__(self, selectors, lkp_selectors, constants, wires, public_inputs_hash):
        self.selectors = selectors
        self.lkp_selectors = lkp_selectors
        self.constants = constants
        self.wires = wires
        self.public_inputs_hash = public_inputs_hash


def run_straight_line(prog: StraightLine, ev: EvaluationVars, algebra) -> list:
    """Evaluate a gate program. `algebra` provides:
    add(a,b), sub(a,b), mul(a,b), lit(int)->val, img(a)->X*a,
    and from_base(v) to lift public-input-hash entries."""
    scope: list = [None] * len(prog.local_defs)

    def ev_var(kind, idx):
        if kind == LOCAL:
            return scope[idx]
        if kind == SEL:
            return ev.selectors[idx]
        if kind == LKPSEL:
            return ev.lkp_selectors[idx]
        if kind == CONST:
            return ev.constants[idx]
        if kind == WIRE:
            return ev.wires[idx]
        if kind == PI:
            return algebra.from_base(ev.public_inputs_hash[idx])
        raise KeyError(kind)

    def go(e: Expr):
        op = e.op
        if op == "var":
            return ev_var(*e.args)
        if op == "lit":
            return algebra.lit(e.args[0])
        if op == "add":
            return algebra.add(go(e.args[0]), go(e.args[1]))
        if op == "sub":
            return algebra.sub(go(e.args[0]), go(e.args[1]))
        if op == "mul":
            return algebra.mul(go(e.args[0]), go(e.args[1]))
        if op == "img":
            return algebra.img(go(e.args[0]))
        raise KeyError(op)

    for i, d in enumerate(prog.local_defs):
        scope[i] = go(d)
    return [go(c) for c in prog.constraints]


class GoldenExtAlgebra:
    """Python-int extension field backend (the oracle)."""

    @staticmethod
    def add(a, b):
        return gf.eadd(a, b)

    @staticmethod
    def sub(a, b):
        return gf.esub(a, b)

    @staticmethod
    def mul(a, b):
        return gf.emul(a, b)

    @staticmethod
    def lit(c):
        return (c % gf.P, 0)

    @staticmethod
    def img(a):
        return gf.emul((0, 1), a)

    @staticmethod
    def from_base(v):
        # public-input hash entries are base-field ints
        if isinstance(v, tuple):
            return v
        return (v % gf.P, 0)


def constraint_degree(prog: StraightLine) -> int:
    """Max total degree of the committed constraints, counting proof vars as
    degree 1 and PI-hash vars as degree 0 (Gate/Computation.hs:137-147)."""
    local_deg = {}

    def deg(e: Expr) -> int:
        if e.op == "var":
            kind, idx = e.args
            if kind == LOCAL:
                return local_deg[idx]
            return 0 if kind == PI else 1
        if e.op == "lit":
            return 0
        if e.op in ("add", "sub"):
            return max(deg(e.args[0]), deg(e.args[1]))
        if e.op == "mul":
            return deg(e.args[0]) + deg(e.args[1])
        if e.op == "img":
            return deg(e.args[0])
        raise KeyError(e.op)

    for i, d in enumerate(prog.local_defs):
        local_deg[i] = deg(d)
    return max((deg(c) for c in prog.constraints), default=0)


def op_count(prog: StraightLine) -> Tuple[int, int]:
    """(adds, muls) over defs + constraints (Algebra/Expr.hs:76-96)."""
    adds = muls = 0

    def go(e: Expr):
        nonlocal adds, muls
        if e.op in ("add", "sub"):
            adds += 1
            go(e.args[0])
            go(e.args[1])
        elif e.op == "mul":
            muls += 1
            go(e.args[0])
            go(e.args[1])
        elif e.op == "img":
            muls += 1
            go(e.args[0])

    for d in prog.local_defs:
        go(d)
    for c in prog.constraints:
        go(c)
    return adds, muls


# ---------------------------------------------------------------------------
# Gate programs (Gate/Constraints.hs:40-108 + Gate/Custom/*)


def _sbox7(c: Compute, x0: Expr) -> Expr:
    x = c.let(x0)
    x2 = c.let(x * x)
    x3 = c.let(x * x2)
    x4 = c.let(x2 * x2)
    return c.let(x3 * x4)


def _arithmetic(c: Compute, num_ops: int) -> None:
    for i in range(num_ops):
        j = 4 * i
        c.commit(wire(j + 3) - cnst(0) * wire(j) * wire(j + 1) - cnst(1) * wire(j + 2))


def _arithmetic_ext(c: Compute, num_ops: int) -> None:
    c0 = _coerce_ext(cnst(0))
    c1 = _coerce_ext(cnst(1))
    for i in range(num_ops):
        j = 8 * i
        c.commit_ext(wire_ext(j + 6) - c0 * wire_ext(j) * wire_ext(j + 2) - c1 * wire_ext(j + 4))


def _base_sum(c: Compute, num_limbs: int, base: int) -> None:
    def limb(i):
        return wire(i + 1)

    def horner(k):
        if k < num_limbs - 1:
            return limb(k) + lit(base) * horner(k + 1)
        return limb(k)

    c.commit(horner(0) - wire(0))
    for i in range(num_limbs):
        prod = limb(i)
        for k in range(1, base):
            prod = prod * (limb(i) - lit(k))
        c.commit(prod)


def _constant(c: Compute, num_consts: int) -> None:
    for i in range(num_consts):
        c.commit(cnst(i) - wire(i))


def _exponentiation(c: Compute, nbits: int) -> None:
    # witness layout: [base, e[0..n-1] (big-endian-consumed), out, t[0..n-1]]
    base = wire(0)

    def exp_bit(i):
        return wire(i + 1)

    out = wire(nbits + 1)

    def tmp(i):
        return wire(nbits + 2 + i)

    def cur_bit(i):
        return exp_bit(nbits - 1 - i)

    for i in range(nbits):
        prev = lit(1) if i == 0 else tmp(i - 1) * tmp(i - 1)
        comp = prev * (cur_bit(i) * base + (lit(1) - cur_bit(i)))
        c.commit(comp - tmp(i))
    c.commit(out - tmp(nbits - 1))


def _mul_ext(c: Compute, num_ops: int) -> None:
    c0 = _coerce_ext(cnst(0))
    for i in range(num_ops):
        j = 6 * i
        c.commit_ext(wire_ext(j + 4) - c0 * wire_ext(j) * wire_ext(j + 2))


def _public_input(c: Compute) -> None:
    for i in range(4):
        c.commit(wire(i) - pi_hash(i))


def _balanced_sum(terms):
    """Associative tree-sum (shallow levels for the TPU levelizer; same value)."""
    terms = list(terms)
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _poseidon_mds(c: Compute) -> None:
    m = mds_matrix()
    for i in range(12):
        acc = _balanced_sum([wire_ext(2 * j).scale(lit(m[i][j])) for j in range(12)])
        c.commit_ext(wire_ext(2 * (i + 12)) - acc)


def _poseidon(c: Compute) -> None:
    """PoseidonGate, width 12: 123 constraints over a 135-cell row
    (Gate/Custom/Poseidon.hs:63-150)."""
    m = mds_matrix()

    def inp(i):
        return wire(i)

    def outp(i):
        return wire(i + 12)

    swap_flag = wire(24)

    def delta(i):
        return wire(25 + i)

    def initial_sbox_in(r, i):  # 0 < r < 4
        return wire(29 + 12 * (r - 1) + i)

    def partial_sbox_in(r):  # 0 <= r < 22
        return wire(29 + 36 + r)

    def final_sbox_in(r, i):  # 0 <= r < 4
        return wire(29 + 36 + 22 + 12 * r + i)

    def mds_layer(state):
        return [sum_exprs([lit(m[i][j]) * state[j] for j in range(12)]) for i in range(12)]

    sum_exprs = _balanced_sum

    def plus_rc(r, state):
        rc = ALL_ROUND_CONSTANTS[12 * r : 12 * r + 12]
        return [x + lit(k) for x, k in zip(state, rc)]

    # merkle-swap constraints
    c.commit(swap_flag * (swap_flag - lit(1)))
    for i in range(4):
        c.commit(swap_flag * (inp(i + 4) - inp(i)) - delta(i))

    state = (
        [inp(i) + delta(i) for i in range(4)]
        + [inp(i) - delta(i - 4) for i in range(4, 8)]
        + [inp(i) for i in range(8, 12)]
    )

    # 4 initial full rounds
    for r in range(4):
        state2 = plus_rc(r, state)
        if r == 0:
            state3 = state2
        else:
            for i in range(12):
                c.commit(state2[i] - initial_sbox_in(r, i))
            state3 = [initial_sbox_in(r, i) for i in range(12)]
        state = mds_layer([_sbox7(c, x) for x in state3])

    # partial rounds (fast-partial formulation)
    state = c.lets([x + lit(k) for x, k in zip(state, FAST_PARTIAL_FIRST_ROUND_CONSTANT)])
    # initial 11x11 matrix on lanes 1..11 (note transposed indexing:
    # partialMdsMatrixCoeff i j = INITIAL_MATRIX[j][i])
    rest = state[1:]
    state = c.lets(
        [state[0]]
        + [
            sum_exprs([lit(FAST_PARTIAL_ROUND_INITIAL_MATRIX[j][i]) * rest[j] for j in range(11)])
            for i in range(11)
        ]
    )
    for r in range(22):
        c.commit(state[0] - partial_sbox_in(r))
        y = _sbox7(c, partial_sbox_in(r))
        if r < 21:
            y = y + lit(FAST_PARTIAL_ROUND_CONSTANTS[r])
        state = c.lets([y] + state[1:])
        # fast partial MDS: first entry is a dot product; rest get a rank-1 update
        s0 = state[0]
        coeffs = (m[0][0],) + FAST_PARTIAL_ROUND_W_HATS[r]
        d = sum_exprs([lit(cc) * x for cc, x in zip(coeffs, state)])
        state = c.lets(
            [d] + [x + s0 * lit(t) for x, t in zip(state[1:], FAST_PARTIAL_ROUND_VS[r])]
        )

    # 4 final full rounds
    for r in range(4):
        state2 = plus_rc(r + 26, state)
        for i in range(12):
            c.commit(state2[i] - final_sbox_in(r, i))
        state = mds_layer([_sbox7(c, final_sbox_in(r, i)) for i in range(12)])

    for i in range(12):
        c.commit(state[i] - outp(i))


def _random_access(c: Compute, num_bits: int, num_copies: int, num_extra: int) -> None:
    veclen = 1 << num_bits
    width = 2 + veclen
    bits_start = width * num_copies + num_extra

    def index(k):
        return wire(k * width)

    def output(k):
        return wire(k * width + 1)

    def inputs(k, j):
        return wire(k * width + 2 + j)

    def extra(j):
        return wire(num_copies * width + j)

    def bit(k, j):
        return wire(bits_start + k * num_bits + j)

    for k in range(num_copies):
        for j in range(num_bits):
            c.commit(bit(k, j) * (bit(k, j) - lit(1)))
        # reconstr = foldr (\b acc -> 2 acc + b) 0 bits  (bit 0 = LSB)
        reconstr = lit(0)
        for j in reversed(range(num_bits)):
            reconstr = lit(2) * reconstr + bit(k, j)
        c.commit(reconstr - index(k))
        # binary-tree mux, folding with bit j at level j
        values = [inputs(k, i) for i in range(veclen)]
        for j in range(num_bits):
            b = bit(k, j)
            values = [
                c.let(values[2 * i] + b * (values[2 * i + 1] - values[2 * i]))
                for i in range(len(values) // 2)
            ]
        c.commit(values[0] - output(k))

    for j in range(num_extra):
        c.commit(cnst(j) - extra(j))


def _coset_interpolation(c: Compute, subgroup_bits: int, degree: int, weights: Sequence[int]) -> None:
    n_points = 1 << subgroup_bits
    n_intermediates = (n_points - 2) // (degree - 1)
    domain = gf.enumerate_subgroup(subgroup_bits)

    coset_shift = wire(0)

    def poly_value(k):
        return wire_ext(1 + 2 * k)

    eval_loc = wire_ext(1 + 2 * n_points)
    eval_result = wire_ext(1 + 2 * n_points + 2)

    def tmp_eval(i):
        return wire_ext(1 + 2 * (n_points + 2) + 2 * i)

    def tmp_prod(i):
        return wire_ext(1 + 2 * (n_points + 2) + 2 * (n_intermediates + i))

    shifted_loc = wire_ext(1 + 2 * (n_points + 2) + 4 * n_intermediates)

    c.commit_ext(eval_loc - shifted_loc.scale(coset_shift))

    def chunk(xs):
        head = xs[:degree]
        rest = xs[degree:]
        out = [head]
        for i in range(0, len(rest), degree - 1):
            out.append(rest[i : i + degree - 1])
        return out

    values = [poly_value(k) for k in range(n_points)]
    chunked_domain = chunk(domain)
    chunked_values = chunk(values)
    chunked_weights = chunk(list(weights))

    def partial_interp(dom, vals, wts, ini):
        ev, prod = ini
        for v, w, xi in zip(vals, wts, dom):
            val = v.scale(lit(w))
            term = shifted_loc - _coerce_ext(lit(xi))
            ev, prod = term * ev + val * prod, term * prod
        return ev, prod

    initials = [(_coerce_ext(0), _coerce_ext(1))] + [
        (tmp_eval(i), tmp_prod(i)) for i in range(n_intermediates)
    ]
    results = [
        partial_interp(d, v, w, ini)
        for ini, (d, v, w) in zip(initials, zip(chunked_domain, chunked_values, chunked_weights))
    ]
    for i, (ev, prod) in enumerate(results[:-1]):
        c.commit_ext(tmp_eval(i) - ev)
        c.commit_ext(tmp_prod(i) - prod)
    final_eval, _ = results[-1]
    c.commit_ext(eval_result - final_eval)


def _reducing(c: Compute, num_coeffs: int) -> None:
    output = wire_ext(0)
    alpha = wire_ext(2)
    initial = wire_ext(4)

    def coeff(i):
        return wire(6 + i)

    def accum(i):
        return wire_ext(6 + num_coeffs + 2 * i) if i < num_coeffs - 1 else output

    prev = initial
    for i in range(num_coeffs):
        c.commit_ext(prev * alpha + _coerce_ext(coeff(i)) - accum(i))
        prev = accum(i)


def _reducing_ext(c: Compute, num_coeffs: int) -> None:
    output = wire_ext(0)
    alpha = wire_ext(2)
    initial = wire_ext(4)

    def coeff(i):
        return wire_ext(6 + 2 * i)

    def accum(i):
        return wire_ext(6 + 2 * num_coeffs + 2 * i) if i < num_coeffs - 1 else output

    prev = initial
    for i in range(num_coeffs):
        c.commit_ext(prev * alpha + coeff(i) - accum(i))
        prev = accum(i)


@lru_cache(maxsize=None)
def gate_program(gate: Gate) -> StraightLine:
    c = Compute()
    k, p = gate.kind, gate.params
    if k == "ArithmeticGate":
        _arithmetic(c, p[0])
    elif k == "ArithmeticExtensionGate":
        _arithmetic_ext(c, p[0])
    elif k == "BaseSumGate":
        _base_sum(c, p[0], p[1])
    elif k == "CosetInterpolationGate":
        _coset_interpolation(c, p[0], p[1], p[2])
    elif k == "ConstantGate":
        _constant(c, p[0])
    elif k == "ExponentiationGate":
        _exponentiation(c, p[0])
    elif k in ("LookupGate", "LookupTableGate", "NoopGate"):
        pass  # no row constraints (lookups use the dedicated argument)
    elif k == "MulExtensionGate":
        _mul_ext(c, p[0])
    elif k == "PublicInputGate":
        _public_input(c)
    elif k == "PoseidonGate":
        assert p[0] == 12, f"unsupported Poseidon width {p[0]}"
        _poseidon(c)
    elif k == "PoseidonMdsGate":
        assert p[0] == 12, f"unsupported PoseidonMds width {p[0]}"
        _poseidon_mds(c)
    elif k == "RandomAccessGate":
        _random_access(c, p[0], p[1], p[2])
    elif k == "ReducingGate":
        _reducing(c, p[0])
    elif k == "ReducingExtensionGate":
        _reducing_ext(c, p[0])
    else:
        raise ValueError(f"unknown gate: {gate}")
    return c.finish()
