"""Witness generation by triangular constraint solving.

Every Plonky2 gate's constraints are triangular: each committed constraint
is affine in (at most) one not-yet-assigned wire, whose value is determined
by the inputs and previously-assigned cells. Rather than hand-writing a
witness generator per gate, we *solve* the gate's own symbolic program:
evaluate constraints in commit order over the ring of affine functions
``a + b*u`` of the first unknown wire encountered (with lazy, memoized local
defs), and assign ``u = -a/b``. This guarantees the witness satisfies the
exact constraints the verifier checks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..gate_parser import Gate
from ..gates import CONST, LKPSEL, LOCAL, PI, SEL, WIRE, Expr, gate_program
from ..golden import field as gf

Affine = Tuple[int, int]  # (a, b) meaning a + b*u for the current unknown


class GateWitnessSolver:
    def __init__(
        self,
        gate: Gate,
        row: List[Optional[int]],
        constants: Sequence[int],
        pi_hash: Sequence[int] = (0, 0, 0, 0),
    ):
        self.prog = gate_program(gate)
        self.row = row
        self.constants = list(constants)
        self.pi_hash = list(pi_hash)
        self._local_cache: Dict[int, Affine] = {}
        self._unknown: Optional[int] = None  # wire index of the current unknown

    def _eval(self, e: Expr) -> Affine:
        op = e.op
        if op == "lit":
            return (e.args[0], 0)
        if op == "var":
            kind, idx = e.args
            if kind == WIRE:
                v = self.row[idx]
                if v is None:
                    if self._unknown is None:
                        self._unknown = idx
                    if self._unknown != idx:
                        raise ValueError(
                            f"constraint has multiple unknown wires ({self._unknown}, {idx})"
                        )
                    return (0, 1)
                return (v, 0)
            if kind == CONST:
                return (self.constants[idx], 0)
            if kind == PI:
                return (self.pi_hash[idx], 0)
            if kind == LOCAL:
                if idx not in self._local_cache:
                    val = self._eval(self.prog.local_defs[idx])
                    if val[1] != 0:
                        raise ValueError("local def depends on an unknown wire")
                    self._local_cache[idx] = val
                return self._local_cache[idx]
            if kind in (SEL, LKPSEL):
                raise ValueError("gate constraints must not reference selector columns")
            raise KeyError(kind)
        a = self._eval(e.args[0])
        if op == "img":
            raise ValueError("img nodes have no base-field witness semantics")
        b = self._eval(e.args[1])
        if op == "add":
            return ((a[0] + b[0]) % gf.P, (a[1] + b[1]) % gf.P)
        if op == "sub":
            return ((a[0] - b[0]) % gf.P, (a[1] - b[1]) % gf.P)
        if op == "mul":
            if a[1] and b[1]:
                raise ValueError("constraint is nonlinear in the unknown wire")
            return ((a[0] * b[0]) % gf.P, (a[0] * b[1] + a[1] * b[0]) % gf.P)
        raise KeyError(op)

    def solve(self) -> List[Optional[int]]:
        for c in self.prog.constraints:
            self._unknown = None
            a, b = self._eval(c)
            if self._unknown is None:
                if a % gf.P != 0:
                    raise ValueError(f"pre-filled witness violates constraint: {c!r} = {a}")
                continue
            if b % gf.P == 0:
                # unknown cancelled; constraint must hold on its own
                if a % gf.P != 0:
                    raise ValueError(f"unsolvable constraint: {c!r}")
                continue
            self.row[self._unknown] = (-a * gf.finv(b)) % gf.P
        return self.row


def solve_gate_witness(
    gate: Gate,
    num_wires: int,
    prefill: Dict[int, int],
    constants: Sequence[int] = (0, 0),
    pi_hash: Sequence[int] = (0, 0, 0, 0),
    fill_unused: int = 0,
) -> List[int]:
    """Solve a full row for `gate`. `prefill` maps wire index -> value for the
    gate's free inputs; remaining cells are derived from the constraints.
    Unconstrained cells are set to `fill_unused`."""
    row: List[Optional[int]] = [None] * num_wires
    for k, v in prefill.items():
        row[k] = v % gf.P
    solver = GateWitnessSolver(gate, row, constants, pi_hash)
    row = solver.solve()
    return [fill_unused if v is None else v for v in row]


def poseidon_gate_witness(inputs: Sequence[int], swap: int = 0, num_wires: int = 135) -> List[int]:
    """Fill a PoseidonGate row: inputs at wires 0..11, swap flag at 24;
    outputs (12..23), deltas, and all sbox-input cells are solved."""
    prefill = {i: int(x) % gf.P for i, x in enumerate(inputs)}
    prefill[24] = swap
    return solve_gate_witness(Gate("PoseidonGate", (12,)), num_wires, prefill)
