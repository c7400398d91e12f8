"""Levelizer for gate constraint programs (pure numpy, no JAX).

A gate's straight-line program (gates.py) is an SSA DAG of ext-field
add/sub/mul nodes. `levelize_gates` groups the nodes of all the circuit's
gates by depth into one program over a value tape:

    tape: (B, T) ext values
    per level: one batched add/sub wave, then one batched mul wave,
               each a gather -> elementwise op -> scatter.

Subtraction rides the add wave as a + sign*b with sign in {1, p-1}. Padded
dummy ops read and write slot 0, the trash slot, which no real op reads.

This is a copy of `_levelize` / `levelize_gates` from
plonky2_verifier_tpu/compiler/gates_jax.py, which cannot be imported without
JAX; tests/test_torch_gates.py holds the two to identical arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from ..gate_parser import Gate
from ..gates import CONST, LKPSEL, LOCAL, PI, SEL, WIRE, Expr, gate_program
from ..golden import field as gf

P_MINUS_1 = gf.P - 1


@dataclass
class LevelizedProgram:
    """Compiled gate program. Input layout of the tape:
    [0] = 0 scratch/trash, [1..n_lits] literal pool,
    then selector, lkp-selector, constant, wire, pi-hash slots (template
    widths), then one slot per SSA node."""

    gate: Gate
    n_tape: int
    lit_values: np.ndarray  # (n_lits,) uint64
    input_slots: Dict[str, Tuple[int, int]]  # kind -> (offset, count)
    # scan arrays, one row per level:
    add_src1: np.ndarray  # (L, maxA) int32
    add_src2: np.ndarray
    add_sign: np.ndarray  # (L, maxA) uint64 (1 or p-1)
    add_dst: np.ndarray
    mul_src1: np.ndarray  # (L, maxM) int32
    mul_src2: np.ndarray
    mul_dst: np.ndarray
    out_slots: np.ndarray  # (n_constraints,) int32
    n_levels: int
    out_slots_per_prog: tuple = ()  # when levelizing many programs at once


def _levelize(prog, widths: Dict[str, int]) -> LevelizedProgram:
    """Levelize one StraightLine program, or a list of them into a single
    merged program (shared literal pool and input slots, one scan): the DAGs
    are independent, so their levels interleave and the wave widths add."""
    progs = prog if isinstance(prog, (list, tuple)) else [prog]
    lit_pool: Dict[int, int] = {}  # value -> slot
    slot_of: Dict[int, int] = {}  # id(node) -> slot
    level_of: Dict[int, int] = {}
    ops: List[Tuple[int, str, int, int, int, int]] = []  # (level, op, s1, s2, sign, dst)

    offset = 1  # slot 0 = trash/zero
    lit_base = offset

    def lit_slot(v: int) -> int:
        if v not in lit_pool:
            lit_pool[v] = len(lit_pool)
        return lit_base + lit_pool[v]

    # reserve literal slots lazily; input slots after a first pass for lits.
    # Two-pass: first collect literals, then assign input offsets.
    def collect_lits(e: Expr):
        if e.op == "lit":
            lit_slot(e.args[0])
        elif e.op == "var":
            pass
        else:
            for a in e.args:
                collect_lits(a)

    for pg in progs:
        for d in pg.local_defs:
            collect_lits(d)
        for c in pg.constraints:
            collect_lits(c)

    n_lits = len(lit_pool)
    input_slots: Dict[str, Tuple[int, int]] = {}
    cur = lit_base + n_lits
    for kind in (SEL, LKPSEL, CONST, WIRE, PI):
        w = widths.get(kind, 0)
        input_slots[kind] = (cur, w)
        cur += w
    next_slot = [cur]

    local_slot: Dict[int, int] = {}
    local_level: Dict[int, int] = {}

    def visit(e: Expr) -> Tuple[int, int]:
        """-> (slot, level)"""
        key = id(e)
        if key in slot_of:
            return slot_of[key], level_of[key]
        if e.op == "lit":
            s, l = lit_slot(e.args[0]), 0
        elif e.op == "var":
            kind, idx = e.args
            if kind == LOCAL:
                s, l = local_slot[idx], local_level[idx]
            else:
                base, w = input_slots[kind]
                assert idx < w, f"{kind}[{idx}] out of range {w}"
                s, l = base + idx, 0
        else:
            if e.op == "img":
                # X * a == lit(X) * a with the literal (0,1); encode as mul by
                # a dedicated ext literal slot. We reuse slot_of for the node.
                raise NotImplementedError("img nodes are unused by all gates")
            (s1, l1) = visit(e.args[0])
            (s2, l2) = visit(e.args[1])
            l = max(l1, l2) + 1
            s = next_slot[0]
            next_slot[0] += 1
            if e.op == "mul":
                ops.append((l, "mul", s1, s2, 0, s))
            elif e.op == "add":
                ops.append((l, "add", s1, s2, 1, s))
            else:  # sub
                ops.append((l, "add", s1, s2, P_MINUS_1, s))
        slot_of[key] = s
        level_of[key] = l
        return s, l

    out_per_prog = []
    for pg in progs:
        local_slot.clear()
        local_level.clear()
        slot_of.clear()
        level_of.clear()
        for i, d in enumerate(pg.local_defs):
            s, l = visit(d)
            local_slot[i] = s
            local_level[i] = l
        outs = []
        for c in pg.constraints:
            s, _ = visit(c)
            outs.append(s)
        out_per_prog.append(outs)
    out = [s for outs in out_per_prog for s in outs]

    n_levels = max((op[0] for op in ops), default=1)
    adds_per_level: List[List] = [[] for _ in range(n_levels)]
    muls_per_level: List[List] = [[] for _ in range(n_levels)]
    for (l, kind, s1, s2, sign, dst) in ops:
        (adds_per_level if kind == "add" else muls_per_level)[l - 1].append((s1, s2, sign, dst))

    max_a = max((len(a) for a in adds_per_level), default=0) or 1
    max_m = max((len(m) for m in muls_per_level), default=0) or 1

    def pack(per_level, width, with_sign):
        src1 = np.zeros((n_levels, width), dtype=np.int32)
        src2 = np.zeros((n_levels, width), dtype=np.int32)
        sign = np.ones((n_levels, width), dtype=np.uint64)
        dst = np.zeros((n_levels, width), dtype=np.int32)  # dummy -> trash slot 0
        for li, lst in enumerate(per_level):
            for k, (s1, s2, sg, d) in enumerate(lst):
                src1[li, k] = s1
                src2[li, k] = s2
                sign[li, k] = sg
                dst[li, k] = d
        return src1, src2, sign, dst

    a1, a2, asg, ad = pack(adds_per_level, max_a, True)
    m1, m2, _, md = pack(muls_per_level, max_m, False)

    lits = np.zeros(n_lits, dtype=np.uint64)
    for v, i in lit_pool.items():
        lits[i] = v

    return LevelizedProgram(
        gate=None,
        n_tape=next_slot[0],
        lit_values=lits,
        input_slots=input_slots,
        add_src1=a1,
        add_src2=a2,
        add_sign=asg,
        add_dst=ad,
        mul_src1=m1,
        mul_src2=m2,
        mul_dst=md,
        out_slots=np.array(out, dtype=np.int32),
        n_levels=n_levels,
        out_slots_per_prog=tuple(np.array(o, dtype=np.int32) for o in out_per_prog),
    )


@lru_cache(maxsize=None)
def levelize_gates(
    gates: Tuple[Gate, ...], n_sel: int, n_lkp: int, n_const: int, n_wires: int
) -> LevelizedProgram:
    """Merge all gates' programs into one levelized program (one scan for the
    whole circuit's gate-constraint evaluation); `out_slots_per_prog[i]` holds
    gate i's constraint slots."""
    progs = [gate_program(g) for g in gates]
    return _levelize(progs, {SEL: n_sel, LKPSEL: n_lkp, CONST: n_const, WIRE: n_wires, PI: 4})
