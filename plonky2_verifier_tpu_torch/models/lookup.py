"""Lookup fixtures: circuits exercising the log-derivative lookup argument
(LookupGate + LookupTableGate rows, lookup selector columns, RE/SLDC running
sums). Analogs of the reference's `lookup` / `multi_lookup` JSON fixtures
(testmain.hs:28-29)."""

from __future__ import annotations

from ..gate_parser import Gate
from ..golden import field as gf
from .builder import CircuitBuilder, Fixture


def lookup_fixture(
    table_size: int = 37,
    n_lookups: int = 50,
    num_query_rounds: int = 28,
    proof_of_work_bits: int = 8,
    seed: int = 0,
) -> Fixture:
    """One lookup table f(x) = x^2 + 7, `n_lookups` uses, with one looked-up
    output routed into an ArithmeticGate row and exposed as a public input."""
    b = CircuitBuilder(seed=seed, num_query_rounds=num_query_rounds, proof_of_work_bits=proof_of_work_bits)
    table = [(x, (x * x + 7) % gf.P) for x in range(table_size)]
    lut = b.add_lookup_table(table)

    rng = b.rng
    outs = []
    for _ in range(n_lookups):
        x = rng.randrange(table_size)
        outs.append((x, b.add_lookup(lut, x)))

    # arithmetic row consuming the first looked-up output: out = 1*y*1 + 1*y
    y = outs[0][1]
    arith = Gate("ArithmeticGate", (20,))
    prefill = {w: 0 for op in range(20) for w in (4 * op, 4 * op + 1, 4 * op + 2)}
    prefill.update({0: y, 1: 1, 2: y})
    b.add_row(arith, constants=(1, 1), prefill=prefill)

    b.add_row(Gate("PublicInputGate"))
    b.set_public_inputs([outs[0][0], (2 * y) % gf.P])
    return b.build(name="lookup")


def multi_lookup_fixture(
    num_query_rounds: int = 28, proof_of_work_bits: int = 8, seed: int = 1
) -> Fixture:
    """Two lookup tables of different sizes and shapes, interleaved uses, plus
    arithmetic rows (the reference's `multi_lookup` family)."""
    b = CircuitBuilder(seed=seed, num_query_rounds=num_query_rounds, proof_of_work_bits=proof_of_work_bits)
    t1 = [(x, (3 * x + 1) % gf.P) for x in range(26)]  # exactly one LUT row
    t2 = [(x, gf.fpow(x, 3)) for x in range(61)]  # padded LUT rows
    lut1 = b.add_lookup_table(t1)
    lut2 = b.add_lookup_table(t2)

    rng = b.rng
    total = 0
    for _ in range(45):
        b.add_lookup(lut1, rng.randrange(26))
        total += 1
    for _ in range(85):  # > 2 full Lookup rows
        b.add_lookup(lut2, rng.randrange(61))
        total += 1

    arith = Gate("ArithmeticGate", (20,))
    prefill = {w: 0 for op in range(20) for w in (4 * op, 4 * op + 1, 4 * op + 2)}
    prefill.update({0: 5, 1: 6, 2: 0})
    b.add_row(arith, constants=(1, 0), prefill=prefill)
    b.set_public_inputs([total])
    return b.build(name="multi_lookup")
