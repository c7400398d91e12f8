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


def big_lut_fixture(
    table_size: int = 1 << 16,
    inputs: tuple = (51, 2),
    num_query_rounds: int = 28,
    proof_of_work_bits: int = 16,
    seed: int = 0,
) -> Fixture:
    """Plonky2's `test_big_lut` (plonky2/src/lookup_test.rs) under the
    standard recursion config: one table of `table_size` (u16::MAX + 1 in
    Plonky2) pairs (x, y), x = 0, 1, ... and each y a u16 drawn from `seed`,
    then one lookup of each of `inputs`. The public inputs are those inputs
    and their outputs, in the order the test registers them (initial_a,
    initial_b, output_a, output_b). Proofs of other `inputs` share the
    circuit: the looked-up pairs and the multiplicities are witness words."""
    b = CircuitBuilder(seed=seed, num_query_rounds=num_query_rounds, proof_of_work_bits=proof_of_work_bits)
    outputs = [b.rng.getrandbits(16) for _ in range(table_size)]
    lut = b.add_lookup_table(list(zip(range(table_size), outputs)))
    looked = [b.add_lookup(lut, x) for x in inputs]
    b.add_row(Gate("PublicInputGate"))
    b.set_public_inputs(list(inputs) + looked)
    return b.build(name="big_lut")
