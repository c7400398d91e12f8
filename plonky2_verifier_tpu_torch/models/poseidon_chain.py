"""Poseidon hash-chain fixture: rows of PoseidonGate with outputs routed
into the next row's inputs. Exercises the largest gate (123 constraints,
degree 7) and — at enough rows — FRI commit-phase folding."""

from __future__ import annotations

from ..gate_parser import Gate
from ..golden import field as gf
from .builder import CircuitBuilder, Fixture


def poseidon_chain_fixture(
    n_chain: int = 6,
    num_query_rounds: int = 28,
    proof_of_work_bits: int = 8,
    arity_bits: int = 4,
    final_poly_bits: int = 5,
    seed: int = 0,
) -> Fixture:
    b = CircuitBuilder(
        seed=seed,
        num_query_rounds=num_query_rounds,
        proof_of_work_bits=proof_of_work_bits,
        arity_bits=arity_bits,
        final_poly_bits=final_poly_bits,
    )
    pos = Gate("PoseidonGate", (12,))
    pi = Gate("PublicInputGate")

    state = [gf.fmul(i + 1, 0x9E3779B97F4A7C15) % gf.P for i in range(12)]
    rows = []
    for r in range(n_chain):
        prefill = {i: state[i] for i in range(12)}
        prefill[24] = 0  # no merkle swap
        row = b.add_row(pos, prefill=prefill)
        rows.append(row)
        from ..golden.poseidon import permutation

        state = permutation(state)
        if r > 0:
            for i in range(12):
                b.connect((rows[r - 1], 12 + i), (rows[r], i))

    b.add_row(pi)
    b.set_public_inputs(state[:4])
    return b.build(name="poseidon_chain")
