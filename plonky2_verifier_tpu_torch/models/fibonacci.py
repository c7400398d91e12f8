"""Fibonacci fixture: ArithmeticGate chains + cross-row routing + public
inputs. The smallest end-to-end circuit family (analog of the reference's
`fibonacci` JSON fixture, testmain.hs:28)."""

from __future__ import annotations

from ..gate_parser import Gate
from ..golden import field as gf
from .builder import CircuitBuilder, Fixture


def fibonacci_fixture(
    n_arith_rows: int = 5,
    num_query_rounds: int = 28,
    proof_of_work_bits: int = 8,
    seed: int = 0,
    x0: int = 1,
    x1: int = 2,
    **builder_kwargs,
) -> Fixture:
    """Compute fib-style chain x_{k+2} = x_k + x_{k+1} across `n_arith_rows`
    ArithmeticGate rows (20 ops each), with:
    - op output routed into the next op's inputs (copy constraints),
    - the constant 1 (the `y` multiplicand) routed from a ConstantGate row,
    - public inputs [x0, x1, result].

    Different (x0, x1) produce distinct proofs over the *same* circuit shape
    (identical CommonCircuitData/template) — used for heterogeneous-batch
    tests where every lane must carry a genuinely different transcript."""
    # builder_kwargs passes shape knobs straight through (cap_height,
    # arity_bits, final_poly_bits, rate_bits...): circuit shape is data
    # (Types.hs:151-171) and the shape-grid tests exercise the derivations
    b = CircuitBuilder(
        seed=seed,
        num_query_rounds=num_query_rounds,
        proof_of_work_bits=proof_of_work_bits,
        **builder_kwargs,
    )
    arith = Gate("ArithmeticGate", (20,))
    const = Gate("ConstantGate", (2,))
    pi = Gate("PublicInputGate")
    seq = [x0, x1]
    total_ops = 20 * n_arith_rows
    for _ in range(total_ops):
        seq.append(gf.fadd(seq[-2], seq[-1]))

    # ConstantGate row: wire 0 holds 1, wire 1 holds 0
    const_row = b.add_row(const, constants=(1, 0))

    # Arithmetic rows: op i computes out = c0*x*y + c1*z with c0=c1=1, y=1
    # wires per op: (x, y, z, out) at 4i..4i+3
    rows = []
    k = 0
    for _ in range(n_arith_rows):
        prefill = {}
        for op in range(20):
            prefill[4 * op + 0] = seq[k]  # x = f_k
            prefill[4 * op + 1] = 1  # y = 1
            prefill[4 * op + 2] = seq[k + 1]  # z = f_{k+1}
            k += 1
        r = b.add_row(arith, constants=(1, 1), prefill=prefill)
        rows.append(r)

    # routing: y cells <- constant row wire 0; chain outputs into next inputs
    k = 0
    for r in rows:
        for op in range(20):
            b.connect((r, 4 * op + 1), (const_row, 0))
            if k + 2 <= len(seq) - 1 and k + 2 < total_ops + 2:
                # out(op) == z of the next op == x of the op after next
                nxt = k + 1
                if nxt < total_ops:
                    r2, op2 = rows[nxt // 20], nxt % 20
                    b.connect((r, 4 * op + 3), (r2, 4 * op2 + 2))
                nxt2 = k + 2
                if nxt2 < total_ops:
                    r3, op3 = rows[nxt2 // 20], nxt2 % 20
                    b.connect((r, 4 * op + 3), (r3, 4 * op3 + 0))
            k += 1

    b.add_row(pi)
    b.set_public_inputs([x0, x1, seq[total_ops + 1]])
    return b.build(name="fibonacci")
