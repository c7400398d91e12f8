"""Small circuits of many shapes, for driving TorchVerifier where the fixed
fixtures do not reach: the six-point shape grid (cap_height 0/2/4 x
arity_bits 1/2/3 x final_poly_bits 0/1/2: cap sizes, fold structures, path
lengths down to 0, final-poly lengths) and the seeded fuzz circuits (random
gate mixes with the hard gates and lookup blocks).

The two functions are the port's own copies of tests/shape_grid_check.py
(tiny_fixture) and tests/test_fuzz_circuits.py (_random_circuit), which
build with the JAX package's CircuitBuilder; tests/test_torch_shapes.py
holds the circuits and proofs of both equal. `check_circuit` drives one
through TorchVerifier, on the CPU in tests/test_torch_shapes.py; with
`transcript_equals_golden` it holds a verifier's debug transcript against
golden/ (tests/test_torch_forward_card.py does on the card).
"""

import random

import numpy as np

from ..gate_parser import Gate
from ..golden import field as gf
from ..models.builder import CircuitBuilder
from ..models.gate_zoo import barycentric_weights

# (cap_height, arity_bits, final_poly_bits): every axis value appears twice
GRID = [(0, 1, 0), (2, 2, 1), (4, 3, 2), (0, 3, 1), (2, 1, 2), (4, 2, 0)]
# seed 13 carries PoseidonGate + ArithmeticExtension, seed 23 adds RandomAccess + PoseidonMds
FUZZ_SEEDS = [13, 23]
# Arrays whose first word is flipped, one a lane; each must reject whatever
# the shape. cap_w is absorbed by the transcript; cap_cs (vkey data, not
# absorbed) is caught only when a query lands in the mutated entry's subtree,
# so it is no always-reject probe. The step arrays apply where the template
# has a fold step, and step_sibs_0 is empty when the step's cap covers the
# whole folded tree (path_len 0): empty arrays are passed over.
GRID_FAULTS = ["pow_witness", "cap_w", "final_poly", "step_sibs_0", "step_evals_0"]
FUZZ_FAULTS = ["pow_witness", "openings1", "leaves_1"]


def grid_fixture(cap_height: int, arity_bits: int, final_poly_bits: int):
    """A minimal-gate circuit (the gate set does not matter to the shape
    axes) with the given FRI shape parameters."""
    b = CircuitBuilder(
        num_query_rounds=2,
        proof_of_work_bits=2,
        cap_height=cap_height,
        arity_bits=arity_bits,
        final_poly_bits=final_poly_bits,
    )
    b.add_row(Gate("ConstantGate", (2,)), constants=(3, 4))
    for _ in range(4):
        b.add_row(Gate("NoopGate", ()))
    b.add_row(Gate("PublicInputGate"))
    b.set_public_inputs([3])
    return b.build(name=f"grid_c{cap_height}a{arity_bits}f{final_poly_bits}")


MENU = [
    "arith", "mulext", "basesum", "exp", "reducing", "noop",
    "arith_ext", "poseidon", "poseidon_mds", "coset", "random_access",
]


def fuzz_fixture(seed: int):
    """The seeded random gate mix of tests/test_fuzz_circuits.py (_random_circuit)."""
    rng = random.Random(seed)
    b = CircuitBuilder(
        seed=seed,
        num_query_rounds=rng.choice([3, 4, 6]),
        proof_of_work_bits=rng.choice([0, 2, 4]),
        arity_bits=rng.choice([1, 2]),
        final_poly_bits=rng.choice([0, 1]),
    )
    rnd = lambda: rng.randrange(gf.P)

    # a random multiset of gate rows; prefills give solvable inputs
    n_gates = rng.randrange(2, 6)
    for _ in range(n_gates):
        kind = rng.choice(MENU)
        if kind == "arith":
            ops = rng.choice([2, 5, 20])
            pre = {}
            for op in range(ops):
                pre[4 * op] = rnd()
                pre[4 * op + 1] = rnd()
                pre[4 * op + 2] = rnd()
            b.add_row(Gate("ArithmeticGate", (ops,)), constants=(rnd(), rnd()), prefill=pre)
        elif kind == "mulext":
            ops = rng.choice([1, 3, 13])
            pre = {}
            for op in range(ops):
                for c in range(4):
                    pre[6 * op + c] = rnd()
            b.add_row(Gate("MulExtensionGate", (ops,)), constants=(rnd(),), prefill=pre)
        elif kind == "basesum":
            # limbs prefilled (each range-constrained), the sum wire is solved
            limbs = rng.choice([4, 8, 16])
            base = rng.choice([2, 4])
            val = rng.randrange(base**limbs)
            pre = {}
            for i in range(limbs):
                pre[1 + i] = val % base
                val //= base
            b.add_row(Gate("BaseSumGate", (limbs, base)), prefill=pre)
        elif kind == "exp":
            bits = rng.choice([2, 3, 5])
            b.add_row(
                Gate("ExponentiationGate", (bits,)),
                prefill={0: rnd(), **{1 + i: rng.randrange(2) for i in range(bits)}},
            )
        elif kind == "reducing":
            # wires: out(0,1) alpha(2,3) old_acc(4,5) coeffs(6..6+n) — solve
            # out and the accumulators, prefill the rest
            n = rng.choice([2, 4])
            pre = {k: rnd() for k in range(2, 6)}
            for i in range(n):
                pre[6 + i] = rnd()
            b.add_row(Gate("ReducingGate", (n,)), prefill=pre)
        elif kind == "arith_ext":
            ops = rng.choice([2, 10])
            pre = {}
            for op in range(ops):
                for c in range(6):  # x,y,z ext pairs; out solved
                    pre[8 * op + c] = rnd()
            b.add_row(Gate("ArithmeticExtensionGate", (ops,)), constants=(rnd(), rnd()), prefill=pre)
        elif kind == "poseidon":
            pre = {i: rnd() for i in range(12)}
            pre[24] = 0  # no merkle swap
            b.add_row(Gate("PoseidonGate", (12,)), prefill=pre)
        elif kind == "poseidon_mds":
            b.add_row(Gate("PoseidonMdsGate", (12,)), prefill={i: rnd() for i in range(24)})
        elif kind == "coset":
            sub_bits, degree = 4, rng.choice([6, 8])
            g = Gate("CosetInterpolationGate", (sub_bits, degree, barycentric_weights(sub_bits)))
            n_points = 1 << sub_bits
            pre = {0: gf.MULT_GEN}
            for k in range(n_points):
                pre[1 + 2 * k] = rnd()
                pre[1 + 2 * k + 1] = rnd()
            n_intermediates = (n_points - 2) // (degree - 1)
            sl_base = 1 + 2 * (n_points + 2) + 4 * n_intermediates
            pre[sl_base] = rnd()
            pre[sl_base + 1] = rnd()
            b.add_row(g, prefill=pre)
        elif kind == "random_access":
            bits, copies, extra = 2, rng.choice([2, 4]), 0
            g = Gate("RandomAccessGate", (bits, copies, extra))
            width = 2 + (1 << bits)
            pre = {}
            for k in range(copies):
                idx = rng.randrange(1 << bits)
                pre[k * width] = idx
                for j in range(1 << bits):
                    pre[k * width + 2 + j] = rnd()
                for j in range(bits):
                    pre[copies * width + extra + k * bits + j] = (idx >> j) & 1
            b.add_row(g, prefill=pre)
        else:
            b.add_row(Gate("NoopGate", ()))
    if rng.random() < 0.5:
        # seeded lookup block: small LUT, a few uses
        tsize = rng.choice([8, 16])
        table = [(x, (x * x + rng.randrange(16)) % gf.P) for x in range(tsize)]
        lut = b.add_lookup_table(table)
        for _ in range(rng.randrange(1, 6)):
            b.add_lookup(lut, rng.randrange(tsize))
    b.set_public_inputs([rng.randrange(1000) for _ in range(rng.randrange(0, 3))])
    return b.build(name=f"fuzz{seed}")


def transcript_equals_golden(common, dbg, lane: int, vkey, pwp):
    """Raises unless lane `lane` of a debug forward's challenges (`dbg`,
    TorchVerifier(debug=True)'s out["debug"]) equal golden/'s for the proof:
    zeta, the betas, gammas, alphas and lookup deltas, the FRI alpha, the
    proof-of-work response, the query indices and the public-input hash."""
    from ..golden.challenges import proof_challenges
    from ..golden.hashing import sponge
    from ..ops.field import to_u64

    ch = proof_challenges(common, vkey, pwp)
    u = lambda t: [int(v) for v in np.atleast_1d(to_u64(t[lane]))]
    got = {
        "zeta": (u(dbg["zeta"][0])[0], u(dbg["zeta"][1])[0]),
        "betas": [u(b)[0] for b in dbg["betas"]],
        "gammas": [u(g)[0] for g in dbg["gammas"]],
        "alphas": [u(a)[0] for a in dbg["alphas"]],
        "deltas": [tuple(u(x)[0] for x in d) for d in dbg["deltas"]],
        "fri_alpha": (u(dbg["fri_alpha"][0])[0], u(dbg["fri_alpha"][1])[0]),
        "pow_response": u(dbg["pow_response"])[0],
        "query_indices": u(dbg["query_indices"]),
        "pi_hash": tuple(u(dbg["pi_hash"])),
    }
    want = {
        "zeta": tuple(ch.zeta),
        "betas": list(ch.betas),
        "gammas": list(ch.gammas),
        "alphas": list(ch.alphas),
        "deltas": [(d.a, d.b, d.alpha, d.delta) for d in ch.deltas],
        "fri_alpha": tuple(ch.fri.alpha),
        "pow_response": ch.fri.pow_response,
        "query_indices": list(ch.fri.query_indices),
        "pi_hash": tuple(sponge(pwp.public_inputs)),
    }
    for k in want:
        if got[k] != want[k]:
            raise AssertionError(f"lane {lane}: {k} differs from golden: {got[k]} != {want[k]}")


def check_circuit(name: str, common, vkey, pwp, faults, device=None):
    """One proof of a small circuit through TorchVerifier on `device` (None:
    the card): a batch of 2 accepted with lane 0's transcript equal to
    golden, then a batch that holds one fault a lane (the first word of that
    array flipped; empty arrays passed over) and one intact lane behind
    them, rejected on exactly the faulted lanes. Prints a line of the shape
    and the verdicts; returns the verifier."""
    from ..compiler import CircuitTemplate, flatten_proofs
    from ..verifier_torch import TorchVerifier

    tpl = CircuitTemplate(common)
    v = TorchVerifier(tpl, debug=True, device=device)
    out = v(v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * 2)))
    if v.to_host(out).tolist() != [True, True]:
        raise AssertionError(f"{name}: an honest proof was rejected: {out['ok']}, eqs {out['eqs_ok']}, fri {out['fri_ok']}")
    transcript_equals_golden(common, out["debug"], 0, vkey, pwp)
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * (len(faults) + 1))
    live = [f for f in faults if f in arrays and arrays[f].size]
    for lane, fault in enumerate(live):
        arrays[fault].reshape(len(faults) + 1, -1)[lane, 0] ^= np.uint64(1)
    ok = v.to_host(v(v.prepare({k: a[: len(live) + 1] for k, a in arrays.items()}))).tolist()
    if ok != [False] * len(live) + [True]:
        raise AssertionError(f"{name}: faults {live} gave verdicts {ok}")
    print(f"shape {name}: degree_bits {tpl.degree_bits}, cap {tpl.cap_len}, initial path {tpl.initial_path_len}, steps "
          f"{[(st['arity_bits'], st['path_len'], st['cap_len']) for st in tpl.steps]}, final poly {tpl.final_poly_len}, "
          f"{tpl.n_pi} public inputs, {tpl.num_queries} queries: accepted, transcript equals golden, rejected {live}")
    return v
