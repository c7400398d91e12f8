"""Gate-zoo fixture: one circuit exercising every gate kind.

The reference's recursion fixtures (`recursion_middle`/`recursion_outer`,
testmain.hs:28-29) are what pull CosetInterpolation, RandomAccess,
Reducing(Ext) and PoseidonMds into play (Gate/Custom/*.hs); this fixture is
their analog: a single circuit with one row of every gate family —
Arithmetic, ArithmeticExtension, BaseSum, Constant, CosetInterpolation,
Exponentiation, MulExtension, Poseidon, PoseidonMds, PublicInput,
RandomAccess, Reducing, ReducingExtension, Noop (padding) — plus an optional
lookup block (Lookup/LookupTable), covering all 16 kinds in one proof.

Witnesses are solved from the gates' own symbolic constraints
(prover/witness.py); prefills below give each gate mathematically meaningful
inputs (e.g. the CosetInterpolation row really interpolates a polynomial
over a shifted coset, so its solved eval_result must equal p(eval_loc) —
asserted in tests/test_gate_zoo.py)."""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

from ..gate_parser import Gate
from ..golden import field as gf
from .builder import CircuitBuilder, Fixture


def barycentric_weights(subgroup_bits: int) -> Tuple[int, ...]:
    """w_i = 1 / prod_{j != i} (x_i - x_j) over the 2^bits subgroup
    (Gate/Custom/CosetInterp.hs:44-47)."""
    pts = gf.enumerate_subgroup(subgroup_bits)
    out = []
    for i, xi in enumerate(pts):
        prod = 1
        for j, xj in enumerate(pts):
            if j != i:
                prod = prod * ((xi - xj) % gf.P) % gf.P
        out.append(gf.finv(prod))
    return tuple(out)


def gate_zoo_fixture(
    num_query_rounds: int = 28,
    proof_of_work_bits: int = 8,
    with_lookup: bool = True,
    seed: int = 7,
    arity_bits: int = 4,
    final_poly_bits: int = 5,
    target_degree_bits: int = 0,
) -> Fixture:
    """One circuit exercising every gate kind; `target_degree_bits > 0`
    additionally fills the circuit with a rotating mix of real gate rows
    (Arithmetic/MulExt/ArithExt/BaseSum/PoseidonMds/Poseidon/ReducingExt)
    up to ~2^target rows — the gate-heavy / recursion-shaped bench configs
    (BASELINE configs 3-4; the reference's analog is the Poseidon-dominated
    recursion fixtures, testmain.hs:28-29)."""
    rng = random.Random(seed)
    b = CircuitBuilder(
        seed=seed,
        num_query_rounds=num_query_rounds,
        proof_of_work_bits=proof_of_work_bits,
        arity_bits=arity_bits,
        final_poly_bits=final_poly_bits,
    )

    def rnd() -> int:
        return rng.randrange(gf.P)

    def rnd_ext() -> Tuple[int, int]:
        return (rnd(), rnd())

    # ConstantGate: its two cells route into other gates' inputs below.
    c0_val, c1_val = 5, 11
    const_row = b.add_row(Gate("ConstantGate", (2,)), constants=(c0_val, c1_val))

    # ArithmeticGate (20 ops): out = c0*x*y + c1*z
    arith_prefill: Dict[int, int] = {}
    for op in range(20):
        arith_prefill[4 * op + 0] = rnd()
        arith_prefill[4 * op + 1] = rnd()
        arith_prefill[4 * op + 2] = rnd()
    arith_row = b.add_row(Gate("ArithmeticGate", (20,)), constants=(3, 4), prefill=arith_prefill)

    # ArithmeticExtensionGate (10 ops): ext out = c0*x*y + c1*z over wireExt pairs
    ae_prefill: Dict[int, int] = {}
    for op in range(10):
        for k in range(6):  # x,y,z as 3 ext = 6 cells; out solved
            ae_prefill[8 * op + k] = rnd()
    b.add_row(Gate("ArithmeticExtensionGate", (10,)), constants=(rnd(), rnd()), prefill=ae_prefill)

    # MulExtensionGate (13 ops): ext out = c0*x*y
    me_prefill: Dict[int, int] = {}
    for op in range(13):
        for k in range(4):
            me_prefill[6 * op + k] = rnd()
    b.add_row(Gate("MulExtensionGate", (13,)), constants=(rnd(), 0), prefill=me_prefill)

    # BaseSumGate (63 limbs, base 2): limbs prefilled, the sum wire is solved
    bs_val = rng.randrange(1 << 63)
    bs_prefill = {1 + i: (bs_val >> i) & 1 for i in range(63)}
    b.add_row(Gate("BaseSumGate", (63, 2)), prefill=bs_prefill)

    # ExponentiationGate (8 bits): base routed from the ConstantGate row
    exp_e = rng.randrange(1 << 8)
    exp_prefill = {0: c0_val}
    for j in range(8):
        exp_prefill[1 + j] = (exp_e >> j) & 1
    exp_row = b.add_row(Gate("ExponentiationGate", (8,)), prefill=exp_prefill)
    b.connect((exp_row, 0), (const_row, 0))

    # RandomAccessGate (bits=4, copies=4, extra=2): 16-vector dynamic index
    ra_gate = Gate("RandomAccessGate", (4, 4, 2))
    ra_prefill: Dict[int, int] = {}
    width = 2 + 16
    ra_vecs: List[List[int]] = []
    ra_idxs: List[int] = []
    for k in range(4):
        vec = [rnd() for _ in range(16)]
        idx = rng.randrange(16)
        ra_vecs.append(vec)
        ra_idxs.append(idx)
        ra_prefill[k * width] = idx
        for j, v in enumerate(vec):
            ra_prefill[k * width + 2 + j] = v
        for j in range(4):  # index bits live past the routed region
            ra_prefill[4 * width + 2 + k * 4 + j] = (idx >> j) & 1
    ra_row = b.add_row(ra_gate, constants=(c0_val, c1_val), prefill=ra_prefill)

    # ReducingGate (32 base coeffs): Horner accumulation; coeff 0 routed
    red_prefill: Dict[int, int] = {}
    red_alpha = rnd_ext()
    red_init = rnd_ext()
    red_prefill[2], red_prefill[3] = red_alpha
    red_prefill[4], red_prefill[5] = red_init
    red_prefill[6] = c1_val
    for i in range(1, 32):
        red_prefill[6 + i] = rnd()
    red_row = b.add_row(Gate("ReducingGate", (32,)), prefill=red_prefill)
    b.connect((red_row, 6), (const_row, 1))

    # ReducingExtensionGate (30 ext coeffs)
    re_prefill: Dict[int, int] = {}
    for k in range(2, 6):
        re_prefill[k] = rnd()
    for i in range(30):
        re_prefill[6 + 2 * i] = rnd()
        re_prefill[6 + 2 * i + 1] = rnd()
    b.add_row(Gate("ReducingExtensionGate", (30,)), prefill=re_prefill)

    # PoseidonMdsGate: 12 ext inputs -> 12 ext MDS outputs
    pm_prefill = {i: rnd() for i in range(24)}
    b.add_row(Gate("PoseidonMdsGate", (12,)), prefill=pm_prefill)

    # PoseidonGate: hash 12 random inputs, no merkle swap
    ps_prefill = {i: rnd() for i in range(12)}
    ps_prefill[24] = 0
    b.add_row(Gate("PoseidonGate", (12,)), prefill=ps_prefill)

    # CosetInterpolationGate (subgroup_bits=4, degree=6): genuinely
    # interpolate p over the coset shift*H and evaluate at eval_loc.
    sub_bits, ci_degree = 4, 6
    weights = barycentric_weights(sub_bits)
    ci_gate = Gate("CosetInterpolationGate", (sub_bits, ci_degree, weights))
    shift = gf.MULT_GEN
    p_coeffs = [rnd() for _ in range(1 << sub_bits)]
    pts = gf.enumerate_subgroup(sub_bits)
    ci_prefill: Dict[int, int] = {0: shift}
    for k, x in enumerate(pts):
        v = 0
        sx = gf.fmul(shift, x)
        for c in reversed(p_coeffs):
            v = (v * sx + c) % gf.P
        ci_prefill[1 + 2 * k] = v
        ci_prefill[1 + 2 * k + 1] = 0
    shifted_loc = rnd_ext()
    n_points = 1 << sub_bits
    n_intermediates = (n_points - 2) // (ci_degree - 1)
    sl_base = 1 + 2 * (n_points + 2) + 4 * n_intermediates
    ci_prefill[sl_base] = shifted_loc[0]
    ci_prefill[sl_base + 1] = shifted_loc[1]
    ci_row = b.add_row(ci_gate, prefill=ci_prefill)

    # PublicInputGate + optional lookup use
    b.add_row(Gate("PublicInputGate"))

    if target_degree_bits:
        def _fill_row(i: int) -> None:
            fam = i % 7
            if fam == 0:
                pf = {}
                for op in range(20):
                    pf[4 * op], pf[4 * op + 1], pf[4 * op + 2] = rnd(), rnd(), rnd()
                b.add_row(Gate("ArithmeticGate", (20,)), constants=(3, 4), prefill=pf)
            elif fam == 1:
                pf = {}
                for op in range(13):
                    for k2 in range(4):
                        pf[6 * op + k2] = rnd()
                b.add_row(Gate("MulExtensionGate", (13,)), constants=(rnd(), 0), prefill=pf)
            elif fam == 2:
                pf = {}
                for op in range(10):
                    for k2 in range(6):
                        pf[8 * op + k2] = rnd()
                b.add_row(
                    Gate("ArithmeticExtensionGate", (10,)), constants=(rnd(), rnd()), prefill=pf
                )
            elif fam == 3:
                v = rng.randrange(1 << 63)
                b.add_row(Gate("BaseSumGate", (63, 2)), prefill={1 + j: (v >> j) & 1 for j in range(63)})
            elif fam == 4:
                b.add_row(Gate("PoseidonMdsGate", (12,)), prefill={j: rnd() for j in range(24)})
            elif fam == 5:
                pf = {j: rnd() for j in range(12)}
                pf[24] = 0
                b.add_row(Gate("PoseidonGate", (12,)), prefill=pf)
            else:
                pf = {k2: rnd() for k2 in range(2, 6)}
                for j in range(30):
                    pf[6 + 2 * j], pf[6 + 2 * j + 1] = rnd(), rnd()
                b.add_row(Gate("ReducingExtensionGate", (30,)), prefill=pf)

        i = 0
        # leave headroom for the lookup block (<= 8 rows) so padding lands
        # exactly at 2^target_degree_bits
        while len(b._rows) < (1 << target_degree_bits) - 8:
            _fill_row(i)
            i += 1

    if with_lookup:
        table = [(i, (i * i + 3) % gf.P) for i in range(16)]
        lut = b.add_lookup_table(table)
        b.add_lookup(lut, 9)
        b.add_lookup(lut, 4)

    b.set_public_inputs([c0_val, c1_val, bs_val % gf.P])
    fx = b.build(name="gate_zoo")
    # stash semantic expectations for the tests
    fx_meta = {
        "ci_row": ci_row,
        "ci_coeffs": p_coeffs,
        "ci_shift": shift,
        "ci_shifted_loc": shifted_loc,
        "ci_sl_base": sl_base,
        "ra_row": ra_row,
        "ra_vecs": ra_vecs,
        "ra_idxs": ra_idxs,
        "ra_width": width,
        "exp_row": exp_row,
        "exp_base": c0_val,
        "exp_e": exp_e,
        "bs_val": bs_val,
        "arith_row": arith_row,
    }
    fx.meta = fx_meta  # type: ignore[attr-defined]
    return fx
