"""Plonk constraint checks at zeta — golden model.

Covers selector evaluation (Gate/Selector.hs:23-95), the canonical
constraint-vector assembly (Plonk/Vanishing.hs:60-111), the lookup argument
(Plonk/Lookups.hs:45-132), and the combined quotient equation
(Plonk/Verifier.hs:31-52).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..gates import EvaluationVars, GoldenExtAlgebra, gate_program, run_straight_line
from ..types import CommonCircuitData, OpeningSet
from .challenges import LookupDelta, ProofChallenges
from . import field as gf
from .field import (
    EXT_ONE,
    EXT_ZERO,
    FExt,
    combine_with_powers_of_alpha,
    eadd,
    ediv,
    emul,
    epow,
    escale,
    esub,
    from_base,
)

UNUSED_SELECTOR = (1 << 32) - 1

# lookup selector roles (Plonk/Lookups.hs:27-41)
TRANS_SRE, TRANS_LDC, INIT_SRE, LAST_LDC = 0, 1, 2, 3


@dataclass
class SelectorConfig:
    num_gate_selectors: int
    num_lookup_selectors: int
    num_gate_constants: int
    num_sigma_columns: int


def get_selector_config(common: CommonCircuitData) -> SelectorConfig:
    nluts = common.num_luts
    expected_lookup_sels = 0 if nluts == 0 else 4 + nluts
    if common.num_lookup_selectors != expected_lookup_sels:
        raise ValueError("num_lookup_selectors != 4 + #luts")
    num_gate_selectors = len(common.selectors_info.groups)
    if common.num_constants != num_gate_selectors + common.num_lookup_selectors + common.config.num_constants:
        raise ValueError("constant column tally does not add up")
    return SelectorConfig(
        num_gate_selectors=num_gate_selectors,
        num_lookup_selectors=common.num_lookup_selectors,
        num_gate_constants=common.config.num_constants,
        num_sigma_columns=common.config.num_routed_wires,
    )


def split_constant_columns(cfg: SelectorConfig, xs: Sequence):
    a = cfg.num_gate_selectors
    b = a + cfg.num_lookup_selectors
    c = b + cfg.num_gate_constants
    if len(xs) != c:
        raise ValueError("wrong number of constant-column openings")
    return list(xs[:a]), list(xs[a:b]), list(xs[b:c])


def eval_gate_selector(selectors_info, x: FExt, gate_idx: int) -> FExt:
    """Closed-form selector value for gate `gate_idx` given the opening `x`
    of its group's selector column (Gate/Selector.hs:78-89)."""
    group_idx = selectors_info.selector_indices[gate_idx]
    rng = selectors_info.groups[group_idx]
    if len(selectors_info.groups) > 1:
        value = esub(from_base(UNUSED_SELECTOR), x)
    else:
        value = EXT_ONE
    for j in range(rng.start, rng.end):
        if j != gate_idx:
            value = emul(value, esub(from_base(j), x))
    return value


def eval_gate_selectors(selectors_info, selector_openings: Sequence[FExt]) -> List[FExt]:
    return [
        eval_gate_selector(selectors_info, selector_openings[grp], i)
        for i, grp in enumerate(selectors_info.selector_indices)
    ]


def eval_lagrange_0(n: int, zeta: FExt) -> FExt:
    """L_0(zeta) = (zeta^n - 1)/(n (zeta - 1)) (Algebra/Poly.hs:14-17)."""
    if zeta == EXT_ONE:
        return EXT_ONE
    num = esub(epow(zeta, n), EXT_ONE)
    den = escale(n % gf.P, esub(zeta, EXT_ONE))
    return ediv(num, den)


def _chunks(xs, k):
    return [xs[i : i + k] for i in range(0, len(xs), k)]


def eval_all_plonk_constraints(
    common: CommonCircuitData, openings: OpeningSet, challenges: ProofChallenges
) -> List[FExt]:
    """The canonical constraint vector: [L0(z-1) per round] ++ pp transition
    checks ++ lookup checks ++ vertically-combined gate constraints
    (Plonk/Vanishing.hs:60-111)."""
    selcfg = get_selector_config(common)
    gate_sels, lkp_sels, gate_consts = split_constant_columns(selcfg, openings.constants)

    n = common.nrows
    maxdeg = common.quotient_degree_factor
    zeta = challenges.zeta

    # (1) L0(zeta) (z - 1) per challenge round
    lag0 = eval_lagrange_0(n, zeta)
    zs1 = [emul(lag0, esub(z, EXT_ONE)) for z in openings.plonk_zs]

    # (2) partial-product transition checks
    pp_chunks = _chunks(openings.partial_products, common.num_partial_products)
    pp_checks: List[FExt] = []
    for z, z_next, beta, gamma, pp_chunk in zip(
        openings.plonk_zs, openings.plonk_zs_next, challenges.betas, challenges.gammas, pp_chunks
    ):
        numers = [
            eadd(w, eadd(escale(gf.fmul(beta, k), zeta), from_base(gamma)))
            for k, w in zip(common.k_is, openings.wires)
        ]
        denoms = [
            eadd(w, eadd(escale(beta, sigma), from_base(gamma)))
            for sigma, w in zip(openings.plonk_sigmas, openings.wires)
        ]
        current = [z] + list(pp_chunk) + [z_next]
        for (prev, nxt), num_chunk, den_chunk in zip(
            zip(current, current[1:]), _chunks(numers, maxdeg), _chunks(denoms, maxdeg)
        ):
            num_prod = EXT_ONE
            for t in num_chunk:
                num_prod = emul(num_prod, t)
            den_prod = EXT_ONE
            for t in den_chunk:
                den_prod = emul(den_prod, t)
            pp_checks.append(esub(emul(prev, num_prod), emul(nxt, den_prod)))

    # (3) lookup checks
    lookup_checks: List[FExt] = []
    if common.luts:
        lookup_checks = eval_lookup_equations(common, lkp_sels, openings, challenges)

    # (4) gate constraints, filtered by selectors, combined vertically
    ev = EvaluationVars(
        selectors=gate_sels,
        lkp_selectors=lkp_sels,
        constants=gate_consts,
        wires=openings.wires,
        public_inputs_hash=list(challenges.public_inputs_hash),
    )
    sel_values = eval_gate_selectors(common.selectors_info, gate_sels)
    combined: List[FExt] = []
    for gate, sel in zip(common.gates, sel_values):
        cons = run_straight_line(gate_program(gate), ev, GoldenExtAlgebra)
        for i, cval in enumerate(cons):
            filtered = emul(sel, cval)
            if i < len(combined):
                combined[i] = eadd(combined[i], filtered)
            else:
                combined.append(filtered)

    return zs1 + pp_checks + lookup_checks + combined


def pad_lut(table, total_slots: int):
    """Pad a LUT to full rows with its FIRST entry, multiplicity 0 —
    upstream fix 091047f (Plonk/Lookups.hs:99-109). Zero-padding instead
    changes the final-RE table polynomial and rejects honest proofs
    (docs/traps.md row 8; mutation-tested in tests/test_traps.py)."""
    return list(table) + [table[0]] * (total_slots - len(table))


def eval_lookup_equations(
    common: CommonCircuitData, lkp_sels: Sequence[FExt], openings: OpeningSet, challenges: ProofChallenges
) -> List[FExt]:
    """Log-derivative lookup argument checks (Plonk/Lookups.hs:45-132)."""
    cfg = common.config
    nluts = common.num_luts
    num_lu_slots = cfg.num_routed_wires // 2
    num_lut_slots = cfg.num_routed_wires // 3
    num_sldc = common.num_lookup_polys - 1
    lu_degree = common.quotient_degree_factor - 1
    lut_degree = -(-num_lut_slots // num_sldc)  # ceil

    def selector(i: int) -> FExt:
        return lkp_sels[i]

    round_cols = _chunks(list(zip(openings.lookup_zs, openings.lookup_zs_next)), common.num_lookup_polys)

    final: List[FExt] = []
    for delta, columns in zip(challenges.deltas, round_cols):
        (re, re_next), *sldc_pairs = columns
        sldc = [p[0] for p in sldc_pairs]
        sldc_next = [p[1] for p in sldc_pairs]

        wire_pairs = _chunks(openings.wires, 2)[:num_lu_slots]
        wire_triples = _chunks(openings.wires, 3)[:num_lut_slots]
        lu_combos = [eadd(inp, escale(delta.a, out)) for inp, out in wire_pairs]
        lut_combos_a = [eadd(t[0], escale(delta.a, t[1])) for t in wire_triples]
        lut_combos_b = [eadd(t[0], escale(delta.b, t[1])) for t in wire_triples]
        mults = [t[2] for t in wire_triples]

        chunks_lu = _chunks(lu_combos, lu_degree)
        chunks_lut = _chunks(lut_combos_a, lut_degree)
        chunks_mults = _chunks(mults, lut_degree)

        eq_last_sldc = emul(selector(LAST_LDC), sldc[-1])
        eq_ini_sum = emul(selector(INIT_SRE), sldc[0])
        eq_ini_re = emul(selector(INIT_SRE), re)

        # final RE per LUT: evaluate the padded table polynomial at delta
        eq_finals_re = []
        for k, table in enumerate(common.luts):
            lut_nrows = -(-len(table) // num_lut_slots)
            padded = pad_lut(table, lut_nrows * num_lut_slots)
            cur = 0
            for inp, out in padded:
                cur = (delta.delta * cur + inp + delta.b * out) % gf.P
            eq_finals_re.append(emul(selector(4 + k), esub(re, from_base(cur))))

        # RE transition
        cur_sum = re_next
        for combo in lut_combos_b:
            cur_sum = eadd(escale(delta.delta, cur_sum), combo)
        eq_re_trans = emul(selector(TRANS_SRE), esub(re, cur_sum))

        # SLDC transitions with leave-one-out products
        prev_this = list(zip([sldc_next[-1]] + sldc, sldc))
        alpha_ext = from_base(delta.alpha)
        eqs_sldc: List[FExt] = []
        for (prev, this), lu_chunk, lut_chunk, mult_chunk in zip(
            prev_this, chunks_lu, chunks_lut, chunks_mults
        ):
            lu_terms = [esub(alpha_ext, c) for c in lu_chunk]
            lut_terms = [esub(alpha_ext, c) for c in lut_chunk]

            def prod(terms):
                acc = EXT_ONE
                for t in terms:
                    acc = emul(acc, t)
                return acc

            lu_prod = prod(lu_terms)
            lut_prod = prod(lut_terms)
            lu_sum = EXT_ZERO
            for i in range(len(lu_terms)):
                lu_sum = eadd(lu_sum, prod(lu_terms[:i] + lu_terms[i + 1 :]))
            lut_sum = EXT_ZERO
            for i in range(len(lut_terms)):
                lut_sum = eadd(lut_sum, emul(mult_chunk[i], prod(lut_terms[:i] + lut_terms[i + 1 :])))

            eq_sum_trans = emul(selector(TRANS_SRE), esub(emul(lut_prod, esub(this, prev)), lut_sum))
            eq_ldc_trans = emul(selector(TRANS_LDC), eadd(emul(lu_prod, esub(this, prev)), lu_sum))
            eqs_sldc.extend([eq_sum_trans, eq_ldc_trans])

        final.extend([eq_last_sldc, eq_ini_sum, eq_ini_re] + eq_finals_re + [eq_re_trans] + eqs_sldc)

    return final


def check_combined_plonk_equations(
    common: CommonCircuitData, proof_with_pis, challenges: ProofChallenges
) -> List[bool]:
    """Per challenge round: Q(zeta) (zeta^n - 1) == C_alpha(zeta)
    (Plonk/Verifier.hs:31-52)."""
    openings = proof_with_pis.proof.openings
    n = common.nrows
    zeta = challenges.zeta
    zeta_n = epow(zeta, n)

    constraints = eval_all_plonk_constraints(common, openings, challenges)
    combined = [combine_with_powers_of_alpha(a, constraints) for a in challenges.alphas]

    quotient_chunks = _chunks(openings.quotient_polys, common.quotient_degree_factor)
    zn1 = esub(zeta_n, EXT_ONE)
    oks = []
    for chunk, c in zip(quotient_chunks, combined):
        q = EXT_ZERO
        for x in reversed(chunk):
            q = eadd(x, emul(zeta_n, q))
        oks.append(emul(q, zn1) == c)
    return oks
