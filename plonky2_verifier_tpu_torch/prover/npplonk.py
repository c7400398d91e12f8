"""Vectorized Plonk constraint evaluation over a whole LDE domain (prover).

Same canonical constraint-vector assembly as golden.plonk (selector products
Gate/Selector.hs:78-89, vanishing order Plonk/Vanishing.hs:60-111, lookups
Plonk/Lookups.hs:45-132), but every value is a numpy (re, im) array over all
2^lde_bits evaluation points at once. The gate programs are the *same*
StraightLine objects the golden verifier and the TPU compiler consume
(gates.py) — this is just their third backend, running on npf arrays.

The prover uses this to build the quotient polynomial: evaluate the combined
constraint C_alpha(x) on the LDE coset, divide by Z_H(x) = x^n - 1, and
interpolate (prove.py step 4).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..gates import EvaluationVars, gate_program, run_straight_line
from ..golden import field as gf
from ..golden.plonk import UNUSED_SELECTOR, get_selector_config, split_constant_columns
from ..types import CommonCircuitData
from . import npf
from .npf import FExtArr


class NpExtAlgebra:
    """numpy (re, im) extension-array backend for gate programs."""

    add = staticmethod(npf.eadd)
    sub = staticmethod(npf.esub)
    mul = staticmethod(npf.emul)

    @staticmethod
    def lit(c: int) -> FExtArr:
        return (np.uint64(c % gf.P), np.uint64(0))

    @staticmethod
    def img(a: FExtArr) -> FExtArr:
        # (r + i X) * X = 7 i + r X
        return (npf.mul(a[1], npf.W), a[0])

    @staticmethod
    def from_base(v) -> FExtArr:
        if isinstance(v, tuple) and len(v) == 2 and not isinstance(v[0], np.ndarray):
            return (npf.arr(v[0]), npf.arr(v[1]))
        if isinstance(v, tuple):
            return v
        return (npf.arr(v), np.uint64(0))


def _from_base_int(v: int) -> FExtArr:
    return (np.uint64(v % gf.P), np.uint64(0))


def eval_gate_selectors_np(selectors_info, selector_openings: Sequence[FExtArr]) -> List[FExtArr]:
    """Vectorized closed-form selector values (Gate/Selector.hs:78-89)."""
    out = []
    multi = len(selectors_info.groups) > 1
    for gate_idx, group_idx in enumerate(selectors_info.selector_indices):
        x = selector_openings[group_idx]
        rng = selectors_info.groups[group_idx]
        if multi:
            value = npf.esub(_from_base_int(UNUSED_SELECTOR), x)
        else:
            value = _from_base_int(1)
        for j in range(rng.start, rng.end):
            if j != gate_idx:
                value = npf.emul(value, npf.esub(_from_base_int(j), x))
        out.append(value)
    return out


def eval_lagrange_0_np(n: int, zeta: FExtArr) -> FExtArr:
    """L_0(zeta) = (zeta^n - 1)/(n (zeta - 1)), vectorized; callers must
    guarantee zeta is never in H (LDE points live on the shifted coset)."""
    one = _from_base_int(1)
    num = npf.esub(npf.epow_int(zeta, n), one)
    den = npf.escale(np.uint64(n % gf.P), npf.esub(zeta, one))
    return npf.ediv(num, den)


def _chunks(xs, k):
    return [xs[i : i + k] for i in range(0, len(xs), k)]


def eval_all_plonk_constraints_np(
    common: CommonCircuitData, openings, challenges
) -> List[FExtArr]:
    """The canonical constraint vector, vectorized over evaluation points.

    `openings` carries lists of (re, im) arrays (one per column); `challenges`
    is a namespace with python-int betas/gammas/alphas/deltas, an array-valued
    zeta, and the public_inputs_hash. Mirrors golden.plonk
    .eval_all_plonk_constraints element-for-element."""
    selcfg = get_selector_config(common)
    gate_sels, lkp_sels, gate_consts = split_constant_columns(selcfg, openings.constants)

    n = common.nrows
    maxdeg = common.quotient_degree_factor
    zeta = challenges.zeta
    one = _from_base_int(1)

    # (1) L0(zeta) (z - 1) per challenge round
    lag0 = eval_lagrange_0_np(n, zeta)
    zs1 = [npf.emul(lag0, npf.esub(z, one)) for z in openings.plonk_zs]

    # (2) partial-product transition checks
    pp_chunks = _chunks(openings.partial_products, common.num_partial_products)
    pp_checks: List[FExtArr] = []
    for z, z_next, beta, gamma, pp_chunk in zip(
        openings.plonk_zs, openings.plonk_zs_next, challenges.betas, challenges.gammas, pp_chunks
    ):
        gamma_e = _from_base_int(gamma)
        numers = [
            npf.eadd(w, npf.eadd(npf.escale(np.uint64(gf.fmul(beta, k)), zeta), gamma_e))
            for k, w in zip(common.k_is, openings.wires)
        ]
        denoms = [
            npf.eadd(w, npf.eadd(npf.escale(np.uint64(beta), sigma), gamma_e))
            for sigma, w in zip(openings.plonk_sigmas, openings.wires)
        ]
        current = [z] + list(pp_chunk) + [z_next]
        for (prev, nxt), num_chunk, den_chunk in zip(
            zip(current, current[1:]), _chunks(numers, maxdeg), _chunks(denoms, maxdeg)
        ):
            num_prod = one
            for t in num_chunk:
                num_prod = npf.emul(num_prod, t)
            den_prod = one
            for t in den_chunk:
                den_prod = npf.emul(den_prod, t)
            pp_checks.append(npf.esub(npf.emul(prev, num_prod), npf.emul(nxt, den_prod)))

    # (3) lookup checks
    lookup_checks: List[FExtArr] = []
    if common.luts:
        lookup_checks = eval_lookup_equations_np(common, lkp_sels, openings, challenges)

    # (4) gate constraints, filtered by selectors, combined vertically
    ev = EvaluationVars(
        selectors=gate_sels,
        lkp_selectors=lkp_sels,
        constants=gate_consts,
        wires=openings.wires,
        public_inputs_hash=list(challenges.public_inputs_hash),
    )
    sel_values = eval_gate_selectors_np(common.selectors_info, gate_sels)
    combined: List[FExtArr] = []
    for gate, sel in zip(common.gates, sel_values):
        cons = run_straight_line(gate_program(gate), ev, NpExtAlgebra)
        for i, cval in enumerate(cons):
            filtered = npf.emul(sel, cval)
            if i < len(combined):
                combined[i] = npf.eadd(combined[i], filtered)
            else:
                combined.append(filtered)

    return zs1 + pp_checks + lookup_checks + combined


def eval_lookup_equations_np(
    common: CommonCircuitData, lkp_sels: Sequence[FExtArr], openings, challenges
) -> List[FExtArr]:
    """Vectorized log-derivative lookup checks (Plonk/Lookups.hs:45-132)."""
    from ..golden.plonk import INIT_SRE, LAST_LDC, TRANS_LDC, TRANS_SRE

    cfg = common.config
    num_lu_slots = cfg.num_routed_wires // 2
    num_lut_slots = cfg.num_routed_wires // 3
    num_sldc = common.num_lookup_polys - 1
    lu_degree = common.quotient_degree_factor - 1
    lut_degree = -(-num_lut_slots // num_sldc)
    one = _from_base_int(1)
    zero = _from_base_int(0)

    def selector(i: int) -> FExtArr:
        return lkp_sels[i]

    round_cols = _chunks(
        list(zip(openings.lookup_zs, openings.lookup_zs_next)), common.num_lookup_polys
    )

    final: List[FExtArr] = []
    for delta, columns in zip(challenges.deltas, round_cols):
        (re, re_next), *sldc_pairs = columns
        sldc = [p[0] for p in sldc_pairs]
        sldc_next = [p[1] for p in sldc_pairs]

        wire_pairs = _chunks(openings.wires, 2)[:num_lu_slots]
        wire_triples = _chunks(openings.wires, 3)[:num_lut_slots]
        lu_combos = [npf.eadd(inp, npf.escale(np.uint64(delta.a), out)) for inp, out in wire_pairs]
        lut_combos_a = [npf.eadd(t[0], npf.escale(np.uint64(delta.a), t[1])) for t in wire_triples]
        lut_combos_b = [npf.eadd(t[0], npf.escale(np.uint64(delta.b), t[1])) for t in wire_triples]
        mults = [t[2] for t in wire_triples]

        chunks_lu = _chunks(lu_combos, lu_degree)
        chunks_lut = _chunks(lut_combos_a, lut_degree)
        chunks_mults = _chunks(mults, lut_degree)

        eq_last_sldc = npf.emul(selector(LAST_LDC), sldc[-1])
        eq_ini_sum = npf.emul(selector(INIT_SRE), sldc[0])
        eq_ini_re = npf.emul(selector(INIT_SRE), re)

        # final RE per LUT: the padded table polynomial at delta (scalar)
        eq_finals_re = []
        for k, table in enumerate(common.luts):
            lut_nrows = -(-len(table) // num_lut_slots)
            padded = list(table) + [table[0]] * (lut_nrows * num_lut_slots - len(table))
            cur = 0
            for inp, out in padded:
                cur = (delta.delta * cur + inp + delta.b * out) % gf.P
            eq_finals_re.append(npf.emul(selector(4 + k), npf.esub(re, _from_base_int(cur))))

        # RE transition
        cur_sum = re_next
        for combo in lut_combos_b:
            cur_sum = npf.eadd(npf.escale(np.uint64(delta.delta), cur_sum), combo)
        eq_re_trans = npf.emul(selector(TRANS_SRE), npf.esub(re, cur_sum))

        # SLDC transitions with leave-one-out products
        prev_this = list(zip([sldc_next[-1]] + sldc, sldc))
        alpha_ext = _from_base_int(delta.alpha)
        eqs_sldc: List[FExtArr] = []
        for (prev, this), lu_chunk, lut_chunk, mult_chunk in zip(
            prev_this, chunks_lu, chunks_lut, chunks_mults
        ):
            lu_terms = [npf.esub(alpha_ext, c) for c in lu_chunk]
            lut_terms = [npf.esub(alpha_ext, c) for c in lut_chunk]

            def prod(terms):
                acc = one
                for t in terms:
                    acc = npf.emul(acc, t)
                return acc

            lu_prod = prod(lu_terms)
            lut_prod = prod(lut_terms)
            lu_sum = zero
            for i in range(len(lu_terms)):
                lu_sum = npf.eadd(lu_sum, prod(lu_terms[:i] + lu_terms[i + 1 :]))
            lut_sum = zero
            for i in range(len(lut_terms)):
                lut_sum = npf.eadd(
                    lut_sum, npf.emul(mult_chunk[i], prod(lut_terms[:i] + lut_terms[i + 1 :]))
                )

            eq_sum_trans = npf.emul(
                selector(TRANS_SRE), npf.esub(npf.emul(lut_prod, npf.esub(this, prev)), lut_sum)
            )
            eq_ldc_trans = npf.emul(
                selector(TRANS_LDC), npf.eadd(npf.emul(lu_prod, npf.esub(this, prev)), lu_sum)
            )
            eqs_sldc.extend([eq_sum_trans, eq_ldc_trans])

        final.extend([eq_last_sldc, eq_ini_sum, eq_ini_re] + eq_finals_re + [eq_re_trans] + eqs_sldc)

    return final


def combine_with_powers_of_alpha_np(alpha: int, xs: Sequence[FExtArr]) -> FExtArr:
    """sum alpha^k x_k with a base-field alpha (Plonk/Vanishing.hs:52-56)."""
    acc: FExtArr = _from_base_int(0)
    a = np.uint64(alpha)
    for x in reversed(xs):
        acc = npf.eadd(x, npf.escale(a, acc))
    return acc
