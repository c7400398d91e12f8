"""The check of the constraint equations at zeta: plonky2/src/plonk/verifier.rs
`verify_with_challenges` up to FRI, with vanishing_poly.rs's
`eval_vanishing_poly` (the L_0(x)(Z(x) - 1) terms, the partial products'
terms, the lookup terms, the gates' terms, then each challenge's alpha
combination), `check_partial_products` (plonk/vanishing_poly.rs), the
lookup argument's `check_lookup_constraints` and `get_lut_poly`, and the
gates' filters of gates/gate.rs (`eval_filtered`, `compute_filter`)."""

from __future__ import annotations

from .field import ONE, ZERO, Ext, product

UNUSED_SELECTOR = 2**32 - 1  # u32::MAX as usize
# LookupSelectors and LookupChallenges (gates/lookup_table.rs, plonk/vanishing_poly.rs)
TRANS_SRE, TRANS_LDC, INIT_SRE, LAST_LDC, START_END = 0, 1, 2, 3, 4
CHALLENGE_A, CHALLENGE_B, CHALLENGE_ALPHA, CHALLENGE_DELTA = 0, 1, 2, 3


def eval_l_0(n: int, x: Ext) -> Ext:
    if x == ONE:
        return ONE
    return (x ** n - ONE) / ((x - ONE) * n)


def gate_constraints(cd, constants, wires, pi_hash) -> list:
    out = [ZERO] * cd.num_gate_constraints
    prefix = cd.num_selectors + cd.num_lookup_selectors
    for row, gate in enumerate(cd.gates):
        s_index = cd.selector_indices[row]
        lo, hi = cd.groups[s_index]
        s = constants[s_index]
        terms = [Ext(i) - s for i in range(lo, hi) if i != row]
        if cd.num_selectors > 1:  # rows of no gate of the group hold UNUSED_SELECTOR
            terms.append(Ext(UNUSED_SELECTOR) - s)
        flt = product(terms)
        for i, c in enumerate(gate.constraints(wires, constants[prefix:], pi_hash)):
            out[i] = out[i] + flt * c
    return out


def check_partial_products(numerators, denominators, partials, z_x, z_gx, max_degree) -> list:
    accs = [z_x] + list(partials) + [z_gx]
    out = []
    for k, lo in enumerate(range(0, len(numerators), max_degree)):
        num = product(numerators[lo:lo + max_degree])
        den = product(denominators[lo:lo + max_degree])
        out.append(accs[k] * num - accs[k + 1] * den)
    assert len(out) == len(accs) - 1
    return out


def lut_poly_eval(lut, b: int, degree: int, x: int) -> Ext:
    """get_lut_poly(...).eval(x): the coefficients (input + b output) of the
    table's rows, padded to `degree` with the first row's (the rows that
    fill the last LookupTableGate hold the first entry), reversed: the first
    entry takes the highest power."""
    combos = [(i + b * o) for i, o in lut]
    acc = Ext(0)
    for co in combos + [combos[0]] * (degree - len(combos)):
        acc = acc * x + co
    return acc


def check_lookup_constraints(cd, wires, local_zs, next_zs, selectors, deltas) -> list:
    num_lu_slots = cd.num_routed_wires // 2  # LookupGate::num_slots
    num_lut_slots = cd.num_routed_wires // 3  # LookupTableGate::num_slots
    lu_degree = cd.quotient_degree_factor - 1
    n_sldc = len(local_zs) - 1
    lut_degree = -(-num_lut_slots // n_sldc)
    z_re, next_z_re = local_zs[0], next_zs[0]
    z_x, z_gx = local_zs[1:n_sldc + 1], next_zs[1:n_sldc + 1]
    a, b = deltas[CHALLENGE_A], deltas[CHALLENGE_B]
    alpha, delta = Ext(deltas[CHALLENGE_ALPHA]), deltas[CHALLENGE_DELTA]
    looked = [wires[3 * s] + wires[3 * s + 1] * a for s in range(num_lut_slots)]
    looking = [wires[2 * s] + wires[2 * s + 1] * a for s in range(num_lu_slots)]
    lookup = [wires[3 * s] + wires[3 * s + 1] * b for s in range(num_lut_slots)]
    mults = [wires[3 * s + 2] for s in range(num_lut_slots)]

    # the last SLDC sum is 0; the first sum and RE start at 0
    out = [selectors[LAST_LDC] * z_x[n_sldc - 1], selectors[INIT_SRE] * z_x[0], selectors[INIT_SRE] * z_re]
    for r in range(START_END, cd.num_lookup_selectors):
        lut = cd.luts[r - START_END]
        rows = -(-len(lut) // num_lut_slots)
        out.append(selectors[r] * (z_re - lut_poly_eval(lut, b, num_lut_slots * rows, delta)))
    acc = next_z_re
    for elt in range(num_lut_slots):
        acc = acc * delta + lookup[elt]
    out.append(selectors[TRANS_SRE] * (z_re - acc))

    for poly in range(n_sldc):
        lut_range = range(poly * lut_degree, min((poly + 1) * lut_degree, num_lut_slots))
        lu_range = range(poly * lu_degree, min((poly + 1) * lu_degree, num_lu_slots))
        lut_prod = product(alpha - looked[i] for i in lut_range)
        lu_prod = product(alpha - looking[i] for i in lu_range)
        lut_sum = sum((mults[i] * product(alpha - looked[j] for j in lut_range if j != i) for i in lut_range), ZERO)
        lu_sum = sum((product(alpha - looking[j] for j in lu_range if j != i) for i in lu_range), ZERO)
        prev = z_gx[n_sldc - 1] if poly == 0 else z_x[poly - 1]
        out.append(selectors[TRANS_SRE] * (lut_prod * (z_x[poly] - prev) - lut_sum))
        out.append(selectors[TRANS_LDC] * (lu_prod * (z_x[poly] - prev) + lu_sum))
    return out


def reduce_with_powers(terms, x) -> Ext:
    acc = ZERO
    for t in reversed(terms):
        acc = acc * x + t
    return acc


def check_constraint_equations(proof, ch) -> list:
    """One verdict a challenge: vanishing(zeta) == Z_H(zeta) * t(zeta)."""
    cd = proof.common
    o = proof.opening
    zeta = ch.zeta
    constants, wires = o("constants"), o("wires")
    zs, zs_next, sigmas, pps = o("plonk_zs"), o("plonk_zs_next"), o("plonk_sigmas"), o("partial_products")
    lzs, lzs_next = o("lookup_zs"), o("lookup_zs_next")
    lookup_selectors = constants[cd.num_selectors:cd.num_selectors + cd.num_lookup_selectors]
    n_prods, n_lk = cd.num_partial_products, cd.num_lookup_polys

    l0 = eval_l_0(1 << cd.degree_bits, zeta)
    z1_terms, pp_terms, lookup_terms = [], [], []
    for i in range(cd.num_challenges):
        z1_terms.append(l0 * (zs[i] - ONE))
        if n_lk:
            lookup_terms += check_lookup_constraints(cd, wires, lzs[n_lk * i:n_lk * (i + 1)], lzs_next[n_lk * i:n_lk * (i + 1)],
                                                     lookup_selectors, ch.deltas[4 * i:4 * (i + 1)])
        beta, gamma = ch.betas[i], ch.gammas[i]
        nums = [wires[j] + zeta * cd.k_is[j] * beta + gamma for j in range(cd.num_routed_wires)]
        dens = [wires[j] + sigmas[j] * beta + gamma for j in range(cd.num_routed_wires)]
        pp_terms += check_partial_products(nums, dens, pps[i * n_prods:(i + 1) * n_prods], zs[i], zs_next[i],
                                           cd.quotient_degree_factor)
    terms = z1_terms + pp_terms + lookup_terms + gate_constraints(cd, constants, wires, ch.public_inputs_hash)
    vanishing = [reduce_with_powers(terms, Ext(alpha)) for alpha in ch.alphas]

    zeta_n = zeta ** (1 << cd.degree_bits)
    z_h = zeta_n - ONE
    q = o("quotient_polys")
    f = cd.quotient_degree_factor
    return [vanishing[i] == z_h * reduce_with_powers(q[f * i:f * (i + 1)], zeta_n) for i in range(cd.num_challenges)]
