"""FRI batch-opening verification — golden model.

Semantics per reference spec Plonk/FRI.hs:
- 4-oracle initial tree checks (:105-117) with expected widths (:56-65),
- combineInitial with its *reordered* batch (constants ++ wires ++ pp ++
  quotient ++ lookup — note this differs from the transcript order!) and the
  alpha^{len(second batch)} swap (:151-207),
- proof-of-work mask check (:212-216),
- coset folding: bit-reversed indexing, O(arity^2) inverse DFT on the coset,
  beta-Horner combine (:222-327),
- reduction-strategy expansion (:337-354) and the top-level query-round loop
  (:358-408).

Unlike the reference (which aborts with `error` on malformed steps), every
check returns False cleanly so fault-injection tests can assert rejection.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..types import CommonCircuitData, Proof, VerifierOnlyCircuitData
from .challenges import ProofChallenges, fri_opening_batches
from . import field as gf
from .field import (
    EXT_ZERO,
    FExt,
    eadd,
    ediv,
    emul,
    epow,
    escale,
    esub,
    flatten_ext,
    from_base,
    reduce_with_powers,
    reverse_bits,
    reverse_index_bits,
)
from .hashing import check_merkle_proof


def oracle_widths(common: CommonCircuitData) -> Tuple[int, int, int, int]:
    """(constants, witness, pp_lookup, quotient) row widths (Plonk/FRI.hs:56-65)."""
    cfg = common.config
    r = cfg.num_challenges
    return (
        common.num_constants + cfg.num_routed_wires,
        cfg.num_wires,
        r * (1 + common.num_partial_products + common.num_lookup_polys),
        r * common.quotient_degree_factor,
    )


def check_proof_of_work(fri_config, pow_response: int) -> bool:
    """Top pow_bits of the response must be zero (Plonk/FRI.hs:212-216)."""
    bits = fri_config.proof_of_work_bits
    mask = ((1 << bits) - 1) << (64 - bits) if bits else 0
    return (pow_response & mask) == 0


def combine_initial(
    common: CommonCircuitData,
    challenges: ProofChallenges,
    y0: FExt,
    y1: FExt,
    row_oracles: Sequence[Sequence[int]],
    query_idx: int,
) -> FExt:
    """Combined-quotient evaluation at x0 = g * eta^rev(idx) (Plonk/FRI.hs:151-207)."""
    cfg = common.config
    alpha = challenges.fri.alpha
    zeta = challenges.zeta

    constants, witness, pp_lookup, quotient = row_oracles
    r = cfg.num_challenges
    npp = -(-cfg.num_routed_wires // common.quotient_degree_factor)
    assert r * (npp + common.num_lookup_polys) == len(pp_lookup)
    oracle_pp = list(pp_lookup[: r * npp])
    oracle_lookup = list(pp_lookup[r * npp :])

    first_batch = list(constants) + list(witness) + oracle_pp + list(quotient) + oracle_lookup
    second_batch = oracle_pp[:r] + oracle_lookup

    g0 = reduce_with_powers(alpha, [from_base(x) for x in first_batch])
    g1 = reduce_with_powers(alpha, [from_base(x) for x in second_batch])

    logn_small = common.fri_params.degree_bits
    logn_lde = common.fri_params.lde_bits
    omega = gf.subgroup_generator(logn_small)
    eta = gf.subgroup_generator(logn_lde)

    rev_idx = reverse_bits(logn_lde, query_idx)
    point_x = from_base(gf.fmul(gf.MULT_GEN, gf.fpow(eta, rev_idx)))

    one = ediv(esub(g0, y0), esub(point_x, zeta))
    two = ediv(esub(g1, y1), esub(point_x, escale(omega, zeta)))
    return eadd(emul(epow(alpha, len(second_batch)), one), two)


def fold_coset(beta: FExt, arity_bits: int, coset_offset: int, values: Sequence[FExt]) -> FExt:
    """Inverse-DFT the coset then beta-Horner combine (Plonk/FRI.hs:263-279).
    `values` must already be in subgroup order (bit-reversal undone)."""
    arity = 1 << arity_bits
    omega = gf.subgroup_generator(arity_bits)
    inv_arity = gf.finv(arity % gf.P)
    ys = []
    for k in range(arity):
        acc = EXT_ZERO
        for j in range(arity):
            x_omega_j = gf.fmul(coset_offset, gf.fpow(omega, j))
            acc = eadd(acc, escale(gf.fpow(x_omega_j, -k), values[j]))
        ys.append(acc)
    return escale(inv_arity, reduce_with_powers(beta, ys))


def check_fri_proof(
    common: CommonCircuitData,
    vkey: VerifierOnlyCircuitData,
    proof: Proof,
    challenges: ProofChallenges,
) -> bool:
    fri_config = common.config.fri_config
    fri_proof = proof.opening_proof
    fri = challenges.fri

    if not check_proof_of_work(fri_config, fri.pow_response):
        return False

    # validate cap sizes (Plonk/FRI.hs:79-97)
    cap_len = 1 << fri_config.cap_height
    caps = [
        vkey.constants_sigmas_cap,
        proof.wires_cap,
        proof.plonk_zs_partial_products_cap,
        proof.quotient_polys_cap,
    ]
    if any(len(c) != cap_len for c in caps):
        return False

    widths = oracle_widths(common)

    # precomputed reduced openings (Plonk/FRI.hs:120-134)
    batch_this, batch_next = fri_opening_batches(proof.openings)
    y0 = reduce_with_powers(fri.alpha, batch_this)
    y1 = reduce_with_powers(fri.alpha, batch_next)

    logn_lde = common.fri_params.lde_bits
    step_arities = list(common.fri_params.reduction_arity_bits)

    if len(fri_proof.commit_phase_merkle_caps) != len(step_arities):
        return False

    for query_idx, round_proof in zip(fri.query_indices, fri_proof.query_round_proofs):
        # initial tree proofs (Plonk/FRI.hs:105-117)
        if len(round_proof.initial_trees_proof.evals_proofs) != 4:
            return False
        rows = []
        for cap, (leaf, mproof), width in zip(caps, round_proof.initial_trees_proof.evals_proofs, widths):
            if len(leaf) != width:
                return False
            if not check_merkle_proof(cap, query_idx, leaf, mproof.siblings):
                return False
            rows.append(leaf)

        eval_cur = combine_initial(common, challenges, y0, y1, rows, query_idx)

        # folding (Plonk/FRI.hs:301-323)
        shift = gf.MULT_GEN
        log_size = logn_lde
        idx = query_idx
        ok = True
        if len(round_proof.steps) != len(step_arities):
            return False
        for arity_bits, beta, cap, step in zip(
            step_arities, fri.betas, fri_proof.commit_phase_merkle_caps, round_proof.steps
        ):
            arity = 1 << arity_bits
            if len(step.evals) != arity:
                return False
            new_idx = idx >> arity_bits
            new_log_size = log_size - arity_bits
            if not check_merkle_proof(cap, new_idx, flatten_ext(step.evals), step.merkle_proof.siblings):
                return False
            if step.evals[idx % arity] != eval_cur:
                return False
            # recover coset offset: shift * eta^rev((idx>>a)<<a) over the
            # *current* level's subgroup (Plonk/FRI.hs:248-259)
            eta = gf.subgroup_generator(log_size)
            start = reverse_bits(log_size, (idx >> arity_bits) << arity_bits)
            offset = gf.fmul(shift, gf.fpow(eta, start))
            values = reverse_index_bits(list(step.evals))
            eval_cur = fold_coset(beta, arity_bits, offset, values)
            for _ in range(arity_bits):
                shift = gf.fmul(shift, shift)
            idx, log_size = new_idx, new_log_size
        if not ok:
            return False

        # final check: evaluate the final polynomial at the folded location
        x_final = from_base(gf.fmul(shift, gf.fpow(gf.subgroup_generator(log_size), reverse_bits(log_size, idx))))
        final_eval = EXT_ZERO
        pw = (1, 0)
        for coeff in fri_proof.final_poly:
            final_eval = eadd(final_eval, emul(coeff, pw))
            pw = emul(pw, x_final)
        if final_eval != eval_cur:
            return False

    return True
