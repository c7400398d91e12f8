"""The FRI opening proof's check: plonky2/src/fri/verifier.rs `verify_fri_proof`
(the proof of work, each query round's initial Merkle openings,
`fri_combine_initial`, each reduction step's coset check, interpolation and
Merkle opening, the final polynomial), with the batches of
plonk/circuit_data.rs `get_fri_instance` (at zeta: the constants and sigmas,
the wires, the Zs and partial products, the quotient chunks, the lookup Zs;
at g zeta: the Zs and the lookup Zs) and hash/merkle_proofs.rs
`verify_merkle_proof_to_cap` with the configuration's hasher (hashing.py),
whose digests it compares: words, or bytes. The coset's interpolation is
Lagrange's."""

from __future__ import annotations

from .field import MULTIPLICATIVE_GROUP_GENERATOR, P, ZERO, Ext, inv, primitive_root_of_unity, reverse_bits


def merkle_ok(hasher, leaf, index: int, siblings, cap) -> bool:
    digest = hasher.hash_or_noop(leaf)
    for sib in siblings:
        digest = hasher.two_to_one(sib, digest) if index & 1 else hasher.two_to_one(digest, sib)
        index >>= 1
    return index < len(cap) and digest == cap[index]


def fri_batches(cd) -> list:
    """Each batch's polynomials as (oracle, index), and its point's power of g."""
    n = cd.num_challenges
    widths = cd.oracle_widths()
    zs = [(2, i) for i in range(n)]
    zs_pps = [(2, i) for i in range(n * (1 + cd.num_partial_products))]
    lookups = [(2, i) for i in range(n * (1 + cd.num_partial_products), widths[2])]
    at_zeta = ([(0, i) for i in range(widths[0])] + [(1, i) for i in range(widths[1])] + zs_pps
               + [(3, i) for i in range(widths[3])] + lookups)
    return [(at_zeta, 0), (zs + lookups, 1)]


def reduce(values, alpha: Ext) -> Ext:
    acc = ZERO
    for v in reversed(values):
        acc = acc * alpha + v
    return acc


def interpolate(xs, ys, at: Ext) -> Ext:
    for x, y in zip(xs, ys):
        if at == Ext(x):
            return y
    out = ZERO
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num, den = Ext(1), 1
        for j, xj in enumerate(xs):
            if j != i:
                num = num * (at - xj)
                den = den * (xi - xj) % P
        out = out + yi * num * inv(den)
    return out


def check_fri(proof, ch) -> bool:
    cd = proof.common
    assert not cd.hiding, "a hiding proof salts its leaves; not read here"
    if (ch.fri_pow_response >> (64 - cd.pow_bits) if cd.pow_bits else 0) != 0:
        return False
    if len(proof.query_rounds) != cd.num_query_rounds or len(ch.fri_query_indices) != cd.num_query_rounds:
        return False
    g = primitive_root_of_unity(cd.degree_bits)
    batches = fri_batches(cd)
    openings = proof.opening_batches()
    points = [ch.zeta * pow(g, k, P) for _, k in batches]
    reduced_openings = [reduce(vals, ch.fri_alpha) for vals in openings]
    caps = proof.initial_merkle_caps()
    log_n = cd.degree_bits + cd.rate_bits
    omega = primitive_root_of_unity(log_n)
    for x_index, (initial, steps) in zip(ch.fri_query_indices, proof.query_rounds):
        if len(initial) != len(caps) or len(steps) != len(cd.reduction_arity_bits):
            return False
        for (leaf, path), cap in zip(initial, caps):
            if not merkle_ok(proof.hasher, leaf, x_index, path, cap):
                return False
        x = MULTIPLICATIVE_GROUP_GENERATOR * pow(omega, reverse_bits(x_index, log_n), P) % P
        # fri_combine_initial
        total = ZERO
        for (polys, _), point, opened in zip(batches, points, reduced_openings):
            evals = [Ext(initial[o][0][i]) for o, i in polys]
            total = total * (ch.fri_alpha ** len(polys)) + (reduce(evals, ch.fri_alpha) - opened) / (Ext(x) - point)
        old = total
        for i, arity_bits in enumerate(cd.reduction_arity_bits):
            evals, path = steps[i]
            arity = 1 << arity_bits
            if len(evals) != arity:
                return False
            coset_index, within = x_index >> arity_bits, x_index & (arity - 1)
            if evals[within] != old:
                return False
            gen = primitive_root_of_unity(arity_bits)
            ordered = [evals[reverse_bits(k, arity_bits)] for k in range(arity)]
            start = x * pow(gen, arity - reverse_bits(within, arity_bits), P) % P
            xs = [start * pow(gen, k, P) % P for k in range(arity)]
            old = interpolate(xs, ordered, ch.fri_betas[i])
            leaf = [w for e in evals for w in (e.a, e.b)]
            if not merkle_ok(proof.hasher, leaf, coset_index, path, proof.commit_phase_merkle_caps[i]):
                return False
            x = pow(x, arity, P)
            x_index = coset_index
        final = ZERO
        for co in reversed(proof.final_poly):
            final = final * x + co
        if final != old:
            return False
    return True
