"""The fixture prover: turn a Fixture (circuit + witness) into a real
Plonky2 proof that the verifier accepts bit-exactly.

Pipeline (the honest-prover side of the protocol the verifier checks):
1. commit constants+sigmas, wires (coset LDE at shift g, bit-reversed-leaf
   Merkle caps),
2. run the Fiat-Shamir transcript (golden duplex) to get betas/gammas,
3. build the partial-product columns (z + 9 partial columns per challenge
   round, in the shifted layout of commentary/Wiring.md), commit,
4. alphas -> evaluate the full constraint vector on the LDE domain (reusing
   the *verifier's own* gate programs through the numpy backend,
   npplonk.eval_all_plonk_constraints_np), divide by Z_H, split the quotient
   into maxdeg chunks, commit,
5. zeta -> openings at zeta / omega*zeta,
6. FRI: combined polynomial (combine order + alpha^{M2} swap of
   Plonk/FRI.hs:171-207), commit phase with per-step folding, grinding,
   query rounds against all trees.

All the heavy steps (LDE FFTs, Merkle hashing, the whole-domain constraint
evaluation, polynomial openings, FRI folding, grinding) run vectorized on
numpy uint64 arrays (npf/nphash/npplonk), so standard-size circuits
(degree_bits=12, 2^15 LDE rows, PoW 16) generate in seconds instead of
hours. The transcript itself stays on the golden Duplex: it is tiny and it
is the bit-exactness anchor every other backend is validated against.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Sequence, Tuple

import numpy as np

from ..golden import field as gf
from ..golden.challenges import fri_opening_batches
from ..golden.duplex import RATE, Duplex
from ..golden.hashing import sponge
from ..models.builder import Fixture
from ..types import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
    MerkleProof,
    OpeningSet,
    Proof,
    ProofWithPublicInputs,
    VerifierOnlyCircuitData,
)
from . import npf, nphash
from .npf import FExtArr
from .npplonk import combine_with_powers_of_alpha_np, eval_all_plonk_constraints_np


@dataclass
class _Committed:
    """A committed matrix: per-column coefficients, LDE values, Merkle tree.

    `col_coeffs` is (n_cols, n) and `ldes` is (n_cols, lde_n); `lde_rows` is
    the transposed, row-contiguous (lde_n, n_cols) view the Merkle leaves and
    query rounds read."""

    col_coeffs: np.ndarray
    ldes: np.ndarray
    lde_rows: np.ndarray
    tree: nphash.NpMerkleTree


def _commit_from_coeffs(col_coeffs: np.ndarray, lde_bits: int, cap_height: int) -> _Committed:
    ldes = npf.coset_evaluate(col_coeffs, gf.MULT_GEN, lde_bits)
    lde_rows = np.ascontiguousarray(ldes.T)
    leaves = lde_rows[npf._bitrev_perm(lde_bits)]
    tree = nphash.NpMerkleTree(leaves, cap_height)
    return _Committed(col_coeffs, ldes, lde_rows, tree)


def _commit(columns: np.ndarray, rate_bits: int, cap_height: int) -> _Committed:
    """columns: (n_cols, n) values on the subgroup H."""
    n = columns.shape[-1]
    lde_bits = (n.bit_length() - 1) + rate_bits
    col_coeffs = npf.interpolate(columns)
    return _commit_from_coeffs(col_coeffs, lde_bits, cap_height)


def _synthetic_div(coeffs: List[gf.FExt], root: gf.FExt) -> List[gf.FExt]:
    """Divide sum c_i X^i by (X - root); remainder must be zero."""
    out: List[gf.FExt] = [gf.EXT_ZERO] * (len(coeffs) - 1)
    acc = gf.EXT_ZERO
    for i in range(len(coeffs) - 1, 0, -1):
        acc = gf.eadd(coeffs[i], gf.emul(acc, root)) if i < len(coeffs) - 1 else coeffs[i]
        out[i - 1] = acc
        acc = out[i - 1]
    rem = gf.eadd(coeffs[0], gf.emul(out[0], root))
    assert rem == gf.EXT_ZERO, f"nonzero remainder {rem}"
    return out


def _prefix_products(vals: np.ndarray) -> np.ndarray:
    """Inclusive modular prefix product along axis 0 (Hillis-Steele scan)."""
    acc = vals.copy()
    shift = 1
    while shift < acc.shape[0]:
        acc[shift:] = npf.mul(acc[shift:], acc[:-shift])
        shift <<= 1
    return acc


def compute_partial_product_columns(
    fixture: Fixture, betas: Sequence[int], gammas: Sequence[int]
) -> Tuple[List[np.ndarray], int]:
    """Per challenge round: [z] + num_partial_products partial columns, in the
    shifted layout of commentary/Wiring.md (z holds the running product; the
    partial columns hold per-chunk prefixes within each row). Vectorized over
    all n rows at once; the cross-row running product is a log-depth scan."""
    common = fixture.common
    n = common.nrows
    maxdeg = common.quotient_degree_factor
    nrouted = common.config.num_routed_wires
    assert nrouted % maxdeg == 0, "routed wires must split evenly into chunks"
    nchunks = nrouted // maxdeg
    omega_pows = npf.powers(gf.subgroup_generator(common.fri_params.degree_bits), n)  # (n,)

    wr = npf.arr(fixture.witness)[:, :nrouted]  # (n, nrouted)
    sig = npf.arr(fixture.sigma_columns).T  # (n, nrouted)
    k_is = npf.arr(common.k_is)  # (nrouted,)

    out: List[np.ndarray] = []
    zs_cols: List[np.ndarray] = []
    pp_cols_all: List[np.ndarray] = []
    for beta, gamma in zip(betas, gammas):
        beta_a = npf.arr(beta)
        gamma_a = npf.arr(gamma)
        num = npf.add(wr, npf.add(npf.mul(npf.mul(beta_a, k_is)[None, :], omega_pows[:, None]), gamma_a))
        den = npf.add(wr, npf.add(npf.mul(beta_a, sig), gamma_a))
        num_c = num.reshape(n, nchunks, maxdeg)
        den_c = den.reshape(n, nchunks, maxdeg)
        num_prod = _prefix_products(np.moveaxis(num_c, -1, 0))[-1]  # (n, nchunks)
        den_prod = _prefix_products(np.moveaxis(den_c, -1, 0))[-1]
        ratio = npf.mul(num_prod, npf.inv(den_prod))
        # within-row prefix across chunks, then the cross-row running product
        row_prefix = _prefix_products(ratio.T)  # (nchunks, n); row_prefix[c, i]
        row_prod = row_prefix[-1]  # (n,)
        run = _prefix_products(row_prod)
        assert int(run[-1]) == 1, "grand product does not close to 1"
        z = np.concatenate([np.ones(1, dtype=np.uint64), run[:-1]])
        zs_cols.append(z)
        for c in range(common.num_partial_products):
            pp_cols_all.append(npf.mul(z, row_prefix[c]))
    return zs_cols + pp_cols_all, len(zs_cols)


def compute_lookup_columns(fixture: Fixture, deltas) -> List[List[int]]:
    """Per challenge round: the RE column + num_sldc SLDC running-sum columns
    (commentary/Lookups.md). Accumulation runs from the bottom row upward
    (row transitions reference omega*x = the row below): zero on each block's
    Noop row, Sum added across LookupTable rows, LDC subtracted across Lookup
    rows, closing at zero on the topmost Lookup row. Row roles are read off
    the committed lookup selector columns, so the columns match exactly what
    the verifier's equations (Plonk/Lookups.hs:45-132) constrain."""
    common = fixture.common
    cfg = common.config
    n = common.nrows
    num_lu_slots = cfg.num_routed_wires // 2
    num_lut_slots = cfg.num_routed_wires // 3
    num_sldc = common.num_lookup_polys - 1
    lu_degree = common.quotient_degree_factor - 1
    lut_degree = -(-num_lut_slots // num_sldc)

    n_sel = len(common.selectors_info.groups)
    trans_sre = fixture.constant_columns[n_sel + 0]
    trans_ldc = fixture.constant_columns[n_sel + 1]

    cols: List[List[int]] = []
    for delta in deltas:
        re_col = [0] * n
        sldc_cols = [[0] * n for _ in range(num_sldc)]
        re_below = 0
        a_below = 0
        for i in range(n - 1, -1, -1):
            w = fixture.witness[i]
            if trans_sre[i]:  # LookupTable row: RE Horner step + Sum chunks
                acc = re_below
                for j in range(num_lut_slots):
                    acc = (delta.delta * acc + w[3 * j] + delta.b * w[3 * j + 1]) % gf.P
                re_col[i] = acc
                prev = a_below
                for k in range(num_sldc):
                    for j in range(k * lut_degree, min((k + 1) * lut_degree, num_lut_slots)):
                        combo = (w[3 * j] + delta.a * w[3 * j + 1]) % gf.P
                        prev = (prev + w[3 * j + 2] * gf.finv((delta.alpha - combo) % gf.P)) % gf.P
                    sldc_cols[k][i] = prev
            elif trans_ldc[i]:  # Lookup row: LDC chunks subtract
                prev = a_below
                for k in range(num_sldc):
                    for j in range(k * lu_degree, min((k + 1) * lu_degree, num_lu_slots)):
                        combo = (w[2 * j] + delta.a * w[2 * j + 1]) % gf.P
                        prev = (prev - gf.finv((delta.alpha - combo) % gf.P)) % gf.P
                    sldc_cols[k][i] = prev
            re_below = re_col[i]
            a_below = sldc_cols[-1][i]
        cols.append(re_col)
        cols.extend(sldc_cols)
    return cols


def _ext_cols(mat: np.ndarray) -> List[FExtArr]:
    """(n_cols, m) base values -> list of (re, im=0) column pairs."""
    zero = np.uint64(0)
    return [(mat[j], zero) for j in range(mat.shape[0])]


def _eval_cols_at(col_coeffs: np.ndarray, zeta: gf.FExt) -> List[gf.FExt]:
    """Evaluate every base-coefficient column polynomial at the extension
    point zeta: two modular matvecs against the power vector."""
    m, n = col_coeffs.shape
    zp_re, zp_im = npf.epowers(zeta, n)
    re = npf.modsum(npf.mul(col_coeffs, zp_re), axis=-1)
    im = npf.modsum(npf.mul(col_coeffs, zp_im), axis=-1)
    return list(zip(npf.to_ints(re), npf.to_ints(im)))


def _combine_cols(col_coeffs: np.ndarray, alpha: gf.FExt) -> FExtArr:
    """sum_k alpha^k * column_k as extension coefficient arrays; columns are
    base-field (n_polys, width)."""
    ap_re, ap_im = npf.epowers(alpha, col_coeffs.shape[0])
    re = npf.modsum(npf.mul(col_coeffs, ap_re[:, None]), axis=0)
    im = npf.modsum(npf.mul(col_coeffs, ap_im[:, None]), axis=0)
    return (re, im)


def _np_grind(d: Duplex, mask: int, chunk: int = 1 << 14) -> int:
    """Find the smallest pow_witness whose duplex response clears `mask`,
    trying candidates in vectorized batches through the numpy permutation.
    Replicates Duplex.absorb + squeeze exactly: flush a full pending buffer,
    overwrite lanes [buf..] + the candidate, permute, read lane 7 (the first
    element of reversed(state[:8]), Challenge/Pure.hs:41-43)."""
    assert not d._squeeze_mode
    state = npf.arr(d.state)
    buf = list(d._buf)
    if len(buf) == RATE:
        state = nphash.permutation(np.concatenate([npf.arr(buf), state[RATE:]]))
        buf = []
    nbuf = len(buf)
    mask_u = np.uint64(mask)
    w0 = 0
    while True:
        cand = np.arange(w0, w0 + chunk, dtype=np.uint64)
        sts = np.broadcast_to(state, (chunk, nphash.WIDTH)).copy()
        if nbuf:
            sts[:, :nbuf] = npf.arr(buf)
        sts[:, nbuf] = cand
        out = nphash.permutation(sts)[:, 7]
        hits = np.nonzero((out & mask_u) == 0)[0]
        if hits.size:
            return int(w0 + int(hits[0]))
        w0 += chunk


def prove(fixture: Fixture, grind_hook=None) -> Tuple[VerifierOnlyCircuitData, ProofWithPublicInputs]:
    common = fixture.common
    cfg = common.config
    n = common.nrows
    degree_bits = common.fri_params.degree_bits
    rate_bits = cfg.fri_config.rate_bits
    lde_bits = degree_bits + rate_bits
    lde_n = 1 << lde_bits
    cap_h = cfg.fri_config.cap_height
    r = cfg.num_challenges
    maxdeg = common.quotient_degree_factor

    # 1. commit constants+sigmas and wires --------------------------------
    n_const_cols = len(fixture.constant_columns)
    cs_cols = np.concatenate([npf.arr(fixture.constant_columns), npf.arr(fixture.sigma_columns)])
    cs = _commit(cs_cols, rate_bits, cap_h)
    wires = _commit(npf.arr(fixture.witness).T.copy(), rate_bits, cap_h)

    circuit_digest = sponge([x for d in cs.tree.cap for x in d] + [n])
    vkey = VerifierOnlyCircuitData(constants_sigmas_cap=cs.tree.cap, circuit_digest=circuit_digest)

    # 2. transcript: betas, gammas ----------------------------------------
    pi_hash = sponge(fixture.public_inputs)
    d = Duplex()
    d.absorb_digest(circuit_digest)
    d.absorb_digest(pi_hash)
    d.absorb_cap(wires.tree.cap)
    betas = d.squeeze_n(r)
    gammas = d.squeeze_n(r)
    deltas: List = []
    if common.num_lookup_polys > 0:
        extra = d.squeeze_n(2 * r)
        from ..golden.challenges import LookupDelta

        all4 = betas + gammas + extra
        deltas = [LookupDelta(*all4[i : i + 4]) for i in range(0, len(all4), 4)]

    # 3. partial products (+ lookup running sums) --------------------------
    pp_columns, n_z = compute_partial_product_columns(fixture, betas, gammas)
    if common.num_lookup_polys > 0:
        pp_columns = pp_columns + [npf.arr(c) for c in compute_lookup_columns(fixture, deltas)]
    pps = _commit(np.stack(pp_columns), rate_bits, cap_h)
    d.absorb_cap(pps.tree.cap)
    alphas = d.squeeze_n(r)

    # 4. quotient ----------------------------------------------------------
    # evaluate the canonical constraint vector on the whole LDE coset at once
    # (the gate programs' numpy backend), divide by Z_H, interpolate.
    lde_points = npf.mul(npf.arr(gf.MULT_GEN), npf.powers(gf.subgroup_generator(lde_bits), lde_n))
    next_shift = 1 << rate_bits  # z(omega*x) is `2^rate_bits` LDE rows ahead

    n_pp = r * common.num_partial_products
    pps_next = np.roll(pps.ldes, -next_shift, axis=-1)
    openings_lde = SimpleNamespace(
        constants=_ext_cols(cs.ldes[:n_const_cols]),
        plonk_sigmas=_ext_cols(cs.ldes[n_const_cols:]),
        wires=_ext_cols(wires.ldes),
        plonk_zs=_ext_cols(pps.ldes[:n_z]),
        plonk_zs_next=_ext_cols(pps_next[:n_z]),
        partial_products=_ext_cols(pps.ldes[n_z : n_z + n_pp]),
        quotient_polys=[],
        lookup_zs=_ext_cols(pps.ldes[n_z + n_pp :]),
        lookup_zs_next=_ext_cols(pps_next[n_z + n_pp :]),
    )
    challenges_lde = SimpleNamespace(
        betas=betas,
        gammas=gammas,
        alphas=alphas,
        deltas=deltas,
        zeta=(lde_points, np.uint64(0)),
        public_inputs_hash=pi_hash,
        fri=None,
    )
    cons = eval_all_plonk_constraints_np(common, openings_lde, challenges_lde)
    zh_inv = npf.inv(npf.sub(npf.pow_int(lde_points, n), np.uint64(1)))
    quotient_col_coeffs = np.empty((r * maxdeg, n), dtype=np.uint64)
    unscale = npf.powers(gf.finv(gf.MULT_GEN), lde_n)
    for ri, alpha in enumerate(alphas):
        acc_re, acc_im = combine_with_powers_of_alpha_np(alpha, cons)
        assert not np.any(acc_im), "constraint evaluation left the base field"
        qvals = npf.mul(acc_re, zh_inv)
        # coset IFFT: values on g*K -> coefficients (unscale by g^-i)
        coeffs = npf.mul(npf.interpolate(qvals), unscale)
        # degree < maxdeg * n by construction; split into maxdeg chunks of n
        assert not np.any(coeffs[maxdeg * n :]), "quotient degree too high"
        quotient_col_coeffs[ri * maxdeg : (ri + 1) * maxdeg] = coeffs[: maxdeg * n].reshape(maxdeg, n)
    quot = _commit_from_coeffs(quotient_col_coeffs, lde_bits, cap_h)
    d.absorb_cap(quot.tree.cap)
    zeta = d.squeeze_ext()

    # 5. openings ----------------------------------------------------------
    omega = gf.subgroup_generator(degree_bits)
    omega_zeta = gf.escale(omega, zeta)
    zs_coeffs = pps.col_coeffs[:n_z]
    pp_coeffs = pps.col_coeffs[n_z : n_z + n_pp]
    lookup_coeffs = pps.col_coeffs[n_z + n_pp :]
    cs_at_zeta = _eval_cols_at(cs.col_coeffs, zeta)
    wires_at_zeta = _eval_cols_at(wires.col_coeffs, zeta)
    pps_at_zeta = _eval_cols_at(pps.col_coeffs, zeta)
    pps_at_omega_zeta = _eval_cols_at(pps.col_coeffs, omega_zeta)
    openings = OpeningSet(
        constants=cs_at_zeta[:n_const_cols],
        plonk_sigmas=cs_at_zeta[n_const_cols:],
        wires=wires_at_zeta,
        plonk_zs=pps_at_zeta[:n_z],
        plonk_zs_next=pps_at_omega_zeta[:n_z],
        partial_products=pps_at_zeta[n_z : n_z + n_pp],
        quotient_polys=_eval_cols_at(quot.col_coeffs, zeta),
        lookup_zs=pps_at_zeta[n_z + n_pp :],
        lookup_zs_next=pps_at_omega_zeta[n_z + n_pp :],
    )

    # 6. FRI ----------------------------------------------------------------
    batch_this, batch_next = fri_opening_batches(openings)
    d.absorb_many(gf.flatten_ext(batch_this))
    d.absorb_many(gf.flatten_ext(batch_next))
    fri_alpha = d.squeeze_ext()

    # combined polynomial (combine order == transcript order elementwise;
    # cf. Plonk/FRI.hs:171-186 and Challenge/FRI.hs:46-61)
    first_batch_coeffs = np.concatenate(
        [cs.col_coeffs, wires.col_coeffs, zs_coeffs, pp_coeffs, quot.col_coeffs, lookup_coeffs]
    )
    g0_re, g0_im = _combine_cols(first_batch_coeffs, fri_alpha)
    second = np.concatenate([zs_coeffs, lookup_coeffs])
    g1_re, g1_im = _combine_cols(second, fri_alpha)
    g0 = list(zip(npf.to_ints(g0_re), npf.to_ints(g0_im)))
    g1 = list(zip(npf.to_ints(g1_re), npf.to_ints(g1_im)))
    y0 = gf.reduce_with_powers(fri_alpha, batch_this)
    y1 = gf.reduce_with_powers(fri_alpha, batch_next)
    g0[0] = gf.esub(g0[0], y0)
    g1[0] = gf.esub(g1[0], y1)
    p0 = _synthetic_div(g0, zeta)
    p1 = _synthetic_div(g1, omega_zeta)
    m2 = second.shape[0]
    a_m2 = gf.epow(fri_alpha, m2)
    p_coeffs = [gf.EXT_ZERO] * max(len(p0), len(p1))
    for i, c in enumerate(p0):
        p_coeffs[i] = gf.eadd(p_coeffs[i], gf.emul(a_m2, c))
    for i, c in enumerate(p1):
        p_coeffs[i] = gf.eadd(p_coeffs[i], c)

    # commit phase
    step_arities = list(common.fri_params.reduction_arity_bits)
    cw_re = npf.arr([c[0] for c in p_coeffs])
    cw_im = npf.arr([c[1] for c in p_coeffs])
    shift = gf.MULT_GEN
    cur_bits = lde_bits
    commit_caps: List = []
    commit_trees: List[nphash.NpMerkleTree] = []
    commit_brvs: List[FExtArr] = []
    for a_bits in step_arities:
        arity = 1 << a_bits
        ev_re, ev_im = npf.coset_evaluate_ext((cw_re, cw_im), shift, cur_bits)
        brv = npf._bitrev_perm(cur_bits)
        brv_re, brv_im = ev_re[brv], ev_im[brv]
        n_leaves = brv_re.shape[0] // arity
        leaves = np.empty((n_leaves, 2 * arity), dtype=np.uint64)
        leaves[:, 0::2] = brv_re.reshape(n_leaves, arity)
        leaves[:, 1::2] = brv_im.reshape(n_leaves, arity)
        tree = nphash.NpMerkleTree(leaves, min(cap_h, cur_bits - a_bits))
        commit_trees.append(tree)
        commit_brvs.append((brv_re, brv_im))
        commit_caps.append(tree.cap)
        d.absorb_cap(tree.cap)
        beta = d.squeeze_ext()
        # fold coefficients: new_c[j] = sum_k beta^k c[arity*j + k]
        # (pad the ragged tail with zeros — Horner ignores trailing zeros)
        if cw_re.shape[0] % arity:
            pad = arity - cw_re.shape[0] % arity
            cw_re = np.concatenate([cw_re, np.zeros(pad, dtype=np.uint64)])
            cw_im = np.concatenate([cw_im, np.zeros(pad, dtype=np.uint64)])
        ch_re = cw_re.reshape(-1, arity)
        ch_im = cw_im.reshape(-1, arity)
        acc: FExtArr = (ch_re[:, arity - 1], ch_im[:, arity - 1])
        beta_t = (npf.arr(beta[0]), npf.arr(beta[1]))
        for k in range(arity - 2, -1, -1):
            acc = npf.eadd((ch_re[:, k], ch_im[:, k]), npf.emul(beta_t, acc))
        cw_re, cw_im = acc
        for _ in range(a_bits):
            shift = gf.fmul(shift, shift)
        cur_bits -= a_bits

    # pad to the canonical final-poly length so the transcript schedule is
    # fully determined by the circuit shape (Plonky2 sends exactly
    # 2^(degree_bits - sum(arity_bits)) coefficients)
    canonical_len = 1 << (degree_bits - sum(step_arities))
    assert cw_re.shape[0] <= canonical_len, "final polynomial too long"
    final_poly = list(zip(npf.to_ints(cw_re), npf.to_ints(cw_im)))
    final_poly += [gf.EXT_ZERO] * (canonical_len - len(final_poly))
    d.absorb_many(gf.flatten_ext(final_poly))

    # grinding: find pow_witness whose response has pow_bits leading zeros
    pow_bits = cfg.fri_config.proof_of_work_bits
    mask = ((1 << pow_bits) - 1) << (64 - pow_bits) if pow_bits else 0
    if grind_hook is not None:
        import copy as _copy

        pow_witness = grind_hook(_copy.deepcopy(d), mask)
    else:
        pow_witness = _np_grind(d, mask)
    d.absorb(pow_witness)
    pow_response = d.squeeze()
    assert (pow_response & mask) == 0

    query_indices = [q % lde_n for q in d.squeeze_n(cfg.fri_config.num_query_rounds)]

    # query rounds
    trees = [cs, wires, pps, quot]
    rounds: List[FriQueryRound] = []
    for q in query_indices:
        evals_proofs = []
        nat = gf.reverse_bits(lde_bits, q)
        for t in trees:
            evals_proofs.append((npf.to_ints(t.lde_rows[nat]), MerkleProof(t.tree.prove(q))))
        steps: List[FriQueryStep] = []
        idx = q
        for a_bits, tree, brv in zip(step_arities, commit_trees, commit_brvs):
            arity = 1 << a_bits
            leaf_idx = idx >> a_bits
            evals = list(
                zip(
                    npf.to_ints(brv[0][leaf_idx * arity : (leaf_idx + 1) * arity]),
                    npf.to_ints(brv[1][leaf_idx * arity : (leaf_idx + 1) * arity]),
                )
            )
            steps.append(FriQueryStep(evals=evals, merkle_proof=MerkleProof(tree.prove(leaf_idx))))
            idx = leaf_idx
        rounds.append(
            FriQueryRound(initial_trees_proof=FriInitialTreeProof(evals_proofs=evals_proofs), steps=steps)
        )

    fri_proof = FriProof(
        commit_phase_merkle_caps=commit_caps,
        query_round_proofs=rounds,
        final_poly=final_poly,
        pow_witness=pow_witness,
    )
    proof = Proof(
        wires_cap=wires.tree.cap,
        plonk_zs_partial_products_cap=pps.tree.cap,
        quotient_polys_cap=quot.tree.cap,
        openings=openings,
        opening_proof=fri_proof,
    )
    return vkey, ProofWithPublicInputs(proof=proof, public_inputs=list(fixture.public_inputs))
