"""Fiat–Shamir challenge derivation — golden model.

Reproduces the reference transcript bit-exactly
(Challenge/Verifier.hs:58-103 and Challenge/FRI.hs:42-104):

zero state -> absorb circuit_digest, PI hash, wires_cap
           -> squeeze betas, gammas (num_challenges each)
           -> (lookups: squeeze 2r deltas; lookup challenge 4-tuples are
               chunks of betas ++ gammas ++ deltas)
           -> absorb zs/partial-products cap -> squeeze alphas
           -> absorb quotient cap -> squeeze zeta (ext)
           -> absorb the two *reordered* opening batches
           -> squeeze FRI alpha; per commit-phase cap: absorb cap, squeeze beta
           -> absorb final-poly coeffs; absorb pow_witness, squeeze response
           -> query indices = squeezeN num_query_rounds, each mod lde_size
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..types import CommonCircuitData, ProofWithPublicInputs, VerifierOnlyCircuitData
from .duplex import Duplex
from .field import FExt, flatten_ext
from .hashing import sponge


@dataclass
class FriChallenges:
    alpha: FExt
    betas: List[FExt]
    pow_response: int
    query_indices: List[int]


@dataclass
class LookupDelta:
    a: int  # combines lookup input/output in the argument
    b: int  # combines input/output in the LUT consistency check
    alpha: int  # log-derivative random point
    delta: int  # LUT polynomial evaluation point


@dataclass
class ProofChallenges:
    betas: List[int]
    gammas: List[int]
    alphas: List[int]
    deltas: List[LookupDelta]
    zeta: FExt
    fri: FriChallenges
    public_inputs_hash: Tuple[int, int, int, int]


def fri_opening_batches(openings) -> Tuple[List[FExt], List[FExt]]:
    """The two *transcript-order* batches (Challenge/FRI.hs:46-61).
    NB: differs from the combineInitial order (Plonk/FRI.hs:171-186)."""
    batch_this = (
        openings.constants
        + openings.plonk_sigmas
        + openings.wires
        + openings.plonk_zs
        + openings.partial_products
        + openings.quotient_polys
        + openings.lookup_zs
    )
    batch_next = openings.plonk_zs_next + openings.lookup_zs_next
    return batch_this, batch_next


def lookup_delta_challenges(
    d: Duplex, betas: List[int], gammas: List[int], num_challenges: int
) -> List[LookupDelta]:
    """Lookup challenge 4-tuples: the plonk β/γ DOUBLE as the first lookup
    challenges; only 2r extra felts are squeezed (Challenge/Verifier.hs:82-86).
    Squeezing 4r fresh felts instead shifts the whole downstream transcript
    (docs/traps.md row 10; mutation-tested in tests/test_traps.py)."""
    extra = d.squeeze_n(2 * num_challenges)
    all4 = betas + gammas + extra
    return [LookupDelta(*all4[i : i + 4]) for i in range(0, len(all4), 4)]


def proof_challenges(
    common: CommonCircuitData,
    vkey: VerifierOnlyCircuitData,
    proof_with_pis: ProofWithPublicInputs,
    duplex: Duplex | None = None,
) -> ProofChallenges:
    proof = proof_with_pis.proof
    num_challenges = common.config.num_challenges
    has_lookup = common.num_lookup_polys > 0

    pi_hash = sponge(proof_with_pis.public_inputs)

    d = duplex or Duplex()
    d.absorb_digest(vkey.circuit_digest)
    d.absorb_digest(pi_hash)
    d.absorb_cap(proof.wires_cap)

    betas = d.squeeze_n(num_challenges)
    gammas = d.squeeze_n(num_challenges)

    deltas: List[LookupDelta] = []
    if has_lookup:
        deltas = lookup_delta_challenges(d, betas, gammas, num_challenges)

    d.absorb_cap(proof.plonk_zs_partial_products_cap)
    alphas = d.squeeze_n(num_challenges)

    d.absorb_cap(proof.quotient_polys_cap)
    zeta = d.squeeze_ext()

    fri = fri_challenges(common, proof, d)

    return ProofChallenges(
        betas=betas,
        gammas=gammas,
        alphas=alphas,
        deltas=deltas,
        zeta=zeta,
        fri=fri,
        public_inputs_hash=pi_hash,
    )


def fri_challenges(common: CommonCircuitData, proof, d: Duplex) -> FriChallenges:
    fri_proof = proof.opening_proof
    fri_config = common.config.fri_config
    lde_size = 1 << (common.fri_params.degree_bits + fri_config.rate_bits)

    batch_this, batch_next = fri_opening_batches(proof.openings)
    d.absorb_many(flatten_ext(batch_this))
    d.absorb_many(flatten_ext(batch_next))

    alpha = d.squeeze_ext()

    betas = []
    for cap in fri_proof.commit_phase_merkle_caps:
        d.absorb_cap(cap)
        betas.append(d.squeeze_ext())

    d.absorb_many(flatten_ext(fri_proof.final_poly))

    d.absorb(fri_proof.pow_witness)
    pow_response = d.squeeze()

    query_indices = [q % lde_size for q in d.squeeze_n(fri_config.num_query_rounds)]

    return FriChallenges(alpha=alpha, betas=betas, pow_response=pow_response, query_indices=query_indices)
