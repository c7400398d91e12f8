"""The Fiat-Shamir transcript of a Plonky2 proof.

`Challenger` is plonky2/src/iop/challenger.rs's duplex sponge in overwrite
mode: an observed element clears the outputs and is buffered, 8 buffered
elements (the rate) force a duplexing; a challenge duplexes first when inputs
are buffered or no output is left, then pops the last output. Its
permutation of 12 words is the hasher's (hashing.py): Poseidon's, or
KeccakPermutation's; a digest is observed as its words (`observe_hash`:
`to_vec`).

`proof_challenges` is plonky2/src/plonk/get_challenges.rs's
`get_challenges` with the challenger's `fri_challenges`
(plonky2/src/fri/challenges.rs), in their order: the circuit digest, the
public inputs' hash, the wires cap; betas, gammas; with lookups the deltas
(the betas, the gammas, then 4 x challenges - 2 x challenges fresh ones); the
Z and partial-products cap, alphas; the quotient cap, zeta; the openings
(the batch at zeta, then the batch at g zeta); FRI's alpha, a beta after each
commit-phase cap, the final polynomial, the PoW witness, the PoW response
and the query indices.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import poseidon
from .field import Ext
from .hashing import digest_words

NUM_COINS_LOOKUP = 4
WIDTH, RATE = 12, 8  # hash/hashing.rs SPONGE_WIDTH, SPONGE_RATE


class Challenger:
    def __init__(self, permute):
        self.permute = permute
        self.state = [0] * WIDTH
        self.inputs: list = []
        self.outputs: list = []

    def _duplex(self):
        assert len(self.inputs) <= RATE
        self.state[:len(self.inputs)] = self.inputs
        self.inputs = []
        self.state = self.permute(self.state)
        self.outputs = self.state[:RATE]

    def observe(self, x: int):
        self.outputs = []
        self.inputs.append(x)
        if len(self.inputs) == RATE:
            self._duplex()

    def observe_all(self, xs):
        for x in xs:
            self.observe(x)

    def observe_ext(self, xs):
        for x in xs:
            self.observe_all((x.a, x.b))

    def observe_cap(self, cap):
        for h in cap:
            self.observe_all(digest_words(h))

    def challenge(self) -> int:
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def challenges(self, n: int) -> list:
        return [self.challenge() for _ in range(n)]

    def ext_challenge(self) -> Ext:
        a, b = self.challenges(2)
        return Ext(a, b)


@dataclass
class Challenges:
    public_inputs_hash: list
    betas: list
    gammas: list
    deltas: list  # flat: 4 a challenge, (A, B, alpha, delta) each
    alphas: list
    zeta: Ext
    fri_alpha: Ext
    fri_betas: list
    fri_pow_response: int
    fri_query_indices: list


def proof_challenges(proof, challenger: Challenger = None) -> Challenges:
    """`proof` is a proof.Proof; the transcript runs in `challenger`, by
    default one with the permutation of the proof's hasher. The public
    inputs' hash is Poseidon's (InnerHasher) whatever the hasher."""
    c = challenger or Challenger(proof.hasher.permute)
    cd = proof.common
    n = cd.num_challenges
    pi_hash = poseidon.hash_no_pad(proof.public_inputs)
    c.observe_all(digest_words(proof.circuit_digest))
    c.observe_all(pi_hash)
    c.observe_cap(proof.wires_cap)
    betas = c.challenges(n)
    gammas = c.challenges(n)
    deltas = []
    if cd.num_lookup_polys:
        deltas = betas + gammas + c.challenges(NUM_COINS_LOOKUP * n - 2 * n)
    c.observe_cap(proof.zs_partial_products_cap)
    alphas = c.challenges(n)
    c.observe_cap(proof.quotient_polys_cap)
    zeta = c.ext_challenge()
    for batch in proof.opening_batches():
        c.observe_ext(batch)
    fri_alpha = c.ext_challenge()
    fri_betas = []
    for cap in proof.commit_phase_merkle_caps:
        c.observe_cap(cap)
        fri_betas.append(c.ext_challenge())
    c.observe_ext(proof.final_poly)
    c.observe(proof.pow_witness)
    pow_response = c.challenge()
    lde_size = 1 << (cd.degree_bits + cd.rate_bits)
    queries = [c.challenge() % lde_size for _ in range(cd.num_query_rounds)]
    return Challenges(pi_hash, betas, gammas, deltas, alphas, zeta, fri_alpha, fri_betas, pow_response, queries)
