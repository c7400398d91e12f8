"""The benchmark's plain reference: a Plonky2 verifier in plain Python,
transcribed from Plonky2's own sources (each module names the files it
follows) and sharing no code with the program under test: it imports nothing
but the standard library and its own modules.

- field.py: Goldilocks, its quadratic extension, the extension algebra;
- poseidon.py: the permutation in its plain form and the hashing;
- proof.py: the proof, verifier key and common data read from their JSON;
- challenger.py: the Fiat-Shamir transcript and the proof's challenges;
- gates.py: each gate's constraints;
- vanishing.py: the constraint equations at zeta;
- fri.py: the FRI opening proof.

`judge` is the one entry the harness uses.
"""

from __future__ import annotations

from . import poseidon
from .challenger import proof_challenges
from .fri import check_fri
from .proof import Common, Proof
from .vanishing import check_constraint_equations


def challenge_words(ch) -> list:
    """Every Fiat-Shamir challenge of one proof as a flat list of words, in
    the order the harness reads them from the program's debug output: zeta,
    FRI's alpha, the betas, gammas, alphas, the deltas (4 a challenge), the
    PoW response, the query indices, the public inputs' hash."""
    words = [ch.zeta.a, ch.zeta.b, ch.fri_alpha.a, ch.fri_alpha.b, *ch.betas, *ch.gammas, *ch.alphas, *ch.deltas]
    return words + [ch.fri_pow_response, *ch.fri_query_indices, *ch.public_inputs_hash]


def judge(common_json: dict, vkey_json: dict, proof_json: dict) -> dict:
    """One proof's verdicts, as the program reports them on its lane (`ok`,
    `eqs_ok`: the constraint equations at zeta, `fri_ok`: the FRI opening
    proof with its proof of work), its challenge words, and the Poseidon
    permutations its verification made (for an honest proof: every hash of
    the transcript, the public inputs and each query's Merkle openings)."""
    before = poseidon.Counter.permutations
    proof = Proof(Common(common_json), vkey_json, proof_json)
    ch = proof_challenges(proof)
    eqs_ok = all(check_constraint_equations(proof, ch))
    fri_ok = check_fri(proof, ch)
    return {"ok": eqs_ok and fri_ok, "eqs_ok": eqs_ok, "fri_ok": fri_ok, "challenges": challenge_words(ch),
            "permutations": poseidon.Counter.permutations - before}

