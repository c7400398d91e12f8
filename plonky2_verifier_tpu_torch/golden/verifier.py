"""Top-level golden verifier: challenges -> plonk equations -> FRI check.

verifyProof semantics per reference spec Plonk/Verifier.hs:56-66.
This is the slow, bit-exact oracle; the production path is
`plonky2_verifier_tpu.verifier_jax`.
"""

from __future__ import annotations

from ..types import CommonCircuitData, ProofWithPublicInputs, VerifierOnlyCircuitData
from .challenges import proof_challenges
from .fri import check_fri_proof
from .plonk import check_combined_plonk_equations


def verify_proof(
    common: CommonCircuitData,
    vkey: VerifierOnlyCircuitData,
    proof_with_pis: ProofWithPublicInputs,
) -> bool:
    """Cryptographic verdict for a structurally well-formed proof.

    Invalid-but-well-formed proofs return False through the Bool pipeline
    (Plonk/Verifier.hs:47,62-65). *Structurally* malformed inputs (wrong
    lengths, unknown gates, ...) raise — exactly like the reference's
    `error` aborts (Plonk/FRI.hs:399-401) — so an oracle crash can never
    masquerade as a clean rejection in fault-injection suites. Callers
    wanting a total function over untrusted bytes should validate shape
    first (compiler.flatten.flatten_proofs does this for the device path).
    """
    challenges = proof_challenges(common, vkey, proof_with_pis)
    eqs_ok = all(check_combined_plonk_equations(common, proof_with_pis, challenges))
    fri_ok = check_fri_proof(common, vkey, proof_with_pis.proof, challenges)
    return eqs_ok and fri_ok
