"""Fixture generator: a host-side Plonky2 prover for synthetic circuits.

The reference repository ships no proof fixtures (its JSON vectors are
gitignored), so the framework generates its own: commit the 4 matrices
(LDE + Merkle caps), run the real Fiat-Shamir transcript, compute partial
products and the quotient, and emit the FRI commit phase + query rounds.
Golden-verifier acceptance plus single-bit-mutation rejection make the whole
stack testable without upstream Rust.
"""
