"""Test-circuit families (fixture models).

Each model builds a `Fixture` (circuit data + satisfying witness) via the
`CircuitBuilder`; `plonky2_verifier_tpu.prover.prove` turns a fixture into a
real Plonky2 proof. Families mirror the reference's fixture set
(testmain.hs:28-29): fibonacci (arithmetic + routing), poseidon chains,
lookup circuits, and a recursion-style gate mix (CosetInterpolation /
RandomAccess / Reducing / PoseidonMds).
"""

from .builder import CircuitBuilder, Fixture  # noqa: F401
