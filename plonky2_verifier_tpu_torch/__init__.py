"""PyTorch + CUDA port of the batched Plonky2 verifier.

The counterpart of plonky2_verifier_tpu's JAX verifier: the same flattened
proof arrays (compiler.flatten_proofs) and the same CircuitTemplate in, the
same per-proof verdicts out. The package stands alone: it imports torch,
numpy and the standard library, never JAX and nothing of
plonky2_verifier_tpu. Its host tier (types.py, gate_parser.py, gates.py,
compiler/template.py, compiler/flatten.py, golden/, models/, prover/) is a
file-for-file copy of the JAX package's modules of the same names; the tests
hold each copy equal to its original. Both packages share the proved
fixtures under the repository's fixtures/ directory.

Entry points (verifier_torch.py): `verify_batch(tpl, arrays)` for numpy in,
numpy out, and `TorchVerifier(tpl)` for the module. Both run on the CUDA
card unless the caller passes `device="cpu"`, and raise where there is no
card. Modules mirror the JAX package: ops/field.py, ops/poseidon.py,
ops/hash.py (the Pallas hash kernels' counterparts), compiler/. The Poseidon
kernels are CUDA C++ in csrc/, built by kernels.py.
"""
