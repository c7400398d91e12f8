"""The hasher that a configuration's Plonky2 `GenericConfig` names
(plonky2/src/plonk/config.rs): its `Hasher`, which makes the Merkle trees,
the circuit digest and the Fiat-Shamir transcript (`Challenger<F,
C::Hasher>`, with the hasher's permutation). `InnerHasher`, which hashes the
public inputs, is Poseidon in both configurations.

- PoseidonGoldilocksConfig: PoseidonHash; a digest is a `HashOut` of 4 words;
- KeccakGoldilocksConfig: KeccakHash<25>; a digest is a `BytesHash<25>`,
  and the transcript observes its `to_vec`.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import keccak, poseidon

POSEIDON_CONFIG = "PoseidonGoldilocksConfig"


@dataclass(frozen=True)
class Hasher:
    hash_or_noop: object  # a leaf's words -> its digest
    two_to_one: object  # (left, right) digests -> their parent's
    permute: object  # the challenger's permutation of 12 words


HASHERS = {
    POSEIDON_CONFIG: Hasher(poseidon.hash_or_noop, poseidon.two_to_one, poseidon.permute),
    "KeccakGoldilocksConfig": Hasher(keccak.hash_or_noop, keccak.two_to_one, keccak.permute),
}


def hasher(generic_config: str) -> Hasher:
    if generic_config not in HASHERS:
        raise ValueError(f"generic_config {generic_config!r} is none of {sorted(HASHERS)}")
    return HASHERS[generic_config]


def read_digest(doc):
    """A digest from its serde JSON: a HashOut {"elements": [4 words]} as a
    list of words, a BytesHash<25> (serialize_bytes: [25 byte values]) as
    bytes."""
    if isinstance(doc, dict):
        return [int(x) for x in doc["elements"]]
    return bytes(doc)


def digest_words(digest) -> list:
    """The elements a transcript observes of a digest (observe_hash: its
    to_vec)."""
    return keccak.to_vec(digest) if isinstance(digest, bytes) else list(digest)
