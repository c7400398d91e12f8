"""Sponge, Merkle-cap verification, and digests — golden model.

Semantics: reference spec Hash/Sponge.hs:18-42 (rate-8/capacity-4 sponge in
overwrite mode, no padding), Hash/Merkle.hs:21-42 (2-to-1 compression and
Merkle-cap proof reconstruction), Hash/Digest.hs:20-61.

A Digest is a 4-tuple of field elements; Merkle caps are lists of digests
(the proof path stops at the cap layer; the residual index picks the root).
"""

from __future__ import annotations

from typing import Sequence

from .poseidon import permutation

Digest = tuple  # (int, int, int, int)

ZERO_DIGEST: Digest = (0, 0, 0, 0)
RATE = 8
WIDTH = 12


def sponge(inputs: Sequence[int]) -> Digest:
    """Overwrite-mode rate-8 sponge, no padding (Hash/Sponge.hs:26-31)."""
    state = [0] * WIDTH
    xs = list(inputs)
    for i in range(0, len(xs), RATE) if xs else []:
        chunk = xs[i : i + RATE]
        state = permutation(chunk + state[len(chunk) :])
    return tuple(state[:4])


def sponge_with_pad(inputs: Sequence[int]) -> Digest:
    """10*1 padding variant, used only for the (empty) domain separator
    (Hash/Sponge.hs:33-42)."""
    state = [0] * WIDTH
    xs = list(inputs) + [1]
    for i in range(0, len(xs), RATE):
        chunk = xs[i : i + RATE]
        k = len(chunk)
        if k < RATE:
            chunk = chunk + [0] * (RATE - k - 1) + [1]
        state = permutation(chunk + state[RATE:])
    return tuple(state[:4])


def compress(x: Digest, y: Digest) -> Digest:
    """2-to-1 Merkle node hash (Hash/Merkle.hs:21-23)."""
    state = permutation(list(x) + list(y) + [0, 0, 0, 0])
    return tuple(state[:4])


def reconstruct_merkle_root(leaf_digest: Digest, leaf_idx: int, siblings: Sequence[Digest]):
    """Walk the path; returns (residual_cap_index, root) (Hash/Merkle.hs:30-37)."""
    idx = leaf_idx
    cur = leaf_digest
    for sib in siblings:
        cur = compress(cur, sib) if (idx & 1) == 0 else compress(sib, cur)
        idx >>= 1
    return idx, cur


def check_merkle_proof(cap: Sequence[Digest], idx: int, leaf: Sequence[int], siblings: Sequence[Digest]) -> bool:
    """Leaf row is sponge-hashed, path walked, compared to cap[residual]
    (Hash/Merkle.hs:39-42)."""
    root_idx, root = reconstruct_merkle_root(sponge(leaf), idx, siblings)
    return tuple(cap[root_idx]) == tuple(root)
