"""Merkle tree building with caps (prover side).

Leaves are *rows* (vectors of felts), sponge-hashed; the tree stops at the
cap layer (2^cap_height roots). Leaf order: the caller passes leaves already
in tree order (for LDE matrices that means bit-reversed row order, per
commentary/FRI.md "the leaves are reordered by reversing the bits of the
index").
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..golden.hashing import Digest, compress, sponge


class MerkleTree:
    def __init__(self, leaves: Sequence[Sequence[int]], cap_height: int):
        n = len(leaves)
        bits = n.bit_length() - 1
        assert 1 << bits == n, "leaf count must be a power of two"
        assert cap_height <= bits
        self.cap_height = cap_height
        self.n_levels = bits - cap_height  # levels below the cap
        self.levels: List[List[Digest]] = [[sponge(l) for l in leaves]]
        for _ in range(self.n_levels):
            prev = self.levels[-1]
            self.levels.append([compress(prev[i], prev[i + 1]) for i in range(0, len(prev), 2)])
        self.cap: List[Digest] = self.levels[-1]

    def prove(self, leaf_idx: int) -> List[Digest]:
        sibs = []
        i = leaf_idx
        for lvl in self.levels[: self.n_levels]:
            sibs.append(lvl[i ^ 1])
            i >>= 1
        return sibs
