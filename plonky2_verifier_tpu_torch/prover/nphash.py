"""Vectorized Poseidon-12 / sponge / Merkle trees on numpy (host prover tier).

Hashing dominates fixture generation (a degree_bits=12 commit sponges 2^15
leaf rows and compresses ~2^15 nodes per tree); this module runs the whole
batch through each round at once. Same semantics as the golden model
(Hash/Poseidon.hs:42-101, Hash/Sponge.hs:18-31, Hash/Merkle.hs:21-42), and
the same MDS trick as the TPU kernel (ops/poseidon.py): the circulant
coefficients are <= 49, so each 32-bit half of the state contracts against
the integer matrix exactly in uint64 (12 * 49 * (2^32-1) < 2^41), and the two
widened halves recombine through one 128-bit reduction per lane.

Validated bit-exactly against golden.poseidon (KAT) in tests/test_np_prover.py.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np

from ..golden.poseidon import mds_matrix
from ..golden.poseidon_constants import ALL_ROUND_CONSTANTS
from . import npf

WIDTH = 12
RATE = 8


@lru_cache(maxsize=None)
def _mds() -> np.ndarray:
    return np.asarray(mds_matrix(), dtype=np.uint64)  # (12, 12), entries <= 49


@lru_cache(maxsize=None)
def _rc() -> np.ndarray:
    return np.asarray(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, WIDTH)


def _sbox7(x: np.ndarray) -> np.ndarray:
    x2 = npf.mul(x, x)
    x3 = npf.mul(x2, x)
    x4 = npf.mul(x2, x2)
    return npf.mul(x3, x4)


def _mds_layer(state: np.ndarray) -> np.ndarray:
    m_t = _mds().T  # contract as state @ M^T: out[..., i] = sum_j M[i][j] s[..., j]
    lo = state & npf.M32
    hi = state >> npf.S32
    acc_lo = lo @ m_t  # < 2^41, exact in uint64
    acc_hi = hi @ m_t
    hi64 = acc_hi >> npf.S32  # the 2^64.. overflow word, < 2^9
    lo64 = acc_lo + ((acc_hi & npf.M32) << npf.S32)
    hi64 = hi64 + (lo64 < acc_lo)
    return npf._reduce128(hi64, lo64)


def permutation(state: np.ndarray) -> np.ndarray:
    """Full 30-round Poseidon-12; state (..., 12) uint64 canonical."""
    rc = _rc()
    for r in range(4):
        state = _mds_layer(_sbox7(npf.add(state, rc[r])))
    for r in range(4, 26):
        state = npf.add(state, rc[r])
        state = np.concatenate([_sbox7(state[..., :1]), state[..., 1:]], axis=-1)
        state = _mds_layer(state)
    for r in range(26, 30):
        state = _mds_layer(_sbox7(npf.add(state, rc[r])))
    return state


def sponge_rows(rows: np.ndarray) -> np.ndarray:
    """Overwrite-mode rate-8 sponge over each row; (..., width) -> (..., 4)."""
    width = rows.shape[-1]
    state = np.zeros(rows.shape[:-1] + (WIDTH,), dtype=np.uint64)
    for i in range(0, width, RATE):
        chunk = rows[..., i : i + RATE]
        state = np.concatenate([chunk, state[..., chunk.shape[-1] :]], axis=-1)
        state = permutation(state)
    return state[..., :4]


def compress(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """2-to-1 digest compression; (..., 4) x2 -> (..., 4)."""
    zeros = np.zeros(x.shape[:-1] + (4,), dtype=np.uint64)
    return permutation(np.concatenate([x, y, zeros], axis=-1))[..., :4]


class NpMerkleTree:
    """Merkle tree with caps over a (n_leaves, width) uint64 leaf matrix.

    Same layout contract as prover.merkle.MerkleTree: the caller passes
    leaves already in tree order (bit-reversed row order for LDE matrices);
    `.cap` / `.prove()` return python int tuples for the proof structures."""

    def __init__(self, leaves: np.ndarray, cap_height: int):
        n = leaves.shape[0]
        bits = n.bit_length() - 1
        assert 1 << bits == n, "leaf count must be a power of two"
        assert cap_height <= bits
        self.cap_height = cap_height
        self.n_levels = bits - cap_height
        self.levels: List[np.ndarray] = [sponge_rows(leaves)]
        for _ in range(self.n_levels):
            prev = self.levels[-1]
            self.levels.append(compress(prev[0::2], prev[1::2]))
        self._cap_arr = self.levels[-1]

    @property
    def cap(self) -> List[tuple]:
        return [tuple(d) for d in npf.to_ints(self._cap_arr)]

    def prove(self, leaf_idx: int) -> List[tuple]:
        sibs = []
        i = leaf_idx
        for lvl in self.levels[: self.n_levels]:
            sibs.append(tuple(npf.to_ints(lvl[i ^ 1])))
            i >>= 1
        return sibs
