"""Plonky2's Poseidon-12 permutation over Goldilocks — golden model.

Structure (reference spec Hash/Poseidon.hs:42-101): 4 external rounds,
22 internal rounds, 4 external rounds. Round r consumes
ALL_ROUND_CONSTANTS[12r : 12r+12].

- external round: every lane gets sbox(x + rc), then MDS.
- internal round: lane 0 gets sbox(x0 + rc0); lanes 1..11 get x + rc
  (no sbox), then MDS.
- sbox(x) = x^7; MDS = circulant(MDS_CIRC) + diag(MDS_DIAG).

Includes the embedded known-answer test (KAT): permutation([0..11]).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

from .field import P
from .poseidon_constants import ALL_ROUND_CONSTANTS, MDS_CIRC, MDS_DIAG

WIDTH = 12
N_EXTERNAL = 8  # 4 initial + 4 final
N_INTERNAL = 22
N_ROUNDS = 30

# Permutation of [0..11]; reference Hash/Poseidon.hs:27-35.
KAT_OUTPUT = (
    0xD64E1E3EFC5B8E9E, 0x53666633020AAA47, 0xD40285597C6A8825, 0x613A4F81E81231D2,
    0x414754BFEBD051F0, 0xCB1F8980294A023F, 0x6EB2A9E4D54A9D0F, 0x1902BC3AF467E056,
    0xF045D5EAFDC6021F, 0xE4150F77CAAA3BE5, 0xC9BFD01D39B50CCE, 0x5C0A27FCB0E1459B,
)


@lru_cache(maxsize=None)
def mds_matrix() -> tuple[tuple[int, ...], ...]:
    """M[i][j] = MDS_CIRC[(j - i) mod 12] + (MDS_DIAG[i] if i == j)."""
    return tuple(
        tuple(MDS_CIRC[(j - i) % WIDTH] + (MDS_DIAG[i] if i == j else 0) for j in range(WIDTH))
        for i in range(WIDTH)
    )


def _mds(state: list[int]) -> list[int]:
    m = mds_matrix()
    return [sum(m[i][j] * state[j] for j in range(WIDTH)) % P for i in range(WIDTH)]


def _sbox(x: int) -> int:
    x2 = x * x % P
    x3 = x2 * x % P
    return x3 * x3 % P * x % P  # x^7


def _round_constants(r: int) -> Sequence[int]:
    return ALL_ROUND_CONSTANTS[WIDTH * r : WIDTH * (r + 1)]


def permutation(state: Sequence[int]) -> list[int]:
    s = [x % P for x in state]
    assert len(s) == WIDTH
    for r in range(4):
        rc = _round_constants(r)
        s = _mds([_sbox((x + c) % P) for x, c in zip(s, rc)])
    for r in range(4, 26):
        rc = _round_constants(r)
        s = [(x + c) % P for x, c in zip(s, rc)]
        s[0] = _sbox(s[0])
        s = _mds(s)
    for r in range(26, 30):
        rc = _round_constants(r)
        s = _mds([_sbox((x + c) % P) for x, c in zip(s, rc)])
    return s


def sanity_check() -> bool:
    return tuple(permutation(list(range(12)))) == KAT_OUTPUT
