"""Keccak over Goldilocks words, as Plonky2's KeccakGoldilocksConfig hashes:

- Keccak-f[1600] and Keccak-256 with the original Keccak padding (a 0x01
  byte after the message, 0x80 into the last byte of its block, rate 136
  bytes), as the `keccak-hash` crate that plonky2/src/hash/keccak.rs calls
  computes it. FIPS 202's SHA3-256 pads with 0x06 and gives other digests;
  Python's `hashlib.sha3_256` is that, and is not used here;
- `KeccakHash<25>` (hash/keccak.rs): `hash_no_pad` (each element's
  canonical u64 in little-endian, Keccak-256, the first 25 bytes),
  `hash_or_noop` (the Hasher trait's default: inputs of at most 25 bytes are
  their own bytes, zero-padded to 25) and `two_to_one` (Keccak-256 of the
  left 25 bytes and the right 25, cut to 25 bytes);
- `to_vec` (hash/hash_types.rs `BytesHash::to_vec`): the 25 bytes in
  little-endian chunks of 7, 4 words, as a transcript observes a digest;
- `permute` (hash/keccak.rs `KeccakPermutation::permute`): the challenger's
  pseudo-permutation of 12 words: their 96 canonical bytes through
  Keccak-256, then each 32-byte output through Keccak-256 in turn, each
  output read as 4 little-endian u64 words, every word >= p dropped, the
  first 12 kept.

A digest is `bytes` of length 25.
"""

from __future__ import annotations

from .field import P

HASH_SIZE = 25
RATE_BYTES = 136
MASK = (1 << 64) - 1

# Keccak-f[1600]'s 24 round constants (iota)
ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008)

# rho's rotation of lane x + 5 y
ROTATIONS = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14)

# pi: lane x + 5 y moves to lane y + 5 ((2 x + 3 y) % 5); PI_SOURCE[i] is the lane that moves to i
PI_SOURCE = tuple(sorted(range(25), key=lambda i: (i // 5) + 5 * ((2 * (i % 5) + 3 * (i // 5)) % 5)))


class Counter:
    """Counts the Keccak-f[1600] calls made through it (the yardstick reads
    this): one an absorbed block."""

    permutations = 0


def _rot(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & MASK if r else x


def keccak_f(a: list) -> list:
    """Keccak-f[1600] on 25 lanes of 64 bits (lane x + 5 y)."""
    Counter.permutations += 1
    a = list(a)
    for rc in ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rot(c[(x + 1) % 5], 1) for x in range(5)]
        b = [_rot(a[j] ^ d[j % 5], ROTATIONS[j]) for j in PI_SOURCE]
        a = [b[i] ^ (~b[i - i % 5 + (i + 1) % 5] & b[i - i % 5 + (i + 2) % 5]) for i in range(25)]
        a[0] ^= rc
    return a


def _sponge(data: bytes, suffix: int = 0x01) -> bytes:
    """32 bytes of a Keccak sponge of rate 136 bytes: `suffix` after the
    message (0x01: Keccak's padding; 0x06: SHA3's), 0x80 into its block's
    last byte."""
    padded = bytearray(data) + bytes([suffix]) + bytes(-(len(data) + 1) % RATE_BYTES)
    padded[-1] |= 0x80
    state = [0] * 25
    for i in range(0, len(padded), RATE_BYTES):
        block = padded[i:i + RATE_BYTES]
        for j in range(RATE_BYTES // 8):
            state[j] ^= int.from_bytes(block[8 * j:8 * j + 8], "little")
        state = keccak_f(state)
    return b"".join(w.to_bytes(8, "little") for w in state[:4])


def keccak256(data: bytes) -> bytes:
    return _sponge(data)


def _word_bytes(words) -> bytes:
    return b"".join((int(w) % P).to_bytes(8, "little") for w in words)


def hash_no_pad(words) -> bytes:
    return keccak256(_word_bytes(words))[:HASH_SIZE]


def hash_or_noop(words) -> bytes:
    words = list(words)
    if 8 * len(words) <= HASH_SIZE:
        return _word_bytes(words).ljust(HASH_SIZE, b"\0")
    return hash_no_pad(words)


def two_to_one(left: bytes, right: bytes) -> bytes:
    return keccak256(bytes(left) + bytes(right))[:HASH_SIZE]


def to_vec(digest: bytes) -> list:
    return [int.from_bytes(digest[i:i + 7], "little") for i in range(0, len(digest), 7)]


def words_below_p(outputs):
    """The words of each 32-byte output in turn, every word >= p dropped."""
    for out in outputs:
        for i in range(0, 32, 8):
            w = int.from_bytes(out[i:i + 8], "little")
            if w < P:
                yield w


def _onion(state: list):
    out = keccak256(_word_bytes(state))
    while True:
        yield out
        out = keccak256(out)


def permute(state) -> list:
    """KeccakPermutation::permute of 12 field elements."""
    words = words_below_p(_onion(list(state)))
    return [next(words) for _ in range(len(state))]
