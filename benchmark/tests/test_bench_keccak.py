"""The reference's Keccak (reference/keccak.py), as Plonky2's
KeccakGoldilocksConfig hashes: Keccak-256's known answers and its original
padding (not SHA3's), the permutation against a second form written here bit
by bit from FIPS 202's step mappings, KeccakHash<25>'s digests and their
words, KeccakPermutation's word filter, a Merkle tree of Keccak digests
walked by fri.merkle_ok, and the yardstick's K counted from the same
constants."""

from __future__ import annotations

import hashlib

import pytest

from reference import keccak
from reference.challenger import Challenger
from reference.field import P
from reference.fri import merkle_ok
from reference.hashing import HASHERS, digest_words

KECCAK = HASHERS["KeccakGoldilocksConfig"]


# --- FIPS 202, bit by bit: a state a[x][y][z], each step as the standard writes it

def _rc_bit(t: int) -> int:
    """FIPS 202 Algorithm 5, rc(t)."""
    if t % 255 == 0:
        return 1
    r = [1, 0, 0, 0, 0, 0, 0, 0]
    for _ in range(t % 255):
        r = [0] + r
        for i in (0, 4, 5, 6):
            r[i] ^= r[8]
        r = r[:8]
    return r[0]


def _bit_round(a, ir: int):
    c = [[a[x][0][z] ^ a[x][1][z] ^ a[x][2][z] ^ a[x][3][z] ^ a[x][4][z] for z in range(64)] for x in range(5)]
    d = [[c[(x - 1) % 5][z] ^ c[(x + 1) % 5][(z - 1) % 64] for z in range(64)] for x in range(5)]
    a = [[[a[x][y][z] ^ d[x][z] for z in range(64)] for y in range(5)] for x in range(5)]
    rho = [[list(a[x][y]) for y in range(5)] for x in range(5)]  # Algorithm 2
    x, y = 1, 0
    for t in range(24):
        rho[x][y] = [a[x][y][(z - (t + 1) * (t + 2) // 2) % 64] for z in range(64)]
        x, y = y, (2 * x + 3 * y) % 5
    pi = [[rho[(x + 3 * y) % 5][x] for y in range(5)] for x in range(5)]  # Algorithm 3
    chi = [[[pi[x][y][z] ^ ((pi[(x + 1) % 5][y][z] ^ 1) & pi[(x + 2) % 5][y][z]) for z in range(64)]
            for y in range(5)] for x in range(5)]
    for j in range(7):  # Algorithm 6, iota
        chi[0][0][2 ** j - 1] ^= _rc_bit(j + 7 * ir)
    return chi


def _bit_sponge(msg: bytes, suffix: list) -> bytes:
    """Keccak[c = 512] over `msg`'s bits (least significant bit of each byte
    first), `suffix`, then pad10*1 to whole blocks of 1088 bits; 256 bits out."""
    bits = [(byte >> i) & 1 for byte in msg for i in range(8)] + suffix
    pad = -(len(bits) + 2) % 1088
    bits += [1] + [0] * pad + [1]
    s = [0] * 1600
    for i in range(0, len(bits), 1088):
        s = [s[k] ^ (bits[i + k] if k < 1088 else 0) for k in range(1600)]
        a = [[[s[64 * (5 * y + x) + z] for z in range(64)] for y in range(5)] for x in range(5)]
        for ir in range(24):
            a = _bit_round(a, ir)
        s = [a[x][y][z] for y in range(5) for x in range(5) for z in range(64)]
    return bytes(sum(s[8 * i + j] << j for j in range(8)) for i in range(32))


LENGTHS = [0, 135, 136, 137, 272]


def _message(n: int) -> bytes:
    return bytes((7 * i + 3) % 256 for i in range(n))


def test_keccak256_known_answers():
    assert keccak.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert hashlib.sha3_256(b"").digest() != keccak.keccak256(b"")  # SHA3 pads with 0x06


@pytest.mark.parametrize("n", LENGTHS)
def test_keccak256_against_fips_202_bit_by_bit(n):
    msg = _message(n)
    # the bit form with SHA3's suffix 01 is hashlib's SHA3-256, so the bit form is FIPS 202's
    assert _bit_sponge(msg, [0, 1]) == hashlib.sha3_256(msg).digest()
    assert keccak._sponge(msg, 0x06) == hashlib.sha3_256(msg).digest()
    assert keccak.keccak256(msg) == _bit_sponge(msg, [])


@pytest.mark.parametrize("n, blocks", zip(LENGTHS, [1, 1, 2, 2, 3]))
def test_a_keccak_f_call_an_absorbed_block(n, blocks):
    before = keccak.Counter.permutations
    keccak.keccak256(_message(n))
    assert keccak.Counter.permutations - before == blocks


def test_digest_words_pack_seven_bytes_and_round_trip():
    digest = bytes(range(200, 225))
    words = keccak.to_vec(digest)
    assert words == [int.from_bytes(digest[i:i + 7], "little") for i in (0, 7, 14)] + [int.from_bytes(digest[21:], "little")]
    assert all(w < 2 ** 56 < P for w in words)
    assert b"".join(w.to_bytes(7, "little") for w in words[:3]) + words[3].to_bytes(4, "little") == digest
    assert digest_words(digest) == words and digest_words([1, 2, 3, 4]) == [1, 2, 3, 4]


def test_hash_or_noop_keeps_three_words_and_hashes_four():
    three = [1, P - 1, 2 ** 40 + 5]
    assert keccak.hash_or_noop(three) == b"".join(w.to_bytes(8, "little") for w in three) + b"\0"
    four = three + [P + 9]  # non-canonical: hashed as 9
    canonical = b"".join(w.to_bytes(8, "little") for w in three + [9])
    assert keccak.hash_or_noop(four) == keccak.hash_no_pad(three + [9]) == keccak.keccak256(canonical)[:25]
    assert keccak.two_to_one(keccak.hash_or_noop(three), keccak.hash_or_noop(four)) == keccak.keccak256(
        keccak.hash_or_noop(three) + keccak.hash_or_noop(four))[:25]


def test_permutation_drops_words_at_or_above_p():
    def out(*words):
        return b"".join(w.to_bytes(8, "little") for w in words)

    stream = [out(P, 5, 2 ** 64 - 1, P - 1), out(0, P + 1, 7, 9)]
    assert list(keccak.words_below_p(stream)) == [5, P - 1, 0, 7, 9]

    state = list(range(3, 15))
    outputs = [keccak.keccak256(out(*state))]
    while len(list(keccak.words_below_p(outputs))) < 12:
        outputs.append(keccak.keccak256(outputs[-1]))
    before = keccak.Counter.permutations
    assert keccak.permute(state) == list(keccak.words_below_p(outputs))[:12]
    assert keccak.Counter.permutations - before == len(outputs)  # the onion stops once 12 words are kept


def test_challenger_duplexes_with_keccak_and_observes_digest_words():
    digest = keccak.hash_no_pad(range(10))
    a, b = Challenger(keccak.permute), Challenger(keccak.permute)
    a.observe_cap([digest])
    b.observe_all(keccak.to_vec(digest))
    assert a.challenges(9) == b.challenges(9)
    c = Challenger(keccak.permute)
    c.observe_all(keccak.to_vec(digest))
    state = [0] * 12
    state[:4] = keccak.to_vec(digest)
    assert c.challenge() == keccak.permute(state)[7]  # the last of the 8 outputs


def _tree(leaves, cap_height):
    """Plonky2's MerkleTree of Keccak digests: (cap, every leaf's siblings)."""
    layers = [[keccak.hash_or_noop(leaf) for leaf in leaves]]
    while len(layers[-1]) > 2 ** cap_height:
        prev = layers[-1]
        layers.append([keccak.two_to_one(prev[i], prev[i + 1]) for i in range(0, len(prev), 2)])
    paths = [[layer[(i >> level) ^ 1] for level, layer in enumerate(layers[:-1])] for i in range(len(leaves))]
    return layers[-1], paths


@pytest.mark.parametrize("cap_height", [0, 2])
def test_merkle_paths_of_keccak_digests(cap_height):
    leaves = [[(31 * i + k) % P for k in range(1 + i % 6)] for i in range(16)]  # 1-6 words: noop and hashed leaves
    cap, paths = _tree(leaves, cap_height)
    assert len(cap) == 2 ** cap_height and all(len(p) == 4 - cap_height for p in paths)
    for i, (leaf, path) in enumerate(zip(leaves, paths)):
        assert merkle_ok(KECCAK, leaf, i, path, cap)
    flipped = bytearray(paths[5][0])
    flipped[24] ^= 1
    assert not merkle_ok(KECCAK, leaves[5], 5, [bytes(flipped)] + paths[5][1:], cap)
    bad_cap = list(cap)
    bad_cap[5 >> (4 - cap_height)] = bytes([cap[5 >> (4 - cap_height)][0] ^ 0x80]) + cap[5 >> (4 - cap_height)][1:]
    assert not merkle_ok(KECCAK, leaves[5], 5, paths[5], bad_cap)
    assert not merkle_ok(KECCAK, leaves[5], 6, paths[5], cap)


def test_k_is_counted_from_the_permutations_constants():
    """yardstick.K: round 1 on the sparsest block 126, rounds 2-23 178 + the
    round constant's non-zero halves, round 24 for a digest's 25 bytes 57;
    rho rotates 24 lanes, none by a multiple of 32, and row 0 of chi reads
    the 5 diagonal lanes, 4 of them rotated."""
    import yardstick

    halves = [(rc >> 32 != 0) + (rc & 0xFFFFFFFF != 0) for rc in keccak.ROUND_CONSTANTS]
    assert (sum(halves), halves[0], halves[23]) == (37, 1, 2)
    assert sum(r % 32 != 0 for r in keccak.ROTATIONS) == 24 and keccak.ROTATIONS[0] == 0
    diagonal = [x + 5 * x for x in range(5)]
    assert sorted(keccak.PI_SOURCE[:5]) == diagonal and sum(keccak.ROTATIONS[i] != 0 for i in diagonal) == 4
    theta, rho, chi = 5 * 2 * 2 + 5 * 2 + 25 * 2, 24 * 2, 25 * 2
    assert theta + rho + chi == 178
    first = 27 + rho + chi + halves[0]
    last = (5 * 2 * 2 + 5 * 2 + 5 * 2) + 4 * 2 + (3 * 2 + 1) + halves[23]
    assert (first, last) == (126, 57)
    assert yardstick.K_INSTRUCTIONS == first + sum(178 + h for h in halves[1:23]) + last == 4133
    assert abs(yardstick.SECONDS_A_KECCAK - 2.4708e-10) < 1e-14
