"""Port Poseidon ops (plain permutation, sponge, row sponge, Merkle walk)
against the JAX package's CPU path and the golden model.

The JAX side runs as its own suite runs it on the CPU: `_permutation_jnp`,
`verifier_jax.sponge_rows` and `JaxVerifier._merkle_batched` with
P2V_FUSED_HASH unset (no Pallas). Inputs come from numpy seeds and feed
both. Tolerance: bit-exact (integer arithmetic)."""

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu.golden import field as gf
from plonky2_verifier_tpu.golden import hashing as gh
from plonky2_verifier_tpu.golden import poseidon as gp
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu.ops import poseidon as jp
from plonky2_verifier_tpu.verifier_jax import JaxVerifier
from plonky2_verifier_tpu.verifier_jax import sponge_rows as jax_sponge_rows
from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops import hash as th
from plonky2_verifier_tpu_torch.ops import poseidon as tp
from plonky2_verifier_tpu_torch.verifier_torch import merkle_batched
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

P = gf.P
EDGE = np.array([0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P, 2**64 - 1], dtype=np.uint64)


@pytest.fixture(scope="module")
def consts():
    return tp.PoseidonConstants("cpu")


@pytest.fixture(autouse=True)
def _unfused(monkeypatch):
    monkeypatch.delenv("P2V_FUSED_HASH", raising=False)
    monkeypatch.setenv("P2V_POSEIDON_BACKEND", "jnp")


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_permutation_kat(consts):
    out = tp.permutation_plain(tf.from_u64(np.arange(12, dtype=np.uint64), "cpu"), consts)
    assert tuple(int(x) for x in tf.to_u64(out)) == gp.KAT_OUTPUT


def test_permutation_random_and_edge_vs_jax(consts):
    rng = np.random.default_rng(1)
    edge_states = EDGE[rng.integers(0, len(EDGE), size=(32, 12))]
    states = np.concatenate([_rand(2, (64, 12)), np.repeat(EDGE[:, None], 12, axis=1), edge_states])
    got = tf.to_u64(tp.permutation_plain(tf.from_u64(states, "cpu"), consts))
    np.testing.assert_array_equal(got, jf.to_u64(jp._permutation_jnp(jf.from_u64(states))))
    for i in range(0, len(states), 17):
        assert [int(x) for x in got[i]] == gp.permutation([int(x) for x in states[i]])


@pytest.mark.parametrize("width", [0, 1, 3, 8, 9, 20, 32, 135])
def test_sponge_rows_vs_jax(consts, width):
    rows = _rand(100 + width, (2, 3, width))
    got = tf.to_u64(th.sponge_rows_plain(tf.from_u64(rows, "cpu"), width, consts))
    np.testing.assert_array_equal(got, jf.to_u64(jax_sponge_rows(jf.from_u64(rows), width)))
    np.testing.assert_array_equal(got, tf.to_u64(tp.sponge(tf.from_u64(rows, "cpu"), width, consts)))
    np.testing.assert_array_equal(got, tf.to_u64(th.sponge_rows(tf.from_u64(rows, "cpu"), width, consts)))
    flat_rows, flat_got = rows.reshape(6, width), got.reshape(6, 4)
    for i in range(2):
        assert tuple(int(x) for x in flat_got[i]) == gh.sponge([int(x) for x in flat_rows[i]])


GROUP_SHAPES = [(2, 3, 135), (5, 20), (1, 4, 32), (3, 0), (0, 8), (7, 9)]


@pytest.mark.parametrize("k", range(len(GROUP_SHAPES)), ids=[str(s) for s in GROUP_SHAPES])
def test_sponge_rows_grouped_vs_jax(consts, k):
    """Matrices of mixed widths (and leading axes) through the grouped entry
    point on the CPU: matrix k equals its own sponge_rows_plain and the JAX
    sponge_rows reference, whatever else is in the group."""
    group = [tf.from_u64(_rand(200 + i, shape), "cpu") for i, shape in enumerate(GROUP_SHAPES)]
    got = th.sponge_rows_grouped(group, consts)
    plain = th.sponge_rows_grouped_plain(group, consts)
    assert len(got) == len(plain) == len(group)
    rows, width = group[k], GROUP_SHAPES[k][-1]
    assert got[k].shape == rows.shape[:-1] + (4,)
    assert torch.equal(got[k], plain[k])
    assert torch.equal(got[k], th.sponge_rows_plain(rows, width, consts))
    want = jf.to_u64(jax_sponge_rows(jf.from_u64(tf.to_u64(rows)), width))
    np.testing.assert_array_equal(tf.to_u64(got[k]), want)


def _merkle_case(seed, n, path_len, cap_len=4):
    """Random digests, indices (bits above path_len set) and siblings, and
    caps that hold the true root for even rows and a wrong one for odd rows."""
    index = np.random.default_rng(seed).integers(0, cap_len << path_len, size=n, dtype=np.int64)
    return _rand(seed, (n, 4)), index, _rand(seed + 1, (n, path_len, 4)), _rand(seed + 2, (n, cap_len, 4))


@pytest.mark.parametrize("path_len", [0, 3, 11])
def test_merkle_fold_vs_golden_and_jax(consts, path_len):
    n = 6
    digest, index, sibs, cap = _merkle_case(7 + path_len, n, path_len)
    root = tf.to_u64(
        th.merkle_fold_plain(tf.from_u64(digest, "cpu"), torch.from_numpy(index), tf.from_u64(sibs, "cpu"), path_len, consts)
    )
    for i in range(n):
        res, want = gh.reconstruct_merkle_root(
            tuple(int(x) for x in digest[i]), int(index[i]), [tuple(int(x) for x in s) for s in sibs[i]]
        )
        assert tuple(int(x) for x in root[i]) == want
        if i % 2 == 0:
            cap[i, res] = root[i]
    # the verifier's cap check, port against JAX, on true and wrong roots
    ok_jax = np.asarray(
        JaxVerifier._merkle_batched(
            jf.from_u64(digest), np.asarray(index, dtype=np.uint32), jf.from_u64(sibs), jf.from_u64(cap), path_len
        )
    )
    ok_torch = merkle_batched(
        tf.from_u64(digest, "cpu"), torch.from_numpy(index), tf.from_u64(sibs, "cpu"), tf.from_u64(cap, "cpu"), path_len, consts
    ).numpy()
    np.testing.assert_array_equal(ok_torch, ok_jax)
    np.testing.assert_array_equal(ok_torch, np.arange(n) % 2 == 0)


def test_compress_and_verify_merkle_path(consts):
    digest, index, sibs, cap = _merkle_case(31, 4, 3)
    x, y = _rand(40, (4, 4)), _rand(41, (4, 4))
    got = tf.to_u64(tp.compress(tf.from_u64(x, "cpu"), tf.from_u64(y, "cpu"), consts))
    for i in range(4):
        assert tuple(int(v) for v in got[i]) == gh.compress(tuple(int(v) for v in x[i]), tuple(int(v) for v in y[i]))
    root = th.merkle_fold_plain(tf.from_u64(digest, "cpu"), torch.from_numpy(index), tf.from_u64(sibs, "cpu"), 3, consts)
    residual = index >> 3
    cap[np.arange(4), residual] = tf.to_u64(root)
    cap[1, residual[1], 0] ^= np.uint64(1)
    ok = tp.verify_merkle_path(tf.from_u64(digest, "cpu"), torch.from_numpy(index), tf.from_u64(sibs, "cpu"), tf.from_u64(cap, "cpu"), 3, consts)
    ok_jax = jp.verify_merkle_path(
        jf.from_u64(digest), np.asarray(index, dtype=np.uint32), jf.from_u64(sibs), jf.from_u64(cap), 3
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_jax))
    assert ok.tolist() == [True, False, True, True]


@pytest.mark.parametrize("batch", [1, 3])
def test_permutation_scan_plain_vs_golden(consts, batch):
    """The transcript scan's plain loop: from a zero state, each step
    overwrites the masked lanes from the data row, permutes and records."""
    rng = np.random.default_rng(60 + batch)
    n_perms, n_data = 5, 23
    ov_idx = rng.integers(0, n_data, size=(n_perms, 12), dtype=np.int64)
    ov_mask = rng.integers(0, 3, size=(n_perms, 12)) == 0
    data = _rand(61 + batch, (batch, n_data))
    data[0, :3] = EDGE[-3:]  # proof words need not be canonical
    got = tf.to_u64(tp.permutation_scan_plain(tf.from_u64(data, "cpu"), torch.from_numpy(ov_idx), torch.from_numpy(ov_mask), consts))
    assert got.shape == (n_perms, batch, 12)
    for b in range(batch):
        state = [0] * 12
        for step in range(n_perms):
            state = gp.permutation([int(data[b, i]) if m else s for i, m, s in zip(ov_idx[step], ov_mask[step], state)])
            assert [int(x) for x in got[step, b]] == state
    empty = tp.permutation_scan_plain(tf.from_u64(data, "cpu"), torch.zeros((0, 12), dtype=torch.int64), torch.zeros((0, 12), dtype=torch.bool), consts)
    assert empty.shape == (0, batch, 12)


def test_folded_round_constants_give_the_same_permutation():
    """The kernels' tables (kernels.folded_round_constants): round 0's
    constants up front, every later constant started from inside the
    previous round's MDS sums, the partial rounds' lanes 1-11 carried through
    the MDS to the last full rounds. In Python ints, against golden/."""
    pre, post = kernels.folded_round_constants()
    assert len(pre) == 12 and len(post) == 30 and all(len(row) == 12 for row in post)
    assert all(0 <= c < P for row in [pre] + post for c in row)
    assert all(row[1:] == [0] * 11 for row in post[3:25]) and post[29] == [0] * 12
    mds = gp.mds_matrix()
    rng = np.random.default_rng(70)
    for state in [list(range(12))] + [[int(x) for x in row] for row in rng.integers(0, P, size=(8, 12), dtype=np.uint64)]:
        s = [(x + c) % P for x, c in zip(state, pre)]
        for r in range(30):
            s = [gp._sbox(x) for x in s] if r < 4 or r >= 26 else [gp._sbox(s[0])] + s[1:]
            s = [(sum(mds[i][j] * s[j] for j in range(12)) + post[r][i]) % P for i in range(12)]
        assert s == gp.permutation(state)


# A word-level model of the thread form of csrc/poseidon.cuh: the phase
# schedule of `permute` (4 full rounds; the partial rounds in Plonky2's sparse
# form: the initial matrix, 22 sparse rounds, the carried constants; rounds
# 26-28; round 29 without constants), the dense MDS rows as two sums of 32-bit
# halves, `join_halves`, `mul_mod`, `mul_add_mod` and the sparse rows' `Dot`
# step by step, each asserting the range its comment in the header claims.
# The dense schedule beside it is the split form's (its tables,
# kernels.folded_round_constants), in the same word arithmetic.
M64, M32, EPS = 2**64, 2**32 - 1, 2**32 - 1


def _header_list(name):
    """The integers of csrc/poseidon.cuh's `#define <name> a, b, ...`."""
    import os
    import re

    with open(os.path.join(kernels.CSRC, "poseidon.cuh")) as f:
        (line,) = re.findall(rf"^#define {name} (.*)$", f.read(), flags=re.M)
    return tuple(int(x) for x in line.split(","))


def _reduce_model(prod):
    """mul_mod's tail on the 128-bit (r3, r2, r1, r0)."""
    assert prod < 2**128
    lo, r2, r3 = prod % M64, (prod >> 64) & M32, prod >> 96
    t = lo - r3
    if t < 0:  # on a borrow the wrapped t is at least 2^64 - 2^32 + 1
        t += M64
        assert t >= M64 - 2**32 + 1
        t -= EPS
    u = t + r2 * EPS
    k, u = u >> 64, u % M64
    assert u + k * EPS < M64  # adding k (2^32 - 1) back cannot carry
    return u + k * EPS


def _mul_mod_model(a, b):
    return _reduce_model(a * b)  # (r3, r2, r1, r0), four partial products


def _mul_add_model(y, v, a):
    """mul_add_mod: a as the addend of the first product; y v + a < 2^128."""
    assert y < M64 and v < M64 and a < M64
    return _reduce_model(y * v + a)


def _add_rc_model(x, c):
    assert c < P  # one canonical operand: on a carry the wrapped sum is at most p - 2
    x += c
    return x - M64 + EPS if x >= M64 else x


def _sbox_model(x):
    x2 = _mul_mod_model(x, x)
    return _mul_mod_model(_mul_mod_model(x2, x), _mul_mod_model(x2, x2))


def _join_model(acc_lo, acc_hi):
    h, m = acc_hi >> 32, acc_hi & M32
    u = acc_lo + h * EPS
    assert u < M64  # the room the folded constants leave
    high = (u >> 32) + m
    k = high >> 32
    u = (u & M32) | ((high & M32) << 32)
    assert u + k * EPS < M64
    return u + k * EPS


def _mds_model(s, c, rows, n_const):
    circ, diag = _header_list("P2V_MDS_CIRC"), _header_list("P2V_MDS_DIAG")
    out = list(s)
    for i in range(rows):
        acc_lo, acc_hi = (c[i] if i < n_const else 0), 0
        for coef, x in [(diag[i], s[i])] + [(circ[t], s[(i + t) % 12]) for t in range(12)]:
            acc_lo += coef * (x & M32)
            acc_hi += coef * (x >> 32)
        assert acc_lo < M64 and acc_hi < 2**41
        out[i] = _join_model(acc_lo, acc_hi)
    return out


def _dot_model(terms, start=0, y=0, m=0):
    """dot_start (start + m y), dot_term a term, dot_reduce: A and B exact,
    their top words (a4, b2) counting the carries out."""
    assert start < M64 and y < M64 and m < 2**32 and len(terms) <= 11
    a, b = start + m * (y & M32), m * (y >> 32)
    assert a < 2**96 and b < M64  # dot_start: a2 takes the one carry, B is one product
    for x, w in terms:
        assert x < M64 and w < M64
        a += (x & M32) * (w & M32) + ((x >> 32) * (w >> 32) << 64)
        b += (x & M32) * (w >> 32) + (x >> 32) * (w & M32)
    assert a < 13 * 2**128 and b < 24 * 2**64  # a4 and b2 (each a 32-bit word) hold the carries
    t = a + (b << 32)  # (t4, t3, t2, t1, a0)
    t0, t1, t2, h = t & M32, (t >> 32) & M32, (t >> 64) & M32, t >> 96
    assert h < 13 * 2**32
    u = t0 + (t1 << 32) - h
    if u < 0:  # on a borrow the wrapped difference leaves room to take 2^32 - 1
        u += M64
        assert u >= M64 - 13 * 2**32
        u -= EPS
    u += t2 * EPS
    k, u = u >> 64, u % M64
    assert u + k * EPS < M64
    return u + k * EPS


def _first_constants_model(state, pre, zero_cap):
    # the zero lanes of a compression start at their constant
    return [c if zero_cap and k >= 8 else _add_rc_model(x, c) for k, (x, c) in enumerate(zip(state, pre))]


def _partial_rounds_model(s, t):
    """partial_rounds: the initial matrix, the 22 sparse rounds, add_tail."""
    m00 = _header_list("P2V_MDS_CIRC")[0] + _header_list("P2V_MDS_DIAG")[0]
    s = [s[0]] + [_dot_model(list(zip(s[1:], t["init"][c]))) for c in range(11)]
    for r in range(22):
        y = _sbox_model(s[0])
        row0 = _dot_model(list(zip(s[1:], t["w_hat"][r])), t["row0"][r][0], y, m00)
        s = [row0] + [_mul_add_model(y, v, x) for x, v in zip(s[1:], t["vs"][r])]
    return [s[0]] + [_add_rc_model(x, c) for x, c in zip(s[1:], t["tail"][0])]


def _permute_model(state, zero_cap=False, keep=12):
    """permute<zero_cap, keep> of csrc/poseidon.cuh (the thread form);
    returns lanes 0 .. keep - 1."""
    pre, _ = kernels.folded_round_constants()
    t = kernels.sparse_round_tables()
    s = _first_constants_model(state, pre, zero_cap)
    for f in range(2 * 4 + 1):
        if f == 4:
            s = _partial_rounds_model(s, t)
            continue
        s = [_sbox_model(x) for x in s]
        if f == 8:
            break
        s = _mds_model(s, t["full"][f if f < 4 else f - 1], 12, 12)
    s = _mds_model(s, None, keep, 0)  # round 29 reads no constant
    assert all(x < M64 for x in s)
    return [x - P if x >= P else x for x in s[:keep]]


def _permute_dense_model(state, zero_cap=False, keep=12):
    """The dense schedule the split form runs on kernels.folded_round_constants
    (every partial round a full MDS, lanes 1-11's constants carried to round
    25), in the same word arithmetic; returns lanes 0 .. keep - 1."""
    pre, post = kernels.folded_round_constants()
    s = _first_constants_model(state, pre, zero_cap)
    for f in range(2 * 4 + 1):
        if f == 4:
            for r in range(4, 25):
                s[0] = _sbox_model(s[0])
                assert post[r][1:] == [0] * 11  # rows 1-11 read no constant
                s = _mds_model(s, post[r], 12, 1)
            s[0] = _sbox_model(s[0])
        else:
            s = [_sbox_model(x) for x in s]
        if f == 8:
            break
        s = _mds_model(s, post[f if f < 4 else f + 21], 12, 12)
    assert post[29] == [0] * 12  # round 29 reads no constant
    s = _mds_model(s, None, keep, 0)
    assert all(x < M64 for x in s)
    return [x - P if x >= P else x for x in s[:keep]]


EDGE_LANES = [0, 1, P - 1, P, 2**64 - 1]
SCHEDULE_STATES = [("random", None)] + [(f"every lane {w:#x}", w) for w in EDGE_LANES] + [("edge band", "band")]


def _schedule_states(word):
    rng = np.random.default_rng(80)
    if word is None:
        return [[int(x) for x in row] for row in rng.integers(0, P, size=(3, 12), dtype=np.uint64)]
    if word == "band":
        return [[int(x) for x in row] for row in EDGE[rng.integers(0, len(EDGE), size=(3, 12))]]
    return [[word] * 12]


def _holds_golden(model, word):
    for state in _schedule_states(word):
        assert model(state) == gp.permutation(state)
        cap = state[:8] + [0] * 4
        assert model(cap, zero_cap=True, keep=4) == gp.permutation(cap)[:4]


@pytest.mark.parametrize("what,word", SCHEDULE_STATES, ids=[w for w, _ in SCHEDULE_STATES])
def test_round_body_schedule_model_equals_golden(what, word):
    """The model of the thread form's schedule and word arithmetic (the
    sparse partial rounds) gives golden's permutation, on random states, on
    one edge word in every lane and on mixed edge words; as a 2-to-1
    compression (lanes 8-11 zero, rows 0-3 of the last MDS) it gives
    golden's first four lanes."""
    _holds_golden(_permute_model, word)


@pytest.mark.parametrize("what,word", SCHEDULE_STATES, ids=[w for w, _ in SCHEDULE_STATES])
def test_dense_schedule_model_equals_golden(what, word):
    """The dense schedule on the split form's tables, in the same word
    arithmetic, gives golden's permutation and compression on the same
    states."""
    _holds_golden(_permute_dense_model, word)


@pytest.mark.parametrize("what,word", SCHEDULE_STATES, ids=[w for w, _ in SCHEDULE_STATES])
def test_sparse_round_tables_give_the_same_permutation(what, word):
    """The thread form's tables exactly as kernels.py uploads them
    (kernels.sparse_round_tables, one array in kernels.sparse_table_words'
    order): in Python ints, the four full rounds from round 0's constants
    and "full", the initial matrix, 22 sparse rounds from "row0", "w_hat"
    and "vs", the carried "tail", the last four full rounds, give golden's
    permutation. The tables taken unchanged equal Plonky2's FAST_PARTIAL_*."""
    from plonky2_verifier_tpu_torch.golden import poseidon_constants as pc

    pre, _ = kernels.folded_round_constants()
    t = kernels.sparse_round_tables()
    words = kernels.sparse_table_words(t)
    assert len(words) == 722 and all(0 <= c < P for c in words)
    assert t["w_hat"] == [list(r) for r in pc.FAST_PARTIAL_ROUND_W_HATS]
    assert t["vs"] == [list(r) for r in pc.FAST_PARTIAL_ROUND_VS]
    assert t["init"] == [list(r) for r in zip(*pc.FAST_PARTIAL_ROUND_INITIAL_MATRIX)]
    assert t["full"][3] == list(pc.FAST_PARTIAL_FIRST_ROUND_CONSTANT)
    mds = gp.mds_matrix()
    dense = lambda s, c: [(sum(mds[i][j] * s[j] for j in range(12)) + c[i]) % P for i in range(12)]
    for state in _schedule_states(word):
        s = [(x + c) % P for x, c in zip(state, pre)]
        for f in range(4):
            s = dense([gp._sbox(x) for x in s], t["full"][f])
        s = [s[0]] + [sum(w * x for w, x in zip(t["init"][c], s[1:])) % P for c in range(11)]
        for r in range(22):
            y = gp._sbox(s[0])
            s = [(mds[0][0] * y + sum(w * x for w, x in zip(t["w_hat"][r], s[1:])) + t["row0"][r][0]) % P] + [
                (x + y * v) % P for x, v in zip(s[1:], t["vs"][r])
            ]
        s = [s[0]] + [(x + c) % P for x, c in zip(s[1:], t["tail"][0])]
        for f in range(4, 8):
            s = dense([gp._sbox(x) for x in s], t["full"][f] if f < 7 else [0] * 12)
        assert s == gp.permutation(state)


def test_header_mds_constants_equal_golden():
    """csrc/poseidon.cuh's compile-time MDS matrix is Plonky2's."""
    from plonky2_verifier_tpu_torch.golden.poseidon_constants import MDS_CIRC, MDS_DIAG

    assert _header_list("P2V_MDS_CIRC") == tuple(MDS_CIRC)
    assert _header_list("P2V_MDS_DIAG") == tuple(MDS_DIAG)
    mds = gp.mds_matrix()
    circ, diag = _header_list("P2V_MDS_CIRC"), _header_list("P2V_MDS_DIAG")
    assert all(mds[i][j] == circ[(j - i) % 12] + (diag[i] if i == j else 0) for i in range(12) for j in range(12))


def test_folded_constants_leave_the_join_its_room():
    """kernels.check_round_body_bounds: every folded constant below
    JOIN_LIMIT (the row's low sum starts from the whole constant), and a
    table with one constant at the limit refused."""
    pre, post = kernels.folded_round_constants()
    kernels.check_round_body_bounds(post)
    assert max(c for row in post for c in row) < kernels.JOIN_LIMIT
    bad = [list(row) for row in post]
    bad[7][3] = kernels.JOIN_LIMIT
    with pytest.raises(ValueError, match="JOIN_LIMIT"):
        kernels.check_round_body_bounds(bad)


def test_sparse_tables_leave_the_accumulators_their_room():
    """kernels.check_sparse_bounds accepts today's tables and refuses one
    planted word at each range's limit: a full round's constant at
    JOIN_LIMIT, a tail constant at p (add_rc's canonical operand), a W_HAT
    at 2^64 (a 64-bit multiplicand), a row of the wrong length."""
    t = kernels.sparse_round_tables()
    kernels.check_sparse_bounds(t)
    for name, row, col, word, match in [("full", 5, 7, kernels.JOIN_LIMIT, "JOIN_LIMIT"), ("tail", 0, 10, P, "canonical"),
                                        ("w_hat", 13, 4, 2**64, "outside"), ("init", 3, None, None, "is not")]:
        bad = {k: [list(r) for r in v] for k, v in t.items()}
        if col is None:
            bad[name][row].pop()
        else:
            bad[name][row][col] = word
        with pytest.raises(ValueError, match=match):
            kernels.check_sparse_bounds(bad)
    assert max(t["tail"][0]) < P and max(c for row in t["full"] for c in row) < kernels.JOIN_LIMIT


def test_sparse_tables_upload_in_the_headers_order():
    """kernels.sparse_table_words packs the tables in the order in which
    csrc/poseidon.cuh's upload_constants copies them to its constant tables
    (c_full, c_init, c_w_hat, c_vs, c_row0, c_tail), each of the size the
    header declares."""
    import os
    import re

    with open(os.path.join(kernels.CSRC, "poseidon.cuh")) as f:
        src = f.read()
    order = re.findall(r"next\(c_(\w+), sizeof", src)
    assert order == list(kernels.SPARSE_SHAPES) == ["full", "init", "w_hat", "vs", "row0", "tail"]
    sizes = dict(re.findall(r"static __constant__ uint64_t c_(\w+)\[([^\]]+)\];", src))
    consts = {"N_FULL_MDS": 7, "WIDTH": 12, "SPARSE": 11, "N_PARTIAL": 22}
    for name, (rows, cols) in kernels.SPARSE_SHAPES.items():
        assert eval(sizes[name], {}, consts) == rows * cols, name
