"""The CUDA kernels against their plain PyTorch versions and the golden
model, on the card: the three Poseidon kernels, the three field kernels
(the extension Horner sum, and the inversion and the exponentiations in
their grouped forms), the levelized gate program (in both forms, the tapes in shared memory
and in device scratch), the FRI coset folds, and L0 with the partial
products, the lookup argument and the gate filter, their inputs drawn from the edge band and words
x + p as well. Bit-exact (integer arithmetic).

These tests need a CUDA device and nvcc; without them they skip. This file
imports no JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu_torch import verifier_torch as vt
from plonky2_verifier_tpu_torch.kernels import INV_GROUP, horner_segments
from plonky2_verifier_tpu_torch.golden import field as gf
from plonky2_verifier_tpu_torch.golden import hashing as gh
from plonky2_verifier_tpu_torch.golden import poseidon as gp
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops import hash as th
from plonky2_verifier_tpu_torch.ops import poseidon as tp
from plonky2_verifier_tpu_torch.ops.field import GExt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.compiler.gates_torch import GateProgram, compact_ops
from plonky2_verifier_tpu_torch.types import load_common
from plonky2_verifier_tpu_torch.tools.check_field_kernels import (
    check_coset_fold,
    check_gate_filter,
    check_lookup_checks,
    check_partial_products,
    gate_inputs,
    gate_programs,
    golden_gate_program,
    horner_rows_plain,
    inv_grouped_split_plain,
    pow_grouped_cases,
    pow_grouped_rows_plain,
    verifier_like_gather,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda
P = tf.P
EDGE = np.array([0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P, 2**64 - 1], dtype=np.uint64)


@pytest.fixture(scope="module")
def lib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plonky2_verifier_tpu_torch import kernels

    return kernels.load()


@pytest.fixture(scope="module")
def consts(lib):
    return tp.PoseidonConstants("cuda")


def _rand(seed, shape):
    return tf.from_u64(np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64), "cuda")


def _schedule(seed, n_perms, n_data):
    rng = np.random.default_rng(seed)
    ov_idx = torch.from_numpy(rng.integers(0, n_data, size=(n_perms, 12), dtype=np.int64)).cuda()
    ov_mask = torch.from_numpy(rng.integers(0, 3, size=(n_perms, 12)) == 0).cuda()
    return ov_idx, ov_mask


@pytest.mark.parametrize("form", ["thread", "split", "auto"])
def test_permutation_kat_and_random(lib, consts, form):
    kat = lib.permutation(tf.from_u64(np.arange(12, dtype=np.uint64).reshape(1, 12), "cuda"), form)
    assert tuple(int(x) for x in tf.to_u64(kat)[0]) == gp.KAT_OUTPUT
    band = tf.from_u64(EDGE[np.random.default_rng(1).integers(0, len(EDGE), size=(999, 12))], "cuda")
    for x in (band, _rand(2, (4099, 12))):
        assert torch.equal(lib.permutation(x, form), tp.permutation_plain(x, consts))


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 1024, 8192, 8193, 70001])
def test_permutation_forms_agree_at_every_size(lib, consts, n):
    """Sizes around a half-warp, a block of the lane-split form and the
    launcher's switch between the forms."""
    x = _rand(n, (n, 12))
    want = lib.permutation(x, "thread")
    assert torch.equal(lib.permutation(x, "split"), want)
    assert torch.equal(lib.permutation(x, "auto"), want)
    assert torch.equal(want[:64], tp.permutation_plain(x[:64], consts))


@pytest.mark.parametrize("form", ["thread", "split", "auto"])
@pytest.mark.parametrize("batch", [1, 5, 1024])
def test_permutation_scan(lib, consts, batch, form):
    ov_idx, ov_mask = _schedule(batch, 9, 40)
    data = _rand(50 + batch, (batch, 40))
    data[0, :3] = tf.from_u64(EDGE[-3:], "cuda")  # proof words need not be canonical
    got = lib.permutation_scan(data, ov_idx, ov_mask, form)
    assert got.shape == (9, batch, 12)
    assert torch.equal(got, tp.permutation_scan_plain(data, ov_idx, ov_mask, consts))
    state, host = [0] * 12, tf.to_u64(data)[0]
    for i, m in zip(ov_idx.cpu().tolist(), ov_mask.cpu().tolist()):
        state = gp.permutation([int(host[j]) if keep else s for j, keep, s in zip(i, m, state)])
    assert [int(v) for v in tf.to_u64(got[-1, 0])] == state


@pytest.mark.parametrize("width", [0, 1, 3, 7, 8, 9, 16, 20, 32, 83, 135])
def test_sponge_rows(lib, consts, width):
    rows = _rand(width, (517, width))
    got = lib.sponge_rows(rows, width)
    assert torch.equal(got, th.sponge_rows_plain(rows, width, consts))
    host = tf.to_u64(rows)
    assert tuple(int(x) for x in tf.to_u64(got)[0]) == gh.sponge([int(x) for x in host[0]])


SPONGE_GROUP = [(517, 135), (31, 83), (0, 8), (1, 32), (33, 32), (64, 20), (4099, 16), (7, 0), (300, 9)]


def test_sponge_rows_grouped_mixed_widths_in_one_launch(lib, consts):
    """Every width in one launch, row counts on both sides of a warp, an
    empty matrix and a width of 0: the plain version, the one-matrix entry
    point and (row 0 of each) the golden sponge."""
    group = [_rand(50 + k, shape) for k, shape in enumerate(SPONGE_GROUP)]
    group[0][:9] = tf.from_u64(np.repeat(EDGE[:, None], 135, axis=1), "cuda")  # p and 2^64 - 1 among them
    before = lib.launches["sponge_rows_grouped"]
    got = lib.sponge_rows_grouped(group)
    assert lib.launches["sponge_rows_grouped"] == before + 1
    want = th.sponge_rows_grouped_plain(group, consts)
    for rows, g, w in zip(group, got, want):
        assert g.shape == (rows.shape[0], 4)
        assert torch.equal(g, w)
        assert torch.equal(g, lib.sponge_rows(rows, rows.shape[1]))
        if rows.shape[0]:
            assert tuple(int(x) for x in tf.to_u64(g)[0]) == gh.sponge([int(x) for x in tf.to_u64(rows)[0]])


@pytest.mark.parametrize("n", [1, 33, 33793, 70001])
def test_sponge_rows_more_rows_than_the_grid(lib, consts, n):
    """Fewer rows than a warp, and more warps of rows than the 8 one-warp
    blocks an SM that the launch starts (132 x 8 x 32 = 33,792 rows)."""
    rows = _rand(n, (n, 9))
    assert torch.equal(lib.sponge_rows(rows, 9), th.sponge_rows_plain(rows, 9, consts))
    a, b = lib.sponge_rows_grouped([rows, rows[: n // 2, :4].contiguous()])
    assert torch.equal(a, lib.sponge_rows(rows, 9))
    assert torch.equal(b, th.sponge_rows_plain(rows[: n // 2, :4], 4, consts))


def test_sponge_rows_grouped_beyond_one_launch(lib, consts):
    group = [_rand(70 + k, (5 + k, 1 + k)) for k in range(lib.max_segments + 3)]
    before = lib.launches["sponge_rows_grouped"]
    got = lib.sponge_rows_grouped(group)
    assert lib.launches["sponge_rows_grouped"] == before + 2
    for g, w in zip(got, th.sponge_rows_grouped_plain(group, consts)):
        assert torch.equal(g, w)
    assert lib.sponge_rows_grouped([]) == []


@pytest.mark.parametrize("path_len", [0, 1, 3, 7, 11])
def test_merkle_fold(lib, consts, path_len):
    n = 517
    dig, sibs = _rand(10 + path_len, (n, 4)), _rand(20 + path_len, (n, path_len, 4))
    idx = torch.from_numpy(np.random.default_rng(path_len).integers(0, 1 << 32, size=n, dtype=np.int64)).cuda()
    got = lib.merkle_fold(dig, idx, sibs)
    assert torch.equal(got, th.merkle_fold_plain(dig, idx, sibs, path_len, consts))
    _, root = gh.reconstruct_merkle_root(
        tuple(int(x) for x in tf.to_u64(dig)[0]), int(idx[0]), [tuple(int(x) for x in s) for s in tf.to_u64(sibs)[0]]
    )
    assert tuple(int(x) for x in tf.to_u64(got)[0]) == root


@pytest.mark.parametrize("n", [1, 31, 33, 118273, 300007])
def test_merkle_fold_grid_sizes(lib, consts, n):
    """Fewer paths than a warp, one wave of blocks and a few paths beyond
    it (132 SMs x 28 blocks x 32 threads = 118,272), and several paths a thread."""
    dig, sibs = _rand(n, (n, 4)), _rand(n + 1, (n, 2, 4))
    idx = torch.from_numpy(np.random.default_rng(n).integers(0, 1 << 32, size=n, dtype=np.int64)).cuda()
    assert torch.equal(lib.merkle_fold(dig, idx, sibs), th.merkle_fold_plain(dig, idx, sibs, 2, consts))


# The words at the edges of the round body's ranges (csrc/poseidon.cuh):
# 0, 1, p - 1, p and 2^64 - 1, the last two not canonical.
HASH_EDGE = np.array([0, 1, P - 1, P, 2**64 - 1], dtype=np.uint64)


def _edge_words(seed, shape):
    """Words drawn from HASH_EDGE; the first of every row is each edge word in turn."""
    words = HASH_EDGE[np.random.default_rng(seed).integers(0, len(HASH_EDGE), size=shape)]
    words.reshape(-1, shape[-1])[:, 0] = np.resize(HASH_EDGE, int(np.prod(shape[:-1])))
    return words


@pytest.mark.parametrize("index_bits", ["zeros", "ones"])
@pytest.mark.parametrize("path_len", [3, 7, 11])
def test_merkle_fold_on_edge_words(lib, consts, path_len, index_bits):
    """Digests and siblings of edge words, every index bit 0 or every bit 1:
    the kernel, the plain walk and golden/ give the same roots."""
    n = 517
    dig, sibs = _edge_words(path_len, (n, 4)), _edge_words(path_len + 1, (n, path_len, 4))
    dig[:5] = HASH_EDGE[:, None]  # every lane one edge word
    idx = np.full(n, 0 if index_bits == "zeros" else (1 << path_len) - 1, dtype=np.int64)
    d, s, i = tf.from_u64(dig, "cuda"), tf.from_u64(sibs, "cuda"), torch.from_numpy(idx).cuda()
    got = lib.merkle_fold(d, i, s)
    assert torch.equal(got, th.merkle_fold_plain(d, i, s, path_len, consts))
    roots = tf.to_u64(got)
    for r in range(0, n, 37):
        _, want = gh.reconstruct_merkle_root(tuple(int(x) for x in dig[r]), int(idx[r]), [tuple(int(x) for x in w) for w in sibs[r]])
        assert tuple(int(x) for x in roots[r]) == want


# the leaf widths of one verifier call on each benchmark circuit
EDGE_SPONGE_WIDTHS = {"fibonacci": [135, 83, 32, 32, 20, 16], "gate zoo": [135, 91, 34, 32, 32, 16]}


@pytest.mark.parametrize("name", list(EDGE_SPONGE_WIDTHS))
def test_sponge_rows_grouped_on_edge_words(lib, consts, name):
    """Rows of edge words at the widths one verifier call hashes, in one
    grouped launch: the plain sponge and golden/ give the same digests."""
    group = [tf.from_u64(_edge_words(10 + k, (300 + k, w)), "cuda") for k, w in enumerate(EDGE_SPONGE_WIDTHS[name])]
    got = lib.sponge_rows_grouped(group)
    for rows, g, w in zip(group, got, th.sponge_rows_grouped_plain(group, consts)):
        assert torch.equal(g, w)
        host, digests = tf.to_u64(rows), tf.to_u64(g)
        for r in range(0, rows.shape[0], 61):
            assert tuple(int(x) for x in digests[r]) == gh.sponge([int(x) for x in host[r]])


def test_permutation_scan_on_edge_words_at_16384(lib, consts):
    """The transcript scan at 16,384 states, the batch of the benchmark's
    cells, in the thread form the launcher picks there, on data of edge
    words: the plain scan gives the same states, and golden/ lane 0's."""
    batch, n_perms, n_data = 16384, 9, 40
    ov_idx, ov_mask = _schedule(70, n_perms, n_data)
    data = tf.from_u64(_edge_words(71, (batch, n_data)), "cuda")
    got = lib.permutation_scan(data, ov_idx, ov_mask)
    assert torch.equal(got, lib.permutation_scan(data, ov_idx, ov_mask, "thread"))
    assert torch.equal(got[:, :1024], tp.permutation_scan_plain(data[:1024], ov_idx, ov_mask, consts))
    assert torch.equal(got[:, -1024:], tp.permutation_scan_plain(data[-1024:], ov_idx, ov_mask, consts))
    for b in (0, 1, batch - 1):
        state, host = [0] * 12, tf.to_u64(data)[b]
        for i, m in zip(ov_idx.cpu().tolist(), ov_mask.cpu().tolist()):
            state = gp.permutation([int(host[j]) if keep else s for j, keep, s in zip(i, m, state)])
        assert [int(v) for v in tf.to_u64(got[-1, b])] == state


def _noncanonical(seed, shape):
    """Words drawn from the edge band, x + p (x < 2^32 - 1) and random."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([EDGE, rng.integers(0, 2**32 - 1, size=64, dtype=np.uint64) + np.uint64(P), rng.integers(0, P, size=64, dtype=np.uint64)])
    return tf.from_u64(pool[rng.integers(0, len(pool), size=shape)], "cuda")


# (rows, K, v_rep, p_rep, the segments a row kernels.horner_segments picks on
# the H100's 132 SMs): every count from 1 to 32 by K on few rows, and by the
# rows' threads at 4,116 and 28,672 rows
HORNER_KERNEL_SHAPES = [
    (97, 254, 1, 1, 32), (33, 31, 3, 1, 4), (28, 32, 1, 7, 8), (5, 33, 4, 20, 8), (37, 1, 1, 1, 1), (37, 0, 1, 1, 1),
    (0, 5, 1, 1, 1), (40, 11, 1, 1, 2), (40, 67, 1, 1, 16), (147, 254, 28, 1, 16), (28672, 40, 1, 28, 2),
]


@pytest.mark.parametrize("base_values,base_point", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("rows,k,v_rep,p_rep,segments", HORNER_KERNEL_SHAPES)
def test_horner_kernel(lib, base_values, base_point, rows, k, v_rep, p_rep, segments):
    """Both flags, widths around a warp's 32 lanes, K = 0 (zeros), no rows
    (no launch) and repeated rows (v_rep, p_rep), on non-canonical words, at
    shapes where the library picks each segment count a row: the plain
    version, and golden/ on the first row."""
    n = rows * v_rep
    assert horner_segments(n, k, lib.sms) == segments
    v_re, v_im = _noncanonical(rows + k, (rows, k)), None if base_values else _noncanonical(rows + k + 1, (rows, k))
    p_re, p_im = _noncanonical(n + 2, (n // p_rep,)), None if base_point else _noncanonical(n + 3, (n // p_rep,))
    before = lib.launches["horner"]
    got = lib.horner(v_re, v_im, p_re, p_im, v_rep, p_rep)
    assert lib.launches["horner"] == before + (1 if n else 0)
    want = horner_rows_plain(v_re, v_im, p_re, p_im, v_rep, p_rep)
    assert got[0].shape == got[1].shape == (n,)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n:
        u = lambda t, i: 0 if t is None else int(tf.to_u64(t)[i]) % P
        acc, pt = (0, 0), (u(p_re, 0), u(p_im, 0))
        for j in range(k - 1, -1, -1):
            acc = gf.eadd((int(tf.to_u64(v_re)[0, j]) % P, 0 if v_im is None else int(tf.to_u64(v_im)[0, j]) % P), gf.emul(pt, acc))
        assert (int(tf.to_u64(got[0])[0]), int(tf.to_u64(got[1])[0])) == acc


def test_horner_wrappers_at_the_call_sites_layouts(lib):
    """The wrappers on the views the verifier hands them, against the plain
    versions: interleaved openings (column stride 2), a stride-0 point over
    the query axis, base-field values and points, a (B, r) quotient reshape
    that cannot be merged, final-polynomial values broadcast over queries,
    horner_scaled's values broadcast over r scales, and the parts of one
    GExt laid out unlike each other."""
    B, Q, r = 6, 5, 2
    op = _noncanonical(70, (B, 40, 2))
    o1 = GExt(op[..., 0], op[..., 1])
    alpha = GExt(_noncanonical(71, (B,)), _noncanonical(72, (B,)))
    bq = GExt(alpha.re.unsqueeze(1).expand(B, Q), alpha.im.unsqueeze(1).expand(B, Q))
    leaves = _noncanonical(73, (B, Q, 37))
    x = _noncanonical(74, (B, Q))
    quots = o1[:, 10:26].reshape(B, r, 8)
    zeta = GExt(_noncanonical(75, (B, 1)).expand(B, r), _noncanonical(76, (B, 1)).expand(B, r))
    fp = GExt(op[:, :8, 0].unsqueeze(1).expand(B, Q, 8), op[:, :8, 1].unsqueeze(1).expand(B, Q, 8))
    unlike = GExt(_noncanonical(77, (B, 1, 9)).expand(B, Q, 9), _noncanonical(78, (B, Q, 9)))
    before = lib.launches["horner"]
    for values, point in [(o1, alpha), (leaves, bq), (quots, zeta), (fp, x), (unlike, bq), (o1[:, :0], alpha), (leaves[:0], bq[:0])]:
        got = vt.horner_ext(values, point)
        want = vt.horner_ext_plain(vt.as_ext(values), vt.as_ext(point))
        assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    scale = _noncanonical(79, (B, r))
    got, want = vt.horner_scaled(o1, scale), vt.horner_scaled_plain(o1, scale)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert lib.launches["horner"] == before + 7  # K = 0 launches (zeros), no rows does not


def test_wrappers_count_launches_and_dispatch(lib, consts):
    before = dict(lib.launches)
    x = _rand(30, (2, 3, 12))
    assert torch.equal(tp.permutation(x, consts), tp.permutation_plain(x, consts))
    rows = _rand(31, (2, 3, 20))
    assert torch.equal(th.sponge_rows(rows, 20, consts), th.sponge_rows_plain(rows, 20, consts))
    dig, sibs = _rand(32, (2, 3, 4)), _rand(33, (2, 3, 4, 4))
    idx = torch.arange(6, dtype=torch.int64, device="cuda").reshape(2, 3) * 5
    assert torch.equal(th.merkle_fold(dig, idx, sibs, 4, consts), th.merkle_fold_plain(dig, idx, sibs, 4, consts))
    ov_idx, ov_mask = _schedule(34, 3, 20)
    data = _rand(35, (4, 20))
    assert torch.equal(tp.permutation_scan(data, ov_idx, ov_mask, consts), tp.permutation_scan_plain(data, ov_idx, ov_mask, consts))
    group = [_rand(36, (2, 3, 20)), _rand(37, (5, 9))]
    for g, w in zip(th.sponge_rows_grouped(group, consts), th.sponge_rows_grouped_plain(group, consts)):
        assert torch.equal(g, w)
    values, point = GExt(_rand(38, (2, 3, 9)), _rand(39, (2, 3, 9))), GExt(_rand(40, (2, 3)), _rand(41, (2, 3)))
    got, want = vt.horner_ext(values, point), vt.horner_ext_plain(values, point)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    a = _rand(42, (2, 3))
    exps = torch.arange(6, dtype=torch.int64, device="cuda").reshape(2, 3) * 1000
    (_, lp), = [p for p in gate_programs() if p[0] == "fibonacci"]
    prog = GateProgram(lp, "cuda")
    inputs, _ = gate_inputs(np.random.default_rng(43), lp, 3, "cuda")
    got, want = prog(inputs, (3,)), prog.forward_plain(inputs, (3,))
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    for g, w in zip(tf.inv_grouped([a, a[:, :1]]), tf.inv_grouped_plain([a, a[:, :1]])):
        assert torch.equal(g, w)
    gens = pow_grouped_cases("cuda")
    got, want = tf.pow_grouped(exps % 2**15, gens, [(point, 4096), (point, 1)]), tf.pow_grouped_plain(exps % 2**15, gens, [(point, 4096), (point, 1)])
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    assert all(torch.equal(g.re, w.re) and torch.equal(g.im, w.im) for g, w in zip(got[1], want[1]))
    evals, off_inv = _rand(44, (2, 3, 4, 2)), _rand(45, (2, 3))
    perm, idft = torch.tensor([0, 2, 1, 3], device="cuda"), tf.from_u64(np.array([[gf.fpow(gf.finv(gf.subgroup_generator(2)), j * k) for j in range(4)]
                                                                                 for k in range(4)], np.uint64), "cuda")
    beta = GExt(point.re[:, 0], point.im[:, 0])
    (got,), want = vt.coset_folds([evals], [off_inv], [beta], [perm], [idft]), vt.coset_fold_plain(evals, off_inv, beta, perm, idft)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    ext = lambda seed, *shape: GExt(_rand(seed, shape), _rand(seed + 100, shape))
    pp = (ext(46, 2), ext(47, 2), ext(48, 2, 2), ext(49, 2, 2), ext(50, 2, 2), ext(51, 2, 6), ext(52, 2, 6), _rand(53, (2, 2)), _rand(54, (2, 2)),
          ext(55, 2), _rand(56, (6,)), 3)
    got, want = vt.partial_products(*pp), vt.partial_products_plain(*pp)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    coeffs, offsets = _rand(57, (4, 2)) & 0xFFFF, torch.tensor([0, 2, 4], device="cuda")
    deltas = [tuple(_rand(58 + k, (2,)) for k in range(4))]
    lk = (ext(62, 2, 6), ext(63, 2, 6), ext(64, 2, 3), ext(65, 2, 3), deltas, coeffs, offsets, 6, 4)
    got, want = vt.lookup_checks(*lk), vt.lookup_checks_plain(*lk)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    gf_args = (ext(66, 2, 3), ext(67, 2, 8), torch.tensor([0, 2], device="cuda"), _rand(68, (2, 2)), torch.ones((2, 2), dtype=torch.bool, device="cuda"), 4)
    got, want = vt.gate_filter(*gf_args), vt.gate_filter_plain(*gf_args)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert {k: lib.launches[k] - before[k] for k in before} == {
        "permutation": 1, "permutation_scan": 1, "sponge_rows": 1, "sponge_rows_grouped": 1, "merkle_fold": 1, "horner": 1,
        "inv_grouped": 1, "pow_grouped": 1, "gate_program": 1, "coset_fold": 1, "partial_products": 1, "lookup_checks": 1,
        "gate_filter": 1,
    }


def test_kernel_inputs_are_validated(lib):
    x = _rand(40, (8, 12))
    with pytest.raises(ValueError, match="contiguous"):
        lib.permutation(x.t().contiguous().t())
    with pytest.raises(ValueError, match="int64"):
        lib.permutation(x.to(torch.int32))
    with pytest.raises(ValueError, match="shape"):
        lib.sponge_rows(_rand(41, (4, 9)), 8)
    with pytest.raises(ValueError, match=r"rows\[1\]"):
        lib.sponge_rows_grouped([_rand(46, (4, 9)), _rand(47, (4, 9)).cpu()])
    with pytest.raises(ValueError, match="index"):
        lib.merkle_fold(_rand(42, (4, 4)), torch.zeros(3, dtype=torch.int64, device="cuda"), _rand(43, (4, 2, 4)))
    ov_idx, ov_mask = _schedule(44, 3, 20)
    with pytest.raises(ValueError, match="bool"):
        lib.permutation_scan(_rand(45, (4, 20)), ov_idx, ov_mask.to(torch.int64))
    with pytest.raises(KeyError):
        lib.permutation(x, "warp")
    v, pt = _rand(48, (6, 5)), _rand(49, (6,))
    with pytest.raises(ValueError, match="int64"):
        lib.horner(v.to(torch.int32), None, pt, None)
    with pytest.raises(ValueError, match="rows"):
        lib.horner(v, None, pt[:5], None)
    with pytest.raises(ValueError, match="rows"):
        lib.horner(v, None, pt, None, v_rep=2)
    with pytest.raises(ValueError, match="v_im"):
        lib.horner(v, v.t().contiguous().t(), pt, None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lib.horner(v, None, pt.cpu(), None)
    with pytest.raises(ValueError, match="contiguous"):
        lib.inv_grouped(x.t())
    with pytest.raises(ValueError, match="int64"):
        lib.inv_grouped(x.to(torch.int32))


def test_entry_points_default_to_the_card(lib):
    """TorchVerifier, verify_batch and PoseidonConstants without a device
    argument build and run on the card, through the kernels, with the
    verdicts of the CPU path."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
    from plonky2_verifier_tpu_torch.prover.prove import prove
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier, verify_batch

    fx = fibonacci_fixture(n_arith_rows=13, num_query_rounds=2, proof_of_work_bits=2)
    tpl = CircuitTemplate(fx.common)
    arrays = flatten_proofs(tpl, [prove(fx)] * 3)
    arrays["openings1"][1, 0, 0] ^= np.uint64(1)
    assert {b.device.type for b in TorchVerifier(tpl).buffers()} == {"cuda"}
    assert tp.PoseidonConstants().rc.device.type == "cuda"
    before = dict(lib.launches)
    card = verify_batch(tpl, arrays, debug=True)
    assert lib.launches["permutation_scan"] == before["permutation_scan"] + 1
    assert lib.launches["merkle_fold"] > before["merkle_fold"]
    # the sponge twice: the public-input hash, and every leaf hash in one grouped launch
    assert lib.launches["sponge_rows"] == before["sponge_rows"] + 1
    assert lib.launches["sponge_rows_grouped"] == before["sponge_rows_grouped"] + 1
    # the Horner sums: alpha combination, quotient, y0, y1, g0, g1, a fold each step, the final polynomial;
    # every inversion (L0, the two combineInitial quotients, an offset each step) in one grouped launch, every
    # exponentiation (the query points, an offset each step, the final x, zeta^n, alpha^(n_zs + n_lookup)) in
    # another; the gate program once
    assert lib.launches["horner"] == before["horner"] + 7 + len(tpl.steps)
    assert lib.launches["inv_grouped"] == before["inv_grouped"] + 1
    assert lib.launches["pow_grouped"] == before["pow_grouped"] + 1
    assert lib.launches["gate_program"] == before["gate_program"] + 1
    cpu = verify_batch(tpl, arrays, debug=True, device="cpu")
    assert card["ok"].tolist() == cpu["ok"].tolist() == [True, False, True]
    np.testing.assert_array_equal(card["debug"]["zeta"][0], cpu["debug"]["zeta"][0])
    np.testing.assert_array_equal(card["debug"]["query_indices"], cpu["debug"]["query_indices"])


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 17, 1001, 143361, 0])
def test_inv_grouped_kernel(lib, n):
    """The batch inversion at lengths around its group and at a forward's
    size, a zero and a word p in every position of a group, on
    non-canonical words: inv_plain's and the kernel order's bits; no words,
    no launch."""
    groups = -(-n // INV_GROUP)
    x = tf.to_u64(_noncanonical(90 + n % 50, (n,))).copy()
    for j in range(INV_GROUP):
        if j * groups < n:
            x[j * groups] = 0
        if groups > 1 and groups - 1 + j * groups < n:
            x[groups - 1 + j * groups] = P
    a = tf.from_u64(x, "cuda")
    before = lib.launches["inv_grouped"]
    got = lib.inv_grouped(a)
    assert lib.launches["inv_grouped"] == before + (1 if n else 0)
    assert torch.equal(got, tf.inv_plain(a)) and torch.equal(got, inv_grouped_split_plain(a))
    assert tf.to_u64(got)[[i for i in range(n) if x[i] in (0, P)]].tolist() == [0] * sum(1 for v in x if v in (0, P))


@pytest.mark.parametrize("queries", [28, 14, 1])
def test_pow_grouped_kernel(lib, queries):
    """Every fixed-generator segment as the verifier makes them and
    extension bases at host exponents in one launch, on indices of a
    strided (rows, queries) view: pow_grouped_plain's bits and the table
    products'."""
    rng = np.random.default_rng(queries)
    idx = torch.from_numpy(rng.integers(0, 1 << 15, size=(1024, 28), dtype=np.int64)).cuda()[:, :queries]
    gens = pow_grouped_cases("cuda")
    b = _noncanonical(99, (1024, 2))
    base = GExt(b[:, 0], b[:, 1])
    exts = [(base, 4096), (base, 2), (base, 2**64 - 1)]
    before = lib.launches["pow_grouped"]
    got_g, got_e = tf.pow_grouped(idx, gens, exts + [(base, 0)])
    assert lib.launches["pow_grouped"] == before + 1
    want_g, want_e = tf.pow_grouped_plain(idx, gens, exts + [(base, 0)])
    split_g, _ = pow_grouped_rows_plain(idx, [(g.table, g.shift, g.clear, g.factor) for g in gens], [])
    for g, w, s in zip(got_g, want_g, split_g):
        assert torch.equal(g, w) and torch.equal(g, s)
    for g, w in zip(got_e, want_e):
        assert torch.equal(g.re, w.re) and torch.equal(g.im, w.im)


@pytest.mark.parametrize("gather", ["own", "verifier-like"])
@pytest.mark.parametrize("form", ["shared", "global"])
@pytest.mark.parametrize("batch", [37, 300, 400, 1030, 2112, 4225, 1, 0])
@pytest.mark.parametrize("name", ["fibonacci", "gate zoo", "fuzz 13"])
def test_gate_program_kernel(lib, name, batch, form, gather):
    """The fibonacci, gate-zoo and fuzz-13 programs, packed for their own
    outputs and for a verifier-like gather (zeros, a slot twice, an input,
    a literal), in both forms, at batches whose lanes a block do and do not
    divide them (fibonacci's 1 to 32 lanes a block), B = 0: the padded
    plain loop, and golden/ on lane 0."""
    (_, lp), = [p for p in gate_programs() if p[0] == name]
    prog = GateProgram(lp, "cuda")
    slots = lp.out_slots if gather == "own" else verifier_like_gather(lp)
    inputs, views = gate_inputs(np.random.default_rng(batch), lp, batch, "cuda")
    before = lib.launches["gate_program"]
    got = lib.gate_program(views, prog.pack(slots), form=form)
    assert lib.launches["gate_program"] == before + (1 if batch else 0)
    want = prog.forward_plain(inputs, (batch,), out_slots=slots)
    assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im)
    if batch:
        ops = compact_ops(lp)
        gold = golden_gate_program([(o, None if re is None else re[:1], None if im is None else im[:1]) for o, re, im in views],
                                   prog.lit_values, ops["add_off"], ops["adds"], ops["mul_off"], ops["muls"], slots)
        assert torch.equal(got[0][:1], gold[0]) and torch.equal(got[1][:1], gold[1])


@pytest.mark.parametrize("name,batch,lanes,threads", [
    ("gate zoo", 100, 1, 64), ("gate zoo", 200, 2, 128), ("gate zoo", 400, 4, 256), ("gate zoo", 1024, 8, 512), ("gate zoo", 4225, 8, 512),
    ("fibonacci", 2112, 16, 1024), ("fibonacci", 4225, 32, 1024),
])
def test_gate_program_lanes_and_threads(lib, name, batch, lanes, threads):
    """The lanes and threads a block that the library's rule gives a batch
    on the H100's 132 SMs (the zoo's tape allows 8 lanes a block, the
    fibonacci program's 32): the same words as the plain loop; narrow steps
    do and do not fit one warp."""
    (_, lp), = [p for p in gate_programs() if p[0] == name]
    prog = GateProgram(lp, "cuda")
    packed = prog.pack()
    plan = lib.gate_plan(batch, packed)
    assert (plan["lanes"], plan["threads"]) == (lanes, threads)
    inputs, views = gate_inputs(np.random.default_rng(batch), lp, batch, "cuda")
    got = lib.gate_program(views, packed)
    want = prog.forward_plain(inputs, (batch,))
    assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im)


def test_gate_program_forms_agree_at_the_verifier_batch(lib):
    """The zoo's program at 1024 lanes: the form the wrapper picks (shared),
    the global form forced, and the plain loop agree; a tape above a
    block's shared memory takes the global form, and forcing the shared one
    on it raises."""
    import dataclasses

    (_, lp), = [p for p in gate_programs() if p[0] == "gate zoo"]
    prog = GateProgram(lp, "cuda")
    inputs, views = gate_inputs(np.random.default_rng(1024), lp, 1024, "cuda")
    want = prog.forward_plain(inputs, (1024,))
    packed = prog.pack()
    big = dataclasses.replace(packed, n_slots=lib.gate_smem_limit // 16 + 1, args=None)  # slots past the packed ones are never written or read
    for got in (lib.gate_program(views, packed), lib.gate_program(views, packed, form="global"), lib.gate_program(views, big)):
        assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im)
    with pytest.raises(ValueError, match="shared memory"):
        lib.gate_program(views, big, form="shared")


@pytest.mark.parametrize("check", [check_coset_fold, check_partial_products, check_lookup_checks, check_gate_filter],
                         ids=["coset_fold", "partial_products", "lookup_checks", "gate_filter"])
def test_stage_kernels_against_plain_and_golden(lib, check):
    """tools/check_field_kernels.py's sweep of each stage kernel at full
    size: the coset folds (arity 2 to 64 in one launch, both forms, a query
    slice, B = 0), L0 with the partial products (r, maxdeg, chunk counts)
    and the lookup argument (SLDC chunks, table counts and lengths, the
    lanes of each kind, subtrahends y + p at sldc - prev) and the gate
    filter (templates of one selector group and of several, rows of one
    live slot, of none and with gaps, one live gate and none, batches 1,
    1,023 and 16,384): the plain version's words, the kernel order's in
    PyTorch, and golden/'s on a few lanes."""
    from plonky2_verifier_tpu_torch.tools.check_hash_kernels import KernelCheck

    c = KernelCheck(check.__name__)
    check(lib, c, np.random.default_rng(11), "cuda", 1 << 20)
    assert c.cases > 0 and c.max_abs_err == 0


def test_stage_kernels_validate_inputs(lib):
    """More fold steps than a launch takes, a fold step's values not
    contiguous, sigmas that make no whole chunks and a lookup round of one
    polynomial raise; zero lanes launch nothing."""
    from plonky2_verifier_tpu_torch.kernels import FOLD_MAX_STEPS

    evals, off_inv, beta, idft = _rand(70, (2, 3, 2, 2)), _rand(71, (2, 3)), _rand(72, (2,)), _rand(73, (2, 2))
    with pytest.raises(ValueError, match="fold steps"):
        lib.coset_fold([(evals, off_inv, beta, beta, idft)] * (FOLD_MAX_STEPS + 1))
    with pytest.raises(ValueError, match="contiguous"):
        lib.coset_fold([(evals.transpose(2, 3).contiguous().transpose(2, 3), off_inv, beta, beta, idft)])
    with pytest.raises(ValueError, match="idft"):
        lib.coset_fold([(evals, off_inv, beta, beta, _rand(74, (3, 3)))])
    ext = lambda seed, *shape: (_rand(seed, shape), _rand(seed + 100, shape))
    with pytest.raises(ValueError, match="chunks"):
        lib.partial_products(ext(75, 2), ext(76, 2), ext(77, 2, 2), ext(78, 2, 2), ext(79, 2, 2), ext(80, 2, 7), ext(81, 2, 7),
                             _rand(82, (2, 2)), _rand(83, (2, 2)), ext(84, 2), _rand(85, (7,)), 3)
    with pytest.raises(ValueError, match="polynomials"):
        lib.lookup_checks(ext(86, 2, 5), ext(87, 2, 6), ext(88, 2, 1), ext(89, 2, 1), _rand(90, (2, 1, 4)), _rand(91, (2, 2)),
                          torch.tensor([0, 2], device="cuda"), 6, 4)
    before = dict(lib.launches)
    assert lib.coset_fold([(evals[:0], off_inv[:0], beta[:0], beta[:0], idft)]).shape == (1, 2, 0, 3)
    assert lib.partial_products(*(x[:0] if isinstance(x, torch.Tensor) and x.dim() == 2 and x.shape[0] == 2 else
                                  (x[0][:0], x[1][:0]) if isinstance(x, tuple) else x
                                  for x in (ext(75, 2), ext(76, 2), ext(77, 2, 2), ext(78, 2, 2), ext(79, 2, 2), ext(80, 2, 6),
                                            ext(81, 2, 6), _rand(82, (2, 2)), _rand(83, (2, 2)), ext(84, 2), _rand(85, (6,)), 3)))[0].shape == (0, 6)
    assert lib.launches == before


BENCH_DATA = os.path.join(os.path.dirname(__file__), "..", "benchmark", "data")


def _bench_common(config):
    return load_common(os.path.join(BENCH_DATA, config, "common.json"))


@pytest.mark.parametrize("config", ["fibonacci-std-d12", "gate-zoo-lookup-d12"])
def test_gate_filter_kernel_on_the_benchmark_templates(lib, config):
    """check_gate_filter on the live gates' rows of each benchmark
    template (3 live gates in one selector group; 13 in four, with
    UNUSED_SELECTOR) at batches 1, 1,023 and 16,384 and B = 0."""
    from plonky2_verifier_tpu_torch.tools.check_hash_kernels import KernelCheck

    c = KernelCheck("gate_filter")
    check_gate_filter(lib, c, np.random.default_rng(12), "cuda", 1 << 20, commons=[(config, _bench_common(config))])
    assert c.cases > 0 and c.max_abs_err == 0


def test_gate_filter_kernel_on_noncanonical_subtrahends(lib):
    """The gate zoo's rows with lane 1's every selector column y + p
    (n_gates < y < 2^32 - 1, where consts - x is not exact mod p): the
    kernel gives gate_filter_plain's words (tests/test_torch_noncanonical.py
    holds those to the JAX package's), and on the same words reduced it
    reads otherwise exactly where the plain version does, lane 1 among
    them."""
    common = _bench_common("gate-zoo-lookup-d12")
    v = vt.TorchVerifier(CircuitTemplate(common), device="cuda")
    n_sel, n_gc, L = v.tpl.n_gate_selectors, common.num_gate_constraints, len(v._live_gates)
    rng = np.random.default_rng(13)
    sels = rng.integers(0, P, size=(3, n_sel, 2), dtype=np.uint64)
    sels[1] = rng.integers(len(common.selectors_info.selector_indices) + 1, (1 << 32) - 1, size=(n_sel, 2), dtype=np.uint64) + np.uint64(P)
    cons = tf.from_u64(rng.integers(0, P, size=(2, 3, L * n_gc), dtype=np.uint64), "cuda")
    rows = (v._filter_cols, v._filter_consts, v._filter_mask)

    def both(words):
        t = tf.from_u64(words, "cuda")
        s = GExt(t[..., 0], t[..., 1])
        got = lib.gate_filter((s.re, s.im), (cons[0], cons[1]), *rows, n_gc)
        want = vt.gate_filter_plain(s, GExt(cons[0], cons[1]), *rows, n_gc)
        return torch.stack(got), torch.stack([want.re, want.im])

    got, want = both(sels)
    assert torch.equal(got, want)
    got_red, want_red = both(sels % np.uint64(P))
    assert torch.equal(got != got_red, want != want_red) and (want[:, 1] != want_red[:, 1]).any()


def test_gate_filter_validates_inputs(lib):
    """CPU tensors, int32 words, constraints of the wrong width, a mask of
    the wrong shape or type and more live gates or factor slots than the
    kernel takes raise; no live gate or no lane gives zeros with no
    launch."""
    from plonky2_verifier_tpu_torch.kernels import GATE_FILTER_MAX_LIVE, GATE_FILTER_MAX_SPAN

    B, n_sel, n_gc, L, span = 5, 3, 4, 2, 2
    sels, cons = (_rand(90, (B, n_sel)), _rand(91, (B, n_sel))), (_rand(92, (B, L * n_gc)), _rand(93, (B, L * n_gc)))
    cols, consts = torch.tensor([0, 2], device="cuda"), _rand(94, (L, span))
    mask = torch.ones((L, span), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        lib.gate_filter((sels[0].cpu(), sels[1].cpu()), cons, cols, consts, mask, n_gc)
    with pytest.raises(ValueError, match="int64"):
        lib.gate_filter(sels, cons, cols, consts.to(torch.int32), mask, n_gc)
    with pytest.raises(ValueError, match="shape"):
        lib.gate_filter(sels, cons, cols, consts, mask, n_gc + 1)
    with pytest.raises(ValueError, match="bool"):
        lib.gate_filter(sels, cons, cols, consts, mask.to(torch.uint8), n_gc)
    with pytest.raises(ValueError, match="shape"):
        lib.gate_filter(sels, cons, cols, consts, mask[:, :1], n_gc)
    many = GATE_FILTER_MAX_LIVE + 1
    with pytest.raises(ValueError, match="live gates"):
        lib.gate_filter(sels, (_rand(95, (B, many)), _rand(96, (B, many))), torch.zeros(many, dtype=torch.int64, device="cuda"),
                        _rand(97, (many, 1)), torch.ones((many, 1), dtype=torch.bool, device="cuda"), 1)
    wide = GATE_FILTER_MAX_SPAN + 1
    with pytest.raises(ValueError, match="factor slots"):
        lib.gate_filter(sels, cons, cols, _rand(98, (L, wide)), torch.ones((L, wide), dtype=torch.bool, device="cuda"), n_gc)
    before = dict(lib.launches)
    none = lib.gate_filter(sels, (cons[0][:, :0], cons[1][:, :0]), cols[:0], consts[:0], mask[:0], n_gc)
    empty = lib.gate_filter((sels[0][:0], sels[1][:0]), (cons[0][:0], cons[1][:0]), cols, consts, mask, n_gc)
    assert lib.launches == before and none[0].shape == (B, n_gc) and not (none[0].any() or none[1].any()) and empty[0].shape == (0, n_gc)
