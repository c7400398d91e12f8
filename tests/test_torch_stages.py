"""The three verifier stages that each launch one kernel on the card -- the
FRI coset folds (csrc/fold.cu), L0 with the partial products and the lookup
argument (csrc/plonk.cu) -- on the CPU, where they run their plain versions.

- `coset_fold_plain` against golden/fri.py `fold_coset`, lane by lane, for
  arities 2, 4, 8 and 16 and on a query slice; the kernel's own order in
  PyTorch (`check_field_kernels.coset_fold_rows_plain`) against the plain
  version on the same words.
- `partial_products_plain` against the L0 and partial-product terms of
  golden/plonk.py `eval_all_plonk_constraints` on a proof's openings and
  challenges, lane by lane (an intact lane, a lane with a partial-product
  opening flipped, a lane with its openings written as x + p); the kernel's
  order (lanes a chunk, their shuffle tree) against the plain version at
  maxdeg 1 to 40 on every lane count a chunk the kernel takes, with every
  opening word y + p in two lanes.
- The card paths' argument marshaling (`verifier_torch._coset_folds_kernel`,
  `_partial_products_kernel`, `_lookup_checks_kernel`) with a stand-in
  library that records what it was given and computes in the kernels' own
  order: the openings reach it as views of the opened values (column
  stride 2, never copied), the template's tables and weights as its
  buffers, a query slice at its strides; the results equal the plain ones.
- A forward of a circuit with two fold steps, one lane with a word of
  step_evals_1 flipped (FRI) and one with a partial-product opening flipped
  (the Plonk equations): the port, JaxVerifier and golden/ give the same
  (ok, eqs_ok, fri_ok) on every lane, and the port rejects exactly those
  two lanes, also with every stage's card path taken (the stand-in library).
  These are the only verifier forwards here: two of the port, one of
  JaxVerifier.

Inputs come from numpy seeds: random canonical words, the p-edge band and
words x + p. Tolerance: bit-exact (integers mod p)."""

import json

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu import types as jax_types
from plonky2_verifier_tpu.compiler import CircuitTemplate as JaxTemplate
from plonky2_verifier_tpu.verifier_jax import JaxVerifier
from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch import verifier_torch as vt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.golden import challenges as gch
from plonky2_verifier_tpu_torch.golden import field as gf
from plonky2_verifier_tpu_torch.golden import fri as gfri
from plonky2_verifier_tpu_torch.golden import plonk as gplonk
from plonky2_verifier_tpu_torch.models.poseidon_chain import poseidon_chain_fixture
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops.field import GExt
from plonky2_verifier_tpu_torch.prover.prove import prove
from plonky2_verifier_tpu_torch.tools.check_field_kernels import (
    LOOKUP_SHAPES,
    coset_fold_rows_plain,
    lookup_checks_rows_plain,
    partial_products_args,
    partial_products_rows_plain,
    partial_products_words,
    probe_sldc_subtrahends,
    words,
)
from plonky2_verifier_tpu_torch.tools.check_hash_kernels import PlainLibrary
from plonky2_verifier_tpu_torch.types import ProofWithPublicInputs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

P = gf.P
B, Q = 3, 6


def _ints(x: GExt, lane, *index):
    return int(tf.to_u64(x.re[(lane,) + index])) % P, int(tf.to_u64(x.im[(lane,) + index])) % P


def _idft(bits):
    w = gf.finv(gf.subgroup_generator(bits))
    return tf.from_u64(np.array([[gf.fpow(w, j * k) for j in range(1 << bits)] for k in range(1 << bits)], dtype=np.uint64), "cpu")


def _perm(bits):
    return torch.tensor([gf.reverse_bits(bits, i) for i in range(1 << bits)], dtype=torch.int64)


def _fold_inputs(seed, bits, queries=Q):
    rng = np.random.default_rng(seed)
    evals = tf.from_u64(words(rng, (B, queries, 1 << bits, 2)), "cpu")
    off_inv = tf.from_u64(rng.integers(1, P, size=(B, queries), dtype=np.uint64), "cpu")
    beta = tf.from_u64(words(rng, (B, 2)), "cpu")
    return evals, off_inv, GExt(beta[:, 0], beta[:, 1])


@pytest.mark.parametrize("bits,cut", [(1, None), (2, None), (3, None), (4, None), (4, slice(1, 5))],
                         ids=["arity2", "arity4", "arity8", "arity16", "arity16-query-slice"])
def test_coset_fold_plain_equals_golden_lane_by_lane(bits, cut):
    """Every (b, q) of coset_fold_plain is golden/'s fold_coset of the same
    values (bit reversal undone), beta and offset (the inverse's inverse);
    on a query slice (a mesh rank's, a strided view) too. The kernel's
    order gives the same words."""
    evals, off_inv, beta = _fold_inputs(bits, bits)
    if cut is not None:
        evals, off_inv = evals[:, cut], off_inv[:, cut]
    got = vt.coset_fold_plain(evals, off_inv, beta, _perm(bits), _idft(bits))
    assert got.shape == off_inv.shape
    v = GExt(evals[..., 0], evals[..., 1])
    for b in range(B):
        for q in range(off_inv.shape[1]):
            values = [_ints(v, b, q, gf.reverse_bits(bits, j)) for j in range(1 << bits)]
            want = gfri.fold_coset(_ints(beta, b), bits, gf.finv(int(tf.to_u64(off_inv[b, q]))), values)
            assert _ints(got, b, q) == want, (b, q)
    order = coset_fold_rows_plain([(evals, off_inv, beta.re, beta.im, _idft(bits))])
    assert torch.equal(order[0, 0], got.re) and torch.equal(order[0, 1], got.im)


@pytest.mark.parametrize("bits,batch,cut", [(1, B, None), (2, B, None), (3, B, None), (4, B, None), (5, B, None), (6, B, None),
                                            (4, B, slice(1, 6, 2)), (4, 0, None)],
                         ids=["arity2", "arity4", "arity8", "arity16", "arity32", "arity64-scratch-form", "arity16-strided-queries",
                              "no-lanes"])
def test_coset_fold_kernel_order_equals_plain(bits, batch, cut):
    """The kernel's order in PyTorch (coset_fold_rows_plain: the opened
    words made canonical, the butterflies, the Horner chain in beta off_inv)
    gives coset_fold_plain's words, word for word, on opened values with
    the p-edge band and words x + p among them, every offset inverse and
    beta as words() gives them too; at every arity the kernel's shared form
    takes and one of its scratch form, on a strided query slice and on no
    lanes."""
    rng = np.random.default_rng(100 + bits)
    evals = tf.from_u64(words(rng, (batch, Q, 1 << bits, 2)), "cpu")
    off_inv = tf.from_u64(words(rng, (batch, Q)), "cpu")
    beta = tf.from_u64(words(rng, (batch, 2)), "cpu")
    if cut is not None:
        evals, off_inv = evals[:, cut], off_inv[:, cut]
    assert batch == 0 or (evals.numel() and bool(tf.uge(evals, tf.P_I64).any()))  # words x + p among the values
    want = vt.coset_fold_plain(evals, off_inv, GExt(beta[:, 0], beta[:, 1]), _perm(bits), _idft(bits))
    got = coset_fold_rows_plain([(evals, off_inv, beta[:, 0], beta[:, 1], _idft(bits))])
    assert got.shape == (1, 2) + tuple(off_inv.shape)
    assert torch.equal(got[0, 0], want.re) and torch.equal(got[0, 1], want.im)


def _lookup_case(shape, seed):
    """A LOOKUP_SHAPES entry at a few lanes: tables padded as the verifier
    pads them, openings from words() in one interleaved tensor as the
    verifier's views are, and in lane i >= 1 the SLDC transition of chunk
    (i - 1) mod n_sldc of every round with its subtrahend a word y + p above
    its minuend + p, where ops/field.sub is not exact mod p
    (probe_sldc_subtrahends)."""
    from types import SimpleNamespace

    batch, r, routed, n_polys, maxdeg, lengths = shape
    batch = min(batch, 4)
    rng = np.random.default_rng(seed)
    tables = [[tuple(int(x) for x in row) for row in rng.integers(0, 1 << 16, size=(n, 2))] for n in lengths]
    coeffs, offsets = vt.lookup_tables(SimpleNamespace(config=SimpleNamespace(num_routed_wires=routed), luts=tables), "cpu")
    widths = [4 + len(lengths), routed + 5, r * n_polys, r * n_polys]
    at = np.concatenate([[0], np.cumsum(widths)])
    op = words(rng, (batch, int(at[-1]), 2))
    probe_sldc_subtrahends(rng, op[:, at[2] : at[3]], op[:, at[3] : at[4]], r, n_polys, range(1, batch))
    t = tf.from_u64(op, "cpu")
    sels, wires, zs_t, zs_next_t = (GExt(t[:, at[i] : at[i + 1], 0], t[:, at[i] : at[i + 1], 1]) for i in range(4))
    d = tf.from_u64(rng.integers(0, P, size=(batch, r, 4), dtype=np.uint64), "cpu")
    return (sels, wires, zs_t, zs_next_t), d, coeffs, offsets, routed, maxdeg


@pytest.mark.parametrize("shape", LOOKUP_SHAPES, ids=[f"B{s[0]}-r{s[1]}-routed{s[2]}-polys{s[3]}-maxdeg{s[4]}" for s in LOOKUP_SHAPES])
def test_lookup_kernel_order_equals_plain(shape):
    """The kernel's order in PyTorch (lookup_checks_rows_plain: a chunk's
    slots over kernels.lookup_split's lanes, the lanes' leave-one-out pairs
    met by the tree, the RE transition and each table's final as segmented
    Horner sums in delta) gives lookup_checks_plain's words, word for word,
    with words y + p at the SLDC transition's sldc - prev (lanes 1 on) and
    the p-edge band and words x + p everywhere else."""
    ext, d, coeffs, offsets, routed, maxdeg = _lookup_case(shape, 200 + shape[2] + shape[4])
    r, n_polys = d.shape[1], ext[2].shape[1] // d.shape[1]
    if ext[2].shape[0] > 1:  # lane 1's probe of chunk 0 meets the inexact subtraction: not sub of the same elements reduced
        a, b = ext[2].re[1, 1], ext[3].re[1, n_polys - 1]
        assert not torch.equal(tf.sub(a, b), tf.sub(a, b - tf.P_I64))
    deltas = [tuple(d[:, k, j] for j in range(4)) for k in range(r)]
    want = vt.lookup_checks_plain(*ext, deltas, coeffs, offsets, routed, maxdeg)
    got = lookup_checks_rows_plain(*[(x.re, x.im) for x in ext], d, coeffs, offsets, routed, maxdeg)
    assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im)


def test_lookup_split_sizes_a_tables_lanes_by_the_longest_table():
    """kernels.lookup_split: a table's lanes follow the longest padded
    table, not the tables' rows together (26 + 26 + 52 + 78 rows: 16 lanes
    of at most 8 rows, not 32); the zoo's one table of 26 rows takes 4; past
    32 lanes a lane takes more rows; other slots a lane and values a segment
    give other lanes, and the order in PyTorch on lanes passed explicitly
    still gives the plain version's words."""
    assert kernels.lookup_split(80, 6, 8, [0, 26, 52, 104, 182]) == (2, 4, 16)
    assert kernels.lookup_split(80, 6, 8, [0, 26]) == (2, 4, 4)
    assert kernels.lookup_split(80, 6, 8, [0, 312, 338]) == (2, 4, 32)
    assert kernels.lookup_split(80, 6, 8, [0, 26], 1, 1) == (8, 32, 32)
    ext, d, coeffs, offsets, routed, maxdeg = _lookup_case(LOOKUP_SHAPES[0], 7)
    r = d.shape[1]
    deltas = [tuple(d[:, k, j] for j in range(4)) for k in range(r)]
    want = vt.lookup_checks_plain(*ext, deltas, coeffs, offsets, routed, maxdeg)
    for lanes in [(1, 1, 1), (4, 8, 32)]:
        got = lookup_checks_rows_plain(*[(x.re, x.im) for x in ext], d, coeffs, offsets, routed, maxdeg, lanes)
        assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im)


@pytest.fixture(scope="module")
def two_steps():
    """A poseidon-chain proof whose FRI folds twice (arity 2), proved by the
    port's prover."""
    fx = poseidon_chain_fixture(n_chain=6, num_query_rounds=5, arity_bits=1, final_poly_bits=1)
    tpl = CircuitTemplate(fx.common)
    assert [st["arity_bits"] for st in tpl.steps] == [1, 1]
    return fx.common, tpl, prove(fx)


def _pp_lanes(pwp):
    """Three proofs: intact, one partial-product opening flipped, and every
    opening the partial products read written as x + p where it fits."""
    flipped = json.loads(json.dumps(pwp.to_json()))
    flipped["proof"]["openings"]["partial_products"][0][0] ^= 1
    noncanonical = json.loads(json.dumps(pwp.to_json()))
    op = noncanonical["proof"]["openings"]
    for key in ("plonk_sigmas", "wires", "plonk_zs", "plonk_zs_next", "partial_products"):
        for pair in op[key]:
            for i, x in enumerate(pair):
                if x < 2**64 - P:
                    pair[i] = x + P
    return [pwp] + [ProofWithPublicInputs.from_json(o) for o in (flipped, noncanonical)]


def test_partial_products_plain_equals_golden_terms(two_steps):
    """partial_products_plain's head (B, r + r n_chunks) on each lane's
    openings, the golden challenges, zeta^n and the inverse of n (zeta - 1)
    is the first r + r n_chunks terms of golden/'s constraint vector, lane
    by lane; the kernel's order gives the same words."""
    common, tpl, (vkey, pwp) = two_steps
    lanes = _pp_lanes(pwp)
    chs = [gch.proof_challenges(common, vkey, p) for p in lanes]
    n, r, maxdeg = tpl.n, tpl.r, common.quotient_degree_factor

    def ext(rows):  # (lanes, k) pairs as a GExt of u64 words, x + p kept
        a = np.array(rows, dtype=np.uint64)
        return GExt(tf.from_u64(a[..., 0], "cpu"), tf.from_u64(a[..., 1], "cpu"))

    ops = [p.proof.openings for p in lanes]
    args = (
        ext([[gf.epow(ch.zeta, n)] for ch in chs]).reshape(len(lanes)),
        ext([[gf.einv(gf.escale(n % P, gf.esub(ch.zeta, gf.EXT_ONE)))] for ch in chs]).reshape(len(lanes)),
        ext([o.plonk_zs for o in ops]), ext([o.plonk_zs_next for o in ops]), ext([o.partial_products for o in ops]),
        ext([o.wires[: tpl.n_sigmas] for o in ops]), ext([o.plonk_sigmas for o in ops]),
        tf.from_u64(np.array([ch.betas for ch in chs], np.uint64), "cpu"), tf.from_u64(np.array([ch.gammas for ch in chs], np.uint64), "cpu"),
        ext([[ch.zeta] for ch in chs]).reshape(len(lanes)), tf.from_u64(np.array(common.k_is, np.uint64), "cpu"), maxdeg,
    )
    got = vt.partial_products_plain(*args)
    width = r + r * (tpl.n_sigmas // maxdeg)
    assert got.shape == (len(lanes), width)
    for lane, (op, ch) in enumerate(zip(ops, chs)):
        want = gplonk.eval_all_plonk_constraints(common, op, ch)[:width]
        assert [_ints(got, lane, i) for i in range(width)] == [tuple(w) for w in want], lane
    assert any(_ints(got, 1, i) != (0, 0) for i in range(r, width))  # the flipped opening breaks a check
    pairs = [(x.re, x.im) if isinstance(x, GExt) else x for x in args]
    re, im = partial_products_rows_plain(*pairs)
    assert torch.equal(re, got.re) and torch.equal(im, got.im)


@pytest.mark.parametrize("maxdeg,r,n_chunks", [(1, 2, 5), (2, 1, 3), (3, 2, 4), (5, 3, 3), (8, 2, 10), (40, 1, 2)],
                         ids=["maxdeg1", "maxdeg2", "maxdeg3", "maxdeg5", "maxdeg8", "maxdeg40"])
def test_partial_products_kernel_order_equals_plain(maxdeg, r, n_chunks):
    """The kernel's order in PyTorch (partial_products_rows_plain: a lane's
    wires in order, the lanes' pairs joined by the shuffle tree, lanes past
    maxdeg holding 1) gives partial_products_plain's words, word for word,
    on the lanes kernels.partial_products_lanes gives and on every other
    power of two up to 32, with every opening word y + p in lanes 1 and 2
    and the p-edge band and words x + p in lane 0."""
    w = partial_products_words(np.random.default_rng(60 + maxdeg), 3, r, maxdeg, n_chunks, 1 << 4, above_p=(1, 2))
    args = partial_products_args(w, maxdeg)
    want = vt.partial_products_plain(*args)
    assert want.shape == (3, r + r * n_chunks)
    pairs = [(x.re, x.im) if isinstance(x, GExt) else x for x in args]
    for lanes in (None, 1, 2, 4, 8, 16, 32):
        re, im = partial_products_rows_plain(*pairs, lanes=lanes)
        assert torch.equal(re, want.re) and torch.equal(im, want.im), lanes


class _Recording:
    """The kernel library's three stage kernels in their own order
    (PlainLibrary), recording what each call was given."""

    def __init__(self):
        self.plain, self.calls = PlainLibrary(None), []

    def coset_fold(self, steps):
        self.calls.append([(e.stride(), o.stride(), br.stride(), bi.data_ptr() - br.data_ptr(), w.data_ptr()) for e, o, br, bi, w in steps])
        return self.plain.coset_fold(steps)

    def partial_products(self, *args):
        self.calls.append([x[0].stride() if isinstance(x, tuple) else x for x in args])
        return self.plain.partial_products(*args)

    def lookup_checks(self, *args):
        self.calls.append([x[0].stride() if isinstance(x, tuple) else x for x in args])
        return self.plain.lookup_checks(*args)


def test_card_path_coset_folds_steps_and_strides(monkeypatch):
    """Two steps (arity 2 and 16) on a query slice of 4 of 6 rounds: one
    call with both steps, the opened values, offsets and beta at their own
    strides and the weights as given, never copied; the plain version's
    words."""
    lib = _Recording()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    states = tf.from_u64(words(np.random.default_rng(5), (B, 12)), "cpu")
    beta = GExt(states[:, 3], states[:, 4])  # a transcript's squeeze: stride 12
    steps = [_fold_inputs(20 + bits, bits) for bits in (1, 4)]
    evals, offs = [e[:, 1:5] for e, _, _ in steps], [o[:, 1:5] for _, o, _ in steps]
    idfts = [_idft(1), _idft(4)]
    got = vt._coset_folds_kernel(evals, offs, [beta, beta], idfts)
    want = [vt.coset_fold_plain(e, o, beta, _perm(bits), w) for e, o, bits, w in zip(evals, offs, (1, 4), idfts)]
    for g, w in zip(got, want):
        assert torch.equal(g.re, w.re) and torch.equal(g.im, w.im)
    (call,) = lib.calls
    assert call == [((Q * 4, 4, 2, 1), (Q, 1), (12,), 8, idfts[0].data_ptr()), ((Q * 32, 32, 2, 1), (Q, 1), (12,), 8, idfts[1].data_ptr())]


def test_card_path_partial_products_views_of_openings(monkeypatch, two_steps):
    """The verifier's own call: the openings as views of openings1 and
    openings2 (column stride 2), k_is the verifier's buffer; the plain
    version's words."""
    lib = _Recording()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    _, tpl, proof = two_steps
    v = vt.TorchVerifier(tpl, device="cpu")
    calls = []
    monkeypatch.setattr(vt, "partial_products", lambda *a: calls.append(a) or vt.partial_products_plain(*a))
    with torch.no_grad():
        v(v.prepare(flatten_proofs(tpl, [proof] * 2)))
    (args,) = calls
    got = vt._partial_products_kernel(*args)
    want = vt.partial_products_plain(*args)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    (call,) = lib.calls
    m1 = 2 * (tpl.n_const_cols + tpl.n_sigmas + tpl.num_wires + tpl.n_zs + tpl.n_pp + tpl.n_quot + tpl.n_lookup)
    m2 = 2 * (tpl.n_zs + tpl.n_lookup)
    assert call[2:7] == [(m1, 2), (m2, 2), (m1, 2), (m1, 2), (m1, 2)]  # zs, zs_next, pps, wires, sigmas
    assert call[10] is v._k_is and call[11] == tpl.common.quotient_degree_factor


def test_card_path_lookup_checks_views_and_tables(monkeypatch):
    """Openings as views (column stride 2), the four challenges of each
    round stacked to (B, r, 4), the tables as the buffers given; the plain
    version's words."""
    from plonky2_verifier_tpu_torch.tools.check_field_kernels import LOOKUP_SHAPES

    lib = _Recording()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    rng = np.random.default_rng(7)
    _, r, routed, n_polys, maxdeg, lengths = LOOKUP_SHAPES[0]
    common = type("Common", (), {"config": type("Config", (), {"num_routed_wires": routed}), "luts": [
        [tuple(int(x) for x in row) for row in rng.integers(0, 1 << 16, size=(n, 2))] for n in lengths]})
    coeffs, offsets = vt.lookup_tables(common, "cpu")
    widths = [4 + len(lengths), routed, r * n_polys, r * n_polys]
    at = np.concatenate([[0], np.cumsum(widths)])
    op = tf.from_u64(words(rng, (B, int(at[-1]), 2)), "cpu")
    sels, wires, zs, zs_next = (GExt(op[:, at[i] : at[i + 1], 0], op[:, at[i] : at[i + 1], 1]) for i in range(4))
    d = tf.from_u64(rng.integers(0, P, size=(B, 4 * r), dtype=np.uint64), "cpu")
    deltas = [tuple(d[:, 4 * k + j] for j in range(4)) for k in range(r)]
    got = vt._lookup_checks_kernel(sels, wires, zs, zs_next, deltas, coeffs, offsets, routed, maxdeg)
    want = vt.lookup_checks_plain(sels, wires, zs, zs_next, deltas, coeffs, offsets, routed, maxdeg)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    (call,) = lib.calls
    width = 2 * int(at[-1])
    assert call[:4] == [(width, 2)] * 4 and call[5] is coeffs and call[6] is offsets
    assert call[4].shape == (B, r, 4) and call[4].stride() == (4 * r, 4, 1)
    stacked = lookup_checks_rows_plain(*[(x.re, x.im) for x in (sels, wires, zs, zs_next)], d.reshape(B, r, 4), coeffs, offsets, routed, maxdeg)
    assert torch.equal(stacked[0], want.re) and torch.equal(stacked[1], want.im)


MUTATED = {1: "step_evals_1", 2: "partial_products"}  # lane -> what is flipped; lanes 0 and 3 intact


@pytest.fixture(scope="module")
def mutated_forward(two_steps):
    """The two-step proof in four lanes, a word of step_evals_1 flipped in
    lane 1 and the first partial-product opening in lane 2 (in the proof's
    JSON, so golden/ sees it too), through TorchVerifier on the CPU, again
    with every stage's card path on the stand-in library, and through
    JaxVerifier."""
    common, tpl, (vkey, pwp) = two_steps
    step = json.loads(json.dumps(pwp.to_json()))
    step["proof"]["opening_proof"]["query_round_proofs"][0]["steps"][1]["evals"][0][0] ^= 1
    pp = json.loads(json.dumps(pwp.to_json()))
    pp["proof"]["openings"]["partial_products"][0][0] ^= 1
    lanes = [pwp] + [ProofWithPublicInputs.from_json(o) for o in (step, pp)] + [pwp]
    arrays = flatten_proofs(tpl, [(vkey, p) for p in lanes])
    v = vt.TorchVerifier(tpl, device="cpu")
    with torch.no_grad():
        port = v(v.prepare(arrays))
        lib = PlainLibrary(None)
        mp = pytest.MonkeyPatch()
        mp.setattr(kernels, "load", lambda: lib)
        for name in ("coset_folds", "partial_products", "lookup_checks"):  # their card paths, on CPU tensors
            mp.setattr(vt, name, getattr(vt, f"_{name}_kernel") if name != "coset_folds" else
                       (lambda e, o, b, p, w: vt._coset_folds_kernel(e, o, b, w)))
        try:
            card = v(v.prepare(arrays))
        finally:
            mp.undo()
    jv = JaxVerifier(JaxTemplate(jax_types.CommonCircuitData.from_json(common.to_json())))
    jax_out = jv(jv.prepare(arrays))  # flatten_proofs' arrays are the JAX package's (tests/test_torch_host_tier.py)
    golden = []
    for p in lanes:
        ch = gch.proof_challenges(common, vkey, p)
        eqs = all(gplonk.check_combined_plonk_equations(common, p, ch))
        fri = gfri.check_fri_proof(common, vkey, p.proof, ch)
        golden.append((eqs and fri, eqs, fri))
    return port, card, jax_out, golden, lib.launches


def test_mutated_stage_lanes_rejected_on_exactly_their_lanes(mutated_forward):
    port, card, jax_out, golden, launches = mutated_forward
    verdicts = lambda out: [tuple(bool(np.asarray(out[k])[lane]) for k in ("ok", "eqs_ok", "fri_ok")) for lane in range(4)]
    assert verdicts(port) == verdicts(card) == verdicts(jax_out) == golden
    assert [ok for ok, _, _ in golden] == [lane not in MUTATED for lane in range(4)]
    assert golden[1] == (False, True, False)  # a coset value: FRI alone
    assert (launches["coset_fold"], launches["partial_products"], launches["lookup_checks"]) == (1, 1, 0)
