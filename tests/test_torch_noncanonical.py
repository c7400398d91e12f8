"""The port keeps the JAX package's bits on raw proof words above p.

Where a subtraction's subtrahend is a raw proof word written as y + p
(0 < y < 2^32 - 1) above the minuend + p, ops/field.sub, the port's as the
JAX package's (plonky2_verifier_tpu/ops/field.py), is not exact mod p;
golden/ reduces its operands first and gives other words (ROADMAP.md Queue
3 lists every such site). Two sites subtract such a word:

- the SLDC transition's sldc - prev in the lookup argument
  (`verifier_torch.lookup_checks_plain`; on the card csrc/plonk.cu, whose
  order in PyTorch is `check_field_kernels.lookup_checks_rows_plain`),
- the selector factors' consts - x in `verifier_torch.eval_selectors`, x the
  gate-selector columns of openings1, and so the gate filter
  (`gate_filter_plain`; on the card csrc/plonk.cu, whose order in PyTorch is
  `check_field_kernels.gate_filter_rows_plain`).

Function by function on the CPU, no proof: the lookup fixture's template,
openings of random words with such subtrahends written in, through the port
(the plain version and the kernel's order) and through the JAX package's
`JaxVerifier._lookup_checks` / `_eval_selectors` / its filtered sum: the same words. Each case
also shows that it reaches the inexact subtraction: the same elements
reduced first (golden/'s side) give other words on the probed lanes.

L0 with the partial products is exact mod p on any words (csrc/plonk.cu
says why), so there the reduced words give the same answer: on openings
with every word y + p, `partial_products_plain` and the kernel's order
(`check_field_kernels.partial_products_rows_plain`: lanes, shuffle tree)
give the words of `JaxVerifier._plonk_checks`' head (verifier_jax.py:
345-385, run eagerly up to the selectors) and of golden/'s terms on the
reduced words, at maxdeg 2, 3, 5, 8 and 40 (above a warp) and 1-3 rounds.

Tolerance: none (integers mod p, bit for bit)."""

import inspect
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from plonky2_verifier_tpu.compiler.template import CircuitTemplate as JaxTemplate
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu.verifier_jax import JaxVerifier, _unsq
from plonky2_verifier_tpu.verifier_jax import ext_sum_axis as jax_ext_sum_axis
from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch import verifier_torch as vt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.golden import field as gf
from plonky2_verifier_tpu_torch.models.lookup import lookup_fixture
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops.field import GExt, to_u64
from plonky2_verifier_tpu_torch.tools.check_field_kernels import (
    golden_partial_products,
    partial_products_args,
    partial_products_rows_plain,
    partial_products_words,
    probe_sldc_subtrahends,
    words,
)
from plonky2_verifier_tpu_torch.tools.check_hash_kernels import PlainLibrary
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

P = gf.P


@pytest.fixture(scope="module")
def verifiers():
    """The lookup fixture's template (2 rounds, 6 SLDC chunks, 80 routed
    wires, one table; several selector groups) in both packages; no proof."""
    common = lookup_fixture(num_query_rounds=4, proof_of_work_bits=4).common
    return common, vt.TorchVerifier(CircuitTemplate(common), device="cpu"), JaxVerifier(JaxTemplate(common))


def _port(a: np.ndarray) -> GExt:
    return GExt(tf.from_u64(a[..., 0], "cpu"), tf.from_u64(a[..., 1], "cpu"))


def _jax(a: np.ndarray):
    return jf.ext_from_u64(a[..., 0], a[..., 1])


def _words(x) -> np.ndarray:
    return np.stack([to_u64(x.re), to_u64(x.im)], axis=-1)


def test_lookup_checks_equal_jax_on_noncanonical_subtrahends(verifiers, monkeypatch):
    """Lanes 1-6 carry at every SLDC chunk's sldc - prev (one chunk a lane,
    both rounds) a subtrahend y + p above the minuend + p, lane 0 the words
    of words() (the p-edge band and x + p): the port's plain version and
    the kernel's order give JaxVerifier._lookup_checks' words; reduced
    first, each of lanes 1-6 reads otherwise."""
    common, tv, jv = verifiers
    tpl = tv.tpl
    r, n_polys = tpl.r, common.num_lookup_polys
    B = 1 + n_polys - 1
    rng = np.random.default_rng(31)
    arrays = {"lkp_sels": words(rng, (B, 4 + common.num_luts, 2)), "wires": words(rng, (B, tpl.num_wires, 2)),
              "lookup_zs": words(rng, (B, r * n_polys, 2)), "lookup_zs_next": words(rng, (B, r * n_polys, 2))}
    probe_sldc_subtrahends(rng, arrays["lookup_zs"], arrays["lookup_zs_next"], r, n_polys, range(1, B))
    deltas = [[rng.integers(0, P, size=B, dtype=np.uint64) for _ in range(4)] for _ in range(r)]
    port_deltas = [tuple(tf.from_u64(x, "cpu") for x in d) for d in deltas]
    names = ("lkp_sels", "wires", "lookup_zs", "lookup_zs_next")

    got = tv._lookup_checks(*[_port(arrays[k]) for k in names], port_deltas)
    lib = PlainLibrary(None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    order = vt._lookup_checks_kernel(*[_port(arrays[k]) for k in names], port_deltas, tv._lut_coeffs, tv._lut_off,
                                     common.config.num_routed_wires, common.quotient_degree_factor)
    ref = jax.jit(jv._lookup_checks)(*[_jax(arrays[k]) for k in names], [tuple(jf.from_u64(x) for x in d) for d in deltas])
    ref = np.stack([np.asarray(x) for x in jf.ext_to_u64(ref)], axis=-1)
    np.testing.assert_array_equal(_words(got), ref)
    np.testing.assert_array_equal(_words(order), ref)

    reduced = tv._lookup_checks(*[_port(arrays[k] % np.uint64(P)) for k in names], port_deltas)
    differs = (_words(reduced) != ref).any(axis=(1, 2))
    assert differs[1:].all(), differs


def _selector_words(tv, seed):
    """Gate-selector openings of 3 lanes: lane 1 has every column written as
    y + p (n_gates < y < 2^32 - 1, above every gate-index factor; the UNUSED
    factor 2^32 - 1 stays above it), lanes 0 and 2 the words of words()."""
    n_sel = tv.tpl.n_gate_selectors
    n_gates = len(tv.tpl.common.selectors_info.selector_indices)
    rng = np.random.default_rng(seed)
    sels = words(rng, (3, n_sel, 2))
    sels[1] = rng.integers(n_gates + 1, (1 << 32) - 1, size=(n_sel, 2), dtype=np.uint64) + np.uint64(P)
    return sels, rng


def test_eval_selectors_equal_jax_on_noncanonical_subtrahends(verifiers):
    """consts - x with x the gate-selector openings of _selector_words: the
    port's eval_selectors on the live gates' rows gives JaxVerifier's words
    for those gates; reduced first, lane 1 reads otherwise."""
    common, tv, jv = verifiers
    sels, _ = _selector_words(tv, 32)
    rows = (tv._filter_cols, tv._filter_consts, tv._filter_mask)
    got = vt.eval_selectors(_port(sels), *rows)
    ref = jv._eval_selectors(_jax(sels))[:, np.array(tv._live_gates)]
    ref = np.stack([np.asarray(x) for x in jf.ext_to_u64(ref)], axis=-1)
    np.testing.assert_array_equal(_words(got), ref)

    reduced = _words(vt.eval_selectors(_port(sels % np.uint64(P)), *rows))
    assert (reduced[1] != ref[1]).any()


def test_gate_filter_equal_jax_on_noncanonical_subtrahends(verifiers, monkeypatch):
    """The filtered sum of the gate constraints on the selector words of
    _selector_words: gate_filter_plain and the card path's order
    (_gate_filter_kernel over gate_filter_rows_plain) give the words of
    JaxVerifier's selectors, gathered, multiplied and summed as its
    _plonk_checks does; reduced first, each reads otherwise exactly where
    the plain version does, lane 1 among them."""
    common, tv, jv = verifiers
    sels, rng = _selector_words(tv, 33)
    n_gc, live = common.num_gate_constraints, tv._live_gates
    cons = words(rng, (3, len(live) * n_gc, 2))
    rows = (tv._filter_cols, tv._filter_consts, tv._filter_mask)
    lib = PlainLibrary(None)
    monkeypatch.setattr(kernels, "load", lambda: lib)

    def port(s):
        return (_words(vt.gate_filter_plain(_port(s), _port(cons), *rows, n_gc)),
                _words(vt._gate_filter_kernel(_port(s), _port(cons), *rows, n_gc)))

    plain, order = port(sels)
    sel_live = jv._eval_selectors(_jax(sels))[:, np.array(live)]
    ref = jax_ext_sum_axis(jf.emul(_unsq(sel_live, -1), _jax(cons.reshape(3, len(live), n_gc, 2))), axis=1)
    ref = np.stack([np.asarray(x) for x in jf.ext_to_u64(ref)], axis=-1)
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(order, ref)
    assert lib.launches["gate_filter"] == 1

    plain_red, order_red = port(sels % np.uint64(P))
    differs = plain != plain_red
    np.testing.assert_array_equal(order != order_red, differs)
    assert differs[1].any()


PP_CASES = [(2, 1, 3), (3, 2, 4), (5, 3, 3), (8, 2, 10), (40, 1, 2)]  # (maxdeg, r, n_chunks)
PP_IDS = [f"maxdeg{m}-r{r}-chunks{c}" for m, r, c in PP_CASES]
PP_N = 1 << 5


def _pp_words(maxdeg, r, n_chunks):
    """Lane 0 the words of words(), lanes 1 and 2 every opening word y + p."""
    return partial_products_words(np.random.default_rng(40 + maxdeg + r), 3, r, maxdeg, n_chunks, PP_N, above_p=(1, 2))


class _HeadDone(Exception):
    pass


def _jax_head(w: dict, maxdeg: int) -> np.ndarray:
    """JaxVerifier._plonk_checks on the CPU, eagerly, as far as its first
    call after the partial products (_eval_selectors), on a stand-in
    template of these shapes; its (B, r + r n_chunks) head, zs1 ++ pp_vec,
    read from the method's own frame there."""
    B, r = w["zs"].shape[:2]
    ns = w["sigmas"].shape[1]
    common = SimpleNamespace(quotient_degree_factor=maxdeg, k_is=[int(k) for k in w["k_is"]], num_partial_products=ns // maxdeg - 1,
                             num_lookup_polys=0)
    tpl = SimpleNamespace(common=common, r=r, n=PP_N, n_sigmas=ns, n_gate_selectors=0, n_lookup_selectors=0)
    head = {}

    def eval_selectors(_):
        head.update(inspect.currentframe().f_back.f_locals)
        raise _HeadDone

    e = lambda k: _jax(w[k])
    betas, gammas = jf.from_u64(w["betas"]), jf.from_u64(w["gammas"])
    with pytest.raises(_HeadDone):
        JaxVerifier._plonk_checks(SimpleNamespace(tpl=tpl, _eval_selectors=eval_selectors), None, None, jf.ext_zeros((B, 0)),
                                  e("sigmas"), e("wires"), e("zs"), e("zs_next"), e("pps"), None, None, None,
                                  [betas[:, i] for i in range(r)], [gammas[:, i] for i in range(r)], [], [], e("zeta"))
    out = jf.ext_concat([head["zs1"], head["pp_vec"]], axis=1)
    return np.stack([np.asarray(x) for x in jf.ext_to_u64(out)], axis=-1)


@pytest.mark.parametrize("maxdeg,r,n_chunks", PP_CASES, ids=PP_IDS)
def test_partial_products_equal_jax_on_words_above_p(maxdeg, r, n_chunks):
    """partial_products_plain and the kernel's order give JaxVerifier's L0
    and partial-product head word for word, lanes 1 and 2 with every
    opening word y + p."""
    w = _pp_words(maxdeg, r, n_chunks)
    assert (w["wires"][1] >= P).all() and (w["pps"][2] >= P).all()
    args = partial_products_args(w, maxdeg)
    ref = _jax_head(w, maxdeg)
    assert ref.shape == (3, r + r * n_chunks, 2)
    np.testing.assert_array_equal(_words(vt.partial_products_plain(*args)), ref)
    order = partial_products_rows_plain(*[(x.re, x.im) if isinstance(x, GExt) else x for x in args])
    np.testing.assert_array_equal(_words(GExt(*order)), ref)


@pytest.mark.parametrize("maxdeg,r,n_chunks", PP_CASES, ids=PP_IDS)
def test_partial_products_plain_equals_golden_on_reduced_words(maxdeg, r, n_chunks):
    """Every op of L0 and the partial products is exact mod p on any u64
    words: on the words y + p the plain version gives golden/'s terms on
    the same words reduced mod p, every lane, and its own words on the
    reduced inputs."""
    w = _pp_words(maxdeg, r, n_chunks)
    got = _words(vt.partial_products_plain(*partial_products_args(w, maxdeg)))
    reduced = {k: x % np.uint64(P) for k, x in w.items()}
    np.testing.assert_array_equal(_words(vt.partial_products_plain(*partial_products_args(reduced, maxdeg))), got)
    ints = lambda a: [tuple(int(v) for v in x) for x in a]
    for lane in range(3):
        gold = golden_partial_products(PP_N, tuple(int(v) for v in reduced["zeta"][lane]), ints(reduced["zs"][lane]),
                                       ints(reduced["zs_next"][lane]), ints(reduced["pps"][lane]), ints(reduced["wires"][lane]),
                                       ints(reduced["sigmas"][lane]), [int(x) for x in reduced["betas"][lane]],
                                       [int(x) for x in reduced["gammas"][lane]], [int(x) for x in reduced["k_is"]], maxdeg)
        assert [tuple(int(v) for v in x) for x in got[lane]] == gold, lane


# The hash kernels read raw proof words too (leaf rows, digests, siblings,
# transcript data), p and 2^64 - 1 among them. tests/test_torch_kernels.py
# holds the kernels on the card to the plain versions on such words; here the
# plain versions are held to golden/ on the same kind of words.
HASH_EDGE = np.array([0, 1, P - 1, P, 2**64 - 1], dtype=np.uint64)
HASH_CASES = ["merkle L=3, index bits 0", "merkle L=11, index bits 1", "sponge, fibonacci widths", "sponge, gate zoo widths", "scan"]


def _edge_words(seed, shape):
    return HASH_EDGE[np.random.default_rng(seed).integers(0, len(HASH_EDGE), size=shape)]


@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_plain_versions_equal_golden_on_edge_words(case):
    from plonky2_verifier_tpu_torch.golden import hashing as gh
    from plonky2_verifier_tpu_torch.golden import poseidon as gp
    from plonky2_verifier_tpu_torch.ops import hash as th
    from plonky2_verifier_tpu_torch.ops import poseidon as tp

    consts = tp.PoseidonConstants("cpu")
    rows = lambda a: [[int(x) for x in r] for r in a]
    if case.startswith("merkle"):
        path_len = 3 if "L=3" in case else 11
        dig, sibs = _edge_words(1, (5, 4)), _edge_words(2, (5, path_len, 4))
        dig[:] = HASH_EDGE[:, None]  # one edge word in every lane of a digest
        idx = np.full(5, 0 if case.endswith("0") else (1 << path_len) - 1, dtype=np.int64)
        got = to_u64(th.merkle_fold_plain(tf.from_u64(dig, "cpu"), torch.from_numpy(idx), tf.from_u64(sibs, "cpu"), path_len, consts))
        for i in range(5):
            assert tuple(int(x) for x in got[i]) == gh.reconstruct_merkle_root(tuple(rows(dig)[i]), int(idx[i]), [tuple(s) for s in rows(sibs[i])])[1]
    elif case.startswith("sponge"):
        widths = [135, 83, 32, 32, 20, 16] if "fibonacci" in case else [135, 91, 34, 32, 32, 16]
        group = [_edge_words(10 + k, (3, w)) for k, w in enumerate(widths)]
        for g, digests in zip(group, th.sponge_rows_grouped_plain([tf.from_u64(g, "cpu") for g in group], consts)):
            assert [tuple(int(x) for x in d) for d in to_u64(digests)] == [gh.sponge(r) for r in rows(g)]
    else:
        data = _edge_words(20, (2, 40))
        rng = np.random.default_rng(21)
        ov_idx, ov_mask = rng.integers(0, 40, size=(6, 12), dtype=np.int64), rng.integers(0, 3, size=(6, 12)) == 0
        got = to_u64(tp.permutation_scan_plain(tf.from_u64(data, "cpu"), torch.from_numpy(ov_idx), torch.from_numpy(ov_mask), consts))
        for b in range(2):
            state = [0] * 12
            for step in range(6):
                state = gp.permutation([int(data[b, j]) if m else s for j, m, s in zip(ov_idx[step], ov_mask[step], state)])
                assert [int(x) for x in got[step, b]] == state
