"""The field glue that launches the field kernels on the card
(csrc/field.cu), on the CPU: `verifier_torch.horner_ext` and
`horner_scaled` take their plain versions for CPU tensors, and each, with
`ops/field.inv_plain`, is held bit for bit against the JAX package's own
function on the CPU (`verifier_jax.horner_ext`, `horner_scaled`,
`ops.field.inv`).

Inputs are made with numpy from a seed, half drawn from the p-edge band and
half non-canonical words x + p (x < 2^32 - 1), as proof words may be. The
shapes are the verifier's in small: combineInitial's base-field leaf words
(3, 7, 254), the reduced openings (3, 16), horner_scaled's (3, 2, 5) and
(3, 5) x (3, 2), no coefficients and no rows. A point with a zero imaginary
part gives the same bits as a base-field point through both forms, which
is what the kernel's BASE_POINT flag relies on. Last, the wrappers' card
path (`_horner_kernel`: the verifier's views flattened to rows, stride-0
rows passed as repeats) with the kernel library replaced by the plain
version of its interface. The same for the exponentiations
(`ops/field.pow_grouped` answers an extension base at e = 0 and 1 on the
host, without a launch) and the gate
program (`GateProgram._forward_kernel`: the inputs' views at their strides,
the program packed for the verifier's padded slots) and the gate filter
(`_gate_filter_kernel`: the selector columns' view and the template's
rows as they lie; `_plonk_checks` hands it those and indexes nothing by a
Python list; `gate_filter_plain` against the chain it replaced, on both
benchmark templates). The Horner kernel's
own order of products and adds (`horner_split_plain`, every segment count)
against the plain chain, and the rule that picks the segments. Tolerance:
bit-exact. One verifier forward (the gate filter's call site)."""

import os

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu import verifier_jax as vj
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch import verifier_torch as vt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs, gates_torch
from plonky2_verifier_tpu_torch.golden.plonk import UNUSED_SELECTOR
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
from plonky2_verifier_tpu_torch.types import load_common
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops.field import GExt
from plonky2_verifier_tpu_torch.tools.check_field_kernels import (
    gate_filter_rows_plain,
    gate_programs,
    golden_packed_program,
    horner_split_plain,
    horner_rows_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

P = tf.P
EDGE = np.array([0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**32 + 1, 2**63, P - 2**32], dtype=np.uint64)


def _words(seed, shape) -> np.ndarray:
    """Half the edge band, half x + p with x < 2^32 - 1, shuffled."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    w = np.concatenate([EDGE[rng.integers(0, len(EDGE), size=n - n // 2)], rng.integers(0, 2**32 - 1, size=n // 2, dtype=np.uint64) + np.uint64(P)])
    rng.shuffle(w)
    return w.reshape(shape)


def _ext_np(seed, shape):
    return _words(seed, shape), _words(seed + 1000, shape)


def _port(re, im=None) -> GExt:
    return GExt(tf.from_u64(re, "cpu"), tf.from_u64(np.zeros_like(re) if im is None else im, "cpu"))


def _jax(re, im=None):
    return jf.GExt(jf.from_u64(re), jf.from_u64(np.zeros_like(re) if im is None else im))


def _equal(port: GExt, jax_out):
    np.testing.assert_array_equal(tf.to_u64(port.re), jf.to_u64(jax_out.re))
    np.testing.assert_array_equal(tf.to_u64(port.im), jf.to_u64(jax_out.im))


@pytest.mark.parametrize("lead,k", [((3, 7), 254), ((3,), 16), ((3, 2), 5), ((3,), 0), ((0,), 5)], ids=["leaves", "openings", "quotient", "K0", "N0"])
def test_horner_ext_extension_values(lead, k):
    v, pt = _ext_np(1, lead + (k,)), _ext_np(2, lead)
    got = vt.horner_ext(_port(*v), _port(*pt))
    assert got.shape == lead
    _equal(got, vj.horner_ext(_jax(*v), _jax(*pt)))


@pytest.mark.parametrize("lead,k", [((3, 7), 254), ((3,), 16), ((3,), 0)], ids=["leaves", "openings", "K0"])
def test_horner_ext_base_field_values(lead, k):
    """Values given as a base-field tensor (combineInitial's form) against the
    JAX function on ext_from_base of the same words."""
    v, pt = _words(3, lead + (k,)), _ext_np(4, lead)
    got = vt.horner_ext(tf.from_u64(v, "cpu"), _port(*pt))
    _equal(got, vj.horner_ext(jf.ext_from_base(jf.from_u64(v)), _jax(*pt)))


@pytest.mark.parametrize("v_shape,s_shape", [((3, 2, 5), (3, 2)), ((3, 5), (3, 2)), ((3, 0), (3, 2)), ((0, 5), (0, 2))], ids=["same-lead", "extra-axis", "K0", "N0"])
def test_horner_scaled(v_shape, s_shape):
    v, s = _ext_np(5, v_shape), _words(6, s_shape)
    got = vt.horner_scaled(_port(*v), tf.from_u64(s, "cpu"))
    assert got.shape == s_shape
    _equal(got, vj.horner_scaled(_jax(*v), jf.from_u64(s)))


@pytest.mark.parametrize("base_values", [False, True], ids=["ext-values", "base-values"])
def test_point_with_zero_imaginary_part_through_both_forms(base_values):
    """emul with im = 0 and escale give the same bits: horner_ext at
    (x, 0), horner_ext at the base-field x and horner_scaled at x agree with
    each other and with both JAX functions."""
    lead, k = (3, 7), 33
    v = (_words(7, lead + (k,)), None) if base_values else _ext_np(7, lead + (k,))
    x = _words(8, lead)
    values = tf.from_u64(v[0], "cpu") if base_values else _port(*v)
    at_pair = vt.horner_ext(values, _port(x))
    at_base = vt.horner_ext(values, tf.from_u64(x, "cpu"))
    scaled = vt.horner_scaled(vt.as_ext(values), tf.from_u64(x, "cpu"))
    for got in (at_base, scaled):
        assert torch.equal(got.re, at_pair.re) and torch.equal(got.im, at_pair.im)
    _equal(at_pair, vj.horner_ext(_jax(*v), _jax(x)))
    _equal(at_pair, vj.horner_scaled(_jax(*v), jf.from_u64(x)))


@pytest.mark.parametrize("shape", [(3, 28), (517,), (0,)])
def test_inv(shape):
    a = _words(9, shape)
    got = tf.to_u64(tf.inv_plain(tf.from_u64(a, "cpu")))
    np.testing.assert_array_equal(got, jf.to_u64(jf.inv(jf.from_u64(a))))
    assert [int(x) for x in got.reshape(-1)] == [pow(int(x) % P, P - 2, P) for x in a.reshape(-1)]


def test_inv_of_zero_is_zero():
    zero = np.array([0, P], dtype=np.uint64)  # 0 and its non-canonical twin
    assert tf.to_u64(tf.inv_plain(tf.from_u64(zero, "cpu"))).tolist() == [0, 0]
    assert jf.to_u64(jf.inv(jf.from_u64(zero))).tolist() == [0, 0]


@pytest.mark.parametrize("segments", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 254])
def test_horner_split_order_equals_the_plain_order(k, segments):
    """The Horner kernel's order (check_field_kernels.horner_split_plain: a
    row's columns s, s + S, ... a segment in point^S, then a tree over the
    segments) gives the plain chain's words, every flag pair, on the edge
    band and words x + p, the point x + p too."""
    v, pt = _ext_np(50 + k, (3, k)), _ext_np(60 + segments, (3,))
    for base_v in (False, True):
        for base_p in (False, True):
            args = (tf.from_u64(v[0], "cpu"), None if base_v else tf.from_u64(v[1], "cpu"),
                    tf.from_u64(pt[0], "cpu"), None if base_p else tf.from_u64(pt[1], "cpu"))
            got = horner_split_plain(*args, segments=segments)
            want = vt.horner_ext_plain(vt.as_ext(args[0] if base_v else GExt(args[0], args[1])),
                                       vt.as_ext(args[2] if base_p else GExt(args[2], args[3])))
            assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im), (base_v, base_p)


def test_horner_segments_at_the_verifier_shapes():
    """The rule that picks a row's segments (kernels.horner_segments) at the
    main path's sums, batch 1024 on 132 SMs: combineInitial's g0 2, the
    reduced opening y0 32, horner_scaled 8, a coset fold, the final
    polynomial and the quotient 2, g1 and y1 1; always a power of two up to
    32, every segment at least 4 values, and no doubling once the rows'
    threads reach 256 an SM."""
    picks = {(28672, 254): 2, (1024, 254): 32, (28672, 16): 2, (2048, 8): 2, (28672, 2): 1, (1024, 2): 1, (2048, 42): 8}
    assert {shape: kernels.horner_segments(*shape, 132) for shape in picks} == picks
    for rows in (0, 1, 7, 1024, 10**6):
        for k in (0, 1, 8, 15, 16, 255, 256, 10**4):
            s = kernels.horner_segments(rows, k, 132)
            assert s in (1, 2, 4, 8, 16, 32) and (s == 1 or (s * 4 <= k and s // 2 * rows < 132 * 256))


class _RowsLibrary:
    """The kernel library's `horner` by the plain version, recording what
    each call was given."""

    def __init__(self):
        self.calls = []

    def horner(self, v_re, v_im, p_re, p_im, v_rep=1, p_rep=1):
        self.calls.append({"v_rows": v_re.shape[0], "v_rep": v_rep, "p_rows": p_re.shape[0], "p_rep": p_rep,
                           "v_strides": v_re.stride(), "base": (v_im is None, p_im is None)})
        return horner_rows_plain(v_re, v_im, p_re, p_im, v_rep, p_rep)


def _layouts():
    """The views the verifier hands the Horner wrappers (B = 6, Q = 5, r = 2)
    and the rows, repeats and flags that must reach the kernel."""
    B, Q, r = 6, 5, 2
    op = tf.from_u64(_words(10, (B, 40, 2)), "cpu")
    o1 = GExt(op[..., 0], op[..., 1])
    alpha = _port(*_ext_np(11, (B,)))
    bq = GExt(alpha.re.unsqueeze(1).expand(B, Q), alpha.im.unsqueeze(1).expand(B, Q))
    leaves = tf.from_u64(_words(12, (B, Q, 37)), "cpu")
    zeta = _port(*_ext_np(13, (B, 1)))
    x = tf.from_u64(_words(14, (B, Q)), "cpu")
    fp = GExt(op[:, :8, 0].unsqueeze(1).expand(B, Q, 8), op[:, :8, 1].unsqueeze(1).expand(B, Q, 8))
    unlike = GExt(tf.from_u64(_words(15, (B, 1, 9)), "cpu").expand(B, Q, 9), tf.from_u64(_words(16, (B, Q, 9)), "cpu"))
    return [
        ("reduced openings", o1, alpha, {"v_rows": B, "v_rep": 1, "p_rows": B, "p_rep": 1, "v_strides": (80, 2), "base": (False, False)}),
        ("combineInitial", leaves, bq, {"v_rows": B * Q, "v_rep": 1, "p_rows": B, "p_rep": Q, "v_strides": (37, 1), "base": (True, False)}),
        ("quotient", o1[:, 10:26].reshape(B, r, 8), GExt(zeta.re.expand(B, r), zeta.im.expand(B, r)),
         {"v_rows": B * r, "v_rep": 1, "p_rows": B, "p_rep": r, "v_strides": (8, 1), "base": (False, False)}),
        ("final polynomial", fp, x, {"v_rows": B, "v_rep": Q, "p_rows": B * Q, "p_rep": 1, "v_strides": (80, 2), "base": (False, True)}),
        ("parts laid out unlike each other", unlike, bq, {"v_rows": B * Q, "v_rep": 1, "p_rows": B, "p_rep": Q, "v_strides": (9, 1), "base": (False, False)}),
    ]


@pytest.mark.parametrize("case", range(5), ids=[c[0] for c in _layouts()])
def test_card_path_rows_and_repeats(monkeypatch, case):
    """`_horner_kernel` on the verifier's own views: a stride-0 axis reaches
    the kernel as a repeat (never copied), a reshape that cannot be merged
    is copied without repeats, and the result equals the plain version's."""
    lib = _RowsLibrary()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    _, values, point, want = _layouts()[case]
    got = vt._horner_kernel(values, point)
    plain = vt.horner_ext_plain(vt.as_ext(values), vt.as_ext(point))
    assert torch.equal(got.re, plain.re) and torch.equal(got.im, plain.im)
    assert lib.calls == [want]


def test_card_path_horner_scaled_broadcasts_values_over_scales(monkeypatch):
    lib = _RowsLibrary()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    values, scale = _port(*_ext_np(17, (6, 11))), tf.from_u64(_words(18, (6, 2)), "cpu")
    got = vt._horner_kernel(values.reshape(6, 1, 11).expand(6, 2, 11), scale)
    want = vt.horner_scaled_plain(values, scale)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert lib.calls == [{"v_rows": 6, "v_rep": 2, "p_rows": 12, "p_rep": 1, "v_strides": (11, 1), "base": (False, True)}]


class _FieldLibrary:
    """The kernel library's `gate_program` by its plain version, recording
    what each call was given."""

    def __init__(self):
        self.calls = []

    def gate_program(self, inputs, packed):
        self.calls.append({"strides": [None if re is None else (re.stride(), im.stride()) for _, re, im in inputs],
                           "ops": packed.ops.shape[0], "out": packed.n_out, "n_slots": packed.n_slots})
        return golden_packed_program(inputs, packed)


@pytest.mark.parametrize("e", [0, 1])
def test_ext_pow_const_small_exponents_launch_nothing(monkeypatch, e):
    """pow_grouped's card path answers an extension base at e = 0 and 1 as
    the plain version answers them, on any device: (1, 0), and the input
    itself (x + p stays x + p); the library gets no segment and launches
    nothing."""
    got = []

    class Library:
        def pow_grouped(self, idx, gens, exts):
            got.append((idx, gens, exts))
            return [], []

    monkeypatch.setattr(kernels, "load", lambda: Library())
    meta = GExt(torch.empty((4, 3), dtype=torch.int64, device="meta"), torch.empty((4, 3), dtype=torch.int64, device="meta"))
    gens, (out,) = tf.pow_grouped(torch.empty((4, 3), dtype=torch.int64, device="meta"), [], [(meta, e)])
    assert gens == [] and got == [(None, [], [])]
    assert out.shape == (4, 3) and (out is meta) == (e == 1)


def test_card_path_gate_program_views_and_slots(monkeypatch):
    """`_forward_kernel` on inputs at the verifier's strides (column stride
    2, never copied) gives the plain loop's constraints, whole, per program
    and at padded slots (0 reads zero)."""
    lib = _FieldLibrary()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    (_, lp), = [p for p in gate_programs() if p[0] == "fuzz 13"]
    prog = gates_torch.GateProgram(lp, "cpu")
    B = 4
    inputs = {}
    for k, kind in enumerate(gates_torch.INPUT_KINDS):
        t = tf.from_u64(_words(40 + k, (B, lp.input_slots[kind][1], 2)), "cpu")
        inputs[kind] = GExt(t[..., 0], t[..., 1])
    slots = torch.tensor([0, int(lp.out_slots[3]), 0, int(lp.out_slots[0])], dtype=torch.int32)
    for kwargs in ({}, {"per_prog": True}, {"out_slots": slots}):
        packed = {"packed": prog.pack(slots)} if "out_slots" in kwargs else {}  # as the verifier passes its own
        got = prog._forward_kernel(inputs, (B,), **kwargs, **packed)
        want = prog.forward_plain(inputs, (B,), **kwargs)
        for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]):
            assert torch.equal(g.re, w.re) and torch.equal(g.im, w.im)
    assert not (got.re[:, 0].any() or got.im[:, 2].any())
    ops = gates_torch.compact_ops(lp)
    assert lib.calls[0] == {"strides": [None if not lp.input_slots[k][1] else ((2 * lp.input_slots[k][1], 2),) * 2 for k in gates_torch.INPUT_KINDS],
                            "ops": len(ops["adds"]) + len(ops["muls"]), "out": len(lp.out_slots), "n_slots": prog.pack().n_slots}
    assert [c["out"] for c in lib.calls] == [len(lp.out_slots)] * 2 + [4]
    with pytest.raises(ValueError):
        prog(inputs, (B,), per_prog=True, out_slots=slots)
    with pytest.raises(ValueError, match="packed"):
        prog._forward_kernel(inputs, (B,), out_slots=slots)


BENCH_DATA = os.path.join(os.path.dirname(__file__), "..", "benchmark", "data")


def _chain_before_the_kernel(v, gate_sels, cons, n_gc):
    """The filter as the verifier computed it before the gate filter: every
    gate's selector value from the whole (n_gates, span) factor matrices,
    the live gates gathered by a Python list, their emul by the gate
    outputs and ext_sum_axis over the gates."""
    si = v.tpl.common.selectors_info
    multi = len(si.groups) > 1
    span = max(max(g.end - g.start for g in si.groups) - 1 + (1 if multi else 0), 1)
    tmat = np.zeros((len(si.selector_indices), span), dtype=np.uint64)
    mask = np.zeros(tmat.shape, dtype=bool)
    for g, grp in enumerate(si.selector_indices):
        fs = ([UNUSED_SELECTOR] if multi else []) + [j for j in range(si.groups[grp].start, si.groups[grp].end) if j != g]
        tmat[g, : len(fs)], mask[g, : len(fs)] = fs, True
    x = gate_sels[:, torch.tensor(si.selector_indices)]
    terms = tf.ext_where(torch.from_numpy(mask), tf.ext_from_base(tf.from_u64(tmat, "cpu")).unsqueeze(0) - x.unsqueeze(-1),
                         tf.ext_constant(1, shape=(1, 1, 1), device="cpu"))
    sel_live = vt.tree_prod_last(terms)[:, v._live_gates]
    B, L = cons.shape[0], len(v._live_gates)
    return vt.ext_sum_axis(tf.emul(sel_live.unsqueeze(-1), cons.reshape(B, L, n_gc)), axis=1)


@pytest.mark.parametrize("config", ["fibonacci-std-d12", "gate-zoo-lookup-d12"])
def test_gate_filter_plain_equals_the_chain_it_replaced(config):
    """On the benchmark templates' rows (one selector group; four, with
    UNUSED_SELECTOR), random selector openings and gate outputs (the edge
    band and x + p): gate_filter_plain and the kernel's order give the
    words of the chain the verifier ran before."""
    v = vt.TorchVerifier(CircuitTemplate(load_common(os.path.join(BENCH_DATA, config, "common.json"))), device="cpu")
    n_sel, n_gc, L = v.tpl.n_gate_selectors, v.tpl.common.num_gate_constraints, len(v._live_gates)
    sels, cons = _port(*_ext_np(60, (5, n_sel))), _port(*_ext_np(61, (5, L * n_gc)))
    rows = (v._filter_cols, v._filter_consts, v._filter_mask)
    want = _chain_before_the_kernel(v, sels, cons, n_gc)
    for got in (vt.gate_filter_plain(sels, cons, *rows, n_gc), GExt(*gate_filter_rows_plain((sels.re, sels.im), (cons.re, cons.im), *rows, n_gc))):
        assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert L == v._filter_cols.shape[0] > 1 and (len(v.tpl.common.selectors_info.groups) > 1) == (config == "gate-zoo-lookup-d12")


class _FilterLibrary:
    """The kernel library's gate_filter by the kernel's order in PyTorch,
    recording the tensors it was given."""

    def __init__(self):
        self.calls, self.launches = [], {"gate_filter": 0}

    def gate_filter(self, sels, cons, cols, consts, mask, n_gc):
        self.calls.append((sels, cons, cols, consts, mask, n_gc))
        self.launches["gate_filter"] += 1
        return gate_filter_rows_plain(sels, cons, cols, consts, mask, n_gc)


def test_card_path_gate_filter_views_and_table(monkeypatch):
    """A CPU forward hands gate_filter the selector columns as a view of
    openings1 (its column stride, never copied), the gate program's outputs
    and the template's buffers, and indexes no GExt by a Python list (the
    gather that synchronised with the card); `_gate_filter_kernel` passes
    those tensors to the library as they are and gives the plain words."""
    common, vkey, pwp = get_fixture_proof("fibonacci", num_query_rounds=6)
    tpl = CircuitTemplate(common)
    v = vt.TorchVerifier(tpl, device="cpu")
    a = v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * 2))
    seen, indexes = [], []
    plain_filter, getitem = vt.gate_filter, GExt.__getitem__
    monkeypatch.setattr(vt, "gate_filter", lambda *args: seen.append(args) or plain_filter(*args))
    monkeypatch.setattr(GExt, "__getitem__", lambda self, idx: indexes.append(idx) or getitem(self, idx))
    with torch.no_grad():
        out = v(a)
    assert bool(out["ok"].all())
    (sels, cons, cols, consts, mask, n_gc), = seen
    assert cols is v._filter_cols and consts is v._filter_consts and mask is v._filter_mask and n_gc == common.num_gate_constraints
    o1 = a["openings1"]
    assert sels.re.data_ptr() == o1.data_ptr() and sels.re.stride() == (o1.shape[1] * 2, 2) and sels.shape == (2, tpl.n_gate_selectors)
    assert cons.shape == (2, len(v._live_gates) * n_gc)
    flat = lambda idx: idx if isinstance(idx, tuple) else (idx,)
    assert not any(isinstance(i, list) for idx in indexes for i in flat(idx))

    lib = _FilterLibrary()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    got = vt._gate_filter_kernel(sels, cons, cols, consts, mask, n_gc)
    want = vt.gate_filter_plain(sels, cons, cols, consts, mask, n_gc)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    (l_sels, l_cons, *l_rows, l_n), = lib.calls
    assert l_sels[0] is sels.re and l_sels[1] is sels.im and l_cons[0] is cons.re and l_cons[1] is cons.im
    assert all(x is y for x, y in zip(l_rows, (cols, consts, mask))) and l_n == n_gc
