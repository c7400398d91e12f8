"""Bit-exactness check of the field kernels on the card: the extension
Horner sum, the grouped inversion and the grouped exponentiation (csrc/field.cu),
the levelized gate program (csrc/gates.cu), the FRI coset folds
(csrc/fold.cu), and L0 with the partial products, the lookup argument and
the gate filter (csrc/plonk.cu), against their plain PyTorch versions
(`verifier_torch.horner_ext_plain`, `ops/field.inv_plain`,
`pow_dynamic_plain` / `ext_pow_const_plain`, `GateProgram.forward_plain`,
`verifier_torch.coset_fold_plain`, `partial_products_plain`,
`lookup_checks_plain`, `gate_filter_plain`) and the golden (Python-int) model. `tools/check_hash_kernels.py` runs it
after the Poseidon kernels, for its command line and for tools/probe_kernels.py.

Every input mixes random canonical words with the p-edge band and random
words x + p (x < 2^32 - 1): proof words need not be canonical, and the
kernels must give the plain bits for them too.
- inv_grouped (the batch inversion a forward launches once): `n_random`
  random words, the band and 4,096 words x + p, flat and as (rows, 28),
  then lengths 1-1,001 around the group of kernels.INV_GROUP words, each
  with a zero and a word p (0 mod p) in every position of a group, and all
  zeros; against inv_plain, golden and the kernel's own order in PyTorch
  (inv_grouped_split_plain); zero words give zero; no words launch nothing;
- horner: both template flags (base-field values, base-field point) in all
  four combinations, the interleaved openings' column stride of 2, rows
  repeated through v_rep and p_rep (the wrappers' stride-0 rows), widths
  around a warp's 32 lanes, K = 0 (zeros) and no rows at all (no launch),
  combineInitial's width of 254 on about 2^20 words, and small rows whose
  K makes kernels.horner_segments pick each segment count a row (1 to 32)
  in every flag pair (the check raises if a count was never picked);
- pow_grouped (a forward's powers in one launch): fixed-generator segments
  as the verifier makes them (query points over 15 bits, fold offsets with
  the index shifted and its low bits cleared, a final x of 0 bits, the
  factor 1 and a level shift) on indices with 0 and 2^15 - 1 among them, a
  row-strided index view (a mesh rank's query slice), beside extension
  bases at host exponents 2, 3, 2^12, 2^64 - 1 and random, all in one
  launch and apart; against pow_grouped_plain, golden and the table
  products in PyTorch (pow_grouped_rows_plain); e = 0 and 1 answered by
  ops/field.pow_grouped with no launch, refused by the library;
- gate_program: the fibonacci, poseidon_chain, gate-zoo and fuzz-13 / 23
  programs on random lanes, the inputs at the verifier's strides (column
  stride 2), in both forms (the tape in shared memory, in device scratch)
  and the one the library picks, at batches whose lanes a block do and do
  not divide them and that give fibonacci's program every lanes a block
  from 1 to 32 on the H100, B = 0 (no launch), for the program's own outputs and
  for a gather like the verifier's (zeros, a slot twice, an input, a
  literal), against GateProgram.forward_plain and, on a few lanes, a
  Python-int interpreter of the compact op lists (golden_gate_program);
  the plain stand-in runs the packed program in Python ints
  (golden_packed_program);
- coset_fold: steps of arity 2 to 64 in one launch over (B, Q) lanes (up
  to 32 staged in shared memory, 64 in scratch), the offsets' inverses 0, 1
  and random, on every Q and on a strided query
  slice (a mesh rank's), B = 0 (no launch); against coset_fold_plain, the
  kernel's order in PyTorch (coset_fold_rows_plain) and golden/fri.py
  fold_coset on a few lanes;
- partial_products: r of 1 to 3, maxdeg 2 to 8 and n_chunks 1 to 10, the
  openings as the verifier's interleaved views (column stride 2), B = 0;
  against partial_products_plain, partial_products_rows_plain and the
  golden formula (golden_partial_products) on a few lanes;
- lookup_checks: routed wires, SLDC chunks (1 to 6, the last one short),
  table counts and lengths (shorter than a row, whole rows, and more), so
  that kernels.lookup_split gives 1 to 16 lanes a chunk, 1 to 8 for the
  RE transition and 1 to 32 a table (its longest table's: 312 rows past
  32 lanes of 8, tables of other lengths beside it), B = 0, subtrahends y + p at every
  chunk's sldc - prev (probe_sldc_subtrahends); against lookup_checks_plain, lookup_checks_rows_plain and
  golden/plonk.py eval_lookup_equations on a few lanes;
- gate_filter: the live gates' rows of the fibonacci, gate-zoo and lookup
  templates (several selector groups: UNUSED_SELECTOR among the factors),
  of a shape-grid point and a fuzz seed (one group and several) and of rows
  made here (one gate of one live slot, the raw subtraction's word; a row
  of no live slot; slots with gaps; no live gate), at batches 1, 1,023 and
  16,384 (a block's 16 lanes do not divide the first two) and B = 0 (no
  launch), the selector columns a view of an openings-like tensor (column
  stride 2); against gate_filter_plain, gate_filter_rows_plain and the
  filter in Python ints on the first lanes' words reduced.
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..compiler.gates_torch import INPUT_KINDS, NO_SLOT, OP_MUL, OP_SUB, GateProgram, compact_ops, decode_ops
from ..compiler.levelize import levelize_gates
from ..golden import field as gf
from ..golden.fri import fold_coset
from ..golden.plonk import eval_lookup_equations
from ..kernels import INV_GROUP, KernelLibrary, horner_segments, lookup_split, partial_products_lanes
from ..ops import field as tf
from ..ops.field import GExt
from ..verifier_torch import (coset_fold_plain, gate_filter_plain, horner_ext_plain, lookup_checks_plain, lookup_tables,
                              partial_products_plain)

P = tf.P
EDGE = [0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P, 2**64 - 1]  # the last two are not canonical
N_RANDOM = (1 << 20) + 37
GOLDEN_ROWS = 3
# (rows of values, K, base-field values, base-field point, v_rep, p_rep, interleaved)
HORNER_CASES = [
    (147, 254, True, False, 28, 1, False),  # combineInitial: (B, Q, 254) leaf words, the point a proof's (B,) alpha
    (4116, 254, True, False, 1, 28, False),
    (2053, 254, False, False, 1, 1, True),  # the reduced openings: interleaved (re, im)
    (97, 77, False, True, 5, 1, False),  # horner_scaled: values (B, K) broadcast over r scales
    (511, 16, False, False, 1, 7, False),  # a coset fold
    (140, 8, False, True, 1, 28, True),  # the final polynomial at a base-field x, one polynomial a proof
    (300, 33, True, True, 1, 1, False),
    (65, 1, False, False, 1, 1, False),
    (33, 31, False, False, 3, 1, False),
    (31, 32, True, False, 1, 1, False),
    (37, 0, False, False, 1, 1, False),  # K = 0: zeros
    (0, 5, False, False, 1, 1, False),  # no rows: no launch
]
HORNER_SEGMENTS = (1, 2, 4, 8, 16, 32)  # every segment count a row the Horner kernel takes
# small rows (their threads far under the card's), K = 4 S + 3 (5 for S = 1):
# horner_segments picks S, the last segment short, in every flag pair
HORNER_CASES += [(24 + s, 4 * s + 3 if s > 1 else 5, base_v, base_p, 1, 1, False)
                 for s in HORNER_SEGMENTS for base_v in (False, True) for base_p in (False, True)]


def words(rng, shape) -> np.ndarray:
    """Random canonical words with the edge band and words x + p among them."""
    out = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = out.reshape(-1)
    k = flat.size // 4
    flat[:k] = np.array(EDGE, dtype=np.uint64)[rng.integers(0, len(EDGE), size=k)]
    flat[k : 2 * k] = rng.integers(0, 2**32 - 1, size=k, dtype=np.uint64) + np.uint64(P)
    rng.shuffle(flat)
    return out


def horner_rows_plain(v_re, v_im, p_re, p_im, v_rep: int = 1, p_rep: int = 1):
    """What `KernelLibrary.horner` computes, by the plain version."""
    g = lambda t, rep: None if t is None else t.repeat_interleave(rep, 0)
    v_re, v_im, p_re, p_im = g(v_re, v_rep), g(v_im, v_rep), g(p_re, p_rep), g(p_im, p_rep)
    out = horner_ext_plain(
        GExt(v_re, torch.zeros_like(v_re) if v_im is None else v_im),
        GExt(p_re, torch.zeros_like(p_re) if p_im is None else p_im),
    )
    return out.re, out.im


def horner_split_plain(v_re, v_im, p_re, p_im, v_rep: int = 1, p_rep: int = 1, segments: int = 1):
    """What `KernelLibrary.horner` computes, in the kernel's own order
    (csrc/field.cu) with `segments` (S) a row: segment s runs the Horner sum
    of the columns s, s + S, ... in q = point^S from zero (a first step past
    K adds 0 to 0), then the tree adds, level j, point^(2^j) times the
    right neighbour's sum. Its words equal horner_rows_plain's for every S."""
    g = lambda t, rep: None if t is None else t.repeat_interleave(rep, 0)
    v_re, v_im, p_re, p_im = g(v_re, v_rep), g(v_im, v_rep), g(p_re, p_rep), g(p_im, p_rep)
    n, k = v_re.shape
    steps = -(-k // segments)
    pad = lambda t: torch.cat([t, torch.zeros((n, steps * segments - k), dtype=t.dtype, device=t.device)], 1)
    values = GExt(pad(v_re), pad(torch.zeros_like(v_re) if v_im is None else v_im)).reshape(n, steps, segments)
    q = GExt(p_re, torch.zeros_like(p_re) if p_im is None else p_im)
    powers = []
    while len(powers) < segments.bit_length() - 1:
        powers.append(q)
        q = tf.emul(q, q)
    acc = tf.ext_zeros((n, segments), v_re.device)
    for m in range(steps - 1, -1, -1):
        acc = values[:, m] + tf.emul(q.unsqueeze(1).expand(n, segments), acc)
    for pw in powers:
        right = acc[:, 1::2]
        acc = acc[:, 0::2] + tf.emul(pw.unsqueeze(1).expand(*right.shape), right)
    return acc.re[:, 0], acc.im[:, 0]


def _golden_horner(v_re, v_im, p_re, p_im):
    """One row's sum in Python ints: values (K,), the point a word each."""
    pt = (int(p_re) % P, 0 if p_im is None else int(p_im) % P)
    acc = (0, 0)
    for k in range(len(v_re) - 1, -1, -1):
        acc = gf.eadd((int(v_re[k]) % P, 0 if v_im is None else int(v_im[k]) % P), gf.emul(pt, acc))
    return acc


POW_BITS = 15  # lde_bits of the verifier's query points
POW_CONST = [2, 3, 4096, 2**64 - 1]  # host exponents, beside random ones (0 and 1 never reach the library)
# on the H100 (132 SMs) fibonacci's program runs 1, 2, 4, 8, 16 and 32 lanes a
# block at these (the last block of 1030 holds 6)
GATE_BATCHES = [37, 300, 400, 1030, 2112, 4225, 1, 0]
GOLDEN_LANES = 2
PLAIN_GATE_LANES = 8  # the plain stand-in runs the packed program in Python ints: a few lanes
ZOO_COMMON = os.path.join(os.path.dirname(__file__), "..", "..", "fixtures", "gate_zoo_3abb3dc54fe7_common.json")


def inv_grouped_split_plain(a):
    """What `KernelLibrary.inv_grouped` computes, in the kernel's own order
    (csrc/field.cu): word i in group i mod T, T = ceil(n / INV_GROUP), a
    group's prefix products, one inversion of their product, the sweep back;
    a word 0 or p enters as 1 and leaves as 0, the padding enters as 1. Its
    words equal inv_plain's."""
    flat = a.reshape(-1)
    n = flat.numel()
    if n == 0:
        return torch.empty_like(a)
    groups = -(-n // INV_GROUP)
    x = torch.cat([flat, torch.ones(groups * INV_GROUP - n, dtype=flat.dtype, device=flat.device)]).reshape(INV_GROUP, groups)
    zero = (x == 0) | (x == tf.P_I64)
    x = torch.where(zero, torch.ones_like(x), x)
    prefix = [x[0]]
    for j in range(1, INV_GROUP):
        prefix.append(tf.mul(prefix[-1], x[j]))
    u = tf.inv_plain(prefix[-1])
    out = [None] * INV_GROUP
    for j in range(INV_GROUP - 1, 0, -1):
        out[j] = tf.mul(u, prefix[j - 1])
        u = tf.mul(u, x[j])
    out[0] = u
    out = torch.where(zero, torch.zeros_like(x), torch.stack(out))
    return out.reshape(-1)[:n].reshape(a.shape)


def pow_grouped_rows_plain(idx, gens, exts):
    """What `KernelLibrary.pow_grouped` computes from its own arguments, in
    the kernel's way: a fixed-generator element is its factor times the
    table's g^(2^k) at the set bits of its exponent, derived from the index
    as the kernel derives it; an extension row is ext_pow_const_plain's."""
    gen_out = []
    for table, shift, clear, factor in gens:
        e = tf.bit_reverse((idx >> (shift + clear)) << clear, table.shape[0])  # (rows, q), as the library returns
        acc = tf.constant(factor, e.shape, table.device)
        for k in range(table.shape[0]):
            acc = torch.where(((e >> k) & 1) == 1, tf.mul(acc, table[k].expand(e.shape)), acc)
        gen_out.append(acc)
    ext_out = []
    for re, im, e in exts:
        if not 2 <= e < 2**64:
            raise ValueError(f"exponent {e}: a host exponent is a u64 of at least 2")
        out = tf.ext_pow_const_plain(GExt(re, im), e)
        ext_out.append((out.re, out.im))
    return gen_out, ext_out


def golden_gate_program(inputs, lits, add_off, adds, mul_off, muls, out_slots, n_tape: int = 0):
    """What the gate program computes, lane by lane in Python ints
    (golden/field.py) on the compact op lists (compact_ops), level by
    level: the inputs and literals enter the tape as given, every op
    reduces its operands mod p, slot 0 reads zero. Returns (out_re,
    out_im), each (B, n_out), on the literals' device."""
    batch = next(re.shape[0] for _, re, _ in inputs if re is not None)
    add_off, mul_off, adds, muls = add_off.tolist(), mul_off.tolist(), adds.tolist(), muls.tolist()
    lit_words = [(int(v), 0) for v in tf.to_u64(lits)]
    given = [(offset, tf.to_u64(re), tf.to_u64(im)) for offset, re, im in inputs if re is not None]
    canon = lambda v: (v[0] % gf.P, v[1] % gf.P)
    out = np.zeros((batch, out_slots.shape[0], 2), dtype=np.uint64)
    for lane in range(batch):
        tape = dict(enumerate(lit_words, 1))
        for offset, re, im in given:
            tape.update((offset + j, (int(x), int(y))) for j, (x, y) in enumerate(zip(re[lane], im[lane])))
        tape[0] = (0, 0)
        for level in range(len(add_off) - 1):
            for s1, s2, neg, dst in adds[add_off[level] : add_off[level + 1]]:
                b = canon(tape[s2])
                tape[dst] = gf.eadd(canon(tape[s1]), gf.eneg(b) if neg else b)
            for s1, s2, dst, _ in muls[mul_off[level] : mul_off[level + 1]]:
                tape[dst] = gf.emul(canon(tape[s1]), canon(tape[s2]))
        out[lane] = [tape[s] for s in out_slots.tolist()]
    return tf.from_u64(out[..., 0], lits.device), tf.from_u64(out[..., 1], lits.device)


def golden_packed_program(inputs, packed):
    """What `KernelLibrary.gate_program` computes on a packed program
    (compiler/gates_torch.PackedProgram), lane by lane in Python ints:
    the initial tape, the steps (every op of a step reads the tape as the
    step found it), the output columns stored by ops and by the tail.
    Raises where the packing breaks what the kernel assumes: a slot read
    before it is written, a step that writes a slot it reads or one slot
    twice, a column stored twice or never. Returns (out_re, out_im), each
    (B, n_out), on the literals' device."""
    batch = next(re.shape[0] for _, re, _ in inputs if re is not None)
    lits = [int(v) for v in tf.to_u64(packed.lits)]
    given = [(offset, tf.to_u64(re), tf.to_u64(im)) for offset, re, im in inputs if re is not None]
    loads, tail, step_off = (x.tolist() for x in (packed.loads, packed.tail, packed.step_off))
    ops = decode_ops(packed.ops.cpu().numpy()).tolist()
    canon = lambda v: (v[0] % gf.P, v[1] % gf.P)

    def source(slot, lane):
        if 1 <= slot <= len(lits):
            return lits[slot - 1], 0
        for offset, re, im in given:
            if 0 <= slot - offset < re.shape[1]:
                return int(re[lane, slot - offset]), int(im[lane, slot - offset])
        return 0, 0

    out = np.zeros((batch, packed.n_out, 2), dtype=np.uint64)
    for lane in range(batch):
        tape, cols = [None] * packed.n_slots, [None] * packed.n_out
        for slot, src in loads:
            tape[slot] = source(src, lane)
        for t in range(len(step_off) - 1):
            step = ops[step_off[t] : step_off[t + 1]]
            reads, writes = {x for o in step for x in o[:2]}, [o[2] for o in step if o[2] != NO_SLOT]
            if reads & set(writes) or len(set(writes)) != len(writes):
                raise AssertionError(f"step {t} writes a slot it reads, or one slot twice")
            results = []
            for x, y, dst, kind, col in step:
                if tape[x] is None or tape[y] is None:
                    raise AssertionError(f"step {t} reads slot {x if tape[x] is None else y} before it is written")
                a, b = canon(tape[x]), canon(tape[y])
                v = gf.emul(a, b) if kind == OP_MUL else gf.eadd(a, gf.eneg(b) if kind == OP_SUB else b)
                results.append((dst, col, v))
            for dst, col, v in results:
                if dst != NO_SLOT:
                    tape[dst] = v
                if col >= 0:
                    if cols[col] is not None:
                        raise AssertionError(f"column {col} stored twice")
                    cols[col] = v
        for col, src in tail:
            if cols[col] is not None or (src < 0 and cols[-src - 1] is None):
                raise AssertionError(f"tail column {col}: stored twice, or a copy of a column not yet stored")
            cols[col] = source(src, lane) if src >= 0 else cols[-src - 1]
        if any(v is None for v in cols):
            raise AssertionError("a column stored by no op and no tail entry")
        out[lane] = cols
    return tf.from_u64(out[..., 0], packed.lits.device), tf.from_u64(out[..., 1], packed.lits.device)


def verifier_like_gather(lp) -> np.ndarray:
    """Program slots gathered as the verifier's padded layout gathers them
    and more: zeros, the outputs in another order, one output twice, an
    input and a literal (where the program has them)."""
    outs = [int(s) for s in lp.out_slots]
    extra = [lp.input_slots[k][0] for k in INPUT_KINDS if lp.input_slots[k][1]][:1] + ([1] if len(lp.lit_values) else [])
    return np.array([0] + outs[::-1] + [0, outs[0]] + extra, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def gate_programs():
    """(name, LevelizedProgram) of the circuits whose programs the check
    runs: fibonacci, poseidon_chain, the gate zoo (its common data as cached
    by the 2-query fixture, or built from the model without proving: the
    gates are the same) and fuzz seeds 13 and 23."""
    from ..compiler import CircuitTemplate
    from ..models.fibonacci import fibonacci_fixture
    from ..models.gate_zoo import gate_zoo_fixture
    from ..models.poseidon_chain import poseidon_chain_fixture
    from ..types import load_common
    from . import shape_circuits as sc

    zoo = load_common(ZOO_COMMON) if os.path.exists(ZOO_COMMON) else gate_zoo_fixture(num_query_rounds=2, proof_of_work_bits=2).common
    commons = [
        ("fibonacci", fibonacci_fixture(num_query_rounds=2).common),
        ("poseidon_chain", poseidon_chain_fixture(n_chain=2, num_query_rounds=2).common),
        ("gate zoo", zoo),
    ] + [(f"fuzz {seed}", sc.fuzz_fixture(seed).common) for seed in sc.FUZZ_SEEDS]
    out = []
    for name, common in commons:
        tpl = CircuitTemplate(common)
        out.append((name, levelize_gates(tuple(common.gates), tpl.n_gate_selectors, tpl.n_lookup_selectors,
                                         tpl.n_gate_constants, tpl.num_wires)))
    return tuple(out)


def gate_inputs(rng, lp, batch: int, dev):
    """Random inputs of each kind (the edge band and x + p among them), as
    GExt views at the verifier's strides: every kind's (re, im) interleaved
    in one (batch, count, 2) tensor, so column stride 2. Returns (inputs,
    the same as KernelLibrary.gate_program takes them: (offset, re, im) a
    kind, re and im None where it has no words)."""
    inputs, views = {}, []
    for kind in INPUT_KINDS:
        offset, w = lp.input_slots[kind]
        t = tf.from_u64(words(rng, (batch, w, 2)), dev)
        inputs[kind] = GExt(t[..., 0], t[..., 1])
        views.append((offset, inputs[kind].re, inputs[kind].im) if w else (offset, None, None))
    return inputs, views


INV_GROUPED_LENGTHS = [1, 2, 7, 8, 9, 15, 16, 17, 63, 64, 65, 1000, 1001]


def check_inv_grouped(lib, c, rng, dev, words_np):
    """checks["inv"], the grouped entry point: `words_np` (random, the band,
    words x + p) flat and as (rows, 28), then every length of
    INV_GROUPED_LENGTHS with a zero and a p in every position of a group
    (the first group's and the last's), and all zeros; against inv_plain and
    the kernel's order (inv_grouped_split_plain), the head against golden;
    no words, no launch."""
    a = tf.from_u64(words_np, dev)
    got = lib.inv_grouped(a)
    c.compare(got, tf.inv_plain(a), f"grouped: {words_np.size} words")
    c.compare(got, inv_grouped_split_plain(a), f"grouped: {words_np.size} words, the kernel's order")
    head = words_np[: len(EDGE) + 4096 + 64]
    c.compare(got[: head.size], np.array([pow(int(x) % P, P - 2, P) for x in head], dtype=np.uint64), "grouped: vs golden")
    grid = a[: min(a.numel() // 28, 1024) * 28].reshape(-1, 28)
    c.compare(lib.inv_grouped(grid), tf.inv_plain(grid), f"grouped: {tuple(grid.shape)}")
    for n in INV_GROUPED_LENGTHS:
        groups = -(-n // INV_GROUP)
        x = words(rng, (n,))
        for j in range(INV_GROUP):  # a zero in position j of the first group, a p in position j of the last
            if j * groups < n:
                x[j * groups] = 0
            if groups - 1 + j * groups < n and groups > 1:
                x[groups - 1 + j * groups] = P
        for what, v in [("zero and p in every position", x), ("all zero", np.zeros(n, np.uint64))]:
            t = tf.from_u64(v, dev)
            got = lib.inv_grouped(t)
            c.compare(got, tf.inv_plain(t), f"grouped: {n} words, {what}")
            c.compare(got, inv_grouped_split_plain(t), f"grouped: {n} words, {what}, the kernel's order")
            c.compare(got, np.array([pow(int(w) % P, P - 2, P) for w in v], dtype=np.uint64), f"grouped: {n} words, {what} vs golden")
    before = lib.launches.get("inv_grouped", 0)
    if lib.inv_grouped(a[:0]).numel() or lib.launches.get("inv_grouped", 0) != before:
        raise AssertionError("inv_grouped of no words launched or returned words")
    parts = [a[:5], grid, a[:0], a[7:40].reshape(3, 11)]  # ops/field.inv_grouped: several tensors, one launch on the card
    before = lib.launches.get("inv_grouped", 0)
    got = tf.inv_grouped(parts)  # on the card through kernels.load(), which is `lib` there
    if torch.device(dev).type != "cpu" and lib.launches.get("inv_grouped", 0) != before + 1:
        raise AssertionError(f"ops/field.inv_grouped of {len(parts)} tensors made {lib.launches.get('inv_grouped', 0) - before} launches")
    for g, w in zip(got, tf.inv_grouped_plain(parts)):
        c.compare(g, w, f"ops/field.inv_grouped part {tuple(w.shape)}")


def pow_grouped_cases(dev):
    """Fixed-generator segments as the verifier makes them (kernels'
    argument form and ops/field.GeneratorPower form): the query points over
    15 bits, two fold steps (the index shifted, its low bits cleared), a final
    x of 0 bits, and the factor 1 beside a level shift."""
    g15, g11, g7 = (gf.subgroup_generator(b) for b in (15, 11, 7))
    specs = [(gf.subgroup_generator(POW_BITS), POW_BITS, gf.MULT_GEN, 0, 0), (g15, 15, gf.fpow(gf.MULT_GEN, 16), 0, 4),
             (g11, 11, gf.fpow(gf.MULT_GEN, 256), 4, 4), (g7, 7, gf.fpow(gf.MULT_GEN, 4096), 8, 0), (1, 0, 7, 15, 0),
             (g15, 15, 1, 0, 0), (g11, 11, 1, 3, 2)]
    return [tf.GeneratorPower(g, bits, factor, shift, clear, tf.from_u64(tf.power_table(g, bits), dev))
            for g, bits, factor, shift, clear in specs]


def check_pow_grouped(lib, c, rng, dev, n_random: int):
    """checks["pow"], the grouped entry point: pow_grouped_cases' segments
    on query indices (rows, 28) (0 and 2^15 - 1 among them, and a
    row-strided view of 14 of 28 columns) with extension segments at host
    exponents beside them, in one launch and each apart; against
    pow_grouped_plain, the table products (pow_grouped_rows_plain) and golden
    on a few elements; ops/field.pow_grouped answers e = 0 and 1 on the host."""
    rows = max(n_random // 28, 2)
    idx_np = rng.integers(0, 2**POW_BITS, size=(rows, 28), dtype=np.int64)
    idx_np[0, :4] = [0, 2**POW_BITS - 1, 1, 2 ** (POW_BITS - 1)]
    idx_full = torch.from_numpy(idx_np).to(dev)
    gens = pow_grouped_cases(dev)
    b_np = words(rng, (rows, 2))
    b = tf.from_u64(b_np, dev)
    base = GExt(b[:, 0], b[:, 1])  # stride 2, as the transcript's states are read
    host_e = POW_CONST + [int(x) for x in rng.integers(2, 2**63, size=2)]
    for what_idx, idx in [("(rows, 28)", idx_full), ("a strided (rows, 14) view", idx_full[:, 7:21])]:
        gen_args = [(g.table, g.shift, g.clear, g.factor) for g in gens]
        ext_args = [(base.re, base.im, e) for e in host_e]
        before = lib.launches.get("pow_grouped", 0)
        got_g, got_e = lib.pow_grouped(idx, gen_args, ext_args)
        if lib.launches.get("pow_grouped", 0) != before + 1:
            raise AssertionError(f"pow_grouped of {len(gens) + len(host_e)} segments made {lib.launches.get('pow_grouped', 0) - before} launches")
        want_g, want_e = tf.pow_grouped_plain(idx, gens, [(base, e) for e in host_e])
        split_g, split_e = pow_grouped_rows_plain(idx, gen_args, ext_args)
        at = [0, 1, 2, 3, idx.numel() // 2, idx.numel() - 1]
        flat_idx = idx.reshape(-1).cpu().numpy()
        for g, x, w, s in zip(gens, got_g, want_g, split_g):
            what = f"grouped {what_idx}: generator of {g.bits} bits, shift {g.shift}, clear {g.clear}, factor {g.factor}"
            c.compare(x, w, what)
            c.compare(x, s, f"{what}, the table products")
            gold = [gf.fmul(g.factor, gf.fpow(g.generator, gf.reverse_bits(g.bits, ((int(flat_idx[i]) >> (g.shift + g.clear)) << g.clear) % (1 << g.bits)) if g.bits else 0))
                    for i in at]
            c.compare(x.reshape(-1)[at], np.array(gold, np.uint64), f"{what} vs golden")
        for e, (re, im), w, s in zip(host_e, got_e, want_e, split_e):
            c.compare(torch.stack([re, im]), torch.stack([w.re, w.im]), f"grouped {what_idx}: extension base, e = {e}")
            c.compare(torch.stack([re, im]), torch.stack(s), f"grouped {what_idx}: extension base, e = {e}, apart")
            gold = [gf.epow((int(b_np[i, 0]) % P, int(b_np[i, 1]) % P), e) for i in (0, rows - 1)]
            c.compare(torch.stack([re[[0, rows - 1]], im[[0, rows - 1]]], 1), np.array(gold, np.uint64), f"grouped: e = {e} vs golden")
        for k, g in enumerate(gens):  # each segment in a launch of its own gives the same words
            alone, _ = lib.pow_grouped(idx, gen_args[k : k + 1], [])
            c.compare(alone[0], got_g[k], f"grouped {what_idx}: generator {k} alone")
    for e in (0, 1):  # ops/field.pow_grouped answers both on the host; the library refuses them
        got = tf.pow_grouped_plain(idx_full, [], [(base, e)])[1][0]
        want = tf.ext_pow_const_plain(base, e)
        c.compare(torch.stack([got.re, got.im]), torch.stack([want.re, want.im]), f"grouped: ext_pow_const e = {e}")
        try:
            lib.pow_grouped(None, [], [(base.re, base.im, e)])
        except ValueError:
            continue
        raise AssertionError(f"pow_grouped took a host exponent {e}, which ops/field.pow_grouped answers itself")
    before = lib.launches.get("pow_grouped", 0)
    if lib.pow_grouped(idx_full[:0], [(gens[0].table, 0, 0, 1)], [])[0][0].numel() or lib.launches.get("pow_grouped", 0) != before:
        raise AssertionError("pow_grouped launched for no elements")


def check_gate_program(lib, c, rng, dev, max_lanes: int, kernel: bool):
    """checks["gate_program"]: every program of gate_programs() at every
    batch of GATE_BATCHES, cut to max_lanes, in both forms and the one the
    library picks (`kernel`; the plain stand-in has no forms), for its own
    outputs and a verifier-like gather. Lanes are independent, so one plain
    run a program and gather, on the most lanes, holds every batch."""
    batches = sorted({min(b, max_lanes) for b in GATE_BATCHES})
    for name, lp in gate_programs():
        gp = GateProgram(lp, dev)
        compact = compact_ops(lp)
        inputs, views = gate_inputs(rng, lp, batches[-1], dev)
        per_prog = gp(inputs, (batches[-1],), per_prog=True) if dev == "cpu" else gp.forward_plain(inputs, (batches[-1],), per_prog=True)
        if [x.shape[-1] for x in per_prog] != [len(s) for s in lp.out_slots_per_prog]:
            raise AssertionError(f"gate_program {name}: per_prog split {[x.shape for x in per_prog]}")
        gathers = [("its outputs", None, tf.ext_concat(per_prog, dim=-1))]
        slots = verifier_like_gather(lp)
        gathers.append(("a verifier-like gather", slots, gp.forward_plain(inputs, (batches[-1],), out_slots=slots)))
        for what_gather, slots, want in gathers:
            packed = gp.pack(slots)
            for batch in batches:
                cut = [(o, None if re is None else re[:batch], None if im is None else im[:batch]) for o, re, im in views]
                for form in ("shared", "global", "auto") if kernel else ("auto",):
                    what = (f"{name} ({lp.n_levels} levels, {lp.n_tape} slots; packed: {packed.n_steps} steps, {packed.n_slots} slots), "
                            f"{what_gather}, {batch} lanes, form {form}")
                    before = lib.launches.get("gate_program", 0)
                    got = lib.gate_program(cut, packed, form=form)
                    if lib.launches.get("gate_program", 0) != before + (1 if batch else 0):
                        raise AssertionError(f"gate_program {what}: {lib.launches.get('gate_program', 0) - before} launches")
                    c.compare(torch.stack(got), torch.stack([want.re[:batch], want.im[:batch]]), what)
                if batch:
                    gold = golden_gate_program([(o, None if re is None else re[:GOLDEN_LANES], None if im is None else im[:GOLDEN_LANES])
                                                for o, re, im in cut], gp.lit_values, compact["add_off"], compact["adds"], compact["mul_off"],
                                               compact["muls"], lp.out_slots if slots is None else slots, lp.n_tape)
                    c.compare(torch.stack([got[0][:GOLDEN_LANES], got[1][:GOLDEN_LANES]]), torch.stack(gold), f"{what}, {GOLDEN_LANES} lanes vs golden")


def coset_fold_rows_plain(steps):
    """What `KernelLibrary.coset_fold` computes, in the kernel's own order
    (csrc/fold.cu): the opened values made canonical, the inverse DFT as a
    radix-2 decimation-in-time butterfly network on them in bit-reversed
    order (twiddle omega^(-j A / 2h) of butterfly j at span 2h from the
    weights' row 1, no product where j = 0), then with c = beta off_inv the
    Horner chain in c from k = A - 1 down, then 1/A. Returns (steps, 2, B,
    Q); its words equal coset_fold_plain's."""
    outs = []
    for evals, off_inv, beta_re, beta_im, idft in steps:
        B, Q, arity = evals.shape[:3]
        bits = arity.bit_length() - 1
        canon = torch.where(tf.uge(evals, tf.P_I64), evals - tf.P_I64, evals)
        v = [GExt(canon[..., j, 0], canon[..., j, 1]) for j in range(arity)]  # bit-reversed order
        for s in range(bits):
            h = 1 << s
            for m in range(arity // 2):
                j, lo = m & (h - 1), ((m >> s) << (s + 1)) | (m & (h - 1))
                u, w = v[lo], v[lo + h]
                if j:
                    w = tf.escale(idft[1, j << (bits - 1 - s)].expand(B, Q), w)
                v[lo], v[lo + h] = u + w, u - w
        c = tf.escale(off_inv, GExt(beta_re.unsqueeze(1).expand(B, Q), beta_im.unsqueeze(1).expand(B, Q)))
        acc = tf.ext_zeros((B, Q), evals.device)
        for k in range(arity - 1, -1, -1):
            acc = v[k] + tf.emul(c, acc)
        out = tf.escale(tf.constant(gf.finv(arity % P), (B, Q), evals.device), acc)
        outs.append(torch.stack([out.re, out.im]))
    return torch.stack(outs)


def partial_products_rows_plain(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg: int,
                                lanes=None):
    """What `KernelLibrary.partial_products` computes from its arguments
    ((re, im) pairs), in the kernel's own order (csrc/plonk.cu) with its
    lanes a chunk (`lanes`, or kernels.partial_products_lanes'): lane l's
    numerator and denominator terms (k_i times beta zeta, formed once a
    round) of the chunk's wires l, l + L, ... multiplied in that order (a
    lane past maxdeg holds 1), the lanes' (numerator, denominator) pairs
    joined by the group's shuffle tree (`_tree`: the kernel keeps a pair's
    two sides on lanes s and s + 1 from level 0 on, the same products),
    then lane 0's current[c] num - current[c + 1] den, and L0(zeta)(z - 1).
    Returns (re, im), each (B, r + r n_chunks); its words equal
    partial_products_plain's."""
    e = lambda pair: GExt(*pair)
    zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, zeta = map(e, (zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, zeta))
    B, r = zs.shape
    n_chunks = sigmas.shape[1] // maxdeg
    L = partial_products_lanes(maxdeg) if lanes is None else lanes
    one = tf.ext_constant(1, shape=(B,), device=zs.re.device)
    lag0 = tf.emul(zeta_n - one, l0_den_inv)
    cols = [tf.emul(lag0, zs[:, i] - one) for i in range(r)]
    npp = n_chunks - 1
    for rnd in range(r):
        beta, gamma = betas[:, rnd], gammas[:, rnd]
        bz = tf.escale(beta, zeta)

        def terms(i):  # w + k_i (beta zeta) + gamma, w + beta sigma + gamma
            w, kz, bs = wires[:, i], tf.escale(k_is[i].expand(B), bz), tf.escale(beta, sigmas[:, i])
            return (GExt(tf.add(tf.add(w.re, kz.re), gamma), tf.add(w.im, kz.im)),
                    GExt(tf.add(tf.add(w.re, bs.re), gamma), tf.add(w.im, bs.im)))

        current = [zs[:, rnd]] + [pps[:, rnd * npp + k] for k in range(npp)] + [zs_next[:, rnd]]
        for c in range(n_chunks):
            pairs = []
            for lane in range(L):
                wires_of_lane = range(c * maxdeg + lane, (c + 1) * maxdeg, L)
                pair = (one, one)
                for k, i in enumerate(wires_of_lane):
                    num, den = terms(i)
                    pair = (num, den) if k == 0 else (tf.emul(pair[0], num), tf.emul(pair[1], den))
                pairs.append(pair)
            num, den = _tree(pairs, lambda a, o, j: (tf.emul(a[0], o[0]), tf.emul(a[1], o[1])))
            cols.append(tf.emul(current[c], num) - tf.emul(current[c + 1], den))
    out = tf.ext_stack(cols, dim=1) if cols else tf.ext_zeros((B, 0), zs.re.device)
    return out.re, out.im


def _tree(values, join):
    """A warp's shuffle tree over a group's lanes, as csrc/plonk.cu runs it:
    at level j lane s (a multiple of 2^(j + 1)) joins lane s + 2^j's value
    into its own (join(value, other, j)); lane 0's value at the end."""
    values, j = list(values), 0
    while (1 << j) < len(values):
        for s in range(0, len(values), 2 << j):
            values[s] = join(values[s], values[s + (1 << j)], j)
        j += 1
    return values[0]


def _segmented_horner(n: int, lanes: int, value, point, scale, add, zero):
    """sum_k point^k value(k) over k < n, as csrc/plonk.cu's segments take it:
    segment s the values s, s + S, ... in point^S from `zero` (a step past n
    adds 0), then the tree joins segment s + 2^j by point^(2^j). Values and
    sums are extension pairs or base-field words, scaled by `scale(word,
    x)` and added by `add`."""
    q = point
    for _ in range(lanes.bit_length() - 1):
        q = tf.mul(q, q)
    segments = []
    for s in range(lanes):
        acc = zero
        for m in range(-(-n // lanes) - 1, -1, -1):
            k = s + m * lanes
            acc = add(value(k) if k < n else zero, scale(q, acc))
        segments.append(acc)
    powers = [point]
    for _ in range(lanes.bit_length() - 1):
        powers.append(tf.mul(powers[-1], powers[-1]))
    return _tree(segments, lambda a, o, j: add(a, scale(powers[j], o)))


def lookup_checks_rows_plain(sels, wires, zs, zs_next, deltas, coeffs, table_off, num_routed_wires: int, maxdeg: int, lanes=None):
    """What `KernelLibrary.lookup_checks` computes from its arguments, in
    the kernel's own order (csrc/plonk.cu) with its lanes
    (`lanes`, or kernels.lookup_split's): a chunk's slots split over its lanes, each lane
    a running pair P' = P t, S' = S t + m P from (1, 0) over its slots, the
    lanes' pairs met by the tree ((P1, S1) o (P2, S2) = (P1 P2, S1 P2 + P1
    S2)); the RE transition and each table's final as segmented Horner sums
    in delta joined by the tree. Returns (re, im), each (B, r (4 + luts + 2
    n_sldc)); its words equal lookup_checks_plain's."""
    sels, wires, zs, zs_next = (GExt(*x) for x in (sels, wires, zs, zs_next))
    B, r = deltas.shape[:2]
    dev = deltas.device
    n_polys = zs.shape[1] // r
    n_sldc, num_lu, num_lut = n_polys - 1, num_routed_wires // 2, num_routed_wires // 3
    lu_deg, lut_deg = maxdeg - 1, -(-num_lut // n_sldc)
    bounds = table_off.tolist()
    chunk_lanes, re_lanes, table_lanes = lookup_split(num_routed_wires, n_sldc, maxdeg, bounds) if lanes is None else lanes
    one, zero = tf.ext_constant(1, shape=(B,), device=dev), tf.ext_zeros((B,), dev)
    combo = lambda i, c: wires[:, i] + tf.escale(c, wires[:, i + 1])
    term = lambda i, c, alpha: GExt(tf.sub(alpha, combo(i, c).re), tf.sub(torch.zeros_like(alpha), combo(i, c).im))

    def meet(a, o, _):
        (p, s), (op, os) = a, o
        return tf.emul(p, op), tf.emul(s, op) + tf.emul(p, os)

    rounds = []
    for rnd in range(r):
        ca, cb, alpha, delta = (deltas[:, rnd, k] for k in range(4))
        z0 = rnd * n_polys
        re = zs[:, z0]
        cols = {0: tf.emul(sels[:, 3], zs[:, z0 + n_sldc]), 1: tf.emul(sels[:, 2], zs[:, z0 + 1]), 2: tf.emul(sels[:, 2], re)}
        for k in range(len(bounds) - 1):
            first, rows = bounds[k], bounds[k + 1] - bounds[k]
            acc_in, acc_out = (_segmented_horner(rows, table_lanes, lambda u, col=col: coeffs[first + rows - 1 - u, col].expand(B), delta,
                                                 tf.mul, tf.add, torch.zeros_like(delta)) for col in (0, 1))
            cols[3 + k] = tf.emul(sels[:, 4 + k], re - tf.ext_from_base(tf.add(acc_in, tf.mul(cb, acc_out))))
        # ascending powers of delta: combo_b(num_lut - 1), ..., combo_b(0), then re_next
        cur = _segmented_horner(num_lut + 1, re_lanes, lambda u: combo(3 * (num_lut - 1 - u), cb) if u < num_lut else zs_next[:, z0],
                                delta, tf.escale, GExt.__add__, zero)
        luts = len(bounds) - 1
        cols[3 + luts] = tf.emul(sels[:, 0], re - cur)
        for j in range(n_sldc):
            prev = zs_next[:, z0 + n_sldc] if j == 0 else zs[:, z0 + j]
            dmin = zs[:, z0 + 1 + j] - prev
            lu, lut = [], []
            for lane in range(chunk_lanes):
                lu_p, lu_s = one, zero
                for i in range(j * lu_deg + lane, min((j + 1) * lu_deg, num_lu), chunk_lanes):
                    t = term(2 * i, ca, alpha)
                    lu_s, lu_p = tf.emul(lu_s, t) + lu_p, tf.emul(lu_p, t)
                lut_p, lut_s = one, zero
                for i in range(j * lut_deg + lane, min((j + 1) * lut_deg, num_lut), chunk_lanes):
                    t = term(3 * i, ca, alpha)
                    lut_s, lut_p = tf.emul(lut_s, t) + tf.emul(wires[:, 3 * i + 2], lut_p), tf.emul(lut_p, t)
                lu.append((lu_p, lu_s))
                lut.append((lut_p, lut_s))
            (lu_p, lu_s), (lut_p, lut_s) = _tree(lu, meet), _tree(lut, meet)
            cols[4 + luts + 2 * j] = tf.emul(sels[:, 0], tf.emul(lut_p, dmin) - lut_s)
            cols[5 + luts + 2 * j] = tf.emul(sels[:, 1], tf.emul(lu_p, dmin) + lu_s)
        rounds += [cols[k] for k in range(len(cols))]
    out = tf.ext_stack(rounds, dim=1) if rounds else tf.ext_zeros((B, 0), dev)
    return out.re, out.im


def _ext_ints(re, im, lane, *index):
    """One extension word of lane `lane` as a pair of canonical Python ints."""
    return int(tf.to_u64(re[(lane,) + index])) % P, int(tf.to_u64(im[(lane,) + index])) % P


FOLD_ARITY_BITS = [1, 2, 3, 4, 5, 6]  # the steps of one launch: arity 2 to 32 staged in shared memory, 64 in scratch
FOLD_SHAPES = [(37, 28), (5, 3), (1030, 2), (0, 28)]  # (B, Q)


def check_coset_fold(lib, c, rng, dev, max_lanes: int):
    """checks["coset_fold"]: FOLD_ARITY_BITS as the steps of one launch at
    each of FOLD_SHAPES (B cut to max_lanes), then on a strided query slice
    of the first; the inverses of the offsets random with 0 and 1 among
    them; against coset_fold_plain, coset_fold_rows_plain and golden/'s
    fold_coset (the offset the inverse's inverse) on a few lanes."""
    cases = []
    for B, Q in FOLD_SHAPES:
        B = min(B, max_lanes)
        evals = [tf.from_u64(words(rng, (B, Q, 1 << bits, 2)), dev) for bits in FOLD_ARITY_BITS]
        off = rng.integers(0, P, size=(len(FOLD_ARITY_BITS), B, Q), dtype=np.uint64)
        off.reshape(len(FOLD_ARITY_BITS), B * Q)[:, : min(2, B * Q)] = [0, 1][: min(2, B * Q)]
        betas = [tf.from_u64(words(rng, (B, 2)), dev) for _ in FOLD_ARITY_BITS]
        cases.append((f"({B}, {Q})", evals, [tf.from_u64(o, dev) for o in off], betas))
        if (B, Q) == FOLD_SHAPES[0]:
            cut = lambda t: t[:, 7:21]
            cases.append((f"({B}, {Q}) at queries 7:21", [cut(e) for e in evals], [cut(o) for o in tf.from_u64(off, dev)], betas))
    for what, evals, offs, betas in cases:
        perms = [torch.tensor([gf.reverse_bits(bits, i) for i in range(1 << bits)], dtype=torch.int64, device=dev) for bits in FOLD_ARITY_BITS]
        omegas = [gf.finv(gf.subgroup_generator(bits)) for bits in FOLD_ARITY_BITS]
        idfts = [tf.from_u64(np.array([[gf.fpow(w, j * k) for j in range(1 << b)] for k in range(1 << b)], dtype=np.uint64), dev)
                 for w, b in zip(omegas, FOLD_ARITY_BITS)]
        steps = [(e, o, b[:, 0], b[:, 1], w) for e, o, b, w in zip(evals, offs, betas, idfts)]
        before = lib.launches.get("coset_fold", 0)
        got = lib.coset_fold(steps)
        B, Q = offs[0].shape
        if lib.launches.get("coset_fold", 0) != before + (1 if B * Q else 0) or got.shape != (len(steps), 2, B, Q):
            raise AssertionError(f"coset_fold {what}: {lib.launches.get('coset_fold', 0) - before} launches, shape {tuple(got.shape)}")
        c.compare(got, coset_fold_rows_plain(steps), f"{what}, arity bits {FOLD_ARITY_BITS}, the kernel's order")
        for k, (e, o, b, perm, w) in enumerate(zip(evals, offs, betas, perms, idfts)):
            want = coset_fold_plain(e, o, GExt(b[:, 0], b[:, 1]), perm, w)
            name = f"{what}, arity {1 << FOLD_ARITY_BITS[k]}"
            c.compare(got[k], torch.stack([want.re, want.im]), name)
            for lane in range(min(B, 2)):
                for q in (0, Q - 1):
                    oi = int(tf.to_u64(o[lane, q]))
                    if oi == 0:
                        continue
                    vals = [_ext_ints(e[..., 0], e[..., 1], lane, q, gf.reverse_bits(FOLD_ARITY_BITS[k], j)) for j in range(e.shape[2])]
                    gold = fold_coset(_ext_ints(b[:, 0], b[:, 1], lane), FOLD_ARITY_BITS[k], gf.finv(oi), vals)
                    c.compare(got[k, :, lane, q], np.array(gold, np.uint64), f"{name}, lane {lane} query {q} vs golden")


# (B, r, maxdeg, n_chunks): the main path's shape at a B not a multiple of a block, maxdeg 1 to 8 (powers of two and
# not: some lanes' second wire is past maxdeg), one above a warp (32 lanes, two wires or one each), no lanes
PP_SHAPES = [(37, 2, 8, 10), (5, 1, 2, 3), (1030, 3, 4, 1), (29, 2, 3, 4), (11, 1, 5, 3), (7, 3, 7, 2), (9, 2, 40, 2),
             (3, 1, 1, 5), (0, 2, 8, 10)]


def golden_partial_products(n, zeta, zs, zs_next, pps, wires, sigmas, betas, gammas, k_is, maxdeg):
    """L0(zeta)(z - 1) a round and the partial-product checks of one lane,
    as golden/plonk.py eval_all_plonk_constraints forms its terms (1) and
    (2): every argument canonical Python ints, extension values as pairs."""
    lag0 = gf.ediv(gf.esub(gf.epow(zeta, n), gf.EXT_ONE), gf.escale(n % P, gf.esub(zeta, gf.EXT_ONE)))
    out = [gf.emul(lag0, gf.esub(z, gf.EXT_ONE)) for z in zs]
    npp = len(pps) // len(zs)
    for rnd, (z, z_next, beta, gamma) in enumerate(zip(zs, zs_next, betas, gammas)):
        numers = [gf.eadd(w, gf.eadd(gf.escale(gf.fmul(beta, k), zeta), (gamma, 0))) for k, w in zip(k_is, wires)]
        denoms = [gf.eadd(w, gf.eadd(gf.escale(beta, s), (gamma, 0))) for s, w in zip(sigmas, wires)]
        current = [z] + list(pps[rnd * npp : (rnd + 1) * npp]) + [z_next]
        for c in range(len(current) - 1):
            num, den = gf.EXT_ONE, gf.EXT_ONE
            for t in numers[c * maxdeg : (c + 1) * maxdeg]:
                num = gf.emul(num, t)
            for t in denoms[c * maxdeg : (c + 1) * maxdeg]:
                den = gf.emul(den, t)
            out.append(gf.esub(gf.emul(current[c], num), gf.emul(current[c + 1], den)))
    return out


def partial_products_words(rng, B: int, r: int, maxdeg: int, n_chunks: int, n: int, above_p=()) -> dict:
    """numpy words of one partial-product call: the openings (zs, zs_next
    (B, r, 2), pps (B, r (n_chunks - 1), 2), wires and sigmas (B, maxdeg
    n_chunks, 2)) from words(), zeta and the challenges canonical, zeta^n
    and the inverse of n (zeta - 1) from golden/; in each lane of `above_p`
    every opening word written as y + p (0 < y < 2^32 - 1)."""
    ns = maxdeg * n_chunks
    w = {"zs": words(rng, (B, r, 2)), "zs_next": words(rng, (B, r, 2)), "pps": words(rng, (B, r * (n_chunks - 1), 2)),
         "wires": words(rng, (B, ns, 2)), "sigmas": words(rng, (B, ns, 2))}
    for lane in above_p:
        for x in w.values():
            x[lane] = rng.integers(1, 2**32 - 1, size=x[lane].shape, dtype=np.uint64) + np.uint64(P)
    w["zeta"] = rng.integers(2, P, size=(B, 2), dtype=np.uint64)
    w["zeta_n"] = np.array([gf.epow((int(x), int(y)), n) for x, y in w["zeta"]], np.uint64).reshape(B, 2)
    w["l0_den_inv"] = np.array([gf.einv(gf.escale(n, gf.esub((int(x), int(y)), gf.EXT_ONE))) for x, y in w["zeta"]], np.uint64).reshape(B, 2)
    w["betas"], w["gammas"] = (rng.integers(0, P, size=(B, r), dtype=np.uint64) for _ in range(2))
    w["k_is"] = rng.integers(0, P, size=ns, dtype=np.uint64)
    return w


def partial_products_args(w: dict, maxdeg: int, dev="cpu") -> tuple:
    """partial_products_words' words as partial_products_plain's arguments."""
    ext = lambda a: GExt(tf.from_u64(a[..., 0], dev), tf.from_u64(a[..., 1], dev))
    return (ext(w["zeta_n"]), ext(w["l0_den_inv"]), ext(w["zs"]), ext(w["zs_next"]), ext(w["pps"]), ext(w["wires"]), ext(w["sigmas"]),
            tf.from_u64(w["betas"], dev), tf.from_u64(w["gammas"], dev), ext(w["zeta"]), tf.from_u64(w["k_is"], dev), maxdeg)


def check_partial_products(lib, c, rng, dev, max_lanes: int):
    """checks["partial_products"]: PP_SHAPES (B cut to max_lanes), the
    openings interleaved in one (B, M, 2) tensor as the verifier's views of
    openings1 are, zeta^n and the inverse of n (zeta - 1) from a zeta and an
    n of golden/'s on the lanes held against it."""
    for B, r, maxdeg, n_chunks in PP_SHAPES:
        B = min(B, max_lanes)
        ns = maxdeg * n_chunks
        widths = [r, r, r * (n_chunks - 1), ns + 3, ns]  # zs, zs_next, pps, wires (more than the routed ones), sigmas
        at = np.concatenate([[0], np.cumsum(widths)])
        op = tf.from_u64(words(rng, (B, int(at[-1]), 2)), dev)
        zs, zs_next, pps, wires, sigmas = (GExt(op[:, at[i] : at[i + 1], 0], op[:, at[i] : at[i + 1], 1]) for i in range(5))
        wires = wires[:, :ns]
        n = 1 << int(rng.integers(3, 13))
        zeta_np = rng.integers(2, P, size=(B, 2), dtype=np.uint64)
        zn_np = np.array([gf.epow((int(x), int(y)), n) for x, y in zeta_np], np.uint64).reshape(B, 2)
        inv_np = np.array([gf.einv(gf.escale(n, gf.esub((int(x), int(y)), gf.EXT_ONE))) for x, y in zeta_np], np.uint64).reshape(B, 2)
        zeta, zeta_n, l0_inv = (tf.from_u64(x, dev) for x in (zeta_np, zn_np, inv_np))
        zeta, zeta_n, l0_inv = (GExt(x[:, 0], x[:, 1]) for x in (zeta, zeta_n, l0_inv))
        betas, gammas = tf.from_u64(rng.integers(0, P, size=(B, r), dtype=np.uint64), dev), tf.from_u64(words(rng, (B, r)), dev)
        k_is = tf.from_u64(rng.integers(0, P, size=ns, dtype=np.uint64), dev)
        args = (zeta_n, l0_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg)
        pairs = [(x.re, x.im) if isinstance(x, GExt) else x for x in args]
        what = f"B {B}, r {r}, maxdeg {maxdeg}, {n_chunks} chunks"
        before = lib.launches.get("partial_products", 0)
        got = torch.stack(lib.partial_products(*pairs))
        if lib.launches.get("partial_products", 0) != before + (1 if B else 0) or got.shape != (2, B, r + r * n_chunks):
            raise AssertionError(f"partial_products {what}: {lib.launches.get('partial_products', 0) - before} launches, shape {tuple(got.shape)}")
        want = partial_products_plain(*args)
        c.compare(got, torch.stack([want.re, want.im]), what)
        c.compare(got, torch.stack(partial_products_rows_plain(*pairs)), f"{what}, the kernel's order")
        ints = lambda x, lane: [_ext_ints(x.re, x.im, lane, i) for i in range(x.shape[1])]
        for lane in range(min(B, 2)):
            gold = golden_partial_products(n, _ext_ints(zeta.re, zeta.im, lane), ints(zs, lane), ints(zs_next, lane), ints(pps, lane),
                                           ints(wires, lane), ints(sigmas, lane), [int(x) for x in tf.to_u64(betas[lane])],
                                           [int(x) % P for x in tf.to_u64(gammas[lane])], [int(x) for x in tf.to_u64(k_is)], maxdeg)
            c.compare(got[:, lane].t(), np.array(gold, np.uint64), f"{what}, lane {lane} vs golden")


# (B, r, num_routed_wires, lookup polys a round, maxdeg, table lengths)
# (every shape golden/ takes: ceil(slots / chunk size) = the SLDC chunks, for both kinds of slot)
LOOKUP_SHAPES = [(37, 2, 80, 7, 8, [5, 26, 27, 53]), (9, 1, 12, 3, 4, [1, 4, 9]), (5, 3, 6, 2, 4, [2]), (1030, 2, 80, 7, 8, [17]),
                 (0, 2, 80, 7, 8, [5]), (7, 1, 80, 2, 41, [5, 26]), (11, 2, 30, 4, 6, [3, 7]), (3, 1, 100, 6, 11, [40]),
                 (4, 2, 12, 3, 4, [50]), (6, 1, 80, 7, 8, [300, 5])]


def probe_sldc_subtrahends(rng, zs, zs_next, r: int, n_polys: int, lanes):
    """Write into numpy words (B, r n_polys, 2) in place: in the k-th lane
    of `lanes` the SLDC transition of chunk k mod n_sldc of every round gets
    a small minuend and a subtrahend y + p above it + p (0 < y < 2^32 - 1),
    where ops/field.sub is not exact mod p (as the JAX package's): chunk 0's
    subtrahend is zs_next's last SLDC column, chunk j's zs's column j."""
    for k, lane in enumerate(lanes):
        j = k % (n_polys - 1)
        for z0 in range(0, r * n_polys, n_polys):
            zs[lane, z0 + 1 + j] = rng.integers(0, 1 << 16, size=2, dtype=np.uint64)
            prev = zs_next[lane, z0 + n_polys - 1] if j == 0 else zs[lane, z0 + j]
            prev[:] = zs[lane, z0 + 1 + j] + rng.integers(1, 1 << 31, size=2, dtype=np.uint64) + np.uint64(P)


def check_lookup_checks(lib, c, rng, dev, max_lanes: int):
    """checks["lookup_checks"]: LOOKUP_SHAPES (B cut to max_lanes), the
    openings interleaved as the verifier's views are, tables of random
    words padded as lookup_tables pads them; against lookup_checks_plain,
    lookup_checks_rows_plain and golden/plonk.py eval_lookup_equations (on
    stand-ins of the common data, openings and challenges) on the first
    GOLDEN_LANES lanes, whose words are canonical: the SLDC transition's
    sldc - prev subtracts two proof words, and ops/field.sub (as the JAX
    package's) is not exact mod p where the subtrahend is a word x + p above
    the minuend + p, which golden/ reduces first. The lanes after those
    carry such subtrahends at every chunk (probe_sldc_subtrahends)."""
    for B, r, routed, n_polys, maxdeg, lengths in LOOKUP_SHAPES:
        B = min(B, max_lanes)
        luts = len(lengths)
        tables = [[tuple(int(x) for x in row) for row in rng.integers(0, 1 << 16, size=(n, 2))] for n in lengths]
        common = SimpleNamespace(config=SimpleNamespace(num_routed_wires=routed), luts=tables, num_luts=luts,
                                 num_lookup_polys=n_polys, quotient_degree_factor=maxdeg)
        coeffs, offsets = lookup_tables(common, dev)
        widths = [4 + luts, routed + 5, r * n_polys, r * n_polys]  # selectors, wires (more than the routed ones), zs, zs_next
        at = np.concatenate([[0], np.cumsum(widths)])
        op_np = words(rng, (B, int(at[-1]), 2))
        op_np[:GOLDEN_LANES] %= np.uint64(P)  # golden/'s lanes (see check_lookup_checks)
        probe_sldc_subtrahends(rng, op_np[:, at[2] : at[3]], op_np[:, at[3] : at[4]], r, n_polys, range(GOLDEN_LANES, min(B, 2 * GOLDEN_LANES + n_polys)))
        op = tf.from_u64(op_np, dev)
        sels, wires, zs, zs_next = (GExt(op[:, at[i] : at[i + 1], 0], op[:, at[i] : at[i + 1], 1]) for i in range(4))
        d_np = rng.integers(0, P, size=(B, r, 4), dtype=np.uint64)
        deltas_t = tf.from_u64(d_np, dev)
        deltas = [tuple(deltas_t[:, k, j] for j in range(4)) for k in range(r)]
        what = f"B {B}, r {r}, {routed} routed wires, {n_polys - 1} SLDC chunks, maxdeg {maxdeg}, tables of {lengths} rows"
        pairs = [(x.re, x.im) for x in (sels, wires, zs, zs_next)]
        before = lib.launches.get("lookup_checks", 0)
        got = torch.stack(lib.lookup_checks(*pairs, deltas_t, coeffs, offsets, routed, maxdeg))
        width = r * (4 + luts + 2 * (n_polys - 1))
        if lib.launches.get("lookup_checks", 0) != before + (1 if B else 0) or got.shape != (2, B, width):
            raise AssertionError(f"lookup_checks {what}: {lib.launches.get('lookup_checks', 0) - before} launches, shape {tuple(got.shape)}")
        want = lookup_checks_plain(sels, wires, zs, zs_next, deltas, coeffs, offsets, routed, maxdeg)
        c.compare(got, torch.stack([want.re, want.im]), what)
        c.compare(got, torch.stack(lookup_checks_rows_plain(*pairs, deltas_t, coeffs, offsets, routed, maxdeg)), f"{what}, the kernel's order")
        for lane in range(min(B, GOLDEN_LANES)):
            ints = lambda x: [_ext_ints(x.re, x.im, lane, i) for i in range(x.shape[1])]
            openings = SimpleNamespace(wires=ints(wires), lookup_zs=ints(zs), lookup_zs_next=ints(zs_next))
            ch = SimpleNamespace(deltas=[SimpleNamespace(a=int(a), b=int(b), alpha=int(al), delta=int(dl)) for a, b, al, dl in d_np[lane]])
            gold = eval_lookup_equations(common, ints(sels), openings, ch)
            c.compare(got[:, lane].t(), np.array(gold, np.uint64), f"{what}, lane {lane} vs golden")


def gate_filter_rows_plain(sels, cons, cols, consts, mask, n_gc: int):
    """What `KernelLibrary.gate_filter` computes from its arguments (sels
    and cons (re, im) pairs), in the kernel's own order (csrc/plonk.cu): a
    live gate's selector value is its first live factor's consts - x, times
    each further one in slot order (1 where none is live); then for each
    slot c the sum over the gates in order of sel_k cons[:, k n_gc + c]
    (the kernel keeps the sum exact and reduces once: the canonical value
    of the same sum, which these canonical adds give). Returns (re, im),
    each (B, n_gc); its words equal gate_filter_plain's."""
    sels, cons = GExt(*sels), GExt(*cons)
    B, dev = cons.shape[0], cons.re.device
    acc = tf.ext_zeros((B, n_gc), dev)
    for k in range(cols.shape[0]):
        x = sels[:, int(cols[k])]
        sel = tf.ext_constant(1, shape=(B,), device=dev)
        first = True
        for j in range(consts.shape[1]):
            if bool(mask[k, j]):
                t = GExt(consts[k, j].expand(B), torch.zeros_like(x.im)) - x
                sel, first = (t if first else tf.emul(sel, t)), False
        acc = acc + tf.emul(sel.unsqueeze(-1), cons[:, k * n_gc : (k + 1) * n_gc])
    return acc.re, acc.im


def golden_gate_filter(sels, cons, cols, consts, mask, n_gc: int):
    """The filter of one lane in Python ints on canonical words: sels
    (n_sel,) and cons (L n_gc,) extension pairs, the rows as lists ->
    (n_gc,) pairs."""
    acc = [gf.EXT_ZERO] * n_gc
    for k, col in enumerate(cols):
        sel = gf.EXT_ONE
        for c, live in zip(consts[k], mask[k]):
            if live:
                sel = gf.emul(sel, gf.esub((int(c), 0), sels[col]))
        acc = [gf.eadd(a, gf.emul(sel, cons[k * n_gc + i])) for i, a in enumerate(acc)]
    return acc


GATE_FILTER_BATCHES = [1, 1023, 16384, 0]


@functools.lru_cache(maxsize=None)
def gate_filter_commons():
    """(name, common data) of the templates whose live gates' rows the gate
    filter's check runs: fibonacci, the gate zoo (as gate_programs() finds
    it), the lookup fixture, a shape-grid point and fuzz seed 13."""
    from ..models.fibonacci import fibonacci_fixture
    from ..models.gate_zoo import gate_zoo_fixture
    from ..models.lookup import lookup_fixture
    from ..types import load_common
    from . import shape_circuits as sc

    zoo = load_common(ZOO_COMMON) if os.path.exists(ZOO_COMMON) else gate_zoo_fixture(num_query_rounds=2, proof_of_work_bits=2).common
    return (("fibonacci", fibonacci_fixture(num_query_rounds=2).common), ("gate zoo", zoo),
            ("lookup", lookup_fixture(num_query_rounds=2, proof_of_work_bits=2).common),
            (f"grid {sc.GRID[0]}", sc.grid_fixture(*sc.GRID[0]).common), ("fuzz 13", sc.fuzz_fixture(13).common))


def gate_filter_rows(common, dev):
    """(n_sel, n_gc, cols, consts, mask): a template's gate-selector columns,
    gate constraints and live gates' rows as TorchVerifier builds them."""
    from ..compiler import CircuitTemplate
    from ..verifier_torch import TorchVerifier

    v = TorchVerifier(CircuitTemplate(common), device=dev)
    return v.tpl.n_gate_selectors, common.num_gate_constraints, v._filter_cols, v._filter_consts, v._filter_mask


def made_filter_rows(dev):
    """(name, n_sel, n_gc, cols, consts, mask) of rows made here: one gate
    of one live slot (its selector the raw subtraction's word); gates of no
    live slot, of one after a gap, of three with a gap; no live gate."""
    out = []
    for name, n_sel, n_gc, cols, consts, mask in [
        ("one gate, one slot", 2, 5, [1], [[3]], [[True]]),
        ("gaps", 4, 7, [0, 3, 2], [[5, 0, 0, 0], [0, 9, 0, 0], [2**32 - 1, 1, 0, 4]],
         [[False, False, False, False], [False, True, False, False], [True, True, False, True]]),
        ("no live gate", 3, 4, [], [], []),
    ]:
        out.append((name, n_sel, n_gc, torch.tensor(cols, dtype=torch.int64, device=dev),
                    tf.from_u64(np.array(consts, dtype=np.uint64).reshape(len(cols), -1 if cols else 1), dev),
                    torch.tensor(np.array(mask, dtype=bool).reshape(len(cols), -1 if cols else 1), device=dev)))
    return out


def check_gate_filter(lib, c, rng, dev, max_lanes: int, commons=None):
    """checks["gate_filter"]: the live gates' rows of `commons` ((name,
    common) pairs; gate_filter_commons() unless given) and made_filter_rows()
    at GATE_FILTER_BATCHES cut to max_lanes, the selector columns a view at
    column stride 2 beside other openings; against gate_filter_plain,
    gate_filter_rows_plain and golden_gate_filter on the first
    GOLDEN_LANES lanes, whose words are reduced mod p (golden/ reduces
    first; consts - x is not exact mod p on a word y + p above consts + p,
    tests/test_torch_noncanonical.py)."""
    cases = [(name, *gate_filter_rows(common, dev)) for name, common in (gate_filter_commons() if commons is None else commons)]
    for name, n_sel, n_gc, cols, consts, mask in cases + made_filter_rows(dev):
        live = cols.shape[0]
        for batch in sorted({min(b, max_lanes) for b in GATE_FILTER_BATCHES}):
            op_np = words(rng, (batch, n_sel + 3, 2))
            cons_np = words(rng, (batch, live * n_gc, 2))
            op_np[:GOLDEN_LANES] %= np.uint64(P)
            cons_np[:GOLDEN_LANES] %= np.uint64(P)
            op, cons_t = tf.from_u64(op_np, dev), tf.from_u64(cons_np, dev)
            sels = GExt(op[:, 1 : 1 + n_sel, 0], op[:, 1 : 1 + n_sel, 1])  # column stride 2, as the verifier's view of openings1
            cons = GExt(cons_t[..., 0].contiguous(), cons_t[..., 1].contiguous())
            what = f"{name}: {live} live gates, {n_gc} constraints, {consts.shape[1]} factor slots, {batch} lanes"
            before = lib.launches.get("gate_filter", 0)
            got = torch.stack(lib.gate_filter((sels.re, sels.im), (cons.re, cons.im), cols, consts, mask, n_gc))
            if lib.launches.get("gate_filter", 0) != before + (1 if batch and live else 0) or got.shape != (2, batch, n_gc):
                raise AssertionError(f"gate_filter {what}: {lib.launches.get('gate_filter', 0) - before} launches, shape {tuple(got.shape)}")
            want = gate_filter_plain(sels, cons, cols, consts, mask, n_gc)
            c.compare(got, torch.stack([want.re, want.im]), what)
            c.compare(got, torch.stack(gate_filter_rows_plain((sels.re, sels.im), (cons.re, cons.im), cols, consts, mask, n_gc)),
                      f"{what}, the kernel's order")
            rows = (cols.tolist(), [[int(x) for x in r] for r in tf.to_u64(consts)], mask.tolist())
            for lane in range(min(batch, GOLDEN_LANES)):
                gold = golden_gate_filter([_ext_ints(sels.re, sels.im, lane, i) for i in range(n_sel)],
                                          [_ext_ints(cons.re, cons.im, lane, i) for i in range(live * n_gc)], *rows, n_gc)
                c.compare(got[:, lane].t(), np.array(gold, np.uint64).reshape(n_gc, 2), f"{what}, lane {lane} vs golden")


def check_field_kernels(lib, checks, dev, n_random: int = N_RANDOM):
    """The field kernels of `lib` (kernels.KernelLibrary, or the CPU run's
    PlainLibrary) into checks["inv"] (the grouped inversion), checks["horner"], checks["pow"] (the grouped exponentiation),
    checks["gate_program"], checks["coset_fold"], checks["partial_products"]
    checks["lookup_checks"] and checks["gate_filter"]; raises on the first
    word that differs."""
    rng = np.random.default_rng(2026)

    c = checks["inv"]
    a_np = np.concatenate([
        np.array(EDGE, dtype=np.uint64),
        rng.integers(0, 2**32 - 1, size=4096, dtype=np.uint64) + np.uint64(P),
        rng.integers(0, P, size=n_random, dtype=np.uint64),
    ])
    check_inv_grouped(lib, c, rng, dev, a_np)

    kernel = isinstance(lib, KernelLibrary)  # not the plain stand-in (also when its module runs as __main__)
    c = checks["horner"]
    picked = set()
    for rows, k, base_v, base_p, v_rep, p_rep, interleaved in HORNER_CASES:
        n = rows * v_rep
        segments = horner_segments(n, k, lib.sms)
        picked.add(segments)
        what = (f"({rows} x {v_rep}, {k}) {'base' if base_v else 'ext'} values, {'base' if base_p else 'ext'} point "
                f"x {p_rep}{', interleaved' if interleaved else ''}, {segments} segments a row")
        v_np = words(rng, (rows, k, 2))
        p_np = words(rng, (n // p_rep, 2))
        if interleaved:
            v = tf.from_u64(v_np, dev)
            v_re, v_im = v[..., 0], v[..., 1]  # column stride 2
        else:
            v_re, v_im = tf.from_u64(v_np[..., 0], dev), tf.from_u64(v_np[..., 1], dev)
        if base_v:
            v_re, v_im, v_np[..., 1] = v_re.contiguous(), None, 0
        p_re, p_im = tf.from_u64(p_np[:, 0], dev), None if base_p else tf.from_u64(p_np[:, 1], dev)
        if base_p:
            p_np[:, 1] = 0
        before = lib.launches.get("horner", 0)
        got = lib.horner(v_re, v_im, p_re, p_im, v_rep, p_rep)
        if lib.launches.get("horner", 0) != before + (1 if n else 0):
            raise AssertionError(f"horner {what}: {lib.launches.get('horner', 0) - before} launches")
        want = horner_rows_plain(v_re, v_im, p_re, p_im, v_rep, p_rep)
        for part, g, w in zip(("re", "im"), got, want):
            if g.shape != (n,):
                raise AssertionError(f"horner {what}: {part} has shape {tuple(g.shape)}")
            c.compare(g, w, f"{what} {part}")
        if k == 0 and n and (tf.to_u64(got[0]).any() or tf.to_u64(got[1]).any()):
            raise AssertionError("horner with K = 0 is not zero")
        for row in list(range(0, n, max(n // GOLDEN_ROWS, 1)))[:GOLDEN_ROWS]:
            vr, pr = row // v_rep, row // p_rep
            gold = _golden_horner(v_np[vr, :, 0], None if base_v else v_np[vr, :, 1], p_np[pr, 0], None if base_p else p_np[pr, 1])
            c.compare(torch.stack([got[0][row], got[1][row]]), np.array(gold, dtype=np.uint64), f"{what} row {row} vs golden")
    if picked != set(HORNER_SEGMENTS):
        raise AssertionError(f"horner: the cases reached the segment counts {sorted(picked)}, not every one of {HORNER_SEGMENTS}")
    check_pow_grouped(lib, checks["pow"], rng, dev, n_random)
    check_gate_program(lib, checks["gate_program"], rng, dev, n_random if kernel else min(n_random, PLAIN_GATE_LANES), kernel)
    check_coset_fold(lib, checks["coset_fold"], rng, dev, n_random)
    check_partial_products(lib, checks["partial_products"], rng, dev, n_random)
    check_lookup_checks(lib, checks["lookup_checks"], rng, dev, n_random)
    check_gate_filter(lib, checks["gate_filter"], rng, dev, n_random)
    for name in ("horner", "inv", "pow", "gate_program", "coset_fold", "partial_products", "lookup_checks", "gate_filter"):
        print(f"check {name}: {checks[name].cases} words bit-exact against plain and golden")
    return checks
