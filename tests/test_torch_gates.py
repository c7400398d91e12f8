"""The port's levelizer copy and gate executor against the JAX package.

`levelize.levelize_gates` must give arrays identical to
`gates_jax.levelize_gates` (fibonacci, poseidon_chain, the gate zoo's
program, loaded from its cached common data or built from the model without
proving, and fuzz seed 13's); no real op may read the trash slot 0 (dummy
ops all write it); `run_levelized` on random inputs made with numpy must
equal the JAX executor bit for bit. The kernel's form of the program
(`gates_torch.compact_ops`, csrc/gates.cu) must hold every real op of the
padded arrays exactly once, level by level, and no dummy op; a level's ops
must read only slots written before it (the kernel runs a level's adds and
multiplies as one pass), every node slot must be written exactly once; and
a Python-int interpreter of the compact lists on golden/field
(`tools/check_field_kernels.golden_gate_program`) must equal
`GateProgram.forward_plain` on random lanes with words x + p among them.
The program as the kernel runs it (`gates_torch.pack_program`: its own
schedule, a tape packed by liveness, outputs stored as they are made) must
give those words too, read each operand from a slot that holds it, store
every column once, and fit its stated tape."""

import os

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu.compiler import CircuitTemplate
from plonky2_verifier_tpu.compiler import gates_jax
from plonky2_verifier_tpu.gates import CONST, LKPSEL, PI, SEL, WIRE
from plonky2_verifier_tpu.golden import field as gf
from plonky2_verifier_tpu.models.fibonacci import fibonacci_fixture
from plonky2_verifier_tpu.models.poseidon_chain import poseidon_chain_fixture
from plonky2_verifier_tpu.models.gate_zoo import gate_zoo_fixture
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu.types import CommonCircuitData, load_common
from plonky2_verifier_tpu_torch.compiler import gates_torch, levelize
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.tools import shape_circuits
from plonky2_verifier_tpu_torch.tools.check_field_kernels import (
    gate_inputs,
    gate_programs,
    golden_gate_program,
    golden_packed_program,
    verifier_like_gather,
    words,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARRAYS = ("lit_values", "add_src1", "add_src2", "add_sign", "add_dst", "mul_src1", "mul_src2", "mul_dst", "out_slots")
FIXTURES = {
    "fibonacci": lambda: fibonacci_fixture(num_query_rounds=2).common,
    "poseidon_chain": lambda: poseidon_chain_fixture(n_chain=2, num_query_rounds=2).common,
}
ZOO_COMMON = os.path.join(os.path.dirname(__file__), "..", "fixtures", "gate_zoo_3abb3dc54fe7_common.json")


def _zoo_common():
    """The gate zoo's common data as its 2-query fixture caches it, or built
    from the model (the same gates) where no run has cached it yet."""
    if os.path.exists(ZOO_COMMON):
        return load_common(ZOO_COMMON)
    return gate_zoo_fixture(num_query_rounds=2, proof_of_work_bits=2).common


ALL_PROGRAMS = dict(
    FIXTURES,
    gate_zoo=_zoo_common,
    fuzz_13=lambda: CommonCircuitData.from_json(shape_circuits.fuzz_fixture(13).common.to_json()),
)


def _levelized(common):
    tpl = CircuitTemplate(common)
    args = (tuple(tpl.common.gates), tpl.n_gate_selectors, tpl.n_lookup_selectors, tpl.n_gate_constants, tpl.num_wires)
    return levelize.levelize_gates(*args), gates_jax.levelize_gates(*args)


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def programs(request):
    return _levelized(FIXTURES[request.param]())


@pytest.fixture(scope="module", params=sorted(ALL_PROGRAMS))
def all_programs(request):
    return _levelized(ALL_PROGRAMS[request.param]())


def test_levelize_copy_is_identical(all_programs):
    ours, ref = all_programs
    for name in ARRAYS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ours.n_tape, ours.n_levels, ours.input_slots) == (ref.n_tape, ref.n_levels, ref.input_slots)
    assert len(ours.out_slots_per_prog) == len(ref.out_slots_per_prog)
    for a, b in zip(ours.out_slots_per_prog, ref.out_slots_per_prog):
        np.testing.assert_array_equal(a, b)


def test_no_real_op_reads_trash_slot(all_programs):
    lp, _ = all_programs
    for src1, src2, dst in [(lp.add_src1, lp.add_src2, lp.add_dst), (lp.mul_src1, lp.mul_src2, lp.mul_dst)]:
        real = dst != 0
        assert (src1[real] != 0).all() and (src2[real] != 0).all()
    assert (lp.out_slots != 0).all()
    # every dummy op is a pure trash write: it reads slot 0 only
    assert (lp.add_src1[lp.add_dst == 0] == 0).all() and (lp.mul_src2[lp.mul_dst == 0] == 0).all()


def test_run_levelized_matches_jax(programs):
    lp, _ = programs
    B = 3
    rng = np.random.default_rng(5)
    t_inputs, j_inputs = {}, {}
    for kind in (SEL, LKPSEL, CONST, WIRE, PI):
        _, w = lp.input_slots[kind]
        re = rng.integers(0, gf.P, size=(B, w), dtype=np.uint64)
        im = rng.integers(0, gf.P, size=(B, w), dtype=np.uint64)
        t_inputs[kind] = tf.GExt(tf.from_u64(re, "cpu"), tf.from_u64(im, "cpu"))
        j_inputs[kind] = jf.GExt(jf.from_u64(re), jf.from_u64(im))
    got = gates_torch.run_levelized(lp, t_inputs, (B,), per_prog=True)
    want = gates_jax.run_levelized(lp, j_inputs, (B,), per_prog=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tf.to_u64(g.re), jf.to_u64(w.re))
        np.testing.assert_array_equal(tf.to_u64(g.im), jf.to_u64(w.im))
    flat = gates_torch.run_levelized(lp, t_inputs, (B,))
    np.testing.assert_array_equal(tf.to_u64(flat.re), np.concatenate([tf.to_u64(g.re) for g in got], axis=-1))


def _n_init(lp):
    return max([1 + len(lp.lit_values)] + [off + w for off, w in lp.input_slots.values()])


def test_compact_ops_hold_every_real_op_once(all_programs):
    """Level by level, the compact lists are the padded waves' real ops (the
    same multiset, in the padded order) and nothing else."""
    lp, _ = all_programs
    ops = gates_torch.compact_ops(lp)
    assert ops["adds"].dtype == ops["muls"].dtype == np.int32
    for lvl in range(lp.n_levels):
        real = lp.add_dst[lvl] != 0
        want = np.stack([lp.add_src1[lvl][real], lp.add_src2[lvl][real], lp.add_sign[lvl][real] == gf.P - 1, lp.add_dst[lvl][real]], 1)
        got = ops["adds"][ops["add_off"][lvl] : ops["add_off"][lvl + 1]]
        np.testing.assert_array_equal(got, want.astype(np.int32))
        real = lp.mul_dst[lvl] != 0
        want = np.stack([lp.mul_src1[lvl][real], lp.mul_src2[lvl][real], lp.mul_dst[lvl][real], 0 * lp.mul_dst[lvl][real]], 1)
        np.testing.assert_array_equal(ops["muls"][ops["mul_off"][lvl] : ops["mul_off"][lvl + 1]], want.astype(np.int32))
    assert ops["add_off"][-1] == len(ops["adds"]) == int((lp.add_dst != 0).sum())
    assert ops["mul_off"][-1] == len(ops["muls"]) == int((lp.mul_dst != 0).sum())
    assert (ops["adds"][:, 3] != 0).all() and (ops["muls"][:, 2] != 0).all()  # no dummy op
    assert set(np.unique(lp.add_sign[lp.add_dst != 0]).tolist()) <= {1, gf.P - 1}


def test_compact_levels_read_only_what_earlier_levels_wrote(all_programs):
    """The kernel's premises: each node slot is written by exactly one op, no
    op writes an input, literal or slot 0, and an op of level l reads only
    those or slots written at a level below l."""
    lp, _ = all_programs
    ops = gates_torch.compact_ops(lp)
    n_init = _n_init(lp)
    written_at = {}
    for lvl in range(lp.n_levels):
        adds = ops["adds"][ops["add_off"][lvl] : ops["add_off"][lvl + 1]]
        muls = ops["muls"][ops["mul_off"][lvl] : ops["mul_off"][lvl + 1]]
        reads = np.concatenate([adds[:, :2].ravel(), muls[:, :2].ravel()])
        assert all(s < n_init or written_at.get(int(s), lvl) < lvl for s in reads), lvl
        for dst in np.concatenate([adds[:, 3], muls[:, 2]]).tolist():
            assert dst >= n_init and dst not in written_at
            written_at[dst] = lvl
    assert sorted(written_at) == list(range(n_init, lp.n_tape))
    assert all(s < n_init and s != 0 or s in written_at for s in lp.out_slots.tolist())


def test_compact_interpreter_equals_forward_plain(all_programs):
    """golden_gate_program (Python ints on the compact lists) equals the
    padded loop bit for bit, on lanes with the edge band and words x + p."""
    lp, _ = all_programs
    B = 3
    rng = np.random.default_rng(11)
    inputs = {}
    for kind in (SEL, LKPSEL, CONST, WIRE, PI):
        t = tf.from_u64(words(rng, (B, lp.input_slots[kind][1], 2)), "cpu")
        inputs[kind] = tf.GExt(t[..., 0], t[..., 1])  # column stride 2, as the verifier's openings
    prog = gates_torch.GateProgram(lp, "cpu")
    got = prog.forward_plain(inputs, (B,))
    views = [(lp.input_slots[k][0], inputs[k].re, inputs[k].im) if lp.input_slots[k][1] else (lp.input_slots[k][0], None, None)
             for k in gates_torch.INPUT_KINDS]
    ops = gates_torch.compact_ops(lp)
    want = golden_gate_program(views, prog.lit_values, ops["add_off"], ops["adds"], ops["mul_off"], ops["muls"], lp.out_slots, lp.n_tape)
    assert torch.equal(got.re, want[0]) and torch.equal(got.im, want[1])
    again = prog(inputs, (B,))  # forward takes the plain loop for CPU tensors
    assert (again.re == got.re).all() and (again.im == got.im).all()



# The packed programs' shape, as pack_program gives it today: (steps, tape
# slots a lane, block barriers a block of the lanes the library gives 1024
# lanes on 132 SMs: 8 for every program, its ops staged beside the tapes).
# Steps of at most 64 ops spread the zoo's wide levels over its narrow
# chain: 15 of its 125 steps fit a warp, where 70 did under a cap of 128. Under the levels the zoo's tape needed 7,849 slots, or
# 3,134 with every slot freed after its last read; packed it fits 8 lanes
# and more in a block's 227 KB.
PACKED = {
    "fibonacci": (4, 126, 5),
    "poseidon_chain": (68, 980, 69),
    "gate zoo": (125, 1019, 112),
    "fuzz 13": (68, 1008, 69),
    "fuzz 23": (16, 250, 17),
}


@pytest.fixture(scope="module", params=sorted(PACKED))
def gate_program(request):
    (lp,) = [lp for name, lp in gate_programs() if name == request.param]
    return request.param, lp


def _gathers(lp):
    return [("own", lp.out_slots), ("verifier-like", verifier_like_gather(lp))]


def test_packed_program_equals_golden_and_forward_plain(gate_program):
    """The packed program run in Python ints (golden_packed_program, which
    also raises where a step reads a slot it writes, or a column is stored
    twice or never) equals golden_gate_program on the compact lists and
    forward_plain, on lanes with the edge band and words x + p, for the
    program's outputs and for a verifier-like gather (zeros, a slot twice,
    an input, a literal)."""
    name, lp = gate_program
    B = 2
    prog = gates_torch.GateProgram(lp, "cpu")
    inputs, views = gate_inputs(np.random.default_rng(len(name)), lp, B, "cpu")
    ops = gates_torch.compact_ops(lp)
    for what, slots in _gathers(lp):
        got = golden_packed_program(views, prog.pack(slots))
        gold = golden_gate_program(views, prog.lit_values, ops["add_off"], ops["adds"], ops["mul_off"], ops["muls"], slots, lp.n_tape)
        plain = prog.forward_plain(inputs, (B,), out_slots=slots)
        assert torch.equal(got[0], gold[0]) and torch.equal(got[1], gold[1]), what
        assert torch.equal(got[0], plain.re) and torch.equal(got[1], plain.im), what


def test_packed_tape_holds_each_operand_when_read(gate_program):
    """Symbolically, slot by slot: every op reads the tape slots that hold
    its own operands at that step (so no slot is read before it is written
    or after it is reused), no step writes a slot that it reads, every
    column is stored exactly once with the slot it gathers, and the tape
    has exactly as many slots as values are live at once."""
    name, lp = gate_program
    init = gates_torch.n_init(lp)
    ops = gates_torch.compact_ops(lp)
    compact = {int(d): (gates_torch.OP_SUB if neg else gates_torch.OP_ADD, int(s1), int(s2)) for s1, s2, neg, d in ops["adds"]}
    compact.update({int(d): (gates_torch.OP_MUL, int(s1), int(s2)) for s1, s2, d, _ in ops["muls"]})
    for what, slots in _gathers(lp):
        p = gates_torch.pack_program(lp, slots)
        tape = [None] * p["n_slots"]
        for slot, src in p["loads"].tolist():
            assert 0 < src < init and tape[slot] is None
            tape[slot] = src
        stored = [None] * len(slots)
        live, peak = sum(1 for s in tape if s is not None), 0
        last_read = {}  # program slot -> the last step that reads it
        for t in range(len(p["step_off"]) - 1):
            for d in p["origin"][p["step_off"][t] : p["step_off"][t + 1]].tolist():
                last_read.update(dict.fromkeys(compact[d][1:], t))
        decoded = gates_torch.decode_ops(p["ops"])
        assert (gates_torch.encode_ops(decoded) == p["ops"]).all()
        for t in range(len(p["step_off"]) - 1):
            rows = decoded[p["step_off"][t] : p["step_off"][t + 1]].tolist()
            origin = p["origin"][p["step_off"][t] : p["step_off"][t + 1]].tolist()
            written = [r[2] for r in rows if r[2] != gates_torch.NO_SLOT]
            assert not {x for r in rows for x in r[:2]} & set(written) and len(set(written)) == len(written), (what, t)
            for (x, y, dst, kind, col), d in zip(rows, origin):
                assert (kind, tape[x], tape[y]) == compact[d], (what, t, d)
                if col >= 0:
                    assert stored[col] is None and int(slots[col]) == d
                    stored[col] = d
            for (_, _, dst, _, _), d in zip(rows, origin):
                if dst != gates_torch.NO_SLOT:
                    tape[dst] = d
            peak = max(peak, live + len(written))
            live = sum(1 for s in set(tape) if s is not None and last_read.get(s, -1) > t)
        for col, src in p["tail"].tolist():
            assert stored[col] is None
            stored[col] = src if src >= 0 else stored[-src - 1]
        assert stored == [int(s) for s in slots], what
        assert p["n_slots"] == peak, (what, p["n_slots"], peak)


def test_packed_programs_fit_several_lanes_a_block(gate_program):
    """The stated steps, tape slots and block barriers of each program:
    every step within STEP_OPS ops, no more steps than levels or ops over
    STEP_OPS allow twice over, and every tape within 28 KB a lane (8 lanes
    in a block's 227 KB)."""
    name, lp = gate_program
    p = gates_torch.pack_program(lp, lp.out_slots)
    program = 8 * len(p["ops"]) + 4 * len(p["step_off"])  # staged beside the tapes in 227 KB
    most = max(1, min(32, -(-1024 // 132), (232448 - program) // (16 * p["n_slots"])))
    lanes = 1 << (most.bit_length() - 1)  # kernels.KernelLibrary.gate_plan
    got = (len(p["step_off"]) - 1, p["n_slots"], gates_torch.step_barriers(p["step_off"], lanes))
    assert got == PACKED[name]
    assert np.diff(p["step_off"]).max() <= gates_torch.STEP_OPS
    assert got[0] <= 2 * max(lp.n_levels, -(-len(p["ops"]) // gates_torch.STEP_OPS)) and 16 * got[1] <= 28 * 1024
