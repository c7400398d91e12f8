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
`GateProgram.forward_plain` on random lanes with words x + p among them."""

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
from plonky2_verifier_tpu_torch.tools.check_field_kernels import golden_gate_program, words

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
    want = golden_gate_program(views, prog.lit_values, prog.k_add_off, prog.k_adds, prog.k_mul_off, prog.k_muls, prog.k_out_slots, lp.n_tape)
    assert torch.equal(got.re, want[0]) and torch.equal(got.im, want[1])
    again = prog(inputs, (B,))  # forward takes the plain loop for CPU tensors
    assert (again.re == got.re).all() and (again.im == got.im).all()

