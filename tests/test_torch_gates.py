"""The port's levelizer copy and gate executor against the JAX package.

`levelize.levelize_gates` must give arrays identical to
`gates_jax.levelize_gates`; no real op may read the trash slot 0 (dummy
ops all write it, in no defined order on CUDA); `run_levelized` on random
inputs made with numpy must equal the JAX executor bit for bit."""

import numpy as np
import pytest

from plonky2_verifier_tpu.compiler import CircuitTemplate
from plonky2_verifier_tpu.compiler import gates_jax
from plonky2_verifier_tpu.gates import CONST, LKPSEL, PI, SEL, WIRE
from plonky2_verifier_tpu.golden import field as gf
from plonky2_verifier_tpu.models.fibonacci import fibonacci_fixture
from plonky2_verifier_tpu.models.poseidon_chain import poseidon_chain_fixture
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu_torch.compiler import gates_torch, levelize
from plonky2_verifier_tpu_torch.ops import field as tf

ARRAYS = ("lit_values", "add_src1", "add_src2", "add_sign", "add_dst", "mul_src1", "mul_src2", "mul_dst", "out_slots")
FIXTURES = {
    "fibonacci": lambda: fibonacci_fixture(num_query_rounds=2),
    "poseidon_chain": lambda: poseidon_chain_fixture(n_chain=2, num_query_rounds=2),
}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def programs(request):
    tpl = CircuitTemplate(FIXTURES[request.param]().common)
    args = (tuple(tpl.common.gates), tpl.n_gate_selectors, tpl.n_lookup_selectors, tpl.n_gate_constants, tpl.num_wires)
    return levelize.levelize_gates(*args), gates_jax.levelize_gates(*args)


def test_levelize_copy_is_identical(programs):
    ours, ref = programs
    for name in ARRAYS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ours.n_tape, ours.n_levels, ours.input_slots) == (ref.n_tape, ref.n_levels, ref.input_slots)
    assert len(ours.out_slots_per_prog) == len(ref.out_slots_per_prog)
    for a, b in zip(ours.out_slots_per_prog, ref.out_slots_per_prog):
        np.testing.assert_array_equal(a, b)


def test_no_real_op_reads_trash_slot(programs):
    lp, _ = programs
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
