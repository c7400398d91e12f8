"""The lookup argument and the gate zoo through the port, on the CPU.

(a) `TorchVerifier._lookup_checks` alone against the jitted
    `JaxVerifier._lookup_checks` on the same numpy inputs and against
    `golden.plonk.eval_lookup_equations`, for the lookup and multi_lookup
    fixtures; lane 1 of the batch carries a flipped lookup opening, so the two
    verifiers are also compared where the equations do not vanish. The
    padded tables are the verifier's buffers, built once with the module
    (golden/'s pad_lut rows; a call uploads nothing), and the card path
    (`verifier_torch._lookup_checks_kernel`, the kernel's own order on a
    stand-in library) gives the JAX module's words too.
(b) The whole lookup templates through `TorchVerifier(device="cpu")` and
    `verify_batch`: accepted, every challenge (the lookup deltas among them)
    equal to `golden.challenges`, and each mutated lookup opening rejected on
    its own lane. The comparison is against `golden/` alone: XLA:CPU needs
    more than ten minutes to compile `JaxVerifier` for a template whose
    lookup oracle block is not empty (docs/performance.md, "pathological
    compile"), so the JAX side is held at the module boundary in (a).
(c) The gate-zoo fixture (all 16 gate kinds and a lookup block) through the
    port against `golden/`: accepted, and a wire mutation for each gate kind
    rejected on its lane, as tests/test_gate_zoo.py does for the golden model.

4 queries, PoW 4 bits. Tolerance: none (integers mod p, bit for bit)."""

import jax
import numpy as np
import pytest

from plonky2_verifier_tpu.compiler.template import CircuitTemplate as JaxTemplate
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu.verifier_jax import JaxVerifier
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.golden import field as gf
from plonky2_verifier_tpu_torch.golden.challenges import proof_challenges
from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch import verifier_torch as vt
from plonky2_verifier_tpu_torch.golden.plonk import (
    eval_lookup_equations,
    get_selector_config,
    pad_lut,
    split_constant_columns,
)
from plonky2_verifier_tpu_torch.golden.verifier import verify_proof
from plonky2_verifier_tpu_torch.models.gate_zoo import gate_zoo_fixture
from plonky2_verifier_tpu_torch.models.lookup import lookup_fixture, multi_lookup_fixture
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops.field import GExt, to_u64
from plonky2_verifier_tpu_torch.prover.prove import prove
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier, verify_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = {"num_query_rounds": 4, "proof_of_work_bits": 4}
FIXTURES = {"lookup": lookup_fixture, "multi_lookup": multi_lookup_fixture}
N_LOOKUP_ZS = 14  # both lookup fixtures: 2 rounds x (1 RE + 6 SLDC)
# the wire that carries each custom gate's output in the zoo (models/gate_zoo.py)
ZOO_WIRES = {
    "RandomAccess output": 1,
    "Reducing output": 0,
    "CosetInterpolation eval": 35,
    "PoseidonMds output": 24,
    "BaseSum sum": 0,
    "Exponentiation out": 9,
}


@pytest.fixture(scope="module", params=list(FIXTURES))
def proved(request):
    fx = FIXTURES[request.param](**SMALL)
    vkey, pwp = prove(fx)
    return fx.common, vkey, pwp


def _lookup_zs_offset(tpl) -> int:
    return tpl.n_const_cols + tpl.n_sigmas + tpl.num_wires + tpl.n_zs + tpl.n_pp + tpl.n_quot


# -- (a) the module alone -------------------------------------------------------


@pytest.fixture(scope="module")
def module_inputs(proved):
    """The inputs of `_lookup_checks` as numpy arrays, batch 3: lane 0 the
    proof's openings, lane 1 with lookup_zs[0].re flipped, lane 2 lane 0."""
    common, vkey, pwp = proved
    ch = proof_challenges(common, vkey, pwp)
    op = pwp.proof.openings
    _, lkp_sels, _ = split_constant_columns(get_selector_config(common), op.constants)
    B = 3

    def ext(rows):
        return np.array(rows, dtype=np.uint64).reshape(1, -1, 2).repeat(B, axis=0)

    arrays = {k: ext(v) for k, v in [("lkp_sels", lkp_sels), ("wires", op.wires), ("lookup_zs", op.lookup_zs), ("lookup_zs_next", op.lookup_zs_next)]}
    arrays["lookup_zs"][1, 0, 0] ^= np.uint64(1)
    deltas = [[np.full((B,), x, dtype=np.uint64) for x in (d.a, d.b, d.alpha, d.delta)] for d in ch.deltas]
    want = eval_lookup_equations(common, lkp_sels, op, ch)
    return common, arrays, deltas, want


def _port_inputs(arrays, deltas):
    t_ext = {k: GExt(tf.from_u64(a[..., 0], "cpu"), tf.from_u64(a[..., 1], "cpu")) for k, a in arrays.items()}
    t_deltas = [tuple(tf.from_u64(x, "cpu") for x in d) for d in deltas]
    return [t_ext["lkp_sels"], t_ext["wires"], t_ext["lookup_zs"], t_ext["lookup_zs_next"], t_deltas]


@pytest.fixture(scope="module")
def module_outputs(module_inputs):
    common, arrays, deltas, _ = module_inputs
    tv = TorchVerifier(CircuitTemplate(common), device="cpu")
    got = tv._lookup_checks(*_port_inputs(arrays, deltas))

    jv = JaxVerifier(JaxTemplate(common))
    j_ext = {k: jf.ext_from_u64(a[..., 0], a[..., 1]) for k, a in arrays.items()}
    j_deltas = [tuple(jf.from_u64(x) for x in d) for d in deltas]
    ref = jax.jit(jv._lookup_checks)(j_ext["lkp_sels"], j_ext["wires"], j_ext["lookup_zs"], j_ext["lookup_zs_next"], j_deltas)
    ref_re, ref_im = (np.asarray(x) for x in jf.ext_to_u64(ref))
    return (to_u64(got.re), to_u64(got.im)), (ref_re, ref_im)


def test_lookup_checks_equal_jax_module(module_outputs):
    (got_re, got_im), (ref_re, ref_im) = module_outputs
    np.testing.assert_array_equal(got_re, ref_re)
    np.testing.assert_array_equal(got_im, ref_im)


def test_lookup_checks_equal_golden_equations(module_inputs, module_outputs):
    _, _, _, want = module_inputs
    (got_re, got_im), _ = module_outputs
    for lane in (0, 2):
        got = [(int(r), int(i)) for r, i in zip(got_re[lane], got_im[lane])]
        assert got == [tuple(w) for w in want]


def test_lookup_checks_see_a_flipped_opening(module_outputs):
    (got_re, _), _ = module_outputs
    assert not np.array_equal(got_re[1], got_re[0])


def test_lookup_tables_are_buffers_built_once(module_inputs, module_outputs, monkeypatch):
    """The padded tables are buffers of the verifier (golden/'s pad_lut rows,
    one table after the other), and a call of _lookup_checks uploads
    nothing: with tf.from_u64 refused it gives the JAX module's words."""
    common, arrays, deltas, _ = module_inputs
    tv = TorchVerifier(CircuitTemplate(common), device="cpu")
    num_lut = common.config.num_routed_wires // 3
    rows = [list(row) for t in common.luts for row in pad_lut(t, -(-len(t) // num_lut) * num_lut)]
    assert to_u64(tv._lut_coeffs).tolist() == rows
    assert {"_lut_coeffs", "_lut_off"} <= dict(tv.named_buffers()).keys()
    inputs = _port_inputs(arrays, deltas)

    def refuse(*a, **kw):
        raise AssertionError("the lookup argument uploaded a table")

    monkeypatch.setattr(tf, "from_u64", refuse)
    got = tv._lookup_checks(*inputs)
    _, (ref_re, ref_im) = module_outputs
    np.testing.assert_array_equal(to_u64(got.re), ref_re)
    np.testing.assert_array_equal(to_u64(got.im), ref_im)


def test_lookup_card_path_equals_jax_module(module_inputs, module_outputs, monkeypatch):
    """The card path with the kernel's own order in PyTorch standing in for
    the library (the running leave-one-out pair, a thread's Horner chains):
    the JAX module's words."""
    from plonky2_verifier_tpu_torch.tools.check_hash_kernels import PlainLibrary

    common, arrays, deltas, _ = module_inputs
    tv = TorchVerifier(CircuitTemplate(common), device="cpu")
    lib = PlainLibrary(None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    got = vt._lookup_checks_kernel(*_port_inputs(arrays, deltas), tv._lut_coeffs, tv._lut_off, common.config.num_routed_wires,
                                   common.quotient_degree_factor)
    _, (ref_re, ref_im) = module_outputs
    np.testing.assert_array_equal(to_u64(got.re), ref_re)
    np.testing.assert_array_equal(to_u64(got.im), ref_im)
    assert lib.launches["lookup_checks"] == 1


# -- (b) the whole lookup templates ---------------------------------------------


@pytest.fixture(scope="module")
def template_run(proved):
    """Lane 0 intact, then one lane for each lookup opening with its real
    part flipped, through verify_batch on the CPU."""
    common, vkey, pwp = proved
    tpl = CircuitTemplate(common)
    assert tpl.n_lookup == N_LOOKUP_ZS
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * (1 + N_LOOKUP_ZS))
    first = _lookup_zs_offset(tpl)
    for i in range(N_LOOKUP_ZS):
        arrays["openings1"][1 + i, first + i, 0] ^= np.uint64(1)
    return common, vkey, pwp, verify_batch(tpl, arrays, debug=True, device="cpu")


def test_lookup_template_accepted(template_run):
    common, vkey, pwp, out = template_run
    assert verify_proof(common, vkey, pwp)
    assert bool(out["ok"][0]) and bool(out["eqs_ok"][0]) and bool(out["fri_ok"][0])


def test_lookup_template_challenges_equal_golden(template_run):
    common, vkey, pwp, out = template_run
    ch = proof_challenges(common, vkey, pwp)
    dbg = out["debug"]
    assert [int(b[0]) for b in dbg["betas"]] == ch.betas
    assert [int(g[0]) for g in dbg["gammas"]] == ch.gammas
    assert [int(a[0]) for a in dbg["alphas"]] == ch.alphas
    assert [tuple(int(x[0]) for x in d) for d in dbg["deltas"]] == [(d.a, d.b, d.alpha, d.delta) for d in ch.deltas]
    assert (int(dbg["zeta"][0][0]), int(dbg["zeta"][1][0])) == tuple(ch.zeta)
    assert (int(dbg["fri_alpha"][0][0]), int(dbg["fri_alpha"][1][0])) == tuple(ch.fri.alpha)
    assert int(dbg["pow_response"][0]) == ch.fri.pow_response
    assert [int(q) for q in dbg["query_indices"][0]] == ch.fri.query_indices


@pytest.mark.parametrize("i", range(N_LOOKUP_ZS))
def test_mutated_lookup_opening_rejected_on_its_lane(template_run, i):
    _, _, _, out = template_run
    assert not bool(out["eqs_ok"][1 + i]), f"mutated lookup_zs[{i}] passed the Plonk checks"
    assert not bool(out["ok"][1 + i])


def test_torch_verifier_module_takes_lookup_template(proved):
    """The module form (tensors in, tensors out), batch 2, no debug."""
    common, vkey, pwp = proved
    tpl = CircuitTemplate(common)
    v = TorchVerifier(tpl, device="cpu")
    out = v(v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * 2)))
    assert out["ok"].tolist() == [True, True]
    assert "debug" not in out


# -- (c) the gate zoo -------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo_run():
    """Lane 0 intact; one lane a gate kind with that gate's output wire
    opening changed (+1 mod p, as tests/test_gate_zoo.py); one lane with a
    lookup opening flipped; the last lane intact again."""
    fx = gate_zoo_fixture(**SMALL)
    vkey, pwp = prove(fx)
    tpl = CircuitTemplate(fx.common)
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * (len(ZOO_WIRES) + 3))
    wires_at = tpl.n_const_cols + tpl.n_sigmas
    for lane, wire in enumerate(ZOO_WIRES.values(), start=1):
        cell = arrays["openings1"][lane, wires_at + wire]
        cell[0] = np.uint64((int(cell[0]) + 1) % gf.P)
    arrays["openings1"][len(ZOO_WIRES) + 1, _lookup_zs_offset(tpl), 0] ^= np.uint64(1)
    return fx, vkey, pwp, tpl, verify_batch(tpl, arrays, debug=True, device="cpu")


def test_zoo_has_every_gate_kind_and_lookups(zoo_run):
    fx, _, _, tpl, _ = zoo_run
    assert len({g.kind for g in fx.common.gates}) == 16
    assert tpl.n_lookup > 0 and fx.common.num_lookup_polys > 0


def test_zoo_accepted_as_golden_accepts(zoo_run):
    fx, vkey, pwp, _, out = zoo_run
    assert verify_proof(fx.common, vkey, pwp)
    for lane in (0, len(ZOO_WIRES) + 2):
        assert bool(out["ok"][lane]) and bool(out["eqs_ok"][lane]) and bool(out["fri_ok"][lane])


def test_zoo_transcript_equals_golden(zoo_run):
    fx, vkey, pwp, _, out = zoo_run
    ch = proof_challenges(fx.common, vkey, pwp)
    dbg = out["debug"]
    assert (int(dbg["zeta"][0][0]), int(dbg["zeta"][1][0])) == tuple(ch.zeta)
    assert [int(a[0]) for a in dbg["alphas"]] == ch.alphas
    assert [tuple(int(x[0]) for x in d) for d in dbg["deltas"]] == [(d.a, d.b, d.alpha, d.delta) for d in ch.deltas]
    assert [int(q) for q in dbg["query_indices"][0]] == ch.fri.query_indices


@pytest.mark.parametrize("lane,name", list(enumerate(ZOO_WIRES, start=1)), ids=list(ZOO_WIRES))
def test_zoo_wire_mutation_rejected(zoo_run, lane, name):
    _, _, _, _, out = zoo_run
    assert not bool(out["eqs_ok"][lane]), f"{name} mutation passed the Plonk checks"
    assert not bool(out["ok"][lane])


def test_zoo_lookup_mutation_rejected(zoo_run):
    _, _, _, _, out = zoo_run
    assert not bool(out["ok"][len(ZOO_WIRES) + 1])
