"""Shape variety through TorchVerifier on the CPU: the six points of the
shape grid (tests/test_shape_grid.py: cap_height 0/2/4 x arity_bits 1/2/3 x
final_poly_bits 0/1/2) and the fuzz circuits of tests/test_fuzz_circuits.py
at seeds 13 and 23.

Each circuit is built and proved by the JAX package (tiny_fixture,
_random_circuit, its prover) and crosses into the port through to_json /
from_json. There tools/shape_circuits.check_circuit holds it against
golden/: a batch of 2 accepted, lane 0's challenges
equal, one fault a lane (tests/shape_grid_check.py, fuzz_device_check.py)
rejected on exactly its lane. The port's own copies of those two functions
(tools/shape_circuits.py) must give the same circuits and proofs, but at the
three circuits where the port's builder stops folding as Plonky2 does: there
the same circuits but for their FRI arities, and proofs golden/ accepts. Grid point
(4, 3, 2) also goes through JaxVerifier on the same arrays: equal verdicts
and debug challenges. Tolerance: none (integers and booleans)."""

import json

import numpy as np
import pytest

from plonky2_verifier_tpu.compiler import CircuitTemplate as RefTemplate
from plonky2_verifier_tpu.compiler import flatten_proofs as ref_flatten
from plonky2_verifier_tpu.prover.prove import prove as ref_prove
from plonky2_verifier_tpu.verifier_jax import JaxVerifier
from plonky2_verifier_tpu_torch import types as pt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.golden.verifier import verify_proof
from plonky2_verifier_tpu_torch.prover.prove import prove
from plonky2_verifier_tpu_torch.tools import shape_circuits as sc
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier
from shape_grid_check import tiny_fixture
from test_fuzz_circuits import _random_circuit
from test_shape_grid import GRID
from test_torch_verifier import _debug_pairs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CIRCUITS = [("grid", pt_) for pt_ in GRID] + [("fuzz", seed) for seed in (13, 23)]
# (the port's arities, the JAX package's) where degree_bits + rate_bits -
# arity_bits falls below cap_height before the degree reaches
# final_poly_bits: Plonky2's builder stops there, the JAX package's folds on
PLONKY2_STOPS = {("grid", (4, 3, 2)): ([], [3]), ("grid", (4, 2, 0)): ([2], [2, 1]), ("fuzz", 13): ([1], [1, 1])}


def _build(kind, arg):
    """(the JAX package's fixture, the port's copy of it, the faults)."""
    if kind == "grid":
        return tiny_fixture(*arg), sc.grid_fixture(*arg), sc.GRID_FAULTS
    return _random_circuit(arg), sc.fuzz_fixture(arg), sc.FUZZ_FAULTS


def _cross(common, vkey, pwp):
    return (
        pt.CommonCircuitData.from_json(common.to_json()),
        pt.VerifierOnlyCircuitData.from_json(vkey.to_json()),
        pt.ProofWithPublicInputs.from_json(pwp.to_json()),
    )


def test_the_lists_are_the_reference_tests():
    assert sc.GRID == GRID and sc.FUZZ_SEEDS == [13, 23]


@pytest.mark.parametrize("kind,arg", CIRCUITS, ids=[f"{k}-{a}" for k, a in CIRCUITS])
def test_shape_against_golden(kind, arg, capsys):
    ref_fx, fx, faults = _build(kind, arg)
    ref_vkey, ref_pwp = ref_prove(ref_fx)
    # the port's copy and its prover give the same circuit and the same proof,
    # but where the port's builder stops folding as Plonky2 does (PLONKY2_STOPS):
    # there the same circuit but for its arities, and a proof golden/ accepts
    ours, theirs = fx.common.to_json(), ref_fx.common.to_json()
    arities = (ours["fri_params"].pop("reduction_arity_bits"), theirs["fri_params"].pop("reduction_arity_bits"))
    assert json.dumps(ours) == json.dumps(theirs)
    assert arities == PLONKY2_STOPS.get((kind, arg), (arities[1], arities[1]))
    vkey, pwp = prove(fx)
    if arities[0] == arities[1]:
        assert json.dumps(pwp.to_json()) == json.dumps(ref_pwp.to_json())
        assert json.dumps(vkey.to_json()) == json.dumps(ref_vkey.to_json())
    else:
        assert verify_proof(fx.common, vkey, pwp)

    v = sc.check_circuit(f"{kind} {arg}", *_cross(ref_fx.common, ref_vkey, ref_pwp), faults, device="cpu")
    tpl, line = v.tpl, capsys.readouterr().out
    assert "accepted, transcript equals golden, rejected" in line
    if kind == "grid":
        assert tpl.cap_len == 1 << min(arg[0], tpl.degree_bits + 3)
        rejected = ["pow_witness", "cap_w", "final_poly"] + (["step_sibs_0"] if tpl.steps[0]["path_len"] else []) + ["step_evals_0"]
    else:
        rejected = sc.FUZZ_FAULTS
    assert line.rstrip().endswith(f"rejected {rejected}")


def test_the_circuits_differ_in_shape():
    """The grid reaches distinct fold structures, cap sizes, final-poly
    lengths and path lengths (0 among them); the fuzz seeds the hard gates."""
    tpls = [RefTemplate(tiny_fixture(*p).common) for p in GRID]
    assert len({len(t.steps) for t in tpls}) >= 2
    assert len({t.final_poly_len for t in tpls}) >= 2
    assert len({t.cap_len for t in tpls}) >= 2
    assert 0 in {st["path_len"] for t in tpls for st in t.steps}
    hard = {g.kind for seed in (13, 23) for g in _random_circuit(seed).common.gates}
    assert {"PoseidonGate", "ArithmeticExtensionGate", "RandomAccessGate", "PoseidonMdsGate"} <= hard


def test_grid_point_against_jax_verifier():
    """(4, 3, 2): a step cap that covers the whole folded tree (path_len 0),
    cap 16, arity 8. The same arrays, lane 0 intact and one fault in each
    further lane, through JaxVerifier and TorchVerifier."""
    ref_fx = tiny_fixture(4, 3, 2)
    ref_proof = ref_prove(ref_fx)
    ref_tpl = RefTemplate(ref_fx.common)
    faults = [f for f in sc.GRID_FAULTS if ref_flatten(ref_tpl, [ref_proof])[f].size]
    arrays = ref_flatten(ref_tpl, [ref_proof] * (len(faults) + 1))
    for lane, fault in enumerate(faults, start=1):
        arrays[fault].reshape(len(faults) + 1, -1)[lane, 0] ^= np.uint64(1)

    jv = JaxVerifier(ref_tpl, debug=True)
    j_out = jv(jv.prepare(arrays))
    common, _, _ = _cross(ref_fx.common, *ref_proof)
    tv = TorchVerifier(CircuitTemplate(common), debug=True, device="cpu")
    t_out = tv(tv.prepare(arrays))
    for k in ("ok", "eqs_ok", "fri_ok"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]), err_msg=k)
    assert tv.to_host(t_out).tolist() == [True] + [False] * len(faults)
    assert "step_sibs_0" not in faults and "step_evals_0" in faults
    for name, ours, theirs in _debug_pairs(t_out["debug"], j_out["debug"]):
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
