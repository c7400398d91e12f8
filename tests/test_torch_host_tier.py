"""The port's own host tier against the JAX package's.

plonky2_verifier_tpu_torch keeps a file-for-file copy of the JAX-free
modules it needs (types, gate parser, gate programs, template, flatten,
metrics, the native C++ ingest, golden model, fixture models, prover), because it may import nothing of
plonky2_verifier_tpu. Each copy must equal its original once the package
name in import lines is normalised; and, run end to end, the port's prover
gives the same proof bytes, its flatten_proofs the same arrays, and its
golden verifier accepts the proof. Tolerance: none (bytes and integers)."""

import copy
import json
import os
import re

import numpy as np
import pytest

import plonky2_verifier_tpu as ref_pkg
import plonky2_verifier_tpu_torch as port_pkg
from plonky2_verifier_tpu.compiler import CircuitTemplate as RefTemplate
from plonky2_verifier_tpu.compiler import flatten_proofs as ref_flatten
from plonky2_verifier_tpu.golden.verifier import verify_proof as ref_verify
from plonky2_verifier_tpu.models import cache as ref_cache
from plonky2_verifier_tpu.models.fibonacci import fibonacci_fixture as ref_fixture
from plonky2_verifier_tpu.prover.prove import prove as ref_prove
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.golden.verifier import verify_proof
from plonky2_verifier_tpu_torch.models import cache
from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
from plonky2_verifier_tpu_torch.prover.prove import prove
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

COPIED = (
    ["types.py", "gate_parser.py", "gates.py", "compiler/template.py", "compiler/flatten.py", "metrics.py"]
    + ["native/__init__.py", "native/fastload.cpp"]
    + [f"golden/{m}.py" for m in ("__init__", "field", "poseidon", "poseidon_constants", "hashing", "duplex", "challenges", "plonk", "fri", "verifier")]
    + [f"models/{m}.py" for m in ("__init__", "builder", "cache", "fibonacci", "poseidon_chain", "lookup", "gate_zoo")]
    + [f"prover/{m}.py" for m in ("__init__", "fft", "merkle", "npf", "nphash", "npplonk", "prove", "witness")]
)
IMPORT_LINE = re.compile(r"^\s*(from|import)\s")


def _normalised(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [l.replace("plonky2_verifier_tpu_torch", "plonky2_verifier_tpu") if IMPORT_LINE.match(l) else l for l in lines]


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_original(rel):
    ours = os.path.join(os.path.dirname(port_pkg.__file__), rel)
    theirs = os.path.join(os.path.dirname(ref_pkg.__file__), rel)
    assert _normalised(ours) == _normalised(theirs)


def test_every_host_module_of_the_closure_is_copied():
    """A copied module's relative imports must resolve inside the port: every
    module that the original host tier holds in these folders has its copy."""
    for folder in ("golden", "models", "prover"):
        theirs = sorted(f for f in os.listdir(os.path.join(os.path.dirname(ref_pkg.__file__), folder)) if f.endswith(".py"))
        ours = sorted(f for f in os.listdir(os.path.join(os.path.dirname(port_pkg.__file__), folder)) if f.endswith(".py"))
        assert ours == theirs, folder


def test_perms_per_proof_agrees_across_packages():
    """The analytic permutation count of both metrics modules on one small
    template (chip_smoke.py holds the standard shape to its 2,774)."""
    from plonky2_verifier_tpu.metrics import perms_per_proof as ref_perms
    from plonky2_verifier_tpu_torch.metrics import perms_per_proof

    tpl = CircuitTemplate(fibonacci_fixture(num_query_rounds=6).common)
    ref_tpl = RefTemplate(ref_fixture(num_query_rounds=6).common)
    per_round = sum(-(-w // 8) for w in tpl.oracle_widths) + 4 * tpl.initial_path_len
    per_round += sum(-(-(2 << st["arity_bits"]) // 8) + st["path_len"] for st in tpl.steps)
    want = len(tpl.schedule.permutes) + -(-tpl.n_pi // 8) + 6 * per_round
    assert perms_per_proof(tpl) == ref_perms(ref_tpl) == want


def test_both_packages_share_the_fixture_cache():
    assert os.path.realpath(cache.FIXTURE_DIR) == os.path.realpath(ref_cache.FIXTURE_DIR)


@pytest.fixture(scope="module")
def proofs():
    return prove(fibonacci_fixture(num_query_rounds=6)), ref_prove(ref_fixture(num_query_rounds=6))


def test_prove_gives_the_same_proof_bytes(proofs):
    (vkey, pwp), (ref_vkey, ref_pwp) = proofs
    assert json.dumps(pwp.to_json()).encode() == json.dumps(ref_pwp.to_json()).encode()
    assert json.dumps(vkey.to_json()).encode() == json.dumps(ref_vkey.to_json()).encode()


def test_flatten_proofs_gives_the_same_arrays(proofs):
    ours, theirs = proofs
    tpl = CircuitTemplate(fibonacci_fixture(num_query_rounds=6).common)
    ref_tpl = RefTemplate(ref_fixture(num_query_rounds=6).common)
    a, b = flatten_proofs(tpl, [ours] * 2), ref_flatten(ref_tpl, [theirs] * 2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.uint64, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tpl.schedule.permutes == ref_tpl.schedule.permutes
    assert tpl.schedule.challenges == ref_tpl.schedule.challenges


def test_golden_verifier_accepts_across_packages(proofs):
    (vkey, pwp), (ref_vkey, ref_pwp) = proofs
    common = fibonacci_fixture(num_query_rounds=6).common
    assert verify_proof(common, vkey, pwp)
    assert ref_verify(ref_fixture(num_query_rounds=6).common, ref_vkey, ref_pwp)
    bad = copy.deepcopy(pwp)
    bad.public_inputs[0] ^= 1
    assert not verify_proof(common, vkey, bad)
