"""The port's own host tier against the JAX package's.

plonky2_verifier_tpu_torch keeps a file-for-file copy of the JAX-free
modules it needs (types, gate parser, gate programs, template, flatten,
metrics, the native C++ ingest, golden model, fixture models, prover), because it may import nothing of
plonky2_verifier_tpu. Each copy must equal its original once the package
name in import lines is normalised, but for the port's own changes listed
in PORT_ONLY; and, run end to end, the port's prover
gives the same proof bytes, its flatten_proofs the same arrays, and its
golden verifier accepts the proof. The port's builder stops folding where
Plonky2 does, and the port follows the FRI arities of the circuit data,
which the benchmark's reference accepts at such a shape. Tolerance: none
(bytes and integers)."""

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
# Where a copy parts from its original on purpose: the top-level functions
# only the original has ("drops") and only the port has ("adds"), and the
# original's lines the port has in other words ("lines": original -> port).
# The builder's ConstantArityBits expansion stops where Plonky2's
# FriReductionStrategy::reduction_arity_bits stops, and the template, the
# prover and golden/ read the arities from fri_params, as Plonky2 does,
# where the JAX package expands the strategy; models/lookup.py adds
# Plonky2's test_big_lut circuit.
PORT_ONLY = {
    "models/lookup.py": {"adds": ["big_lut_fixture"]},
    "models/builder.py": {"lines": [
        (["        # Mirrored in golden/fri.py expand_reduction_strategy."],
         ["        # Plonky2's second stop (FriReductionStrategy::reduction_arity_bits):",
          "        # no step once logn + rate_bits - arity_bits < cap_height. The port",
          "        # reads the arities from fri_params (template, prover, golden/)."]),
        (["        while logn > self.final_poly_bits:"],
         ["        while logn > self.final_poly_bits and logn + self.rate_bits - self.arity_bits >= fri_config.cap_height:"]),
    ]},
    "compiler/template.py": {"lines": [
        (["from ..golden.fri import expand_reduction_strategy, oracle_widths"],
         ["from ..golden.fri import oracle_widths"]),
        (["        self.step_arity_bits = expand_reduction_strategy(",
          "            self.degree_bits, cfg.fri_config.reduction_strategy",
          "        )"],
         ["        self.step_arity_bits = list(common.fri_params.reduction_arity_bits)"]),
    ]},
    "prover/prove.py": {"lines": [
        (["    from ..golden.fri import expand_reduction_strategy",
          "",
          "    step_arities = expand_reduction_strategy(degree_bits, cfg.fri_config.reduction_strategy)"],
         ["    step_arities = list(common.fri_params.reduction_arity_bits)"]),
    ]},
    "golden/fri.py": {"drops": ["expand_reduction_strategy"], "lines": [
        (["from typing import List, Sequence, Tuple"], ["from typing import Sequence, Tuple"]),
        (["    step_arities = expand_reduction_strategy(common.fri_params.degree_bits, fri_config.reduction_strategy)"],
         ["    step_arities = list(common.fri_params.reduction_arity_bits)"]),
    ]},
}


def _normalised(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [l.replace("plonky2_verifier_tpu_torch", "plonky2_verifier_tpu") if IMPORT_LINE.match(l) else l for l in lines]


def _without_functions(lines, names):
    """`lines` without the top-level functions `names`: each from its `def`
    to the next line that starts at column 0 (but a signature's closing
    parenthesis), and the file's trailing blank lines."""
    out, i = [], 0
    while i < len(lines):
        if any(lines[i].startswith(f"def {n}(") for n in names):
            i += 1
            while i < len(lines) and (not lines[i] or lines[i][0].isspace() or lines[i].startswith(")")):
                i += 1
            continue
        out.append(lines[i])
        i += 1
    while out and not out[-1]:
        out.pop()
    return out


def _replaced(lines, pairs):
    """`lines` with each run `old` replaced by `new`, each run found once."""
    for old, new in pairs:
        at = [i for i in range(len(lines)) if lines[i : i + len(old)] == old]
        assert len(at) == 1, f"{old[0]!r} found {len(at)} times"
        lines = lines[: at[0]] + new + lines[at[0] + len(old) :]
    return lines


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_original(rel):
    ours = _normalised(os.path.join(os.path.dirname(port_pkg.__file__), rel))
    theirs = _normalised(os.path.join(os.path.dirname(ref_pkg.__file__), rel))
    spec = PORT_ONLY.get(rel, {})
    theirs = _replaced(_without_functions(theirs, spec.get("drops", [])), spec.get("lines", []))
    ours = _without_functions(ours, spec.get("adds", []))
    assert ours == theirs


def test_builder_stops_folding_where_plonky2_does():
    """A high cap over a low degree (cap 4, arity 3, degree 3: 3 + 3 - 3 <
    4): no fold step, where the JAX package's builder folds once; the
    port's prover and golden verifier and the benchmark's reference agree
    on the proof. The standard shape at degree 12 keeps its [4, 4]."""
    import sys

    from plonky2_verifier_tpu.models.builder import CircuitBuilder as RefBuilder
    from plonky2_verifier_tpu_torch.gate_parser import Gate
    from plonky2_verifier_tpu_torch.models.builder import CircuitBuilder

    def tiny(builder, rows, **kw):
        b = builder(num_query_rounds=2, proof_of_work_bits=2, **kw)
        for _ in range(rows):
            b.add_row(Gate("NoopGate", ()))
        b.add_row(Gate("PublicInputGate"))
        b.set_public_inputs([3])
        return b.build()

    corner = dict(cap_height=4, arity_bits=3, final_poly_bits=2)
    fx = tiny(CircuitBuilder, 5, **corner)
    assert fx.common.fri_params.degree_bits == 3 and fx.common.fri_params.reduction_arity_bits == []
    assert tiny(RefBuilder, 5, **corner).common.fri_params.reduction_arity_bits == [3]
    assert CircuitTemplate(fx.common).steps == []
    vkey, pwp = prove(fx)
    assert pwp.proof.opening_proof.commit_phase_merkle_caps == [] and verify_proof(fx.common, vkey, pwp)
    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from reference import judge

    assert judge(fx.common.to_json(), vkey.to_json(), pwp.to_json())["ok"]
    std = tiny(CircuitBuilder, 2100)  # 2,101 rows: degree 12 at the standard recursion config's cap 4, arity 4
    assert std.common.fri_params.degree_bits == 12 and std.common.fri_params.reduction_arity_bits == [4, 4]


def test_every_host_module_of_the_closure_is_copied():
    """A copied module's relative imports must resolve inside the port: every
    module that the original host tier holds in these folders has its copy."""
    for folder in ("golden", "models", "prover"):
        theirs = sorted(f for f in os.listdir(os.path.join(os.path.dirname(ref_pkg.__file__), folder)) if f.endswith(".py"))
        ours = sorted(f for f in os.listdir(os.path.join(os.path.dirname(port_pkg.__file__), folder)) if f.endswith(".py"))
        assert ours == theirs, folder


def test_perms_per_proof_agrees_across_packages():
    """The analytic permutation count of both metrics modules on one small
    template (tests/test_torch_forward_card.py holds the standard shape to its
    2,774)."""
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
