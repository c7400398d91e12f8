"""Plonky2's test_big_lut circuit through the port on the CPU
(models/lookup.py big_lut_fixture; the benchmark's configuration big-lut-d12).

At a small size (a table of 512 rows, degree 5, 2 queries): TorchVerifier
and the benchmark's plain reference (benchmark/reference/) accept the honest
proof and reject, with eqs_ok false, a proof whose looked-up output is not the
table's and the honest proof under common data with one table word changed;
the tracer's table-work counter equals the benchmark's yardstick count there.
At the published 65,536 rows, from the committed common data and without a
verification: the padded table, its offsets and the lookup kernel's lanes;
the yardstick's count (benchmark/lookup_yardstick.py) equals the reference's
own, for big-lut-d12 and for gate-zoo-lookup-d12. The plain path's table sum
(verifier_torch.table_poly_eval) equals the Horner sum in Python ints.
Tolerance: none (verdicts, counts and field words)."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu_torch import kernels, tracing
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.golden import field as gf
from plonky2_verifier_tpu_torch.models.lookup import big_lut_fixture
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.prover.prove import prove
from plonky2_verifier_tpu_torch.types import CommonCircuitData, ProofWithPublicInputs, VerifierOnlyCircuitData
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier, lookup_tables, table_poly_eval
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import lookup_yardstick  # noqa: E402
from reference import judge  # noqa: E402
from reference import vanishing  # noqa: E402
from reference.challenger import proof_challenges  # noqa: E402
from reference.field import Ext  # noqa: E402
from reference.proof import Common, Proof  # noqa: E402

SMALL = dict(table_size=512, inputs=(51, 500), num_query_rounds=2, proof_of_work_bits=2, seed=5)
VERDICTS = ("ok", "eqs_ok", "fri_ok")


def _load(config: str, name: str):
    with open(os.path.join(BENCH, "data", config, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small():
    """The small circuit's common data (JSON), its honest proof, and a
    proof of the same circuit whose first lookup claims the table's output
    plus one: the witness changed in the LookupGate row's first output
    slot, the lookup argument's sums no longer balanced."""
    fx = big_lut_fixture(**SMALL)
    honest = prove(fx)
    lu_row = next(i for i, row in enumerate(fx.witness) if row[:2] == [51, fx.public_inputs[2]])
    fx.witness[lu_row][1] = (fx.witness[lu_row][1] + 1) % (1 << 16)
    false_output = prove(fx)
    return fx.common.to_json(), [tuple(x.to_json() for x in honest), tuple(x.to_json() for x in false_output)]


def _port(common_json, pairs, trace=False):
    """The port's verdicts on the CPU, a lane a (vkey, proof) pair, and the
    tracer's report of the forward where `trace`."""
    tpl = CircuitTemplate(CommonCircuitData.from_json(common_json))
    v = TorchVerifier(tpl, device="cpu")
    arrays = flatten_proofs(tpl, [(VerifierOnlyCircuitData.from_json(vk), ProofWithPublicInputs.from_json(p)) for vk, p in pairs])
    tracing.reset()
    if trace:
        tracing.enable()
    try:
        with torch.no_grad():
            out = v(v.prepare(arrays))
    finally:
        tracing.disable()
    rep = tracing.report()
    tracing.reset()
    return [{k: bool(out[k][i]) for k in VERDICTS} for i in range(len(pairs))], rep


def _reference(common_json, pairs):
    return [{k: judge(common_json, vk, p)[k] for k in VERDICTS} for vk, p in pairs]


def test_small_big_lut_honest_accepted_false_output_rejected(small):
    """One forward of both lanes; the reference judges each: the honest
    proof accepted, the false output rejected by its constraint equations
    alone (its FRI opening proof is sound), and the tracer's counter is the
    yardstick's padded rows x rounds x lanes."""
    common, pairs = small
    got, rep = _port(common, pairs, trace=True)
    want = [{"ok": True, "eqs_ok": True, "fri_ok": True}, {"ok": False, "eqs_ok": False, "fri_ok": True}]
    assert got == want
    assert _reference(common, pairs) == want
    assert rep["counts_per_forward"] == {tracing.LOOKUP_TABLE_ROWS: lookup_yardstick.row_rounds(common) * len(pairs)}
    assert lookup_yardstick.padded_rows(common) == 520  # 512 rows in 20 LookupTableGate rows of 26 slots


def test_small_big_lut_changed_table_word_rejected(small):
    """The honest proof under common data whose table has one output word
    changed: the final running-evaluation check fails, the transcript and
    FRI do not see it."""
    common, pairs = small
    changed = copy.deepcopy(common)
    changed["luts"][0][300][1] ^= 1
    want = [{"ok": False, "eqs_ok": False, "fri_ok": True}]
    assert _port(changed, pairs[:1])[0] == want
    assert _reference(changed, pairs[:1]) == want


def test_published_table_template_rows_offsets_and_lanes():
    """big-lut-d12's 65,536 pairs in 2,521 rows of 26 slots: 65,546 padded
    rows, the first pair repeated in the last 10; the lookup kernel's table
    lanes at their cap of 32."""
    common_json = _load("big-lut-d12", "common.json")
    common = CommonCircuitData.from_json(common_json)
    assert len(common.luts) == 1 and len(common.luts[0]) == 1 << 16
    coeffs, offsets = lookup_tables(common, "cpu")
    assert tuple(coeffs.shape) == (65546, 2) and offsets.tolist() == [0, 65546]
    assert tf.to_u64(coeffs[-10:]).tolist() == [list(common.luts[0][0])] * 10
    assert kernels.lookup_split(80, common.num_lookup_polys - 1, common.quotient_degree_factor, offsets.tolist()) == (2, 4, 32)
    assert TorchVerifier(CircuitTemplate(common), device="cpu")._lookup_lanes == (2, 4, 32)


@pytest.mark.parametrize("config", ["big-lut-d12", "gate-zoo-lookup-d12"])
def test_yardstick_count_equals_the_references_rows(config, monkeypatch):
    """lookup_yardstick.row_rounds against the degrees the reference gives
    get_lut_poly's evaluation in its constraint equations (each call
    recorded, none evaluated); at 16,384 lanes the big table's bound is
    5.14 ms."""
    common_json = _load(config, "common.json")
    degrees = []

    def record(lut, b, degree, x):
        degrees.append(degree)
        return Ext(0)

    monkeypatch.setattr(vanishing, "lut_poly_eval", record)
    proof = Proof(Common(common_json), _load(config, "vkey_0.json"), _load(config, "proof_0.json"))
    vanishing.check_constraint_equations(proof, proof_challenges(proof))
    assert sum(degrees) == lookup_yardstick.row_rounds(common_json)
    assert len(degrees) == len(common_json["luts"]) * common_json["config"]["num_challenges"]
    if config == "big-lut-d12":
        assert sum(degrees) == 2 * 65546
        assert abs(lookup_yardstick.least_seconds(common_json, 16384) - 5.1361e-3) < 1e-7
        assert lookup_yardstick.cell_common(["--workload", "biglut-batch-16384", "--seed", "1"]) == common_json
        assert lookup_yardstick.cell_common(["--workload", "no-such-cell"]) is None


@pytest.mark.parametrize("n", [1, 26, 1024, 2500])
def test_table_poly_eval_equals_the_horner_sum(n):
    """verifier_torch.table_poly_eval's blocks of powers against the Horner
    sum over the rows in Python ints, at a table shorter than a block, one
    block, and a block and a part."""
    rng = np.random.default_rng(n)
    rows = rng.integers(0, gf.P, size=(n, 2), dtype=np.uint64)
    point = rng.integers(0, gf.P, size=(2, 3), dtype=np.uint64)
    got = tf.to_u64(table_poly_eval(tf.from_u64(rows, "cpu"), tf.from_u64(point, "cpu")))
    for idx in np.ndindex(point.shape):
        for col in range(2):
            acc = 0
            for c in rows[:, col]:
                acc = (acc * int(point[idx]) + int(c)) % gf.P
            assert int(got[idx + (col,)]) == acc
