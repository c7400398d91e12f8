"""The port's stream loops against the JAX package's, on the CPU.

The streams of tests/test_stream.py (fibonacci fixtures of 4 and 8 queries,
batch 4) go through plonky2_verifier_tpu's StreamVerifier /
BucketedStreamVerifier and through the port's with device="cpu": equal
proofs, accepted, rejected and batches, per shape, and an equal order of
folded buckets. The proofs are built by the JAX package and cross into the
port through to_json / from_json. Tolerance: none (counts and booleans).
Plus what the port adds: the card by default, the synchronous form, an
error on the prefetch thread, what ingest_work_s means, and `mesh=` as a
process a device: the same streams in two gloo processes (2 x 1 and 1 x 2)
hold the one-process counts on every rank. The pinned staging runs only on
the card: tests/test_torch_stream_card.py."""

import copy
import json

import pytest
import torch

from plonky2_verifier_tpu.compiler import CircuitTemplate as RefTemplate
from plonky2_verifier_tpu.golden import field as gf
from plonky2_verifier_tpu.metrics import StreamMetrics as RefMetrics
from plonky2_verifier_tpu.models.cache import get_fixture_proof
from plonky2_verifier_tpu.parallel import BucketedStreamVerifier as RefBucketed
from plonky2_verifier_tpu.parallel import StreamVerifier as RefStream
from plonky2_verifier_tpu.parallel import template_key as ref_template_key
from plonky2_verifier_tpu_torch import types as pt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.metrics import perms_per_proof
from plonky2_verifier_tpu_torch.parallel import BucketedStreamVerifier, StreamVerifier, make_mesh, run_ranks, template_key
from plonky2_verifier_tpu_torch.tools.stream_verify import stream_rank
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

COUNTS = ("proofs", "accepted", "rejected", "batches")
MESH_TIMEOUT_S = 240  # a spawned group that takes longer is killed and fails its test alone


def _corrupt(pwp):
    bad = copy.deepcopy(pwp)
    re, im = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((re + 1) % gf.P, im)
    return bad


def _cross(common, vkey, pwp):
    """JAX-package objects -> the port's, through their JSON form."""
    return (
        pt.CommonCircuitData.from_json(common.to_json()),
        pt.VerifierOnlyCircuitData.from_json(vkey.to_json()),
        pt.ProofWithPublicInputs.from_json(pwp.to_json()),
    )


class Shape:
    """One fixture on both sides: `ref` holds the JAX package's (common,
    vkey, proof, corrupt proof), `port` the port's."""

    def __init__(self, queries):
        common, vkey, pwp = get_fixture_proof("fibonacci", num_query_rounds=queries)
        self.ref = (common, vkey, pwp, _corrupt(pwp))
        self.port = _cross(common, vkey, pwp) + (_cross(common, vkey, self.ref[3])[2],)
        self._ref_stream = None

    def ref_stream(self):
        """The JAX package's StreamVerifier at batch 4 with fresh metrics: one
        object a shape, so its verifier is traced and compiled once."""
        if self._ref_stream is None:
            self._ref_stream = RefStream(RefTemplate(self.ref[0]), batch=4)
        old = self._ref_stream.metrics
        self._ref_stream.metrics = RefMetrics(perms_per_proof=old.perms_per_proof, queries_per_proof=old.queries_per_proof)
        return self._ref_stream

    def stream(self, side, corrupt_at, n):
        _, vkey, pwp, bad = side
        return [(vkey, bad if i in corrupt_at else pwp) for i in range(n)]


@pytest.fixture(scope="module")
def fib():
    return Shape(4)


@pytest.fixture(scope="module")
def fib8():
    return Shape(8)


def _run_both(shape, corrupt_at, n, on_batch=None):
    ref = shape.ref_stream().run(shape.stream(shape.ref, corrupt_at, n))
    sv = StreamVerifier(CircuitTemplate(shape.port[0]), batch=4, device="cpu")
    m = sv.run(shape.stream(shape.port, corrupt_at, n), on_batch=on_batch)
    assert [getattr(m, k) for k in COUNTS] == [getattr(ref, k) for k in COUNTS]
    return m, sv


def test_partial_batch_padding_and_live_count(fib):
    m, _ = _run_both(fib, (), 6)  # 1 full batch + a 2-live padded batch
    assert m.proofs == 6 and m.accepted == 6 and m.rejected == 0
    assert m.batches == 2


def test_corrupted_lanes_counted(fib):
    m, _ = _run_both(fib, (1, 5, 6), 7)
    assert m.proofs == 7 and m.rejected == 3 and m.accepted == 4


def test_corrupted_pad_source_not_double_counted(fib):
    """The final partial batch pads by repeating its LAST proof; if that
    proof is corrupt, it must still count as exactly ONE rejection."""
    m, _ = _run_both(fib, (1,), 2)  # live=2, 2 pad lanes
    assert m.proofs == 2 and m.rejected == 1 and m.accepted == 1


@pytest.fixture(scope="module")
def eight(fib):
    seen = []
    m, sv = _run_both(fib, (), 8, on_batch=lambda mm: seen.append(mm.snapshot()))
    return m, sv, seen


def test_rolling_metrics_sane(fib, eight):
    m, sv, seen = eight
    assert len(seen) == 2  # one callback per folded batch
    snap = m.snapshot()
    assert snap["proofs_per_sec"] > 0
    assert snap["poseidon_perms_per_sec"] == pytest.approx(snap["proofs_per_sec"] * m.perms_per_proof, rel=0.01)
    assert snap["fri_queries_per_sec"] == pytest.approx(snap["proofs_per_sec"] * sv.tpl.num_queries, rel=0.01)
    assert m.rolling_rate() >= 0.0
    assert m.perms_per_proof == perms_per_proof(sv.tpl)


def test_ingest_device_split_reported(eight):
    """The snapshot attributes the stream's wall time as the JAX package's
    does, and the conservation law of tests/test_stream.py holds: ingest_s is
    what the calling thread paid, no more than the ingest work on both threads."""
    m, sv, _ = eight
    snap = m.snapshot()
    assert snap["ingest_s"] >= 0 and m.ingest_s > 0  # the snapshot rounds to ms: flattening 4 tiny proofs may read 0.0
    assert snap["ingest_ms_per_proof"] >= 0
    assert 0.0 <= snap["ingest_utilization"] <= 1.0
    assert snap["device_wait_s"] >= 0
    assert snap["ingest_s"] + snap["device_wait_s"] <= snap["elapsed_s"] + 0.05
    assert m.ingest_s + m.device_wait_s <= snap["elapsed_s"]  # unrounded: both are the calling thread's own time
    assert 0.0 < m.ingest_s <= sv.ingest_work_s + 0.05


def test_submit_and_flush_fold_one_batch_late(fib):
    """The synchronous form: submit folds the batch before, flush the last."""
    sv = StreamVerifier(CircuitTemplate(fib.port[0]), batch=4, device="cpu")
    group = fib.stream(fib.port, (2,), 4)
    sv.submit(group, 4)
    assert sv.metrics.batches == 0 and sv._pending is not None
    sv.submit(group, 3)  # 3 live lanes: the corrupt lane 2 among them
    assert (sv.metrics.batches, sv.metrics.proofs, sv.metrics.rejected) == (1, 4, 1)
    sv.flush()
    assert (sv.metrics.batches, sv.metrics.proofs, sv.metrics.rejected) == (2, 7, 2)
    assert sv._pending is None and sv.ingest_work_s == sv.metrics.ingest_s > 0.0  # nothing hidden: all of it paid


def test_template_key_groups_by_shape(fib, fib8):
    c4, c8 = fib.port[0], fib8.port[0]
    assert template_key(c4) == template_key(copy.deepcopy(c4))
    assert template_key(c4) != template_key(c8)
    assert template_key(c4) == ref_template_key(fib.ref[0])
    assert template_key(c8) == ref_template_key(fib8.ref[0])


def test_bucketed_mixed_shapes(fib, fib8):
    """One stream interleaving two circuit shapes: per-bucket counts and the
    order in which buckets fold equal the JAX package's."""

    def items(side4, side8):
        out = []
        for i in range(5):  # 5 of shape A
            out.append((side4[0], side4[1], side4[2]))
            if i < 3:  # 3 of shape B, one corrupt
                out.append((side8[0], side8[1], side8[3] if i == 1 else side8[2]))
        return out

    ref_folded, folded = [], []
    ref_out = RefBucketed(batch=4).run(items(fib.ref, fib8.ref), on_batch=lambda k, m: ref_folded.append(k))
    out = BucketedStreamVerifier(batch=4, device="cpu").run(items(fib.port, fib8.port), on_batch=lambda k, m: folded.append(k))
    k4, k8 = template_key(fib.port[0]), template_key(fib8.port[0])
    assert list(out) == list(ref_out) == [k4, k8]
    assert folded == ref_folded
    for k in (k4, k8):
        assert [getattr(out[k], c) for c in COUNTS] == [getattr(ref_out[k], c) for c in COUNTS]
    assert out[k4].proofs == 5 and out[k4].accepted == 5
    assert out[k8].proofs == 3 and out[k8].accepted == 2 and out[k8].rejected == 1
    assert sorted(folded.count(k) for k in (k4, k8)) == [1, 2]  # 2 batches A, 1 B


def _raw(side):
    """(vkey, proof, corrupt proof) of one side as JSON bytes for the native ingest."""
    enc = lambda o: json.dumps(o.to_json()).encode()
    return enc(side[1]), enc(side[2]), enc(side[3])


@pytest.fixture(scope="module")
def one_process_eleven(fib):
    """11 proofs at batch 4 through one process, proof 10 corrupt."""
    m = StreamVerifier(CircuitTemplate(fib.port[0]), batch=4, device="cpu").run(fib.stream(fib.port, (10,), 11))
    return [getattr(m, k) for k in COUNTS]


@pytest.mark.parametrize(
    "raw,n,corrupt,dp,qp",
    [(False, 11, 10, 2, 1), (True, 11, 10, 2, 1), (True, 9, 8, 2, 1), (False, 11, 10, 1, 2)],
    ids=["objects-2x1", "raw-2x1", "raw-2x1-a-rank-all-padding", "objects-1x2"],
)
def test_stream_over_a_mesh_counts_like_one_process(fib, one_process_eleven, raw, n, corrupt, dp, qp):
    """Two gloo processes, global batch 4: every rank reads the same items,
    verifies its own lanes (or query rounds) and holds the global counts. With
    9 proofs the last batch has one live lane, in rank 0: rank 1's share is
    all padding (copies of the corrupt proof, which must count once) and it
    still returns."""
    if raw:
        vk, good, bad = _raw(fib.port)
        items = [(vk, bad if i == corrupt else good) for i in range(n)]
    else:
        items = fib.stream(fib.port, (corrupt,), n)
    ranks = run_ranks(stream_rank, 2, (items, 4, dp, qp, raw, "cpu", fib.port[0]), threads=1, timeout_s=MESH_TIMEOUT_S)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert [r[k] for k in COUNTS] == [n, n - 1, 1, 3]
        if n == 11:
            assert [r[k] for k in COUNTS] == one_process_eleven


def test_bucketed_stream_over_a_mesh(fib, fib8):
    """Two shapes interleaved through BucketedStreamVerifier in two gloo
    processes: the per-shape counts of test_bucketed_mixed_shapes on both
    ranks, the buckets in the same order."""
    s4, s8 = fib.port, fib8.port
    items = []
    for i in range(5):
        items.append((s4[0], s4[1], s4[2]))
        if i < 3:
            items.append((s8[0], s8[1], s8[3] if i == 1 else s8[2]))
    ranks = run_ranks(stream_rank, 2, (items, 4, 2, 1, False, "cpu"), threads=1, timeout_s=MESH_TIMEOUT_S)
    k4, k8 = template_key(s4[0]), template_key(s8[0])
    for r in ranks:
        assert list(r["per_shape"]) == [k4, k8]
        assert [r["per_shape"][k4][c] for c in COUNTS] == [5, 5, 0, 2]
        assert [r["per_shape"][k8][c] for c in COUNTS] == [3, 2, 1, 1]


def test_ingest_workers_default_divides_the_cores_among_the_ranks(fib, monkeypatch):
    """Without a mesh the parser takes the host's cores; with one, the cores
    over the mesh's processes on this host (LOCAL_WORLD_SIZE, else all of
    them), at least 1; a number given is kept."""
    import os

    tpl = CircuitTemplate(fib.port[0])
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    workers = lambda **kw: StreamVerifier(tpl, 16, device="cpu", **kw).ingest_workers
    assert workers() == 8
    assert workers(mesh=make_mesh(2, 1, rank=1, world_size=2)) == 4
    assert workers(mesh=make_mesh(16, 1, rank=3, world_size=16)) == 1
    assert workers(mesh=make_mesh(2, 1, rank=1, world_size=2), ingest_workers=3) == 3
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")  # 16 ranks, four of them on this host
    assert workers(mesh=make_mesh(16, 1, rank=3, world_size=16)) == 2


@pytest.mark.parametrize("cls", [StreamVerifier, BucketedStreamVerifier])
def test_streams_default_to_the_card_and_raise_without_one(fib, cls):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    args = (CircuitTemplate(fib.port[0]), 4) if cls is StreamVerifier else (4,)
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(*args)


def test_a_failed_ingest_raises_out_of_run(fib):
    """An error on the prefetch thread (here a proof of another shape)
    reaches the caller of run(), and the batch before it is still folded by
    a later flush."""
    sv = StreamVerifier(CircuitTemplate(fib.port[0]), batch=2, device="cpu")
    good = fib.stream(fib.port, (), 2)
    with pytest.raises((AttributeError, TypeError, ValueError)):
        sv.run(good + [("not a vkey", "not a proof")])
    sv.flush()
    assert (sv.metrics.proofs, sv.metrics.accepted, sv.metrics.batches) == (2, 2, 1)


@pytest.mark.parametrize("raw", [False, True])
def test_stream_tool_sprinkles_corrupt_proofs(fib, raw):
    """tools/stream_verify.proof_stream (chip_smoke.py's traffic): every
    N-th proof has its pow_witness flipped, as objects or as JSON bytes."""
    import json

    from plonky2_verifier_tpu_torch.tools.stream_verify import proof_stream

    _, vkey, pwp, _ = fib.port
    items, expected = proof_stream(vkey, pwp, 9, 4, raw)
    items = list(items)
    assert len(items) == 9 and expected == 2
    witness = lambda p: json.loads(p)["proof"]["opening_proof"]["pow_witness"] if raw else p.proof.opening_proof.pow_witness
    good = pwp.proof.opening_proof.pow_witness
    assert [witness(p) for _, p in items] == [good ^ 1 if i in (3, 7) else good for i in range(9)]
    assert all(isinstance(vk, bytes) == raw for vk, _ in items)
    assert proof_stream(vkey, pwp, 5, 0, raw)[1] == 0
