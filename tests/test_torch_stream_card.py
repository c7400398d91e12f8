"""The stream loops on the card: pinned staging, the copy stream, the
prefetch thread and the verdict's way back, against the same stream on the
CPU. Each batch carries its corrupt proofs in other lanes, and the stream
is longer than the two buffer sets, so a set that was refilled too early, or
a verdict read from the wrong set, changes a batch's count. Tolerance: none.

These tests need a CUDA device and nvcc; without them they skip. This file
imports no JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stream_card.py
"""

import copy
import json

import pytest
import torch

from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
from plonky2_verifier_tpu_torch.parallel.stream import BucketedStreamVerifier, StreamVerifier, template_key
from plonky2_verifier_tpu_torch.prover.prove import prove
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda
CORRUPT_AT = (1, 6, 7, 12, 17)  # of 18 proofs at batch 4: 1, 2, 0, 1 and (2 live, the pad source corrupt) 1
REJECTED_AFTER_EACH_BATCH = [1, 3, 3, 4, 5]


@pytest.fixture(scope="module")
def fib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fx = fibonacci_fixture(num_query_rounds=6)
    vkey, pwp = prove(fx)
    bad = copy.deepcopy(pwp)
    bad.proof.opening_proof.pow_witness ^= 1
    return fx.common, vkey, pwp, bad


def _items(fib, raw):
    _, vkey, pwp, bad = fib
    enc = (lambda o: json.dumps(o.to_json()).encode()) if raw else (lambda o: o)
    vk, good, bad = enc(vkey), enc(pwp), enc(bad)
    return [(vk, bad if i in CORRUPT_AT else good) for i in range(18)]


@pytest.mark.parametrize("raw", [False, True])
def test_card_stream_counts_every_batch_like_the_cpu(fib, raw):
    tpl = CircuitTemplate(fib[0])
    seen = {}
    for device in (None, "cpu"):
        sv = StreamVerifier(tpl, batch=4, raw_json=raw, ingest_workers=2, device=device)
        seen[device] = []
        m = sv.run(_items(fib, raw), on_batch=lambda mm, d=device: seen[d].append((mm.proofs, mm.rejected)))
        assert (m.proofs, m.accepted, m.rejected, m.batches) == (18, 13, 5, 5)
        # the calling thread's times never overlap, whatever the prefetch thread hides
        assert m.ingest_s + m.device_wait_s <= m.snapshot()["elapsed_s"]
        assert 0.0 < m.ingest_s <= sv.ingest_work_s + 0.05
    assert seen[None] == seen["cpu"]
    assert [r for _, r in seen[None]] == REJECTED_AFTER_EACH_BATCH


def test_card_submit_and_flush(fib):
    sv = StreamVerifier(CircuitTemplate(fib[0]), batch=4)
    items = _items(fib, False)
    for k in range(4):  # the synchronous form through both buffer sets twice
        sv.submit(items[4 * k : 4 * k + 4], 4)
    sv.flush()
    assert (sv.metrics.proofs, sv.metrics.rejected, sv.metrics.batches) == (16, 4, 4)
    assert sv.metrics.ingest_s == sv.ingest_work_s  # no prefetch: every ingest is paid
    assert sv.metrics.ingest_s + sv.metrics.device_wait_s <= sv.metrics.snapshot()["elapsed_s"]


def test_card_bucketed_stream(fib):
    common = fib[0]
    out = BucketedStreamVerifier(batch=4, raw_json=True).run([(common, vk, pf) for vk, pf in _items(fib, True)])
    m = out[template_key(common)]
    assert (m.proofs, m.accepted, m.rejected, m.batches) == (18, 13, 5, 5)
