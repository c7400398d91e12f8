"""The port's tracer (plonky2_verifier_tpu_torch/tracing.py) and the spans of
TorchVerifier.forward and the stream.

On the CPU: spans nest, with their parents and their forward's id; the three
stage spans tile "forward"; tracing off records nothing and changes no
output bit; the switch follows torch.profiler; report()'s arithmetic on a
trace made by hand; the stream's rule for the ingest its caller paid.

On the card (marked `cuda`, skipped without one): one clock, the profiler's
launches and device operations of a forward inside the tracer's spans of it
to +-50 us; the tracer records under a profiler of CUDA activity alone; a
planted `.item()` counts one synchronisation in its span. This file imports
no JAX, so on a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plonky2_verifier_tpu_torch import tracing
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
from plonky2_verifier_tpu_torch.parallel.stream import paid_ns
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STAGES = ["challenges", "plonk_checks", "fri_checks"]
LEAVES = {"challenges": ["pi hash", "transcript", "powers and inverses"],
          "plonk_checks": ["plonk: L0 and partial products", "plonk: selectors and gate program", "plonk: lookup argument",
                           "plonk: alpha combination and quotient"],
          "fri_checks": ["fri: proof of work and reduced openings", "fri: leaf hashes", "fri: initial Merkle walks",
                         "fri: combineInitial", "fri: final polynomial"]}  # the 6-query fibonacci template has no fold step
SLACK_NS = 50_000


@pytest.fixture(autouse=True)
def untraced():
    """Each test starts and ends with tracing off and the store empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _verifier(device):
    common, vkey, pwp = get_fixture_proof("fibonacci", num_query_rounds=6)
    tpl = CircuitTemplate(common)
    v = TorchVerifier(tpl, device=device)
    return v, v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * 2))


@pytest.fixture(scope="module")
def cpu_verifier():
    return _verifier("cpu")


@pytest.fixture(scope="module")
def card_verifier():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _verifier(None)


def _call(v, dev):
    with torch.no_grad():
        return v(dev)


def _children(raw, parent):
    return [s for s in raw if s["parent"] == parent]


def test_spans_nest_with_their_parents_and_forward_ids(cpu_verifier):
    v, dev = cpu_verifier
    tracing.enable()
    _call(v, dev)
    _call(v, dev)
    tracing.disable()
    rep = tracing.report()
    raw = rep["raw"]
    forwards = [i for i, s in enumerate(raw) if s["name"] == "forward"]
    assert rep["forwards"] == 2 and [raw[i]["request"] for i in forwards] == [1, 2]
    for i in forwards:
        assert raw[i]["parent"] is None
        stages = _children(raw, i)
        assert [s["name"] for s in stages] == STAGES
        for s in stages:
            j = raw.index(s)
            assert [c["name"] for c in _children(raw, j)] == LEAVES[s["name"]]
            assert {c["request"] for c in _children(raw, j)} == {s["request"]} == {raw[i]["request"]}
    assert rep["spans"]["plonk: lookup argument"]["parent"] == "plonk_checks" and rep["spans"]["forward"]["count"] == 2
    assert rep["syncs"] == {} and rep["syncs_per_forward"] == 0  # the CPU never synchronises


def test_the_three_stage_spans_tile_the_forward(cpu_verifier):
    v, dev = cpu_verifier
    tracing.enable()
    _call(v, dev)
    tracing.disable()
    raw = tracing.report()["raw"]
    i = next(k for k, s in enumerate(raw) if s["name"] == "forward")
    f0, f1 = raw[i]["host_ns"]
    stages = _children(raw, i)
    assert f0 <= stages[0]["host_ns"][0]
    for a, b in zip(stages, stages[1:]):
        assert a["host_ns"][1] <= b["host_ns"][0]
    assert stages[-1]["host_ns"][1] <= f1
    covered = sum(s["host_ns"][1] - s["host_ns"][0] for s in stages)
    assert covered >= 0.98 * (f1 - f0)
    for s in stages:  # the leaves tile their stage from its start to the last mark
        leaves = _children(raw, raw.index(s))
        assert leaves[0]["host_ns"][0] == s["host_ns"][0] and leaves[-1]["host_ns"][1] <= s["host_ns"][1]
        assert all(a["host_ns"][1] == b["host_ns"][0] for a, b in zip(leaves, leaves[1:]))
        assert s["device_ns"] == s["host_ns"]  # on the CPU the device times are the host's


def test_tracing_off_records_nothing_and_changes_no_bit(cpu_verifier):
    v, dev = cpu_verifier
    off = _call(v, dev)
    assert tracing.report()["forwards"] == 0 and tracing.report()["raw"] == []
    tracing.enable()
    on = _call(v, dev)
    tracing.disable()
    assert tracing.report()["forwards"] == 1
    assert sorted(off) == sorted(on) and all(torch.equal(off[k], on[k]) for k in off)
    assert tracing.span("x") is tracing.span("y")  # off: one shared no-op, nothing made


def test_the_switch_follows_the_profiler(cpu_verifier):
    v, dev = cpu_verifier
    _call(v, dev)
    with profile(activities=[ProfilerActivity.CPU]):
        _call(v, dev)
        assert tracing._on
    _call(v, dev)
    assert not tracing._on
    rep = tracing.report()
    assert rep["forwards"] == 1 and [s["request"] for s in rep["raw"] if s["name"] == "forward"] == [1]


def _span(name, parent, start, end, syncs=None):
    s = tracing.Span(name, request=1, device=torch.device("cpu"))
    s.parent, s.host_start, s.host_end, s.syncs = parent, start, end, syncs
    tracing._spans.append(s)
    return s


def test_report_arithmetic_on_a_trace_made_by_hand():
    for k in range(2):
        t = k * 10_000_000
        f = _span("forward", None, t, t + 8_000_000)
        c = _span("challenges", f, t, t + 2_000_000)
        _span("pi hash", c, t, t + 500_000)
        _span("plonk_checks", f, t + 2_000_000, t + 5_000_000, {"ops/field.py:262 < verifier_torch.py:746": 2})
        _span("fri_checks", f, t + 5_000_000, t + 8_000_000)
    s = tracing.Span("stream.ingest", request=0)
    s.host_start, s.host_end, s.syncs = 0, 4_000_000, {"x.py:1": 1}
    tracing._spans.append(s)
    rep = tracing.report()
    assert rep["forwards"] == 2
    spans = rep["spans"]
    assert list(spans) == ["forward", "challenges", "pi hash", "plonk_checks", "fri_checks", "stream.ingest"]
    assert spans["plonk_checks"] == {"parent": "forward", "count": 2, "host_ms": 6.0, "device_ms": 6.0, "host_ms_a_forward": 3.0,
                                     "device_ms_a_forward": 3.0}
    assert spans["pi hash"]["parent"] == "challenges" and spans["pi hash"]["device_ms_a_forward"] == 0.5
    assert spans["forward"]["device_ms_a_forward"] == 8.0
    assert spans["stream.ingest"]["device_ms"] is None and spans["stream.ingest"]["host_ms"] == 4.0
    assert rep["syncs"] == {"plonk_checks": {"ops/field.py:262 < verifier_torch.py:746": 4}, "stream.ingest": {"x.py:1": 1}}
    assert rep["syncs_per_forward"] == 2.0  # the stream's is outside every forward
    assert rep["raw"][1]["parent"] == 0 and rep["raw"][2]["parent"] == 1


@pytest.mark.parametrize("waited, paid", [
    ((100, 400), 300),  # the prefetch ran inside the wait: all of it paid
    ((150, 250), 100),  # the caller came late and left early
    ((50, 450), 300),  # the caller waited before the thread began and after it ended: only the span counts
    ((0, 90), 0),  # the wait ended before the span began
    (None, 300),  # submit(): the caller made the batch itself
])
def test_the_stream_pays_the_part_of_its_ingest_that_its_wait_overlaps(waited, paid):
    span = tracing.Span("stream.ingest", 0)
    span.host_start, span.host_end = 100, 400
    assert paid_ns(span, waited) == paid


@pytest.mark.cuda
def test_card_one_clock_kineto_events_fall_inside_the_tracers_spans(card_verifier):
    from torch.autograd import DeviceType

    v, dev = card_verifier
    _call(v, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _call(v, dev)
        torch.cuda.synchronize()
    rep = tracing.report()
    f = next(s for s in rep["raw"] if s["name"] == "forward")
    (h0, h1), (d0, d1) = f["host_ns"], f["device_ns"]
    launches = [ev.start_ns() for ev in prof.profiler.kineto_results.events() if ev.name() == "cudaLaunchKernel"]
    ops = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CUDA]
    assert launches and ops
    assert all(h0 - SLACK_NS <= t <= h1 + SLACK_NS for t in launches), (h0, h1, min(launches), max(launches))
    assert all(d0 - SLACK_NS <= a and b <= d1 + SLACK_NS for a, b in ops), (d0, d1, min(ops), max(ops))


@pytest.mark.cuda
def test_card_the_tracer_records_under_a_profiler_of_cuda_alone(card_verifier):
    v, dev = card_verifier
    with profile(activities=[ProfilerActivity.CUDA]):
        _call(v, dev)
        _call(v, dev)
        torch.cuda.synchronize()
    rep = tracing.report()
    assert rep["forwards"] == 2
    assert all(rep["spans"][name]["device_ms"] > 0 for name in ["forward"] + STAGES)
    assert sum(rep["spans"][name]["device_ms"] for name in STAGES) >= 0.98 * rep["spans"]["forward"]["device_ms"]


@pytest.mark.cuda
def test_card_a_planted_item_counts_one_synchronisation_in_its_span(card_verifier):
    x = torch.ones(4, device="cuda")
    tracing.enable()
    with tracing.forward(x.device), tracing.span("planted"):
        x.sum().item()
    with tracing.forward(x.device), tracing.span("clean"):
        x.sum()
    tracing.disable()
    rep = tracing.report()
    assert sum(rep["syncs"]["planted"].values()) == 1 and "clean" not in rep["syncs"]
    assert rep["syncs_per_forward"] == 0.5
