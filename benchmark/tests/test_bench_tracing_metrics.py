"""The readers of the program's tracer (traced_report.py and the metrics
challenges_ms, plonk_checks_ms, fri_checks_ms, forward_idle_ms and
syncs_per_forward): each reads its number from a report made by hand, over
the steady forwards alone, and gives None where the tracer recorded no
forward or the program has none."""

from __future__ import annotations

import sys

import pytest

import traced_report
from conftest import BENCH
from run import read_metric

STEADY = {"forward": 130.0, "challenges": 7.5, "plonk_checks": 14.0, "fri_checks": 108.0}  # ms a forward


def _report(forwards: int = 4) -> dict:
    """`forwards` forwards one after another, the first SETTLE of them 20 ms
    longer in each span (from an idle card), each span inside the one before
    in STEADY's order, and a stream span around them all."""
    raw, t = [{"name": "stream.dispatch", "parent": None, "request": 0, "device_ns": None}], 0
    for k in range(1, forwards + 1):
        extra = 20e6 if k <= traced_report.SETTLE else 0
        f = len(raw)
        for name, ms in STEADY.items():
            raw.append({"name": name, "parent": 0 if name == "forward" else f, "request": k,
                        "device_ns": [t, t + ms * 1e6 + extra]})
        t += 200e6
    return {"forwards": forwards, "syncs_per_forward": 2.0, "spans": {}, "raw": raw}


OBS = {"span": {"busy_s_a_forward": 0.1165}}
WANT = {"challenges_ms": 7.5, "plonk_checks_ms": 14.0, "fri_checks_ms": 108.0, "forward_idle_ms": 130.0 - 116.5,
        "syncs_per_forward": 2.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_report_made_by_hand(monkeypatch, name):
    monkeypatch.setattr(traced_report, "report", _report)
    assert read_metric(BENCH, name, OBS) == pytest.approx(WANT[name])


def test_with_no_more_forwards_than_settle_every_forward_counts(monkeypatch):
    monkeypatch.setattr(traced_report, "report", lambda: _report(traced_report.SETTLE))
    assert traced_report.device_ms("challenges") == pytest.approx(27.5)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_on_an_empty_report(name):
    from plonky2_verifier_tpu_torch import tracing

    tracing.reset()
    assert traced_report.report() is None  # no forward recorded, as off the card
    assert read_metric(BENCH, name, {"span": None}) is None


def test_report_is_none_for_a_program_without_the_tracer(monkeypatch):
    import plonky2_verifier_tpu_torch

    monkeypatch.setitem(sys.modules, "plonky2_verifier_tpu_torch.tracing", None)  # its import then fails
    monkeypatch.delattr(plonky2_verifier_tpu_torch, "tracing", raising=False)
    assert traced_report.report() is None
    assert read_metric(BENCH, "syncs_per_forward", OBS) is None
