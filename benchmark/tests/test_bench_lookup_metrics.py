"""The readers of the lookup argument's leaf span: lookup_argument_ms and
lookup_roofline, on a report made by hand over the steady forwards alone,
the roofline's least time counted from the common data of the cell that the
run's --workload names (lookup_yardstick.py); None where the tracer recorded
no forward, and the roofline's None in a cell without lookup tables."""

from __future__ import annotations

import os
import sys

import pytest

import lookup_yardstick
import traced_report
from conftest import BENCH, ROOT, load
from run import read_metric

LEAF = "plonk: lookup argument"


def _report(ms: float, forwards: int = 4) -> dict:
    """`forwards` forwards, each with its plonk_checks span and, inside it,
    the lookup argument's leaf of `ms` (20 ms longer in the first SETTLE)."""
    raw, t = [], 0
    for k in range(1, forwards + 1):
        extra = 20e6 if k <= traced_report.SETTLE else 0
        f = len(raw)
        raw.append({"name": "forward", "parent": None, "request": k, "device_ns": [t, t + 150e6]})
        raw.append({"name": "plonk_checks", "parent": f, "request": k, "device_ns": [t + 10e6, t + 40e6]})
        raw.append({"name": LEAF, "parent": f + 1, "request": k, "device_ns": [t + 20e6, t + 20e6 + ms * 1e6 + extra]})
        t += 200e6
    return {"forwards": forwards, "syncs_per_forward": 0.0, "spans": {}, "raw": raw}


def _argv(monkeypatch, workload):
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload", workload, "--seed", "3", "--seconds", "1", "--trace", "1"])


def test_lookup_argument_ms_reads_the_leaf(monkeypatch):
    monkeypatch.setattr(traced_report, "report", lambda: _report(13.0))
    assert read_metric(BENCH, "lookup_argument_ms", {"span": None}) == pytest.approx(13.0)


def test_lookup_roofline_counts_the_cell_of_the_run(monkeypatch):
    monkeypatch.setattr(traced_report, "report", lambda: _report(13.0))
    _argv(monkeypatch, "biglut-batch-16384")
    common = load(os.path.join(BENCH, "data", "big-lut-d12", "common.json"))
    want = 100.0 * lookup_yardstick.least_seconds(common, 16384) * 1e3 / 13.0
    assert read_metric(BENCH, "lookup_roofline", {"batch": 16384}) == pytest.approx(want)
    assert 39.4 < want < 39.6  # 5.136 ms over 13 ms


def test_lookup_roofline_is_none_without_tables(monkeypatch):
    monkeypatch.setattr(traced_report, "report", lambda: _report(13.0))
    _argv(monkeypatch, "fib-batch-16384")
    assert lookup_yardstick.cell_common(sys.argv[1:], ROOT)["luts"] == []
    assert read_metric(BENCH, "lookup_roofline", {"batch": 16384}) is None


@pytest.mark.parametrize("name", ["lookup_argument_ms", "lookup_roofline"])
def test_reader_gives_none_on_an_empty_report(monkeypatch, name):
    monkeypatch.setattr(traced_report, "report", lambda: None)
    _argv(monkeypatch, "biglut-batch-16384")
    assert read_metric(BENCH, name, {"batch": 16384, "span": None}) is None
