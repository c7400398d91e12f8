"""Spans and a counter inside the port, on the profiler's clock.

A span is a named interval of one request: its name, its parent span, the
id of its request (a forward's running number, or a stream batch's number),
its host start and end and, for a span on the verifier's stream, its device
start and end. Spans nest as context managers (`span`); `mark` closes a leaf
of the innermost open span, begun where that span began or where its last
leaf ended. `forward` opens the span of one TorchVerifier forward.

The switch. Tracing is on while a torch.profiler runs, read once at each
forward's entry (`forward`), or from `enable()` to `disable()`. Off, a span
boundary checks one flag and does nothing else: no clock, no event, no
allocation, no synchronisation.

One clock. Host times are `time.time_ns()`, the clock kineto stamps its
events with, so a span lines up with the profiler's events as they are.
Device times come from one CUDA event per boundary (a leaf's end is the next
leaf's start), taken from a pool made on the first boundary on a card after
tracing switches on. There the card is synchronised once and an anchor event
recorded on its idle stream beside a host stamp; an event's device time is
the anchor's host time plus its elapsed time from the anchor. On the CPU a
span's device times are its host times; a span with no device (the
stream's) has none.

The counter. While tracing is on, `torch.cuda.set_sync_debug_mode("warn")`
reports every host-device synchronisation, and each one counts in the
innermost open span of the thread that made it, by site (the innermost two
frames of this package: "ops/field.py:262 < verifier_torch.py:748").

The store is module state, so it outlives the verifier that filled it:
`report()` reads it, `reset()` empties it. Nothing is written to a file.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import warnings

import torch

POOL = 512  # events made at once: ~25 boundaries a forward, ~20 forwards; past them an event is made at its boundary
SYNC_WARNING = "called a synchronizing CUDA operation"
_HERE = os.path.abspath(__file__)
_PACKAGE = os.path.dirname(_HERE)

_on = False  # the flag every boundary reads
_forced = False  # enable() holds tracing on, profiler or not
_forwards = 0  # forwards opened since reset(): the forward span's request id
_spans: list = []  # every span opened while on since reset(), in order of opening
_loose_syncs: dict = {}  # synchronisations outside any open span, by site
_pool: list = []
_anchors: dict = {}  # card index -> (anchor event, host ns)
_warnings = None  # (the catch_warnings that restores the filters and showwarning, the sync debug mode before) while on
_local = threading.local()


class Span:
    """One interval. `host_start` / `host_end` (ns) are set on every span,
    so a caller that needs its times whether or not tracing is on makes one
    itself (the stream does); it enters the store, and the rest is set, only
    where tracing was on when it opened."""

    __slots__ = ("name", "request", "device", "parent", "thread", "host_start", "host_end", "ev_start", "ev_end",
                 "dev_start", "dev_end", "syncs", "_cursor", "_traced")

    def __init__(self, name: str, request=None, device=None):
        self.name, self.request, self.device = name, request, device
        self.parent = self.thread = self.host_end = self.ev_start = self.ev_end = self.dev_start = self.dev_end = None
        self.syncs = None
        self._traced = False

    def __enter__(self):
        if not _on:
            self.host_start = time.time_ns()
            return self
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            self.request = self.parent.request if self.request is None else self.request
            self.device = self.parent.device if self.device is None else self.device
        self.thread = threading.get_ident()
        self.host_start, self.ev_start = self._cursor = _boundary(self.device)
        self._traced = True
        stack.append(self)
        _spans.append(self)
        return self

    def __exit__(self, *exc):
        if not self._traced:
            self.host_end = time.time_ns()
            return False
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.host_end, self.ev_end = _boundary(self.device)
        return False

    @property
    def host_s(self) -> float:
        return (self.host_end - self.host_start) / 1e9


_OFF = contextlib.nullcontext()  # every span while tracing is off


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _boundary(device):
    """(host ns, the event recorded on the device's current stream, or None
    where the span is not on a card)."""
    if device is None or device.type != "cuda":
        return time.time_ns(), None
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _anchors:
        _anchor(index)
    event = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    host = time.time_ns()
    event.record(torch.cuda.current_stream(index))
    return host, event


def _anchor(index: int) -> None:
    """The card's events' zero on the host clock, and the pool's events made
    (each recorded once). Only device-wide synchronisations: a profiled
    span's reader (benchmark/profiled.py) takes an event's synchronisation
    for a wait on a verdict."""
    stream = torch.cuda.current_stream(index)
    if not _pool:
        _pool.extend(torch.cuda.Event(enable_timing=True) for _ in range(POOL))
        for event in _pool:
            event.record(stream)
    torch.cuda.synchronize(index)
    anchor = torch.cuda.Event(enable_timing=True)
    before = time.time_ns()
    anchor.record(stream)  # on an idle card it completes as it is recorded
    after = time.time_ns()
    _anchors[index] = (anchor, (before + after) // 2)


def span(name: str, request=None):
    """A span under the innermost open one, its request and device by
    default; off, a shared no-op."""
    return Span(name, request) if _on else _OFF


def mark(name: str) -> None:
    """Close the leaf `name` of the innermost open span: from that span's
    start or its last leaf's end to here."""
    if not _on:
        return
    stack = _stack()
    if not stack:
        return
    parent = stack[-1]
    leaf = Span(name, parent.request, parent.device)
    leaf.parent, leaf.thread, leaf._traced = parent, parent.thread, True
    leaf.host_start, leaf.ev_start = parent._cursor
    leaf.host_end, leaf.ev_end = parent._cursor = _boundary(parent.device)
    _spans.append(leaf)


def forward(device):
    """The span of one forward on `device`, opened at its entry, where the
    switch follows the profiler (or enable())."""
    global _forwards
    want = _forced or torch._C._autograd._profiler_enabled()
    if want != _on:
        _switch(want)
    if not _on:
        return _OFF
    _forwards += 1
    return Span("forward", _forwards, device)


def enable() -> None:
    """Trace from here, profiler or not, until disable()."""
    global _forced
    _forced = True
    if not _on:
        _switch(True)


def disable() -> None:
    """Stop tracing (a forward under a running profiler starts it again)."""
    global _forced
    _forced = False
    if _on:
        _switch(False)


def _switch(on: bool) -> None:
    global _on, _warnings
    if on:
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)  # every occurrence, not once a site
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                _count_sync(filename, lineno)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _warnings = (caught, mode)
        _on = True
    else:
        _on = False
        caught, mode = _warnings
        _warnings = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)


def _count_sync(filename: str, lineno: int) -> None:
    sites, frame = [], sys._getframe(2)
    while frame is not None and len(sites) < 2:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PACKAGE) and path != _HERE:
            sites.append(f"{os.path.relpath(path, _PACKAGE)}:{frame.f_lineno}")
        frame = frame.f_back
    site = " < ".join(sites) or f"{os.path.basename(filename)}:{lineno}"
    stack = _stack()
    if stack:
        if stack[-1].syncs is None:
            stack[-1].syncs = {}
        counts = stack[-1].syncs
    else:
        counts = _loose_syncs
    counts[site] = counts.get(site, 0) + 1


def _resolve() -> None:
    """Device times of every closed span from its events, which go back to
    the pool unless a span still open holds them."""
    done = {}
    for s in _spans:
        if s.host_end is None or s.dev_start is not None or s.device is None:
            continue
        if s.ev_start is None:  # not on a card: the host's times
            s.dev_start, s.dev_end = s.host_start, s.host_end
            continue
        index = s.device.index if s.device.index is not None else torch.cuda.current_device()
        anchor, zero = _anchors[index]
        for ev in (s.ev_start, s.ev_end):
            if id(ev) not in done:
                ev.synchronize()
                done[id(ev)] = (ev, zero + round(anchor.elapsed_time(ev) * 1e6))
        s.dev_start, s.dev_end = done[id(s.ev_start)][1], done[id(s.ev_end)][1]
        s.ev_start = s.ev_end = None
    held = {id(ev) for s in _spans if s.host_end is None for ev in (s.ev_start, s._cursor[1])}
    _pool.extend(ev for key, (ev, _) in done.items() if key not in held)


def reset() -> None:
    """Forget every span, count and forward recorded."""
    global _forwards
    _spans.clear()
    _loose_syncs.clear()
    _forwards = 0


def _under_forward(s: Span) -> bool:
    while s is not None:
        if s.name == "forward":
            return True
        s = s.parent
    return False


def report() -> dict:
    """What was recorded since reset(), over its closed spans:

    - `forwards`: forward spans;
    - `spans`: by name, in order of first opening: `parent` (its parent's
      name), `count`, `host_ms` and `device_ms` summed (device None for a
      span not on the verifier's stream), and each over the forwards
      (`host_ms_a_forward`, `device_ms_a_forward`; None without a forward);
    - `syncs`: by span name ("" outside any span), {site: count};
      `syncs_per_forward`: those inside a forward span, over the forwards;
    - `raw`: every span, {name, parent (its index here), request, thread,
      host_ns: [start, end], device_ns: [start, end] or None}, to merge with
      a profiler's events."""
    _resolve()
    closed = [s for s in _spans if s.host_end is not None]
    n = sum(1 for s in closed if s.name == "forward")
    spans, syncs, in_forwards = {}, {}, 0
    for s in closed:
        e = spans.setdefault(s.name, {"parent": s.parent.name if s.parent else None, "count": 0, "host_ms": 0.0,
                                      "device_ms": None})
        e["count"] += 1
        e["host_ms"] += (s.host_end - s.host_start) / 1e6
        if s.dev_start is not None:
            e["device_ms"] = (e["device_ms"] or 0.0) + (s.dev_end - s.dev_start) / 1e6
        if s.syncs:
            by_site = syncs.setdefault(s.name, {})
            for site, k in s.syncs.items():
                by_site[site] = by_site.get(site, 0) + k
            if _under_forward(s):
                in_forwards += sum(s.syncs.values())
    if _loose_syncs:
        syncs[""] = dict(_loose_syncs)
    for e in spans.values():
        e["host_ms_a_forward"] = e["host_ms"] / n if n else None
        e["device_ms_a_forward"] = e["device_ms"] / n if n and e["device_ms"] is not None else None
    index = {id(s): i for i, s in enumerate(closed)}
    raw = [{"name": s.name, "parent": index.get(id(s.parent)), "request": s.request, "thread": s.thread,
            "host_ns": [s.host_start, s.host_end],
            "device_ns": [s.dev_start, s.dev_end] if s.dev_start is not None else None} for s in closed]
    return {"forwards": n, "spans": spans, "syncs": syncs, "syncs_per_forward": in_forwards / n if n else None, "raw": raw}
