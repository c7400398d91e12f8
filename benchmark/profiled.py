"""A traced span of the closed loop under torch.profiler, after the window,
reduced to what the per-layer metrics read: launches, the host's dispatch
time a forward (the harness's clock from a batch's dispatch to the return of
its enqueue, less the time spent inside CUDA runtime and driver calls, where
the host waits on the card: a synchronisation, a copy to the host, a launch
into a full queue), the device's busy time (the union of its kernel, copy and set
intervals) a forward and over the span's steady part, that part's length,
and the breakdown: the device operations that took most time and the
longest idle gaps, each named by the operation that ended it.

Only CUDA activity is recorded (the device's operations and the runtime calls
that launch them): with host operators too the profiler books each kernel a
second time and its bookkeeping of ~10^5 events takes minutes. The events
are read raw from the profiler's results, without key_averages().
"""

from __future__ import annotations

import re

TOP = 10


def short_name(name: str) -> str:
    """A device operation's name without its template arguments, parameters
    and namespaces, in the characters a metric name allows."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1]
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name.strip())[:64] or "unnamed"


def _union(intervals) -> float:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


# runtime calls the harness makes outside a batch's enqueue: the verdict wait
# and the synchronisation that ends the span
OUTSIDE_ENQUEUE = ("cudaEventSynchronize", "cudaDeviceSynchronize")


def summarize(events, forwards: int, enqueue_s: float = 0.0, settle: int = 2) -> dict:
    """`events`: (name, is_device, start_ns, duration_ns) of a span of
    `forwards` batches of the loop. Launches and busy time a forward are
    taken over the whole span. The idle share is taken over its steady part:
    from the `settle`-th verdict wait's end (cudaEventSynchronize; the
    batches before it start from an idle card) to the last one's.
    `enqueue_s`: the span's batches' time from dispatch to enqueued, summed
    (the harness's clock)."""
    launches, device, by_op, waits, runtime = 0, [], {}, [], 0
    for name, on_device, start, dur in events:
        if on_device:
            device.append((start, start + dur, name))
            by_op[short_name(name)] = by_op.get(short_name(name), 0) + dur
        elif name == "cudaLaunchKernel":
            launches += 1
        if not on_device and name.startswith("cu") and name not in OUTSIDE_ENQUEUE:
            runtime += dur
        if name == "cudaEventSynchronize":
            waits.append(start + dur)
    if not device:
        return None
    device.sort()
    waits.sort()
    t0, t1 = (waits[settle - 1], waits[-1]) if len(waits) > settle else (device[0][0], max(e for _, e, _ in device))
    gaps, end = {}, None
    for s, e, name in device:
        if end is not None and s > end and t0 <= end and s <= t1:
            key = f"before_{short_name(name)}"
            gaps[key] = gaps.get(key, 0) + (min(s, t1) - end)
        end = e if end is None else max(end, e)
    return {
        "forwards": forwards,
        "launches": launches,
        "runtime_s_a_forward": runtime / 1e9 / forwards,
        "dispatch_s_a_forward": (enqueue_s - runtime / 1e9) / forwards,
        "busy_s_a_forward": _union((s, e) for s, e, _ in device) / 1e9 / forwards,
        "busy_s": _union((max(s, t0), min(e, t1)) for s, e, _ in device if e > t0 and s < t1) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "breakdown": {
            "device_ops": [[k, v / 1e9] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[k, v / 1e9] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def traced_span(program, batches: int) -> dict:
    """`batches` batches of the closed loop under the profiler; None off the
    card."""
    if not program.on_card:
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    program.sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        records = program.loop(batches=batches)
        program.sync()
    events = [(ev.name(), ev.device_type() == DeviceType.CUDA, ev.start_ns(), ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()]
    return summarize(events, batches, sum(r["enqueued"] - r["due"] for r in records))
