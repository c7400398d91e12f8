"""Where one verifier call spends its time: the one tool for what
tools/profile_stages.py, profile_split.py, profile_verifier.py and
profile_compile.py answer about the JAX package.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.profile_verifier
      [--model fibonacci|gate_zoo|fibonacci6] [--proofs DIR] [--batch N]
      [--in-flight N] [--device cpu]

On the template given (fibonacci: the standard shape; gate_zoo: the gate zoo
with lookups at the same degree, queries and PoW; fibonacci6: the 6-query
fixture, for --device cpu), or on the proofs of a directory (--proofs:
common.json, vkey_<i>.json, proof_<i>.json, as benchmark/data/<config>/ holds
them), and a batch of copies of its proofs (each flattened once, the lanes
gathered on the device):

(a) stage times from the tracer's spans of one call (tracing.py; device ms,
    and no synchronise but the call's end): the public-input hash, the
    transcript, the powers and inverses (the span "challenges"), the Plonk
    checks in four parts (L0 and the partial products, the gate program, the
    lookup argument, the alpha combination with the quotient; the span
    "plonk_checks"), FRI in its parts (proof of work and reduced openings,
    leaf hashes, initial Merkle walks, combineInitial, the coset folds of
    every step in one stage -- one kernel launch on the card -- then each
    fold step's Merkle walk and opened slot, the final polynomial; the span
    "fri_checks"). The stages add up to the staged call, the span "forward";
(b) under torch.profiler, on the card, `calls` calls with `in_flight` of them
    enqueued (the next enqueued before the wait for a verdict, as
    benchmark/program.py runs them): `cudaLaunchKernel` calls a forward, the
    launches and device time of each of the port's own kernels, the kernels
    launched most often, the kernels' time on the device, the idle share of
    the card (1 - kernel time / wall time) over the profiled calls and over a
    warm one; and, merged with the tracer's spans on their shared clock, the
    launches by host span (each `cudaLaunchKernel` to the innermost span open
    at its start), the idle gaps by host span (each gap of the card to the
    innermost span open when it ended), the device time of each span and its
    kernels (each kernel to the innermost device span it starts in), and the
    host-device synchronisations by span and site;
(c) what a program that compiles nothing per template has in place of
    compile times: seconds for the kernel library (built or found built),
    for `TorchVerifier(tpl)`, for the first call and for a warm call.

Prints the stages as lines and one JSON line at the end. Times of a
--device cpu run are the host's, and the line names the device.
"""

import argparse
import bisect
import json
import os
import re
import sys
import time
from collections import deque

import torch

from .. import tracing
from .. import verifier_torch as vt
from ..compiler import CircuitTemplate, flatten_proofs
from ..models.cache import get_fixture_proof
from ..ops import field as tf
from ..types import CommonCircuitData, ProofWithPublicInputs, VerifierOnlyCircuitData
from .stream_verify import STANDARD

MODELS = {
    "fibonacci": ("fibonacci", STANDARD),
    "gate_zoo": ("gate_zoo", {"target_degree_bits": 12, "num_query_rounds": 28, "proof_of_work_bits": 16}),
    "fibonacci6": ("fibonacci", {"num_query_rounds": 6}),
}
# csrc/*.cu's kernels: a function of an anonymous namespace at the name's start
# (PyTorch's own kernels there are templates over its namespaces)
PORT_KERNEL = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+(?:<[^>:]*>)?)\(")
STAGE_SPANS = ("challenges", "plonk_checks", "fri_checks")
OUTSIDE = "(no span)"
TOP = 8


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_times(v, dev) -> dict:
    """One call of `v` on `dev`, traced, with no synchronise but its end.
    -> {"staged_call_ms": the span "forward", "stages_ms": {stage: ms},
    "spans_ms": {"challenges" | "plonk_checks" | "fri_checks": ms}, "syncs"},
    device ms where `v` is on the card."""
    device = v._ov_idx.device
    _sync(device)
    tracing.reset()
    tracing.enable()
    try:
        with torch.no_grad():
            out = v(dev)
        _sync(device)
    finally:
        tracing.disable()
    if not bool(out["ok"].all()):
        raise AssertionError("the profiled batch was not fully accepted")
    rep = tracing.report()
    spans = rep["spans"]
    return {"staged_call_ms": spans["forward"]["device_ms"],
            "stages_ms": {name: s["device_ms"] for name, s in spans.items() if s["parent"] in STAGE_SPANS},
            "spans_ms": {name: spans[name]["device_ms"] for name in STAGE_SPANS}, "syncs": rep["syncs"]}


def short_name(name: str) -> str:
    """A kernel's name without its template arguments, parameters and
    namespaces."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip() or "unnamed"


def innermost(raw: list, clock: str):
    """The tracer's raw spans (tracing.report) on one clock ("host_ns" or
    "device_ns") as (points, labels): labels[k] names the innermost span over
    [points[k], points[k + 1]), OUTSIDE where none is open."""
    depth = []
    for s in raw:
        d, p = 0, s["parent"]
        while p is not None:
            d, p = d + 1, raw[p]["parent"]
        depth.append(d)
    spans = [(depth[i], s[clock], s["name"]) for i, s in enumerate(raw) if s[clock] is not None]
    points = sorted({t for _, interval, _ in spans for t in interval})
    labels = [OUTSIDE] * len(points)
    for _, (start, end), name in sorted(spans, key=lambda x: x[0]):
        for k in range(bisect.bisect_left(points, start), bisect.bisect_left(points, end)):
            labels[k] = name
    return points, labels


def label_at(points: list, labels: list, t: int) -> str:
    k = bisect.bisect_right(points, t) - 1
    return labels[k] if 0 <= k < len(points) - 1 else OUTSIDE


def device_profile(v, dev, warm_call_ms: float, in_flight: int = 1) -> dict:
    """Calls under torch.profiler: launches, kernel time, idle share, and by
    the tracer's spans, each a forward. One call with `in_flight` 1; else
    5 x `in_flight` calls, each verdict awaited once `in_flight` calls are
    enqueued.

    Device activity alone is recorded (kernels, copies and the CUDA runtime
    calls that launch them): with host activity too, every kernel's time is
    also booked to the operator that launched it and a sum counts it twice,
    and the profiler's bookkeeping of ~10^6 events takes minutes. The events
    are read as the profiler collected them, not through key_averages(),
    which builds a Python object for each. The tracer follows the profiler
    (tracing.py). The profiled call runs slower than a warm call, so the
    idle share is given over both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = 1 if in_flight == 1 else 5 * in_flight
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pending = deque()
        with torch.no_grad():
            for _ in range(calls):
                v(dev)
                event = torch.cuda.Event()
                event.record()
                pending.append(event)
                while len(pending) >= in_flight:
                    pending.popleft().synchronize()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    rep = tracing.report()
    host_points, host_labels = innermost(rep["raw"], "host_ns")
    dev_points, dev_labels = innermost(rep["raw"], "device_ns")
    launches, kernels, kernel_ns, by_kernel, count, port = 0, 0, 0, {}, {}, {}
    launches_by_span, kernels_by_span, device = {}, {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            kernels += 1
            kernel_ns += ev.duration_ns()
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
            by_kernel[name] = by_kernel.get(name, 0) + ev.duration_ns()
            count[name] = count.get(name, 0) + 1
            own = PORT_KERNEL.match(name)
            if own:
                n, ns = port.get(own.group(1), (0, 0))
                port[own.group(1)] = (n + 1, ns + ev.duration_ns())
            per = kernels_by_span.setdefault(label_at(dev_points, dev_labels, ev.start_ns()), {})
            per[short_name(name)] = per.get(short_name(name), 0) + ev.duration_ns()
        elif name == "cudaLaunchKernel":
            launches += 1
            where = label_at(host_points, host_labels, ev.start_ns())
            launches_by_span[where] = launches_by_span.get(where, 0) + 1
    if kernel_ns == 0 or launches == 0:
        raise RuntimeError(f"torch.profiler recorded {launches} cudaLaunchKernel calls and {kernel_ns} ns on the device")
    gaps_by_span, end = {}, None
    for start, stop in sorted(device):
        if end is not None and start > end:
            where = label_at(host_points, host_labels, start)
            gaps_by_span[where] = gaps_by_span.get(where, 0) + start - end
        end = stop if end is None else max(end, stop)
    kernel_ms = kernel_ns / 1e6 / calls
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    return {
        "calls": calls,
        "in_flight": in_flight,
        "cuda_launch_kernel_calls": launches / calls,  # a forward, as every figure below
        "device_activities": kernels / calls,  # kernels, copies and memsets
        "kernel_ms": kernel_ms,
        "profiled_call_ms": wall_ms,
        "idle_share": 1 - kernel_ms / wall_ms,
        "idle_share_of_warm_call": 1 - kernel_ms / warm_call_ms,
        "top_kernels_ms": {k[:160]: round(ns / 1e6 / calls, 3) for k, ns in top},
        "most_launched": {k[:160]: n / calls for k, n in sorted(count.items(), key=lambda kv: -kv[1])[:8]},
        "port_kernels": {k: {"launches": n / calls, "device_ms": ns / 1e6 / calls} for k, (n, ns) in sorted(port.items())},
        "span_device_ms": {k: s["device_ms_a_forward"] for k, s in rep["spans"].items()},
        "launches_by_span": {k: n / calls for k, n in sorted(launches_by_span.items(), key=lambda kv: -kv[1])},
        "idle_gaps_by_span": {k: ns / 1e6 / calls for k, ns in sorted(gaps_by_span.items(), key=lambda kv: -kv[1])},
        "kernels_by_span_ms": {k: {n: ns / 1e6 / calls for n, ns in sorted(per.items(), key=lambda kv: -kv[1])[:TOP]}
                               for k, per in kernels_by_span.items()},
        "syncs_by_span": rep["syncs"],
        "syncs_per_forward": rep["syncs_per_forward"],
    }


def load_proofs(directory: str):
    """The common data and the (vkey, proof) pairs of a directory laid out as
    benchmark/data/<config>/."""
    def read(name):
        with open(os.path.join(directory, name)) as f:
            return json.load(f)

    pairs, i = [], 0
    while os.path.exists(os.path.join(directory, f"proof_{i}.json")):
        pairs.append((VerifierOnlyCircuitData.from_json(read(f"vkey_{i}.json")), ProofWithPublicInputs.from_json(read(f"proof_{i}.json"))))
        i += 1
    if not pairs:
        raise FileNotFoundError(f"no proof_0.json in {directory}")
    return CommonCircuitData.from_json(read("common.json")), pairs


def profile_verifier(model: str, batch: int, device=None, proofs: str = None, in_flight: int = 1) -> dict:
    """Everything the module docstring lists, for one model (or the proofs
    of a directory) and batch."""
    device = tf.resolve_device(device)
    on_card = device.type == "cuda"
    if proofs is None:
        name, params = MODELS[model]
        common, vkey, pwp = get_fixture_proof(name, **params)
        pairs = [(vkey, pwp)]
    else:
        common, pairs = load_proofs(proofs)
    tpl = CircuitTemplate(common)
    res = {
        "model": model if proofs is None else proofs,
        "batch": batch,
        "degree_bits": tpl.degree_bits,
        "num_queries": tpl.num_queries,
        "device": torch.cuda.get_device_name(device) if on_card else f"{device} (host times)",
    }
    if on_card:
        from .. import kernels

        t0 = time.perf_counter()
        kernels.load()
        res["kernel_library_s"] = time.perf_counter() - t0  # nvcc's time where nothing was built yet, else about none
    t0 = time.perf_counter()
    v = vt.TorchVerifier(tpl, device=device)
    _sync(device)
    res["construct_s"] = time.perf_counter() - t0
    distinct = v.prepare(flatten_proofs(tpl, pairs))
    lanes = torch.arange(batch, device=device) % len(pairs)
    dev = {k: x.index_select(0, lanes) for k, x in distinct.items()}
    del distinct
    _sync(device)
    for key in ("first_call_s", "warm_call_s"):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = v(dev)
        _sync(device)
        res[key] = time.perf_counter() - t0
    if not bool(out["ok"].all()):
        raise AssertionError("the batch was not fully accepted")
    res.update(stage_times(v, dev))
    res["device_profile"] = device_profile(v, dev, res["warm_call_s"] * 1e3, in_flight) if on_card else None  # not measured off the card
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.profile_verifier")
    p.add_argument("--model", choices=sorted(MODELS), default="fibonacci")
    p.add_argument("--proofs", default=None, help="a directory of common.json, vkey_<i>.json, proof_<i>.json in place of --model")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--in-flight", type=int, default=1, help="calls enqueued before a verdict is awaited in the profiled calls")
    p.add_argument("--device", default=None, help="without it the CUDA card, and an error where there is none")
    args = p.parse_args(argv)
    if args.in_flight < 1:
        p.error("--in-flight is at least 1")
    res = profile_verifier(args.model, args.batch, args.device, args.proofs, args.in_flight)
    for stage, ms in res["stages_ms"].items():
        print(f"{stage}: {ms:.3f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
