"""Where one verifier call spends its time: the one tool for what
tools/profile_stages.py, profile_split.py, profile_verifier.py and
profile_compile.py answer about the JAX package.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.profile_verifier
      [--model fibonacci|gate_zoo|fibonacci6] [--batch N] [--device cpu]

On the template given (fibonacci: the standard shape; gate_zoo: the gate zoo
with lookups at the same degree, queries and PoW; fibonacci6: the 6-query
fixture, for --device cpu) and a batch of copies of its cached proof:

(a) stage times, a synchronise around each stage: the public-input hash, the
    transcript, the Plonk checks in four parts (the lookup argument and the
    gate program apart), FRI in its parts (proof of work and reduced
    openings, leaf hashes, initial Merkle walks, combineInitial, each fold
    step's Merkle walk and its coset fold, the final polynomial). The stages
    add up to the staged call. Beside them, summed across stages, the time
    inside `horner_ext`, `inv` and `pow_dynamic` (each call synchronised);
(b) under torch.profiler, on the card: `cudaLaunchKernel` calls a forward,
    the kernels' time on the device, and the idle share of the card (1 -
    kernel time / wall time) over the profiled forward and over a warm one;
(c) what a program that compiles nothing per template has in place of
    compile times: seconds for the kernel library (built or found built),
    for `TorchVerifier(tpl)`, for the first call and for a warm call.

Prints the stages as lines and one JSON line at the end. Times of a
--device cpu run are the host's, and the line names the device.
"""

import argparse
import json
import sys
import time

import torch

from .. import verifier_torch as vt
from ..compiler import CircuitTemplate, flatten_proofs
from ..models.cache import get_fixture_proof
from ..ops import field as tf
from .stream_verify import STANDARD

MODELS = {
    "fibonacci": ("fibonacci", STANDARD),
    "gate_zoo": ("gate_zoo", {"target_degree_bits": 12, "num_query_rounds": 28, "proof_of_work_bits": 16}),
    "fibonacci6": ("fibonacci", {"num_query_rounds": 6}),
}
INNER = ("horner_ext", "inv", "pow_dynamic")  # summed across the stages they run in


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_times(v, dev) -> dict:
    """One call of `v` on `dev` with a synchronise where each stage ends
    (TorchVerifier.on_stage) and around every call of the INNER functions.
    -> {"staged_call_ms", "stages_ms": {stage: ms}, "inner_ms": {function: ms}}."""
    device = v._ov_idx.device
    stages, inner = {}, dict.fromkeys(INNER, 0.0)
    last = [0.0]

    def on_stage(name):
        _sync(device)
        now = time.perf_counter()
        stages[name] = stages.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    def timed(name, fn):
        def run(*args, **kwargs):
            _sync(device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            inner[name] += (time.perf_counter() - t) * 1e3
            return out

        return run

    originals = {"horner_ext": (vt, vt.horner_ext), "inv": (tf, tf.inv), "pow_dynamic": (tf, tf.pow_dynamic)}
    for name, (module, fn) in originals.items():
        setattr(module, name, timed(name, fn))
    v.on_stage = on_stage
    try:
        _sync(device)
        t0 = last[0] = time.perf_counter()
        with torch.no_grad():
            out = v(dev)
        _sync(device)
        whole = (time.perf_counter() - t0) * 1e3
    finally:
        v.on_stage = None
        for name, (module, fn) in originals.items():
            setattr(module, name, fn)
    if not bool(out["ok"].all()):
        raise AssertionError("the profiled batch was not fully accepted")
    return {"staged_call_ms": whole, "stages_ms": stages, "inner_ms": inner}


def device_profile(v, dev, warm_call_ms: float) -> dict:
    """One call under torch.profiler: launches, kernel time, idle share.

    Device activity alone is recorded (kernels, copies and the CUDA runtime
    calls that launch them): with host activity too, every kernel's time is
    also booked to the operator that launched it and a sum counts it twice,
    and the profiler's bookkeeping of ~10^6 events takes minutes. The events
    are read as the profiler collected them, not through key_averages(),
    which builds a Python object for each. The profiled call runs slower
    than a warm call, so the idle share is given over both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            v(dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches, kernels, kernel_ns, by_kernel = 0, 0, 0, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            kernels += 1
            kernel_ns += ev.duration_ns()
            by_kernel[name] = by_kernel.get(name, 0) + ev.duration_ns()
        elif name == "cudaLaunchKernel":
            launches += 1
    if kernel_ns == 0 or launches == 0:
        raise RuntimeError(f"torch.profiler recorded {launches} cudaLaunchKernel calls and {kernel_ns} ns on the device")
    kernel_ms = kernel_ns / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    return {
        "cuda_launch_kernel_calls": launches,
        "device_activities": kernels,  # kernels, copies and memsets
        "kernel_ms": kernel_ms,
        "profiled_call_ms": wall_ms,
        "idle_share": 1 - kernel_ms / wall_ms,
        "idle_share_of_warm_call": 1 - kernel_ms / warm_call_ms,
        "top_kernels_ms": {k[:160]: round(ns / 1e6, 3) for k, ns in top},
    }


def profile_verifier(model: str, batch: int, device=None) -> dict:
    """Everything the module docstring lists, for one model and batch."""
    device = tf.resolve_device(device)
    on_card = device.type == "cuda"
    name, params = MODELS[model]
    common, vkey, pwp = get_fixture_proof(name, **params)
    tpl = CircuitTemplate(common)
    res = {
        "model": model,
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
    dev = v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * batch))
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
    res["device_profile"] = device_profile(v, dev, res["warm_call_s"] * 1e3) if on_card else None  # not measured off the card
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.profile_verifier")
    p.add_argument("--model", choices=sorted(MODELS), default="fibonacci")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--device", default=None, help="without it the CUDA card, and an error where there is none")
    args = p.parse_args(argv)
    res = profile_verifier(args.model, args.batch, args.device)
    for stage, ms in res["stages_ms"].items():
        print(f"{stage}: {ms:.3f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
