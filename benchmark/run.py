"""Run one cell of the benchmark of plonky2_verifier_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names a
configuration and a traffic mix; each is a file found by its name, and each
metric a reader in benchmark/metrics/<name>.py (cell.py says where). The run:

1. set-up: the proofs are read, each distinct input (honest proofs, and
   each fault of the traffic on each) flattened once by the program, the
   pool of batches made on the card with the lanes `--seed` draws, the
   verifier built, every pool batch verified once (warm-up);
2. the window: the closed loop of program.py for `--seconds`, then the
   batches in flight awaited; with `--trace 1` a few batches more under the
   profiler (profiled.py), after the window;
3. the check (correct.py): the program's challenges read by a debug call,
   its state freed, then every verdict lane of the window against the plain
   reference.

It prints the numbers compared, each beside its limit, as the last lines of
standard error, and as its last line of standard output one JSON object:
`correct`, `attempted` and `failed` (lanes), `metrics` (`--trace 0`: the
cell's end-to-end metrics, `--trace 1`: its per-layer ones), `device`,
`breakdown` (`--trace 1`) and `checks`. It exits non-zero and prints no
result without as many CUDA devices as the cell asks for, or where the
process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "plonky2_verifier_tpu")
TRACE_BATCHES = 10
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def metric_entries(manifest: dict, workload: str, trace: bool) -> list:
    """The metrics a run of `workload` reports: with `trace` the per-layer
    ones, else the end-to-end ones."""
    reported = {m["name"] for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])}
    if not trace:
        return [m for m in manifest["end_to_end"] if m["name"] in reported]
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", []) or ("workloads" not in m and m["moves"] in reported)]


def read_metric(bench_dir: str, name: str, obs: dict):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", os.path.join(bench_dir, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(obs)


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None, help="plant a fault of controls.py in the timed path (checks only)")
    return ap.parse_args(argv)


def run(argv=None, root: str = ROOT, device=None) -> int:
    """One run; `root` holds BENCHMARK.json and the benchmark's directory.
    `device` None means the cell's CUDA devices, and a run without them
    fails; the tests pass "cpu"."""
    args = parse(argv)
    bench_dir = os.path.join(root, "benchmark")
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(HERE, "_cache", sub)
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

    import torch

    parts = {"imports_s": time.perf_counter() - T_START}
    from cell import lane_plans, load_cell, load_json, variants
    import controls
    import correct
    from program import Program

    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = load_cell(bench_dir, manifest, args.workload)
    if device is None:
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} CUDA device(s); torch.cuda.is_available() is {torch.cuda.is_available()}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    inputs = variants(cell)
    plans = lane_plans(cell, args.seed)
    parts["read_s"] = time.perf_counter() - T_START - parts["imports_s"]
    if on_card:
        t = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=device)
        parts["cuda_init_s"] = time.perf_counter() - t
    program = Program(cell, inputs, plans, device, controls.make(args.control) if args.control else None)
    parts.update(program.parts)
    t = time.perf_counter()
    program.loop(batches=len(plans) + program.in_flight)  # every pool batch, in the loop's own pattern
    program.sync()
    parts["warmup_s"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()  # the set-up's objects (the proofs' JSON above all) stay out of the window's collections
    setup_peak = 0
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    records = program.loop(seconds=args.seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    span = None
    trace_s = None
    if args.trace:
        from profiled import traced_span

        t = time.perf_counter()
        span = traced_span(program, TRACE_BATCHES)
        trace_s = time.perf_counter() - t
    words = program.challenge_words()
    program.close()
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}, which the port must not use", file=sys.stderr)
        return 3

    t = time.perf_counter()
    ref = correct.reference(cell.common, inputs)
    checks = correct.compare(records, plans, words, ref)
    reference_s = time.perf_counter() - t

    obs = {"batch": cell.traffic["batch"], "records": records, "span": span, "setup_s": records[0]["due"] - T_START,
           "window_peak_bytes": window_peak, "on_card": on_card, "perms_per_proof": ref[0]["permutations"]}
    entries = metric_entries(manifest, args.workload, bool(args.trace))
    metrics = {}
    for m in entries:
        value = read_metric(bench_dir, m["name"], obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else device.type, "kind": torch.cuda.get_device_name(device) if on_card else str(device),
           "count": cell.workload["chips"] if on_card else 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    if span:
        dev.update(busy_s=span["busy_s"], window_s=span["window_s"])
    attempted = len(records) * cell.traffic["batch"]
    line = {"correct": correct.is_correct(checks), "attempted": attempted,
            "failed": checks["verdict_mismatch_lanes"]["value"], "metrics": metrics, "device": dev}
    if span:
        line["breakdown"] = span["breakdown"]
    line["checks"] = checks

    latencies_ms = sorted(round((r["done"] - r["due"]) * 1e3, 3) for r in records)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "batches": len(records),
                      "samples_behind_verdict_ms_p95": len(records), "setup_parts_s": parts, "trace_s": trace_s,
                      "perms_per_proof": obs["perms_per_proof"], "launches": program.launches(),
                      "reference_s": reference_s, "span": {k: v for k, v in (span or {}).items() if k != "breakdown"},
                      "verdict_ms_sorted_tail": latencies_ms[-12:], "control": args.control}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
