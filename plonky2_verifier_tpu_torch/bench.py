"""The port's benchmark: batched Plonky2 proof verification on one CUDA card,
the counterpart of the root bench.py (which measures the JAX package).

Run from the repository root:
  python3 bench_torch.py [--device cpu] [--seed N] [--warmup N] [--sync]

It prints ONE JSON line. The environment picks the workload, under bench.py's
names and defaults, but for BENCH_ITERS (100 here, so that the step's p90 has
ten samples above it):
  BENCH_MODE           batch (default), stream or mesh_stream
  BENCH_MODEL          fibonacci (default), gate_zoo, or another model of
                       models/cache.get_fixture_proof
  BENCH_BATCH          1024 (mesh_stream: the global batch, 2048)
  BENCH_DEGREE_BITS    12
  BENCH_QUERIES        28
  BENCH_POW_BITS       16
  BENCH_ITERS          100 timed calls (batch mode)
  BENCH_STREAM_PROOFS  10000 (mesh_stream: 8192)
  BENCH_CORRUPT_EVERY  1000: every N-th proof of a stream has a flipped
                       pow_witness (0: none)

Modes:
- batch: `TorchVerifier(tpl)` on `flatten_proofs(tpl, [(vkey, proof)] *
  BENCH_BATCH)`. The first `--warmup` calls (the kernels' first launches, the
  constants' copies) are untimed; then BENCH_ITERS calls, each timed until its
  verdict is on the host, as a caller pays it. The step's median, quartiles,
  p90, min, max and count; proofs_per_sec = batch / median step. One untimed
  call on a copy of the arrays with `--seed`-chosen lanes faulted must reject
  exactly those lanes. On the card one more call under torch.profiler, after
  the timed ones, gives the launches, the kernel time and the idle share of a
  forward (tools/profile_verifier.device_profile).
- stream: BENCH_STREAM_PROOFS raw-JSON proofs (tools/stream_verify.proof_stream)
  through `StreamVerifier(tpl, BENCH_BATCH, raw_json=True)`: `run()` with its
  prefetch thread, or with `--sync` `submit` / `flush` on the calling thread.
  One batch verified before it (StreamVerifier.warm_up) is the warm-up.
- mesh_stream: the same stream over a 2 x 1 mesh of processes on the one card,
  joined by gloo (parallel.run_ranks, tools/stream_verify.stream_rank), then
  the one-process stream of the same proofs and global batch beside it.

A gate that fails (an honest proof rejected, a fault accepted, a miscount, a
TPU kernel's counterpart never launched on the card) is listed by
`gate_failures`; bench_torch.py then exits non-zero and prints no result.

`device=None` means the CUDA card, and raises where there is none: nothing
falls back to the CPU. The CPU runs only when given "cpu", as the tests do;
its times are the host's, and the device fields then say "cpu".
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

MODES = ("batch", "stream", "mesh_stream")
FAULTED = ("openings1", "pow_witness", "leaves_1", "final_poly", "public_inputs", "circuit_digest")  # a word of each, a lane each
TPU_KERNELS = ("permutation_scan", "sponge_rows_grouped", "merkle_fold")  # the Pallas kernels' counterparts a forward must launch
MESH_DP = 2
MESH_TIMEOUT_S = 900.0


def settings(environ=None) -> dict:
    """The workload the BENCH_* variables of `environ` (by default this
    process's environment) name; the module docstring lists them."""
    env = os.environ if environ is None else environ
    mode = env.get("BENCH_MODE", "batch")
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE must be one of {MODES}, not {mode!r}")
    mesh = mode == "mesh_stream"
    return {
        "mode": mode,
        "model": env.get("BENCH_MODEL", "fibonacci"),
        "batch": int(env.get("BENCH_BATCH", "2048" if mesh else "1024")),
        "degree_bits": int(env.get("BENCH_DEGREE_BITS", "12")),
        "queries": int(env.get("BENCH_QUERIES", "28")),
        "pow_bits": int(env.get("BENCH_POW_BITS", "16")),
        "iters": int(env.get("BENCH_ITERS", "100")),
        "stream_proofs": int(env.get("BENCH_STREAM_PROOFS", "8192" if mesh else "10000")),
        "corrupt_every": int(env.get("BENCH_CORRUPT_EVERY", "1000")),
    }


def fixture_params(s: dict | None = None) -> dict:
    """The fixture's parameters for models/cache.get_fixture_proof, as
    bench.py's fixture_params gives them, from `s` (by default settings())."""
    s = settings() if s is None else s
    if s["model"] == "fibonacci":
        # n rows = 1 const + n_arith + 1 public-input, padded to 2^degree_bits
        return {
            "n_arith_rows": (1 << s["degree_bits"]) - 3,
            "num_query_rounds": s["queries"],
            "proof_of_work_bits": s["pow_bits"],
        }
    if s["model"] == "gate_zoo":
        return {
            "target_degree_bits": s["degree_bits"],
            "num_query_rounds": s["queries"],
            "proof_of_work_bits": s["pow_bits"],
        }
    return {"num_query_rounds": s["queries"], "proof_of_work_bits": s["pow_bits"]}


def lookup_opening_column(tpl) -> int:
    """The column of openings1 that holds the first lookup opening (after
    the constants, sigmas, wires, zs, partial products and quotient, two
    words each)."""
    return 2 * (tpl.n_const_cols + tpl.n_sigmas + tpl.num_wires + tpl.n_zs + tpl.n_pp + tpl.n_quot)


def fault_lanes(arrays: dict, batch: int, faults) -> dict:
    """A copy of `arrays` in which, for each (lane, name) or (lane, (name,
    column)) of `faults`, the word at that column (0 by default) of lane's row
    of array `name` has its low bit flipped."""
    mutated = {k: a.copy() for k, a in arrays.items()}
    for lane, name in faults:
        name, column = name if isinstance(name, tuple) else (name, 0)
        mutated[name].reshape(batch, -1)[lane, column] ^= np.uint64(1)
    return mutated


def seeded_faults(tpl, batch: int, seed: int) -> list:
    """Up to half the lanes, chosen by `seed`, each with one word of another
    array of FAULTED flipped (and a lookup opening where the template has
    lookups): [(lane, name or (name, column)), ...] by lane."""
    candidates = list(FAULTED) + ([("openings1", lookup_opening_column(tpl))] if tpl.n_lookup else [])
    rng = np.random.default_rng(seed)
    n = min(len(candidates), batch // 2)
    lanes = sorted(int(i) for i in rng.choice(batch, size=n, replace=False))
    picks = rng.permutation(len(candidates))[:n]
    return [(lane, candidates[int(i)]) for lane, i in zip(lanes, picks)]


def step_stats(steps_s) -> dict:
    """Median, quartiles, p90, min, max (ms) and count of the step times."""
    ms = np.asarray(steps_s, dtype=np.float64) * 1e3
    if ms.size == 0:
        raise ValueError("no timed call")
    q25, median, q75, p90 = np.percentile(ms, [25, 50, 75, 90])
    return {"step_ms_median": float(median), "step_ms_p25": float(q25), "step_ms_p75": float(q75), "step_ms_p90": float(p90),
            "step_ms_min": float(ms.min()), "step_ms_max": float(ms.max()), "step_count": int(ms.size)}


def time_calls(v, dev, iters: int, warmup: int = 2, lib=None) -> dict:
    """`warmup` untimed calls of `v` on `dev`, then `iters` timed ones, each
    ended by its verdict on the host (`ok.all().item()`, which waits for the
    device). With `lib` (the kernel library) its launch counters are set to 0
    after the warm-up and read after the timed calls. Returns {"warmup_s",
    "steps_s", "all_verified" (every lane of every call accepted),
    "launches"}."""
    ok = True
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(warmup):
            ok &= bool(v(dev)["ok"].all().item())
        warmup_s = time.perf_counter() - t0
        if lib is not None:
            lib.reset_launches()
        steps = []
        for _ in range(iters):
            t = time.perf_counter()
            ok &= bool(v(dev)["ok"].all().item())
            steps.append(time.perf_counter() - t)
    return {"warmup_s": warmup_s, "steps_s": steps, "all_verified": ok, "launches": dict(lib.launches) if lib is not None else None}


def _library(device: torch.device):
    """The kernel library (built or found built) and its seconds on the
    card; (None, None) on the CPU, where the wrappers run the plain versions."""
    if device.type != "cuda":
        return None, None
    from . import kernels

    t0 = time.perf_counter()
    lib = kernels.load()
    return lib, time.perf_counter() - t0


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return str(device)
    from .tools.bench_poseidon import card_name_and_limit

    return card_name_and_limit()


def _fixture(s: dict):
    from .compiler import CircuitTemplate
    from .models.cache import get_fixture_proof

    t0 = time.perf_counter()
    common, vkey, pwp = get_fixture_proof(s["model"], **fixture_params(s))
    return CircuitTemplate(common), common, vkey, pwp, time.perf_counter() - t0


def _common_fields(s: dict, tpl, seed: int, device: torch.device, value: float, metric: str) -> dict:
    from .metrics import perms_per_proof

    perms = perms_per_proof(tpl)
    return {
        "metric": metric,
        "value": value,
        "unit": "proofs/s",
        "mode": s["mode"],
        "model": s["model"],
        "batch": s["batch"],
        "degree_bits": tpl.degree_bits,
        "query_rounds": tpl.num_queries,
        "pow_bits": tpl.pow_bits,
        "poseidon_perms_per_proof": perms,
        "poseidon_perms_per_sec": value * perms,
        "seed": seed,
        "device": device_name(device),
    }


def run_batch(s: dict, device: torch.device, seed: int, warmup: int) -> dict:
    """The batch mode (the module docstring)."""
    from .compiler import flatten_proofs
    from .verifier_torch import TorchVerifier

    tpl, _, vkey, pwp, fixture_s = _fixture(s)
    lib, build_s = _library(device)
    batch = s["batch"]
    t0 = time.perf_counter()
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * batch)
    flatten_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v = TorchVerifier(tpl, device=device)
    dev = v.prepare(arrays)
    _sync(device)
    construct_s = time.perf_counter() - t0

    timed = time_calls(v, dev, s["iters"], warmup, lib)
    stats = step_stats(timed["steps_s"])

    faults = seeded_faults(tpl, batch, seed)
    with torch.no_grad():
        ok = v(v.prepare(fault_lanes(arrays, batch, faults)))["ok"].cpu().numpy()
    rejected = [int(i) for i in np.flatnonzero(~ok)]
    want = [lane for lane, _ in faults]

    traced = {"cuda_launches_per_forward": None, "kernel_ms_per_forward": None, "idle_share": None, "traced_call_ms": None,
              "port_kernels": None}  # not measured off the card
    if device.type == "cuda":
        from .tools.profile_verifier import device_profile

        prof = device_profile(v, dev, stats["step_ms_median"])
        traced = {"cuda_launches_per_forward": prof["cuda_launch_kernel_calls"], "kernel_ms_per_forward": prof["kernel_ms"],
                  "idle_share": prof["idle_share_of_warm_call"], "traced_call_ms": prof["profiled_call_ms"],
                  "port_kernels": prof["port_kernels"]}

    proofs_per_sec = batch / stats["step_ms_median"] * 1e3
    parts = {"fixture_s": fixture_s, "build_s": build_s, "flatten_s": flatten_s, "construct_s": construct_s}
    return {
        **_common_fields(s, tpl, seed, device, proofs_per_sec, "proofs_per_sec"),
        "proofs_per_sec": proofs_per_sec,
        **stats,
        "all_verified": timed["all_verified"],
        "fault_lanes": want,
        "fault_arrays": [name if isinstance(name, str) else f"{name[0]}[{name[1]}]" for _, name in faults],
        "rejected_lanes": rejected,
        "faults_rejected": rejected == want,
        "kernel_launches": timed["launches"],  # over the step_count timed calls; None on the CPU
        **traced,
        "setup_s": sum(x for x in parts.values() if x is not None),
        "setup_parts_s": parts,
        "warmup_s": timed["warmup_s"],
        "warmup_calls": warmup,
    }


def _stream_fields(snap: dict, ingest_work_s: float, ingest_s: float, device_wait_s: float) -> dict:
    return {
        "stream_proofs_per_sec": snap["proofs_per_sec"],
        "steady_proofs_per_sec": snap["steady_proofs_per_sec"],
        "proofs": snap["proofs"],
        "accepted": snap["accepted"],
        "rejected": snap["rejected"],
        "batches": snap["batches"],
        "elapsed_s": snap["elapsed_s"],
        "ingest_work_s": ingest_work_s,  # making batches ready, on whichever thread
        "ingest_work_ms_per_proof": ingest_work_s / max(snap["proofs"], 1) * 1e3,
        "ingest_s": ingest_s,  # the part the calling thread paid
        "device_wait_s": device_wait_s,
        "prefetch_hidden_share": 1 - ingest_s / ingest_work_s if ingest_work_s > 0 else None,
    }


def _stream_faults(n: int, corrupt_every: int) -> list:
    return [i for i in range(n) if corrupt_every and i % corrupt_every == corrupt_every - 1]


def one_process_stream(s: dict, tpl, vkey, pwp, device: torch.device, sync: bool, warmup: int, lib) -> dict:
    """The stream of the stream mode in this process: its metrics, the
    warm-up's seconds and the launches of the stream."""
    from .parallel import StreamVerifier
    from .tools.stream_verify import proof_stream

    items, expected = proof_stream(vkey, pwp, s["stream_proofs"], s["corrupt_every"], raw=True)
    sv = StreamVerifier(tpl, s["batch"], raw_json=True, device=device)
    warmup_s = sv.warm_up(list(proof_stream(vkey, pwp, s["batch"], 0, raw=True)[0])) if warmup else 0.0
    if lib is not None:
        lib.reset_launches()
    if sync:
        for group, live in sv._batches(items):
            sv.submit(group, live)
        sv.flush()
    else:
        sv.run(items)
    _sync(device)
    m = sv.metrics
    return {"snapshot": m.snapshot(), "expected": expected, "warmup_s": warmup_s, "ingest_work_s": sv.ingest_work_s,
            "ingest_s": m.ingest_s, "device_wait_s": m.device_wait_s, "ingest_workers": sv.ingest_workers,
            "launches": dict(lib.launches) if lib is not None else None}


def _ingest_tier() -> str:
    from . import native

    return "native" if native.get_fastload() is not None else "python"


def run_stream(s: dict, device: torch.device, seed: int, warmup: int, sync: bool) -> dict:
    """The stream mode (the module docstring)."""
    t0 = time.perf_counter()
    tpl, _, vkey, pwp, fixture_s = _fixture(s)
    lib, build_s = _library(device)
    tier = _ingest_tier()
    setup_s = time.perf_counter() - t0
    res = one_process_stream(s, tpl, vkey, pwp, device, sync, warmup, lib)
    snap, expected = res["snapshot"], res["expected"]
    n = s["stream_proofs"]
    return {
        **_common_fields(s, tpl, seed, device, snap["proofs_per_sec"], "stream_proofs_per_sec"),
        **_stream_fields(snap, res["ingest_work_s"], res["ingest_s"], res["device_wait_s"]),
        "expected_rejected": expected,
        "prefetch": not sync,
        "ingest_tier": tier,
        "ingest_workers": res["ingest_workers"],
        "all_verified": snap["accepted"] == n - expected,
        "fault_lanes": _stream_faults(n, s["corrupt_every"]),
        "faults_rejected": snap["rejected"] == expected,
        "kernel_launches": res["launches"],  # over the stream; None on the CPU
        "setup_s": setup_s,
        "setup_parts_s": {"fixture_s": fixture_s, "build_s": build_s},
        "warmup_s": res["warmup_s"],
        "warmup_calls": 1 if warmup else 0,
    }


def mesh_stream_rank(s: dict, dp: int, warmup: int, device) -> dict:
    """One rank of the mesh_stream mode, in a process of parallel.run_ranks:
    the stream made here from the cached fixture (the parent proved it), then
    tools/stream_verify.stream_rank over a dp x 1 mesh."""
    from .tools.stream_verify import proof_stream, stream_rank

    device = None if device is None else torch.device(device)
    tpl, common, vkey, pwp, _ = _fixture(s)
    if device is None or device.type == "cuda":
        _library(torch.device("cuda"))  # finds the parent's build
    items, _ = proof_stream(vkey, pwp, s["stream_proofs"], s["corrupt_every"], raw=True)
    warm = list(proof_stream(vkey, pwp, s["batch"], 0, raw=True)[0]) if warmup else None
    return stream_rank(items, s["batch"], dp, 1, True, device, common=common, warm_up=warm)


def run_mesh_stream(s: dict, device: torch.device, seed: int, warmup: int) -> dict:
    """The mesh_stream mode (the module docstring): the ranks first, while
    this process has not touched the card, then its own stream beside them."""
    from .parallel import run_ranks

    t0 = time.perf_counter()
    tpl, _, vkey, pwp, fixture_s = _fixture(s)
    lib, build_s = _library(device)
    setup_s = time.perf_counter() - t0
    on_card = device.type == "cuda"
    ranks = run_ranks(mesh_stream_rank, MESH_DP, (s, MESH_DP, warmup, None if on_card else str(device)),
                      backend="gloo", timeout_s=MESH_TIMEOUT_S, threads=0 if on_card else 1)
    one = one_process_stream(s, tpl, vkey, pwp, device, False, warmup, lib)

    n, expected = s["stream_proofs"], one["expected"]
    counts = [[r[k] for k in ("proofs", "accepted", "rejected", "batches")] for r in ranks]
    slow = min(ranks, key=lambda r: r["snapshot"]["proofs_per_sec"])  # the slower rank's clock
    rate = slow["snapshot"]["proofs_per_sec"]
    launches = None
    if on_card:
        launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    return {
        **_common_fields(s, tpl, seed, device, rate, "mesh_stream_proofs_per_sec"),
        **_stream_fields(slow["snapshot"], slow["ingest_work_s"], slow["ingest_s"], slow["device_wait_s"]),
        "expected_rejected": expected,
        "mesh": {"dp": MESH_DP, "qp": 1, "backend": "gloo", "lanes_a_rank": s["batch"] // MESH_DP},
        "rank_counts": counts,  # (proofs, accepted, rejected, batches) on each rank: the global counts
        "rank_proofs_per_sec": [r["snapshot"]["proofs_per_sec"] for r in ranks],
        "rank_steady_proofs_per_sec": [r["snapshot"]["steady_proofs_per_sec"] for r in ranks],
        "rank_ingest_work_s": [r["ingest_work_s"] for r in ranks],
        "rank_ingest_s": [r["ingest_s"] for r in ranks],
        "ingest_workers": ranks[0]["ingest_workers"],
        "one_process_proofs_per_sec": one["snapshot"]["proofs_per_sec"],
        "one_process_steady_proofs_per_sec": one["snapshot"]["steady_proofs_per_sec"],
        "mesh_over_one_process": rate / one["snapshot"]["proofs_per_sec"],
        "all_verified": all(c[:2] == [n, n - expected] for c in counts) and one["snapshot"]["accepted"] == n - expected,
        "fault_lanes": _stream_faults(n, s["corrupt_every"]),
        "faults_rejected": all(c[2] == expected for c in counts) and one["snapshot"]["rejected"] == expected,
        "kernel_launches": launches,  # the ranks' streams together; None on the CPU
        "one_process_kernel_launches": one["launches"],
        "setup_s": setup_s,
        "setup_parts_s": {"fixture_s": fixture_s, "build_s": build_s},
        "warmup_s": max(r["warm_up_s"] for r in ranks),
        "warmup_calls": 1 if warmup else 0,
    }


def bench(s: dict, device=None, seed: int = 0, warmup: int = 2, sync: bool = False) -> dict:
    """The line of one run of the workload `s` (settings()) on `device`
    (None: the card, and an error where there is none)."""
    from .ops.field import resolve_device

    device = resolve_device(device)
    if s["mode"] == "batch":
        return run_batch(s, device, seed, warmup)
    if s["mode"] == "stream":
        return run_stream(s, device, seed, warmup, sync)
    if sync:
        raise ValueError("--sync is a form of the one-process stream mode")
    return run_mesh_stream(s, device, seed, warmup)


def gate_failures(line: dict) -> list:
    """What a line shows to have gone wrong; empty when every gate held."""
    failed = []
    if not line["all_verified"]:
        failed.append("an honest proof was rejected")
    if not line["faults_rejected"]:
        got = line.get("rejected_lanes", line.get("rejected"))
        failed.append(f"the faults {line['fault_lanes']} were not rejected exactly: rejected {got}")
    launches = line["kernel_launches"]
    if launches is not None and not all(launches[k] > 0 for k in TPU_KERNELS):
        failed.append(f"a TPU kernel's counterpart was never launched: {json.dumps(launches)}")
    return failed
