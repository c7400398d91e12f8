"""Native host-runtime components (C++, built on demand with g++).

`fastload` is the proof-ingest fast path: Plonky2 JSON -> flattened uint64
batch arrays in a single parse pass (no DOM), GIL-free during parse so
thread pools scale it across host cores (tools/bench_ingest.py for measured
numbers). The build is gated on a hash of fastload.cpp recorded next to the
.so — a stale or foreign binary is never loaded silently. When no toolchain
is available, `get_fastload()` returns None and `flatten_proof_jsons` falls
back to the pure-Python path (strict_loads -> types.from_json ->
compiler.flatten.flatten_proofs), so callers see identical arrays either
way, just slower.

Both raw-JSON ingest tiers reject documents with duplicated schema keys:
json.loads is last-wins, a naive native parser is typically first-wins, and
on untrusted proof bytes that difference is a parser differential (two
tiers disagreeing on the same document). `strict_loads` is the Python-side
guard.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import sysconfig
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_CACHED = False
_MOD = None

#: stderr of the last failed g++ invocation (None if the build never failed).
last_build_error: Optional[str] = None


def _so_path() -> str:
    return os.path.join(_BUILD, "p2v_fastload" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))


def _src_hash(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def build(force: bool = False) -> Optional[str]:
    """Compile the extension if needed; returns the .so path or None.

    Staleness is decided by a recorded sha256 of fastload.cpp (written next
    to the .so on every successful build), not file mtimes: a checked-out or
    copied binary whose recorded hash does not match the current source is
    rebuilt, never loaded as-is."""
    global last_build_error
    so = _so_path()
    src = os.path.join(_DIR, "fastload.cpp")
    want = _src_hash(src)
    tag = so + ".srchash"
    if not force and os.path.exists(so) and os.path.exists(tag):
        with open(tag) as f:
            if f.read().strip() == want:
                return so
    os.makedirs(_BUILD, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        f"-I{include}", src, "-o", so,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        last_build_error = (e.stderr or b"").decode(errors="replace")
        print(f"p2v native build failed:\n{last_build_error}", file=sys.stderr)
        return None
    except Exception as e:
        last_build_error = repr(e)
        print(f"p2v native build failed: {last_build_error}", file=sys.stderr)
        return None
    with open(tag, "w") as f:
        f.write(want)
    return so


def get_fastload():
    """The loaded extension module, building it on first use; None if the
    toolchain or build is unavailable (callers fall back to Python)."""
    global _CACHED, _MOD
    with _LOCK:
        if _CACHED:
            return _MOD
        _CACHED = True
        so = build()
        if so is None:
            return None
        import importlib.util

        spec = importlib.util.spec_from_file_location("p2v_fastload", so)
        try:
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception:
            return None
        _MOD = mod
        return _MOD


def _reject_dupes(pairs):
    d = {}
    for k, v in pairs:
        if k in d:
            raise ValueError(f"duplicate key: {k}")
        d[k] = v
    return d


def strict_loads(data):
    """json.loads that rejects duplicated object keys, matching the native
    parser — the two raw-JSON ingest tiers must agree on every document."""
    return json.loads(data, object_pairs_hook=_reject_dupes)


def shape_descriptor(tpl) -> dict:
    """The template's shape facts the native flattener needs."""
    return {
        "n_pi": tpl.n_pi,
        "cap_len": tpl.cap_len,
        "n_const_cols": tpl.n_const_cols,
        "n_sigmas": tpl.n_sigmas,
        "num_wires": tpl.num_wires,
        "n_zs": tpl.n_zs,
        "n_pp": tpl.n_pp,
        "n_quot": tpl.n_quot,
        "n_lookup": tpl.n_lookup,
        "final_poly_len": tpl.final_poly_len,
        "num_queries": tpl.num_queries,
        "initial_path_len": tpl.initial_path_len,
        "oracle_widths": [int(w) for w in tpl.oracle_widths],
        "steps": [
            {
                "arity": 1 << st["arity_bits"],
                "path_len": st["path_len"],
                "cap_len": st["cap_len"],
            }
            for st in tpl.steps
        ],
    }


def alloc_batch_arrays(tpl, batch: int) -> Dict[str, np.ndarray]:
    """Batch arrays in compiler/flatten.py's exact layout."""
    out = {
        "circuit_digest": (batch, 4),
        "public_inputs": (batch, tpl.n_pi),
        "cap_cs": (batch, tpl.cap_len, 4),
        "cap_w": (batch, tpl.cap_len, 4),
        "cap_zp": (batch, tpl.cap_len, 4),
        "cap_q": (batch, tpl.cap_len, 4),
        "openings1": (batch, tpl.n_const_cols + tpl.n_sigmas + tpl.num_wires + tpl.n_zs + tpl.n_pp + tpl.n_quot + tpl.n_lookup, 2),
        "openings2": (batch, tpl.n_zs + tpl.n_lookup, 2),
        "final_poly": (batch, tpl.final_poly_len, 2),
        "pow_witness": (batch,),
    }
    for o in range(4):
        out[f"leaves_{o}"] = (batch, tpl.num_queries, tpl.oracle_widths[o])
        out[f"sibs_{o}"] = (batch, tpl.num_queries, tpl.initial_path_len, 4)
    for s, st in enumerate(tpl.steps):
        out[f"step_cap_{s}"] = (batch, st["cap_len"], 4)
        out[f"step_evals_{s}"] = (batch, tpl.num_queries, 1 << st["arity_bits"], 2)
        out[f"step_sibs_{s}"] = (batch, tpl.num_queries, st["path_len"], 4)
    return {k: np.zeros(shape, dtype=np.uint64) for k, shape in out.items()}


def _flatten_python(tpl, pairs):
    from ..compiler.flatten import flatten_proofs
    from ..types import ProofWithPublicInputs, VerifierOnlyCircuitData

    objs = [
        (
            VerifierOnlyCircuitData.from_json(strict_loads(vk)),
            ProofWithPublicInputs.from_json(strict_loads(pf)),
        )
        for vk, pf in pairs
    ]
    return flatten_proofs(tpl, objs)


def flatten_proof_jsons(
    tpl,
    pairs: Sequence[Tuple[bytes, bytes]],
    workers: int = 0,
) -> Dict[str, np.ndarray]:
    """Native counterpart of compiler.flatten.flatten_proofs taking raw
    (vkey_json, proof_json) byte pairs. `workers` > 1 splits the batch into
    contiguous row chunks parsed on a thread pool (the extension drops the
    GIL for each whole chunk). Falls back to the pure-Python path when the
    native toolchain is unavailable."""
    mod = get_fastload()
    if mod is None:
        return _flatten_python(tpl, pairs)
    shape = shape_descriptor(tpl)
    out = alloc_batch_arrays(tpl, len(pairs))
    pairs = [(bytes(vk), bytes(pf)) for vk, pf in pairs]

    n = len(pairs)
    if workers and workers > 1 and n > 1:
        from concurrent.futures import ThreadPoolExecutor

        k = min(workers, n)
        step = -(-n // k)
        chunks = [(i, pairs[i : i + step]) for i in range(0, n, step)]
        with ThreadPoolExecutor(max_workers=k) as ex:
            futs = [ex.submit(mod.flatten_rows, shape, out, s, c) for s, c in chunks]
            for f in futs:
                f.result()
    else:
        mod.flatten_rows(shape, out, 0, pairs)
    return out
