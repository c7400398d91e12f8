"""Structured throughput metrics for batch/stream verification.

The reference's only observability is printouts (testmain.hs:40-63) plus an
analytic Poseidon cost model (commentary/FRI.md:250-274). This module keeps
the BASELINE metrics — proofs/s, Poseidon perms/s, FRI queries/s — as
rolling counters, with the analytic per-proof permutation count derived
from the circuit template so measured hash throughput can be cross-checked
against the FRI.md formula.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


def perms_per_proof(tpl) -> int:
    """Analytic Poseidon-permutation count per proof for this template
    (mirrors commentary/FRI.md:250-267: transcript + per-query-round leaf
    sponges, initial Merkle paths, coset-leaf sponges, step paths)."""
    n = len(tpl.schedule.permutes)
    n += -(-tpl.n_pi // 8) if tpl.n_pi else 0
    per_round = 0
    for w in tpl.oracle_widths:
        per_round += -(-w // 8)
    per_round += 4 * tpl.initial_path_len
    for st in tpl.steps:
        per_round += -(-(2 << st["arity_bits"]) // 8)
        per_round += st["path_len"]
    return n + tpl.num_queries * per_round


@dataclass
class StreamMetrics:
    """Rolling counters over a verification stream."""

    perms_per_proof: int
    queries_per_proof: int
    window: float = 5.0  # seconds per rolling-rate window
    t_start: float = field(default_factory=time.time)
    proofs: int = 0
    accepted: int = 0
    rejected: int = 0
    batches: int = 0
    _win_t0: float = field(default_factory=time.time)
    _win_proofs: int = 0
    _t_first_fold: float = 0.0  # end of batch 0 = compile done
    _proofs_first: int = 0
    # where stream wall time goes: host-side flatten/ingest vs blocking on
    # the device verdict (dispatch itself is async and ~free)
    ingest_s: float = 0.0
    device_wait_s: float = 0.0
    _ingest_proofs: int = 0

    def record_ingest(self, dt: float, n_proofs: int) -> None:
        self.ingest_s += dt
        self._ingest_proofs += n_proofs

    def record_device_wait(self, dt: float) -> None:
        self.device_wait_s += dt

    def record_batch(self, n_proofs: int, n_accepted: int) -> None:
        self.proofs += n_proofs
        self.accepted += n_accepted
        self.rejected += n_proofs - n_accepted
        self.batches += 1
        self._win_proofs += n_proofs
        if self.batches == 1:
            self._t_first_fold = time.time()
            self._proofs_first = n_proofs

    def rolling_rate(self) -> float:
        """proofs/s over the current window; resets the window when read
        past its length."""
        dt = time.time() - self._win_t0
        rate = self._win_proofs / dt if dt > 0 else 0.0
        if dt >= self.window:
            self._win_t0 = time.time()
            self._win_proofs = 0
        return rate

    def snapshot(self) -> dict:
        dt = max(time.time() - self.t_start, 1e-9)
        pps = self.proofs / dt
        # steady-state rate: exclude batch 0, whose wall time is dominated
        # by the one-per-shape XLA compile (cold-start vs steady-state)
        steady = 0.0
        if self.batches > 1:
            sdt = max(time.time() - self._t_first_fold, 1e-9)
            steady = (self.proofs - self._proofs_first) / sdt
        ing = {}
        if self._ingest_proofs:
            ing = {
                "ingest_s": round(self.ingest_s, 3),
                "device_wait_s": round(self.device_wait_s, 3),
                "ingest_ms_per_proof": round(self.ingest_s / self._ingest_proofs * 1000, 3),
                # share of stream wall time spent in host-side ingest: ~1.0
                # means the host starves the device, ~0.0 means device-bound
                "ingest_utilization": round(self.ingest_s / dt, 3),
            }
        return {
            "steady_proofs_per_sec": round(steady, 2),
            **ing,
            "proofs": self.proofs,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "batches": self.batches,
            "elapsed_s": round(dt, 3),
            "proofs_per_sec": round(pps, 2),
            "poseidon_perms_per_sec": round(pps * self.perms_per_proof, 1),
            # 3 decimals: tiny test streams have sub-1.0 rates, and 1-decimal
            # rounding put the derived rate outside a 1% cross-check band
            "fri_queries_per_sec": round(pps * self.queries_per_proof, 3),
        }

    def line(self) -> str:
        return json.dumps(self.snapshot())
