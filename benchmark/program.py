"""The system under test, plonky2_verifier_tpu_torch, driven as a cell's
traffic says. This is the only module of the benchmark that imports the
program, and it takes from it only the verifier, its inputs' layout and its
launch counters.

Set-up builds one `TorchVerifier` for the configuration's circuit, flattens
each distinct input once, and makes the pool of batches on the card by
gathering lanes from them. The window drives `TorchVerifier.__call__` on the
pool's batches in a closed loop with `in_flight` batches enqueued: batch k + 1
is enqueued before the loop waits for batch k's verdict lanes, which are
copied to pinned host memory behind an event.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from cell import VERDICTS


def _u64(t) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


class Program:
    def __init__(self, cell, variants: list, plans: list, device: torch.device, control=None):
        from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
        from plonky2_verifier_tpu_torch.types import CommonCircuitData, ProofWithPublicInputs, VerifierOnlyCircuitData
        from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

        self.device = device
        self.on_card = device.type == "cuda"
        self.batch = cell.traffic["batch"]
        self.in_flight = cell.traffic["in_flight"]
        self.control = control
        self.parts = {}
        t = time.perf_counter()
        self.lib = None
        if self.on_card:
            from plonky2_verifier_tpu_torch import kernels

            self.lib = kernels.load()
        self.parts["library_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tpl = CircuitTemplate(CommonCircuitData.from_json(cell.common))
        inputs = [(VerifierOnlyCircuitData.from_json(v["vkey"]), ProofWithPublicInputs.from_json(v["proof"])) for v in variants]
        arrays = flatten_proofs(tpl, inputs)
        self.parts["flatten_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.v = TorchVerifier(tpl, device=device)
        self.parts["construct_s"] = time.perf_counter() - t
        t = time.perf_counter()
        distinct = self.v.prepare(arrays)
        self.pool = []
        for plan in plans:
            idx = torch.from_numpy(plan.astype(np.int64)).to(device)
            self.pool.append({k: x.index_select(0, idx) for k, x in distinct.items()})
        del distinct
        self.sync()
        self.parts["pool_s"] = time.perf_counter() - t
        self.pinned = [torch.empty((len(VERDICTS), self.batch), dtype=torch.bool, pin_memory=self.on_card)
                       for _ in range(self.in_flight + 1)]

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def enqueue(self, k: int):
        """Enqueue batch k of the loop and the copy of its verdict lanes;
        returns (slot, event)."""
        out = self.v(self.pool[k % len(self.pool)])
        if self.control is not None:
            out = self.control(out, k)
        slot = self.pinned[k % len(self.pinned)]
        for row, key in zip(slot, VERDICTS):  # copies, no kernel of the harness's own
            row.copy_(out[key], non_blocking=self.on_card)
        event = None
        if self.on_card:
            event = torch.cuda.Event()
            event.record()
        return slot, event

    def loop(self, seconds: float = None, batches: int = None) -> list:
        """The closed loop, until `seconds` have passed (then the batches in
        flight are awaited) or for `batches` batches. One record a batch:
        its pool index, when it was due (its dispatch began), when the
        forward returned, when its verdict lanes were on the host, and the
        lanes (3, batch) as bools."""
        records, pending = [], deque()
        t0 = time.perf_counter()
        k = 0
        with torch.no_grad():
            while True:
                due = time.perf_counter()
                if (seconds is not None and due - t0 >= seconds) or (batches is not None and k >= batches):
                    break
                slot, event = self.enqueue(k)
                pending.append({"k": k, "pool": k % len(self.pool), "due": due, "enqueued": time.perf_counter(),
                                "slot": slot, "event": event})
                k += 1
                while len(pending) >= self.in_flight:
                    records.append(self._harvest(pending.popleft()))
            while pending:
                records.append(self._harvest(pending.popleft()))
        return records

    def _harvest(self, rec: dict) -> dict:
        if rec["event"] is not None:
            rec["event"].synchronize()
        rec["done"] = time.perf_counter()
        rec["lanes"] = rec.pop("slot").numpy().copy()
        del rec["event"]
        return rec

    def launches(self) -> dict:
        return dict(self.lib.launches) if self.lib is not None else None

    def challenge_words(self) -> list:
        """Every lane's challenge words of each pool batch, (batch, words)
        uint64, from a debug call of the same verifier outside the window,
        in the order of the reference's `challenge_words`."""
        words = []
        self.v.debug = True
        try:
            with torch.no_grad():
                for dev in self.pool:
                    d = self.v(dev)["debug"]
                    cols = [d["zeta"][0], d["zeta"][1], d["fri_alpha"][0], d["fri_alpha"][1],
                            *d["betas"], *d["gammas"], *d["alphas"]]
                    for delta in d["deltas"]:
                        cols += list(delta)
                    cols.append(d["pow_response"])
                    words.append(np.concatenate([_u64(c).reshape(self.batch, -1) for c in cols]
                                                + [_u64(d["query_indices"]), _u64(d["pi_hash"])], axis=1))
        finally:
            self.v.debug = False
        return words

    def close(self):
        """Free the program's state on the device."""
        self.v = self.pool = self.pinned = None
        if self.on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
