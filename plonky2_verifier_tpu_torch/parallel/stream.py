"""Streaming verification: N >> batch proofs through one TorchVerifier, with
rolling metrics. The counterpart of plonky2_verifier_tpu/parallel/stream.py.

Proofs arrive as (vkey, proof) pairs of ONE circuit shape per
StreamVerifier. The loop packs fixed-size batches and pads the final partial
batch by repeating its last proof; the pad lanes are masked out of the
verdict, so a corrupt last proof counts once.

What overlaps what. A call of TorchVerifier is a long run of Python that
launches small kernels, so it returns only when the device has nearly
finished the batch: an asynchronous dispatch alone hides nothing. `run()`
therefore makes batch k + 1 ready on a thread of its own while the calling
thread verifies batch k (a one-deep prefetch; the native parser and PyTorch's
copies drop the interpreter lock). `submit()` / `flush()` keep the
synchronous form: `submit` makes a batch ready, dispatches it, then folds
the verdict of the batch before it; `flush` folds the last one.

On the card a batch is staged in pinned host buffers (two sets, allocated
once a StreamVerifier) and copied with non_blocking=True on a copy stream
into two sets of device buffers; the compute stream waits on the copy's
event, and the copy stream waits until the verifier call that read the set
before has been enqueued and run. A pinned set is refilled only after the
copy that read it has finished. The verdict returns into a pinned buffer
behind an event of its own, so folding batch k waits for batch k alone.

The metrics in the port (metrics.StreamMetrics) are the calling thread's
own time, so they never overlap and `ingest_s + device_wait_s <= elapsed_s`.
They are summed from the stream's spans (tracing.py, one clock for both
threads; a span enters the tracer's store only while tracing is on): a
batch's "stream.ingest" (on whichever thread makes it ready),
"stream.dispatch" (the verifier call) and "stream.wait" (the verdict), each
carrying the batch's number.
- `ingest_s`: time the calling thread paid for making batches ready (parse
  and flatten, stage, enqueue the copy to the device): all of each
  "stream.ingest" in `submit()`, and in `run()` the part of it that the
  calling thread's wait for the prefetch thread overlaps, so never more.
  `ingest_work_s` (an attribute of the StreamVerifier) is the whole of the
  "stream.ingest" spans, so 1 - ingest_s / ingest_work_s is the share that
  the prefetch hid.
- `device_wait_s`: the "stream.wait" spans, the calling thread blocked on a
  verdict's event.
- `elapsed_s - ingest_s - device_wait_s` is the rest of the calling thread's
  time: the verifier calls, and reading the proofs from their iterator.

Several devices (`mesh=`, a parallel/mesh.Mesh): one process a device, each
running this same loop over the same sequence of items. `batch` stays the
global batch; of each group a rank parses, stages, copies and verifies only
the lanes of its dp shard (and, on a mesh with qp > 1, its share of the
query rounds), and the accepted lanes are summed over the mesh when a batch
is folded, so every rank's metrics hold the global counts. Collectives are
issued by the calling thread alone, in batch order; the prefetch thread makes
none. `init_distributed` joins the process group under PyTorch's standard
environment variables.

Mixed shapes go through BucketedStreamVerifier: items carry their
CommonCircuitData, are grouped by the canonical shape hash, and each bucket
owns a StreamVerifier, built at first sight of its shape; batches dispatch
interleaved as buckets fill. The kernel library is built once a process,
whatever the number of buckets.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Tuple

import torch

from .. import tracing
from ..compiler.flatten import flatten_proofs
from ..compiler.template import CircuitTemplate
from ..metrics import StreamMetrics, perms_per_proof
from ..ops.field import resolve_device
from ..types import CommonCircuitData
from .mesh import Mesh, ShardedVerifier, join_group


def template_key(common: CommonCircuitData) -> str:
    """Canonical shape hash of a circuit: two proofs verify through the same
    template iff their commons serialize identically (the template is a pure
    function of CommonCircuitData)."""
    blob = json.dumps(common.to_json(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def init_distributed(backend: Optional[str] = None, device=None) -> bool:
    """Env-gated start of a run over several processes, one a device.

    Set P2V_DISTRIBUTED=1 plus PyTorch's standard variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) in every process; this joins the process
    group before anything is built on a device, and `make_mesh()` then lays
    the processes out. Returns True when it ran, and False (having touched
    nothing) where the gate is not set; a variable missing under the gate
    raises.

    `backend` is "nccl" where every rank has a card of its own and "gloo"
    on the CPU and where ranks share one card; left out, it is "gloo" for
    device="cpu" and "nccl" otherwise. Under "nccl" the rank takes the card
    `device` names or, without one, card LOCAL_RANK (RANK where that is not
    set), and raises where this host has no such card."""
    if os.environ.get("P2V_DISTRIBUTED") != "1":
        return False
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK") if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"P2V_DISTRIBUTED=1 needs {', '.join(missing)} in the environment")
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = None if device is None else torch.device(device)
    if backend is None:
        backend = "gloo" if dev is not None and dev.type == "cpu" else "nccl"
    index = dev.index if dev is not None and dev.type == "cuda" else None
    if index is None and backend == "nccl":
        index = int(os.environ.get("LOCAL_RANK", rank))
    if index is not None:
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs CUDA device {index}; this host has {torch.cuda.device_count()}")
        torch.cuda.set_device(index)
    join_group(backend, f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", rank, world_size)
    return True


def paid_ns(ingest, waited: Optional[Tuple[int, int]]) -> int:
    """What the calling thread paid of a batch's "stream.ingest" span: the
    part of it that its wait (host ns, from and to) overlaps, or all of it
    where it made the batch itself (`waited` None)."""
    if waited is None:
        return ingest.host_end - ingest.host_start
    return max(0, min(waited[1], ingest.host_end) - max(waited[0], ingest.host_start))


class _CardStaging:
    """Two sets of pinned host buffers, device buffers and verdict buffers
    for one template and batch size, and the streams and events that order
    their use (the module docstring says which waits on which)."""

    SETS = 2

    def __init__(self, shapes: dict, device: torch.device):
        batch = shapes["pow_witness"][0]
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.pinned = [
            {k: torch.empty(s, dtype=torch.int64, pin_memory=True) for k, s in shapes.items()} for _ in range(self.SETS)
        ]
        self.on_card = [
            {k: torch.empty(s, dtype=torch.int64, device=device) for k, s in shapes.items()} for _ in range(self.SETS)
        ]
        self.verdict = [torch.empty((batch,), dtype=torch.bool, pin_memory=True) for _ in range(self.SETS)]
        self.copied = [torch.cuda.Event() for _ in range(self.SETS)]  # the set's copy to the card has finished
        self.consumed = [torch.cuda.Event() for _ in range(self.SETS)]  # the call that read the set has run
        self.judged = [torch.cuda.Event() for _ in range(self.SETS)]  # the set's verdict is in its pinned buffer

    def load(self, arrays, slot: int):
        """Host arrays -> the device buffers of `slot`, copied on the copy
        stream; returns them. May run on another thread than the verifier."""
        pinned, on_card = self.pinned[slot], self.on_card[slot]
        if sorted(arrays) != sorted(pinned):
            raise ValueError(f"arrays {sorted(arrays)} do not match the template's {sorted(pinned)}")
        self.copied[slot].synchronize()  # the copy that last read this pinned set has finished
        for k, a in arrays.items():
            if tuple(a.shape) != tuple(pinned[k].shape):
                raise ValueError(f"{k} has shape {a.shape}, expected {tuple(pinned[k].shape)}")
            pinned[k].copy_(torch.from_numpy(a.view("int64")))
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.consumed[slot])  # the device set is free again
            for k in pinned:
                on_card[k].copy_(pinned[k], non_blocking=True)
            self.copied[slot].record()
        return on_card

    def call(self, verifier, dev, slot: int, queries=None):
        """Run `verifier` on the loaded set behind its copy, and enqueue the
        verdict's way back; returns a function that waits for this batch
        alone and gives its `ok` lanes."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.copied[slot])
        out = verifier(dev, queries=queries)
        self.consumed[slot].record(stream)
        ok = verifier.to_host(out, into=self.verdict[slot])
        self.judged[slot].record(stream)

        def wait():
            self.judged[slot].synchronize()
            return ok.copy()

        return wait


class StreamVerifier:
    """Fixed-shape streaming loop around TorchVerifier.

    `raw_json=True` streams (vkey_json_bytes, proof_json_bytes) pairs
    through the native C++ ingest (plonky2_verifier_tpu_torch.native,
    `ingest_workers` threads that hold no interpreter lock) instead of parsed
    dataclasses. `device=None` means the CUDA card and raises where there is
    none; the tests pass "cpu". With `mesh` (a parallel/mesh.Mesh) this
    process is one rank of a mesh of processes: `batch` is the global batch,
    every rank must be given the same sequence of items, and each verifies
    its own lanes of every group (the module docstring says more). Without
    `ingest_workers` the parser takes the host's cores, divided by the
    mesh's processes on this host."""

    def __init__(
        self,
        tpl: CircuitTemplate,
        batch: int,
        mesh=None,
        shard_queries: bool = True,
        raw_json: bool = False,
        ingest_workers: int = 0,
        device=None,
    ):
        from ..native import alloc_batch_arrays

        self.tpl = tpl
        self.batch = batch
        self.raw_json = raw_json
        self.mesh = mesh if mesh is not None else Mesh()  # a world of one: no collective
        self.ingest_workers = ingest_workers or max(1, (os.cpu_count() or 1) // self.mesh.local_world_size)
        self.device = resolve_device(device)
        self._sharded = ShardedVerifier(tpl, self.mesh, shard_queries=shard_queries, device=self.device)
        self._v = self._sharded.inner
        self._lanes = self._sharded.lanes(batch)  # this rank's lanes of every group
        self._staging = None
        if self.device.type == "cuda":
            one = self._sharded.cut_queries(alloc_batch_arrays(tpl, 1))
            per_rank = self._lanes.stop - self._lanes.start
            self._staging = _CardStaging({k: (per_rank,) + a.shape[1:] for k, a in one.items()}, self.device)
        self._staged = 0  # batches made ready so far; picks the buffer set
        self.metrics = StreamMetrics(
            perms_per_proof=perms_per_proof(tpl), queries_per_proof=tpl.num_queries
        )
        self.ingest_work_s = 0.0  # making batches ready, on whichever thread; metrics.ingest_s is the part the caller paid
        self._pending = None  # (wait for the ok lanes, live, batch number) dispatched but not folded yet

    def _batches(self, proofs: Iterable[Tuple]) -> Iterator[Tuple[list, int]]:
        buf: list = []
        for p in proofs:
            buf.append(p)
            if len(buf) == self.batch:
                yield buf, self.batch
                buf = []
        if buf:
            live = len(buf)
            buf = buf + [buf[-1]] * (self.batch - live)  # pad: masked below
            yield buf, live

    def _flatten(self, group: list):
        if self.raw_json:
            from ..native import flatten_proof_jsons

            return flatten_proof_jsons(self.tpl, group, workers=self.ingest_workers)
        return flatten_proofs(self.tpl, group)

    def _ingest(self, group: list):
        """Make one full-size batch ready on the device: flatten, stage, start
        the copy. Returns (device arrays, buffer set, its "stream.ingest"
        span, proofs). Runs on the prefetch thread in run()."""
        number = self._staged
        self._staged += 1
        with tracing.Span("stream.ingest", number) as span:
            arrays = self._sharded.cut_queries(self._flatten(group[self._lanes]))
            slot = number % _CardStaging.SETS
            dev = self._v.prepare(arrays) if self._staging is None else self._staging.load(arrays, slot)
        return dev, slot, span, len(group)

    def _dispatch(self, ready, live: int, on_batch, waited: Optional[Tuple[int, int]] = None) -> None:
        """`waited`: the calling thread's wait for `ready` (host ns, from and
        to), of which the part inside its "stream.ingest" was paid; without
        it the whole span was."""
        dev, slot, span, n = ready
        self.ingest_work_s += span.host_s
        self.metrics.record_ingest(paid_ns(span, waited) / 1e9, n)
        with torch.no_grad(), tracing.span("stream.dispatch", span.request):
            if self._staging is None:
                out = self._v(dev, queries=self._sharded.queries)
                wait = lambda: self._v.to_host(out)
            else:
                wait = self._staging.call(self._v, dev, slot, self._sharded.queries)
        if self._pending is not None:
            self._fold(self._pending, on_batch)
        self._pending = (wait, live, span.request)

    def submit(self, group: list, live: int, on_batch=None) -> None:
        """Make one full-size batch ready and dispatch it; folds the previous
        batch's verdict once this one is enqueued."""
        self._dispatch(self._ingest(group), live, on_batch)

    def flush(self, on_batch=None) -> None:
        """Block on the last in-flight batch and fold its verdict."""
        if self._pending is not None:
            self._fold(self._pending, on_batch)
            self._pending = None

    def warm_up(self, group: list) -> float:
        """Verify one group of `batch` items outside the metrics: a
        process's first call pays the kernels' first launches and the
        template's constants, which a server pays once. On a mesh every rank
        calls it with the same group, and it returns once every rank has.
        The metrics start anew after it. Returns its seconds."""
        if len(group) != self.batch:
            raise ValueError(f"a warm-up group has {self.batch} items, not {len(group)}")
        t0 = time.time()
        dev, slot, _, _ = self._ingest(group)
        with torch.no_grad():
            if self._staging is None:
                self._v.to_host(self._v(dev, queries=self._sharded.queries))
            else:
                self._staging.call(self._v, dev, slot, self._sharded.queries)()
        if self.mesh.world_size > 1:
            torch.distributed.barrier()
        self.metrics = StreamMetrics(perms_per_proof=self.metrics.perms_per_proof, queries_per_proof=self.metrics.queries_per_proof)
        return time.time() - t0

    def run(
        self,
        proofs: Iterable[Tuple],
        on_batch: Optional[Callable[[StreamMetrics], None]] = None,
    ) -> StreamMetrics:
        """Verify a stream; returns the final metrics. `on_batch(metrics)`
        fires after each batch's verdict lands (for progress lines). Batch
        k + 1 is made ready on a prefetch thread while batch k verifies."""

        def dispatch(ahead):
            future, live = ahead
            t0 = time.time_ns()
            ready = future.result()
            self._dispatch(ready, live, on_batch, waited=(t0, time.time_ns()))

        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="p2v-ingest") as pool:
            ahead = None
            for group, live in self._batches(proofs):
                future = pool.submit(self._ingest, group)
                if ahead is not None:
                    dispatch(ahead)
                ahead = (future, live)
            if ahead is not None:
                dispatch(ahead)
        self.flush(on_batch)
        return self.metrics

    def _fold(self, pending, on_batch) -> None:
        wait, live, number = pending
        with tracing.Span("stream.wait", number) as span:
            ok = wait()
        self.metrics.record_device_wait(span.host_s)
        # this rank's live lanes of a padded last batch; a rank with none still joins the collectives
        mine = min(max(live - self._lanes.start, 0), len(ok))
        if self._sharded.shard_queries:
            ok = self.mesh.and_over_queries(torch.from_numpy(ok)).cpu().numpy()
        self.metrics.record_batch(live, self.mesh.sum_over_shards(int(ok[:mine].sum())))
        if on_batch is not None:
            on_batch(self.metrics)


class BucketedStreamVerifier:
    """Mixed-shape streaming: items are (common, vkey, proof) triples; they
    bucket by `template_key(common)` and each bucket runs its own
    per-template StreamVerifier on `device`. A bucket's verifier is built at
    first sight of its shape, batches dispatch interleaved as buckets fill,
    and partial buckets pad+flush at end-of-stream exactly like the
    single-shape loop. With `raw_json=True` the vkey/proof slots carry JSON
    bytes for the native ingest (common stays a parsed object — it is the
    bucket key). `mesh` goes to every bucket's StreamVerifier: every rank
    reads the same items, so the buckets fill and fold in the same order on
    all of them."""

    def __init__(
        self,
        batch: int,
        mesh=None,
        shard_queries: bool = True,
        raw_json: bool = False,
        ingest_workers: int = 0,
        device=None,
    ):
        self.batch = batch
        self.mesh = mesh
        self.shard_queries = shard_queries
        self.raw_json = raw_json
        self.ingest_workers = ingest_workers
        self.device = resolve_device(device)
        self._buckets: dict = {}  # key -> (StreamVerifier, buffer list)

    def _bucket(self, common: CommonCircuitData):
        key = template_key(common)
        if key not in self._buckets:
            sv = StreamVerifier(
                CircuitTemplate(common),
                self.batch,
                mesh=self.mesh,
                shard_queries=self.shard_queries,
                raw_json=self.raw_json,
                ingest_workers=self.ingest_workers,
                device=self.device,
            )
            self._buckets[key] = (sv, [])
        return key, self._buckets[key]

    def run(
        self,
        items: Iterable[Tuple],
        on_batch: Optional[Callable[[str, StreamMetrics], None]] = None,
    ) -> dict:
        """Verify a mixed stream; returns {shape_key: StreamMetrics}.
        `on_batch(shape_key, metrics)` fires per folded batch."""
        for common, vkey, proof in items:
            key, (sv, buf) = self._bucket(common)
            buf.append((vkey, proof))
            if len(buf) == self.batch:
                cb = (lambda m, k=key: on_batch(k, m)) if on_batch else None
                sv.submit(list(buf), self.batch, cb)
                buf.clear()
        for key, (sv, buf) in self._buckets.items():
            cb = (lambda m, k=key: on_batch(k, m)) if on_batch else None
            if buf:
                live = len(buf)
                sv.submit(buf + [buf[-1]] * (self.batch - live), live, cb)
                buf.clear()
            sv.flush(cb)
        return {k: sv.metrics for k, (sv, _) in self._buckets.items()}
