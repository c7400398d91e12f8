"""Sharded batched verification over several devices, one process a device.

The counterpart of plonky2_verifier_tpu/parallel/mesh.py. There one program
spans every device and the compiler inserts the collectives; a call of
TorchVerifier is a long run of Python that launches small kernels, so one
interpreter cannot feed two cards. Here every device has a process of its
own, the processes are joined by torch.distributed, and the few collectives
are written out.

Axes, as in the JAX module:
- 'dp': proof-batch data parallelism. Every proof array has the batch as its
  leading dimension; dp shard i holds lanes [i B/dp, (i + 1) B/dp).
- 'qp': FRI query-round parallelism within a proof. Query rounds are
  independent once the challenges are derived, so the per-query arrays are
  cut on their Q axis; the transcript and the Plonk checks run whole on every
  rank of a qp row, and the AND of the row's verdicts is the only collective
  across 'qp'.

Rank r sits at (dp_index, qp_index) = divmod(r, qp), the layout of
np.array(devices).reshape(dp, qp). The verdict summary `n_valid` is a sum
over the whole mesh in which each dp shard counts once.

A world of one process needs no process group and makes no collective call.
`verify_sharded` is the whole of it in one call. `join_group` brings a
process into a group under an address, a world size and a rank that the
caller gives; `run_ranks` starts a group of processes on this host and
collects what each returns.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.template import CircuitTemplate
from ..ops.field import resolve_device
from ..verifier_torch import TorchVerifier, is_query_axis_array

COLLECTIVE_TIMEOUT_S = 120  # a rank that died fails the others' next collective instead of hanging them


class Mesh:
    """This process's place in a dp x qp mesh of processes, and the
    collectives the sharded verifier needs. `row_group` is this rank's qp
    row (the ranks that hold the same lanes); sums and gathers go over the
    default group. With the gloo backend the collectives take host tensors,
    with NCCL tensors on this rank's card: which one is what the caller
    named when it initialised the process group, and `wire_device` is where
    that puts them (the stream folds verdicts that are already on the host:
    under NCCL those few bytes go to the card and back). `Mesh()` is a world
    of one, which makes no collective call."""

    def __init__(self, dp: int = 1, qp: int = 1, rank: int = 0, world_size: int = 1, backend: Optional[str] = None, row_group=None,
                 local_world_size: int = 1, wire_device=None):
        self.dp, self.qp, self.rank, self.world_size = dp, qp, rank, world_size
        self.dp_index, self.qp_index = divmod(rank, qp)
        self.shape = {"dp": dp, "qp": qp}
        self.backend = backend
        self.row_group = row_group
        self.local_world_size = local_world_size  # the processes of this mesh on this host
        self.wire_device = wire_device  # where a collective's tensors lie; make_mesh sets it from the backend

    def __repr__(self):
        return f"Mesh(dp={self.dp}, qp={self.qp}, rank={self.rank} at ({self.dp_index}, {self.qp_index}), backend={self.backend})"

    def _on_the_wire(self, t: torch.Tensor) -> torch.Tensor:
        if self.backend is None or self.wire_device is None:
            raise RuntimeError(f"a mesh of {self.world_size} processes needs an initialised process group (join_group, init_distributed)")
        return t.to(self.wire_device)

    def and_over_queries(self, ok: torch.Tensor) -> torch.Tensor:
        """bool (n,), this rank's share of its lanes' verdicts -> bool (n,),
        the AND over this rank's qp row (gloo reduces no bool: a MIN of bytes)."""
        if self.qp == 1:
            return ok
        lanes = self._on_the_wire(ok.to(torch.uint8))
        dist.all_reduce(lanes, op=dist.ReduceOp.MIN, group=self.row_group)
        return lanes.bool()

    def sum_over_shards(self, count: int) -> int:
        """The sum of `count` over the mesh, each dp shard counted once: the
        ranks of a qp row hold the same lanes, so only its first rank adds."""
        if self.world_size == 1:
            return count
        total = self._on_the_wire(torch.tensor([count if self.qp_index == 0 else 0], dtype=torch.int64))
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return int(total[0])

    def gather_lanes(self, ok: torch.Tensor) -> torch.Tensor:
        """bool (n,), this rank's lanes -> bool (dp n,), every lane of the
        global batch in lane order, the same on every rank."""
        if self.world_size == 1:
            return ok
        mine = self._on_the_wire(ok.to(torch.uint8))
        parts = [torch.empty_like(mine) for _ in range(self.world_size)]
        dist.all_gather(parts, mine)
        return torch.cat(parts[:: self.qp]).bool()


def make_mesh(dp: Optional[int] = None, qp: int = 1, *, rank: Optional[int] = None, world_size: Optional[int] = None) -> Mesh:
    """This process's Mesh. `rank` and `world_size` default to the
    initialised process group's and, with no group initialised, to a world of
    one; `dp` defaults to world_size // qp. Every rank of a group must call
    this with the same dp and qp: it creates the process group of every qp
    row, on every rank, in the same order."""
    grouped = dist.is_available() and dist.is_initialized()
    if grouped:
        if (rank, world_size) not in ((None, None), (dist.get_rank(), dist.get_world_size())):
            raise ValueError(
                f"rank {rank} of {world_size} given, but the process group says {dist.get_rank()} of {dist.get_world_size()}"
            )
        rank, world_size = dist.get_rank(), dist.get_world_size()
    elif world_size is None:
        rank, world_size = 0, 1
    elif rank is None or not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not one of a world of {world_size}")
    if dp is None:
        dp = world_size // qp
    if dp * qp != world_size:  # the JAX module's error, for the same mistake
        raise ValueError(f"mesh {dp}x{qp} does not cover {world_size} devices")
    row_group = None
    if grouped and qp > 1:
        for row in range(dp):  # every rank creates every group, its own or not
            group = dist.new_group(ranks=list(range(row * qp, (row + 1) * qp)))
            if row == rank // qp:
                row_group = group
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = wire_device = None
    if grouped:
        backend = dist.get_backend()
        # gloo takes host tensors, NCCL tensors on the card this rank set before it joined
        wire_device = torch.device("cpu") if backend == "gloo" else torch.device("cuda", torch.cuda.current_device())
    return Mesh(dp, qp, rank, world_size, backend, row_group, local, wire_device)


class ShardedVerifier:
    """A TorchVerifier on this rank's device (`.inner`) that verifies this
    rank's share of a global batch: the lanes of its dp shard and, with
    `shard_queries` on a mesh of qp > 1, its share of the query rounds."""

    def __init__(self, tpl: CircuitTemplate, mesh: Mesh, shard_queries: bool = True, device=None):
        self.tpl = tpl
        self.mesh = mesh
        self.inner = TorchVerifier(tpl, device=resolve_device(device))
        self.shard_queries = shard_queries and mesh.qp > 1
        self.queries = None  # this rank's query rounds, or None for all of them
        if self.shard_queries:
            if tpl.num_queries % mesh.qp:
                raise ValueError(f"{tpl.num_queries} query rounds do not split over qp = {mesh.qp}")
            per = tpl.num_queries // mesh.qp
            self.queries = slice(mesh.qp_index * per, (mesh.qp_index + 1) * per)

    def lanes(self, batch: int) -> slice:
        """This rank's lanes of a global batch of `batch`."""
        if batch % self.mesh.dp:
            raise ValueError(f"a batch of {batch} does not split over dp = {self.mesh.dp}")
        per = batch // self.mesh.dp
        return slice(self.mesh.dp_index * per, (self.mesh.dp_index + 1) * per)

    def cut_queries(self, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Host arrays of this rank's lanes -> the same with the per-query
        arrays cut to this rank's query rounds (contiguous copies)."""
        if self.queries is None:
            return arrays
        return {k: np.ascontiguousarray(a[:, self.queries]) if is_query_axis_array(k) else a for k, a in arrays.items()}

    def shard_arrays(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The global host batch (every process holds all of it) -> this
        rank's lanes and query rounds as tensors on its device."""
        lanes = self.lanes(len(arrays["pow_witness"]))
        return self.inner.prepare(self.cut_queries({k: a[lanes] for k, a in arrays.items()}))

    def __call__(self, sharded_arrays):
        """-> {"ok": bool (B/dp,), this rank's lanes after the AND over its
        qp row, "n_valid": the accepted lanes of the whole mesh}, the count
        the same on every rank."""
        with torch.no_grad():
            out = self.inner(sharded_arrays, queries=self.queries)
        ok = self.mesh.and_over_queries(out["ok"]) if self.shard_queries else out["ok"]
        return {"ok": ok, "n_valid": self.mesh.sum_over_shards(int(ok.sum()))}

    def gather(self, ok: torch.Tensor) -> np.ndarray:
        """This rank's lanes `ok` of one call -> the global (B,) verdict in
        lane order, as a numpy array."""
        return self.mesh.gather_lanes(ok).cpu().numpy()


def verify_sharded(common, arrays: Dict[str, np.ndarray], dp: int, qp: int, device=None, shard_queries: bool = True) -> dict:
    """One sharded verification of the global host batch `arrays`, to be
    called by every rank of an initialised process group (or by one process
    alone with dp = qp = 1): lays the ranks out as dp x qp, verifies this
    rank's share and returns {"rank", "ok": this rank's lanes, "gathered":
    every lane of the batch in lane order, "n_valid"} as Python values."""
    mesh = make_mesh(dp, qp)
    sv = ShardedVerifier(CircuitTemplate(common), mesh, shard_queries=shard_queries, device=device)
    out = sv(sv.shard_arrays(arrays))
    return {
        "rank": mesh.rank,
        "ok": out["ok"].cpu().tolist(),
        "gathered": sv.gather(out["ok"]).tolist(),
        "n_valid": out["n_valid"],
    }


# -- joining and starting processes ----------------------------------------------


def join_group(backend: str, init_method: str, rank: int, world_size: int) -> None:
    """Join the default process group. `backend` is the caller's to name:
    "nccl" where every rank has a card of its own, "gloo" on the CPU and
    where ranks share a card (NCCL refuses two ranks a device)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f'backend must be "gloo" or "nccl", got {backend!r}')
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )


def _rank_main(target, args, backend, init_method, rank, world_size, threads, conn):
    if threads:
        torch.set_num_threads(threads)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    if backend == "nccl":  # every rank a card of its own: rank r takes card r
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs CUDA device {rank}; this host has {torch.cuda.device_count()}")
        torch.cuda.set_device(rank)
    join_group(backend, init_method, rank, world_size)
    try:
        conn.send(target(*args))
    finally:
        dist.destroy_process_group()
        conn.close()


def run_ranks(target, world_size: int, args=(), *, backend: str = "gloo", timeout_s: float = 300.0, threads: int = 0) -> list:
    """Run `target(*args)` in `world_size` new processes of this host
    (spawned, never forked), each joined to one process group under a
    rendezvous file of its own, and return what each rank returned, in rank
    order. `target` must be importable by the children. Raises if a rank
    fails or the group takes longer than `timeout_s`, and leaves no process
    behind either way. Under "nccl" rank r takes CUDA card r, and fails where
    there is none. `threads` bounds each child's intra-op threads."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as folder:
        init_method = f"file://{os.path.join(folder, 'rendezvous')}"
        procs, conns = [], []
        for rank in range(world_size):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_rank_main, args=(target, args, backend, init_method, rank, world_size, threads, send))
            proc.start()
            send.close()
            procs.append(proc)
            conns.append(recv)
        results, failed = [None] * world_size, []
        deadline = time.time() + timeout_s
        try:
            pending = dict(zip(conns, range(world_size)))
            while pending and not failed:  # the first rank that fails ends the wait for the others
                ready = multiprocessing.connection.wait(list(pending), max(0.0, deadline - time.time()))
                if not ready:
                    failed.append(f"ranks {sorted(pending.values())} gave no result within {timeout_s} s")
                for conn in ready:
                    rank = pending.pop(conn)
                    try:
                        results[rank] = conn.recv()
                    except EOFError:
                        procs[rank].join(10)
                        failed.append(f"rank {rank} ended without a result (exit code {procs[rank].exitcode})")
            for rank, proc in enumerate(procs):
                if not failed:
                    proc.join(max(0.0, deadline - time.time()))
                    if proc.is_alive():
                        failed.append(f"rank {rank} did not exit within {timeout_s} s")
                    elif proc.exitcode != 0:
                        failed.append(f"rank {rank} exited with code {proc.exitcode}")
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        if failed:
            raise RuntimeError("; ".join(failed))
        return results
