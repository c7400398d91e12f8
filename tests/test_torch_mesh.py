"""The port's several-device layer on the CPU: the query slice of
TorchVerifier.forward, make_mesh, ShardedVerifier and init_distributed
(plonky2_verifier_tpu_torch/parallel). Verdicts are booleans and counts:
tolerance none.

The mesh against JaxVerifier's per-lane truth, in four gloo processes, is in
tests/test_torch_verifier.py (it shares that file's compiled JaxVerifier);
the stream over a mesh is in tests/test_torch_stream.py. Here: one process,
and what needs no second forward. A CPU forward costs seconds whatever the
batch, so the module fixture makes four and every test reads them."""

import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
from plonky2_verifier_tpu_torch.parallel import Mesh, ShardedVerifier, init_distributed, make_mesh, run_ranks
from plonky2_verifier_tpu_torch.verifier_torch import QUERY_AXIS_ARRAYS, TorchVerifier, is_query_axis_array

KEYS = ("ok", "eqs_ok", "fri_ok")


def _cut(arrays, queries):
    return {k: np.ascontiguousarray(a[:, queries]) if is_query_axis_array(k) else a for k, a in arrays.items()}


@pytest.fixture(scope="module")
def sliced():
    """The 8-query fibonacci fixture at batch 4: lane 1 with a flipped
    pow_witness (every slice sees it), lane 2 with a flipped Merkle sibling in
    query round 6 (the second half alone sees it). The whole call, the two
    halves, and the full range given as a slice."""
    common, vkey, pwp = get_fixture_proof("fibonacci", num_query_rounds=8)
    tpl = CircuitTemplate(common)
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * 4)
    arrays["pow_witness"][1] ^= np.uint64(1)
    arrays["sibs_2"][2, 6, 0, 0] ^= np.uint64(1)
    v = TorchVerifier(tpl, device="cpu")
    with torch.no_grad():
        whole = v(v.prepare(arrays))
        lo = v(v.prepare(_cut(arrays, slice(0, 4))), queries=slice(0, 4))
        hi = v(v.prepare(_cut(arrays, slice(4, 8))), queries=slice(4, 8))
        full = v(v.prepare(arrays), queries=slice(0, 8))
    return tpl, arrays, v, whole, lo, hi, full


def test_query_axis_arrays_are_the_jax_modules():
    from plonky2_verifier_tpu.parallel.mesh import _QUERY_AXIS_ARRAYS

    assert QUERY_AXIS_ARRAYS == _QUERY_AXIS_ARRAYS


def test_query_halves_and_to_the_whole(sliced):
    _, _, _, whole, lo, hi, _ = sliced
    assert whole["ok"].tolist() == [True, False, False, True]
    assert (lo["fri_ok"] & hi["fri_ok"]).tolist() == whole["fri_ok"].tolist()
    assert (lo["ok"] & hi["ok"]).tolist() == whole["ok"].tolist()


def test_a_merkle_fault_rejects_in_its_own_half_only(sliced):
    _, _, _, _, lo, hi, _ = sliced
    assert lo["fri_ok"].tolist() == [True, False, True, True]  # the proof of work runs whole in every slice
    assert hi["fri_ok"].tolist() == [True, False, False, True]


@pytest.mark.parametrize("key", KEYS)
def test_the_plonk_checks_run_whole_in_every_slice(sliced, key):
    _, _, _, whole, lo, hi, full = sliced
    assert lo["eqs_ok"].tolist() == hi["eqs_ok"].tolist() == whole["eqs_ok"].tolist()
    assert full[key].tolist() == whole[key].tolist()  # the full range as a slice is the call without one


@pytest.mark.parametrize(
    "queries,cut",
    [(slice(0, 4), slice(0, 3)), (slice(4, 8), slice(0, 8)), (slice(0, 8, 2), slice(0, 4)), (slice(3, 3), slice(0, 0))],
    ids=["short", "whole-arrays", "strided", "empty"],
)
def test_a_mismatched_query_slice_raises(sliced, queries, cut):
    _, arrays, v, *_ = sliced
    with pytest.raises(ValueError, match="quer"):
        v(v.prepare(_cut(arrays, cut)), queries=queries)


def test_make_mesh_shapes_and_places():
    """tests/test_parallel.py::test_mesh_shapes, and every rank's place: the
    layout of np.array(devices).reshape(dp, qp). No process group."""
    assert make_mesh(8, 1, rank=0, world_size=8).shape == {"dp": 8, "qp": 1}
    assert make_mesh(2, 4, rank=0, world_size=8).shape == {"dp": 2, "qp": 4}
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        make_mesh(3, 2, rank=0, world_size=8)
    grid = np.arange(8).reshape(2, 4)
    for rank in range(8):
        m = make_mesh(2, 4, rank=rank, world_size=8)
        assert grid[m.dp_index, m.qp_index] == rank and (m.rank, m.world_size) == (rank, 8)
    assert make_mesh(qp=2, rank=5, world_size=8).shape == {"dp": 4, "qp": 2}  # dp defaults to world_size // qp
    with pytest.raises(ValueError, match="not one of a world"):
        make_mesh(rank=8, world_size=8)


def test_make_mesh_defaults_to_a_world_of_one():
    m = make_mesh()
    assert isinstance(m, Mesh) and m.shape == {"dp": 1, "qp": 1}
    assert (m.rank, m.world_size, m.dp_index, m.qp_index, m.backend, m.row_group) == (0, 1, 0, 0, None, None)


def test_a_world_of_one_equals_torch_verifier_and_calls_no_collective(sliced, monkeypatch):
    tpl, arrays, _, whole, *_ = sliced

    def refuse(*a, **k):
        raise AssertionError("a world of one made a collective call")

    for name in ("all_reduce", "all_gather", "new_group", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    sv = ShardedVerifier(tpl, make_mesh(), device="cpu")
    assert isinstance(sv.inner, TorchVerifier) and sv.queries is None
    out = sv(sv.shard_arrays(arrays))
    assert out["ok"].tolist() == whole["ok"].tolist() and out["n_valid"] == 2
    assert sv.gather(out["ok"]).tolist() == whole["ok"].tolist()


def test_shard_arrays_keeps_this_ranks_lanes_and_queries(sliced):
    """Rank 3 of a 2 x 2 mesh: lanes 2-3, query rounds 4-7 of the per-query
    arrays and every round of the others; shard_queries=False keeps all."""
    tpl, arrays, *_ = sliced
    sv = ShardedVerifier(tpl, make_mesh(2, 2, rank=3, world_size=4), device="cpu")
    assert (sv.lanes(4), sv.queries) == (slice(2, 4), slice(4, 8))
    got = sv.shard_arrays(arrays)
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        want = a[2:4, 4:8] if is_query_axis_array(k) else a[2:4]
        assert got[k].is_contiguous() and np.array_equal(got[k].numpy().view("uint64"), want), k
    assert any(is_query_axis_array(k) for k in arrays)
    whole_rounds = ShardedVerifier(tpl, make_mesh(2, 2, rank=3, world_size=4), shard_queries=False, device="cpu")
    assert whole_rounds.queries is None and whole_rounds.shard_arrays(arrays)["leaves_0"].shape[:2] == (2, 8)


def test_a_batch_or_query_count_that_does_not_split_raises(sliced):
    tpl, arrays, *_ = sliced
    sv = ShardedVerifier(tpl, make_mesh(3, 1, rank=0, world_size=3), device="cpu")
    with pytest.raises(ValueError, match="does not split over dp = 3"):
        sv.shard_arrays(arrays)
    with pytest.raises(ValueError, match="do not split over qp = 3"):
        ShardedVerifier(tpl, make_mesh(1, 3, rank=0, world_size=3), device="cpu")


def test_a_mesh_of_several_needs_a_process_group(sliced):
    tpl, arrays, *_ = sliced
    mesh = make_mesh(2, 1, rank=1, world_size=2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.sum_over_shards(1)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_is_env_gated(monkeypatch):
    for k in ("P2V_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False and not dist.is_initialized()
    monkeypatch.setenv("P2V_DISTRIBUTED", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="MASTER_PORT, RANK"):
        init_distributed(device="cpu")
    assert not dist.is_initialized()


def test_init_distributed_joins_a_world_of_one(monkeypatch):
    env = {"P2V_DISTRIBUTED": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1", "RANK": "0"}
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    try:
        assert init_distributed(device="cpu") is True
        assert dist.is_initialized() and dist.get_backend() == "gloo" and dist.get_world_size() == 1
        m = make_mesh()
        assert (m.shape, m.rank, m.backend) == ({"dp": 1, "qp": 1}, 0, "gloo")
        with pytest.raises(ValueError, match="the process group says"):
            make_mesh(rank=1, world_size=2)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_init_distributed_refuses_an_unknown_backend(monkeypatch):
    env = {"P2V_DISTRIBUTED": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": "1", "WORLD_SIZE": "1", "RANK": "0"}
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    with pytest.raises(ValueError, match="gloo"):
        init_distributed(backend="mpi", device="cpu")
    assert not dist.is_initialized()


def test_init_distributed_names_nccl_and_takes_the_local_ranks_card(monkeypatch):
    """Left to itself init_distributed joins under NCCL with card LOCAL_RANK
    set first, raises where the host has no such card, and takes the card
    and backend the caller names (ranks that share card 2 under gloo). The
    group itself is not joined here: join_group is recorded."""
    from plonky2_verifier_tpu_torch.parallel import stream

    env = {"P2V_DISTRIBUTED": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": "29517", "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"}
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    calls = []
    monkeypatch.setattr(stream, "join_group", lambda *a: calls.append(("join",) + a))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("card", i)))
    assert init_distributed() is True
    assert calls == [("card", 1), ("join", "nccl", "tcp://localhost:29517", 5, 8)]  # the card before the group
    calls.clear()
    assert init_distributed(backend="gloo", device="cuda:2") is True
    assert calls == [("card", 2), ("join", "gloo", "tcp://localhost:29517", 5, 8)]
    calls.clear()
    monkeypatch.delenv("LOCAL_RANK")  # then RANK names the card, and this host has no card 5
    with pytest.raises(RuntimeError, match="rank 5 needs CUDA device 5; this host has 4"):
        init_distributed()
    assert calls == []


def _as_if_grouped(monkeypatch, backend, rank, world_size):
    groups = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda: backend)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: world_size)
    monkeypatch.setattr(dist, "new_group", lambda ranks: groups.append(ranks) or ("group", tuple(ranks)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    return groups


@pytest.mark.parametrize("backend, wire", [("nccl", torch.device("cuda", 3)), ("gloo", torch.device("cpu"))])
def test_make_mesh_puts_the_collectives_tensors_where_the_backend_takes_them(monkeypatch, backend, wire):
    """Rank 1 of a 2 x 2 mesh under each backend (the process group's
    functions replaced): every rank creates every qp row's group in the same
    order and keeps its own; NCCL's tensors go to the card this rank set,
    gloo's stay on the host."""
    groups = _as_if_grouped(monkeypatch, backend, 1, 4)
    m = make_mesh(2, 2)
    assert groups == [[0, 1], [2, 3]] and m.row_group == ("group", (0, 1))
    assert (m.backend, m.wire_device, m.dp_index, m.qp_index) == (backend, wire, 0, 1)
    m.wire_device = torch.device("meta")  # a device this machine has: the move is the one line _on_the_wire is
    assert m._on_the_wire(torch.ones(3, dtype=torch.uint8)).device.type == "meta"


def test_the_collectives_under_nccl_reduce_where_they_should(monkeypatch):
    """Rank 1 of a 2 x 2 mesh named as NCCL's, all_reduce and all_gather
    replaced by the other ranks' answers: the AND is a MIN of bytes over the
    qp row alone, the count adds each dp shard once (this rank, second of its
    row, adds nothing), the gather keeps one rank a row, and every tensor
    handed over lies on the mesh's wire device."""
    m = Mesh(2, 2, rank=1, world_size=4, backend="nccl", row_group="row 0", wire_device=torch.device("cpu"))
    seen = []

    def all_reduce(t, op, group=None):
        assert t.device == m.wire_device
        seen.append((op, group, t.dtype, t.tolist()))
        if op == dist.ReduceOp.MIN:
            t.copy_(torch.minimum(t, torch.tensor([1, 1, 0], dtype=torch.uint8)))  # rank 0 rejects lane 2
        else:
            t += 2 + 1  # rank 0 counts 2, rank 2 counts 1, rank 3 nothing

    def all_gather(parts, t):
        assert t.device == m.wire_device and len(parts) == 4 and all(p.device == t.device and p.dtype == t.dtype for p in parts)
        for p, lanes in zip(parts, ([1, 0, 0], t.tolist(), [0, 1, 1], [0, 1, 1])):
            p.copy_(torch.tensor(lanes, dtype=t.dtype))

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    ok = m.and_over_queries(torch.tensor([True, False, True]))
    assert ok.tolist() == [True, False, False] and ok.dtype == torch.bool
    assert m.sum_over_shards(1) == 3
    assert seen == [(dist.ReduceOp.MIN, "row 0", torch.uint8, [1, 0, 1]), (dist.ReduceOp.SUM, None, torch.int64, [0])]
    assert m.gather_lanes(ok).tolist() == [True, False, False, False, True, True]


def _fail_in_rank_one():
    if dist.get_rank() == 1:
        os._exit(3)
    dist.barrier()  # fails once rank 1 is gone, or is cut by the time limit
    return "unreachable"


def _report_rank():
    return dist.get_rank(), dist.get_world_size(), dist.get_backend(), torch.get_num_threads()


def test_run_ranks_returns_in_rank_order():
    assert run_ranks(_report_rank, 3, threads=1, timeout_s=120) == [(r, 3, "gloo", 1) for r in range(3)]


def test_run_ranks_fails_and_leaves_no_process_when_a_rank_dies():
    import multiprocessing

    with pytest.raises(RuntimeError, match="rank 1 ended without a result"):
        run_ranks(_fail_in_rank_one, 2, threads=1, timeout_s=120)
    assert not multiprocessing.active_children()
