"""Entry points of the port, the counterpart of __graft_entry__.py.

- entry(): the single-device forward step on the flagship model, the
  batched verifier on the fibonacci circuit template, with example arguments.
- dryrun_multichip(n): starts n processes, lays them out as a ('dp', 'qp')
  mesh, runs the sharded verification step once on tiny shapes (proof batch
  over 'dp', FRI query rounds over 'qp', the verdict count summed over the
  mesh) and checks every rank's answer.

    python3 -c "from plonky2_verifier_tpu_torch import graft_entry as g; g.dryrun_multichip(4)"

Both run on the CUDA cards unless the caller gives device="cpu", and raise
where the cards are missing.
"""

import copy

import torch


def _build(num_query_rounds: int, batch: int):
    from .compiler import CircuitTemplate, flatten_proofs
    from .models.cache import get_fixture_proof

    common, vkey, pwp = get_fixture_proof("fibonacci", num_query_rounds=num_query_rounds)
    tpl = CircuitTemplate(common)
    return tpl, flatten_proofs(tpl, [(vkey, pwp)] * batch)


def entry(device=None):
    """-> (fn, example_args): the batched verification step on `device` (the
    CUDA card unless given) and a prepared batch of 4 proofs for it."""
    from .verifier_torch import TorchVerifier

    tpl, arrays = _build(num_query_rounds=8, batch=4)
    v = TorchVerifier(tpl, device=device)
    return v.forward, (v.prepare(arrays),)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """`n_devices` processes of this host as a dp x qp mesh (qp = 2 where
    n_devices is even): rank r on CUDA card r, joined by NCCL, and an error
    where the host has fewer cards than ranks; with device="cpu" on the CPU,
    joined by gloo."""
    from .compiler import CircuitTemplate, flatten_proofs
    from .golden import field as gf
    from .models.fibonacci import fibonacci_fixture
    from .parallel import run_ranks, verify_sharded
    from .prover.prove import prove

    on_cpu = device is not None and torch.device(device).type == "cpu"
    if device is not None and not on_cpu:
        raise ValueError(f'device must be None (rank r on CUDA card r) or "cpu", got {device!r}')
    if not on_cpu and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f'{n_devices} ranks need a CUDA card each and this host has {torch.cuda.device_count()}; device="cpu" runs them on the CPU')
    qp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // qp

    # Heterogeneous batch: every lane carries a distinct transcript (distinct
    # (x0, x1) over the same circuit shape), and two lanes are corrupted with
    # different faults, so a rank that reads another rank's lanes, or lanes in
    # another order, changes the per-lane verdict vector.
    batch = 2 * dp
    proved = [prove(fibonacci_fixture(num_query_rounds=8, x0=1 + i, x1=2 + i)) for i in range(min(4, batch))]
    fx = fibonacci_fixture(num_query_rounds=8)
    tpl = CircuitTemplate(fx.common)
    lanes = [copy.deepcopy(proved[i % len(proved)]) for i in range(batch)]
    bad = sorted({1 % batch, (batch // 2) % batch})
    _, b0 = lanes[bad[0]]
    b0.proof.opening_proof.pow_witness ^= 1  # grinding fault
    _, b1 = lanes[bad[-1]]
    re, im = b1.proof.openings.wires[0]
    b1.proof.openings.wires[0] = ((re + 1) % gf.P, im)  # opening fault
    arrays = flatten_proofs(tpl, lanes)

    results = run_ranks(
        verify_sharded, n_devices, (fx.common, arrays, dp, qp, device, qp > 1), backend="gloo" if on_cpu else "nccl", threads=1 if on_cpu else 0
    )
    expect = [i not in bad for i in range(batch)]
    per = batch // dp
    for rank, res in enumerate(results):
        mine = expect[rank // qp * per : (rank // qp + 1) * per]
        if res["ok"] != mine or res["gathered"] != expect:
            raise AssertionError(f"rank {rank}: per-lane verdict mismatch: got {res['ok']} of {res['gathered']}, want {mine} of {expect}")
        if res["n_valid"] != sum(expect):
            raise AssertionError(f"rank {rank}: summed count {res['n_valid']} != {sum(expect)}")
    print(
        f"dryrun_multichip ok: mesh dp={dp} qp={qp}, {batch} heterogeneous lanes, "
        f"{sum(expect)} accepted, rejected lanes {bad} as expected"
    )

