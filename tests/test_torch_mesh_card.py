"""The mesh of processes on the card: two ranks that share CUDA device 0,
joined by gloo, against the same mesh on the CPU. Verdicts per lane, the
gathered vector and the count must be equal; every rank must have launched
each kernel. Tolerance: none.

These tests need a CUDA device and nvcc; without them they skip. This file
imports no JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_card.py
"""

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
from plonky2_verifier_tpu_torch.parallel import run_ranks, verify_sharded
from plonky2_verifier_tpu_torch.prover.prove import prove
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda


def launches_of_a_sharded_call(common, arrays, dp, qp):
    """One rank: its sharded verification on the card, and the kernel
    library's launch counters over that call alone."""
    from plonky2_verifier_tpu_torch import kernels

    lib = kernels.load()
    lib.reset_launches()
    res = verify_sharded(common, arrays, dp, qp, None)
    torch.cuda.synchronize()
    return dict(res, launches=dict(lib.launches))


@pytest.fixture(scope="module")
def batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fx = fibonacci_fixture(num_query_rounds=6)
    tpl = CircuitTemplate(fx.common)
    proofs = [prove(fibonacci_fixture(num_query_rounds=6, x0=a, x1=b)) for a, b in [(1, 2), (3, 5), (10, 11), (7, 1)]]
    arrays = flatten_proofs(tpl, proofs * 2)
    arrays["pow_witness"][1] ^= np.uint64(1)
    arrays["leaves_1"][6, 0, 0] ^= np.uint64(1)  # query round 0: one half of a qp row sees it
    from plonky2_verifier_tpu_torch import kernels

    kernels.load()  # built here, so that no rank is the one that builds
    return fx.common, arrays


@pytest.mark.parametrize("dp,qp", [(2, 1), (1, 2)])
def test_two_ranks_on_one_card_equal_the_cpu_mesh(batch, dp, qp):
    common, arrays = batch
    on_cpu = run_ranks(verify_sharded, 2, (common, arrays, dp, qp, "cpu"), threads=1, timeout_s=300)
    on_card = run_ranks(launches_of_a_sharded_call, 2, (common, arrays, dp, qp), timeout_s=300)
    want = [i not in (1, 6) for i in range(8)]
    for cpu, card in zip(on_cpu, on_card):
        assert card["gathered"] == cpu["gathered"] == want
        assert card["ok"] == cpu["ok"] and card["n_valid"] == cpu["n_valid"] == 6
        n = card["launches"]
        assert (n["permutation_scan"], n["sponge_rows"], n["sponge_rows_grouped"]) == (1, 1, 1) and n["merkle_fold"] >= 1
