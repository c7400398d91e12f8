"""Whole forwards on the card at the benchmark's shapes: the standard
fibonacci fixture (degree 12, 28 queries, PoW 16) at batch 1024 and the
gate zoo with lookups at batches 512 and 1024, each through TorchVerifier
on the kernels. Every honest lane accepted; lane 0's challenges equal
golden/'s (tools/shape_circuits.transcript_equals_golden); one word of an
array flipped a lane (bench.FAULTED, and for the zoo a lookup opening
inside openings1) rejected on exactly those lanes; and every launch counter
of one forward as the forward makes them: the scan, the public-input
sponge and the grouped sponge once, the Merkle walk once a path, the Horner
sum 7 times, every exponentiation and every inversion in one launch each,
the gate program once, every fold step in one coset-fold launch, L0 with
the partial products once, the lookup argument once where the template
has lookups, the gate filter once. The standard shape counts 2,774
Poseidon permutations a proof. Tolerance: none.

The fixtures are proved once into fixtures/ (models.cache), minutes on the
host's CPU where none is cached. These tests need a CUDA device and nvcc;
without them they skip. This file imports no JAX, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_forward_card.py
"""

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu_torch.bench import FAULTED, fault_lanes, lookup_opening_column
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.metrics import perms_per_proof
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
from plonky2_verifier_tpu_torch.tools.probe_kernels import STANDARD, ZOO
from plonky2_verifier_tpu_torch.tools.shape_circuits import transcript_equals_golden
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier, verify_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def lib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plonky2_verifier_tpu_torch import kernels

    return kernels.load()


def launches_of_a_forward(tpl) -> dict:
    """Every counter of kernels.COUNTERS as one forward of `tpl` makes it."""
    merkle = (1 if tpl.initial_path_len else 0) + sum(1 for st in tpl.steps if st["path_len"])
    return {"permutation": 0, "permutation_scan": 1, "sponge_rows": 1, "sponge_rows_grouped": 1, "merkle_fold": merkle, "horner": 7,
            "inv_grouped": 1, "pow_grouped": 1, "gate_program": 1, "coset_fold": 1 if tpl.steps else 0, "partial_products": 1,
            "lookup_checks": 1 if tpl.common.num_lookup_polys else 0, "gate_filter": 1 if tpl.common.num_gate_constraints else 0}


def check_forward(lib, name: str, params: dict, batch: int, faults):
    """One forward of `batch` copies of the fixture's proof on the card,
    then the faults of `faults` one a lane through verify_batch."""
    common, vkey, pwp = get_fixture_proof(name, **params)
    tpl = CircuitTemplate(common)
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * batch)
    v = TorchVerifier(tpl, debug=True)
    dev = v.prepare(arrays)
    lib.reset_launches()
    with torch.no_grad():
        out = v(dev)
    torch.cuda.synchronize()
    assert lib.launches == launches_of_a_forward(tpl)
    assert v.to_host(out).tolist() == [True] * batch
    transcript_equals_golden(common, out["debug"], 0, vkey, pwp)
    ok = verify_batch(tpl, fault_lanes(arrays, batch, list(enumerate(faults))))["ok"]
    assert np.flatnonzero(~ok).tolist() == list(range(len(faults)))
    return tpl


def test_the_standard_fixture_at_1024(lib):
    tpl = check_forward(lib, "fibonacci", STANDARD, 1024, list(FAULTED))
    assert (tpl.degree_bits, tpl.num_queries, tpl.pow_bits, perms_per_proof(tpl)) == (12, 28, 16, 2774)
    assert tpl.steps and not tpl.common.num_lookup_polys


@pytest.mark.parametrize("batch", [512, 1024])
def test_the_gate_zoo_with_its_lookup_lane(lib, batch):
    common = get_fixture_proof("gate_zoo", **ZOO)[0]
    tpl = check_forward(lib, "gate_zoo", ZOO, batch, list(FAULTED) + [("openings1", lookup_opening_column(CircuitTemplate(common)))])
    assert tpl.n_lookup and len({g.kind for g in tpl.common.gates}) == 16
