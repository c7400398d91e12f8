"""The port's own copy of the native C++ proof ingest
(plonky2_verifier_tpu_torch.native): it builds into its own _build/, its
arrays equal the JAX package's flatten_proof_jsons and both flatten_proofs,
the thread pool, malformed-input rejection, and the raw-JSON stream tier
through the port's StreamVerifier / BucketedStreamVerifier on the CPU.
Tolerance: none (integers)."""

import json
import os

import numpy as np
import pytest

import plonky2_verifier_tpu.native as ref_native
import plonky2_verifier_tpu_torch.native as native
from plonky2_verifier_tpu.compiler import CircuitTemplate as RefTemplate
from plonky2_verifier_tpu.compiler import flatten_proofs as ref_flatten
from plonky2_verifier_tpu.models.fibonacci import fibonacci_fixture
from plonky2_verifier_tpu.prover.prove import prove
from plonky2_verifier_tpu_torch import types as pt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.native import flatten_proof_jsons, get_fastload
from plonky2_verifier_tpu_torch.parallel.stream import BucketedStreamVerifier, StreamVerifier, template_key


@pytest.fixture(scope="module")
def fib():
    if get_fastload() is None:  # pragma: no cover
        pytest.skip("native toolchain unavailable")
    fx = fibonacci_fixture(num_query_rounds=6)
    vkey, pwp = prove(fx)
    vk_b = json.dumps(vkey.to_json()).encode()
    pf_b = json.dumps(pwp.to_json()).encode()
    common = pt.CommonCircuitData.from_json(fx.common.to_json())
    objs = (pt.VerifierOnlyCircuitData.from_json(json.loads(vk_b)), pt.ProofWithPublicInputs.from_json(json.loads(pf_b)))
    return common, CircuitTemplate(common), objs, (vk_b, pf_b), (RefTemplate(fx.common), (vkey, pwp))


def _assert_equal_arrays(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.uint64 and got[k].shape == ref[k].shape, k
        assert (got[k] == ref[k]).all(), k


def test_port_builds_its_own_binary(fib):
    """The port loads a library from its own native/_build/, never the JAX
    package's, and both can be loaded in one process."""
    port_dir = os.path.dirname(os.path.abspath(native.__file__))
    ref_dir = os.path.dirname(os.path.abspath(ref_native.__file__))
    assert port_dir != ref_dir
    assert os.path.dirname(native._so_path()) == os.path.join(port_dir, "_build")
    assert os.path.dirname(os.path.abspath(get_fastload().__file__)) == os.path.join(port_dir, "_build")
    with open(native._so_path() + ".srchash") as f:
        assert f.read().strip() == native._src_hash(os.path.join(port_dir, "fastload.cpp"))
    ref_mod = ref_native.get_fastload()
    if ref_mod is not None:
        assert ref_mod is not get_fastload()
        assert os.path.dirname(os.path.abspath(ref_mod.__file__)) == os.path.join(ref_dir, "_build")


def test_native_matches_every_flatten(fib):
    common, tpl, objs, raw, (ref_tpl, ref_objs) = fib
    got = flatten_proof_jsons(tpl, [raw] * 3, workers=0)
    _assert_equal_arrays(got, flatten_proofs(tpl, [objs] * 3))
    _assert_equal_arrays(got, ref_flatten(ref_tpl, [ref_objs] * 3))
    _assert_equal_arrays(got, ref_native.flatten_proof_jsons(ref_tpl, [raw] * 3, workers=0))
    assert native.shape_descriptor(tpl) == ref_native.shape_descriptor(ref_tpl)


def test_native_thread_pool_matches(fib):
    common, tpl, objs, raw, _ = fib
    _assert_equal_arrays(flatten_proof_jsons(tpl, [raw] * 5, workers=4), flatten_proofs(tpl, [objs] * 5))


def test_native_rejects_malformed(fib):
    common, tpl, objs, (vk_b, pf_b), _ = fib
    with pytest.raises(ValueError):
        flatten_proof_jsons(tpl, [(vk_b, pf_b[:-50])])  # truncated JSON
    with pytest.raises(ValueError):
        flatten_proof_jsons(tpl, [(pf_b, pf_b)])  # wrong document for vkey
    obj = json.loads(pf_b)
    obj["proof"]["openings"]["wires"] = obj["proof"]["openings"]["wires"][:-1]
    with pytest.raises(ValueError, match="wire openings"):
        flatten_proof_jsons(tpl, [(vk_b, json.dumps(obj).encode())])
    # a mutated value still parses (rejecting it is the verifier's job)
    obj = json.loads(pf_b)
    obj["proof"]["opening_proof"]["pow_witness"] ^= 1
    out = flatten_proof_jsons(tpl, [(vk_b, json.dumps(obj).encode())])
    assert out["pow_witness"][0] != np.uint64(json.loads(pf_b.decode())["proof"]["opening_proof"]["pow_witness"])


def test_native_duplicate_key_rejected(fib):
    common, tpl, objs, (vk_b, pf_b), _ = fib
    marker = b'"pow_witness":'
    i = pf_b.index(marker)
    dup = pf_b[:i] + b'"pow_witness": 12345, ' + pf_b[i:]
    with pytest.raises(ValueError, match="duplicate key"):
        flatten_proof_jsons(tpl, [(vk_b, dup)])
    with pytest.raises(ValueError, match="duplicate key"):
        native.strict_loads(dup)


def test_native_trailing_garbage_rejected(fib):
    common, tpl, objs, (vk_b, pf_b), _ = fib
    with pytest.raises(ValueError, match="trailing"):
        flatten_proof_jsons(tpl, [(vk_b, pf_b + b" {}")])
    with pytest.raises(ValueError, match="trailing"):
        flatten_proof_jsons(tpl, [(vk_b + b"7", pf_b)])


def test_python_tier_matches_native(fib, monkeypatch):
    """flatten_proof_jsons gives identical arrays with the toolchain absent."""
    common, tpl, objs, raw, _ = fib
    ref = flatten_proof_jsons(tpl, [raw] * 2, workers=0)
    monkeypatch.setattr(native, "get_fastload", lambda: None)
    _assert_equal_arrays(native.flatten_proof_jsons(tpl, [raw] * 2, workers=0), ref)


def test_bench_ingest_tool_compares_the_tiers(fib):
    from plonky2_verifier_tpu_torch.tools.bench_ingest import bench

    common, tpl, objs, (vk_b, pf_b), _ = fib
    res = bench(tpl, *objs, n=3, workers=2)
    assert res["n"] == 3 and res["proof_json_bytes"] == len(pf_b) and res["native_threads"] == 2
    assert res["python_ms_per_proof"] > 0 and res["native_ms_per_proof"] > 0 and res["native_mt_ms_per_proof"] > 0


def test_raw_json_stream_tier(fib):
    common, tpl, objs, (vk_b, pf_b), _ = fib
    obj = json.loads(pf_b)
    obj["proof"]["opening_proof"]["pow_witness"] ^= 1
    bad = (vk_b, json.dumps(obj).encode())
    sv = StreamVerifier(tpl, batch=2, raw_json=True, ingest_workers=2, device="cpu")
    m = sv.run([(vk_b, pf_b)] * 4 + [bad])  # 2 full batches + a padded partial whose pad source is corrupt
    assert (m.proofs, m.accepted, m.rejected, m.batches) == (5, 4, 1, 3)


def test_raw_json_bucketed_stream(fib):
    common, tpl, objs, (vk_b, pf_b), _ = fib
    bsv = BucketedStreamVerifier(batch=2, raw_json=True, ingest_workers=2, device="cpu")
    per_shape = bsv.run([(common, vk_b, pf_b)] * 3)
    key = template_key(common)
    assert per_shape[key].proofs == 3 and per_shape[key].accepted == 3
