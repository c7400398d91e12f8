"""End to end: the same flattened proofs through TorchVerifier (CPU, plain
Poseidon path) and JaxVerifier (CPU, jnp path), lane by lane, plus the
golden challenges.

Fibonacci at 6 queries: one batch of the four heterogeneous lanes of
tests/test_verifier_jax.py followed by six copies of lane 0, each with one
u64 flipped in a different array (the mutations of test_jax_rejects_mutations),
then lane 0 with a public input written non-canonically (x + p for x).
Poseidon chain at 5 queries exercises a fold step and the Poseidon gate; its
last lane has a flipped coset evaluation. The first eight fibonacci lanes also
go through the port's ShardedVerifier in four gloo processes (4 x 1 and
2 x 2, and scrambled) against the same JaxVerifier verdicts. Tolerance:
bit-exact verdicts and challenge intermediates (integer arithmetic)."""

import numpy as np
import pytest

from plonky2_verifier_tpu.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu.golden import field as gf
from plonky2_verifier_tpu.golden.challenges import proof_challenges
from plonky2_verifier_tpu.golden.hashing import sponge
from plonky2_verifier_tpu.models.cache import get_fixture_proof
from plonky2_verifier_tpu.models.fibonacci import fibonacci_fixture
from plonky2_verifier_tpu.models.poseidon_chain import poseidon_chain_fixture
from plonky2_verifier_tpu.prover.prove import prove
from plonky2_verifier_tpu.verifier_jax import JaxVerifier
from plonky2_verifier_tpu_torch import types as pt
from plonky2_verifier_tpu_torch.ops import poseidon as tp
from plonky2_verifier_tpu_torch.ops.field import to_u64
from plonky2_verifier_tpu_torch.parallel import run_ranks, verify_sharded
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier, verify_batch

HETERO = [(1, 2), (3, 5), (10, 11), (7, 1)]
MUTATED = ["openings1", "pow_witness", "leaves_1", "final_poly", "public_inputs", "circuit_digest"]
NONCANONICAL = len(HETERO) + len(MUTATED)
P = gf.P


@pytest.fixture(autouse=True, scope="module")
def _unfused():
    mp = pytest.MonkeyPatch()
    mp.delenv("P2V_FUSED_HASH", raising=False)
    mp.setenv("P2V_POSEIDON_BACKEND", "jnp")
    yield
    mp.undo()


def _flip(arrays, name, lane):
    B = arrays[name].shape[0]
    arrays[name].reshape(B, -1)[lane, 0] ^= np.uint64(1)


def _run_both(tpl, arrays):
    tv = TorchVerifier(tpl, debug=True, device="cpu")
    jv = JaxVerifier(tpl, debug=True)
    return tv(tv.prepare(arrays)), jv(jv.prepare(arrays))


@pytest.fixture(scope="module")
def fib():
    fx0 = fibonacci_fixture(num_query_rounds=6)
    tpl = CircuitTemplate(fx0.common)
    lanes = [prove(fibonacci_fixture(num_query_rounds=6, x0=a, x1=b)) for a, b in HETERO]
    arrays = flatten_proofs(tpl, lanes + [lanes[0]] * (len(MUTATED) + 1))
    for i, name in enumerate(MUTATED):
        _flip(arrays, name, len(HETERO) + i)
    pi = arrays["public_inputs"][NONCANONICAL]
    assert int(pi[0]) < 2**64 - P
    pi[0] += np.uint64(P)
    t_out, j_out = _run_both(tpl, arrays)
    return fx0.common, lanes, t_out, j_out, tpl, arrays


@pytest.fixture(scope="module")
def pos():
    fx = poseidon_chain_fixture(n_chain=6, num_query_rounds=5, arity_bits=2, final_poly_bits=1)
    tpl = CircuitTemplate(fx.common)
    assert tpl.steps, "fixture must exercise fold steps"
    proof = prove(fx)
    arrays = flatten_proofs(tpl, [proof] * 3)
    _flip(arrays, "step_evals_0", 2)
    t_out, j_out = _run_both(tpl, arrays)
    return fx.common, proof, t_out, j_out


def _jax_u64(pair):
    hi, lo = (np.asarray(x, dtype=np.uint64) for x in pair)
    return (hi << np.uint64(32)) | lo


def _debug_pairs(t_dbg, j_dbg, u=to_u64):
    """(name, port u64 array, JAX u64 array) for every debug intermediate;
    `u` turns the port's value into a uint64 array (tensors by default)."""
    yield "zeta.re", u(t_dbg["zeta"][0]), _jax_u64(j_dbg["zeta"][:2])
    yield "zeta.im", u(t_dbg["zeta"][1]), _jax_u64(j_dbg["zeta"][2:])
    yield "fri_alpha.re", u(t_dbg["fri_alpha"][0]), _jax_u64(j_dbg["fri_alpha"][:2])
    yield "fri_alpha.im", u(t_dbg["fri_alpha"][1]), _jax_u64(j_dbg["fri_alpha"][2:])
    for i, (t, j) in enumerate(zip(t_dbg["betas"], j_dbg["betas"])):
        yield f"betas[{i}]", u(t), _jax_u64(j)
    for i, (t, j) in enumerate(zip(t_dbg["alphas"], j_dbg["alphas"])):
        yield f"alphas[{i}]", u(t), _jax_u64(j)
    yield "pow_response", u(t_dbg["pow_response"]), _jax_u64(j_dbg["pow_response"])
    yield "query_indices", u(t_dbg["query_indices"]), np.asarray(j_dbg["query_indices"], dtype=np.uint64)
    yield "pi_hash", u(t_dbg["pi_hash"]), _jax_u64(j_dbg["pi_hash"])


def _assert_lane_matches_golden(common, dbg, lane, vkey, pwp):
    ch = proof_challenges(common, vkey, pwp)
    at = lambda t: to_u64(t)[lane]
    assert (int(at(dbg["zeta"][0])), int(at(dbg["zeta"][1]))) == tuple(ch.zeta)
    assert [int(at(b)) for b in dbg["betas"]] == ch.betas
    assert [int(at(a)) for a in dbg["alphas"]] == ch.alphas
    assert (int(at(dbg["fri_alpha"][0])), int(at(dbg["fri_alpha"][1]))) == tuple(ch.fri.alpha)
    assert int(at(dbg["pow_response"])) == ch.fri.pow_response
    assert [int(x) for x in at(dbg["query_indices"])] == ch.fri.query_indices
    assert tuple(int(x) for x in at(dbg["pi_hash"])) == sponge(pwp.public_inputs)


def test_cached_fixture_verifies():
    """A proof loaded through models.cache (the JSON round trip chip_smoke.py
    uses) verifies, with golden challenges. These parameters are the cached
    fixture that tests/test_np_prover.py's reproducibility check reads, so
    this also writes it when no other test has yet."""
    common, vkey, pwp = get_fixture_proof("fibonacci", num_query_rounds=8, x0=6, x1=7)
    tpl = CircuitTemplate(common)
    v = TorchVerifier(tpl, debug=True, device="cpu")
    out = v(v.prepare(flatten_proofs(tpl, [(vkey, pwp)])))
    assert out["ok"].tolist() == [True]
    _assert_lane_matches_golden(common, out["debug"], 0, vkey, pwp)


@pytest.mark.parametrize("key", ["ok", "eqs_ok", "fri_ok"])
def test_fibonacci_verdicts_match_jax(fib, key):
    _, _, t_out, j_out, _, _ = fib
    np.testing.assert_array_equal(t_out[key].numpy(), np.asarray(j_out[key]))


def test_fibonacci_accepts_exactly_the_intact_lanes(fib):
    _, _, t_out, _, _, _ = fib
    assert t_out["ok"].tolist() == [True] * len(HETERO) + [False] * len(MUTATED) + [True]


def test_noncanonical_public_input_hashes_as_its_field_element(fib):
    _, _, t_out, _, _, _ = fib
    pi_hash = to_u64(t_out["debug"]["pi_hash"])
    np.testing.assert_array_equal(pi_hash[NONCANONICAL], pi_hash[0])


@pytest.mark.parametrize("i,name", list(enumerate(MUTATED)), ids=MUTATED)
def test_mutation_rejected(fib, i, name):
    _, _, t_out, j_out, _, _ = fib
    lane = len(HETERO) + i
    assert not bool(t_out["ok"][lane]), f"mutating {name} was accepted"
    assert not bool(np.asarray(j_out["ok"])[lane])


def test_fibonacci_debug_matches_jax(fib):
    _, _, t_out, j_out, _, _ = fib
    for name, got, want in _debug_pairs(t_out["debug"], j_out["debug"]):
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("lane", range(len(HETERO)))
def test_heterogeneous_lane_matches_golden(fib, lane):
    common, lanes, t_out, _, _, _ = fib
    _assert_lane_matches_golden(common, t_out["debug"], lane, *lanes[lane])


def test_verify_batch_on_cpu_matches_jax(fib):
    """The one-call entry point, numpy in and numpy out, with device="cpu":
    JaxVerifier's verdicts and challenge intermediates, bit for bit."""
    _, _, t_out, j_out, tpl, arrays = fib
    out = verify_batch(tpl, arrays, debug=True, device="cpu")
    for key in ("ok", "eqs_ok", "fri_ok"):
        assert isinstance(out[key], np.ndarray) and out[key].dtype == np.bool_
        np.testing.assert_array_equal(out[key], np.asarray(j_out[key]), err_msg=key)
    assert out["debug"]["zeta"][0].dtype == np.uint64
    for name, got, want in _debug_pairs(out["debug"], j_out["debug"], u=lambda x: x):  # already uint64 numpy
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(out["debug"]["pi_hash"], to_u64(t_out["debug"]["pi_hash"]))
    assert "debug" not in verify_batch(tpl, {k: a[:2] for k, a in arrays.items()}, device="cpu")


SCRAMBLE = [5, 3, 7, 0, 2, 6, 1, 4]  # the lane permutation of tests/test_parallel.py::test_lane_scramble


@pytest.mark.parametrize("dp,qp,perm", [(4, 1, None), (2, 2, None), (2, 2, SCRAMBLE)], ids=["4x1", "2x2", "2x2-scrambled"])
def test_sharded_verifier_in_four_processes_matches_jax(fib, dp, qp, perm):
    """The first 8 lanes (four intact heterogeneous proofs, then faults in
    openings1, pow_witness, leaves_1 and final_poly) through the port's
    ShardedVerifier in four gloo processes. A lane's verdict does not depend
    on its neighbours, so JaxVerifier's verdicts on the 11-lane batch are the
    truth for these lanes, in any order. Under qp = 2 a rank checks three of
    the six query rounds and the leaves_1 fault lies in round 0: only one
    rank of the row sees it, and the AND over the row must carry it."""
    common, _, _, j_out, _, arrays = fib
    lanes = np.arange(8) if perm is None else np.array(perm)
    truth = np.asarray(j_out["ok"])[lanes].tolist()
    assert sum(truth) == 4
    sub = {k: a[lanes] for k, a in arrays.items()}
    port_common = pt.CommonCircuitData.from_json(common.to_json())
    ranks = run_ranks(verify_sharded, 4, (port_common, sub, dp, qp, "cpu"), threads=1, timeout_s=240)
    per = 8 // dp
    for rank, res in enumerate(ranks):
        assert res["rank"] == rank
        assert res["gathered"] == truth
        assert res["ok"] == truth[rank // qp * per : (rank // qp + 1) * per]
        assert res["n_valid"] == 4


def test_run_transcript_plain_loop_matches_jax_challenges(fib):
    """_run_transcript on a CPU tensor is the plain loop over the schedule
    (one gather, one masked overwrite, one plain permutation a step); its
    challenges are JaxVerifier's debug challenges."""
    _, _, t_out, j_out, tpl, arrays = fib
    v = TorchVerifier(tpl, device="cpu")
    a = v.prepare(arrays)
    data = v._transcript_data(a, t_out["debug"]["pi_hash"])
    states = tp.permutation_scan_plain(data, v._ov_idx, v._ov_mask, v.poseidon)
    assert states.shape == (len(tpl.schedule.permutes), data.shape[0], 12)
    ch = v._run_transcript(data)
    for i, j in enumerate(j_out["debug"]["betas"]):
        np.testing.assert_array_equal(to_u64(ch["betas"][i]), _jax_u64(j), err_msg=f"betas[{i}]")
    for i, j in enumerate(j_out["debug"]["alphas"]):
        np.testing.assert_array_equal(to_u64(ch["alphas"][i]), _jax_u64(j), err_msg=f"alphas[{i}]")
    np.testing.assert_array_equal(to_u64(ch["zeta"][0]), _jax_u64(j_out["debug"]["zeta"][:2]))
    np.testing.assert_array_equal(to_u64(ch["zeta"][1]), _jax_u64(j_out["debug"]["zeta"][2:]))
    np.testing.assert_array_equal(to_u64(ch["pow_response"][0]), _jax_u64(j_out["debug"]["pow_response"]))
    pi, lane = tpl.schedule.challenges["pow_response"][0]
    np.testing.assert_array_equal(to_u64(states[pi][:, lane]), to_u64(ch["pow_response"][0]))


def test_heterogeneous_transcripts_are_distinct(fib):
    _, _, t_out, _, _, _ = fib
    zeta_re = to_u64(t_out["debug"]["zeta"][0])[: len(HETERO)]
    assert len(set(int(z) for z in zeta_re)) == len(HETERO)


def test_poseidon_chain_matches_jax(pos):
    common, proof, t_out, j_out = pos
    for key in ("ok", "eqs_ok", "fri_ok"):
        np.testing.assert_array_equal(t_out[key].numpy(), np.asarray(j_out[key]), err_msg=key)
    assert t_out["ok"].tolist() == [True, True, False]
    for name, got, want in _debug_pairs(t_out["debug"], j_out["debug"]):
        np.testing.assert_array_equal(got, want, err_msg=name)
    _assert_lane_matches_golden(common, t_out["debug"], 0, *proof)
