"""End to end: the same flattened proofs through TorchVerifier (CPU, plain
Poseidon path) and JaxVerifier (CPU, jnp path), lane by lane, plus the
golden challenges.

Fibonacci at 6 queries: one batch of the four heterogeneous lanes of
tests/test_verifier_jax.py followed by six copies of lane 0, each with one
u64 flipped in a different array (the mutations of test_jax_rejects_mutations),
then lane 0 with a public input written non-canonically (x + p for x), then
the non-canonical probe: lane 0 with one word written as x + p (x < 2^32 - 1)
in each of openings1, leaves_1, sibs_0, cap_w and final_poly, a lane each.
Poseidon chain at 5 queries exercises a fold step and the Poseidon gate; its
third lane has a flipped coset evaluation and its fourth a word p in
step_evals_0. The first eight fibonacci lanes also
go through the port's ShardedVerifier in four gloo processes (4 x 1 and
2 x 2, and scrambled) against the same JaxVerifier verdicts. Tolerance:
bit-exact verdicts and challenge intermediates (integer arithmetic).

The probe's lanes are written into the proof (its JSON form, then parsed
back), so golden/ verifies the very words both verifiers see. A probed word
is the first one of its array below 2^32 - 1, written as itself + p, the
same field element; where the array holds none (digests and coset
evaluations are uniform in the field), its first word becomes p, which
stands for 0, not for the word it replaces. What each side does, lane by
lane (`PROBED`; golden/, JaxVerifier and TorchVerifier agree on ok, eqs_ok
and fri_ok in every lane):
- openings1 (a zero opening of an unused wire -> p), leaves_1 (a zero leaf
  word -> p), final_poly (its zero top coefficient -> p): accepted. The
  transcript absorbs the word through the permutation, and every use is a
  product or a Horner sum, so p acts as 0 everywhere.
- sibs_0 (a sibling digest word -> p) and cap_w (a cap digest word -> p):
  rejected by FRI alone, since p stands for 0 there; the cap word is also
  absorbed by the transcript, so every challenge moves and eqs_ok fails too.
- step_evals_0 (poseidon_chain, a coset evaluation -> p): rejected by FRI
  alone."""

import json

import numpy as np
import pytest

from plonky2_verifier_tpu.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu.golden import challenges as gchallenges
from plonky2_verifier_tpu.golden import field as gf
from plonky2_verifier_tpu.golden import fri as gfri
from plonky2_verifier_tpu.golden import plonk as gplonk
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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HETERO = [(1, 2), (3, 5), (10, 11), (7, 1)]
MUTATED = ["openings1", "pow_witness", "leaves_1", "final_poly", "public_inputs", "circuit_digest"]
NONCANONICAL = len(HETERO) + len(MUTATED)
P = gf.P
# the probe: array -> its word as x + p through the proof's JSON (see the
# module docstring), and the verdicts (ok, eqs_ok, fri_ok) golden/ gives
PROBED = {
    "openings1": (True, True, True),
    "leaves_1": (True, True, True),
    "sibs_0": (False, True, False),
    "cap_w": (False, False, False),
    "final_poly": (True, True, True),
}
PROBED_POS = {"step_evals_0": (False, True, False)}


def _json_words(proof, name):
    """The JSON lists of `proof` (ProofWithPublicInputs.to_json()) that hold
    array `name`'s words of one lane, in flatten_proofs' order."""
    pr = proof["proof"]
    op, fp = pr["openings"], pr["opening_proof"]
    queries = fp["query_round_proofs"]
    return {
        "openings1": lambda: [op[k] for k in ("constants", "plonk_sigmas", "wires", "plonk_zs", "partial_products", "quotient_polys", "lookup_zs")],
        "leaves_1": lambda: [q["initial_trees_proof"]["evals_proofs"][1][0] for q in queries],
        "sibs_0": lambda: [q["initial_trees_proof"]["evals_proofs"][0][1]["siblings"] for q in queries],
        "cap_w": lambda: pr["wires_cap"],
        "final_poly": lambda: fp["final_poly"]["coeffs"],
        "step_evals_0": lambda: [q["steps"][0]["evals"] for q in queries],
    }[name]()


def _noncanonical(pwp, name):
    """A copy of `pwp` with one word of array `name` written as x + p: the
    first word below 2^32 - 1 (the same element), or else the first word,
    as p."""
    o = json.loads(json.dumps(pwp.to_json()))  # to_json shares the leaf rows with pwp
    slots = []

    def walk(node):
        for i, x in enumerate(node):
            if isinstance(x, int):
                slots.append((node, i))
            else:
                walk(x["elements"] if isinstance(x, dict) else x)

    walk(_json_words(o, name))
    small = [(node, i) for node, i in slots if node[i] < 2**32 - 1]
    node, i = small[0] if small else slots[0]
    node[i] = (node[i] if small else 0) + P
    return type(pwp).from_json(o)


def _probe_lanes(tpl, vkey, pwp, names):
    """One lane a probed array: its proof, flattened, differs from the
    intact one in exactly one word of that array, and the word is p or more."""
    intact = flatten_proofs(tpl, [(vkey, pwp)])
    lanes = [(vkey, _noncanonical(pwp, name)) for name in names]
    for name, lane in zip(names, lanes):
        one = flatten_proofs(tpl, [lane])
        changed = {k: np.flatnonzero(one[k] != intact[k]) for k in one}
        assert {k: v.size for k, v in changed.items() if v.size} == {name: 1}, name
        assert one[name].reshape(-1)[changed[name][0]] >= np.uint64(P), name
    return lanes


def _golden_verdicts(common, lanes):
    out = []
    for vkey, pwp in lanes:
        ch = gchallenges.proof_challenges(common, vkey, pwp)
        eqs = all(gplonk.check_combined_plonk_equations(common, pwp, ch))
        fri = gfri.check_fri_proof(common, vkey, pwp.proof, ch)
        out.append((eqs and fri, eqs, fri))
    return out


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
    probed = _probe_lanes(tpl, *lanes[0], list(PROBED))
    extra = flatten_proofs(tpl, probed)
    arrays = {k: np.concatenate([a, extra[k]]) for k, a in arrays.items()}
    t_out, j_out = _run_both(tpl, arrays)
    return fx0.common, lanes, t_out, j_out, tpl, arrays, _golden_verdicts(fx0.common, probed)


@pytest.fixture(scope="module")
def pos():
    fx = poseidon_chain_fixture(n_chain=6, num_query_rounds=5, arity_bits=2, final_poly_bits=1)
    tpl = CircuitTemplate(fx.common)
    assert tpl.steps, "fixture must exercise fold steps"
    proof = prove(fx)
    probed = _probe_lanes(tpl, *proof, list(PROBED_POS))
    arrays = flatten_proofs(tpl, [proof] * 3 + probed)
    _flip(arrays, "step_evals_0", 2)
    t_out, j_out = _run_both(tpl, arrays)
    return fx.common, proof, t_out, j_out, _golden_verdicts(fx.common, probed)


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
    """A proof loaded through models.cache (the JSON round trip the tools and
    the card tests use) verifies, with golden challenges. These parameters are the cached
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
    _, _, t_out, j_out, _, _, _ = fib
    np.testing.assert_array_equal(t_out[key].numpy(), np.asarray(j_out[key]))


def test_fibonacci_accepts_exactly_the_intact_lanes(fib):
    _, _, t_out, _, _, _, _ = fib
    assert t_out["ok"].tolist() == [True] * len(HETERO) + [False] * len(MUTATED) + [True] + [v[0] for v in PROBED.values()]


def test_noncanonical_public_input_hashes_as_its_field_element(fib):
    _, _, t_out, _, _, _, _ = fib
    pi_hash = to_u64(t_out["debug"]["pi_hash"])
    np.testing.assert_array_equal(pi_hash[NONCANONICAL], pi_hash[0])


@pytest.mark.parametrize("i,name", list(enumerate(MUTATED)), ids=MUTATED)
def test_mutation_rejected(fib, i, name):
    _, _, t_out, j_out, _, _, _ = fib
    lane = len(HETERO) + i
    assert not bool(t_out["ok"][lane]), f"mutating {name} was accepted"
    assert not bool(np.asarray(j_out["ok"])[lane])


def test_fibonacci_debug_matches_jax(fib):
    _, _, t_out, j_out, _, _, _ = fib
    for name, got, want in _debug_pairs(t_out["debug"], j_out["debug"]):
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("lane", range(len(HETERO)))
def test_heterogeneous_lane_matches_golden(fib, lane):
    common, lanes, t_out, _, _, _, _ = fib
    _assert_lane_matches_golden(common, t_out["debug"], lane, *lanes[lane])


def test_verify_batch_on_cpu_matches_jax(fib):
    """The one-call entry point, numpy in and numpy out, with device="cpu":
    JaxVerifier's verdicts and challenge intermediates, bit for bit."""
    _, _, t_out, j_out, tpl, arrays, _ = fib
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
    common, _, _, j_out, _, arrays, _ = fib
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
    _, _, t_out, j_out, tpl, arrays, _ = fib
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
    _, _, t_out, _, _, _, _ = fib
    zeta_re = to_u64(t_out["debug"]["zeta"][0])[: len(HETERO)]
    assert len(set(int(z) for z in zeta_re)) == len(HETERO)


def test_poseidon_chain_matches_jax(pos):
    common, proof, t_out, j_out, _ = pos
    for key in ("ok", "eqs_ok", "fri_ok"):
        np.testing.assert_array_equal(t_out[key].numpy(), np.asarray(j_out[key]), err_msg=key)
    assert t_out["ok"].tolist() == [True, True, False] + [v[0] for v in PROBED_POS.values()]
    for name, got, want in _debug_pairs(t_out["debug"], j_out["debug"]):
        np.testing.assert_array_equal(got, want, err_msg=name)
    _assert_lane_matches_golden(common, t_out["debug"], 0, *proof)


@pytest.mark.parametrize("i,name", list(enumerate(PROBED)), ids=list(PROBED))
def test_noncanonical_word_lane_by_lane(fib, i, name):
    """The probe, one lane an array: ok, eqs_ok and fri_ok of TorchVerifier
    and JaxVerifier equal each other and golden/'s verdicts on the same
    proof, and those are the ones PROBED states."""
    _, _, t_out, j_out, _, _, golden = fib
    lane = NONCANONICAL + 1 + i
    port = tuple(bool(t_out[k][lane]) for k in ("ok", "eqs_ok", "fri_ok"))
    jax_side = tuple(bool(np.asarray(j_out[k])[lane]) for k in ("ok", "eqs_ok", "fri_ok"))
    assert port == jax_side == golden[i] == PROBED[name]


def test_noncanonical_coset_evaluation_lane(pos):
    _, _, t_out, j_out, golden = pos
    port = tuple(bool(t_out[k][3]) for k in ("ok", "eqs_ok", "fri_ok"))
    jax_side = tuple(bool(np.asarray(j_out[k])[3]) for k in ("ok", "eqs_ok", "fri_ok"))
    assert port == jax_side == golden[0] == PROBED_POS["step_evals_0"]
