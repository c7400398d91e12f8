"""A Plonky2 proof, its verifier key and its common circuit data, read from
the JSON forms that serde gives Plonky2's ProofWithPublicInputs,
VerifierOnlyCircuitData and CommonCircuitData (the fields this verifier
reads; a hash is {"elements": [4 words]}, an extension element [a, b])."""

from __future__ import annotations

from .field import Ext
from .gates import parse_gate


def _hashes(cap) -> list:
    return [[int(x) for x in h["elements"]] for h in cap]


def _exts(xs) -> list:
    return [Ext(int(a), int(b)) for a, b in xs]


class Common:
    def __init__(self, doc: dict):
        cfg = doc["config"]
        fri = doc["fri_params"]
        self.num_wires = cfg["num_wires"]
        self.num_routed_wires = cfg["num_routed_wires"]
        self.num_challenges = cfg["num_challenges"]
        self.rate_bits = fri["config"]["rate_bits"]
        self.cap_height = fri["config"]["cap_height"]
        self.pow_bits = fri["config"]["proof_of_work_bits"]
        self.num_query_rounds = fri["config"]["num_query_rounds"]
        self.hiding = fri["hiding"]
        self.degree_bits = fri["degree_bits"]
        self.reduction_arity_bits = list(fri["reduction_arity_bits"])
        self.gates = [parse_gate(g) for g in doc["gates"]]
        self.selector_indices = list(doc["selectors_info"]["selector_indices"])
        self.groups = [(g["start"], g["end"]) for g in doc["selectors_info"]["groups"]]
        self.quotient_degree_factor = doc["quotient_degree_factor"]
        self.num_gate_constraints = doc["num_gate_constraints"]
        self.num_constants = doc["num_constants"]
        self.num_public_inputs = doc["num_public_inputs"]
        self.k_is = [int(k) for k in doc["k_is"]]
        self.num_partial_products = doc["num_partial_products"]
        self.num_lookup_polys = doc["num_lookup_polys"]
        self.num_lookup_selectors = doc["num_lookup_selectors"]
        self.luts = [[(int(i), int(o)) for i, o in lut] for lut in doc["luts"]]

    @property
    def num_selectors(self) -> int:
        return len(self.groups)

    def oracle_widths(self) -> list:
        """The polynomials of the four committed oracles: constants and
        sigmas; wires; Zs, partial products and lookup Zs; quotient chunks."""
        n = self.num_challenges
        return [self.num_constants + self.num_routed_wires, self.num_wires,
                n * (1 + self.num_partial_products + self.num_lookup_polys), n * self.quotient_degree_factor]


class Proof:
    """One proof with its verifier key, against `common`."""

    def __init__(self, common: Common, vkey: dict, doc: dict):
        self.common = common
        self.circuit_digest = [int(x) for x in vkey["circuit_digest"]["elements"]]
        self.constants_sigmas_cap = _hashes(vkey["constants_sigmas_cap"])
        self.public_inputs = [int(x) for x in doc["public_inputs"]]
        pr = doc["proof"]
        self.wires_cap = _hashes(pr["wires_cap"])
        self.zs_partial_products_cap = _hashes(pr["plonk_zs_partial_products_cap"])
        self.quotient_polys_cap = _hashes(pr["quotient_polys_cap"])
        self.openings = {k: _exts(v) for k, v in pr["openings"].items()}
        op = pr["opening_proof"]
        self.commit_phase_merkle_caps = [_hashes(cap) for cap in op["commit_phase_merkle_caps"]]
        self.final_poly = _exts(op["final_poly"]["coeffs"])
        self.pow_witness = int(op["pow_witness"])
        self.query_rounds = []
        for q in op["query_round_proofs"]:
            initial = [([int(x) for x in evals], _hashes(path["siblings"]))
                       for evals, path in q["initial_trees_proof"]["evals_proofs"]]
            steps = [(_exts(s["evals"]), _hashes(s["merkle_proof"]["siblings"])) for s in q["steps"]]
            self.query_rounds.append((initial, steps))

    def opening(self, name: str) -> list:
        return self.openings.get(name, [])

    def opening_batches(self) -> list:
        """Plonky2's OpeningSet::to_fri_openings: the batch at zeta, then the
        batch at g zeta."""
        o = self.opening
        return [o("constants") + o("plonk_sigmas") + o("wires") + o("plonk_zs") + o("partial_products")
                + o("quotient_polys") + o("lookup_zs"),
                o("plonk_zs_next") + o("lookup_zs_next")]

    def initial_merkle_caps(self) -> list:
        return [self.constants_sigmas_cap, self.wires_cap, self.zs_partial_products_cap, self.quotient_polys_cap]
