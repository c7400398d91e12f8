"""Proof / verification-key data model + JSON codecs.

Mirrors Plonky2's JSON serialization of `CommonCircuitData`,
`VerifierOnlyCircuitData` and `ProofWithPublicInputs` (field names and
nesting exactly as serialized; semantics per reference spec Types.hs:47-279).

Everything here is host-side: plain dataclasses of Python ints. The circuit
template compiler (`plonky2_verifier_tpu.compiler`) flattens these into
fixed-shape device arrays per circuit shape.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

from .gate_parser import Gate, gate_to_string, parse_gate

FExt = Tuple[int, int]
Digest = Tuple[int, int, int, int]


def _ext(v) -> FExt:
    a, b = v
    return (int(a), int(b))


def _digest(v) -> Digest:
    e = v["elements"]
    return (int(e[0]), int(e[1]), int(e[2]), int(e[3]))


def _digest_json(d: Digest):
    return {"elements": list(d)}


# ---------------------------------------------------------------------------


@dataclass
class Range:
    """Half-open interval [start, end)."""

    start: int
    end: int

    def __iter__(self):
        return iter(range(self.start, self.end))

    def __len__(self):
        return self.end - self.start


@dataclass
class SelectorsInfo:
    selector_indices: List[int]  # gate -> selector group index
    groups: List[Range]
    selector_vector: Optional[List[int]] = None

    @classmethod
    def from_json(cls, o):
        return cls(
            selector_indices=[int(x) for x in o["selector_indices"]],
            groups=[Range(int(r["start"]), int(r["end"])) for r in o["groups"]],
            selector_vector=[int(x) for x in o["selector_vector"]] if o.get("selector_vector") else None,
        )

    def to_json(self):
        out = {
            "selector_indices": self.selector_indices,
            "groups": [{"start": r.start, "end": r.end} for r in self.groups],
        }
        if self.selector_vector is not None:
            out["selector_vector"] = self.selector_vector
        return out


@dataclass
class FriReductionStrategy:
    """Sum type: exactly one of the three variants is set."""

    fixed: Optional[List[int]] = None  # arity bits per step
    constant_arity_bits: Optional[Tuple[int, int]] = None  # (arity_bits, final_poly_bits)
    min_size: Optional[Optional[int]] = None

    @classmethod
    def from_json(cls, o):
        (key, val), = o.items()
        if key == "Fixed":
            return cls(fixed=[int(x) for x in val])
        if key == "ConstantArityBits":
            return cls(constant_arity_bits=(int(val[0]), int(val[1])))
        if key == "MinSize":
            return cls(min_size=val)
        raise ValueError(f"unknown FRI reduction strategy {key!r}")

    def to_json(self):
        if self.fixed is not None:
            return {"Fixed": self.fixed}
        if self.constant_arity_bits is not None:
            return {"ConstantArityBits": list(self.constant_arity_bits)}
        raise ValueError("MinSize serialization not supported")


@dataclass
class FriConfig:
    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    reduction_strategy: FriReductionStrategy
    num_query_rounds: int

    @classmethod
    def from_json(cls, o):
        return cls(
            rate_bits=int(o["rate_bits"]),
            cap_height=int(o["cap_height"]),
            proof_of_work_bits=int(o["proof_of_work_bits"]),
            reduction_strategy=FriReductionStrategy.from_json(o["reduction_strategy"]),
            num_query_rounds=int(o["num_query_rounds"]),
        )

    def to_json(self):
        return {
            "rate_bits": self.rate_bits,
            "cap_height": self.cap_height,
            "proof_of_work_bits": self.proof_of_work_bits,
            "reduction_strategy": self.reduction_strategy.to_json(),
            "num_query_rounds": self.num_query_rounds,
        }


@dataclass
class FriParams:
    config: FriConfig
    hiding: bool
    degree_bits: int
    reduction_arity_bits: List[int]

    @property
    def nrows(self) -> int:
        return 1 << self.degree_bits

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    @property
    def lde_nrows(self) -> int:
        return 1 << self.lde_bits

    @classmethod
    def from_json(cls, o):
        return cls(
            config=FriConfig.from_json(o["config"]),
            hiding=bool(o["hiding"]),
            degree_bits=int(o["degree_bits"]),
            reduction_arity_bits=[int(x) for x in o["reduction_arity_bits"]],
        )

    def to_json(self):
        return {
            "config": self.config.to_json(),
            "hiding": self.hiding,
            "degree_bits": self.degree_bits,
            "reduction_arity_bits": self.reduction_arity_bits,
        }


@dataclass
class CircuitConfig:
    num_wires: int
    num_routed_wires: int
    num_constants: int
    use_base_arithmetic_gate: bool
    security_bits: int
    num_challenges: int
    zero_knowledge: bool
    randomize_unused_wires: bool
    max_quotient_degree_factor: int
    fri_config: FriConfig

    @classmethod
    def from_json(cls, o):
        return cls(
            num_wires=int(o["num_wires"]),
            num_routed_wires=int(o["num_routed_wires"]),
            num_constants=int(o["num_constants"]),
            use_base_arithmetic_gate=bool(o["use_base_arithmetic_gate"]),
            security_bits=int(o["security_bits"]),
            num_challenges=int(o["num_challenges"]),
            zero_knowledge=bool(o["zero_knowledge"]),
            randomize_unused_wires=bool(o["randomize_unused_wires"]),
            max_quotient_degree_factor=int(o["max_quotient_degree_factor"]),
            fri_config=FriConfig.from_json(o["fri_config"]),
        )

    def to_json(self):
        return {
            "num_wires": self.num_wires,
            "num_routed_wires": self.num_routed_wires,
            "num_constants": self.num_constants,
            "use_base_arithmetic_gate": self.use_base_arithmetic_gate,
            "security_bits": self.security_bits,
            "num_challenges": self.num_challenges,
            "zero_knowledge": self.zero_knowledge,
            "randomize_unused_wires": self.randomize_unused_wires,
            "max_quotient_degree_factor": self.max_quotient_degree_factor,
            "fri_config": self.fri_config.to_json(),
        }


@dataclass
class CommonCircuitData:
    config: CircuitConfig
    fri_params: FriParams
    gates: List[Gate]
    selectors_info: SelectorsInfo
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int  # TOTAL constant columns (selectors + lookup sels + gate consts)
    num_public_inputs: int
    k_is: List[int]
    num_partial_products: int
    num_lookup_polys: int
    num_lookup_selectors: int
    luts: List[List[Tuple[int, int]]]

    @property
    def nrows(self) -> int:
        return self.fri_params.nrows

    @property
    def num_luts(self) -> int:
        return len(self.luts)

    @classmethod
    def from_json(cls, o):
        return cls(
            config=CircuitConfig.from_json(o["config"]),
            fri_params=FriParams.from_json(o["fri_params"]),
            gates=[parse_gate(s) for s in o["gates"]],
            selectors_info=SelectorsInfo.from_json(o["selectors_info"]),
            quotient_degree_factor=int(o["quotient_degree_factor"]),
            num_gate_constraints=int(o["num_gate_constraints"]),
            num_constants=int(o["num_constants"]),
            num_public_inputs=int(o["num_public_inputs"]),
            k_is=[int(x) for x in o["k_is"]],
            num_partial_products=int(o["num_partial_products"]),
            num_lookup_polys=int(o["num_lookup_polys"]),
            num_lookup_selectors=int(o["num_lookup_selectors"]),
            luts=[[(int(a), int(b)) for a, b in lut] for lut in o["luts"]],
        )

    def to_json(self):
        return {
            "config": self.config.to_json(),
            "fri_params": self.fri_params.to_json(),
            "gates": [gate_to_string(g) for g in self.gates],
            "selectors_info": self.selectors_info.to_json(),
            "quotient_degree_factor": self.quotient_degree_factor,
            "num_gate_constraints": self.num_gate_constraints,
            "num_constants": self.num_constants,
            "num_public_inputs": self.num_public_inputs,
            "k_is": self.k_is,
            "num_partial_products": self.num_partial_products,
            "num_lookup_polys": self.num_lookup_polys,
            "num_lookup_selectors": self.num_lookup_selectors,
            "luts": [[[a, b] for a, b in lut] for lut in self.luts],
        }


# ---------------------------------------------------------------------------


@dataclass
class VerifierOnlyCircuitData:
    constants_sigmas_cap: List[Digest]
    circuit_digest: Digest

    @classmethod
    def from_json(cls, o):
        return cls(
            constants_sigmas_cap=[_digest(d) for d in o["constants_sigmas_cap"]],
            circuit_digest=_digest(o["circuit_digest"]),
        )

    def to_json(self):
        return {
            "constants_sigmas_cap": [_digest_json(d) for d in self.constants_sigmas_cap],
            "circuit_digest": _digest_json(self.circuit_digest),
        }


@dataclass
class MerkleProof:
    siblings: List[Digest]

    @classmethod
    def from_json(cls, o):
        return cls(siblings=[_digest(d) for d in o["siblings"]])

    def to_json(self):
        return {"siblings": [_digest_json(d) for d in self.siblings]}


@dataclass
class FriInitialTreeProof:
    # 4 entries, one per oracle: (opened leaf row, Merkle proof)
    evals_proofs: List[Tuple[List[int], MerkleProof]]

    @classmethod
    def from_json(cls, o):
        return cls(
            evals_proofs=[([int(x) for x in row], MerkleProof.from_json(mp)) for row, mp in o["evals_proofs"]]
        )

    def to_json(self):
        return {"evals_proofs": [[row, mp.to_json()] for row, mp in self.evals_proofs]}


@dataclass
class FriQueryStep:
    evals: List[FExt]  # opened coset (bit-reversed-codeword order)
    merkle_proof: MerkleProof

    @classmethod
    def from_json(cls, o):
        return cls(
            evals=[_ext(e) for e in o["evals"]],
            merkle_proof=MerkleProof.from_json(o["merkle_proof"]),
        )

    def to_json(self):
        return {"evals": [list(e) for e in self.evals], "merkle_proof": self.merkle_proof.to_json()}


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: List[FriQueryStep]

    @classmethod
    def from_json(cls, o):
        return cls(
            initial_trees_proof=FriInitialTreeProof.from_json(o["initial_trees_proof"]),
            steps=[FriQueryStep.from_json(s) for s in o["steps"]],
        )

    def to_json(self):
        return {
            "initial_trees_proof": self.initial_trees_proof.to_json(),
            "steps": [s.to_json() for s in self.steps],
        }


@dataclass
class FriProof:
    commit_phase_merkle_caps: List[List[Digest]]
    query_round_proofs: List[FriQueryRound]
    final_poly: List[FExt]  # coefficients
    pow_witness: int

    @classmethod
    def from_json(cls, o):
        return cls(
            commit_phase_merkle_caps=[[_digest(d) for d in cap] for cap in o["commit_phase_merkle_caps"]],
            query_round_proofs=[FriQueryRound.from_json(q) for q in o["query_round_proofs"]],
            final_poly=[_ext(c) for c in o["final_poly"]["coeffs"]],
            pow_witness=int(o["pow_witness"]),
        )

    def to_json(self):
        return {
            "commit_phase_merkle_caps": [[_digest_json(d) for d in cap] for cap in self.commit_phase_merkle_caps],
            "query_round_proofs": [q.to_json() for q in self.query_round_proofs],
            "final_poly": {"coeffs": [list(c) for c in self.final_poly]},
            "pow_witness": self.pow_witness,
        }


@dataclass
class OpeningSet:
    constants: List[FExt]  # includes selector + lookup-selector columns
    plonk_sigmas: List[FExt]
    wires: List[FExt]
    plonk_zs: List[FExt]
    plonk_zs_next: List[FExt]
    partial_products: List[FExt]
    quotient_polys: List[FExt]
    lookup_zs: List[FExt]
    lookup_zs_next: List[FExt]

    @classmethod
    def from_json(cls, o):
        g = lambda k: [_ext(e) for e in o[k]]
        return cls(
            constants=g("constants"),
            plonk_sigmas=g("plonk_sigmas"),
            wires=g("wires"),
            plonk_zs=g("plonk_zs"),
            plonk_zs_next=g("plonk_zs_next"),
            partial_products=g("partial_products"),
            quotient_polys=g("quotient_polys"),
            lookup_zs=g("lookup_zs"),
            lookup_zs_next=g("lookup_zs_next"),
        )

    def to_json(self):
        f = lambda xs: [list(e) for e in xs]
        return {
            "constants": f(self.constants),
            "plonk_sigmas": f(self.plonk_sigmas),
            "wires": f(self.wires),
            "plonk_zs": f(self.plonk_zs),
            "plonk_zs_next": f(self.plonk_zs_next),
            "partial_products": f(self.partial_products),
            "quotient_polys": f(self.quotient_polys),
            "lookup_zs": f(self.lookup_zs),
            "lookup_zs_next": f(self.lookup_zs_next),
        }


@dataclass
class Proof:
    wires_cap: List[Digest]
    plonk_zs_partial_products_cap: List[Digest]
    quotient_polys_cap: List[Digest]
    openings: OpeningSet
    opening_proof: FriProof

    @classmethod
    def from_json(cls, o):
        return cls(
            wires_cap=[_digest(d) for d in o["wires_cap"]],
            plonk_zs_partial_products_cap=[_digest(d) for d in o["plonk_zs_partial_products_cap"]],
            quotient_polys_cap=[_digest(d) for d in o["quotient_polys_cap"]],
            openings=OpeningSet.from_json(o["openings"]),
            opening_proof=FriProof.from_json(o["opening_proof"]),
        )

    def to_json(self):
        return {
            "wires_cap": [_digest_json(d) for d in self.wires_cap],
            "plonk_zs_partial_products_cap": [_digest_json(d) for d in self.plonk_zs_partial_products_cap],
            "quotient_polys_cap": [_digest_json(d) for d in self.quotient_polys_cap],
            "openings": self.openings.to_json(),
            "opening_proof": self.opening_proof.to_json(),
        }


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: List[int]

    @classmethod
    def from_json(cls, o):
        return cls(proof=Proof.from_json(o["proof"]), public_inputs=[int(x) for x in o["public_inputs"]])

    def to_json(self):
        return {"proof": self.proof.to_json(), "public_inputs": self.public_inputs}


@dataclass
class VerifierCircuitData:
    verifier_only: VerifierOnlyCircuitData
    common: CommonCircuitData


# ---------------------------------------------------------------------------
# file helpers


def load_common(path: str) -> CommonCircuitData:
    return CommonCircuitData.from_json(json.load(open(path)))


def load_vkey(path: str) -> VerifierOnlyCircuitData:
    return VerifierOnlyCircuitData.from_json(json.load(open(path)))


def load_proof(path: str) -> ProofWithPublicInputs:
    return ProofWithPublicInputs.from_json(json.load(open(path)))


def dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj.to_json(), f)
