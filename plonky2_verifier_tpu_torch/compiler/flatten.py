"""Flatten host proofs into fixed-shape device arrays per circuit template.

All shape checks happen here: a proof whose structure does not match the
template (wrong widths, cap sizes, step counts, ...) is rejected host-side
with ValueError — on-device verification is total and branch-free.

Array layout (B = batch):
  circuit_digest  (B, 4)        pow_witness    (B,)
  public_inputs   (B, n_pi)     final_poly     (B, F, 2)
  caps: const_sigma / wires / zs_pp / quotient  (B, cap_len, 4)
  openings1 (B, M1, 2)  openings2 (B, M2, 2)   [transcript batch order]
  query_indices are *derived on device*, never trusted from the host.
  per oracle o: leaves_o (B, Q, w_o), sibs_o (B, Q, L, 4)
  per step s: step_cap_s (B, cap_s, 4), step_evals_s (B, Q, A_s, 2),
              step_sibs_s (B, Q, L_s, 4)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..types import ProofWithPublicInputs, VerifierOnlyCircuitData
from .template import CircuitTemplate


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"malformed proof: {msg}")


def flatten_proofs(
    tpl: CircuitTemplate,
    proofs: Sequence[Tuple[VerifierOnlyCircuitData, ProofWithPublicInputs]],
) -> Dict[str, np.ndarray]:
    B = len(proofs)
    u64 = lambda x: np.array(x, dtype=np.uint64)
    out: Dict[str, List] = {k: [] for k in ["circuit_digest", "public_inputs", "cap_cs", "cap_w", "cap_zp", "cap_q", "openings1", "openings2", "final_poly", "pow_witness"]}
    for o in range(4):
        out[f"leaves_{o}"] = []
        out[f"sibs_{o}"] = []
    for s in range(len(tpl.steps)):
        out[f"step_cap_{s}"] = []
        out[f"step_evals_{s}"] = []
        out[f"step_sibs_{s}"] = []

    for vkey, pwp in proofs:
        proof = pwp.proof
        op = proof.openings
        _check(len(pwp.public_inputs) == tpl.n_pi, "public input count")
        _check(len(vkey.constants_sigmas_cap) == tpl.cap_len, "constants cap size")
        _check(len(proof.wires_cap) == tpl.cap_len, "wires cap size")
        _check(len(proof.plonk_zs_partial_products_cap) == tpl.cap_len, "zs/pp cap size")
        _check(len(proof.quotient_polys_cap) == tpl.cap_len, "quotient cap size")
        _check(len(op.constants) == tpl.n_const_cols, "constants openings")
        _check(len(op.plonk_sigmas) == tpl.n_sigmas, "sigma openings")
        _check(len(op.wires) == tpl.num_wires, "wire openings")
        _check(len(op.plonk_zs) == tpl.n_zs, "zs openings")
        _check(len(op.plonk_zs_next) == tpl.n_zs, "zs_next openings")
        _check(len(op.partial_products) == tpl.n_pp, "pp openings")
        _check(len(op.quotient_polys) == tpl.n_quot, "quotient openings")
        _check(len(op.lookup_zs) == tpl.n_lookup, "lookup openings")
        _check(len(op.lookup_zs_next) == tpl.n_lookup, "lookup_next openings")
        fp = proof.opening_proof
        _check(len(fp.final_poly) == tpl.final_poly_len, "final poly length")
        _check(len(fp.commit_phase_merkle_caps) == len(tpl.steps), "commit phase caps")
        _check(len(fp.query_round_proofs) == tpl.num_queries, "query round count")

        out["circuit_digest"].append(u64(vkey.circuit_digest))
        out["public_inputs"].append(u64(pwp.public_inputs))
        out["cap_cs"].append(u64(vkey.constants_sigmas_cap))
        out["cap_w"].append(u64(proof.wires_cap))
        out["cap_zp"].append(u64(proof.plonk_zs_partial_products_cap))
        out["cap_q"].append(u64(proof.quotient_polys_cap))

        batch1 = (
            op.constants + op.plonk_sigmas + op.wires + op.plonk_zs + op.partial_products
            + op.quotient_polys + op.lookup_zs
        )
        batch2 = op.plonk_zs_next + op.lookup_zs_next
        out["openings1"].append(u64(batch1))
        out["openings2"].append(u64(batch2))
        out["final_poly"].append(u64(fp.final_poly))
        out["pow_witness"].append(np.uint64(fp.pow_witness))

        for s, (cap, st) in enumerate(zip(fp.commit_phase_merkle_caps, tpl.steps)):
            _check(len(cap) == st["cap_len"], f"step {s} cap size")
            out[f"step_cap_{s}"].append(u64(cap))

        leaves = [[] for _ in range(4)]
        sibs = [[] for _ in range(4)]
        sevals = [[] for _ in range(len(tpl.steps))]
        ssibs = [[] for _ in range(len(tpl.steps))]
        for q in fp.query_round_proofs:
            _check(len(q.initial_trees_proof.evals_proofs) == 4, "4 initial oracles")
            for o, ((leaf, mp), w) in enumerate(zip(q.initial_trees_proof.evals_proofs, tpl.oracle_widths)):
                _check(len(leaf) == w, f"oracle {o} leaf width")
                _check(len(mp.siblings) == tpl.initial_path_len, f"oracle {o} path length")
                leaves[o].append(leaf)
                sibs[o].append(mp.siblings if tpl.initial_path_len else np.zeros((0, 4)))
            _check(len(q.steps) == len(tpl.steps), "fold step count")
            for s, (qs, st) in enumerate(zip(q.steps, tpl.steps)):
                _check(len(qs.evals) == 1 << st["arity_bits"], f"step {s} coset size")
                _check(len(qs.merkle_proof.siblings) == st["path_len"], f"step {s} path length")
                sevals[s].append(qs.evals)
                ssibs[s].append(
                    qs.merkle_proof.siblings if st["path_len"] else np.zeros((0, 4))
                )
        for o in range(4):
            out[f"leaves_{o}"].append(u64(leaves[o]))
            out[f"sibs_{o}"].append(u64(sibs[o]))
        for s in range(len(tpl.steps)):
            out[f"step_evals_{s}"].append(u64(sevals[s]))
            out[f"step_sibs_{s}"].append(u64(ssibs[s]))

    return {k: np.stack(v) for k, v in out.items()}
