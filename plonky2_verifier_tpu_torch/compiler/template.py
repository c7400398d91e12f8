"""CircuitTemplate: shape constants + static transcript schedule per circuit.

The Fiat-Shamir transcript is an inherently sequential duplex scan, but for
a fixed circuit *shape* the sequence of (overwrite-lanes, permute, extract)
steps is data-independent (SURVEY.md section 2.4). We derive it by running
the golden duplex state machine once on a dummy transcript of the right
shape and recording its event trace; the device executor then replays the
schedule as a statically-unrolled chain of batched Poseidon permutations.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Tuple

from ..golden import field as gf
from ..golden.duplex import Duplex
from ..golden.fri import oracle_widths
from ..golden.plonk import get_selector_config
from ..types import CommonCircuitData


@dataclass
class TranscriptSchedule:
    n_data: int  # length of the per-proof transcript data vector
    # per permutation: list of (lane, data_position); lanes form a prefix 0..k-1
    permutes: List[List[Tuple[int, int]]]
    # named squeeze events -> list of (permutation_idx, lane) per felt
    challenges: Dict[str, List[Tuple[int, int]]]


@dataclass
class CircuitTemplate:
    common: CommonCircuitData

    def __post_init__(self):
        common = self.common
        cfg = common.config
        # every gate must have a constraint program; an UnknownGate in the
        # vkey is a clean host-side error, never a device verdict (the
        # reference parses it, Gate/Parser.hs:130, but cannot evaluate it)
        from ..gates import gate_program

        for g in common.gates:
            gate_program(g)  # raises ValueError("unknown gate: ...") if unsupported
        self.r = cfg.num_challenges
        self.n = common.nrows
        self.degree_bits = common.fri_params.degree_bits
        self.rate_bits = cfg.fri_config.rate_bits
        self.lde_bits = self.degree_bits + self.rate_bits
        self.lde_n = 1 << self.lde_bits
        self.cap_height = cfg.fri_config.cap_height
        self.cap_len = 1 << self.cap_height
        self.num_queries = cfg.fri_config.num_query_rounds
        self.pow_bits = cfg.fri_config.proof_of_work_bits
        self.num_wires = cfg.num_wires
        self.num_routed = cfg.num_routed_wires
        self.n_pi = common.num_public_inputs

        selcfg = get_selector_config(common)
        self.n_gate_selectors = selcfg.num_gate_selectors
        self.n_lookup_selectors = selcfg.num_lookup_selectors
        self.n_gate_constants = selcfg.num_gate_constants
        self.n_const_cols = common.num_constants  # selectors + lkp sels + gate consts

        self.oracle_widths = list(oracle_widths(common))  # constants, wires, pp, quotient
        self.initial_path_len = self.lde_bits - self.cap_height

        self.step_arity_bits = list(common.fri_params.reduction_arity_bits)
        # per-step: (arity_bits, codeword_bits_before, tree_leaves_bits, path_len, cap_len)
        self.steps = []
        bits = self.lde_bits
        for a in self.step_arity_bits:
            leaves_bits = bits - a
            cap_h = min(self.cap_height, leaves_bits)
            self.steps.append(
                {
                    "arity_bits": a,
                    "codeword_bits": bits,
                    "leaves_bits": leaves_bits,
                    "path_len": leaves_bits - cap_h,
                    "cap_len": 1 << cap_h,
                }
            )
            bits -= a
        self.final_bits = bits  # log2 codeword size at the final level
        self.final_poly_len = 1 << (self.degree_bits - sum(self.step_arity_bits))

        # opening-set widths, in transcript batch order
        self.n_zs = self.r
        self.n_pp = self.r * common.num_partial_products
        self.n_quot = self.r * common.quotient_degree_factor
        self.n_lookup = self.r * common.num_lookup_polys
        self.n_sigmas = self.num_routed
        self.batch1_width = (
            self.n_const_cols
            + self.n_sigmas
            + self.num_wires
            + self.n_zs
            + self.n_pp
            + self.n_quot
            + self.n_lookup
        )
        self.batch2_width = self.n_zs + self.n_lookup

        self.schedule = self._build_schedule()

        # precomputed field constants
        self.g_small = gf.subgroup_generator(self.degree_bits)  # omega
        self.g_lde = gf.subgroup_generator(self.lde_bits)  # eta
        # shift at each fold level: g, g^arity, ...
        self.level_shifts = [gf.MULT_GEN]
        for s in self.steps:
            self.level_shifts.append(gf.fpow(self.level_shifts[-1], 1 << s["arity_bits"]))

    # ------------------------------------------------------------------
    def _build_schedule(self) -> TranscriptSchedule:
        """Replay the challenge derivation on dummy data, recording the trace.

        Data-vector layout (concatenation in absorb order):
        circuit_digest(4) | pi_hash(4) | wires_cap | zs_pp_cap | quotient_cap |
        openings batch1 (2 felts each) | batch2 | per-step commit cap |
        final_poly (2 each) | pow_witness(1)."""
        d = Duplex()
        names: Dict[str, List[Tuple[int, int]]] = {}

        def absorb_n(k: int):
            for _ in range(k):
                d.absorb(0)

        def record(name: str, k: int):
            start = len(d.trace.squeezes)
            d.squeeze_n(k)
            names[name] = d.trace.squeezes[start:]

        r = self.r
        absorb_n(4)  # circuit digest
        absorb_n(4)  # pi hash
        absorb_n(4 * self.cap_len)  # wires cap
        record("betas", r)
        record("gammas", r)
        if self.common.num_lookup_polys > 0:
            record("deltas", 2 * r)
        absorb_n(4 * self.cap_len)  # zs+pp cap
        record("alphas", r)
        absorb_n(4 * self.cap_len)  # quotient cap
        record("zeta", 2)
        absorb_n(2 * self.batch1_width)
        absorb_n(2 * self.batch2_width)
        record("fri_alpha", 2)
        for i, s in enumerate(self.steps):
            absorb_n(4 * s["cap_len"])
            record(f"fri_beta_{i}", 2)
        absorb_n(2 * self.final_poly_len)
        absorb_n(1)  # pow witness
        record("pow_response", 1)
        record("query_indices", self.num_queries)

        return TranscriptSchedule(
            n_data=d.trace.n_absorbed,
            permutes=d.trace.permutes,
            challenges=names,
        )
