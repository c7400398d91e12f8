"""Circuit builder: assemble gates, rows, copy constraints and a witness
into a provable fixture.

Produces the exact artifacts a Plonky2 circuit build would: a
`CommonCircuitData` (selector grouping, k_is, FRI params), the constant
columns (selectors + gate constants), the sigma columns encoding the routing
permutation, and the witness matrix solved row-by-row from the gates' own
symbolic constraints (prover/witness.py).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

from ..gate_parser import Gate
from ..gates import constraint_degree, gate_program
from ..golden import field as gf
from ..golden.hashing import sponge
from ..golden.plonk import UNUSED_SELECTOR
from ..types import (
    CircuitConfig,
    CommonCircuitData,
    FriConfig,
    FriParams,
    FriReductionStrategy,
    Range,
    SelectorsInfo,
)

Cell = Tuple[int, int]  # (row, routed column)


@dataclass
class Fixture:
    common: CommonCircuitData
    constant_columns: List[List[int]]  # num_constants columns x N
    sigma_columns: List[List[int]]  # num_routed columns x N
    witness: List[List[int]]  # N rows x num_wires
    public_inputs: List[int]
    name: str = "fixture"


@dataclass
class _Row:
    gate_idx: int
    constants: Tuple[int, ...]
    prefill: Dict[int, int]


class CircuitBuilder:
    def __init__(
        self,
        num_wires: int = 135,
        num_routed_wires: int = 80,
        num_gate_constants: int = 2,
        num_challenges: int = 2,
        rate_bits: int = 3,
        cap_height: int = 4,
        proof_of_work_bits: int = 8,
        num_query_rounds: int = 28,
        arity_bits: int = 4,
        final_poly_bits: int = 5,
        max_quotient_degree_factor: int = 8,
        seed: int = 0,
    ):
        self.num_wires = num_wires
        self.num_routed = num_routed_wires
        self.num_gate_constants = num_gate_constants
        self.num_challenges = num_challenges
        self.rate_bits = rate_bits
        self.cap_height = cap_height
        self.pow_bits = proof_of_work_bits
        self.num_query_rounds = num_query_rounds
        self.arity_bits = arity_bits
        self.final_poly_bits = final_poly_bits
        self.maxdeg = max_quotient_degree_factor
        self.rng = random.Random(seed)

        self._gates: List[Gate] = []
        self._rows: List[_Row] = []
        self._copies: List[Tuple[Cell, Cell]] = []
        self.public_inputs: List[int] = []
        self.luts: List[List[Tuple[int, int]]] = []
        self._lookups: List[List[Tuple[int, int]]] = []  # per lut: used (inp,out) pairs

    # -- construction -------------------------------------------------------
    def gate_id(self, gate: Gate) -> int:
        if gate not in self._gates:
            self._gates.append(gate)
        return self._gates.index(gate)

    def add_row(self, gate: Gate, constants: Sequence[int] = (), prefill: Optional[Dict[int, int]] = None) -> int:
        g = self.gate_id(gate)
        consts = tuple(constants) + (0,) * (self.num_gate_constants - len(constants))
        self._rows.append(_Row(g, consts, dict(prefill or {})))
        return len(self._rows) - 1

    def connect(self, a: Cell, b: Cell) -> None:
        assert a[1] < self.num_routed and b[1] < self.num_routed, "only routed cells can be wired"
        self._copies.append((a, b))

    def set_public_inputs(self, values: Sequence[int]) -> None:
        self.public_inputs = [v % gf.P for v in values]

    # -- lookups --------------------------------------------------------------
    def add_lookup_table(self, table: Sequence[Tuple[int, int]]) -> int:
        """Register a lookup table of (input, output) pairs; returns its index.
        The log-derivative argument (commentary/Lookups.md, Plonk/Lookups.hs)
        encodes the table itself in LookupTableGate witness rows."""
        if not table:
            raise ValueError("empty lookup table")
        self.luts.append([(i % gf.P, o % gf.P) for i, o in table])
        self._lookups.append([])
        return len(self.luts) - 1

    def add_lookup(self, lut: int, inp: int) -> int:
        """Look `inp` up in table `lut`; records the use and returns the output."""
        inp %= gf.P
        for i, o in self.luts[lut]:
            if i == inp:
                self._lookups[lut].append((inp, o))
                return o
        raise ValueError(f"input {inp} not present in lookup table {lut}")

    @staticmethod
    def _lut_hash(table: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
        """Deterministic table identity for the gate string (stands in for
        plonky2's keccak LUT hash, Gate/Base.hs:18-23)."""
        import hashlib

        h = hashlib.sha256()
        for i, o in table:
            h.update(i.to_bytes(8, "little"))
            h.update(o.to_bytes(8, "little"))
        return tuple(h.digest()[:32])

    def _append_lookup_blocks(self) -> List[dict]:
        """Append, per table: Lookup rows (top), LookupTable rows, a Noop row
        (bottom) — the commentary/Lookups.md layout. Running sums accumulate
        from the bottom row upward, so RE/SLDC start at zero on the Noop row
        and close out on the topmost rows. Returns per-table block metadata."""
        num_lu_slots = self.num_routed // 2
        num_lut_slots = self.num_routed // 3
        blocks = []
        for k, table in enumerate(self.luts):
            pairs = list(self._lookups[k])
            if not pairs:
                raise ValueError(f"lookup table {k} is registered but never used")
            mults = [0] * len(table)
            for inp, out in pairs:
                mults[table.index((inp, out))] += 1
            # pad lookups to full rows with the first entry (counted in mults)
            n_lu_rows = -(-len(pairs) // num_lu_slots)
            pad = n_lu_rows * num_lu_slots - len(pairs)
            pairs += [table[0]] * pad
            mults[0] += pad
            # padded table: first entry repeated, multiplicity 0 for pad slots
            # (the upstream 091047f padding fix, Plonk/Lookups.hs:107)
            n_lut_rows = -(-len(table) // num_lut_slots)
            padded = list(table) + [table[0]] * (n_lut_rows * num_lut_slots - len(table))
            padded_mults = mults + [0] * (len(padded) - len(table))

            lut_hash = self._lut_hash(table)
            lu_gate = Gate("LookupGate", (num_lu_slots, lut_hash))
            lut_gate = Gate("LookupTableGate", (num_lut_slots, lut_hash, len(self._rows) + n_lu_rows + n_lut_rows - 1))

            lu_rows = []
            for r in range(n_lu_rows):
                prefill = {}
                for j in range(num_lu_slots):
                    inp, out = pairs[r * num_lu_slots + j]
                    prefill[2 * j] = inp
                    prefill[2 * j + 1] = out
                lu_rows.append(self.add_row(lu_gate, prefill=prefill))
            # entry i lives in row (n_lut_rows-1 - i // slots), slot i % slots:
            # RE accumulates upward (re(x) = delta^slots * re(omega x) + row
            # combos), so entry 0 must sit at the bottom to receive the highest
            # power of delta in evalFinalRE (Plonk/Lookups.hs:103-109)
            lut_rows = []
            for r in range(n_lut_rows):
                prefill = {}
                for j in range(num_lut_slots):
                    i2 = (n_lut_rows - 1 - r) * num_lut_slots + j
                    prefill[3 * j] = padded[i2][0]
                    prefill[3 * j + 1] = padded[i2][1]
                    prefill[3 * j + 2] = padded_mults[i2]
                lut_rows.append(self.add_row(lut_gate, prefill=prefill))
            noop_row = self.add_row(Gate("NoopGate"))
            blocks.append({"lut": k, "lu_rows": lu_rows, "lut_rows": lut_rows, "noop_row": noop_row})
        return blocks

    # -- selector grouping ---------------------------------------------------
    def _group_selectors(self) -> Tuple[List[int], List[Range]]:
        """Greedy packing of (degree-sorted) gates into contiguous groups so
        selector_degree(=group size, incl. the UNUSED factor) + gate degree
        stays within maxdeg + 1. Reorders self._gates (descending degree)."""
        degs = {i: constraint_degree(gate_program(g)) for i, g in enumerate(self._gates)}
        order = sorted(range(len(self._gates)), key=lambda i: -degs[i])
        remap = {old: new for new, old in enumerate(order)}
        self._gates = [self._gates[i] for i in order]
        for row in self._rows:
            row.gate_idx = remap[row.gate_idx]

        groups: List[Range] = []
        indices: List[int] = [0] * len(self._gates)
        start = 0
        for i, g in enumerate(self._gates):
            d = constraint_degree(gate_program(g))
            group_len = i - start + 1
            if group_len + max(d, *(constraint_degree(gate_program(self._gates[j])) for j in range(start, i + 1))) > self.maxdeg + 1:
                groups.append(Range(start, i))
                start = i
            indices[i] = len(groups)
        groups.append(Range(start, len(self._gates)))
        return indices, groups

    # -- build ---------------------------------------------------------------
    def build(self, name: str = "fixture") -> Fixture:
        lookup_blocks = self._append_lookup_blocks()
        selector_indices, groups = self._group_selectors()
        n_sel = len(groups)
        nluts = len(self.luts)
        n_lkp_sel = 0 if nluts == 0 else 4 + nluts
        num_constants_total = n_sel + n_lkp_sel + self.num_gate_constants

        # pad rows to a power of two with noop rows
        noop_id = self.gate_id(Gate("NoopGate"))
        # (gate list may have grown: regroup if noop was new)
        if noop_id >= len(selector_indices):
            selector_indices, groups = self._group_selectors()
            n_sel = len(groups)
            num_constants_total = n_sel + n_lkp_sel + self.num_gate_constants
            noop_id = self._gates.index(Gate("NoopGate"))
        n = max(4, 1 << (len(self._rows) - 1).bit_length())
        while len(self._rows) < n:
            self._rows.append(_Row(noop_id, (0,) * self.num_gate_constants, {}))
        degree_bits = n.bit_length() - 1

        pi_hash = sponge(self.public_inputs)

        # witness: solve each row from its gate's own constraints
        from ..prover.witness import GateWitnessSolver

        witness: List[List[int]] = []
        for row in self._rows:
            cells: List[Optional[int]] = [None] * self.num_wires
            for k, v in row.prefill.items():
                cells[k] = v % gf.P
            solver = GateWitnessSolver(self._gates[row.gate_idx], cells, row.constants, pi_hash)
            cells = solver.solve()
            witness.append([0 if c is None else c for c in cells])

        # copy constraints: check consistency, then build the permutation
        perm: Dict[Cell, Cell] = {}
        parent: Dict[Cell, Cell] = {}

        def find(c: Cell) -> Cell:
            while parent.get(c, c) != c:
                parent[c] = parent.get(parent[c], parent[c])
                c = parent[c]
            return c

        for a, b in self._copies:
            va, vb = witness[a[0]][a[1]], witness[b[0]][b[1]]
            if va != vb:
                raise ValueError(f"copy constraint violated: {a}={va} vs {b}={vb}")
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
        classes: Dict[Cell, List[Cell]] = {}
        for a, b in self._copies:
            for c in (a, b):
                classes.setdefault(find(c), [])
        for i in range(n):
            for j in range(self.num_routed):
                c = (i, j)
                r = find(c)
                if r in classes and c not in classes[r]:
                    classes[r].append(c)
        sigma: Dict[Cell, Cell] = {}
        for members in classes.values():
            for idx, c in enumerate(members):
                sigma[c] = members[(idx + 1) % len(members)]

        # k_is and sigma columns: phi(i, j) = k_j * omega^i
        k_is = [gf.fpow(gf.MULT_GEN, j) for j in range(self.num_routed)]
        omega_pows = gf.powers(gf.subgroup_generator(degree_bits), n)
        sigma_columns: List[List[int]] = []
        for j in range(self.num_routed):
            col = []
            for i in range(n):
                i2, j2 = sigma.get((i, j), (i, j))
                col.append(gf.fmul(k_is[j2], omega_pows[i2]))
            sigma_columns.append(col)

        # constant columns: selectors, lookup selectors, gate constants
        constant_columns: List[List[int]] = []
        for g_idx in range(n_sel):
            grp = groups[g_idx]
            col = []
            for row in self._rows:
                if grp.start <= row.gate_idx < grp.end:
                    col.append(row.gate_idx)
                else:
                    col.append(UNUSED_SELECTOR)
            constant_columns.append(col)
        # lookup selector columns (commentary/Lookups.md "Lookup selectors"):
        # 0 TransSre on LookupTable rows, 1 TransLdc on Lookup rows,
        # 2 InitSre on the per-block Noop row, 3 LastLdc on the topmost Lookup
        # row, 4+k on the topmost LookupTable row of table k.
        if n_lkp_sel:
            lkp_cols = [[0] * n for _ in range(n_lkp_sel)]
            for blk in lookup_blocks:
                for i in blk["lut_rows"]:
                    lkp_cols[0][i] = 1
                for i in blk["lu_rows"]:
                    lkp_cols[1][i] = 1
                lkp_cols[2][blk["noop_row"]] = 1
                lkp_cols[3][blk["lu_rows"][0]] = 1
                lkp_cols[4 + blk["lut"]][blk["lut_rows"][0]] = 1
            constant_columns.extend(lkp_cols)
        for c_idx in range(self.num_gate_constants):
            constant_columns.append([row.constants[c_idx] % gf.P for row in self._rows])

        # FRI params
        fri_config = FriConfig(
            rate_bits=self.rate_bits,
            cap_height=min(self.cap_height, degree_bits + self.rate_bits),
            proof_of_work_bits=self.pow_bits,
            reduction_strategy=FriReductionStrategy(
                constant_arity_bits=(self.arity_bits, self.final_poly_bits)
            ),
            num_query_rounds=self.num_query_rounds,
        )
        # upstream semantics (commentary/FRI.md:46): push the FULL arity
        # while logn > final_poly_bits — overshooting below final_poly_bits
        # is normal (2^12 -> 2^8 -> 2^4 with final_poly_bits=5; the final
        # poly may be SMALLER than 2^final_poly_bits). Only the upstream-
        # unreachable corner logn < arity_bits is clamped (to logn) so the
        # canonical final-poly length 2^(degree_bits - sum) stays >= 1.
        # Plonky2's second stop (FriReductionStrategy::reduction_arity_bits):
        # no step once logn + rate_bits - arity_bits < cap_height. The port
        # reads the arities from fri_params (template, prover, golden/).
        arities = []
        logn = degree_bits
        while logn > self.final_poly_bits and logn + self.rate_bits - self.arity_bits >= fri_config.cap_height:
            a = min(self.arity_bits, logn)
            arities.append(a)
            logn -= a
        fri_params = FriParams(
            config=fri_config, hiding=False, degree_bits=degree_bits, reduction_arity_bits=arities
        )
        config = CircuitConfig(
            num_wires=self.num_wires,
            num_routed_wires=self.num_routed,
            num_constants=self.num_gate_constants,
            use_base_arithmetic_gate=True,
            security_bits=100,
            num_challenges=self.num_challenges,
            zero_knowledge=False,
            randomize_unused_wires=False,
            max_quotient_degree_factor=self.maxdeg,
            fri_config=fri_config,
        )
        common = CommonCircuitData(
            config=config,
            fri_params=fri_params,
            gates=list(self._gates),
            selectors_info=SelectorsInfo(selector_indices=selector_indices, groups=groups),
            quotient_degree_factor=self.maxdeg,
            num_gate_constraints=max(
                (len(gate_program(g).constraints) for g in self._gates), default=0
            ),
            num_constants=num_constants_total,
            num_public_inputs=len(self.public_inputs),
            k_is=k_is,
            num_partial_products=-(-self.num_routed // self.maxdeg) - 1,
            # 1 RE column + ceil(num_lu_slots / lu_degree) SLDC columns per
            # challenge round (Plonk/Lookups.hs:64-68)
            num_lookup_polys=0
            if nluts == 0
            else 1 + -(-(self.num_routed // 2) // (self.maxdeg - 1)),
            num_lookup_selectors=n_lkp_sel,
            luts=list(self.luts),
        )
        return Fixture(
            common=common,
            constant_columns=constant_columns,
            sigma_columns=sigma_columns,
            witness=witness,
            public_inputs=self.public_inputs,
            name=name,
        )
