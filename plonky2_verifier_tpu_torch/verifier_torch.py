"""The batched verifier in PyTorch: one module per circuit template.

The counterpart of plonky2_verifier_tpu/verifier_jax.py, batched over the
proof batch B (and inside FRI over the Q query rounds):

1. public-input hash + transcript replay (the template's static schedule:
   per step one gather, one masked overwrite and one permutation; on the
   card the whole scan is one kernel launch) -> every Fiat-Shamir challenge,
   bit-exact;
2. Plonk checks at zeta: selectors, L0, partial products, the lookup
   argument (where the template has lookup tables), the gate constraints
   (levelized gate program), alpha-combination, quotient equation;
3. FRI: proof of work, the leaf hashes of the four oracles and of every fold
   step's coset (one grouped sponge launch on the card), the Merkle
   openings, combineInitial, the coset folds (IDFT as a multiply-add loop
   over the arity), the final poly.

Field values are int64 tensors holding u64 bit patterns (ops/field.py). The
Poseidon chains go through ops/poseidon.py and ops/hash.py, which launch the
CUDA kernels for CUDA tensors.

Entry points: `verify_batch(tpl, arrays)` (numpy in, numpy out) and
`TorchVerifier(tpl)`. Both run on the CUDA card unless the caller passes a
device, and raise where there is no card; `device="cpu"` runs every kernel's
plain version.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .compiler.template import CircuitTemplate
from .gates import CONST, LKPSEL, PI, SEL, WIRE
from .golden import field as gf
from .golden.plonk import UNUSED_SELECTOR

from .compiler.gates_torch import GateProgram
from .compiler.levelize import levelize_gates
from .ops import field as tf
from .ops import hash as th
from .ops import poseidon as tp
from .ops.field import GExt


def prepare(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Flattened uint64 host arrays -> int64 tensors on `device`."""
    return {k: tf.from_u64(v, device) for k, v in arrays.items()}


def horner_ext(values: GExt, point: GExt) -> GExt:
    """sum_i point^i values[..., i], Horner from zero as in the JAX verifier
    (the first step's add also reduces a non-canonical proof value)."""
    acc = tf.ext_zeros(values.shape[:-1], point.re.device)
    for i in range(values.shape[-1] - 1, -1, -1):
        acc = values[..., i] + tf.emul(point, acc)
    return acc


def horner_scaled(values: GExt, scale) -> GExt:
    """sum_i scale^i values[..., i] with a base-field scale. `scale` may carry
    extra trailing axes: values (B, K) with scale (B, r) -> (B, r)."""
    lead = values.shape[:-1]
    extra = tuple(scale.shape[len(lead) :])
    acc = tf.ext_zeros(tuple(lead) + extra, scale.device)
    for i in range(values.shape[-1] - 1, -1, -1):
        v = values[..., i].reshape(*lead, *((1,) * len(extra)))
        acc = v + tf.escale(scale, acc)
    return acc


def tree_prod_last(v: GExt) -> GExt:
    """Product over the last axis by halving (pads odd widths with 1)."""
    width = v.shape[-1]
    while width > 1:
        if width % 2:
            pad = tf.ext_constant(1, shape=tuple(v.shape[:-1]) + (1,), device=v.re.device)
            v = tf.ext_concat([v, pad], dim=-1)
            width += 1
        half = width // 2
        v = tf.emul(v[..., :half], v[..., half:])
        width = half
    return v[..., 0]


def ext_sum_axis(v: GExt, axis: int) -> GExt:
    """Sum over `axis` by halving."""
    v = GExt(v.re.movedim(axis, 0), v.im.movedim(axis, 0))
    width = v.shape[0]
    if width == 0:
        raise ValueError("empty sum")
    while width > 1:
        if width % 2:
            v = tf.ext_concat([v, tf.ext_zeros((1,) + tuple(v.shape[1:]), v.re.device)], dim=0)
            width += 1
        half = width // 2
        v = v[:half] + v[half:]
        width = half
    return v[0]


def merkle_batched(digest, index, sibs, cap, path_len: int, consts: tp.PoseidonConstants):
    """digest (..., 4), index (...,), sibs (..., L, 4), cap (..., cap, 4)
    -> bool (...,): the walked root equals the cap row that the residual
    index selects."""
    cur = digest if path_len == 0 else th.merkle_fold(digest, index, sibs, path_len, consts)
    return (cur == tp.select_cap_root(cap, index >> path_len)).all(dim=-1)


# arrays whose second axis is the FRI query-round axis (parallel/mesh.py cuts them)
QUERY_AXIS_ARRAYS = ("leaves_", "sibs_", "step_evals_", "step_sibs_")


def is_query_axis_array(name: str) -> bool:
    return name.startswith(QUERY_AXIS_ARRAYS)


def _bit_reverse(idx, bits: int):
    out = torch.zeros_like(idx)
    for k in range(bits):
        out = out | (((idx >> k) & 1) << (bits - 1 - k))
    return out


class TorchVerifier(nn.Module):
    """Batched verifier for one circuit template. The template's constants
    (Poseidon tables, transcript schedule, gate program, selector matrices,
    fold weights) are buffers built on `device`: `None` means the CUDA card
    and raises where there is none; the tests pass "cpu"."""

    def __init__(self, tpl: CircuitTemplate, debug: bool = False, device=None):
        super().__init__()
        device = tf.resolve_device(device)
        if tpl.lde_bits > 32 or tpl.pow_bits > 32:
            raise ValueError("lde domains beyond 2^32 and PoW beyond 32 bits are unsupported")
        self.tpl = tpl
        self.debug = debug
        self.on_stage = None  # tools/profile_verifier.py: called with a stage's name where the stage ends
        common = tpl.common

        self.poseidon = tp.PoseidonConstants(device)

        # static transcript schedule: per permutation, which lanes are
        # overwritten and from which data positions
        sched = tpl.schedule
        n_perms = len(sched.permutes)
        ov_mask = np.zeros((n_perms, 12), dtype=bool)
        ov_idx = np.zeros((n_perms, 12), dtype=np.int64)
        for i, ov in enumerate(sched.permutes):
            for lane, pos in ov:
                ov_mask[i, lane] = True
                ov_idx[i, lane] = pos
        self.register_buffer("_ov_mask", torch.from_numpy(ov_mask).to(device))
        self.register_buffer("_ov_idx", torch.from_numpy(ov_idx).to(device))

        self.gates = GateProgram(
            levelize_gates(
                tuple(common.gates),
                tpl.n_gate_selectors,
                tpl.n_lookup_selectors,
                tpl.n_gate_constants,
                tpl.num_wires,
            ),
            device,
        )
        self.register_buffer("_k_is", tf.from_u64(np.array(common.k_is, dtype=np.uint64), device))

        # selector factor matrices (Gate/Selector.hs:78-95): per gate,
        # (UNUSED if several groups) and every other index of its group
        si = common.selectors_info
        n_gates = len(si.selector_indices)
        multi = len(si.groups) > 1
        span = max(max(g.end - g.start for g in si.groups) - 1 + (1 if multi else 0), 1)
        tmat = np.zeros((n_gates, span), dtype=np.uint64)
        mask = np.zeros((n_gates, span), dtype=bool)
        for g, grp in enumerate(si.selector_indices):
            rng = si.groups[grp]
            fs = ([UNUSED_SELECTOR] if multi else []) + [j for j in range(rng.start, rng.end) if j != g]
            tmat[g, : len(fs)] = fs
            mask[g, : len(fs)] = True
        self.register_buffer("_sel_consts", tf.from_u64(tmat, device))
        self.register_buffer("_sel_mask", torch.from_numpy(mask).to(device))
        self.register_buffer("_sel_cols", torch.tensor(si.selector_indices, dtype=torch.int64, device=device))

        # per fold step: bit-reversal to subgroup order and the IDFT weights
        # wmat[k, j] = omega^{-jk}
        for s, st in enumerate(tpl.steps):
            abits = st["arity_bits"]
            arity = 1 << abits
            perm = np.array([gf.reverse_bits(abits, i) for i in range(arity)], dtype=np.int64)
            omega_inv = gf.finv(gf.subgroup_generator(abits))
            wmat = np.array(
                [[gf.fpow(omega_inv, j * k) for j in range(arity)] for k in range(arity)], dtype=np.uint64
            )
            self.register_buffer(f"_coset_perm_{s}", torch.from_numpy(perm).to(device))
            self.register_buffer(f"_idft_{s}", tf.from_u64(wmat, device))

    # -- host side ------------------------------------------------------------
    def prepare(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Flattened uint64 host arrays -> int64 tensors on this module's device."""
        return prepare(arrays, self._ov_idx.device)

    def to_host(self, out, into=None) -> np.ndarray:
        """The verdict lanes `ok` of one call's output as a numpy bool array
        (B,). Without `into` it waits for the device. With `into`, a pinned
        bool tensor (B,), the copy is only enqueued on the current stream and
        the array shares `into`'s memory: the caller reads it after an event
        it records behind this call."""
        ok = out["ok"]
        if into is None:
            return ok.cpu().numpy()
        into.copy_(ok, non_blocking=True)
        return into.numpy()

    def forward(self, a: Dict[str, torch.Tensor], queries: Optional[slice] = None):
        """The verdicts of one batch. With `queries=slice(q0, q1)` the
        transcript, the Plonk checks and the proof of work run whole and FRI
        checks query rounds q0 ... q1 - 1 alone: the per-query arrays of `a`
        (QUERY_AXIS_ARRAYS) arrive already cut to those rounds, and `fri_ok`
        is this slice's share of the verdict, to be ANDed with the other
        slices' (parallel/mesh.py)."""
        return self._verify(a, queries)

    def _stage(self, name: str) -> None:
        if self.on_stage is not None:
            self.on_stage(name)

    # -- transcript -------------------------------------------------------------
    def _transcript_data(self, a, pi_hash):
        """The per-proof transcript data vector (B, n_data), in absorb order
        (CircuitTemplate._build_schedule)."""
        tpl = self.tpl
        B = pi_hash.shape[0]

        def flat(x):
            return x.reshape(B, -1)

        data = torch.cat(
            [a["circuit_digest"], pi_hash, flat(a["cap_w"]), flat(a["cap_zp"]), flat(a["cap_q"])]
            + [flat(a["openings1"]), flat(a["openings2"])]
            + [flat(a[f"step_cap_{s}"]) for s in range(len(tpl.steps))]
            + [flat(a["final_poly"]), a["pow_witness"].reshape(B, 1)],
            dim=1,
        )
        if data.shape[1] != tpl.schedule.n_data:
            raise ValueError(f"transcript data has {data.shape[1]} elements, expected {tpl.schedule.n_data}")
        return data

    def _run_transcript(self, data):
        """Replay the schedule over data (B, n_data): one scan-kernel launch
        on the card, the plain loop on the CPU; returns each challenge as
        the list of (B,) words squeezed for it."""
        states = tp.permutation_scan(data, self._ov_idx, self._ov_mask, self.poseidon)  # (n_perms, B, 12)
        return {
            name: [states[pi][:, lane] for pi, lane in coords]
            for name, coords in self.tpl.schedule.challenges.items()
        }

    # -- main ---------------------------------------------------------------------
    def _verify(self, a, queries: Optional[slice] = None):
        tpl = self.tpl
        if queries is not None:
            q0, q1, stride = queries.indices(tpl.num_queries)
            if stride != 1 or q1 <= q0:
                raise ValueError(f"queries must be a non-empty contiguous slice of the {tpl.num_queries} rounds, got {queries}")
            for name, x in a.items():
                if is_query_axis_array(name) and x.shape[1] != q1 - q0:
                    raise ValueError(f"{name} holds {x.shape[1]} query rounds, the slice {q0}:{q1} needs {q1 - q0}")
        pi_hash = th.sponge_rows(a["public_inputs"], tpl.n_pi, self.poseidon)
        self._stage("pi hash")
        ch = self._run_transcript(self._transcript_data(a, pi_hash))
        self._stage("transcript")
        betas, gammas, alphas = ch["betas"], ch["gammas"], ch["alphas"]
        zeta = GExt(*ch["zeta"])
        fri_alpha = GExt(*ch["fri_alpha"])
        fri_betas = [GExt(*ch[f"fri_beta_{i}"]) for i in range(len(tpl.steps))]
        pow_response = ch["pow_response"][0]
        # lde_n <= 2^32, so the index is a low-bit mask of the canonical u64
        qidx = torch.stack([q & (tpl.lde_n - 1) for q in ch["query_indices"]], dim=1)  # (B, Q)
        fri_qidx = qidx if queries is None else qidx[:, q0:q1]

        def ext_view(x):
            return GExt(x[..., 0], x[..., 1])

        o1 = ext_view(a["openings1"])  # (B, M1)
        o2 = ext_view(a["openings2"])
        final_poly = ext_view(a["final_poly"])  # (B, F)

        widths = [
            tpl.n_const_cols, tpl.n_sigmas, tpl.num_wires, tpl.n_zs, tpl.n_pp, tpl.n_quot, tpl.n_lookup
        ]
        offs = np.concatenate([[0], np.cumsum(widths)])
        constants, sigmas, wires, zs, pps, quots, lookup_zs = (
            o1[:, int(offs[i]) : int(offs[i + 1])] for i in range(len(widths))
        )
        zs_next = o2[:, : tpl.n_zs]
        lookup_zs_next = o2[:, tpl.n_zs :]

        # lookup challenge 4-tuples (a, b, alpha, delta), one a round: chunks
        # of betas ++ gammas ++ deltas
        deltas = []
        if tpl.common.num_lookup_polys > 0:
            all4 = betas + gammas + ch["deltas"]
            deltas = [tuple(all4[i : i + 4]) for i in range(0, len(all4), 4)]

        eqs_ok = self._plonk_checks(
            pi_hash, constants, sigmas, wires, zs, zs_next, pps, lookup_zs, lookup_zs_next, quots,
            betas, gammas, alphas, deltas, zeta,
        )
        fri_ok = self._fri_checks(a, o1, o2, zeta, fri_alpha, fri_betas, pow_response, fri_qidx, final_poly)

        out = {"ok": eqs_ok & fri_ok, "eqs_ok": eqs_ok, "fri_ok": fri_ok}
        if self.debug:
            out["debug"] = {
                "zeta": (zeta.re, zeta.im),
                "betas": list(betas),
                "gammas": list(gammas),
                "alphas": list(alphas),
                "deltas": deltas,
                "fri_alpha": (fri_alpha.re, fri_alpha.im),
                "pow_response": pow_response,
                "query_indices": qidx,
                "pi_hash": pi_hash,
            }
        return out

    # -- plonk ----------------------------------------------------------------------
    def _plonk_checks(
        self, pi_hash, constants, sigmas, wires, zs, zs_next, pps, lookup_zs, lookup_zs_next, quots,
        betas, gammas, alphas, deltas, zeta,
    ):
        tpl = self.tpl
        common = tpl.common
        r = tpl.r
        maxdeg = common.quotient_degree_factor
        B = zeta.shape[0]
        dev = zeta.re.device

        gate_sels = constants[:, : tpl.n_gate_selectors]
        lkp_sels = constants[:, tpl.n_gate_selectors : tpl.n_gate_selectors + tpl.n_lookup_selectors]
        gate_consts = constants[:, tpl.n_gate_selectors + tpl.n_lookup_selectors :]

        # L0(zeta)(z - 1)
        zeta_n = tf.ext_pow_const(zeta, tpl.n)
        one = tf.ext_constant(1, shape=(B,), device=dev)
        nval = tf.constant(tpl.n % gf.P, (B,), dev)
        lag0 = tf.ext_div(zeta_n - one, tf.escale(nval, zeta - one))
        zs1 = tf.emul(lag0.unsqueeze(1), zs - tf.ext_constant(1, shape=(B, 1), device=dev))  # (B, r)

        # partial products: all rounds, numerator and denominator in one tensor
        ns = tpl.n_sigmas
        n_chunks = ns // maxdeg
        beta_s = torch.stack(betas, dim=1).unsqueeze(-1)  # (B, r, 1)
        gamma_s = torch.stack(gammas, dim=1).unsqueeze(-1)
        routed = wires[:, :ns].unsqueeze(1)  # (B, 1, ns)
        bk = tf.mul(beta_s, self._k_is)  # (B, r, ns)
        bz = tf.escale(bk, zeta.unsqueeze(1).unsqueeze(1))
        numer = GExt(tf.add(tf.add(routed.re, bz.re), gamma_s), tf.add(routed.im, bz.im))
        bs = tf.escale(beta_s, sigmas.unsqueeze(1))
        denom = GExt(tf.add(tf.add(routed.re, bs.re), gamma_s), tf.add(routed.im, bs.im))
        nd = tf.ext_stack([numer, denom], dim=2).reshape(B, r, 2, n_chunks, maxdeg)
        prods = tree_prod_last(nd)  # (B, r, 2, n_chunks)
        pp_round = pps.reshape(B, r, common.num_partial_products)
        current = tf.ext_concat([zs.unsqueeze(-1), pp_round, zs_next.unsqueeze(-1)], dim=-1)
        pv = tf.ext_stack([current[..., :-1], current[..., 1:]], dim=2)  # (B, r, 2, n_chunks)
        pn = tf.emul(pv, prods)
        pp_vec = (pn[:, :, 0] - pn[:, :, 1]).reshape(B, r * n_chunks)
        self._stage("plonk: L0 and partial products")

        # gate constraints
        sel_values = self._eval_selectors(gate_sels)  # (B, n_gates)
        inputs = {
            SEL: gate_sels,
            LKPSEL: lkp_sels,
            CONST: gate_consts,
            WIRE: wires,
            PI: tf.ext_from_base(pi_hash),
        }
        n_gc = common.num_gate_constraints
        cons_rows = []
        live_gates = []
        for gi, cons in enumerate(self.gates(inputs, (B,), per_prog=True)):
            if cons.shape[-1] == 0:
                continue
            pad = n_gc - cons.shape[-1]
            if pad:
                cons = tf.ext_concat([cons, tf.ext_zeros((B, pad), dev)], dim=-1)
            cons_rows.append(cons)
            live_gates.append(gi)
        acc = tf.ext_zeros((B, n_gc), dev)
        if cons_rows:
            cons_all = tf.ext_stack(cons_rows, dim=1)  # (B, G, n_gc)
            sel_live = sel_values[:, live_gates]
            acc = ext_sum_axis(tf.emul(sel_live.unsqueeze(-1), cons_all), axis=1)
        self._stage("plonk: selectors and gate program")

        # assemble, alpha-combine, quotient equation
        lookup_vec = []
        if common.num_lookup_polys > 0:
            lookup_vec = [self._lookup_checks(lkp_sels, wires, lookup_zs, lookup_zs_next, deltas)]
        self._stage("plonk: lookup argument")
        constraint_vec = tf.ext_concat([zs1, pp_vec] + lookup_vec + [acc], dim=1)  # (B, K)
        combined = horner_scaled(constraint_vec, torch.stack(alphas, dim=1))  # (B, r)
        quots_r = quots.reshape(B, r, maxdeg)
        q = horner_ext(quots_r, zeta_n.unsqueeze(1).expand(B, r))
        zn1 = zeta_n - one
        ok = tf.ext_equal(tf.emul(q, zn1.unsqueeze(1)), combined)  # (B, r)
        ok = ok.all(dim=1)
        self._stage("plonk: alpha combination and quotient")
        return ok

    def _eval_selectors(self, gate_sels: GExt) -> GExt:
        """Closed-form selector values for all gates at once: per gate, the
        product of (factor - x) over its factor row, with masked slots 1."""
        x = gate_sels[:, self._sel_cols]  # (B, n_gates)
        consts = tf.ext_from_base(self._sel_consts).unsqueeze(0)  # (1, n_gates, span)
        one = tf.ext_constant(1, shape=(1, 1, 1), device=x.re.device)
        terms = tf.ext_where(self._sel_mask, consts - x.unsqueeze(-1), one)
        return tree_prod_last(terms)  # (B, n_gates)

    def _lookup_checks(self, lkp_sels: GExt, wires: GExt, lookup_zs: GExt, lookup_zs_next: GExt, deltas) -> GExt:
        """The log-derivative lookup equations at zeta, the counterpart of
        verifier_jax.py  _lookup_checks, all challenge rounds on a leading
        round axis. lkp_sels (B, 4 + luts), wires (B, num_wires), lookup_zs
        and lookup_zs_next (B, r * polys) with the layout [RE, SLDC_0 ...]
        a round, deltas r tuples (a, b, alpha, delta) of (B,) words ->
        (B, r * (4 + luts + 2 * n_sldc)), a round after the other, each
        [last_sldc, init_sum, init_re] ++ finals_re ++ [re_trans] ++
        interleaved (sum_trans, ldc_trans) per SLDC chunk."""
        tpl = self.tpl
        common = tpl.common
        r = tpl.r
        B = wires.shape[0]
        dev = wires.re.device
        num_lu = common.config.num_routed_wires // 2  # (input, output) slots of a LookupGate row
        num_lut = common.config.num_routed_wires // 3  # (input, output, multiplicity) slots of a table row
        n_polys = common.num_lookup_polys
        n_sldc = n_polys - 1
        lu_deg = common.quotient_degree_factor - 1
        lut_deg = -(-num_lut // n_sldc)

        av, bv, alv, dlv = (torch.stack([d[k] for d in deltas], dim=1) for k in range(4))  # (B, r)
        lz = lookup_zs.reshape(B, r, n_polys)
        lzn = lookup_zs_next.reshape(B, r, n_polys)
        re_o, sldc = lz[..., 0], lz[..., 1:]
        re_next, sldc_next = lzn[..., 0], lzn[..., 1:]

        def sel(i: int, rank: int = 2) -> GExt:
            return lkp_sels[:, i].reshape((B,) + (1,) * (rank - 1))

        pairs_in = wires[:, 0 : 2 * num_lu : 2].unsqueeze(1)  # (B, 1, num_lu)
        pairs_out = wires[:, 1 : 2 * num_lu : 2].unsqueeze(1)
        trip_in = wires[:, 0 : 3 * num_lut : 3].unsqueeze(1)  # (B, 1, num_lut)
        trip_out = wires[:, 1 : 3 * num_lut : 3].unsqueeze(1)
        trip_mult = wires[:, 2 : 3 * num_lut : 3].unsqueeze(1)

        def combo(inp: GExt, out: GExt, c) -> GExt:
            return inp + tf.escale(c.unsqueeze(-1), out)  # (B, r, slots)

        lu_combos = combo(pairs_in, pairs_out, av)
        lut_combos_a = combo(trip_in, trip_out, av)
        lut_combos_b = combo(trip_in, trip_out, bv)
        alpha_e = tf.ext_from_base(alv.unsqueeze(-1))

        def chunked_terms(combos: GExt, deg: int, slots: int):
            """alpha - combo in chunks (B, r, n_sldc, deg), padded with 1, and
            the mask (n_sldc, deg) of the real slots."""
            t = alpha_e - combos
            pad = n_sldc * deg - slots
            if pad:
                t = tf.ext_concat([t, tf.ext_constant(1, shape=(B, r, pad), device=dev)], dim=-1)
            mask = torch.arange(n_sldc * deg, device=dev).reshape(n_sldc, deg) < slots
            return t.reshape(B, r, n_sldc, deg), mask

        def leave_one_out(terms: GExt, deg: int):
            """The product over the last axis (B, r, n_sldc) and the products
            that leave one slot out (B, r, n_sldc, deg), from the exclusive
            prefix and suffix products."""
            one = tf.ext_constant(1, shape=tuple(terms.shape[:-1]), device=dev)
            pre, suf = [one], [one]
            for j in range(deg - 1):
                pre.append(tf.emul(pre[-1], terms[..., j]))
                suf.append(tf.emul(suf[-1], terms[..., deg - 1 - j]))
            full = tf.emul(pre[-1], terms[..., deg - 1])
            return full, tf.emul(tf.ext_stack(pre, dim=-1), tf.ext_stack(suf[::-1], dim=-1))

        lu_terms, lu_mask = chunked_terms(lu_combos, lu_deg, num_lu)
        lut_terms, lut_mask = chunked_terms(lut_combos_a, lut_deg, num_lut)
        lu_prod, lu_loo = leave_one_out(lu_terms, lu_deg)
        lut_prod, lut_loo = leave_one_out(lut_terms, lut_deg)
        # sums over the real slots only
        nothing = tf.ext_zeros((1, 1, 1, 1), dev)
        lu_sum = ext_sum_axis(tf.ext_where(lu_mask, lu_loo, nothing), -1)
        mults = trip_mult
        mult_pad = n_sldc * lut_deg - num_lut
        if mult_pad:
            mults = tf.ext_concat([mults, tf.ext_zeros((B, 1, mult_pad), dev)], dim=-1)
        mults = mults.reshape(B, 1, n_sldc, lut_deg)
        lut_sum = ext_sum_axis(tf.ext_where(lut_mask, tf.emul(mults, lut_loo), nothing), -1)

        # transitions of the SLDC chunks: chunk 0 follows the last chunk at omega x
        prev = tf.ext_concat([sldc_next[..., -1:], sldc[..., :-1]], dim=-1)
        dmin = sldc - prev  # (B, r, n_sldc)
        eq_sum_t = tf.emul(sel(0, 3), tf.emul(lut_prod, dmin) - lut_sum)
        eq_ldc_t = tf.emul(sel(1, 3), tf.emul(lu_prod, dmin) + lu_sum)
        inter = tf.ext_stack([eq_sum_t, eq_ldc_t], dim=-1).reshape(B, r, 2 * n_sldc)

        # RE transition: re minus the delta-Horner from re_next over the b-combos
        cur = re_next
        for k in range(num_lut):
            cur = tf.escale(dlv, cur) + lut_combos_b[..., k]
        eq_re_t = tf.emul(sel(0), re_o - cur)  # (B, r)

        # final RE per table: the padded table's (input, output) columns as
        # polynomials in delta, both Horner sums in one loop
        eq_finals = []
        for k, table in enumerate(common.luts):
            rows = -(-len(table) // num_lut) * num_lut
            padded = list(table) + [table[0]] * (rows - len(table))
            coeffs = tf.from_u64(np.array(padded, dtype=np.uint64), dev)  # (rows, 2)
            acc = tf.zeros((B, r, 2), dev)
            for c in coeffs:
                acc = tf.add(tf.mul(dlv.unsqueeze(-1), acc), c)
            expected = tf.add(acc[..., 0], tf.mul(bv, acc[..., 1]))
            eq_finals.append(tf.emul(sel(4 + k), re_o - tf.ext_from_base(expected)))

        eq_last = tf.emul(sel(3), sldc[..., -1])
        eq_ini_sum = tf.emul(sel(2), sldc[..., 0])
        eq_ini_re = tf.emul(sel(2), re_o)
        singles = [eq_last, eq_ini_sum, eq_ini_re] + eq_finals + [eq_re_t]
        per_round = tf.ext_concat([e.unsqueeze(-1) for e in singles] + [inter], dim=-1)
        return per_round.reshape(B, r * per_round.shape[-1])

    # -- FRI ------------------------------------------------------------------------
    def _fri_checks(self, a, o1, o2, zeta, fri_alpha, fri_betas, pow_response, qidx, final_poly):
        tpl = self.tpl
        common = tpl.common
        B, Q = qidx.shape
        r = tpl.r
        dev = qidx.device

        def bq(x: GExt) -> GExt:
            return GExt(x.re.unsqueeze(1).expand(B, Q), x.im.unsqueeze(1).expand(B, Q))

        def const(v: int):
            return tf.constant(v, (B, Q), dev)

        # proof of work: the top pow_bits bits of the response are zero
        if tpl.pow_bits:
            pow_ok = tf.shr(pow_response, 64 - tpl.pow_bits) == 0
        else:
            pow_ok = torch.ones((B,), dtype=torch.bool, device=dev)

        # reduced openings
        y0 = horner_ext(o1, fri_alpha)  # (B,)
        y1 = horner_ext(o2, fri_alpha)
        self._stage("fri: proof of work and reduced openings")

        # every leaf hash up front, in one grouped launch: the four oracles'
        # rows and each fold step's coset leaf ((re, im) interleaved) are all
        # proof data, so none waits for another
        for o in range(4):
            if a[f"leaves_{o}"].shape[-1] != tpl.oracle_widths[o]:
                raise ValueError(f"leaves_{o} rows have {a[f'leaves_{o}'].shape[-1]} elements, expected {tpl.oracle_widths[o]}")
        leaf_digests = th.sponge_rows_grouped(
            [a[f"leaves_{o}"] for o in range(4)]
            + [a[f"step_evals_{s}"].reshape(B, Q, 2 << st["arity_bits"]) for s, st in enumerate(tpl.steps)],
            self.poseidon,
        )
        self._stage("fri: leaf hashes")

        # initial tree checks: the four oracles walk as one stacked batch
        digests = torch.stack(leaf_digests[:4], dim=1)  # (B, 4, Q, 4)
        sibs = torch.stack([a[f"sibs_{o}"] for o in range(4)], dim=1)  # (B, 4, Q, L, 4)
        caps = torch.stack([a[k] for k in ("cap_cs", "cap_w", "cap_zp", "cap_q")], dim=1)  # (B, 4, cap, 4)
        cap_b = caps.unsqueeze(2).expand(B, 4, Q, *caps.shape[2:])
        idx4 = qidx.unsqueeze(1).expand(B, 4, Q)
        merkle_ok = merkle_batched(digests, idx4, sibs, cap_b, tpl.initial_path_len, self.poseidon).all(dim=1)  # (B, Q)
        self._stage("fri: initial Merkle walks")

        # combineInitial
        npp = -(-tpl.n_sigmas // common.quotient_degree_factor)
        pp_leaf = a["leaves_2"]
        oracle_pp = pp_leaf[..., : r * npp]
        oracle_lookup = pp_leaf[..., r * npp :]
        first_batch = torch.cat([a["leaves_0"], a["leaves_1"], oracle_pp, a["leaves_3"], oracle_lookup], dim=-1)
        second_batch = torch.cat([oracle_pp[..., :r], oracle_lookup], dim=-1)
        g0 = horner_ext(tf.ext_from_base(first_batch), bq(fri_alpha))
        g1 = horner_ext(tf.ext_from_base(second_batch), bq(fri_alpha))

        rev_idx = _bit_reverse(qidx, tpl.lde_bits)
        point_x = tf.ext_from_base(tf.mul(const(gf.MULT_GEN), tf.pow_dynamic(const(tpl.g_lde), rev_idx, tpl.lde_bits)))
        zeta_bq = bq(zeta)
        omega_zeta = tf.escale(const(tpl.g_small), zeta_bq)
        one_div = tf.ext_div(g0 - bq(y0), point_x - zeta_bq)
        two_div = tf.ext_div(g1 - bq(y1), point_x - omega_zeta)
        alpha_m2 = tf.ext_pow_const(bq(fri_alpha), tpl.n_zs + tpl.n_lookup)
        eval_cur = tf.emul(alpha_m2, one_div) + two_div  # (B, Q)
        self._stage("fri: combineInitial")

        # folding
        fold_ok = torch.ones((B, Q), dtype=torch.bool, device=dev)
        idx = qidx
        for s, st in enumerate(tpl.steps):
            abits = st["arity_bits"]
            arity = 1 << abits
            evals = a[f"step_evals_{s}"]  # (B, Q, A, 2)
            evals_ext = GExt(evals[..., 0], evals[..., 1])  # (B, Q, A)
            # Merkle check of the coset leaf
            new_idx = idx >> abits
            cap = a[f"step_cap_{s}"]
            cap_b = cap.unsqueeze(1).expand(B, Q, *cap.shape[1:])
            ok_m = merkle_batched(leaf_digests[4 + s], new_idx, a[f"step_sibs_{s}"], cap_b, st["path_len"], self.poseidon)
            # the running evaluation matches the opened coset slot
            slot = (idx & (arity - 1)).unsqueeze(-1)
            opened = GExt(evals_ext.re.gather(-1, slot).squeeze(-1), evals_ext.im.gather(-1, slot).squeeze(-1))
            fold_ok = fold_ok & ok_m & tf.ext_equal(opened, eval_cur)
            self._stage(f"fri: step {s} Merkle walk and opened slot")

            # coset fold: values to subgroup order, offset, IDFT, beta-Horner
            vals = evals_ext[..., getattr(self, f"_coset_perm_{s}")]
            bits_lvl = st["codeword_bits"]
            start = _bit_reverse((idx >> abits) << abits, bits_lvl)
            offset = tf.mul(
                const(tpl.level_shifts[s]),
                tf.pow_dynamic(const(gf.subgroup_generator(bits_lvl)), start, bits_lvl),
            )
            # y'_k = sum_j omega^{-jk} v_j
            wmat = getattr(self, f"_idft_{s}")  # (A, A)
            yprime = tf.ext_zeros((B, Q, arity), dev)
            for j in range(arity):
                yprime = yprime + tf.escale(wmat[:, j], vals[..., j].unsqueeze(-1))
            # y_k = (1/A) offset^{-k} y'_k; powers of offset^{-1} by doubling
            off_inv = tf.inv(offset)
            pows = tf.constant(1, (B, Q, 1), dev)
            cur = off_inv
            while pows.shape[-1] < arity:
                pows = torch.cat([pows, tf.mul(pows, cur.unsqueeze(-1))], dim=-1)
                if pows.shape[-1] < arity:
                    cur = tf.square(cur)
            ys = tf.escale(pows[..., :arity], yprime)
            folded = horner_ext(ys, bq(fri_betas[s]))
            eval_cur = tf.escale(const(gf.finv(arity % gf.P)), folded)
            idx = new_idx
            self._stage(f"fri: step {s} coset fold")

        # final polynomial
        x_final = tf.mul(
            const(tpl.level_shifts[len(tpl.steps)]),
            tf.pow_dynamic(
                const(gf.subgroup_generator(tpl.final_bits)),
                _bit_reverse(idx, tpl.final_bits),
                max(tpl.final_bits, 1),
            ),
        )
        F = tpl.final_poly_len
        fp_b = GExt(final_poly.re.unsqueeze(1).expand(B, Q, F), final_poly.im.unsqueeze(1).expand(B, Q, F))
        final_ok = tf.ext_equal(horner_ext(fp_b, tf.ext_from_base(x_final)), eval_cur)

        round_ok = merkle_ok & fold_ok & final_ok
        ok = pow_ok & round_ok.all(dim=1)
        self._stage("fri: final polynomial")
        return ok


def verify_batch(tpl: CircuitTemplate, arrays: Dict[str, np.ndarray], debug: bool = False, device=None):
    """One-call entry point, the counterpart of verifier_jax.verify_batch:
    flattened uint64 host arrays in, numpy verdicts out ("ok", "eqs_ok",
    "fri_ok", each (B,) bool; with debug=True also "debug", the challenge
    intermediates as uint64 arrays). Runs on the CUDA card unless `device`
    says otherwise, and raises where there is no card."""
    v = TorchVerifier(tpl, debug=debug, device=device)
    with torch.no_grad():
        out = v(v.prepare(arrays))

    def host(x):
        if isinstance(x, (tuple, list)):
            return type(x)(host(y) for y in x)
        return x.cpu().numpy() if x.dtype == torch.bool else tf.to_u64(x)

    return {k: {n: host(x) for n, x in val.items()} if k == "debug" else host(val) for k, val in out.items()}
