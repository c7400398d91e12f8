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
   openings, combineInitial, the coset folds (every step's in one kernel
   launch on the card: a step's fold needs none of the step before), the
   opened-slot checks, the final poly.

Field values are int64 tensors holding u64 bit patterns (ops/field.py). The
Poseidon chains go through ops/poseidon.py and ops/hash.py, the Horner sums
through `horner_ext` / `horner_scaled` here, every exponentiation and
inversion of a forward through one call each of ops/field's `pow_grouped`
and `inv_grouped` right after the transcript (`_powers_and_inverses`: every
exponent is a function of zeta, alpha and the query indices, every
denominator one of zeta and those powers), the gate constraints through
compiler/gates_torch's `GateProgram`, L0 with the partial products through
`partial_products`, the lookup argument through `lookup_checks` and every
fold step's coset fold through one call of `coset_folds`; each launches its
CUDA kernel for CUDA tensors and runs its `*_plain` version for CPU tensors.

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

from . import tracing
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


def horner_ext_plain(values: GExt, point: GExt) -> GExt:
    """sum_i point^i values[..., i], Horner from zero as in the JAX verifier
    (the first step's add also reduces a non-canonical proof value)."""
    acc = tf.ext_zeros(values.shape[:-1], point.re.device)
    for i in range(values.shape[-1] - 1, -1, -1):
        acc = values[..., i] + tf.emul(point, acc)
    return acc


def horner_scaled_plain(values: GExt, scale) -> GExt:
    """sum_i scale^i values[..., i] with a base-field scale. `scale` may carry
    extra trailing axes: values (B, K) with scale (B, r) -> (B, r)."""
    lead = values.shape[:-1]
    extra = tuple(scale.shape[len(lead) :])
    acc = tf.ext_zeros(tuple(lead) + extra, scale.device)
    for i in range(values.shape[-1] - 1, -1, -1):
        v = values[..., i].reshape(*lead, *((1,) * len(extra)))
        acc = v + tf.escale(scale, acc)
    return acc


def as_ext(x) -> GExt:
    """A GExt as given; an int64 tensor of base-field words as a GExt."""
    return x if isinstance(x, GExt) else tf.ext_from_base(x)


def horner_ext(values, point) -> GExt:
    """sum_i point^i values[..., i] for values (..., K) and point (...,),
    each a GExt or an int64 tensor of base-field words (imaginary part
    zero, never built). One launch of the CUDA kernel (csrc/field.cu) for
    CUDA tensors, horner_ext_plain for CPU tensors."""
    if (point if isinstance(point, torch.Tensor) else point.re).device.type == "cpu":
        return horner_ext_plain(as_ext(values), as_ext(point))
    return _horner_kernel(values, point)


def horner_scaled(values: GExt, scale) -> GExt:
    """horner_scaled_plain's sum: the CUDA kernel for CUDA tensors (the
    values broadcast over scale's extra axes as a stride-0 view)."""
    if scale.device.type == "cpu":
        return horner_scaled_plain(values, scale)
    k = values.shape[-1]
    shape = (*values.shape[:-1], *(1,) * (scale.dim() - len(values.shape[:-1])), k)
    return _horner_kernel(values.reshape(*shape).expand(*scale.shape, k), scale)


def horner_rows(values, point):
    """The arguments of KernelLibrary.horner for horner_ext(values, point):
    (v_re, v_im, p_re, p_im, v_rep, p_rep), v_im / p_im None for a
    base-field operand; None where the point has no element."""
    v_re, v_im = (values, None) if isinstance(values, torch.Tensor) else (values.re, values.im)
    p_re, p_im = (point, None) if isinstance(point, torch.Tensor) else (point.re, point.im)
    lead = p_re.dim()
    if tuple(v_re.shape[:-1]) != tuple(p_re.shape):
        raise ValueError(f"values {tuple(v_re.shape)} do not end a point of shape {tuple(p_re.shape)} in a coefficient axis")
    if not p_re.numel():
        return None
    (v_re, v_rep), (p_re, p_rep) = tf.broadcast_rows(v_re, lead), tf.broadcast_rows(p_re, lead)
    if v_im is not None:
        v_im, rep = tf.broadcast_rows(v_im, lead)
        if (rep, v_im.stride()) != (v_rep, v_re.stride()):  # the parts laid out unlike each other: one layout for both
            v_re, v_im, v_rep = v_re.repeat_interleave(v_rep, 0), v_im.repeat_interleave(rep, 0), 1
    if p_im is not None:
        p_im, rep = tf.broadcast_rows(p_im, lead)
        if (rep, p_im.stride()) != (p_rep, p_re.stride()):
            p_re, p_im, p_rep = p_re.repeat_interleave(p_rep, 0), p_im.repeat_interleave(rep, 0), 1
    return v_re, v_im, p_re, p_im, v_rep, p_rep


def _horner_kernel(values, point) -> GExt:
    from . import kernels

    p_re = point if isinstance(point, torch.Tensor) else point.re
    args = horner_rows(values, point)
    if args is None:
        return tf.ext_zeros(p_re.shape, p_re.device)
    re, im = kernels.load().horner(*args)
    return GExt(re.reshape(p_re.shape), im.reshape(p_re.shape))


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


def coset_fold_plain(evals, off_inv, beta: GExt, perm, wmat) -> GExt:
    """One FRI step's coset fold, the counterpart of verifier_jax.py:749-810:
    the opened coset values evals (B, Q, A, 2) to subgroup order (perm, the
    bit reversal), the IDFT (wmat[k, j] = omega^(-jk)), y_k scaled by
    off_inv^k (off_inv (B, Q) the inverse of the coset's offset), the Horner
    sum in beta (B,) and 1/A -> (B, Q)."""
    B, Q, arity = evals.shape[:3]
    dev = evals.device
    vals = GExt(evals[..., 0], evals[..., 1])[..., perm]
    # y'_k = sum_j omega^{-jk} v_j
    yprime = tf.ext_zeros((B, Q, arity), dev)
    for j in range(arity):
        yprime = yprime + tf.escale(wmat[:, j], vals[..., j].unsqueeze(-1))
    # y_k = (1/A) offset^{-k} y'_k; powers of offset^{-1} by doubling
    pows = tf.constant(1, (B, Q, 1), dev)
    cur = off_inv
    while pows.shape[-1] < arity:
        pows = torch.cat([pows, tf.mul(pows, cur.unsqueeze(-1))], dim=-1)
        if pows.shape[-1] < arity:
            cur = tf.square(cur)
    ys = tf.escale(pows[..., :arity], yprime)
    folded = horner_ext_plain(ys, GExt(beta.re.unsqueeze(1).expand(B, Q), beta.im.unsqueeze(1).expand(B, Q)))
    return tf.escale(tf.constant(gf.finv(arity % gf.P), (B, Q), dev), folded)


def coset_folds_plain(evals, off_invs, betas, perms, idfts) -> list:
    """coset_fold_plain of every fold step (lists, a step an item)."""
    return [coset_fold_plain(*step) for step in zip(evals, off_invs, betas, perms, idfts)]


def coset_folds(evals, off_invs, betas, perms, idfts) -> list:
    """coset_folds_plain's folds (every step over the same (B, Q)): one
    launch of the CUDA kernel (csrc/fold.cu) for all of them for CUDA
    tensors, the plain version for CPU tensors."""
    if not evals:
        return []
    if evals[0].device.type == "cpu":
        return coset_folds_plain(evals, off_invs, betas, perms, idfts)
    return _coset_folds_kernel(evals, off_invs, betas, idfts)


def _coset_folds_kernel(evals, off_invs, betas, idfts) -> list:
    from . import kernels

    out = kernels.load().coset_fold([(e, o, b.re, b.im, w) for e, o, b, w in zip(evals, off_invs, betas, idfts)])
    return [GExt(x[0], x[1]) for x in out]


def partial_products_plain(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg: int) -> GExt:
    """L0(zeta)(z - 1) a round and the partial-product transition checks,
    the counterpart of verifier_jax.py:345-385 -> the constraint vector's
    head (B, r + r n_chunks). zeta_n, l0_den_inv (the inverse of n (zeta -
    1)) and zeta (B,); zs and zs_next (B, r); pps (B, r npp); wires the
    routed columns and sigmas (B, ns); betas and gammas (B, r); k_is (ns,);
    n_chunks = ns / maxdeg."""
    B, r = zs.shape
    dev = zs.re.device
    one = tf.ext_constant(1, shape=(B,), device=dev)
    lag0 = tf.emul(zeta_n - one, l0_den_inv)
    zs1 = tf.emul(lag0.unsqueeze(1), zs - tf.ext_constant(1, shape=(B, 1), device=dev))  # (B, r)

    # all rounds, numerator and denominator in one tensor
    ns = sigmas.shape[1]
    n_chunks = ns // maxdeg
    beta_s = betas.unsqueeze(-1)  # (B, r, 1)
    gamma_s = gammas.unsqueeze(-1)
    routed = wires.unsqueeze(1)  # (B, 1, ns)
    bk = tf.mul(beta_s, k_is)  # (B, r, ns)
    bz = tf.escale(bk, zeta.unsqueeze(1).unsqueeze(1))
    numer = GExt(tf.add(tf.add(routed.re, bz.re), gamma_s), tf.add(routed.im, bz.im))
    bs = tf.escale(beta_s, sigmas.unsqueeze(1))
    denom = GExt(tf.add(tf.add(routed.re, bs.re), gamma_s), tf.add(routed.im, bs.im))
    nd = tf.ext_stack([numer, denom], dim=2).reshape(B, r, 2, n_chunks, maxdeg)
    prods = tree_prod_last(nd)  # (B, r, 2, n_chunks)
    pp_round = pps.reshape(B, r, pps.shape[1] // r)
    current = tf.ext_concat([zs.unsqueeze(-1), pp_round, zs_next.unsqueeze(-1)], dim=-1)
    pv = tf.ext_stack([current[..., :-1], current[..., 1:]], dim=2)  # (B, r, 2, n_chunks)
    pn = tf.emul(pv, prods)
    pp_vec = (pn[:, :, 0] - pn[:, :, 1]).reshape(B, r * n_chunks)
    return tf.ext_concat([zs1, pp_vec], dim=1)


def partial_products(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg: int) -> GExt:
    """partial_products_plain's head: one launch of the CUDA kernel
    (csrc/plonk.cu) for CUDA tensors, reading the openings' views where they
    lie; the plain version for CPU tensors."""
    if zs.re.device.type == "cpu":
        return partial_products_plain(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg)
    return _partial_products_kernel(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg)


def _partial_products_kernel(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg: int) -> GExt:
    from . import kernels

    pair = lambda x: (x.re, x.im)
    re, im = kernels.load().partial_products(
        pair(zeta_n), pair(l0_den_inv), pair(zs), pair(zs_next), pair(pps), pair(wires), pair(sigmas), betas.contiguous(),
        gammas.contiguous(), pair(zeta), k_is, maxdeg,
    )
    return GExt(re, im)


def lookup_tables(common, device):
    """The lookup tables as the lookup argument reads them, a constant of
    the template: each table padded with its first row to whole rows of
    num_routed_wires // 3 slots (golden/plonk.pad_lut), all of them one
    after the other as (rows, 2) words (input, output), and (luts + 1,) the
    first row of each and the end."""
    num_lut = common.config.num_routed_wires // 3
    rows, offsets = [], [0]
    for table in common.luts:
        total = -(-len(table) // num_lut) * num_lut
        rows += list(table) + [table[0]] * (total - len(table))
        offsets.append(len(rows))
    coeffs = tf.from_u64(np.array(rows, dtype=np.uint64).reshape(-1, 2), device)
    return coeffs, torch.tensor(offsets, dtype=torch.int64, device=device)


def lookup_checks_plain(lkp_sels: GExt, wires: GExt, lookup_zs: GExt, lookup_zs_next: GExt, deltas, coeffs, offsets,
                        num_routed_wires: int, maxdeg: int) -> GExt:
    """The log-derivative lookup equations at zeta, the counterpart of
    verifier_jax.py:468-642, all challenge rounds on a leading round axis.
    lkp_sels (B, 4 + luts), wires (B, num_wires), lookup_zs and
    lookup_zs_next (B, r * polys) with the layout [RE, SLDC_0 ...] a round,
    deltas r tuples (a, b, alpha, delta) of (B,) words, coeffs and offsets
    the padded tables (lookup_tables) -> (B, r * (4 + luts + 2 * n_sldc)),
    a round after the other, each [last_sldc, init_sum, init_re] ++
    finals_re ++ [re_trans] ++ interleaved (sum_trans, ldc_trans) per SLDC
    chunk."""
    r = len(deltas)
    B = wires.shape[0]
    dev = wires.re.device
    num_lu = num_routed_wires // 2  # (input, output) slots of a LookupGate row
    num_lut = num_routed_wires // 3  # (input, output, multiplicity) slots of a table row
    n_polys = lookup_zs.shape[1] // r
    n_sldc = n_polys - 1
    lu_deg = maxdeg - 1
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
    bounds = offsets.tolist()
    for k in range(len(bounds) - 1):
        acc = tf.zeros((B, r, 2), dev)
        for c in coeffs[bounds[k] : bounds[k + 1]]:
            acc = tf.add(tf.mul(dlv.unsqueeze(-1), acc), c)
        expected = tf.add(acc[..., 0], tf.mul(bv, acc[..., 1]))
        eq_finals.append(tf.emul(sel(4 + k), re_o - tf.ext_from_base(expected)))

    eq_last = tf.emul(sel(3), sldc[..., -1])
    eq_ini_sum = tf.emul(sel(2), sldc[..., 0])
    eq_ini_re = tf.emul(sel(2), re_o)
    singles = [eq_last, eq_ini_sum, eq_ini_re] + eq_finals + [eq_re_t]
    per_round = tf.ext_concat([e.unsqueeze(-1) for e in singles] + [inter], dim=-1)
    return per_round.reshape(B, r * per_round.shape[-1])


def lookup_checks(lkp_sels: GExt, wires: GExt, lookup_zs: GExt, lookup_zs_next: GExt, deltas, coeffs, offsets,
                  num_routed_wires: int, maxdeg: int, lanes=None) -> GExt:
    """lookup_checks_plain's equations: one launch of the CUDA kernel
    (csrc/plonk.cu) for CUDA tensors, reading the openings' views where they
    lie and the tables from the template's buffers, on the kernel's `lanes`
    (kernels.lookup_split; None has the wrapper read the offsets for them);
    the plain version for CPU tensors."""
    if wires.re.device.type == "cpu":
        return lookup_checks_plain(lkp_sels, wires, lookup_zs, lookup_zs_next, deltas, coeffs, offsets, num_routed_wires, maxdeg)
    return _lookup_checks_kernel(lkp_sels, wires, lookup_zs, lookup_zs_next, deltas, coeffs, offsets, num_routed_wires, maxdeg, lanes)


def _lookup_checks_kernel(lkp_sels: GExt, wires: GExt, lookup_zs: GExt, lookup_zs_next: GExt, deltas, coeffs, offsets,
                          num_routed_wires: int, maxdeg: int, lanes=None) -> GExt:
    from . import kernels

    B = wires.shape[0]
    stacked = torch.stack([x for d in deltas for x in d], dim=1).reshape(B, len(deltas), 4)
    pair = lambda x: (x.re, x.im)
    re, im = kernels.load().lookup_checks(pair(lkp_sels), pair(wires), pair(lookup_zs), pair(lookup_zs_next), stacked, coeffs, offsets,
                                          num_routed_wires, maxdeg, lanes)
    return GExt(re, im)


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
        # the padded lookup tables (none without lookups), a constant of the template
        coeffs, offsets = lookup_tables(common, device)
        self.register_buffer("_lut_coeffs", coeffs)
        self.register_buffer("_lut_off", offsets)
        # the lookup kernel's lanes, from the tables' lengths known here (none without lookups)
        self._lookup_lanes = None
        if common.num_lookup_polys > 0:
            from .kernels import lookup_split

            self._lookup_lanes = lookup_split(common.config.num_routed_wires, common.num_lookup_polys - 1,
                                              common.quotient_degree_factor, offsets.tolist())
        # the gate program's outputs in the padded (gates with constraints, n_gc)
        # layout, slot 0 (zero) in the padding: one gather, no concatenation
        n_gc = common.num_gate_constraints
        self._live_gates = [gi for gi, s in enumerate(self.gates.out_slots_per_prog) if len(s)]
        padded = np.zeros((len(self._live_gates), n_gc), dtype=np.int32)
        for k, gi in enumerate(self._live_gates):
            slots = self.gates.out_slots_per_prog[gi]
            if len(slots) > n_gc:
                raise ValueError(f"gate {gi} has {len(slots)} constraints, above num_gate_constraints {n_gc}")
            padded[k, : len(slots)] = slots
        self._gate_out_slots = padded.reshape(-1)
        # the kernel's program for this gather, packed once (the CPU path runs the padded arrays)
        self._gate_packed = self.gates.pack(self._gate_out_slots) if self._k_is.device.type == "cuda" else None

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

        # the forward's fixed-generator powers (pow_grouped): combineInitial's
        # query points MULT_GEN g_lde^rev(idx), each fold step's coset offset
        # shift_s w_s^rev((idx_s >> a_s) << a_s) and the final x, idx_s the
        # query index shifted by the arity bits before step s; each
        # generator's table of 2^k powers a buffer on this device
        shift, gens = 0, [(tpl.g_lde, tpl.lde_bits, gf.MULT_GEN, 0, 0)]
        for s, st in enumerate(tpl.steps):
            bits_lvl = st["codeword_bits"]
            gens.append((gf.subgroup_generator(bits_lvl), bits_lvl, tpl.level_shifts[s], shift, st["arity_bits"]))
            shift += st["arity_bits"]
        gens.append((gf.subgroup_generator(tpl.final_bits), tpl.final_bits, tpl.level_shifts[len(tpl.steps)], shift, 0))
        self._gen_powers = []
        for k, (g, bits, factor, shift, clear) in enumerate(gens):
            self.register_buffer(f"_pow_table_{k}", tf.from_u64(tf.power_table(g, bits), device))
            self._gen_powers.append(tf.GeneratorPower(g, bits, factor, shift, clear, getattr(self, f"_pow_table_{k}")))

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
        slices' (parallel/mesh.py). Traced (tracing.py) in the span
        "forward", its stages "challenges", "plonk_checks" and "fri_checks",
        and their parts."""
        with tracing.forward(self._ov_idx.device):
            return self._verify(a, queries)

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
        with tracing.span("challenges"):
            pi_hash = th.sponge_rows(a["public_inputs"], tpl.n_pi, self.poseidon)
            tracing.mark("pi hash")
            ch = self._run_transcript(self._transcript_data(a, pi_hash))
            tracing.mark("transcript")
            betas, gammas, alphas = ch["betas"], ch["gammas"], ch["alphas"]
            zeta = GExt(*ch["zeta"])
            fri_alpha = GExt(*ch["fri_alpha"])
            fri_betas = [GExt(*ch[f"fri_beta_{i}"]) for i in range(len(tpl.steps))]
            pow_response = ch["pow_response"][0]
            # lde_n <= 2^32, so the index is a low-bit mask of the canonical u64
            qidx = torch.stack([q & (tpl.lde_n - 1) for q in ch["query_indices"]], dim=1)  # (B, Q)
            fri_qidx = qidx if queries is None else qidx[:, q0:q1]
            pw = self._powers_and_inverses(zeta, fri_alpha, fri_qidx)
            tracing.mark("powers and inverses")

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

        with tracing.span("plonk_checks"):
            eqs_ok = self._plonk_checks(
                pi_hash, constants, sigmas, wires, zs, zs_next, pps, lookup_zs, lookup_zs_next, quots,
                betas, gammas, alphas, deltas, zeta, pw,
            )
        with tracing.span("fri_checks"):
            fri_ok = self._fri_checks(a, o1, o2, fri_alpha, fri_betas, pow_response, fri_qidx, final_poly, pw)

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

    # -- powers and inverses ------------------------------------------------------
    def _powers_and_inverses(self, zeta: GExt, fri_alpha: GExt, qidx):
        """Every exponentiation and inversion of a forward, one pow_grouped
        and one inv_grouped call: zeta^n, alpha^(n_zs + n_lookup), the query
        points x, each fold step's coset offset and the final x; then the
        inverses of L0's denominator n (zeta - 1), of x - zeta and x - omega
        zeta (combineInitial's, through their norms) and of each offset.
        qidx (B, Q) are the query indices FRI checks."""
        tpl = self.tpl
        B, Q = qidx.shape
        dev = qidx.device
        (x, *offsets, x_final), (zeta_n, alpha_m) = tf.pow_grouped(
            qidx, self._gen_powers, [(zeta, tpl.n), (fri_alpha, tpl.n_zs + tpl.n_lookup)]
        )
        l0_den = tf.escale(tf.constant(tpl.n % gf.P, (B,), dev), zeta - tf.ext_constant(1, shape=(B,), device=dev))
        point = tf.ext_from_base(x)
        zeta_bq = GExt(zeta.re.unsqueeze(1).expand(B, Q), zeta.im.unsqueeze(1).expand(B, Q))
        dens = [l0_den, point - zeta_bq, point - tf.escale(tf.constant(tpl.g_small, (B, Q), dev), zeta_bq)]
        inverses = tf.inv_grouped([tf.ext_norm(d) for d in dens] + offsets)
        l0_inv, one_inv, two_inv = (tf.ext_inv_with(d, i) for d, i in zip(dens, inverses))
        return {"zeta_n": zeta_n, "alpha_m": alpha_m, "l0_den_inv": l0_inv, "one_den_inv": one_inv, "two_den_inv": two_inv,
                "offset_invs": inverses[len(dens):], "x_final": x_final}

    # -- plonk ----------------------------------------------------------------------
    def _plonk_checks(
        self, pi_hash, constants, sigmas, wires, zs, zs_next, pps, lookup_zs, lookup_zs_next, quots,
        betas, gammas, alphas, deltas, zeta, pw,
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

        # L0(zeta)(z - 1) and the partial products: the constraint vector's head (B, r + r n_chunks)
        zeta_n = pw["zeta_n"]
        head = partial_products(zeta_n, pw["l0_den_inv"], zs, zs_next, pps, wires[:, : tpl.n_sigmas], sigmas,
                                torch.stack(betas, dim=1), torch.stack(gammas, dim=1), zeta, self._k_is, maxdeg)
        tracing.mark("plonk: L0 and partial products")

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
        live = self._live_gates
        cons_all = self.gates(inputs, (B,), out_slots=self._gate_out_slots, packed=self._gate_packed).reshape(B, len(live), n_gc)
        acc = tf.ext_zeros((B, n_gc), dev)
        if live:
            sel_live = sel_values[:, live]
            acc = ext_sum_axis(tf.emul(sel_live.unsqueeze(-1), cons_all), axis=1)
        tracing.mark("plonk: selectors and gate program")

        # assemble, alpha-combine, quotient equation
        lookup_vec = []
        if common.num_lookup_polys > 0:
            lookup_vec = [lookup_checks(lkp_sels, wires, lookup_zs, lookup_zs_next, deltas, self._lut_coeffs, self._lut_off,
                                        common.config.num_routed_wires, maxdeg, lanes=self._lookup_lanes)]
        tracing.mark("plonk: lookup argument")
        constraint_vec = tf.ext_concat([head] + lookup_vec + [acc], dim=1)  # (B, K)
        combined = horner_scaled(constraint_vec, torch.stack(alphas, dim=1))  # (B, r)
        quots_r = quots.reshape(B, r, maxdeg)
        q = horner_ext(quots_r, zeta_n.unsqueeze(1).expand(B, r))
        zn1 = zeta_n - tf.ext_constant(1, shape=(B,), device=dev)
        ok = tf.ext_equal(tf.emul(q, zn1.unsqueeze(1)), combined)  # (B, r)
        ok = ok.all(dim=1)
        tracing.mark("plonk: alpha combination and quotient")
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
        """The lookup equations of this template by the plain version
        (lookup_checks_plain on its padded tables), the counterpart of
        verifier_jax.py  _lookup_checks."""
        common = self.tpl.common
        return lookup_checks_plain(lkp_sels, wires, lookup_zs, lookup_zs_next, deltas, self._lut_coeffs, self._lut_off,
                                   common.config.num_routed_wires, common.quotient_degree_factor)

    # -- FRI ------------------------------------------------------------------------
    def _fri_checks(self, a, o1, o2, fri_alpha, fri_betas, pow_response, qidx, final_poly, pw):
        tpl = self.tpl
        common = tpl.common
        B, Q = qidx.shape
        r = tpl.r
        dev = qidx.device

        def bq(x: GExt) -> GExt:
            return GExt(x.re.unsqueeze(1).expand(B, Q), x.im.unsqueeze(1).expand(B, Q))

        # proof of work: the top pow_bits bits of the response are zero
        if tpl.pow_bits:
            pow_ok = tf.shr(pow_response, 64 - tpl.pow_bits) == 0
        else:
            pow_ok = torch.ones((B,), dtype=torch.bool, device=dev)

        # reduced openings
        y0 = horner_ext(o1, fri_alpha)  # (B,)
        y1 = horner_ext(o2, fri_alpha)
        tracing.mark("fri: proof of work and reduced openings")

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
        tracing.mark("fri: leaf hashes")

        # initial tree checks: the four oracles walk as one stacked batch
        digests = torch.stack(leaf_digests[:4], dim=1)  # (B, 4, Q, 4)
        sibs = torch.stack([a[f"sibs_{o}"] for o in range(4)], dim=1)  # (B, 4, Q, L, 4)
        caps = torch.stack([a[k] for k in ("cap_cs", "cap_w", "cap_zp", "cap_q")], dim=1)  # (B, 4, cap, 4)
        cap_b = caps.unsqueeze(2).expand(B, 4, Q, *caps.shape[2:])
        idx4 = qidx.unsqueeze(1).expand(B, 4, Q)
        merkle_ok = merkle_batched(digests, idx4, sibs, cap_b, tpl.initial_path_len, self.poseidon).all(dim=1)  # (B, Q)
        tracing.mark("fri: initial Merkle walks")

        # combineInitial
        npp = -(-tpl.n_sigmas // common.quotient_degree_factor)
        pp_leaf = a["leaves_2"]
        oracle_pp = pp_leaf[..., : r * npp]
        oracle_lookup = pp_leaf[..., r * npp :]
        first_batch = torch.cat([a["leaves_0"], a["leaves_1"], oracle_pp, a["leaves_3"], oracle_lookup], dim=-1)
        second_batch = torch.cat([oracle_pp[..., :r], oracle_lookup], dim=-1)
        g0 = horner_ext(first_batch, bq(fri_alpha))  # base-field values
        g1 = horner_ext(second_batch, bq(fri_alpha))

        # (g0 - y0) / (x - zeta) and (g1 - y1) / (x - omega zeta), the inverses from _powers_and_inverses
        one_div = tf.emul(g0 - bq(y0), pw["one_den_inv"])
        two_div = tf.emul(g1 - bq(y1), pw["two_den_inv"])
        eval_cur = tf.emul(bq(pw["alpha_m"]), one_div) + two_div  # (B, Q)
        tracing.mark("fri: combineInitial")

        # every step's coset fold at once: a step's fold reads its own opened
        # coset, offset and beta, and the step before is only compared with
        # its opened slot below
        steps = range(len(tpl.steps))
        folds = coset_folds([a[f"step_evals_{s}"] for s in steps], pw["offset_invs"], fri_betas,
                            [getattr(self, f"_coset_perm_{s}") for s in steps], [getattr(self, f"_idft_{s}") for s in steps])
        if tpl.steps:
            tracing.mark("fri: coset folds")

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
            eval_cur = folds[s]
            idx = new_idx
            tracing.mark(f"fri: step {s} Merkle walk and opened slot")

        # final polynomial at x_final = shift_F w_F^rev(idx_F)
        x_final = pw["x_final"]
        F = tpl.final_poly_len
        fp_b = GExt(final_poly.re.unsqueeze(1).expand(B, Q, F), final_poly.im.unsqueeze(1).expand(B, Q, F))
        final_ok = tf.ext_equal(horner_ext(fp_b, x_final), eval_cur)  # a base-field point

        round_ok = merkle_ok & fold_ok & final_ok
        ok = pow_ok & round_ok.all(dim=1)
        tracing.mark("fri: final polynomial")
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
