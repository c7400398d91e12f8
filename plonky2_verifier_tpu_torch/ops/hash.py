"""The verifier's Poseidon chains: the row sponge and the Merkle path walk.

- `sponge_rows`: the rate-8 overwrite sponge over rows (..., width) ->
  (..., 4). A partial last chunk overwrites only `width % 8` lanes; width 0
  gives zeros.
- `sponge_rows_grouped`: the same sponge over several row tensors of
  different widths at once, one kernel launch on the card (none of the
  verifier's row hashes waits for another).
- `merkle_fold`: the L-level Merkle walk. At level l the index bit l orders
  (current, sibling); compress is the permutation of [left, right, 0^4],
  keeping lanes 0-3. Returns the root; the cap compare stays with the caller.

Each wrapper runs its CUDA kernel (csrc/sponge.cu, csrc/merkle.cu) for CUDA
tensors and its `*_plain` version, built on the plain permutation, for CPU
tensors. Leading axes are flattened into one row axis before a launch.
"""

from __future__ import annotations

import torch

from . import field as tf
from .poseidon import WIDTH, PoseidonConstants, permutation_plain


def sponge_rows_plain(rows, width: int, consts: PoseidonConstants):
    lead = rows.shape[:-1]
    state = tf.zeros(lead + (WIDTH,), rows.device)
    for c in range(0, width, 8):
        k = min(8, width - c)
        state = permutation_plain(torch.cat([rows[..., c : c + k], state[..., k:]], dim=-1), consts)
    return state[..., :4]


def sponge_rows(rows, width: int, consts: PoseidonConstants):
    if rows.shape[-1] != width:
        raise ValueError(f"rows end in {rows.shape[-1]} elements, expected {width}")
    if rows.device.type == "cpu":
        return sponge_rows_plain(rows, width, consts)
    from .. import kernels

    lead = rows.shape[:-1]
    out = kernels.load().sponge_rows(rows.reshape(lead.numel(), width).contiguous(), width)
    return out.reshape(*lead, 4)


def sponge_rows_grouped_plain(rows_list, consts: PoseidonConstants):
    return [sponge_rows_plain(rows, rows.shape[-1], consts) for rows in rows_list]


def sponge_rows_grouped(rows_list, consts: PoseidonConstants):
    """A list of rows (..., width_k) -> the list of their digests (..., 4)."""
    rows_list = list(rows_list)
    if all(rows.device.type == "cpu" for rows in rows_list):
        return sponge_rows_grouped_plain(rows_list, consts)
    from .. import kernels

    flat = [rows.reshape(rows.shape[:-1].numel(), rows.shape[-1]).contiguous() for rows in rows_list]
    outs = kernels.load().sponge_rows_grouped(flat)
    return [out.reshape(*rows.shape[:-1], 4) for out, rows in zip(outs, rows_list)]


def merkle_fold_plain(digest, index, sibs, path_len: int, consts: PoseidonConstants):
    cur = digest
    zero = torch.zeros_like(digest)
    for lvl in range(path_len):
        sib = sibs[..., lvl, :]
        is_left = (((index >> lvl) & 1) == 0).unsqueeze(-1)
        left = torch.where(is_left, cur, sib)
        right = torch.where(is_left, sib, cur)
        cur = permutation_plain(torch.cat([left, right, zero], dim=-1), consts)[..., :4]
    return cur


def merkle_fold(digest, index, sibs, path_len: int, consts: PoseidonConstants):
    """digest (..., 4), index (...,) int64, sibs (..., path_len, 4) -> root (..., 4)."""
    if sibs.shape[-2:] != (path_len, 4):
        raise ValueError(f"sibs end in {tuple(sibs.shape[-2:])}, expected ({path_len}, 4)")
    if digest.device.type == "cpu":
        return merkle_fold_plain(digest, index, sibs, path_len, consts)
    from .. import kernels

    lead = digest.shape[:-1]
    out = kernels.load().merkle_fold(
        digest.reshape(-1, 4).contiguous(),
        index.reshape(-1).contiguous(),
        sibs.reshape(-1, path_len, 4).contiguous(),
    )
    return out.reshape(*lead, 4)
