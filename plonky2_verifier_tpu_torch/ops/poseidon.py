"""Poseidon-12 over Goldilocks on int64 tensors: the plain permutation, its
kernel wrapper, and the sponge / compress / Merkle-path helpers built on it.

State is an int64 tensor of shape (..., 12) (see ops/field.py). The
permutation is 4 full rounds, 22 partial rounds (S-box x^7 on lane 0 only)
and 4 full rounds; each round adds its round constants, applies the S-box
and then the MDS  y_i = sum_t CIRC[t] x_{(i+t) mod 12} + DIAG[i] x_i
(semantics: golden/poseidon.py, which carries the known-answer test).

`permutation` runs the CUDA kernel (csrc/permutation.cu) for a CUDA tensor
and `permutation_plain` for a CPU tensor; `permutation_scan`, the
transcript's chain of overwrite-and-permute steps, likewise. The round constants and the MDS
come from golden/poseidon_constants.py; the plain version reads them from a
`PoseidonConstants` module built on the caller's device (the card by default),
and the kernel reads the copy uploaded to constant memory when it loads.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..golden.poseidon import mds_matrix
from ..golden.poseidon_constants import ALL_ROUND_CONSTANTS

from . import field as tf

WIDTH = 12
N_ROUNDS = 30


class PoseidonConstants(nn.Module):
    """Buffers for the plain permutation: round constants (30, 12) and the
    full MDS matrix (12, 12), entries <= 49. They are built on `device`;
    `None` means the CUDA card and raises where there is none."""

    def __init__(self, device=None):
        super().__init__()
        device = tf.resolve_device(device)
        rc = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(N_ROUNDS, WIDTH)
        self.register_buffer("rc", tf.from_u64(rc, device))
        self.register_buffer("mds", torch.tensor(mds_matrix(), dtype=torch.int64, device=device))


def _sbox7(x):
    x2 = tf.mul(x, x)
    x3 = tf.mul(x2, x)
    x4 = tf.mul(x2, x2)
    return tf.mul(x3, x4)


def _mds(state, mds):
    """y = M x with M's entries <= 49: each 32-bit half of x is contracted
    exactly in int64 (sums < 2^42), then recombined and reduced once."""
    x_lo = state & tf.M32
    x_hi = tf.shr(state, 32)
    s_lo = (x_lo.unsqueeze(-2) * mds).sum(-1)
    s_hi = (x_hi.unsqueeze(-2) * mds).sum(-1)
    lo = s_lo + (s_hi << 32)
    hi = (s_hi >> 32) + tf.ult(lo, s_lo).to(torch.int64)
    return tf.reduce128(lo, hi)


def permutation_plain(state, consts: PoseidonConstants):
    """The 30-round permutation in plain PyTorch; state (..., 12)."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"state must end in {WIDTH} lanes, got {tuple(state.shape)}")
    rc, mds = consts.rc, consts.mds
    s = state
    for r in range(N_ROUNDS):
        s = tf.add(s, rc[r])
        if 4 <= r < 26:
            s = torch.cat([_sbox7(s[..., :1]), s[..., 1:]], dim=-1)
        else:
            s = _sbox7(s)
        s = _mds(s, mds)
    return s


def permutation(state, consts: PoseidonConstants):
    """The permutation on `state` (..., 12): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if state.device.type == "cpu":
        return permutation_plain(state, consts)
    from .. import kernels

    lead = state.shape[:-1]
    out = kernels.load().permutation(state.reshape(-1, WIDTH).contiguous())
    return out.reshape(*lead, WIDTH)


def permutation_scan_plain(data, ov_idx, ov_mask, consts: PoseidonConstants):
    """The transcript scan as a loop of plain permutations: data (B, n_data),
    the static schedule ov_idx, ov_mask (n_perms, 12) -> states
    (n_perms, B, 12). From a zero state, step i overwrites the masked lanes
    with data[:, ov_idx[i]], permutes, and records the state."""
    state = tf.zeros((data.shape[0], WIDTH), data.device)
    states = []
    for i in range(ov_idx.shape[0]):
        gathered = data.index_select(1, ov_idx[i])  # (B, 12)
        state = permutation_plain(torch.where(ov_mask[i], gathered, state), consts)
        states.append(state)
    if not states:
        return tf.zeros((0, data.shape[0], WIDTH), data.device)
    return torch.stack(states)


def permutation_scan(data, ov_idx, ov_mask, consts: PoseidonConstants):
    """The transcript scan: one launch of the CUDA kernel
    (csrc/permutation.cu, p2v_permutation_scan) for a CUDA tensor, the plain
    loop for a CPU tensor."""
    if data.device.type == "cpu":
        return permutation_scan_plain(data, ov_idx, ov_mask, consts)
    from .. import kernels

    return kernels.load().permutation_scan(data.contiguous(), ov_idx, ov_mask)


def sponge(inputs, width: int, consts: PoseidonConstants):
    """Rate-8 overwrite-mode sponge over rows (..., width) -> (..., 4)."""
    lead = inputs.shape[:-1]
    if width == 0:
        return tf.zeros(lead + (4,), inputs.device)
    state = tf.zeros(lead + (WIDTH,), inputs.device)
    for i in range(0, width, 8):
        chunk = inputs[..., i : min(i + 8, width)]
        state = permutation(torch.cat([chunk, state[..., chunk.shape[-1] :]], dim=-1), consts)
    return state[..., :4]


def compress(x, y, consts: PoseidonConstants):
    """2-to-1 digest compression; x, y (..., 4) -> (..., 4)."""
    state = torch.cat([x, y, torch.zeros_like(x)], dim=-1)
    return permutation(state, consts)[..., :4]


def verify_merkle_path(leaf_digest, index, siblings, cap, path_len: int, consts: PoseidonConstants):
    """Walk a Merkle path (the index bit orders current and sibling), then
    compare with the cap root that the residual index selects.

    leaf_digest (..., 4), index (...,) int64, siblings (..., path_len, 4),
    cap (..., cap_size, 4). Returns bool (...,)."""
    cur = leaf_digest
    for lvl in range(path_len):
        sib = siblings[..., lvl, :]
        is_left = (((index >> lvl) & 1) == 0).unsqueeze(-1)
        cur = compress(torch.where(is_left, cur, sib), torch.where(is_left, sib, cur), consts)
    return (cur == select_cap_root(cap, index >> path_len)).all(dim=-1)


def select_cap_root(cap, residual):
    """cap (..., cap_size, 4), residual (...,) -> the selected root (..., 4)."""
    idx = residual[..., None, None].expand(*residual.shape, 1, 4)
    return torch.gather(cap, -2, idx).squeeze(-2)
