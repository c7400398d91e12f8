"""Executor for a levelized gate program on int64 tensors.

`GateProgram` holds a `LevelizedProgram`'s index arrays as buffers and runs
it as a Python loop over levels on a (B, T) value tape: per level, the add
wave gathers with `index_select`, computes a + sign*b and scatters with
`index_copy_`, then the mul wave does the same with an extension multiply.
The tape is updated in place; it is private to one call.

Padded dummy ops all write slot 0. A scatter with duplicate indices has no
defined order on CUDA, which is harmless because no real op reads slot 0
(tests/test_torch_gates.py checks that).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..gates import CONST, LKPSEL, PI, SEL, WIRE

from ..ops import field as tf
from ..ops.field import GExt
from .levelize import LevelizedProgram

INPUT_KINDS = (SEL, LKPSEL, CONST, WIRE, PI)


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


class GateProgram(nn.Module):
    def __init__(self, lp: LevelizedProgram, device):
        super().__init__()
        self.n_tape = lp.n_tape
        self.input_slots = dict(lp.input_slots)
        self.n_levels = lp.n_levels
        self.register_buffer("lit_values", tf.from_u64(lp.lit_values, device))
        for name in ("add_src1", "add_src2", "add_dst", "mul_src1", "mul_src2", "mul_dst", "out_slots"):
            self.register_buffer(name, _idx(getattr(lp, name), device))
        self.register_buffer("add_sign", tf.from_u64(lp.add_sign, device))
        self.n_out_per_prog = [len(s) for s in lp.out_slots_per_prog]

    def forward(self, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False):
        """`inputs` maps var kind -> GExt of shape batch_shape + (count,).
        Returns the constraints, batch_shape + (n_out,); with per_prog=True a
        list of per-program constraint vectors instead."""
        batch_shape = tuple(batch_shape)
        nb = int(np.prod(batch_shape)) if batch_shape else 1
        device = self.lit_values.device
        parts = [tf.ext_zeros((nb, 1), device)]
        n_lits = self.lit_values.shape[0]
        if n_lits:
            parts.append(tf.ext_from_base(self.lit_values.expand(nb, n_lits)))
        for kind in INPUT_KINDS:
            _, w = self.input_slots[kind]
            if w:
                parts.append(inputs[kind].reshape(nb, w))
        used = sum(p.shape[-1] for p in parts)
        if self.n_tape > used:
            parts.append(tf.ext_zeros((nb, self.n_tape - used), device))
        tape = tf.ext_concat(parts, dim=-1)  # (nb, T), written in place below

        def gather(idx):
            return GExt(tape.re.index_select(-1, idx), tape.im.index_select(-1, idx))

        def scatter(idx, val: GExt):
            tape.re.index_copy_(-1, idx, val.re)
            tape.im.index_copy_(-1, idx, val.im)

        for lvl in range(self.n_levels):
            a = gather(self.add_src1[lvl])
            b = gather(self.add_src2[lvl])
            sign = self.add_sign[lvl]
            scatter(self.add_dst[lvl], GExt(tf.add(a.re, tf.mul(sign, b.re)), tf.add(a.im, tf.mul(sign, b.im))))
            x = gather(self.mul_src1[lvl])
            y = gather(self.mul_src2[lvl])
            scatter(self.mul_dst[lvl], tf.emul(x, y))

        if not per_prog:
            return gather(self.out_slots).reshape(*batch_shape, -1)
        outs = []
        start = 0
        for n in self.n_out_per_prog:
            outs.append(gather(self.out_slots[start : start + n]).reshape(*batch_shape, n))
            start += n
        return outs


def run_levelized(lp: LevelizedProgram, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False):
    """One-shot form of `GateProgram(lp, device)(...)` on the inputs' device."""
    device = next(iter(inputs.values())).re.device
    return GateProgram(lp, device)(inputs, batch_shape, per_prog)
