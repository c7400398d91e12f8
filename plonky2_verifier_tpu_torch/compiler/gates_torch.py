"""Executor for a levelized gate program on int64 tensors.

`GateProgram` holds a `LevelizedProgram` as buffers in two forms and runs it
on a (B, T) value tape:

- on the card, one launch of the CUDA kernel (csrc/gates.cu) over each
  level's real ops alone: the compact op lists of `compact_ops`, with CSR
  offsets a level and no padding (the gate zoo's padded waves are 31x its
  real ops);
- on the CPU, `forward_plain`: a Python loop over levels on the padded
  arrays; per level, the add wave gathers with `index_select`, computes
  a + sign*b and scatters with `index_copy_`, then the mul wave does the
  same with an extension multiply. The tape is updated in place; it is
  private to one call.

Padded dummy ops read and write slot 0 only (tests/test_torch_gates.py
checks that no real op reads it), so slot 0 stays zero: an output slot of 0
reads a zero constraint, which the verifier uses to gather its padded
(B, gates, constraints) layout in one step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..gates import CONST, LKPSEL, PI, SEL, WIRE

from ..ops import field as tf
from ..ops.field import GExt
from .levelize import P_MINUS_1, LevelizedProgram

INPUT_KINDS = (SEL, LKPSEL, CONST, WIRE, PI)


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def compact_ops(lp: LevelizedProgram) -> Dict[str, np.ndarray]:
    """The padded arrays' real ops (those that write a slot other than 0), a
    level's after the level before, as the kernel takes them (int32):
    `adds` (n_add, 4) rows (src1, src2, negate, dst) for dst = src1 + sign *
    src2 with sign p - 1 where negate is 1, else 1; `muls` (n_mul, 4) rows
    (src1, src2, dst, 0); `add_off` / `mul_off` (n_levels + 1,) the CSR
    offsets of each level's rows."""
    signs = np.unique(lp.add_sign[lp.add_dst != 0])
    if not set(signs.tolist()) <= {1, P_MINUS_1}:
        raise ValueError(f"add signs {signs} outside {{1, p - 1}}")
    out = {}
    for wave, cols in (("add", ("add_src1", "add_src2", "add_sign", "add_dst")), ("mul", ("mul_src1", "mul_src2", "mul_dst"))):
        arrays = [getattr(lp, c) for c in cols]
        real = arrays[-1] != 0
        rows = [a[real].astype(np.int64) for a in arrays]  # row-major: level by level
        if wave == "add":
            rows[2] = (arrays[2][real] == P_MINUS_1).astype(np.int64)
        else:
            rows.append(np.zeros_like(rows[0]))
        out[f"{wave}s"] = np.stack(rows, axis=1).astype(np.int32).reshape(-1, 4)
        out[f"{wave}_off"] = np.concatenate([[0], np.cumsum(real.sum(axis=1))]).astype(np.int32)
    return out


class GateProgram(nn.Module):
    def __init__(self, lp: LevelizedProgram, device):
        super().__init__()
        self.n_tape = lp.n_tape
        self.input_slots = dict(lp.input_slots)
        self.n_levels = lp.n_levels
        self.register_buffer("lit_values", tf.from_u64(lp.lit_values, device))
        # the padded arrays, for forward_plain
        for name in ("add_src1", "add_src2", "add_dst", "mul_src1", "mul_src2", "mul_dst", "out_slots"):
            self.register_buffer(name, _idx(getattr(lp, name), device))
        self.register_buffer("add_sign", tf.from_u64(lp.add_sign, device))
        # the compact op lists, for the kernel
        for name, a in compact_ops(lp).items():
            self.register_buffer(f"k_{name}", torch.from_numpy(a).to(device))
        self.register_buffer("k_out_slots", torch.from_numpy(lp.out_slots.astype(np.int32)).to(device))
        self.out_slots_per_prog = lp.out_slots_per_prog
        self.n_out_per_prog = [len(s) for s in lp.out_slots_per_prog]

    def forward(self, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False, out_slots=None):
        """`inputs` maps var kind -> GExt of shape batch_shape + (count,).
        Returns the constraints, batch_shape + (n_out,); with per_prog=True a
        list of per-program constraint vectors instead; with `out_slots`
        (an int32 tensor of tape slots, 0 for a zero) those slots instead.
        One launch of the CUDA kernel for CUDA inputs, forward_plain for
        CPU inputs."""
        if per_prog and out_slots is not None:
            raise ValueError("per_prog splits the program's own outputs; out_slots replaces them")
        if next(iter(inputs.values())).re.device.type == "cpu":
            return self.forward_plain(inputs, batch_shape, per_prog, out_slots)
        return self._forward_kernel(inputs, batch_shape, per_prog, out_slots)

    def _forward_kernel(self, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False, out_slots=None):
        """forward's card path: the inputs' (B, w) views, the program's
        buffers and the slots to gather go to one kernel launch."""
        from .. import kernels

        batch_shape = tuple(batch_shape)
        nb = int(np.prod(batch_shape)) if batch_shape else 1
        views = []
        for kind in INPUT_KINDS:
            offset, w = self.input_slots[kind]
            x = inputs[kind].reshape(nb, w) if w else None  # a view where the strides allow, as the call sites give
            views.append((offset, None if x is None else x.re, None if x is None else x.im))
        slots = self.k_out_slots if out_slots is None else out_slots
        re, im = kernels.load().gate_program(
            views, self.lit_values, self.k_add_off, self.k_adds, self.k_mul_off, self.k_muls, slots, self.n_tape
        )
        return self._split(GExt(re, im), batch_shape, per_prog)

    def forward_plain(self, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False, out_slots=None):
        """The padded program as a Python loop over levels, on any device."""
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

        out = gather(self.out_slots if out_slots is None else out_slots)
        return self._split(out, batch_shape, per_prog)

    def _split(self, out: GExt, batch_shape, per_prog: bool):
        """(nb, n_out) -> batch_shape + (n_out,), or per program when asked."""
        if not per_prog:
            return out.reshape(*batch_shape, out.shape[-1])
        outs = []
        start = 0
        for n in self.n_out_per_prog:
            outs.append(out[:, start : start + n].reshape(*batch_shape, n))
            start += n
        return outs


def run_levelized(lp: LevelizedProgram, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False):
    """One-shot form of `GateProgram(lp, device)(...)` on the inputs' device."""
    device = next(iter(inputs.values())).re.device
    return GateProgram(lp, device)(inputs, batch_shape, per_prog)
