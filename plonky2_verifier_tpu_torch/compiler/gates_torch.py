"""Executor for a levelized gate program on int64 tensors.

`GateProgram` holds a `LevelizedProgram` as buffers in two forms and runs it
on a (B, T) value tape:

- on the card, one launch of the CUDA kernel (csrc/gates.cu) over the
  program as `pack_program` packs it for the slots the caller gathers: the
  real ops of `compact_ops` (the gate zoo's padded waves are 31x them) in
  a schedule of its own, on a tape whose slots are reused by liveness, each
  gathered value stored to its column when its op runs; packed once a
  gather (`GateProgram.pack`: the program's own outputs at its first card
  call, the verifier's gather when the verifier is built);
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

import heapq
from dataclasses import dataclass
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


STEP_OPS = 64  # ops a step of a packed schedule at most: one round of a block's threads (kernels.GATE_THREADS_A_LANE)
OP_ADD, OP_SUB, OP_MUL = 0, 1, 2  # the kinds of a packed op (csrc/gates.cu)
NO_SLOT = 0xFFFF  # a packed op's dst where no later op reads its value
MAX_COLUMNS = (1 << 14) - 1  # a packed op's column + 1 takes 14 bits


def n_init(lp: LevelizedProgram) -> int:
    """The program slots below the nodes: slot 0, the literals, the inputs."""
    return max([1 + len(lp.lit_values)] + [off + w for off, w in lp.input_slots.values()])


def pack_program(lp: LevelizedProgram, out_slots) -> Dict[str, np.ndarray]:
    """The program as csrc/gates.cu runs it, for the gathered program slots
    `out_slots` (n_out,) (0 reads zero; a slot may repeat or be an input):
    - only the ops that the gathered slots need, list-scheduled into steps
      of at most STEP_OPS ops, an op after every op it reads: each step
      takes its ready ops that free at least as many slots as they fill
      first, then the ones with the longest chain below them;
    - tape slots by liveness: an input or literal that an op reads gets a
      slot before the first step, an op's value that a later op reads gets
      one at its step, and a slot is free again from the step after its
      last read (the lowest free slot first);
    - each gathered node is stored to its first column by its op; the other
      columns are the tail: a program slot below the nodes, or a copy of
      the column that holds the same node.
    Returns int32 arrays `loads` (n_loads, 2) (tape slot, program slot),
    `step_off` (n_steps + 1,), `ops` (n_ops, 2), each op in 8 bytes as the
    kernel reads it (`encode_ops`: src1, src2, dst, kind and column + 1 in
    16, 16, 16, 2 and 14 bits; dst NO_SLOT where no later op reads the
    value, column -1 where it is not gathered), `tail` (n_tail, 2) (column,
    source: a program slot >= 0, or -(column + 1)); `origin` (n_ops,) the
    program slot each op writes; and `n_slots`, the tape's slots a lane,
    the most values live at once."""
    ops = compact_ops(lp)
    init = n_init(lp)
    out = np.asarray(out_slots, dtype=np.int64).reshape(-1)
    if out.size and not (0 <= out.min() and out.max() < lp.n_tape):
        raise ValueError(f"gathered slots outside the program's {lp.n_tape}")
    if out.size > MAX_COLUMNS:
        raise ValueError(f"{out.size} gathered slots, above the {MAX_COLUMNS} a packed op can name")
    prog = []  # (kind, src1, src2, dst) in level order
    for level in range(lp.n_levels):
        for s1, s2, neg, d in ops["adds"][ops["add_off"][level] : ops["add_off"][level + 1]].tolist():
            prog.append((OP_SUB if neg else OP_ADD, s1, s2, d))
        for s1, s2, d, _ in ops["muls"][ops["mul_off"][level] : ops["mul_off"][level + 1]].tolist():
            prog.append((OP_MUL, s1, s2, d))
    needed = {s for s in out.tolist() if s >= init}
    kept = []
    for op in reversed(prog):
        if op[3] in needed:
            kept.append(op)
            needed.update(s for s in op[1:3] if s >= init)
    prog = kept[::-1]

    readers: Dict[int, list] = {}  # program slot -> the ops that read it, each once
    for i, (_, s1, s2, _) in enumerate(prog):
        for s in {s1, s2}:
            readers.setdefault(s, []).append(i)
    height = [0] * len(prog)  # ops on the longest chain from here, this one included
    for i in range(len(prog) - 1, -1, -1):
        height[i] = 1 + max((height[j] for j in readers.get(prog[i][3], ())), default=0)
    unread = {s: len(r) for s, r in readers.items()}  # readers not yet scheduled
    waiting = [sum(1 for s in {s1, s2} if s >= init) for _, s1, s2, _ in prog]
    ready = [i for i, w in enumerate(waiting) if w == 0]
    steps = []
    while ready:
        def fills(i):  # slots taken less slots freed, were op i the next to run
            return (prog[i][3] in readers) - sum(unread[s] == 1 for s in set(prog[i][1:3]))

        ready.sort(key=lambda i: (fills(i) > 0, -height[i], i))
        step, ready = ready[:STEP_OPS], ready[STEP_OPS:]
        for i in step:
            for s in set(prog[i][1:3]):
                unread[s] -= 1
        for i in step:
            for j in readers.get(prog[i][3], ()):
                waiting[j] -= 1
                if waiting[j] == 0:
                    ready.append(j)
        steps.append(sorted(step))
    if sum(map(len, steps)) != len(prog):
        raise ValueError("the program's ops do not form a DAG over its inputs")

    step_of = {prog[i][3]: t for t, step in enumerate(steps) for i in step}
    last = {s: max(step_of[prog[j][3]] for j in r) for s, r in readers.items()}
    tape, free, released, n_slots = {}, [], {}, 0

    def take(s: int) -> int:
        nonlocal n_slots
        if free:
            slot = heapq.heappop(free)
        else:
            slot, n_slots = n_slots, n_slots + 1
        tape[s] = slot
        released.setdefault(last[s] + 1, []).append(slot)
        return slot

    loads = [(take(s), s) for s in sorted(readers) if s < init]
    first_col = {}
    tail = []
    for j, s in enumerate(out.tolist()):
        if s < init:
            tail.append((j, s))
        elif s in first_col:
            tail.append((j, -first_col[s] - 1))
        else:
            first_col[s] = j
    rows, origin = [], []
    for t, step in enumerate(steps):
        for slot in released.pop(t, ()):
            heapq.heappush(free, slot)
        for i in step:
            kind, s1, s2, d = prog[i]
            rows.append((tape[s1], tape[s2], take(d) if d in readers else NO_SLOT, kind, first_col.get(d, -1)))
            origin.append(d)
    if n_slots > NO_SLOT:
        raise ValueError(f"{n_slots} tape slots, above the {NO_SLOT} a packed op can name")
    as_i32 = lambda x, w: np.array(x, dtype=np.int32).reshape(-1, w)
    return {
        "loads": as_i32(loads, 2), "step_off": np.cumsum([0] + [len(x) for x in steps]).astype(np.int32),
        "ops": encode_ops(np.array(rows, dtype=np.int64).reshape(-1, 5)), "tail": as_i32(tail, 2),
        "origin": np.array(origin, dtype=np.int64), "n_slots": n_slots,
    }


def encode_ops(rows: np.ndarray) -> np.ndarray:
    """(n, 5) rows (src1, src2, dst, kind, column) -> the kernel's (n, 2)
    int32 words: src1 | src2 << 16 and dst | (kind | (column + 1) << 2) << 16."""
    src1, src2, dst, kind, col = rows.T
    words = np.stack([src1 | src2 << 16, dst | (kind | (col + 1) << 2) << 16], axis=1)
    return words.astype(np.uint32).view(np.int32).reshape(-1, 2)


def decode_ops(ops) -> np.ndarray:
    """`encode_ops` undone: (n, 2) words -> (n, 5) rows (src1, src2, dst,
    kind, column), dst NO_SLOT for none, column -1 for none."""
    w = np.asarray(ops).astype(np.int32).view(np.uint32).astype(np.int64).reshape(-1, 2)
    return np.stack([w[:, 0] & 0xFFFF, w[:, 0] >> 16, w[:, 1] & 0xFFFF, (w[:, 1] >> 16) & 3, (w[:, 1] >> 18) - 1], axis=1)


def step_barriers(step_off: np.ndarray, lanes: int) -> int:
    """The block barriers a block of `lanes` lanes passes in csrc/gates.cu:
    one after the initial tape and one after every step but one that fits
    a warp (ops x lanes <= 32) and is followed by another such."""
    narrow = np.diff(step_off) * lanes <= 32
    return 1 + int(len(narrow) - (narrow[:-1] & narrow[1:]).sum())


@dataclass
class PackedProgram:
    """`pack_program`'s arrays as the kernel takes them, on one device;
    counts of its ops by kind for the bound (chip_smoke.py)."""

    lits: torch.Tensor  # (n_lits,) the program's literals
    loads: torch.Tensor
    step_off: torch.Tensor
    ops: torch.Tensor
    tail: torch.Tensor
    n_slots: int
    n_out: int
    n_adds: int
    n_muls: int
    args: object = None  # the kernel library's launch arguments for it, laid out at its first launch

    @property
    def n_steps(self) -> int:
        return self.step_off.shape[0] - 1


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
        self.lp = lp
        self.out_slots_per_prog = lp.out_slots_per_prog
        self.n_out_per_prog = [len(s) for s in lp.out_slots_per_prog]
        self._own = None  # pack() of the program's own outputs, made at the first card call that gathers them

    def pack(self, out_slots=None) -> PackedProgram:
        """The program packed for the gathered slots `out_slots` (the
        program's own outputs where None; an integer array or tensor), on
        the device of the program's buffers. Packing takes the host's time:
        pack once a gather and pass the result to each call (forward's
        `packed`)."""
        slots = self.lp.out_slots if out_slots is None else out_slots
        slots = (slots.cpu().numpy() if isinstance(slots, torch.Tensor) else np.asarray(slots)).astype(np.int32).reshape(-1)
        p = pack_program(self.lp, slots)
        kind = decode_ops(p["ops"])[:, 3]
        t = lambda a: torch.from_numpy(a).to(self.lit_values.device)
        return PackedProgram(self.lit_values, t(p["loads"]), t(p["step_off"]), t(p["ops"]), t(p["tail"]), p["n_slots"],
                             len(slots), int((kind != OP_MUL).sum()), int((kind == OP_MUL).sum()))

    def forward(self, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False, out_slots=None, packed: PackedProgram = None):
        """`inputs` maps var kind -> GExt of shape batch_shape + (count,).
        Returns the constraints, batch_shape + (n_out,); with per_prog=True a
        list of per-program constraint vectors instead; with `out_slots`
        (an integer array or tensor of program slots, 0 for a zero) those
        slots instead. One launch of the CUDA kernel for CUDA inputs, on
        `packed`, the program packed for that gather (`pack`; the
        program's own, packed at the first call, where both are None),
        forward_plain for CPU inputs."""
        if per_prog and out_slots is not None:
            raise ValueError("per_prog splits the program's own outputs; out_slots replaces them")
        if next(iter(inputs.values())).re.device.type == "cpu":
            return self.forward_plain(inputs, batch_shape, per_prog, out_slots)
        return self._forward_kernel(inputs, batch_shape, per_prog, out_slots, packed)

    def _forward_kernel(self, inputs: Dict[str, GExt], batch_shape, per_prog: bool = False, out_slots=None,
                        packed: PackedProgram = None):
        """forward's card path: the inputs' (B, w) views and the program
        packed for the slots to gather go to one kernel launch."""
        from .. import kernels

        if packed is None:
            if out_slots is not None:
                raise ValueError("out_slots on the card takes the program packed for them (GateProgram.pack)")
            if self._own is None:
                self._own = self.pack()
            packed = self._own
        batch_shape = tuple(batch_shape)
        nb = int(np.prod(batch_shape)) if batch_shape else 1
        views = []
        for kind in INPUT_KINDS:
            offset, w = self.input_slots[kind]
            x = inputs[kind].reshape(nb, w) if w else None  # a view where the strides allow, as the call sites give
            views.append((offset, None if x is None else x.re, None if x is None else x.im))
        re, im = kernels.load().gate_program(views, packed)
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

        if out_slots is not None:
            out_slots = torch.as_tensor(out_slots, device=device).to(torch.int64)
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
