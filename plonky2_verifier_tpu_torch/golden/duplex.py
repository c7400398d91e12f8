"""Duplex sponge for Fiat–Shamir challenges — golden model.

Overwrite-mode duplex state machine, bit-exact to the reference spec
(Challenge/Pure.hs:27-107). Critical semantics:

- absorbing buffers up to 8 felts; the permutation fires lazily when a 9th
  felt arrives (buffer flushed by overwriting the first 8 lanes) or when a
  squeeze is requested with a pending buffer (overwriting only len(buffer)
  lanes).
- squeezing from a fresh state always permutes first; the output buffer is
  ``reversed(state[:8])`` (Plonky2 pops from the end), and refills with a new
  permutation once 8 outputs have been consumed.
- extension elements absorb as [re, im] and squeeze as two consecutive felts.

In addition to the stateful class, this module records an *event trace*
(`DuplexTrace`): the exact sequence of (overwrite-lane-count, permute)
steps and the (permutation#, lane#) coordinates of each squeezed output.
The TPU transcript compiler consumes this trace to build a static schedule
per circuit shape (the sequence is data-independent for a fixed shape).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Sequence, Tuple

from .poseidon import permutation

RATE = 8
WIDTH = 12


@dataclass
class DuplexTrace:
    """Structural log of a transcript run (data-independent per shape)."""

    # each permutation: list of (lane, absorb_stream_position) overwrites
    # applied just before it fired. Lanes not listed keep their value.
    permutes: List[List[Tuple[int, int]]] = dc_field(default_factory=list)
    # each squeezed felt: (permutation_index, state_lane) it was read from.
    squeezes: List[Tuple[int, int]] = dc_field(default_factory=list)
    n_absorbed: int = 0


class Duplex:
    def __init__(self) -> None:
        self.state = [0] * WIDTH
        self._buf: List[int] = []  # pending absorbs (buffered felts)
        self._buf_pos: List[int] = []  # absorb-stream positions of _buf
        self._out: List[int] = []  # pending squeeze outputs
        self._out_lane: List[int] = []  # state lane of each pending output
        self._squeeze_mode = False
        self.trace = DuplexTrace()

    # -- internals ----------------------------------------------------------
    def _permute_with(self, overwrite: Sequence[int], positions: Sequence[int]) -> None:
        s = list(overwrite) + self.state[len(overwrite) :]
        self.state = permutation(s)
        self.trace.permutes.append(list(zip(range(len(overwrite)), positions)))

    def _fresh_squeezing(self) -> None:
        # output buffer = reverse(state[:8]); lane of out[j] is 7-j.
        self._out = list(reversed(self.state[:RATE]))
        self._out_lane = list(reversed(range(RATE)))
        self._squeeze_mode = True

    # -- public API ---------------------------------------------------------
    def absorb(self, x: int) -> None:
        if self._squeeze_mode:
            self._squeeze_mode = False
            self._out = []
            self._out_lane = []
        if len(self._buf) == RATE:
            self._permute_with(self._buf, self._buf_pos)
            self._buf = []
            self._buf_pos = []
        self._buf.append(x)
        self._buf_pos.append(self.trace.n_absorbed)
        self.trace.n_absorbed += 1

    def absorb_many(self, xs: Sequence[int]) -> None:
        for x in xs:
            self.absorb(x)

    def absorb_ext(self, e) -> None:
        self.absorb(e[0])
        self.absorb(e[1])

    def absorb_digest(self, d) -> None:
        self.absorb_many(list(d))

    def absorb_cap(self, cap) -> None:
        for d in cap:
            self.absorb_digest(d)

    def squeeze(self) -> int:
        if not self._squeeze_mode:
            # flush pending absorbs (overwriting only len(buf) lanes), or
            # permute the raw state if the buffer is empty.
            self._permute_with(self._buf, self._buf_pos)
            self._buf = []
            self._buf_pos = []
            self._fresh_squeezing()
        if not self._out:
            self._permute_with([], [])
            self._fresh_squeezing()
        y = self._out.pop(0)
        lane = self._out_lane.pop(0)
        self.trace.squeezes.append((len(self.trace.permutes) - 1, lane))
        return y

    def squeeze_n(self, n: int) -> List[int]:
        return [self.squeeze() for _ in range(n)]

    def squeeze_ext(self):
        r = self.squeeze()
        i = self.squeeze()
        return (r, i)
