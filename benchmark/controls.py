"""Faults planted in the timed path's output, to show that the comparison
which decides `correct` fails them. None of these runs in a measured run;
`run.py --control <name>` and benchmark/tests/ use them.

- skip_fri: the control. A verifier that checks the constraint equations
  and not the FRI opening proof (its proof of work, Merkle paths and folds):
  the program's `eqs_ok` stands for its verdict. It breaks the soundness that
  the configuration states, on every lane whose fault only FRI can see.
- stale: a step that returns its state unchanged: every batch gets the
  verdicts of the loop's first batch.
- half_batch: half of the batch left out: the second half's lanes get the
  first half's verdicts.
- flip_lane: an answer altered where it is produced: lane 0's verdict is
  inverted.
"""

from __future__ import annotations

import torch


def skip_fri(out: dict, k: int, state: dict) -> dict:
    return {**out, "ok": out["eqs_ok"], "fri_ok": torch.ones_like(out["fri_ok"])}


def stale(out: dict, k: int, state: dict) -> dict:
    return state.setdefault("first", out)


def half_batch(out: dict, k: int, state: dict) -> dict:
    def mirrored(x):
        h = x.shape[0] // 2
        return torch.cat([x[: x.shape[0] - h], x[:h]])

    return {key: mirrored(out[key]) for key in ("ok", "eqs_ok", "fri_ok")}


def flip_lane(out: dict, k: int, state: dict) -> dict:
    ok = out["ok"].clone()
    ok[0] = ~ok[0]
    return {**out, "ok": ok}


CONTROLS = {f.__name__: f for f in (skip_fri, stale, half_batch, flip_lane)}


def make(name: str):
    """The control `name` as the program's `control(out, k)` hook."""
    fn, state = CONTROLS[name], {}
    return lambda out, k: fn(out, k, state)
