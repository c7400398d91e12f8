"""How `correct` is decided: every lane of every batch that the window
answered, and every lane's challenges, against the plain reference.

The reference (benchmark/reference/) judges each distinct input once, from
the same JSON documents the program was given, in processes of its own after
the window has closed and the program's state is freed. Each lane's expected
verdicts are those of the input it holds. Every number compared is a count
of lanes and its limit is 0: the configuration states exact verdicts.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from cell import VERDICTS

LIMITS = {"verdict_mismatch_lanes": 0, "challenge_mismatch_lanes": 0}


def _judge(args):
    from reference import judge

    return judge(*args)


def reference(common: dict, variants: list, generic_config: str) -> list:
    """The reference's verdicts and challenge words of each input under the
    cell's hasher (`generic_config`), a process an input up to the host's
    cores."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(len(variants), os.cpu_count() or 1), mp_context=ctx) as ex:
        return list(ex.map(_judge, [(common, v["vkey"], v["proof"], generic_config) for v in variants]))


def compare(records: list, plans: list, words: list, ref: list) -> dict:
    """The numbers compared, each with its limit."""
    verdicts = np.array([[r[k] for k in VERDICTS] for r in ref], dtype=bool).T  # (3, inputs)
    bad = sum(int((rec["lanes"] != verdicts[:, plans[rec["pool"]]]).any(axis=0).sum()) for rec in records)
    want = np.array([r["challenges"] for r in ref], dtype=np.uint64)  # (inputs, words): one circuit, one width
    bad_ch = 0
    for plan, got in zip(plans, words):
        if got.shape[1] != want.shape[1]:
            bad_ch += len(plan)
        else:
            bad_ch += int((got != want[plan]).any(axis=1).sum())
    values = {"verdict_mismatch_lanes": bad, "challenge_mismatch_lanes": bad_ch}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
