"""The program's own spans (hulk_tpu_torch.spans) in the benchmark's window.

The span readers (hulkbench/metrics/*) turn the spans on in `start`, which
the harness calls in --trace 1 runs only, after the warm-up job, so that
--trace 0 runs measure with spans off. A program without spans (an older
checkout) leaves them nothing to read: `records()` is None and they report
nothing.

Spans run on time.perf_counter(), the clock of the harness's jobs: the
window there starts at the first job's start and lasts `window_s`.
"""
from __future__ import annotations

import numpy as np


def start(ctx) -> None:
    try:
        from hulk_tpu_torch import spans
    except ImportError:
        return
    spans.enable(True)
    spans.reset()


def _program():
    try:
        from hulk_tpu_torch import spans
    except ImportError:
        return None
    return spans


def records() -> list | None:
    sp = _program()
    return sp.records() if sp is not None else None


def counters() -> dict:
    sp = _program()
    return sp.counters() if sp is not None else {}


def window(ctx) -> tuple[float, float] | None:
    """The window on perf_counter."""
    if not ctx.jobs or ctx.window_s <= 0:
        return None
    return ctx.jobs[0].t0, ctx.jobs[0].t0 + ctx.window_s


def clipped(recs: list, name: str, t0: float, t1: float) -> np.ndarray:
    """[n, 2] starts and ends of the spans `name`, clipped to [t0, t1],
    empty ones out."""
    se = np.array([[r.t0, r.t1] for r in recs if r.name == name], dtype=np.float64)
    if se.shape[0] == 0:
        return np.zeros((0, 2))
    se = np.clip(se, t0, t1)
    return se[se[:, 1] > se[:, 0]]


def seconds(recs: list, name: str, t0: float, t1: float) -> float:
    se = clipped(recs, name, t0, t1)
    return float((se[:, 1] - se[:, 0]).sum())


def self_seconds(recs: list, name: str, t0: float, t1: float) -> float:
    """The spans `name` inside [t0, t1] less the part their children on
    the same thread cover (a thread's spans nest, so the children of one
    span do not overlap)."""
    mine = {r.id: r for r in recs if r.name == name}
    total = seconds(recs, name, t0, t1)
    for r in recs:
        up = mine.get(r.parent)
        if up is not None and r.thread == up.thread:
            total -= max(0.0, min(r.t1, t1) - max(r.t0, t0))
    return total

