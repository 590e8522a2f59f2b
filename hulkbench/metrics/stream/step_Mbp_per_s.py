"""stream.step_Mbp_per_s: the stream thread's host cost of enqueuing the
device step (`stream.step` spans, ops/device_step.py group_scan_body, one
a group of batches: the launches of the minimizer kernel, the sorts and
the binning, and the fused step's readbacks): the window's bases, in Mbp,
over the seconds of those spans in the window (program spans, on the
host clock)."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    if not recs or win is None:
        return None
    t = spans.seconds(recs, "stream.step", *win)
    return ctx.work["bases"] * len(ctx.jobs) / t / 1e6 if t > 0 else None
