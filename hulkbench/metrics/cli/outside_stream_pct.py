"""cli.outside_stream_pct: the share of the window outside the stream's
batch loop (`stream.loop`, stream/pipeline.py run_sketch_pipeline): each
job's parameter check and set-up, the final wait on the flush worker, the
last flush and the writes, and the harness's time between jobs."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    if not recs or win is None:
        return None
    t = spans.seconds(recs, "stream.loop", *win)
    return 100.0 * (ctx.window_s - t) / ctx.window_s if t > 0 else None
