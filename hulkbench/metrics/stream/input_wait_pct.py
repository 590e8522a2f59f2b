"""stream.input_wait_pct: the share of the window in which the stream
thread waited on the host input for its next batch (`stream.input_wait`
spans, the consumer's get in stream/fastq.py prefetch_batches)."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    if not recs or win is None:
        return None
    se = spans.clipped(recs, "stream.input_wait", *win)
    if se.shape[0] == 0:
        return None
    return 100.0 * float((se[:, 1] - se[:, 0]).sum()) / ctx.window_s
