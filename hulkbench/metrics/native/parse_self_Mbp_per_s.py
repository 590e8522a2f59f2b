"""native.parse_self_Mbp_per_s: the native parse of the host input layer
(stream/fastq.py batch_reads_native, in the hulk-parse thread): the
window's bases, in Mbp, over the self time of its `input.parse` spans in
the window, that is less the `input.chunk_wait` inside them, where the
parse waits on the gunzip thread (program spans, on the host clock)."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    if not recs or win is None:
        return None
    t = spans.self_seconds(recs, "input.parse", *win)
    return ctx.work["bases"] * len(ctx.jobs) / t / 1e6 if t > 0 else None
