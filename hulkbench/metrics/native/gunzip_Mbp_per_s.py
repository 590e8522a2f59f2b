"""native.gunzip_Mbp_per_s: the gzip inflate of the host input layer
(stream/fastq.py chunks_of, in the hulk-gunzip thread: libdeflate over a
whole file, or one 4 MB zlib read a step): the window's bases, in Mbp,
over the seconds its `input.gunzip` spans took in the window (program
spans, on the host clock)."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    if not recs or win is None:
        return None
    t = spans.seconds(recs, "input.gunzip", *win)
    return ctx.work["bases"] * len(ctx.jobs) / t / 1e6 if t > 0 else None
