"""native.parse_par_Mbp_per_s: the parallel parse of the host input layer
alone (native NativeFastqPacker._feed_par, in the hulk-parse thread: the
two OpenMP passes hulk_count_lines and hulk_pack_fastq_par, -p wide): the
window's bases, in Mbp, over the seconds of its `input.parse_par` spans in
the window (program spans, on the host clock). A program without the span
leaves it nothing to read."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    if not recs or win is None:
        return None
    t = spans.seconds(recs, "input.parse_par", *win)
    return ctx.work["bases"] * len(ctx.jobs) / t / 1e6 if t > 0 else None
