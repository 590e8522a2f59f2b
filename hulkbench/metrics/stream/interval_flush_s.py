"""stream.interval_flush_s: the median seconds of one interval flush in the
flush worker (`flush.interval` spans, stream/pipeline.py interval_flush:
the host drift flush and the snapshot write), over the spans that lie
wholly inside the window (ten a job at -i 1000000 over 10M reads)."""
from __future__ import annotations

import statistics

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    if not recs or win is None:
        return None
    d = [r.t1 - r.t0 for r in recs
         if r.name == "flush.interval" and r.t0 >= win[0] and r.t1 <= win[1]]
    return statistics.median(d) if d else None
