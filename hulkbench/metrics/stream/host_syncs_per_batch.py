"""stream.host_syncs_per_batch: the host's waits on the device a batch:
the `stream.sync` spans that start in the window (each readback of the
device stream: the fused step's one a batch, the two-sort step's with
sketches, a long record's one, the drains, the minimizer count, the sketch
states; not the device flusher's of --deviceFlush) over the batches the
stream stepped, a long record counting as one (the `stream.batches`
counter, counted from the reader's start, after the warm-up job)."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    recs, win = spans.records(), spans.window(ctx)
    batches = spans.counters().get("stream.batches", 0)
    if not recs or win is None or not batches:
        return None
    n = sum(1 for r in recs if r.name == "stream.sync" and win[0] <= r.t0 < win[1])
    return n / batches
