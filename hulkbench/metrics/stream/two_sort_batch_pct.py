"""stream.two_sort_batch_pct: the share of the batches the stream stepped
that took the two-sort step (ops/device_step.py group_scan_body: the
per-read sort, the flat unsigned sort and the values binning): the counter
`stream.two_sort_batches` over `stream.batches`, in %, both counted from
the reader's start, after the warm-up job. A program without the counter
leaves it nothing to read."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    counts = spans.counters()
    batches = counts.get("stream.batches", 0)
    if "stream.two_sort_batches" not in counts or not batches:
        return None
    return 100.0 * counts["stream.two_sort_batches"] / batches
