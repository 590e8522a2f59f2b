"""stream.device_flush_pct: the share of the histosketch flushes that ran
on the card: the counter `flush.device` over `flush.device` plus
`flush.host` (stream/pipeline.py: each flush that ran, counted by its route:
the exact flush on the card, or the native host flush), in %, both counted
from the reader's start, after the warm-up job. A program without the
counters leaves it nothing to read."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    counts = spans.counters()
    device, host = counts.get("flush.device", 0), counts.get("flush.host", 0)
    if not device + host:
        return None
    return 100.0 * device / (device + host)
