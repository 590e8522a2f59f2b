"""native.inflate_ahead_pct: how much of the member route's inflated bytes
came from tasks that ran ahead of the exact position (stream/fastq.py at
-p > 1: tasks that started at a guessed member start on a worker thread
and whose start proved to be the exact end of the bytes before them): the
counter `input.inflate_ahead_bytes` over `input.inflate_member_bytes`, in
%, both counted from the reader's start, after the warm-up job. Nothing to
read where no member was inflated ahead (-p 1, a single-member file, or a
program without the counter)."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    counts = spans.counters()
    ahead = counts.get("input.inflate_ahead_bytes", 0)
    member = counts.get("input.inflate_member_bytes", 0)
    return 100.0 * ahead / member if ahead and member else None
