"""native.inflate_member_pct: how much of the .gz input the host input
layer's member route inflates (stream/fastq.py, in the hulk-gunzip thread:
whole gzip members in the native inflater), against Python's zlib, which
takes a member past the route's cap: the counter
`input.inflate_member_bytes` over it plus `input.inflate_zlib_bytes`, in %,
both counted from the reader's start, after the warm-up job. A program
without the counters leaves it nothing to read."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    counts = spans.counters()
    member = counts.get("input.inflate_member_bytes", 0)
    total = member + counts.get("input.inflate_zlib_bytes", 0)
    return 100.0 * member / total if total else None
