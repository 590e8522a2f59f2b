"""native.parse_team_pct: how wide the parallel parse of the host input
layer ran (native NativeFastqPacker._feed_par, in the hulk-parse thread)
against what -p asks: the counter `input.parse_team_threads` (the team
each hulk_pack_fastq_par call ran with) over `input.parse_par_calls`, over
the configuration's processors, in %. 100 where every parallel parse ran as
wide as -p; below where the host gave fewer threads. A program without the
counters, or one that parsed nothing in parallel, leaves it nothing to
read."""
from __future__ import annotations

from hulkbench import spans
from hulkbench.spans import start  # noqa: F401 -- turns the spans on


def read(ctx) -> float | None:
    counts = spans.counters()
    calls = counts.get("input.parse_par_calls", 0)
    if not calls:
        return None
    return 100.0 * counts.get("input.parse_team_threads", 0) / calls / ctx.config["processors"]
