"""stream.flush_wait_pct: the seconds the streaming thread waited on the
interval flush worker (stream/pipeline.py flush_stats["flush_waits"], a
program counter), over the window's jobs, as a share of their wall
seconds."""
from __future__ import annotations


def start(ctx) -> None:
    from hulk_tpu_torch.stream.pipeline import flush_stats

    flush_stats["flush_waits"].clear()


def read(ctx) -> float | None:
    from hulk_tpu_torch.stream.pipeline import flush_stats

    waits = flush_stats["flush_waits"]
    if not waits or ctx.window_s <= 0:
        return None
    return 100.0 * sum(waits) / ctx.window_s
