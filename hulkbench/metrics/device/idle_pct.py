"""device.idle_pct: the share of the traced window in which no operation
ran on the card (kernels, copies, sets; the union of their intervals in
torch.profiler's trace)."""
from __future__ import annotations

from hulkbench.trace import busy_seconds


def read(ctx) -> float | None:
    tr = ctx.trace
    if not tr or not tr["window"] or not tr["device_ops"]:
        return None
    t0, t1 = tr["window"]
    return 100.0 * (1.0 - busy_seconds(tr) / (t1 - t0))
