"""Per-layer metric readers, one module a metric, found by the metric's
name in BENCHMARK.json: `native.parse_Mbp_per_s` is
hulkbench/metrics/native/parse_Mbp_per_s.py.

A reader has `read(ctx) -> float | None` (None: nothing to read, and the
metric is left out of the line) and may have `start(ctx)`, called just
before the window opens (to reset a program counter). `ctx` is
hulkbench.run.Context.
"""
