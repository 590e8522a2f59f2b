"""kernels.minimizer_roofline: the least time of the window's minimizer
work over the device time of csrc/minimizer_window.cu's kernels (every
hulk_minimizer_* entry) in the trace.

Counted from the input, whatever implements it: 40 u64 operations (two
INT32 each) at every position inside a record, against the derived INT32
peak; bytes: the bases read once at 3 bits (2-bit code and N bit) and each
record's distinct minimizers written once at 8 bytes, against HBM."""
from __future__ import annotations

from hulkbench.peaks import INT32_OPS_PER_S, least_seconds
from hulkbench.trace import kernel_seconds

KERNELS = ("minimizer_window_kernel", "minimizer_record_kernel")
U64_OPS_PER_POSITION = 40


def read(ctx) -> float | None:
    if not ctx.trace or not ctx.trace["window"]:
        return None
    t = kernel_seconds(ctx.trace, KERNELS)
    if t <= 0:
        return None
    bases = ctx.work["bases"] * len(ctx.jobs)
    keys = ctx.work["keys"] * len(ctx.jobs)
    least = least_seconds(3 / 8 * bases + 8 * keys, 2 * U64_OPS_PER_POSITION * bases,
                          INT32_OPS_PER_S)
    return 100.0 * least / t
