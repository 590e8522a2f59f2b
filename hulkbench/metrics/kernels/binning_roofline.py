"""kernels.binning_roofline: the least time of the window's binning
over the device time of csrc/jump_hash.cu's kernels (every
hulk_bin_scatter_* and hulk_jump_hash entry) in the trace.

Counted from the input: each record's distinct minimizers (8 bytes each,
the count the reference gives) read once and the int32 histogram written
once a flush, against HBM; two FP64 operations a jump iteration, the
iterations these keys take (the reference counts them), against the FP64
peak."""
from __future__ import annotations

from hulkbench.peaks import FP64_OPS_PER_S, least_seconds
from hulkbench.trace import kernel_seconds

KERNELS = ("jump_kernel",)


def read(ctx) -> float | None:
    if not ctx.trace or not ctx.trace["window"]:
        return None
    t = kernel_seconds(ctx.trace, KERNELS)
    if t <= 0:
        return None
    jobs = len(ctx.jobs)
    nbytes = (8 * ctx.work["keys"] + 4 * ctx.config["bins"] * ctx.work["flushes"]) * jobs
    least = least_seconds(nbytes, 2 * ctx.work["iterations"] * jobs, FP64_OPS_PER_S)
    return 100.0 * least / t
