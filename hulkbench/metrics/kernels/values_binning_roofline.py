"""kernels.values_binning_roofline: the least time of the window's binning
over the device time of csrc/jump_hash.cu's jump_kernel in its values mode
alone (hulk_bin_scatter_values without dedup: the two-sort step's binning
of a whole sorted batch, equal neighbours counted), in the trace.

The least time is kernels.binning_roofline's count, from the reference's
work: 8 bytes a binned key and the int32 histogram once a flush against
HBM, two FP64 operations a jump iteration against the FP64 peak. The
values mode's instantiation is the trace's name fragment VALUES_KERNEL."""
from __future__ import annotations

import dataclasses

from hulkbench.metrics.kernels import binning_roofline

VALUES_KERNEL = "jump_kernel<((anonymous namespace)::Mode)2,"


def read(ctx) -> float | None:
    tr = ctx.trace
    if not tr or not tr["window"]:
        return None
    ops = [op for op in tr["device_ops"] if VALUES_KERNEL in op[0]]
    if not ops:
        return None
    return binning_roofline.read(dataclasses.replace(ctx, trace=dict(tr, device_ops=ops)))
