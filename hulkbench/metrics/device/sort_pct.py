"""device.sort_pct: the share of the card's busy time in the traced window
spent in sort kernels (torch.sort's and cub's, which `usort` in
hulk_tpu_torch/_u64.py launches: the two-sort step's per-read sort and
flat unsigned sort): the union of their intervals over the union of every
device operation's, as device.idle_pct takes it.

The name fragments matched (SORT_KERNELS), as a traced run of
reads-k31.samples on an H100 names the kernels: `radixSortKVInPlace`
(torch.sort along rows: at::native::radixSortKVInPlace<2, -1, 32, 32,
long, long, unsigned int>, one launch a batch) and `DeviceRadixSort` (the
flat sort in cub: DeviceRadixSortHistogramKernel,
DeviceRadixSortExclusiveSumKernel, and eight DeviceRadixSortOnesweepKernel
launches a batch). The index fill and the sign flips around them are not
counted."""
from __future__ import annotations

from hulkbench.trace import busy_intervals, busy_seconds

SORT_KERNELS = ("radixSortKVInPlace", "DeviceRadixSort")


def read(ctx) -> float | None:
    tr = ctx.trace
    if not tr or not tr["window"]:
        return None
    sorts = [op for op in tr["device_ops"] if any(n in op[0] for n in SORT_KERNELS)]
    u = busy_intervals(sorts, *tr["window"])
    if u.shape[0] == 0:
        return None
    return 100.0 * float((u[:, 1] - u[:, 0]).sum()) / busy_seconds(tr)
