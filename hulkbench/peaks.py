"""Peak rates of one NVIDIA H100 SXM (80 GB HBM3) and the least time of a
piece of work on it.

HBM bandwidth and FP64 are NVIDIA's data sheet (dense, no sparsity, at the
700 W limit). INT32 is derived, not published: 64 INT32 lanes an SM x 132
SMs x 1.98 GHz boost clock.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9  # derived: 16.7e12


def least_seconds(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The larger of bytes over HBM bandwidth and operations over their
    peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
