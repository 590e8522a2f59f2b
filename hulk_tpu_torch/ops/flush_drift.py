"""The histosketch flush with concept drift on a device, in two exact parts.

Counterpart of the drift branch of hulk_tpu/parallel/mesh.py:
sharded_flush_step (:271-296), a lax.scan over every bin. A bin whose
count is 0 changes nothing there, so both parts walk the live bins only,
in bin order:
  (a) the CMS scan: at each live bin every counter is multiplied by dw and
      squashed to +0 below the smallest normal f64, then the bin's counter
      in each row grows by its count; the bin's estimate is the minimum of
      those counters. These are the IEEE operations of the JAX scan and of
      the host flush (sketch/histosketch.py), so the result is bit-equal.
      (The kernel squashes once, at the end, with the same bits: a counter
      below the smallest normal stays below it until a count f >= 1 is
      added, beside which it rounds away.)
  (b) each slot's selection: in bin order, the slot takes a bin whose Aka
      is below weight / dw. It depends on the order (docs/PERF.md,
      "Decision record: no drift-mode device flush") and on no other slot,
      so slot stripes run it apart. With dw = 1 it is the no-drift rule
      (below the weight itself: the first index of the slot's minimum, where
      that is below the weight), which the exact device flush takes too.
Aka between the two is elementwise, with Go's Exp and Log (ops/cws_aka.py),
and the flush is parallel/mesh.py:sharded_flush_step. `*_torch` are the
plain versions, written as the JAX body is, one step a bin;
`cms_drift_scan` and `drift_select` take them for CPU tensors and the
Hopper kernels (ops/flush_drift_cuda.py) for CUDA tensors.
"""
from __future__ import annotations

import torch

# smallest normal f64: decayed counters below it are squashed to +0
TINY = 2.2250738585072014e-308


def cms_drift_scan_torch(freqs: torch.Tensor, row_bins: torch.Tensor, cms: torch.Tensor,
                         dw: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of (a): freqs [n] f64 (the live bins' counts in bin
    order), row_bins [depth, n] int64, cms [depth, width] f64 -> (the CMS
    after the n steps, each bin's estimate [n] f64). cms is not changed."""
    cms = cms.clone()
    rows = torch.arange(cms.shape[0], device=cms.device)
    esti = torch.empty_like(freqs)
    for i in range(freqs.shape[0]):
        cms = cms * dw
        cms = torch.where(cms >= TINY, cms, 0.0)
        cols = row_bins[:, i]
        cms[rows, cols] += freqs[i]
        esti[i] = cms[rows, cols].amin()
    return cms, esti


def drift_select_torch(aka: torch.Tensor, bins: torch.Tensor, sketch: torch.Tensor,
                       weights: torch.Tensor, dw: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of (b): aka [s, n] f64 (each slot's Aka of the n live
    bins in bin order), bins [n] int64, sketch [s] int64, weights [s] f64
    -> (sketch, weights) after the n steps."""
    for i in range(aka.shape[1]):
        better = aka[:, i] < weights / dw
        sketch = torch.where(better, bins[i], sketch)
        weights = torch.where(better, aka[:, i], weights)
    return sketch, weights


def cms_drift_scan(freqs: torch.Tensor, row_bins: torch.Tensor, cms: torch.Tensor,
                   dw: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(a): the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (which raises rather than fall back)."""
    if cms.device.type == "cpu":
        return cms_drift_scan_torch(freqs, row_bins, cms, dw)
    from hulk_tpu_torch.ops.flush_drift_cuda import cms_drift_scan_cuda

    return cms_drift_scan_cuda(freqs, row_bins, cms, dw)


def drift_select(aka: torch.Tensor, bins: torch.Tensor, sketch: torch.Tensor,
                 weights: torch.Tensor, dw: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(b): the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (which raises rather than fall back)."""
    if aka.device.type == "cpu":
        return drift_select_torch(aka, bins, sketch, weights, dw)
    from hulk_tpu_torch.ops.flush_drift_cuda import drift_select_cuda

    return drift_select_cuda(aka, bins, sketch, weights, dw)
