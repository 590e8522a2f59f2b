"""Wrappers of the Hopper drift-flush kernels (csrc/flush_drift.cu).

Replace the drift branch of hulk_tpu/parallel/mesh.py:sharded_flush_step
(:271-296, a lax.scan; hulk_tpu has no Pallas kernel for it):
`cms_drift_scan_cuda` runs the CMS scan with decay over the live bins
(plain version ops/flush_drift.py:cms_drift_scan_torch), and
`drift_select_cuda` each slot's selection (plain version
drift_select_torch). Each wrapper checks its inputs, allocates its
outputs, launches on PyTorch's current stream and counts its launches in
`launches` (one a call: the selection's two launches, its chunk minima
and its walk, count once). The inputs are left as they are.
"""
from __future__ import annotations

import ctypes

import torch

from hulk_tpu_torch.ops import _build

SOURCE = "hulk_tpu_torch/csrc/flush_drift.cu"
# launches of each entry in this process
launches = {"cms_drift_scan": 0, "drift_select": 0}

# the Aka a chunk minimum of the selection covers: of 256, 1,024 and 4,096,
# 256 was the fastest on a flush's Aka on the H100 (PERF.md)
SELECT_CHUNK = 256

_P, _LL, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
ARGTYPES = {
    # freqs, row_bins, n, cms_in, cms_out, depth, width, dw, est_rows, stream
    "hulk_cms_drift_scan": [_P, _P, _LL, _P, _P, _I, _I, _D, _P, _P],
    # aka, bins, n, s, dw, sketch_in, weights_in, sketch_out, weights_out,
    # chunk_min, chunk, stream
    "hulk_drift_select": [_P, _P, _LL, _I, _D, _P, _P, _P, _P, _P, _LL, _P],
}


def entry(name: str):
    """The bound C entry (for callers that queue launches themselves)."""
    return _build.entry(name, ARGTYPES[name])


def _check(what: str, device: torch.device, **tensors) -> None:
    """Every tensor contiguous, on `device` (a CUDA device), with the dtype
    and number of dimensions its name is given as (dtype, dim)."""
    if device.type != "cuda":
        raise ValueError(f"{what}: the tensors must be on a CUDA device")
    for name, (t, dtype, dim) in tensors.items():
        if t.device != device or t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dim}-D {dtype} tensor "
                             f"on {device}")


def _check_dw(what: str, dw: float) -> None:
    """dw = exp(-decay ratio) in [0, 1]: 0 at -x 0; 1 makes the selection the
    no-drift rule (Aka below the weight itself)."""
    if not 0.0 <= dw <= 1.0:
        raise ValueError(f"{what}: the decay weight must be in [0, 1], got {dw}")


def cms_drift_scan_cuda(freqs: torch.Tensor, row_bins: torch.Tensor, cms: torch.Tensor,
                        dw: float) -> tuple[torch.Tensor, torch.Tensor]:
    """freqs [n] f64 (the live bins' counts in bin order, integers >= 1),
    row_bins [depth, n] int64 (their counters, each in [0, width)), cms
    [depth, width] f64 (0 or at least the smallest normal, as a flush
    leaves it), on one CUDA device -> (the CMS after the n steps, each
    bin's estimate [n] f64)."""
    what = "cms_drift_scan_cuda"
    _check(what, cms.device, freqs=(freqs, torch.float64, 1),
           row_bins=(row_bins, torch.int64, 2), cms=(cms, torch.float64, 2))
    _check_dw(what, dw)
    depth, width = cms.shape
    n = freqs.shape[0]
    if row_bins.shape != (depth, n):
        raise ValueError(f"{what}: row_bins must be [{depth}, {n}], got "
                         f"{list(row_bins.shape)}")
    cms_out = torch.empty_like(cms)
    est_rows = torch.empty((depth, n), dtype=torch.float64, device=cms.device)
    fn = entry("hulk_cms_drift_scan")
    with torch.cuda.device(cms.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(freqs.data_ptr(), row_bins.data_ptr(), n, cms.data_ptr(), cms_out.data_ptr(),
                 depth, width, dw, est_rows.data_ptr(), stream)
    _build.check_launch(err, "cms_drift_scan")
    _build.count_launch(launches, "cms_drift_scan")
    return cms_out, est_rows.amin(0)


def drift_select_cuda(aka: torch.Tensor, bins: torch.Tensor, sketch: torch.Tensor,
                      weights: torch.Tensor, dw: float) -> tuple[torch.Tensor, torch.Tensor]:
    """aka [s, n] f64 (each slot's Aka of the n live bins, in bin order),
    bins [n] int64 (their ids), sketch [s] int64, weights [s] f64, on one
    CUDA device -> (sketch, weights) after the n steps."""
    what = "drift_select_cuda"
    _check(what, aka.device, aka=(aka, torch.float64, 2), bins=(bins, torch.int64, 1),
           sketch=(sketch, torch.int64, 1), weights=(weights, torch.float64, 1))
    _check_dw(what, dw)
    s, n = aka.shape
    if bins.shape[0] != n or sketch.shape[0] != s or weights.shape[0] != s:
        raise ValueError(f"{what}: aka [{s}, {n}] needs bins [{n}], sketch and weights [{s}]")
    sketch_out, weights_out = torch.empty_like(sketch), torch.empty_like(weights)
    chunk_min = torch.empty((s, -(-n // SELECT_CHUNK)), dtype=torch.float64, device=aka.device)
    fn = entry("hulk_drift_select")
    with torch.cuda.device(aka.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(aka.data_ptr(), bins.data_ptr(), n, s, dw, sketch.data_ptr(),
                 weights.data_ptr(), sketch_out.data_ptr(), weights_out.data_ptr(),
                 chunk_min.data_ptr(), SELECT_CHUNK, stream)
    _build.check_launch(err, "drift_select")
    _build.count_launch(launches, "drift_select")
    return sketch_out, weights_out
