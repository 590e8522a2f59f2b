"""Wrappers of the Hopper minimizer-window kernel (csrc/minimizer_window.cu).

Replaces hulk_tpu/ops/minimizer_pallas.py:minimizer_window_pallas. Three
C entries share the kernel's scan: `minimizer_window_packed_cuda` reads the
v2 transfer layout (the device step's main path); `minimizer_window_cuda`
reads u8 codes [R, L] through hulk_minimizer_window, also in its cont form
(cont=True; counted apart, under "minimizer_window_cont"), which the
Pallas kernel lacks; `minimizer_record_cuda` scans one long record's u8
codes [L] and appends only its run heads to a buffer behind a device count
(the long-read path, ops/longread.py). The plain versions are
minimizer_window_packed_torch, minimizer_window_torch and
record_run_heads_torch (hulk_tpu_torch.ops.minimizer). Each wrapper checks
its inputs, launches on PyTorch's current stream and counts its launches in
`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from hulk_tpu_torch.ops import _build
from hulk_tpu_torch.ops.minimizer import check_kw

SOURCE = "hulk_tpu_torch/csrc/minimizer_window.cu"
# launches of each entry in this process
launches = {"minimizer_window": 0, "minimizer_window_packed": 0, "minimizer_window_cont": 0,
            "minimizer_record": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {
    # codes, lengths, R, L, k, w, cont, wmin, report, stream
    "hulk_minimizer_window": [_P, _P, _LL, _LL, _I, _I, _I, _P, _P, _P],
    # codes2, mask8, lengths, R, L, k, w, wmin, report, stream
    "hulk_minimizer_window_packed": [_P, _P, _P, _LL, _LL, _I, _I, _P, _P, _P],
    # codes, L, k, w, cont, heads, count, stream
    "hulk_minimizer_record": [_P, _LL, _I, _I, _I, _P, _P, _P],
}
# the most positions one hulk_minimizer_record launch scans (csrc kRecordCap)
RECORD_CAP = 1 << 30


def entry(name: str):
    """The bound C entry (for callers that queue launches themselves)."""
    return _build.entry(name, ARGTYPES[name])


def _check(what: str, tensors: dict, lengths: torch.Tensor) -> None:
    dev = lengths.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: all inputs must be on one CUDA device")
    if any(t.dtype != torch.uint8 for t in tensors.values()) or lengths.dtype != torch.int32:
        raise TypeError(f"{what}: {', '.join(tensors)} must be uint8 and lengths int32")
    R = lengths.shape[0] if lengths.dim() == 1 else -1
    if any(t.dim() != 2 or t.shape[0] != R for t in tensors.values()):
        raise ValueError(f"{what}: {', '.join(tensors)} [R, ..] and lengths [R] expected")
    if not all(t.is_contiguous() for t in (*tensors.values(), lengths)):
        raise ValueError(f"{what}: inputs must be contiguous")


def _outputs(R: int, L: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((R, L), dtype=torch.int64, device=dev),
            torch.empty((R, L), dtype=torch.bool, device=dev))


def minimizer_window_cuda(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                          w: int, cont: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [R, L] uint8 and lengths [R] int32, contiguous on one CUDA
    device -> (wmin [R, L] int64 of u64 bits, report [R, L] bool); cont as
    minimizer_window_torch's."""
    check_kw(k, w)
    _check("minimizer_window_cuda", {"codes": codes}, lengths)
    R, L = codes.shape
    wmin, report = _outputs(R, L, codes.device)
    if R == 0 or L == 0:
        return wmin, report
    name = "minimizer_window_cont" if cont else "minimizer_window"
    fn = entry("hulk_minimizer_window")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(codes.data_ptr(), lengths.data_ptr(), R, L, k, w, int(cont),
                 wmin.data_ptr(), report.data_ptr(), stream)
    _build.check_launch(err, name)
    _build.count_launch(launches, name)
    return wmin, report


def minimizer_window_packed_cuda(codes2: torch.Tensor, mask8: torch.Tensor,
                                 lengths: torch.Tensor, k: int,
                                 w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The v2 transfer layout: codes2 [R, L/4] and mask8 [R, L/8] uint8,
    lengths [R] int32, contiguous on one CUDA device -> (wmin [R, L] int64
    of u64 bits, report [R, L] bool), as minimizer_window_cuda of the
    unpacked codes."""
    check_kw(k, w)
    _check("minimizer_window_packed_cuda", {"codes2": codes2, "mask8": mask8}, lengths)
    R, L = codes2.shape[0], 4 * codes2.shape[1]
    if mask8.shape[1] * 8 != L:
        raise ValueError("minimizer_window_packed_cuda: mask8 must be [R, L/8] for "
                         "codes2 [R, L/4] with L % 8 == 0")
    wmin, report = _outputs(R, L, codes2.device)
    if R == 0 or L == 0:
        return wmin, report
    fn = entry("hulk_minimizer_window_packed")
    with torch.cuda.device(codes2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(codes2.data_ptr(), mask8.data_ptr(), lengths.data_ptr(), R, L, k, w,
                 wmin.data_ptr(), report.data_ptr(), stream)
    _build.check_launch(err, "minimizer_window_packed")
    _build.count_launch(launches, "minimizer_window_packed")
    return wmin, report


def minimizer_record_cuda(codes: torch.Tensor, heads: torch.Tensor, count: torch.Tensor,
                          k: int, w: int, cont: bool = False) -> None:
    """One record's u8 codes [L] (0 < L <= RECORD_CAP), contiguous on a CUDA
    device: its run heads (record_run_heads_torch's, in no order) go to
    heads [N] int64 from index count, and count [] int64 grows by their
    number, in place. heads must have room for L more after count; cont as
    minimizer_window_torch's."""
    check_kw(k, w)
    dev = codes.device
    if dev.type != "cuda" or heads.device != dev or count.device != dev:
        raise ValueError("minimizer_record_cuda: all inputs must be on one CUDA device")
    if codes.dtype != torch.uint8 or heads.dtype != torch.int64 or count.dtype != torch.int64:
        raise TypeError("minimizer_record_cuda: codes must be uint8, heads and count int64")
    if codes.dim() != 1 or heads.dim() != 1 or count.dim() != 0 or not (
            codes.is_contiguous() and heads.is_contiguous()):
        raise ValueError("minimizer_record_cuda: codes [L] and heads [N] contiguous, "
                         "count [] expected")
    L = codes.shape[0]
    if L > RECORD_CAP:
        raise ValueError(f"minimizer_record_cuda: {L} positions, at most {RECORD_CAP} a launch")
    if L == 0:
        return
    fn = entry("hulk_minimizer_record")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(codes.data_ptr(), L, k, w, int(cont), heads.data_ptr(), count.data_ptr(),
                 stream)
    _build.check_launch(err, "minimizer_record")
    _build.count_launch(launches, "minimizer_record")
