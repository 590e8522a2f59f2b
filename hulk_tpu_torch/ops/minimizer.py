"""Minimizer window scan — the framework's hottest op — in PyTorch.

Counterpart of hulk_tpu/ops/minimizer.py (`minimizer_window`, :38). The
reference's rolling scan (src/minimizer/minimizer.go:96-204) becomes a
data-parallel computation over a [reads, positions] batch: the rolling k-mer
update is a closed-form windowed OR (Go's update `(x<<2)|c` is an OR, so the
composition distributes) and the monotonic queue a sliding-window minimum.
u64 values travel as int64 bits (hulk_tpu_torch/_u64.py).

Reference quirks reproduced bit-for-bit:
  * ambiguous bases are NOT skipped; c=4 is shifted into both rolling k-mers
    (minimizer.go:115-122,134-137), and the rc k-mer keeps the `>>2` tail of
    base i-k unmasked;
  * symmetric k-mers (fwd==rc) are skipped entirely (145-147);
  * X = hash64(canonical)<<8 | uint64(int32(span)), span = min(i-w+2, k),
    sign-extended when k<w makes the span negative (127-131,156-158).

`minimizer_window` (u8 codes, with a `cont` form for the chunks of long
records) and `minimizer_window_packed` (the v2 transfer layout, the device
step's main path) are the entry points: each takes its plain version for a
CPU tensor and the CUDA kernel (ops/minimizer_cuda.py) for a CUDA tensor.
`per_read_distinct` turns their output into each read's distinct values,
as the two-sort step needs. `record_run_heads_torch` is the plain version
of the long-read record scan (ops/longread.py): one record's run heads.
"""
from __future__ import annotations

import numpy as np
import torch

from hulk_tpu_torch._u64 import SENT, flip, ugt, usort
from hulk_tpu_torch.hashes.hash64 import hash64_torch


def check_kw(k: int, w: int) -> None:
    if not 0 < k < 32:
        raise ValueError(f"k must be 0 < k < 32, got {k}")
    if not 0 < w < 257:
        raise ValueError(f"w must be 0 < w < 257, got {w}")


def minimizer_window_torch(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                           w: int, cont: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch window minima + report mask (the pre-dedup stream).

    codes: [R, L] integer base codes (0-3, 4 = N; anything past a read's
    length is ignored, whatever its value). lengths: [R] read lengths.
    Returns wmin [R, L] int64 (u64 bits): the minimum of the masked entries
    over the trailing w positions; report [R, L] bool: where the reference
    reports the queue front (valid k-mer at i, i >= w-1).

    cont: the rows are chunks after the first of longer reads
    (ops/longread.py) that overlap the chunk before by w+k-1 bases: the
    span is k at every position and reporting starts at local position
    w+k-1, where every entry of the window equals the in-context one (the
    derivation is in hulk_tpu/ops/minimizer.py:minimizer_window's
    docstring)."""
    check_kw(k, w)
    R, L = codes.shape
    dev = codes.device
    c = codes.to(torch.int64)
    mask = (1 << (2 * k)) - 1
    pos = torch.arange(L, device=dev)[None, :]
    in_read = pos < lengths.to(torch.int64)[:, None]

    # forward k-mer: OR_{j<k} c[i-j] << 2j (left pad contributes 0)
    cf = torch.nn.functional.pad(c, (k - 1, 0))
    fwd = torch.zeros_like(c)
    for j in range(k):
        fwd |= cf[:, k - 1 - j : k - 1 - j + L] << (2 * j)
    fwd &= mask
    # reverse complement: OR_{j<k} (3^c[i-j]) << 2(k-1-j), plus the
    # unmasked (3^c[i-k]) >> 2 tail; left pad 3 so that 3^pad == 0
    comp = 3 ^ torch.nn.functional.pad(c, (k, 0), value=3)
    rc = torch.zeros_like(c)
    for j in range(k):
        rc |= comp[:, k - j : k - j + L] << (2 * (k - 1) - 2 * j)
    rc |= comp[:, 0:L] >> 2  # non-negative, so the shift is logical

    valid = (fwd != rc) & (pos >= k - 1) & in_read
    canonical = torch.where(ugt(fwd, rc), rc, fwd)
    # int64: sign-extended as in Go
    span = k if cont else torch.clamp(pos - (w - 2), max=k)
    x = (hash64_torch(canonical, mask) << 8) | span
    xm = torch.where(valid, x, SENT)

    # unsigned sliding minimum over the trailing w positions (pad: U64MAX)
    fx = flip(torch.nn.functional.pad(xm, (w - 1, 0), value=SENT))
    wmin = flip(fx.unfold(1, w, 1).amin(dim=2))
    report = valid & (pos >= (w + k - 1 if cont else w - 1))
    return wmin, report


def minimizer_window(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                     w: int, cont: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Window minima + report mask: the plain version for CPU tensors, the
    Hopper kernel for CUDA tensors (it raises rather than fall back)."""
    if codes.device.type == "cpu":
        return minimizer_window_torch(codes, lengths, k, w, cont)
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_cuda

    return minimizer_window_cuda(codes, lengths, k, w, cont)


def record_run_heads_torch(codes: torch.Tensor, k: int, w: int,
                           cont: bool = False) -> torch.Tensor:
    """Plain version of the record scan (csrc/minimizer_window.cu
    hulk_minimizer_record): one record's u8 codes [L] -> the window minima
    at its run heads, int64 (u64 bits), in position order; cont as
    minimizer_window_torch's. A run head is a reported position whose
    window minimum differs from the position before's, or whose position
    before is not reported: every distinct reported value has one."""
    lengths = torch.tensor([codes.shape[0]], dtype=torch.int32, device=codes.device)
    wmin, report = minimizer_window_torch(codes[None, :], lengths, k, w, cont)
    head = report.clone()
    head[:, 1:] &= ~(report[:, :-1] & (wmin[:, 1:] == wmin[:, :-1]))
    return wmin[head]


def per_read_distinct(wmin: torch.Tensor,
                      report: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's reported values sorted in unsigned order (SENT after them)
    and the mask of the first of each run of equal values: the per-read
    distinct set (hulk_tpu/ops/minimizer.py:minimizer_scan, :168-179).
    Values reach bit 63 from k = 28 on (2k + 8 >= 64), hence the unsigned
    sort."""
    svals = usort(torch.where(report, wmin, SENT), dim=1)
    first = torch.ones_like(report)
    first[:, 1:] = svals[:, 1:] != svals[:, :-1]
    return svals, first & (svals != SENT)


def minimizer_scan(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                   w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-read distinct minimizer values of u8 codes [R, L]: values [R, L]
    sorted ascending (unsigned) in each row and the mask of the distinct
    ones, as hulk_tpu/ops/minimizer.py:minimizer_scan."""
    return per_read_distinct(*minimizer_window(codes, lengths, k, w))


def unpack_codes2(codes2: torch.Tensor, mask8: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Exact padded codes from the v2 transfer layout (native pack_group2):
    2-bit codes [.., L/4] (position p in bits 2*(p%4)), N bitmask [.., L/8]
    (position p in bit 7-(p%8)), lengths [..]. Returns [.., L] uint8: 0..3
    bases, 4 where the mask bit is set, 5 at and past each read's length."""
    dev = codes2.device
    shifts2 = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
    c = ((codes2[..., None] >> shifts2) & 3).reshape(*codes2.shape[:-1], -1)
    shifts1 = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    m = ((mask8[..., None] >> shifts1) & 1).reshape(*mask8.shape[:-1], -1)
    c = torch.where(m != 0, 4, c)
    pos = torch.arange(c.shape[-1], dtype=torch.int32, device=dev)
    return torch.where(pos >= lengths[..., None], 5, c).to(torch.uint8)


def minimizer_window_packed_torch(codes2: torch.Tensor, mask8: torch.Tensor,
                                  lengths: torch.Tensor, k: int,
                                  w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed entry: unpack the v2 transfer layout
    (codes2 [R, L/4], mask8 [R, L/8], lengths [R]), then
    minimizer_window_torch."""
    return minimizer_window_torch(unpack_codes2(codes2, mask8, lengths), lengths, k, w)


def minimizer_window_packed(codes2: torch.Tensor, mask8: torch.Tensor,
                            lengths: torch.Tensor, k: int,
                            w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Window minima + report mask of the v2 transfer layout: the plain
    version for CPU tensors, the Hopper kernel for CUDA tensors (it raises
    rather than fall back)."""
    if codes2.device.type == "cpu":
        return minimizer_window_packed_torch(codes2, mask8, lengths, k, w)
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_packed_cuda

    return minimizer_window_packed_cuda(codes2, mask8, lengths, k, w)


def short_read_mask(lengths: np.ndarray, k: int, w: int) -> np.ndarray:
    """Reads the reference would reject as fatal errors (len < w+k-1 or 0)."""
    return (lengths < (w + k - 1)) | (lengths < 1)
