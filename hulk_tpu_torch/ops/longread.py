"""Minimizers of reads of any length, one record at a time.

Counterpart of hulk_tpu/ops/longread.py. A record past the batched path's
length cap (a FASTA contig, a long FASTQ read) is scanned on its own, on
the stream's device, into the same histogram, count and sketch states as
the short reads (`long_read_step`):

  1. the record's u8 codes go to the device in one copy (pinned, on the
     card);
  2. the record scan (on the card one launch of csrc/minimizer_window.cu
     hulk_minimizer_record; plain version ops/minimizer.py:
     record_run_heads_torch) writes only the record's run heads, compacted
     behind a device count;
  3. the count is read back (the record's one host sync), and only that
     prefix of the heads is sorted in unsigned order;
  4. the values entry of the jump kernel, in its dedup form, bins each
     distinct value once into the histogram and adds their number to the
     stream's minimizer count on the device;
  5. the distinct values (repeats masked to SENT) feed the KMV, KHF and HMH
     states.

A record longer than the cap of one scan is cut into chunks that overlap by
the halo H = w + k - 1:

  * chunk 0 is a normal scan (the span and report ramps at the read start
    are genuine);
  * chunks j >= 1 start at j*(cap-H) and take the `cont` form (span k
    everywhere, reporting from local position H), so every reported window
    equals the in-context one and the chunks' reported windows tile the
    record's exactly (derivation in hulk_tpu/ops/minimizer.py:
    minimizer_window's docstring).

The card's cap is RECORD_CAP (2^30 positions a launch, where the kernel's
position arithmetic stays in 32 bits), so a contig or a chromosome goes in
one launch. On the CPU the cap is DEFAULT_BLOCK, so the plain version's
[1, chunk] intermediates stay small whatever the record's length.
"""
from __future__ import annotations

import numpy as np
import torch

from hulk_tpu_torch._u64 import SENT, usort
from hulk_tpu_torch.spans import span
from hulk_tpu_torch.ops.device_sketches import SketchStates
from hulk_tpu_torch.ops.device_step import bin_scatter_values, update_sketches
from hulk_tpu_torch.ops.minimizer import check_kw, record_run_heads_torch
from hulk_tpu_torch.ops.minimizer_cuda import RECORD_CAP, minimizer_record_cuda

DEFAULT_BLOCK = 1 << 16  # the chunk of the plain version on the CPU
# the most values fed to the sketch updates at once: KHF's [s, N] product
# stays within s x 8 MB whatever the record's length
SKETCH_SLICE = 1 << 20


def chunks(L: int, cap: int, k: int, w: int) -> list[tuple[int, int]]:
    """The [start, stop) chunks of a record of L positions: the first from
    0, then one every cap - H positions (H = w + k - 1) while a chunk is
    longer than H (only those report), each at most cap long. The cont form
    holds only where the span has reached k at every entry of a reported
    window, from global position H - 1 on: the second chunk's first entry
    of one, cap - H + k, must be there, so cap >= H + max(1, w - 2)."""
    halo = w + k - 1
    if cap < halo + max(1, w - 2):
        raise ValueError(f"the cap must be at least w+k-1 + max(1, w-2) "
                         f"({halo + max(1, w - 2)})")
    return [(0, min(L, cap))] + [(s, min(L, s + cap)) for s in range(cap - halo, L - halo,
                                                                      cap - halo)]


def record_heads_torch(codes: torch.Tensor, *, k: int, w: int,
                       cap: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Plain version of the record scan over one record's u8 codes [L] of
    any length, on any device: each chunk's run heads
    (ops/minimizer.py:record_run_heads_torch), concatenated (int64)."""
    spans = chunks(int(codes.shape[0]), cap, k, w)
    return torch.cat([record_run_heads_torch(codes[a:b], k, w, cont=j > 0)
                      for j, (a, b) in enumerate(spans)])


def record_heads(codes: torch.Tensor, *, k: int, w: int,
                 cap: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One record's u8 codes [L] (L >= w + k - 1) -> (heads [N] int64, count
    [] int64): its run heads, chunk by chunk, in the first `count` entries
    of heads, in no order. The plain version for a CPU tensor (cap
    DEFAULT_BLOCK), the record-scan kernel for a CUDA tensor (cap
    RECORD_CAP; it raises rather than fall back)."""
    check_kw(k, w)
    L = int(codes.shape[0])
    if L < w + k - 1:
        raise ValueError("sequence length must be >= w + k - 1")
    if codes.device.type == "cpu":
        heads = record_heads_torch(codes, k=k, w=w, cap=cap or DEFAULT_BLOCK)
        return heads, torch.tensor(heads.shape[0], dtype=torch.int64)
    spans = chunks(L, cap or RECORD_CAP, k, w)
    heads = torch.empty(sum(b - a for a, b in spans), dtype=torch.int64, device=codes.device)
    count = torch.zeros((), dtype=torch.int64, device=codes.device)
    for j, (a, b) in enumerate(spans):
        minimizer_record_cuda(codes[a:b], heads, count, k, w, cont=j > 0)
    return heads, count


def to_device(codes: np.ndarray, device) -> torch.Tensor:
    """A record's codes on the device: one pinned copy to a card."""
    host = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8))
    device = torch.device(device)
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def sorted_record_values(codes: torch.Tensor, *, k: int, w: int,
                         cap: int | None = None) -> torch.Tensor:
    """The record's run heads sorted in unsigned order: its distinct values,
    each one or more times. Reads the heads' count back, the one host sync
    a record, so that only the live prefix is sorted."""
    heads, count = record_heads(codes, k=k, w=w, cap=cap)
    with span("stream.sync"):
        n = int(count)
    return usort(heads[:n])


def long_read_step(hist: torch.Tensor, count: torch.Tensor, states: SketchStates | None,
                   codes: torch.Tensor, *, k: int, w: int, cap: int | None = None) -> None:
    """One record's u8 codes [L] on the stream's device into hist [nbins]
    int32, count [] int64 and the sketch states (None when no secondary
    sketch is on), in place: each distinct minimizer value of the record
    binned once, counted once and fed to the sketches (in slices of
    SKETCH_SLICE values: each sketch's merge is exact, so slices give the
    same state as one feed)."""
    svals = sorted_record_values(codes, k=k, w=w, cap=cap)
    bin_scatter_values(hist, svals, dedup=True, count=count)
    if states is not None:
        first = torch.ones_like(svals, dtype=torch.bool)
        first[1:] = svals[1:] != svals[:-1]
        fed = torch.where(first, svals, SENT)
        for a in range(0, fed.shape[0], SKETCH_SLICE):
            update_sketches(states, fed[a:a + SKETCH_SLICE], ascending=False)


def long_read_minimizers(codes: np.ndarray, *, k: int, w: int, cap: int | None = None,
                         device="cuda") -> np.ndarray:
    """Distinct minimizer values (sorted uint64) of ONE read of any length.

    codes: [L] uint8 base codes (0-4). Works for any L >= w + k - 1 and is
    bit-identical to scanning the read in one piece."""
    svals = sorted_record_values(to_device(codes, device), k=k, w=w, cap=cap)
    return np.unique(svals.cpu().numpy().view(np.uint64))
