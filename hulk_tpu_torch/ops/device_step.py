"""The streaming sketch step on the device, in PyTorch.

Counterpart of hulk_tpu/ops/device_step.py:177-550 (the fused single-sort
step, its compact row sort and the grouped transfer layout) with the KMV,
KHF and HMH updates off. Per batch: window minima straight from the packed
transfer layout (the minimizer kernel), an adjacent-run prededup, a per-row
sort that compacts each row's live lanes into compact_width(L, w) slots,
ONE global sort of (read_id << vbits | value) keys whose adjacent dedup
equals per-read distinct, then the binning pass (on the card one launch of
the jump kernel that dedups, hashes and adds into the int32 histogram with
atomics). Everything but the two kernels is plain PyTorch, as the reference
left it to XLA; u64 keys travel as int64 bits (hulk_tpu_torch/_u64.py).

The reference picks two branches on the device with lax.cond, which has no
sync-free PyTorch form: a row that overflows the compact width sends the
batch down the full-width branch, and a batch whose live lanes fit the
static bucket bins only the bucket's prefix of the sorted keys. Here both
predicates are read back in ONE host sync per batch. Both branches are exact,
so the histogram and the count do not depend on which one ran.
"""
from __future__ import annotations

import torch

from hulk_tpu_torch._u64 import I64MAX, SENT, usort
from hulk_tpu_torch.hashes.jumphash import jump_hash_torch
from hulk_tpu_torch.ops.minimizer import minimizer_window_packed


def fused_bits_ok(k: int, r: int) -> bool:
    """Can read ids be packed above the value bits in a 64-bit sort key?"""
    return (2 * k + 8) + max(r - 1, 1).bit_length() <= 64


def compact_width(L: int, w: int) -> int:
    """Row-compaction slot count: live lanes per row after the adjacent-run
    prededup are ~2L/(w+1), kept with 1.5x headroom + 16 and rounded to a
    64-lane granule (64 slots for L=160, w=9). Rows that overflow divert the
    whole batch to the exact full-width branch."""
    est = (3 * L) // (w + 1) + 16
    c = 64
    while c < est:
        c += 64
    return min(c, L)


def stream_bucket(r: int, total: int, *, l: int, k: int, w: int) -> int:
    """Static compaction bucket: the minimizer density mean
    2(l-k+1)/(w+1) per read, times 1.03, plus ceil(64/r) slack for small
    batches, at least 16 per read. Denser batches bin full width."""
    per = max(
        16,
        (2 * max(l - k + 1, 0) * 103) // ((w + 1) * 100) + 1 + (-(-64 // r)),
    )
    return min(per * r, total)


def group_views2(flatbuf: torch.Tensor, g: int, r: int, l: int):
    """Slice the flat v2 buffer into codes2 [g, r, l/4], mask8 [g, r, l/8]
    and int32 lengths [g, r] (little-endian u16 on the wire)."""
    ncodes = g * r * (l // 4)
    nmask = g * r * (l // 8)
    codes2 = flatbuf[:ncodes].view(g, r, l // 4)
    mask8 = flatbuf[ncodes:ncodes + nmask].view(g, r, l // 8)
    lraw = flatbuf[ncodes + nmask:ncodes + nmask + g * r * 2].view(g, r, 2).to(torch.int32)
    lengths = lraw[..., 0] | (lraw[..., 1] << 8)
    return codes2, mask8, lengths


def bin_scatter_keys_torch(hist: torch.Tensor, skeys: torch.Tensor, vbits: int) -> None:
    """Plain version: bin a slice of sorted (read_id << vbits | value) keys,
    dedup adjacent, and scatter-add into the int32 histogram in place."""
    live = skeys != SENT
    neq = torch.ones_like(live)
    neq[1:] = skeys[1:] != skeys[:-1]
    mask = live & neq
    keys = torch.where(mask, skeys & ((1 << vbits) - 1), 0)
    bins = jump_hash_torch(keys, hist.shape[0])
    hist.index_add_(0, bins.to(torch.int64), mask.to(torch.int32))


def bin_scatter_keys(hist: torch.Tensor, skeys: torch.Tensor, vbits: int) -> None:
    """The binning pass: the plain version for CPU tensors, the fused Hopper
    kernel (dedup, jump hash and histogram atomics in one launch) for CUDA
    tensors (it raises rather than fall back)."""
    if skeys.device.type == "cpu":
        bin_scatter_keys_torch(hist, skeys, vbits)
        return
    from hulk_tpu_torch.ops.jump_cuda import bin_scatter_keys_cuda

    bin_scatter_keys_cuda(hist, skeys, vbits)


def sorted_batch_keys(wmin: torch.Tensor, report: torch.Tensor, *, k: int,
                      w: int, bucket: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The keys that one batch bins: from its window minima and report mask
    [R, L], the unsigned-sorted (read_id << (2k+8) | value) keys, cut to the
    bucket's prefix when the live lanes fit it, and the batch's minimizer
    count (a 0-d int64 tensor). Requires fused_bits_ok(k, R)."""
    R, L = wmin.shape
    vbits = 2 * k + 8
    # adjacent-run prededup along positions (an optimisation only: the
    # post-sort dedup is authoritative)
    m = report.clone()
    m[:, 1:] &= ~((wmin[:, 1:] == wmin[:, :-1]) & report[:, :-1])
    rid = torch.arange(R, dtype=torch.int64, device=wmin.device)[:, None] << vbits
    m_live = m.sum()

    C = compact_width(L, w)
    if C < L:
        # per-row sort compaction: reported values are < 2^(2k+8) <= 2^62,
        # positive as int64, so a signed row sort with an int64-max sentinel
        # pushes each row's live lanes to the row's front
        rs = torch.sort(torch.where(m, wmin, I64MAX), dim=1).values
        overflow = (rs[:, C] != I64MAX).any()
        overflow, m_live = torch.stack([overflow.to(torch.int64), m_live]).tolist()
        if overflow:
            flat = torch.where(m, rid | wmin, SENT).reshape(-1)
        else:
            kept = rs[:, :C]
            flat = torch.where(kept != I64MAX, rid | kept, SENT).reshape(-1)
    else:
        m_live = int(m_live)
        flat = torch.where(m, rid | wmin, SENT).reshape(-1)

    # keys with bit 63 set (read ids >= 2^(63-vbits)) sort as unsigned
    skeys = usort(flat)
    live = skeys != SENT
    neq = torch.ones_like(live)
    neq[1:] = skeys[1:] != skeys[:-1]
    cnt = (live & neq).sum()
    if bucket < flat.numel() and m_live <= bucket:
        skeys = skeys[:bucket]
    return skeys, cnt


def group_scan_body(hist: torch.Tensor, count: torch.Tensor,
                    flatbuf: torch.Tensor, *, g: int, r: int, l: int, k: int,
                    w: int, bucket: int) -> None:
    """Run the g batches of one flat v2 transfer buffer through the step,
    accumulating into hist [nbins] int32 and count [] int64 in place."""
    codes2, mask8, lengths = group_views2(flatbuf, g, r, l)
    for i in range(g):
        wmin, report = minimizer_window_packed(codes2[i], mask8[i], lengths[i], k, w)
        skeys, cnt = sorted_batch_keys(wmin, report, k=k, w=w, bucket=bucket)
        bin_scatter_keys(hist, skeys, 2 * k + 8)
        count += cnt

