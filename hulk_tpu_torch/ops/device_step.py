"""The streaming sketch step on the device, in PyTorch.

Counterpart of hulk_tpu/ops/device_step.py: the fused single-sort step
(:177-379, with its compact row sort) and the two-sort step (:88-162) over
the grouped v2 transfer layout, with the KMV, KHF and HMH updates
(ops/device_sketches.py). Everything but the two kernels is plain PyTorch,
as the reference left it to XLA; u64 keys travel as int64 bits
(hulk_tpu_torch/_u64.py).

Fused step (read ids pack above the 2k+8 value bits): window minima straight
from the packed transfer layout (the minimizer kernel), an adjacent-run
prededup, a per-row sort that compacts each row's live lanes into
compact_width(L, w) slots, ONE global sort of (read_id << vbits | value)
keys whose adjacent dedup equals per-read distinct, then the binning pass
(on the card one launch of the jump kernel that dedups, hashes and adds into
the int32 histogram with atomics).

Two-sort step (k >= 23 at R = 2048, and every R from k = 28): the same
window minima, a per-read sort in unsigned order with its distinct values,
one flat unsigned sort, then the binning pass over the whole sorted buffer,
SENT tail included (on the card one launch of the jump kernel's values
entry, which counts equal neighbours, since they come from different reads,
stops at the first SENT and adds the number it binned to the device count,
as hulk_tpu adds its count on the device). Without secondary sketches it
makes no host sync; with them it reads the live count once a batch, to
feed them the live prefix. The long-read step (ops/longread.py) bins with
the same entry in its dedup form.

The reference picks the fused step's branches on the device with lax.cond,
which has no sync-free PyTorch form: a row that overflows the compact width
sends the batch down the full-width branch, and a batch whose live lanes
fit the static bucket bins only the bucket's prefix of the sorted keys.
Here the predicates are read back in ONE host sync per batch. Every branch
is exact, so the histogram, the count and the sketches do not depend on
which one ran.
"""
from __future__ import annotations

import torch

from hulk_tpu_torch import spans
from hulk_tpu_torch._u64 import I64MAX, SENT, flip, usort
from hulk_tpu_torch.hashes.jumphash import jump_hash, jump_hash_torch
from hulk_tpu_torch.ops.device_sketches import (
    SketchStates,
    hmh_update,
    khf_update,
    kmv_update,
)
from hulk_tpu_torch.ops.minimizer import (
    minimizer_scan,
    minimizer_window_packed,
    per_read_distinct,
)


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


def ship_group(staged: list, l: int, rmax: int, device: torch.device):
    """Pack staged (codes, lengths) batches into one pinned v2 buffer and
    start its copy to the device. The group's row count r is its largest
    batch's, rounded up to 64, at most rmax. Returns (flat, g, r)."""
    from hulk_tpu_torch import native

    g = len(staged)
    r = min(rmax, -(-max(c.shape[0] for c, _ in staged) // 64) * 64)
    with spans.span("stream.pack"):
        host = torch.empty(native.group2_nbytes(g, r, l), dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        native.pack_group2(staged, g, r, l, out=host.numpy())
    with spans.span("stream.h2d"):
        return host.to(device, non_blocking=True), g, r


def sketch_accumulate_step(hist: torch.Tensor, codes: torch.Tensor, lengths: torch.Tensor, *,
                           k: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the driver entry point (hulk_tpu/ops/device_step.py:
    sketch_accumulate_step, :41-56): hist [nbins] int32 += the binned
    per-read distinct minimizers of u8 codes [R, L]. The u8 minimizer
    (hulk_minimizer_window) and per-read distinct values, the jump hash of
    every lane (hulk_jump_hash), then a scatter-add of the mask, which
    hulk_tpu leaves to XLA. hist is updated in place (hulk_tpu donates it)
    and returned with the minimizer count, an int64 []."""
    vals, mask = minimizer_scan(codes, lengths, k, w)
    bins = jump_hash(vals.reshape(-1), hist.shape[0])
    hist.index_add_(0, bins.to(torch.int64), mask.reshape(-1).to(torch.int32))
    return hist, mask.sum()


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


def bin_scatter_values_torch(hist: torch.Tensor, svals: torch.Tensor, *, dedup: bool = False,
                             count: torch.Tensor | None = None) -> None:
    """Plain version: bin the live values of sorted values and scatter-add
    into the int32 histogram in place: every one (the two-sort step's
    slice, where equal neighbours come from different reads;
    hulk_tpu/ops/device_step.py:bin_scatter_slice), or with dedup each
    distinct one once (a long record's run heads). count (int64 [], or
    None) grows by the number of values binned."""
    live = svals != SENT
    if dedup:
        live[1:] &= svals[1:] != svals[:-1]
    bins = jump_hash_torch(torch.where(live, svals, 0), hist.shape[0])
    hist.index_add_(0, bins.to(torch.int64), live.to(torch.int32))
    if count is not None:
        count += live.sum()


def bin_scatter_values(hist: torch.Tensor, svals: torch.Tensor, *, dedup: bool = False,
                       count: torch.Tensor | None = None) -> None:
    """The values binning pass (the two-sort step's; with dedup the
    long-read step's): the plain version for CPU tensors, the jump kernel's
    values entry for CUDA tensors (it raises rather than fall back)."""
    if svals.device.type == "cpu":
        bin_scatter_values_torch(hist, svals, dedup=dedup, count=count)
        return
    from hulk_tpu_torch.ops.jump_cuda import bin_scatter_values_cuda

    bin_scatter_values_cuda(hist, svals, dedup=dedup, count=count)


def sorted_batch_keys(wmin: torch.Tensor, report: torch.Tensor, *, k: int,
                      w: int, bucket: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The keys that one batch bins: from its window minima and report mask
    [R, L], the unsigned-sorted (read_id << (2k+8) | value) keys, cut to the
    bucket's prefix when the live lanes fit it; the batch's minimizer count
    (a 0-d int64 tensor); and the live lanes n_live (a host int: every live
    key lies in the first n_live). Requires fused_bits_ok(k, R)."""
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
        with spans.span("stream.sync"):
            overflow, m_live = torch.stack([overflow.to(torch.int64), m_live]).tolist()
        if overflow:
            flat = torch.where(m, rid | wmin, SENT).reshape(-1)
        else:
            kept = rs[:, :C]
            flat = torch.where(kept != I64MAX, rid | kept, SENT).reshape(-1)
    else:
        with spans.span("stream.sync"):
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
    return skeys, cnt, m_live


def distinct_values(skeys: torch.Tensor, vbits: int) -> torch.Tensor:
    """The fused step's per-read distinct values, read-grouped: the value
    bits of each live key that differs from the one before it, SENT
    elsewhere (the feed of the secondary sketches; hulk_tpu's `finish`,
    device_step.py:291-296)."""
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    return torch.where(first & (skeys != SENT), skeys & ((1 << vbits) - 1), SENT)


def bottom_k_values(vals: torch.Tensor, s: int) -> torch.Tensor:
    """The s smallest values of a SENT-padded stream of distinct values in
    unsigned order, ascending, SENT padded: the value-sorted prefix KMV
    needs, without sorting the whole stream
    (hulk_tpu/ops/device_step.py:369-379, which holds below 2^63; here the
    values flip into signed order, where SENT becomes the largest)."""
    vi = flip(vals)
    if vi.numel() < s:
        vi = torch.cat([vi, vi.new_full((s - vi.numel(),), I64MAX)])
    return flip(torch.topk(vi, s, largest=False, sorted=True).values)


def sorted_batch_values(wmin: torch.Tensor,
                        report: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-sort step (hulk_tpu/ops/device_step.py:stream_step_body): from
    a batch's window minima and report mask [R, L], each read's distinct
    values, then ONE flat sort in unsigned order (SENT last). Returns the
    sorted values and the live count, an int64 [] on their device (no host
    sync): the live values are exactly the first `count`."""
    vals, mask = per_read_distinct(wmin, report)
    svals = usort(torch.where(mask, vals, SENT).reshape(-1))
    return svals, mask.sum()


def update_sketches(states: SketchStates, vals: torch.Tensor, *, ascending: bool) -> None:
    """Feed a batch's distinct values (SENT for dead lanes) to the sketches
    that are on. ascending: vals is sorted in unsigned order (the two-sort
    step), else KMV takes its bottom s first (the fused step)."""
    if states.kmv is not None:
        s = states.kmv.shape[0]
        states.kmv = kmv_update(states.kmv, vals if ascending else bottom_k_values(vals, s))
    if states.khf is not None:
        states.khf = khf_update(states.khf, vals)
    if states.hmh is not None:
        states.hmh = hmh_update(states.hmh, vals)


def group_scan_body(hist: torch.Tensor, count: torch.Tensor,
                    flatbuf: torch.Tensor, *, g: int, r: int, l: int, k: int,
                    w: int, bucket: int, states: SketchStates | None = None) -> None:
    """Run the g batches of one flat v2 transfer buffer through the step,
    accumulating into hist [nbins] int32, count [] int64 and the sketch
    states (None when no secondary sketch is on) in place. The fused step
    when read ids < r pack above the value bits (fused_bits_ok(k, r)), else
    the two-sort step, as hulk_tpu's _DeviceStream._dispatch_group picks
    (stream/pipeline.py:239-249); both are exact. The fused step syncs the
    host once a batch; the two-sort step only when sketches are on."""
    codes2, mask8, lengths = group_views2(flatbuf, g, r, l)
    fused = fused_bits_ok(k, r)
    vbits = 2 * k + 8
    with spans.span("stream.step"):
        for i in range(g):
            spans.count("stream.batches")
            wmin, report = minimizer_window_packed(codes2[i], mask8[i], lengths[i], k, w)
            if fused:
                skeys, cnt, n_live = sorted_batch_keys(wmin, report, k=k, w=w, bucket=bucket)
                bin_scatter_keys(hist, skeys, vbits)
                if states is not None:
                    update_sketches(states, distinct_values(skeys[:n_live], vbits),
                                    ascending=False)
                count += cnt
            else:
                spans.count("stream.two_sort_batches")
                svals, cnt = sorted_batch_values(wmin, report)
                # the binning adds the live count to count on the device
                bin_scatter_values(hist, svals, count=count)
                if states is not None:  # the live prefix: one sync a batch
                    with spans.span("stream.sync"):
                        n_live = int(cnt)
                    update_sketches(states, svals[:n_live], ascending=True)
