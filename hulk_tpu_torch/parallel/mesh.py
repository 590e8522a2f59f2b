"""The device stage of the no-drift histosketch flush (--deviceFlush), and
the dp "mesh" of the devices a process ranks on.

Counterpart of hulk_tpu/parallel/mesh.py (FLUSH_MARGIN_REL, FLUSH_TOP_T,
the function that make_device_flush_candidates builds, and
make_sketch_mesh's dp axis): plain PyTorch, no hand-written kernel. A mesh
here is a list of torch.devices, each given a contiguous stripe of rows.
The other multi-device pieces of that module (the dp stream step, the mp
sharding of the CWS tables) are not here yet.
"""
from __future__ import annotations

import torch

# Relative margin of the argmin recheck. The device's f64 exp/log (CUDA's,
# or torch's CPU kernels) are within a few ULP of Go's fdlibm each, so a
# device Aka is within ~1e-15 of the exact value; 1e-12 leaves three orders
# of magnitude of slack. Every element whose device Aka lies within this
# margin of the slot's best is counted; when more than FLUSH_TOP_T are, the
# caller falls back to the exact host flush, so exactness never rests on
# the device's transcendentals.
FLUSH_MARGIN_REL = 1e-12
FLUSH_TOP_T = 8


def make_sketch_mesh(n_dp: int | None = None, devices=None) -> list:
    """The first n_dp of `devices` (default: every CUDA device visible to
    this process) as a list of torch.devices."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_dp is not None:
        if n_dp > len(devices):
            raise ValueError(f"mesh of {n_dp} devices requested, {len(devices)} available")
        devices = devices[:n_dp]
    if not devices:
        raise ValueError("no device for the mesh (no CUDA device is visible)")
    return devices


def device_flush_candidates(hist, row_bins, cms, c, b, exp_r, top_t: int = FLUSH_TOP_T):
    """One no-drift flush of a dense histogram, device stage.

    (hist [nbins] int32, row_bins [depth, nbins] int64, cms [depth, width]
    f64, c/b/exp_r [s, nbins] f64) -> (cms_out [depth, width] f64,
    cand_bins [s, T] int64, cand_esti [s, T] f64, cand_live [s, T] bool,
    margin [s] int32).

    The CMS update and each live bin's frequency estimate are exact: in
    every row the estimate of a bin is the counter before the flush plus the
    counts of the bins that share its counter up to and including it
    (ascending bin order, the host scan's), all integer-valued f64 sums
    below 2^53, so any summation order gives the same bits. Only
    Aka = c / (exp(log(esti) - b) * exp_r) uses the device's exp/log; the
    host stage (HistoSketch.apply_flush_candidates) recomputes the T
    candidates of each slot with the Go ports and keeps the reference's
    selection. That is exact whenever margin <= T: the margin's elements
    are then the T smallest whatever topk's order among ties.
    """
    freqs = hist.double()
    live = freqs != 0.0
    estis, rows = [], []
    for d in range(row_bins.shape[0]):
        keys = row_bins[d]
        order = torch.argsort(keys, stable=True)
        ks, fs = keys[order], freqs[order]
        cs = torch.cumsum(fs, 0)
        start = torch.ones_like(ks, dtype=torch.bool)
        start[1:] = ks[1:] != ks[:-1]
        base = torch.where(start, cs - fs, float("-inf"))
        base = torch.cummax(base, 0).values
        pre = cs - base + cms[d][ks]
        estis.append(torch.empty_like(pre).index_copy_(0, order, pre))
        # f64 atomics add in any order: exact, since every summand and sum
        # is an integer below 2^53
        rows.append(cms[d].index_add(0, keys, freqs))
    esti = torch.stack(estis).amin(0)
    cms_out = torch.stack(rows)

    lf = torch.log(torch.where(live, esti, 1.0))
    aka = c / (torch.exp(lf[None, :] - b) * exp_r)
    aka = torch.where(live[None, :], aka, float("inf"))
    top, idx = torch.topk(aka, top_t, dim=1, largest=False, sorted=True)
    best = top[:, 0]
    # sign-safe: best + |best| * rel, plus a tiny term for best == 0
    thresh = best + best.abs() * FLUSH_MARGIN_REL + 1e-300
    margin = (aka <= thresh[:, None]).sum(1, dtype=torch.int32)
    return cms_out, idx, esti[idx], live[idx], margin
