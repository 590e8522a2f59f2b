"""The devices a process runs on, as a dp and mp "mesh": the per-shard group
step of the data-parallel stream, the CWS tables striped over sketch slots
(uploaded once a process), the sharded histogram step, and the whole flush
as one exact device step over slot stripes, with or without drift
(sharded_flush_step).

Counterpart of hulk_tpu/parallel/mesh.py (make_sketch_mesh,
make_sharded_group_step, sharded_histogram_step, sharded_flush_step,
shard_tables). A mesh here is a list of torch.devices,
which may name one device more than once: that is how the CPU tests and a
machine with one card run the sharded paths. Rows (dp) and slots (mp) go to
the devices in contiguous stripes of ceil(n / D); the stream's shards step
in threads of their own. The kernels run through their wrappers, which
launch on the device of their tensors; every other stage is plain
PyTorch, as hulk_tpu left it to XLA. The shards merge exactly (integer
sums, bottom-s unions, minima and maxima), and each slot's stripe needs
only its own tables, so the output does not depend on the number of
devices.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hulk_tpu_torch import spans

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


def stripes(n: int, d: int) -> list[tuple[int, int]]:
    """[lo, hi) of d contiguous stripes of ceil(n / d) over n items (the
    last ones shorter or empty): hulk_tpu's P("dp") row blocks
    (stream/pipeline.py:536-538)."""
    step = -(-n // d)
    return [(min(i * step, n), min(i * step + step, n)) for i in range(d)]


def sharded_group_step(hists: list, counts: list, states: list, shards: list, *,
                       l: int, k: int, w: int) -> None:
    """The data-parallel group step (make_sharded_group_step). shards[i] is
    shard i's staged (codes, lengths) blocks and its row cap, or None where
    the shard got no rows. Each shard packs its blocks into its own pinned
    v2 buffer, copies it to the device of hists[i] and runs the one-device
    group_scan_body into its own carries hists[i], counts[i], states[i], in
    place. The shards run in threads of their own, which share no state, so
    that one device's host syncs (one a batch in the fused step) do not hold
    up another's launches. No collectives: the shards merge at the end or at an interval
    boundary."""
    from hulk_tpu_torch.ops.device_step import group_scan_body, ship_group, stream_bucket

    def step(i: int) -> None:
        blocks, rmax = shards[i]
        flat, g, r = ship_group(blocks, l, rmax, hists[i].device)
        group_scan_body(hists[i], counts[i], flat, g=g, r=r, l=l, k=k, w=w,
                        bucket=stream_bucket(r, r * l, l=l, k=k, w=w), states=states[i])

    live = [i for i, shard in enumerate(shards) if shard is not None]
    with ThreadPoolExecutor(len(live), thread_name_prefix="hulk-shard") as pool:
        run = spans.carry(step)
        for f in [pool.submit(run, i) for i in live]:
            f.result()


def sharded_histogram_step(devices: list, nbins: int, k: int, w: int):
    """(codes [R, L] uint8, lengths [R] int32) -> (hist [nbins] int32,
    count [] int64) on devices[0]: each device's stripe of rows through
    sketch_accumulate_step (the minimizer kernel and the jump kernel,
    hulk_jump_hash) into its own histogram, then the shards summed
    (hulk_tpu's psum over dp). Like hulk_tpu's, it keeps a value that a
    read reports twice, where the stream step counts it once, so the two
    agree only on batches where no read does. The plain versions run on the
    CPU."""
    from hulk_tpu_torch.ops.device_step import sketch_accumulate_step

    def step(codes, lengths):
        codes, lengths = torch.as_tensor(codes), torch.as_tensor(lengths)
        hist = torch.zeros(nbins, dtype=torch.int32, device=devices[0])
        count = torch.zeros((), dtype=torch.int64, device=devices[0])
        for dev, (lo, hi) in zip(devices, stripes(lengths.shape[0], len(devices))):
            if lo == hi:
                continue
            local, n = sketch_accumulate_step(
                torch.zeros(nbins, dtype=torch.int32, device=dev), codes[lo:hi].to(dev),
                lengths[lo:hi].to(dev), k=k, w=w)
            hist += local.to(devices[0])
            count += n.to(devices[0])
        return hist, count

    return step


def shard_tables(devices: list, tables) -> list[tuple]:
    """The CWS tables c, b and exp_r ([s, nbins] f64) as contiguous slot
    stripes, one (c, b, exp_r) per device, on that device (hulk_tpu's
    P("mp", None) placement)."""
    s = tables.c.shape[0]
    # torch.tensor copies: the tables are read-only memory maps
    return [tuple(torch.tensor(t[lo:hi], device=dev) for t in (tables.c, tables.b, tables.exp_r))
            for dev, (lo, hi) in zip(devices, stripes(s, len(devices)))]


# The flush's tables on the devices, uploaded once a process and then read
# only: the CWS tables' slot stripes keyed by (sketch size, bins, devices),
# the CMS row table by (bins, depth, width, device), as their host caches
# key them (hashes/cws.py, sketch/countmin.py). At k = 31 the CWS tables
# are 931 MB, which a job would otherwise copy at every start.
_on_devices: dict = {}
_on_devices_lock = threading.Lock()


def _once(key: tuple, make):
    """_on_devices[key], made by make() at the first call."""
    with _on_devices_lock:
        if key not in _on_devices:
            _on_devices[key] = make()
        return _on_devices[key]


def cached_table_stripes(devices: list, sketch_size: int, nbins: int) -> list[tuple]:
    """shard_tables(devices, get_cws_tables(sketch_size, nbins)), once a
    process."""
    from hulk_tpu_torch.hashes.cws import get_cws_tables

    return _once(("cws", sketch_size, nbins, tuple(str(d) for d in devices)),
                 lambda: shard_tables(devices, get_cws_tables(sketch_size, nbins)))


def cached_row_bins(device, nbins: int, depth: int, width: int) -> torch.Tensor:
    """cms_row_bins_table(nbins, depth, width) as int64 [depth, nbins] on
    `device`, once a process."""
    from hulk_tpu_torch.sketch.countmin import cms_row_bins_table

    return _once(("cmsrows", nbins, depth, width, str(device)), lambda: torch.from_numpy(
        cms_row_bins_table(nbins, depth, width).astype(np.int64)).to(device))


def _estimates(hist, row_bins, cms):
    """The CMS update and each bin's frequency estimate, exact: in every
    row the estimate of a bin is the counter before the flush plus the
    counts of the bins that share its counter up to and including it
    (ascending bin order, the host scan's), all integer-valued f64 sums
    below 2^53, so any summation order gives the same bits. Returns
    (cms_out, esti, live)."""
    freqs = hist.double()
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
    return torch.stack(rows), torch.stack(estis).amin(0), freqs != 0.0


def sharded_flush_step(devices: list, decay_weight: float, apply_drift: bool, depth: int,
                       width: int):
    """The histosketch flush as one device step over slot stripes
    (hulk_tpu/parallel/mesh.py:196-315): the histogram and the CMS on
    devices[0], the sketch, the weights and the CWS tables striped over
    `devices` by slots. Returns a step

        (hist [nbins] int32, int64 or f64, row_bins [depth, nbins] int64,
         cms [depth, width] f64, sketch [s] int64, weights [s] f64,
         table_stripes: shard_tables(devices, tables))
        -> (cms, sketch, weights) on devices[0].

    Bit for bit the exact host flush (HistoSketch.add_elements) of the
    histogram's live bins (count != 0) in ascending order. The CMS is an
    explicit carry, so interval flushes compose. The estimates: without
    drift the exact grouped prefix sums (_estimates); with drift
    (decay_weight = exp(-decay) in [0, 1)) the CMS scan
    (ops/flush_drift.py: cms_drift_scan), on devices[0]. Each stripe's
    device takes its slots' Aka of the live bins with Go's Exp and Log
    (ops/cws_aka.py: cws_aka) and runs each slot's replace-if-below scan in
    bin order (drift_select): below weight / decay_weight with drift, below
    the weight itself without (decay weight 1, the first index of the
    minimum where it is below the weight). Stripes join in slot order,
    bit-equal for any number of them. run_sketch_pipeline flushes through
    this step on CUDA devices in one process, and with device_flush
    (stream/pipeline.py)."""
    from hulk_tpu_torch.ops.cws_aka import cws_aka
    from hulk_tpu_torch.ops.flush_drift import cms_drift_scan, drift_select

    home = devices[0]
    dw = decay_weight if apply_drift else 1.0

    def step(hist, row_bins, cms, sketch, weights, table_stripes):
        if len(table_stripes) != len(devices):
            raise ValueError(f"{len(table_stripes)} table stripes for {len(devices)} devices")
        hist, row_bins, cms = hist.to(home), row_bins.to(home), cms.to(home)
        freqs = hist.double()
        ids = torch.nonzero(freqs).flatten()
        if apply_drift:
            cms_out, esti = cms_drift_scan(freqs[ids], row_bins[:, ids].contiguous(), cms, dw)
        else:
            cms_out, esti, _ = _estimates(hist, row_bins, cms)
            esti = esti[ids]
        sketches, weights_out, lo = [], [], 0
        for c, b, exp_r in table_stripes:
            hi = lo + c.shape[0]
            dev = c.device
            sk, wt = sketch[lo:hi].to(dev).contiguous(), weights[lo:hi].to(dev).contiguous()
            if hi > lo:
                i = ids.to(dev)
                sk, wt = drift_select(cws_aka(esti.to(dev), i, c, b, exp_r), i, sk, wt, dw)
            sketches.append(sk.to(home))
            weights_out.append(wt.to(home))
            lo = hi
        return cms_out, torch.cat(sketches), torch.cat(weights_out)

    return step
