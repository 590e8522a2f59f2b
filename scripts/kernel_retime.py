#!/usr/bin/env python3
"""Time two builds of the port's CUDA kernels in turns on one card.

    mkdir -p build/other && git archive <commit> hulk_tpu_torch/csrc | tar -x -C build/other
    python3 scripts/kernel_retime.py --other build/other/hulk_tpu_torch/csrc

Builds this tree's kernels and the other tree's (nvcc, as ops/_build.py
does) and times every C entry each library has, in the order other, this,
this, other, at the shapes the paths launch them (seed 0):
  * on the main path's production batch (16,384 reads of up to 160 bases,
    k=21, w=9, 194,481 bins): hulk_minimizer_window (u8 codes, after the
    plain unpack_codes2 pass; its cont argument, 0 here, is passed where the
    other source declares it), hulk_minimizer_window_packed (the v2 transfer
    layout), hulk_jump_hash on the batch's masked values (491,520 keys) and
    on every lane of the u8 minimizer's per-read values (2,621,440 keys,
    entry()'s step), hulk_bin_scatter_keys (its sorted keys), and the
    PyTorch calls the other path needs around them (unpack_codes2, the
    binning masks and index_add_);
  * hulk_bin_scatter_values on a k=31 two-sort batch (2,048 reads, 923,521
    bins): the whole SENT-tailed buffer with the device count (the step's
    call) and the live prefix without it;
  * hulk_bin_scatter_values with dedup and the count on the sorted run
    heads of one 200 kb record (k=21, w=9; the long-read step);
  * the drift flush's two entries at chip_smoke.py phase 12b's shape (42
    slots, CMS 7 x 2,000, dw = Go's exp(-0.9)) on a histogram with all
    194,481 bins live (counts 1-299, seed 0) and on its first 4,096 live
    bins (chip_smoke.drift_entry_ms): hulk_cms_drift_scan from an empty
    CMS; hulk_drift_select from an empty sketch on the scan's Aka and on
    Aka strictly decreasing (its worst case: every bin taken); beside them
    the multiply chain and the mul+add chain of the scan's shape
    (chip_smoke.chain_times) and one drift flush (sharded_flush_step over
    two stripes on the card, this tree's Python with each build's two
    entries bound in by _build.bound: wall ms, median of 5).
Kernel times are device times (chip_smoke.device_ms: 50 launches queued
through the C entry behind a sleep, one event pair; 10 for the drift
entries); each round also checks that the builds give the same window
minima, buckets, histograms, CMS, estimates, bins and weights. Prints one
line a measurement and, last, one JSON object of them all, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="csrc directory of the other build")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: kernel_retime.py runs on the card only", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="hulk_kernel_retime_")
    os.environ.setdefault("HULK_TPU_TORCH_CACHE", os.path.join(tmp, "cache"))
    try:
        return retime(args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def retime(args, tmp: str) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hulk_tpu_torch._u64 import usort
    from hulk_tpu_torch.ops import _build
    from hulk_tpu_torch.ops.device_step import sorted_batch_keys, sorted_batch_values, \
        stream_bucket
    from hulk_tpu_torch.ops.longread import record_heads
    from hulk_tpu_torch.ops.minimizer import per_read_distinct, unpack_codes2
    from hulk_tpu_torch.ops.minimizer_cuda import ARGTYPES as MIN_ARGS
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_packed_cuda
    from hulk_tpu_torch.ops.jump_cuda import ARGTYPES as JUMP_ARGS
    from hulk_tpu_torch.synth import kernel_batch

    smi = cs.nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    chain_build = cs.start_chain_build(tmp)
    other_so = os.path.join(_build.build_dir(), "other", "libhulk_kernels.so")
    _build.compile_library(sorted(glob.glob(os.path.join(args.other, "*.cu"))), other_so)
    libs = {"other": ctypes.CDLL(other_so), "this": _build.load()}
    # the u8 entry took no cont argument before the cont form existed
    with open(os.path.join(args.other, "minimizer_window.cu")) as fh:
        takes_cont = {"other": "int cont, void* wmin" in fh.read(), "this": True}
    # the drift selection took no chunk scratch before the chunk skip existed
    with open(os.path.join(args.other, "flush_drift.cu")) as fh:
        chunked = {"other": "void* chunk_min" in fh.read(), "this": True}

    def bind(lib, name, cont=True):
        if not hasattr(lib, name):
            return None
        argtypes = {**MIN_ARGS, **JUMP_ARGS}[name]
        return _build.bind(lib, name, argtypes if cont else argtypes[:6] + argtypes[7:])

    dev = torch.device("cuda", 0)
    R, L, k, w = cs.PRODUCTION
    n, vbits = cs.NBINS, 2 * k + 8
    rng = np.random.default_rng(cs.SEED)
    _, lengths, codes2, mask8 = kernel_batch(rng, R, L, 120, 160)
    c2, m8, ln = (torch.from_numpy(a).to(dev) for a in (codes2, mask8, lengths))
    codes = unpack_codes2(c2, m8, ln)
    # the two-sort batch at k = 31 and one long record's sorted run heads
    R2, L2, k2, w2 = cs.TWO_SORT
    _, l2, c22, m82 = kernel_batch(rng, R2, L2, 120, L2)
    svals, cnt = sorted_batch_values(*minimizer_window_packed_cuda(
        *(torch.from_numpy(a).to(dev) for a in (c22, m82, l2)), k2, w2))
    cnt = int(cnt)
    rec = torch.from_numpy(np.where(rng.random(200_000) < 0.01, 4,
                                    rng.integers(0, 4, size=200_000)).astype(np.uint8)).to(dev)
    heads, hcount = record_heads(rec, k=k, w=w)
    rheads = usort(heads[:int(hcount)])
    stream = torch.cuda.current_stream().cuda_stream
    wm = torch.empty((R, L), dtype=torch.int64, device=dev)
    rep = torch.empty((R, L), dtype=torch.bool, device=dev)
    ref: dict[str, torch.Tensor] = {}
    results: dict[str, list[float]] = {}

    def record(key: str, ms: float) -> None:
        results.setdefault(key, []).append(ms)
        print(f"{key}: {ms:.4f} ms", flush=True)

    def same(name: str, what: str, got: torch.Tensor) -> None:
        torch.cuda.synchronize()
        if what not in ref:
            ref[what] = got.clone()
        elif not torch.equal(got, ref[what]):
            raise SystemExit(f"FAIL {name}: {what} differs between the builds")

    def jump_round(name: str, lib) -> None:
        """The jump entries of one build at their paths' shapes."""
        f_jump = bind(lib, "hulk_jump_hash")
        f_bin = bind(lib, "hulk_bin_scatter_keys")
        f_val = bind(lib, "hulk_bin_scatter_values")
        for tag, keys in (("fused batch values", values), ("entry() batch", ekeys)):
            out = torch.empty(keys.shape, dtype=torch.int32, device=dev)
            a = (keys.data_ptr(), keys.numel(), n, out.data_ptr(), stream)
            record(f"{name} hulk_jump_hash ({tag}, {keys.numel()} keys)",
                   cs.device_ms(lambda: f_jump(*a)))
            same(name, f"buckets of the {tag}", out)
        hist = torch.zeros(n, dtype=torch.int32, device=dev)
        a = (skeys.data_ptr(), skeys.numel(), vbits, hist.data_ptr(), n, stream)
        if f_bin(*a) != 0:
            raise SystemExit(f"FAIL {name}: hulk_bin_scatter_keys refused")
        same(name, "fused histogram", hist)
        record(f"{name} hulk_bin_scatter_keys", cs.device_ms(lambda: f_bin(*a)))
        if f_val is None:
            return
        n31 = cs.NBINS_K31
        for tag, vals, dedup, nb, counted in (
                ("two-sort whole buffer, count", svals, 0, n31, True),
                ("two-sort live prefix", svals[:cnt], 0, n31, False),
                ("dedup, a record's run heads, count", rheads, 1, n, True)):
            h = torch.zeros(nb, dtype=torch.int32, device=dev)
            c = torch.zeros((), dtype=torch.int64, device=dev)
            a = (vals.data_ptr(), vals.numel(), h.data_ptr(), nb, dedup,
                 c.data_ptr() if counted else None, stream)
            if f_val(*a) != 0:
                raise SystemExit(f"FAIL {name}: hulk_bin_scatter_values refused")
            same(name, f"values histogram, {tag}", h)
            if counted:
                same(name, f"values count, {tag}", c)
            record(f"{name} hulk_bin_scatter_values ({tag}, N={vals.numel()})",
                   cs.device_ms(lambda: f_val(*a)))

    drift_round, dw = drift_setup(dev, record, same)
    skeys = values = ekeys = None
    for name in ("other", "this", "this", "other"):
        lib = libs[name]
        cont = takes_cont[name]
        f_u8 = bind(lib, "hulk_minimizer_window", cont)
        f_pk = bind(lib, "hulk_minimizer_window_packed")
        record(f"{name} unpack_codes2 (plain, device)",
               cs.device_ms(lambda: unpack_codes2(c2, m8, ln)))
        a_u8 = (codes.data_ptr(), ln.data_ptr(), R, L, k, w, *([0] if cont else []),
                wm.data_ptr(), rep.data_ptr(), stream)
        record(f"{name} hulk_minimizer_window (u8)", cs.device_ms(lambda: f_u8(*a_u8)))
        same(name, "u8 window minima", wm)
        if ekeys is None:
            ekeys = per_read_distinct(wm, rep)[0].reshape(-1).contiguous()
        if f_pk is not None:
            a_pk = (c2.data_ptr(), m8.data_ptr(), ln.data_ptr(), R, L, k, w, wm.data_ptr(),
                    rep.data_ptr(), stream)
            record(f"{name} hulk_minimizer_window_packed", cs.device_ms(lambda: f_pk(*a_pk)))
            same(name, "packed window minima", wm)
        if skeys is None:
            bucket = stream_bucket(R, R * L, l=L, k=k, w=w)
            skeys, _, _ = sorted_batch_keys(wm, rep, k=k, w=w, bucket=bucket)
            live = skeys != -1
            live[1:] &= skeys[1:] != skeys[:-1]
            values = torch.where(live, skeys & ((1 << vbits) - 1), 0)

        # the binning pass as the other path runs it: masks, jump, index_add_
        def masks():
            m = skeys != -1
            neq = torch.ones_like(m)
            neq[1:] = skeys[1:] != skeys[:-1]
            m = m & neq
            return torch.where(m, skeys & ((1 << vbits) - 1), 0), m

        record(f"{name} binning masks (plain, device)", cs.device_ms(masks))
        vals, mask = masks()
        bins = torch.empty(vals.shape, dtype=torch.int32, device=dev)
        f_jump = bind(lib, "hulk_jump_hash")
        if f_jump(vals.data_ptr(), vals.numel(), n, bins.data_ptr(), stream) != 0:
            raise SystemExit(f"FAIL {name}: hulk_jump_hash refused")
        hist = torch.zeros(n, dtype=torch.int32, device=dev)
        bins64, ones = bins.long(), mask.int()
        record(f"{name} index_add_", cs.device_ms(lambda: hist.index_add_(0, bins64, ones)))
        jump_round(name, lib)
        drift_round(name, lib, chunked[name])
    for key, ms in cs.chain_times(chain_build, cs.NBINS, 7 * 2000, dw).items():
        record(f"{key} chain (14,000 threads of {cs.NBINS} steps)", ms)
    print(json.dumps({"card": smi, "shape": f"R={R} L={L} k={k} w={w} n={n} "
                      f"N={skeys.numel()}; two-sort R={R2} L={L2} k={k2} w={w2} "
                      f"N={svals.numel()} live={cnt}; record run heads {rheads.numel()}; "
                      f"drift n={cs.NBINS} live bins (prefix {cs.DRIFT_PREFIX}), s=42, "
                      f"CMS 7 x 2000", "ms": results}), flush=True)
    return 0


def drift_setup(dev, record, same):
    """The drift inputs at phase 12b's shape; returns drift_round(name, lib,
    chunked), which times one build's two drift entries (chip_smoke's
    drift_entry_ms) and one drift flush with them, and dw."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from hulk_tpu_torch.hashes.cws import build_cws_tables
    from hulk_tpu_torch.hashes.fdlibm import go_exp
    from hulk_tpu_torch.ops import _build
    from hulk_tpu_torch.ops import flush_drift_cuda as fdc
    from hulk_tpu_torch.parallel import mesh
    from hulk_tpu_torch.sketch.countmin import cms_row_bins_table, cms_shape

    dw = float(go_exp(-cs.DRIFT))
    n, s = cs.NBINS, 42
    depth, width = cms_shape()
    rng = np.random.default_rng(cs.SEED)
    hist = torch.from_numpy(rng.integers(1, 300, n).astype(np.int32)).to(dev)
    tables = build_cws_tables(s, n)
    rb = torch.from_numpy(cms_row_bins_table(n, depth, width).astype(np.int64)).to(dev)
    stripes = mesh.shard_tables([dev, dev], tables)
    step = mesh.sharded_flush_step([dev, dev], dw, True, depth, width)
    empty = (torch.zeros(depth, width, dtype=torch.float64, device=dev),
             torch.zeros(s, dtype=torch.int64, device=dev),
             torch.full((s,), np.finfo(np.float64).max, dtype=torch.float64, device=dev))

    def drift_round(name: str, lib, chunked: bool) -> None:
        scan = _build.bind(lib, "hulk_cms_drift_scan", fdc.ARGTYPES["hulk_cms_drift_scan"])
        args = fdc.ARGTYPES["hulk_drift_select"]
        if chunked:
            select = _build.bind(lib, "hulk_drift_select", args)
        else:  # no chunk scratch before the chunk skip: the call less those two
            unchunked = _build.bind(lib, "hulk_drift_select", args[:9] + args[11:])

            def select(*a):
                return unchunked(*a[:9], a[11])
        with _build.bound({"hulk_cms_drift_scan": scan, "hulk_drift_select": select}):
            for prefix in (None, cs.DRIFT_PREFIX):
                got = cs.drift_entry_ms(dev, hist, tables, rb, dw, prefix, worst=True)
                m = got["out"]["estimates"].shape[1]
                for what, t in got["out"].items():
                    same(name, f"drift {what}, {m} bins", t.view(torch.int64))
                record(f"{name} hulk_cms_drift_scan ({m} live bins)", got["cms_drift_scan"])
                record(f"{name} hulk_drift_select (the flush's Aka, {m} live bins)",
                       got["drift_select"])
                record(f"{name} hulk_drift_select (decreasing Aka, {m} live bins)",
                       got["drift_select decreasing"])
            state = step(hist, rb, *empty, stripes)
            same(name, "drift flush CMS", state[0].view(torch.int64))
            same(name, "drift flush bins", state[1])
            walls = cs.wall_ms(lambda: step(hist, rb, *empty, stripes))
            record(f"{name} drift flush, wall (median of 5)", walls[2])

    return drift_round, dw


if __name__ == "__main__":
    sys.exit(main())
