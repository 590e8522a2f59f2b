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
    heads of one 200 kb record (k=21, w=9; the long-read step).
Kernel times are device times (chip_smoke.device_ms: 50 launches queued
through the C entry behind a sleep, one event pair); each round also checks
that the builds give the same window minima, buckets and histograms. Prints
one line a measurement and, last, one JSON object of them all, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="csrc directory of the other build")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: kernel_retime.py runs on the card only", file=sys.stderr)
        return 2
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
    other_so = os.path.join(_build.build_dir(), "other", "libhulk_kernels.so")
    _build.compile_library(sorted(glob.glob(os.path.join(args.other, "*.cu"))), other_so)
    libs = {"other": ctypes.CDLL(other_so), "this": _build.load()}
    # the u8 entry took no cont argument before the cont form existed
    with open(os.path.join(args.other, "minimizer_window.cu")) as fh:
        takes_cont = {"other": "int cont, void* wmin" in fh.read(), "this": True}

    def bind(lib, name, cont=True):
        if not hasattr(lib, name):
            return None
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        argtypes = {**MIN_ARGS, **JUMP_ARGS}[name]
        fn.argtypes = argtypes if cont else argtypes[:6] + argtypes[7:]
        return fn

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
    print(json.dumps({"card": smi, "shape": f"R={R} L={L} k={k} w={w} n={n} "
                      f"N={skeys.numel()}; two-sort R={R2} L={L2} k={k2} w={w2} "
                      f"N={svals.numel()} live={cnt}; record run heads {rheads.numel()}",
                      "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
