#!/usr/bin/env python3
"""Time two builds of the port's CUDA kernels in turns on one card.

    mkdir -p build/other && git archive <commit> hulk_tpu_torch/csrc | tar -x -C build/other
    python3 scripts/kernel_retime.py --other build/other/hulk_tpu_torch/csrc

Builds this tree's kernels and the other tree's (nvcc, as ops/_build.py
does) and times, on the main path's production batch (16,384 reads of up to
160 bases, seed 0, k=21, w=9, 194,481 bins), every C entry each library has,
in the order other, this, this, other:
  hulk_minimizer_window (u8 codes, after the plain unpack_codes2 pass; its
  cont argument, 0 here, is passed where the other source declares it),
  hulk_minimizer_window_packed (the v2 transfer layout), hulk_jump_hash (the
  batch's masked values) and hulk_bin_scatter_keys (its sorted keys), and
  the PyTorch calls the other path needs around them (unpack_codes2, the
  binning masks and index_add_).
Kernel times are device times (chip_smoke.device_ms: 50 launches queued
through the C entry behind a sleep, one event pair); each round also checks
that both builds give the same window minima and histogram. Prints one line
a measurement and, last, one JSON object of them all, with the card's name
and power limit.
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
    from hulk_tpu_torch.ops import _build
    from hulk_tpu_torch.ops.device_step import sorted_batch_keys, stream_bucket
    from hulk_tpu_torch.ops.minimizer import unpack_codes2
    from hulk_tpu_torch.ops.minimizer_cuda import ARGTYPES as MIN_ARGS
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
    _, lengths, codes2, mask8 = kernel_batch(np.random.default_rng(cs.SEED), R, L, 120, 160)
    c2, m8, ln = (torch.from_numpy(a).to(dev) for a in (codes2, mask8, lengths))
    codes = unpack_codes2(c2, m8, ln)
    stream = torch.cuda.current_stream().cuda_stream
    wm = torch.empty((R, L), dtype=torch.int64, device=dev)
    rep = torch.empty((R, L), dtype=torch.bool, device=dev)
    ref = None
    results: dict[str, list[float]] = {}

    def record(key: str, ms: float) -> None:
        results.setdefault(key, []).append(ms)
        print(f"{key}: {ms:.4f} ms", flush=True)

    for name in ("other", "this", "this", "other"):
        lib = libs[name]
        f_u8 = bind(lib, "hulk_minimizer_window", takes_cont[name])
        f_pk = bind(lib, "hulk_minimizer_window_packed")
        f_jump = bind(lib, "hulk_jump_hash")
        f_bin = bind(lib, "hulk_bin_scatter_keys")
        record(f"{name} unpack_codes2 (plain, device)",
               cs.device_ms(lambda: unpack_codes2(c2, m8, ln)))
        a_u8 = (codes.data_ptr(), ln.data_ptr(), R, L, k, w, *([0] if takes_cont[name] else []),
                wm.data_ptr(), rep.data_ptr(), stream)
        record(f"{name} hulk_minimizer_window (u8)", cs.device_ms(lambda: f_u8(*a_u8)))
        if f_pk is not None:
            a_pk = (c2.data_ptr(), m8.data_ptr(), ln.data_ptr(), R, L, k, w, wm.data_ptr(),
                    rep.data_ptr(), stream)
            record(f"{name} hulk_minimizer_window_packed", cs.device_ms(lambda: f_pk(*a_pk)))
        torch.cuda.synchronize()
        if ref is None:
            ref = (wm.clone(), rep.clone())
            bucket = stream_bucket(R, R * L, l=L, k=k, w=w)
            skeys, _, _ = sorted_batch_keys(wm, rep, k=k, w=w, bucket=bucket)
        elif not (torch.equal(wm, ref[0]) and torch.equal(rep, ref[1])):
            raise SystemExit(f"FAIL {name}: window minima differ between the builds")

        # the binning pass as the other path runs it: masks, jump, index_add_
        def masks():
            live = skeys != -1
            neq = torch.ones_like(live)
            neq[1:] = skeys[1:] != skeys[:-1]
            mask = live & neq
            return torch.where(mask, skeys & ((1 << vbits) - 1), 0), mask

        record(f"{name} binning masks (plain, device)", cs.device_ms(masks))
        values, mask = masks()
        bins = torch.empty(values.shape, dtype=torch.int32, device=dev)
        a_jump = (values.data_ptr(), values.numel(), n, bins.data_ptr(), stream)
        record(f"{name} hulk_jump_hash", cs.device_ms(lambda: f_jump(*a_jump)))
        hist = torch.zeros(n, dtype=torch.int32, device=dev)
        bins64, ones = bins.long(), mask.int()
        record(f"{name} index_add_", cs.device_ms(lambda: hist.index_add_(0, bins64, ones)))
        want = torch.zeros_like(hist).index_add_(0, bins64, ones)
        if f_bin is not None:
            got = torch.zeros_like(hist)
            a_bin = (skeys.data_ptr(), skeys.numel(), vbits, got.data_ptr(), n, stream)
            if f_bin(*a_bin) != 0:
                raise SystemExit(f"FAIL {name}: hulk_bin_scatter_keys refused")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"FAIL {name}: histogram differs from jump + index_add_")
            record(f"{name} hulk_bin_scatter_keys", cs.device_ms(lambda: f_bin(*a_bin)))
    print(json.dumps({"card": smi, "shape": f"R={R} L={L} k={k} w={w} n={n} "
                      f"N={skeys.numel()}", "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
