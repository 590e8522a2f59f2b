"""The port's driver entry points, counterparts of __graft_entry__.py.

    entry(device=None)            -> (fn, (hist, codes, lengths)): one step of
                                     the streaming sketch (minimizers, jump
                                     binning, histogram accumulate) on one
                                     [64, 128] batch, on the card by default
    dryrun_multichip(n, devices)  -> the dp histogram step, the mp flush over
                                     slot stripes and the sharded pipeline
                                     with KMV, KHF and HMH, on n devices

A mesh is a list of torch.devices, which may name one device more than
once (parallel/mesh.py). From the shell, on the CPU:

    python -m hulk_tpu_torch.entry --device cpu
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from hulk_tpu_torch.ops.encode import PackedReads, pack_reads


def example_batch(r: int = 64, l: int = 128, seed: int = 0) -> PackedReads:
    """r random reads of l bases (ACGT 24% each, N 4%) from numpy's seed,
    packed [r, l]: __graft_entry__.py's _example_batch."""
    rng = np.random.default_rng(seed)
    seqs = [bytes(rng.choice(list(b"ACGTN"), size=l, p=[0.24, 0.24, 0.24, 0.24, 0.04]).tolist())
            for _ in range(r)]
    return pack_reads(seqs, pad_to=l, n_reads=r)


def entry(device=None):
    """(fn, (hist, codes, lengths)): fn(hist, codes, lengths) -> (hist,
    count) is ops/device_step.py:sketch_accumulate_step at k=21, w=9 into
    21^4 bins, for a batch of any shape; the arguments are an empty
    histogram and example_batch() on `device` (default: the card). fn adds
    into hist in place."""
    from hulk_tpu_torch.ops.device_step import sketch_accumulate_step

    dev = torch.device("cuda" if device is None else device)
    k, w, nbins = 21, 9, 21 ** 4
    packed = example_batch()
    hist = torch.zeros(nbins, dtype=torch.int32, device=dev)

    def fn(hist, codes, lengths):
        return sketch_accumulate_step(hist, codes, lengths, k=k, w=w)

    return fn, (hist, torch.from_numpy(packed.codes).to(dev),
                torch.from_numpy(packed.lengths).to(dev))


@dataclass
class DryrunResult:
    devices: list  # the mesh, n devices
    n_dp: int
    n_mp: int
    count: int  # minimizers of the dp histogram step
    sketch: np.ndarray  # [s] int64, the mp flush's
    weights: np.ndarray  # [s] f64
    result: object  # the pipeline's SketchResult


def default_mesh(n: int) -> list:
    """The first n cards when n are visible, else the one card named n
    times."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name the devices (devices=['cpu'] * n)")
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def dryrun_multichip(n: int, devices=None) -> DryrunResult:
    """__graft_entry__.py's dryrun_multichip on n devices (default_mesh(n)
    unless named): n_mp = 2 for an even n (else 1), n_dp = n // n_mp, the
    dp devices every n_mp-th and the mp devices the first n_mp, as in a
    (dp, mp) mesh of the n. At k=7, w=5, s=8 (2,401 bins) it runs
    sharded_histogram_step over the dp devices on 8 * n_dp reads of 64
    bases, sharded_flush_step without drift over the mp slot stripes, and
    run_sketch_pipeline with KMV, KHF and HMH on all n devices over 256
    reads of 96 bases in batches of 64. Prints the mesh and a summary, and
    returns what it computed."""
    from hulk_tpu_torch.hashes.cws import build_cws_tables
    from hulk_tpu_torch.parallel.mesh import (
        shard_tables,
        sharded_flush_step,
        sharded_histogram_step,
    )
    from hulk_tpu_torch.sketch.countmin import cms_row_bins_table, cms_shape
    from hulk_tpu_torch.stream.pipeline import SketchConfig, run_sketch_pipeline

    devices = default_mesh(n) if devices is None else [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a mesh of {n} devices needs {n} names, got {len(devices)}")
    n_mp = 2 if n % 2 == 0 and n >= 2 else 1
    n_dp = n // n_mp
    dp, mp = devices[::n_mp], devices[:n_mp]
    print(f"dryrun_multichip mesh: dp={n_dp} x mp={n_mp} over "
          f"[{', '.join(str(d) for d in devices)}]", flush=True)

    k, w, s = 7, 5, 8
    nbins = k ** 4
    packed = example_batch(r=8 * max(1, n_dp), l=64)
    hist, count = sharded_histogram_step(dp, nbins, k, w)(packed.codes, packed.lengths)

    depth, width = cms_shape()
    row_bins = torch.from_numpy(cms_row_bins_table(nbins, depth, width).astype(np.int64))
    flush = sharded_flush_step(mp, 0.0, False, depth, width)
    _, sk, wts = flush(hist, row_bins, torch.zeros(depth, width, dtype=torch.float64),
                       torch.zeros(s, dtype=torch.int64),
                       torch.full((s,), np.finfo(np.float64).max, dtype=torch.float64),
                       shard_tables(mp, build_cws_tables(s, nbins)))
    count, sk, wts = int(count), sk.cpu().numpy(), wts.cpu().numpy()
    if count <= 0 or sk.shape != (s,):
        raise RuntimeError(f"dryrun_multichip: {count} minimizers, a sketch of {sk.shape}")

    rng = np.random.default_rng(1)
    reads = [bytes(rng.choice(list(b"ACGTN"), size=96, p=[0.24] * 4 + [0.04]).tolist())
             for _ in range(256)]
    cfg = SketchConfig(kmer_size=k, window_size=w, sketch_size=s, spectrum_size=nbins,
                       kmv=True, khf=True, hmh=True, batch_size=64,
                       device=str(devices[0]), devices=devices)
    res = run_sketch_pipeline(iter(reads), cfg)
    if res.seq_count != 256 or res.minimizer_count <= 0:
        raise RuntimeError(f"dryrun_multichip: the pipeline read {res.seq_count} reads, "
                           f"found {res.minimizer_count} minimizers")
    hs = dict(res.hulk_data.signatures)["histosketch"]
    print(f"dryrun_multichip ok: minimizers={count}, sketch={sk[:4].tolist()}..., "
          f"pipeline on {n} devices: {res.minimizer_count} minimizers, "
          f"sketch={hs.get_sketch()[:4].tolist()}...", flush=True)
    return DryrunResult(devices, n_dp, n_mp, count, sk, wts, res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hulk_tpu_torch.entry",
                                 description="run entry()'s step and dryrun_multichip(8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    print(f"entry ok: {int(fn(*fargs)[1])} minimizers", flush=True)
    dryrun_multichip(8, None if args.device == "cuda" else [args.device] * 8)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
