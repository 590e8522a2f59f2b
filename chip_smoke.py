#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hulk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: the card's name, count and power limit; build the CUDA kernels
     (one nvcc process per source, started together, and a link into one
     library) and the native host runtime (g++); print each build's seconds
     and ptxas's register/spill lines.
  2. kernels: each of the six kernel entries (five C entries, the u8 one
     also in its cont form) against its plain PyTorch version on the card,
     at the shapes the driven paths launch (with random pad past each read
     and rows of length 0 where the path pads) and on corner cases; all
     must be bit-equal. Each entry's device time at the shape of its path
     (50 launches queued through its C entry, one event pair) beside its
     bound, and the plain version's time (CUDA events around one call,
     median of 20 after 3 warm-ups). Then the KMV, KHF and HMH updates' time
     a batch (plain PyTorch, CUDA events around one call).
  3. end to end: `sketch` through hulk_tpu_torch.cli.main on 1,000,000
     synthetic 150 bp reads (gzip FASTQ, seed 0) at k=21, w=9, s=42, with
     every entry's launch count set to 0 just before and read just after;
     the main path's two entries (packed minimizer, fused binning pass) must
     each have launched, once per batch.
  3b. profile: warm passes over the same file: the host parse alone (no
     device), `sketch` end to end, and `sketch` under torch.profiler for the
     device's busy share, the operators with the most device time and each
     kernel's device time a launch; index_add_ must not appear.
  4. equality: the first 50,000 of those reads sketched on the card and with
     --device cpu (the plain versions) must give byte-identical out.json.
  5. sketches: `sketch --kmv --khf --hmh` on the same reads (k=21, w=9,
     s=42): the packed minimizer and the fused binning pass once per batch
     (as many batches as phase 3), out.json holds four sketches; profiled
     once; the first 50,000 reads byte-identical on card and CPU.
  6. two-sort: `sketch -k 31 -w 9 -s 42` on the same reads (R = 2048,
     923,521 bins): the packed minimizer and the values binning entry once
     per batch, the fused binning pass never; profiled once; the first
     50,000 reads byte-identical on card and CPU.
  7. FASTA: `sketch --fasta` (k=21, w=9, s=42) on 2,000 synthetic contigs
     of 1-200 kb (about 206 Mb, 60 columns, 1% N, seed 0): each contig of
     65,536 bases or more runs block 0 through the u8 entry once and its
     continuation blocks through the cont entry once per group of 16; the
     shorter contigs take the fused step; the first 40 contigs
     byte-identical on card and CPU, profiled once, and the host's share of
     their long-read path timed (the blockwise scan against the host
     spectrum's binning of its values).
  8. intervals (BASELINE config 4): ten gzip FASTQ files of 1M reads (phase
     3's and nine generated in parallel processes, seeds 1-9) as one -f
     list: (8a) `-i 1000000 -x 0.9 --stream --checkpoint`, reads/s, ten
     interval documents and the final one on stdout, the streaming
     thread's waits on the flush worker, and a profiled run over files 0-1;
     (8b) the host flush against --deviceFlush (out.json byte-identical, no
     margin fallback), then one interval's flush alone: the candidate
     stage's device time beside its bound, and the exact host flush without
     and with drift; (8c) a run over files 0-4 with --checkpoint, resumed
     over all ten: it seeks to file 4 and gives 8a's out.json; (8d) the
     first 50,000 reads with -i 10000 --stream --streamAll and the three
     sketches, and with --deviceFlush against the host flush on the CPU:
     stdout and out.json byte-identical card vs CPU. Every run's launches
     are asserted: the packed minimizer and the fused binning pass once per
     batch.
  9. smash: 1,024 synthetic sketch JSONs (16 families), `smash -m
     weightedjaccard` and `-m jaccard` on the card and with --device cpu:
     CSV byte-identical, the first 40 sketches' cells equal to the host
     path's; wall seconds, the matrix's device time and the cells
     rechecked on the host; the matrix alone at 4,096 sketches beside its
     bound; `print` and `distance` on both devices.
  10. LSH (BASELINE config 5): (10a) a corpus of 100,000 sketches (s=42,
     synth.lsh_corpus, seed 0) and 1,000 near-duplicate queries at t=0.9:
     the forest's build, `sharded_lsh_search` on the card (queries/s), the
     brute-force ranking on the card against the CPU's on 50 queries, recall
     >= 0.95 and precision 1.0 against it, and the ranking's device time
     beside its bound; (10b) 20,000 rows of mins in [0, 2) at t=0.5, where
     candidates pass 25% of Q*N: the card's ranking against the host's
     scoring, the same hit lists; (10c) two ranks (spawned processes, one
     gloo group) each indexing half of 10a's corpus, `multiprocess_lsh_search`
     top 64 equal to one process's; (10d) `index -r create` and `-r search`
     over phase 9's sketches, card against --device cpu, index and stdout
     byte-identical; (10e) phase 9's weighted smash in two ranks on the card,
     the CSV byte-identical to phase 9's.
Then one JSON line of the device stages that have no TPU kernel (the
flush's candidate stage, the smash matrix, the LSH ranking) with device ms
and bound, one
JSON line of kernels (every entry, with its launches summed over the driven
runs of phases 3, 5, 6, 7 and 8), the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Any failure ends the run with a
non-zero exit code and no result line. Nothing is written into the
repository except the gitignored kernel build directory; the inputs and
outputs live in a temporary directory that is removed at the end.
"""
from __future__ import annotations

import contextlib
import gzip
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
READS = 1_000_000
SEED = 0

# H100 SXM peaks: HBM3 bandwidth and FP64 outside the tensor cores (NVIDIA
# data sheet); INT32 issue rate, 64 INT32 lanes per SM x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 16.7e12
# least u64 operations per position of a rolling minimizer scan (k-mer
# update, canonical pick, hash64, span, sliding minimum), each two int32 ops;
# counted at the positions inside the reads
MIN_U64_OPS_PER_POS = 40
# the sleep that holds the card while device_ms queues its launches:
# 40M cycles, 20 ms at the H100's 1.98 GHz boost clock
SLEEP_CYCLES = 40_000_000
# the main path's batch (R, L, k, w) and histogram width (21^4 bins)
PRODUCTION = (16384, 160, 21, 9)
NBINS = 194_481
# minimizer cases (R, L, k, w, shortest and longest read): the production
# batch, then corners; L % 8 == 0 for the packed entry
MINIMIZER_CASES = [(*PRODUCTION, 120, 160), (256, 200, 31, 2, 40, 200),
                   (256, 304, 5, 64, 60, 304), (64, 5000, 21, 9, 100, 5000),
                   (128, 96, 3, 20, 1, 96)]
# the two-sort step's batch (R, L, k, w) and histogram width (31^4 bins)
TWO_SORT = (2048, 160, 31, 9)
NBINS_K31 = 923_521
# the equality subsets of phases 4-6 (reads) and 7 (contigs)
SUBSET_READS = 50_000
SUBSET_CONTIGS = 40
# the FASTA phase's contigs: count, shortest, longest
CONTIGS = (2000, 1000, 200_000)
# BASELINE config 5 (phase 10a): corpus rows, queries, sketch size, threshold
LSH = (100_000, 1_000, 42, 0.9)
# phase 10b's corpus for the dense-candidate branch: rows, queries, value
# range of the mins, threshold
LSH_DENSE = (20_000, 200, 2, 0.5)
# the equality subset of 10a (queries ranked on the CPU too), the top-K of
# 10c, and how long a spawned rank may take
LSH_SUBSET = 50
LSH_TOPK = 64
RANK_TIMEOUT = 600


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of fn() on the card, one CUDA event pair around
    each call (host time inside the call included): for the plain versions."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(launch, reps: int = 50, warm: int = 5) -> float:
    """Device milliseconds a launch: after warm-ups, `reps` launches queued
    back to back through the C entry behind a sleep kernel that holds the
    card while the host queues them, one event pair around the launches,
    divided by reps. Fails if the host took longer to queue them than the
    sleep lasted (the card would then have idled inside the pair)."""
    import torch

    for _ in range(warm):
        launch()
    torch.cuda.synchronize()
    s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    sleep_ms = s0.elapsed_time(a)
    if host_ms >= sleep_ms:
        raise SystemExit(f"FAIL timing: queueing took {host_ms:.3f} ms, the sleep "
                         f"{sleep_ms:.3f} ms")
    return a.elapsed_time(b) / reps


def adversarial_keys():
    """Keys whose first divisor d=(key>>33)+1 hits the f64 rounding
    boundaries: d=1, d=2^31, powers of two and their neighbours."""
    import numpy as np

    ds = [1, 2, 3]
    for p in range(2, 32):
        ds += [(1 << p) - 1, 1 << p, (1 << p) + 1]
    ds = [d for d in ds if 1 <= d <= (1 << 31)]
    keys = np.array([(d - 1) << 33 for d in ds], dtype=np.uint64)
    return np.concatenate([keys, keys | np.uint64(0x1FFFFFFFF), keys | np.uint64(1)])


def check_equal(name: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise SystemExit(f"FAIL {name}: {bad} of {got.numel()} lanes differ")


def max_abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Least milliseconds: bytes over HBM bandwidth or operations over their
    peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fasta_cases() -> tuple[list, list]:
    """The FASTA phase's launch shapes (R, L, k, w, shortest and longest
    read, rows with a read): for the u8 and packed entries, the largest
    batch of the top length bucket (MAX_BATCH_POSITIONS / L rows), a small
    one padded with empty rows, and a long read's block 0 [1, DEFAULT_BLOCK];
    for the cont entry, groups of DEFAULT_GROUP continuation blocks with 3
    live rows (a contig of up to 200 kb; the first, timed) and with all
    live, at k=21/w=9 and k=31/w=2."""
    from hulk_tpu_torch.ops.longread import DEFAULT_BLOCK as B, DEFAULT_GROUP as G
    from hulk_tpu_torch.stream.fastq import DEFAULT_LENGTH_BUCKETS
    from hulk_tpu_torch.stream.pipeline import MAX_BATCH_POSITIONS

    top, lo = DEFAULT_LENGTH_BUCKETS[-1], DEFAULT_LENGTH_BUCKETS[-2] + 1
    rows = MAX_BATCH_POSITIONS // top
    window = [(rows, top, 21, 9, lo, top, rows), (64, top, 21, 9, lo, top, 5),
              (1, B, 21, 9, B, B, 1)]
    cont = [(G, B, 21, 9, 1000, B, 3), (G, B, 21, 9, 1000, B, G), (G, B, 31, 2, 1000, B, G)]
    return window, cont


def minimizer_bound(R: int, L: int, lengths, packed: bool) -> tuple[float, str]:
    """Bytes: the codes read once ([R, L/4] + [R, L/8] packed, or [R, L]
    u8) with the lengths, wmin and report written at every position;
    operations: MIN_U64_OPS_PER_POS at each position inside a read."""
    read = R * (L // 4 + L // 8) if packed else R * L
    ops = 2 * MIN_U64_OPS_PER_POS * int(lengths.clip(max=L).sum())
    return bound(read + 4 * R + 9 * R * L, ops, INT32_OPS_PER_S)


def minimizer_checks(rng, dev) -> dict:
    """The three minimizer entries against their plain versions on every
    case; at the driven paths' shapes, their device times beside their
    bounds: the packed entry at the production batch, the u8 entry at a long
    read's block 0, the cont entry at a group of continuation blocks."""
    import torch

    from hulk_tpu_torch.ops import minimizer_cuda as mc
    from hulk_tpu_torch.ops.minimizer import (minimizer_window_packed_torch,
                                              minimizer_window_torch, unpack_codes2)
    from hulk_tpu_torch.synth import kernel_batch

    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for R, L, k, w, lo, hi in MINIMIZER_CASES:
        codes, lengths, codes2, mask8 = kernel_batch(rng, R, L, lo, hi)
        c, ln, c2, m8 = (torch.from_numpy(a).to(dev) for a in (codes, lengths, codes2, mask8))
        tag = f"R={R} L={L} k={k} w={w}"
        wm, rep = mc.minimizer_window_cuda(c, ln, k, w)
        wm0, rep0 = minimizer_window_torch(c, ln, k, w)
        pm, prep = mc.minimizer_window_packed_cuda(c2, m8, ln, k, w)
        pm0, prep0 = minimizer_window_packed_torch(c2, m8, ln, k, w)
        torch.cuda.synchronize()
        check_equal(f"minimizer_window {tag} report", rep, rep0)
        check_equal(f"minimizer_window {tag} wmin", wm, wm0)
        check_equal(f"minimizer_window_packed {tag} report", prep, prep0)
        check_equal(f"minimizer_window_packed {tag} wmin", pm, pm0)
        print(f"minimizer_window u8 and packed {tag}: bit-equal "
              f"({int(rep.sum())} and {int(prep.sum())} reported lanes)", flush=True)
        if (R, L, k, w) == PRODUCTION:
            # the main path's batch: the binning pass's keys come from it too
            out["batch"] = (pm, prep)
            f_pk = mc.entry("hulk_minimizer_window_packed")
            a_pk = (c2.data_ptr(), m8.data_ptr(), ln.data_ptr(), R, L, k, w, pm.data_ptr(),
                    prep.data_ptr(), stream)
            out["packed"] = dict(
                ms=device_ms(lambda: f_pk(*a_pk)),
                plain_ms=time_ms(lambda: minimizer_window_packed_torch(c2, m8, ln, k, w)),
                bound=minimizer_bound(R, L, lengths, packed=True),
                err=max(max_abs_err(pm, pm0), max_abs_err(prep, prep0)), shape=tag)
            out["unpack_ms"] = time_ms(lambda: unpack_codes2(c2, m8, ln))
            if f_pk(*a_pk) != 0:
                raise SystemExit("FAIL minimizer_window_packed: a timed launch was refused")
        if (R, L, k, w) == TWO_SORT:
            out["two_sort_batch"] = (pm, prep)
        torch.cuda.synchronize()
    if "two_sort_batch" not in out:  # the two-sort step's batch, k = 31
        R, L, k, w = TWO_SORT
        _, lengths, codes2, mask8 = kernel_batch(rng, R, L, 120, L)
        c2, m8, ln = (torch.from_numpy(a).to(dev) for a in (codes2, mask8, lengths))
        pm, prep = mc.minimizer_window_packed_cuda(c2, m8, ln, k, w)
        pm0, prep0 = minimizer_window_packed_torch(c2, m8, ln, k, w)
        check_equal(f"minimizer_window_packed R={R} L={L} k={k} w={w} report", prep, prep0)
        check_equal(f"minimizer_window_packed R={R} L={L} k={k} w={w} wmin", pm, pm0)
        print(f"minimizer_window packed R={R} L={L} k={k} w={w}: bit-equal", flush=True)
        out["two_sort_batch"] = (pm, prep)

    window_cases, cont_cases = fasta_cases()
    for R, L, k, w, lo, hi, live in window_cases:
        codes, lengths, codes2, mask8 = kernel_batch(rng, R, L, lo, hi, live=live)
        c, ln, c2, m8 = (torch.from_numpy(a).to(dev) for a in (codes, lengths, codes2, mask8))
        tag = f"R={R} ({live} live) L={L} k={k} w={w}"
        wm, rep = mc.minimizer_window_cuda(c, ln, k, w)
        wm0, rep0 = minimizer_window_torch(c, ln, k, w)
        pm, prep = mc.minimizer_window_packed_cuda(c2, m8, ln, k, w)
        pm0, prep0 = minimizer_window_packed_torch(c2, m8, ln, k, w)
        torch.cuda.synchronize()
        check_equal(f"minimizer_window {tag} report", rep, rep0)
        check_equal(f"minimizer_window {tag} wmin", wm, wm0)
        check_equal(f"minimizer_window_packed {tag} report", prep, prep0)
        check_equal(f"minimizer_window_packed {tag} wmin", pm, pm0)
        print(f"minimizer_window u8 and packed {tag}: bit-equal "
              f"({int(rep.sum())} and {int(prep.sum())} reported lanes)", flush=True)
        del pm, prep, pm0, prep0, c2, m8
        if R == 1:  # a long read's block 0: the u8 entry's path shape
            f_u8 = mc.entry("hulk_minimizer_window")
            a_u8 = (c.data_ptr(), ln.data_ptr(), R, L, k, w, 0, wm.data_ptr(),
                    rep.data_ptr(), stream)
            out["u8"] = dict(
                ms=device_ms(lambda: f_u8(*a_u8)),
                plain_ms=time_ms(lambda: minimizer_window_torch(c, ln, k, w)),
                bound=minimizer_bound(R, L, lengths, packed=False),
                err=max(max_abs_err(wm, wm0), max_abs_err(rep, rep0)), shape=tag)
            if f_u8(*a_u8) != 0:
                raise SystemExit("FAIL minimizer_window: a timed launch was refused")
        del c, ln, wm, rep, wm0, rep0
        torch.cuda.synchronize()

    for R, L, k, w, lo, hi, live in cont_cases:
        codes, lengths, _, _ = kernel_batch(rng, R, L, lo, hi, live=live)
        c, ln = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
        tag = f"R={R} ({live} live) L={L} k={k} w={w}"
        wm, rep = mc.minimizer_window_cuda(c, ln, k, w, cont=True)
        wm0, rep0 = minimizer_window_torch(c, ln, k, w, cont=True)
        torch.cuda.synchronize()
        check_equal(f"minimizer_window_cont {tag} report", rep, rep0)
        check_equal(f"minimizer_window_cont {tag} wmin", wm, wm0)
        print(f"minimizer_window cont {tag}: bit-equal ({int(rep.sum())} reported lanes)",
              flush=True)
        if "cont" in out:
            continue
        f_ct = mc.entry("hulk_minimizer_window")
        a_ct = (c.data_ptr(), ln.data_ptr(), R, L, k, w, 1, wm.data_ptr(), rep.data_ptr(),
                stream)
        out["cont"] = dict(
            ms=device_ms(lambda: f_ct(*a_ct)),
            plain_ms=time_ms(lambda: minimizer_window_torch(c, ln, k, w, cont=True)),
            bound=minimizer_bound(R, L, lengths, packed=False),
            err=max(max_abs_err(wm, wm0), max_abs_err(rep, rep0)), shape=tag)
        if f_ct(*a_ct) != 0:
            raise SystemExit("FAIL minimizer_window (cont): a timed launch was refused")
        torch.cuda.synchronize()
    return out


def jump_checks(rng, dev, batch, two_sort_batch) -> dict:
    """The three jump entries against their plain versions: the binning pass
    on the production batch's sorted keys and on synthetic sorted keys
    (mixed, all sentinel, one key repeated) at n = 194,481 and 2^31 - 1; the
    values entry on the k=31 two-sort batch's sorted values (above 2^63) and
    on synthetic sorted values (full range with runs of equal values, all
    sentinel, one value repeated) at n = 1, 923,521 and 2^31 - 1; the
    buckets-only entry on random and adversarial keys. Device times at the
    main paths' batches beside their bounds."""
    import numpy as np
    import torch

    from hulk_tpu_torch.hashes.jumphash import jump_hash_torch
    from hulk_tpu_torch.ops import jump_cuda as jc
    from hulk_tpu_torch.ops.device_step import (bin_scatter_keys_torch,
                                                bin_scatter_values_torch,
                                                sorted_batch_keys, sorted_batch_values,
                                                stream_bucket)
    from hulk_tpu_torch.synth import sorted_keys, sorted_values

    R, L, k, w = PRODUCTION
    vbits, n = 2 * k + 8, NBINS
    bucket = stream_bucket(R, R * L, l=L, k=k, w=w)
    skeys, _, _ = sorted_batch_keys(*batch, k=k, w=w, bucket=bucket)
    N = skeys.numel()
    hist = torch.zeros(n, dtype=torch.int32, device=dev)
    hist0 = torch.zeros_like(hist)
    jc.bin_scatter_keys_cuda(hist, skeys, vbits)
    bin_scatter_keys_torch(hist0, skeys, vbits)
    check_equal(f"bin_scatter_keys production batch N={N} n={n}", hist, hist0)
    err = max_abs_err(hist, hist0)
    touched = int((hist != 0).sum())  # bins the batch adds to
    for kind, n_keys in (("mixed", 200_000), ("all_sentinel", 0), ("dup_only", 5000)):
        keys = torch.from_numpy(sorted_keys(rng, n_keys, vbits, dup_only=kind == "dup_only")
                                .view(np.int64)).to(dev)
        for nb in (n, 2**31 - 1):
            got = torch.zeros(nb, dtype=torch.int32, device=dev)
            want = torch.zeros(nb, dtype=torch.int32, device=dev)
            jc.bin_scatter_keys_cuda(got, keys, vbits)
            bin_scatter_keys_torch(want, keys, vbits)
            check_equal(f"bin_scatter_keys {kind} n={nb}", got, want)
            del got, want
    print(f"bin_scatter_keys production batch ({N} keys) and mixed/all-sentinel/"
          f"duplicate-only keys at n={n} and 2^31-1: bit-equal", flush=True)

    # the values entry: the two-sort batch at k = 31, whole (sentinel tail
    # included) and its live prefix, then synthetic sorted values
    svals, cnt = sorted_batch_values(*two_sort_batch)
    n31 = NBINS_K31
    above = int((svals[:cnt] < 0).sum())
    if above == 0:
        raise SystemExit("FAIL two-sort batch: no value at or above 2^63")
    vhist = torch.zeros(n31, dtype=torch.int32, device=dev)
    vhist0 = torch.zeros_like(vhist)
    for part in (svals, svals[:cnt]):
        vhist.zero_()
        vhist0.zero_()
        jc.bin_scatter_values_cuda(vhist, part)
        bin_scatter_values_torch(vhist0, part)
        check_equal(f"bin_scatter_values two-sort batch N={part.numel()} n={n31}", vhist, vhist0)
        if int(vhist.sum()) != cnt:
            raise SystemExit(f"FAIL bin_scatter_values: {int(vhist.sum())} counted, {cnt} live")
    verr = max_abs_err(vhist, vhist0)
    vtouched = int((vhist != 0).sum())  # bins the live values add to
    for kind, n_vals in (("mixed", 200_000), ("all_sentinel", 0), ("one_key", 5000)):
        vals = torch.from_numpy(sorted_values(rng, n_vals, one_key=kind == "one_key")
                                .view(np.int64)).to(dev)
        for nb in (1, n31, 2**31 - 1):
            got = torch.zeros(nb, dtype=torch.int32, device=dev)
            want = torch.zeros(nb, dtype=torch.int32, device=dev)
            jc.bin_scatter_values_cuda(got, vals)
            bin_scatter_values_torch(want, vals)
            check_equal(f"bin_scatter_values {kind} n={nb}", got, want)
            del got, want
    print(f"bin_scatter_values two-sort batch k=31 ({svals.numel()} lanes, {cnt} live, "
          f"{above} at or above 2^63) and full-range/all-sentinel/one-key values at "
          f"n=1, {n31} and 2^31-1: bit-equal", flush=True)

    live = skeys != -1
    live[1:] &= skeys[1:] != skeys[:-1]
    values = torch.where(live, skeys & ((1 << vbits) - 1), 0)
    got = jc.jump_hash_cuda(values, n)
    want = jump_hash_torch(values, n)
    check_equal(f"jump_hash production values N={N} n={n}", got, want)
    berr = max_abs_err(got, want)
    rkeys = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=N,
                                          dtype=np.int64)).to(dev)
    check_equal(f"jump_hash random keys N={N}", jc.jump_hash_cuda(rkeys, n),
                jump_hash_torch(rkeys, n))
    adv = torch.from_numpy(adversarial_keys().view(np.int64)).to(dev)
    for nb in (1, 2, 2000, 194481, 2**31 - 1):
        check_equal(f"jump_hash adversarial n={nb}", jc.jump_hash_cuda(adv, nb),
                    jump_hash_torch(adv, nb))
    print(f"jump_hash production values, random keys and adversarial keys "
          f"({adv.numel()} x 5 n): bit-equal", flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    f_bin, f_jump = jc.entry("hulk_bin_scatter_keys"), jc.entry("hulk_jump_hash")
    f_val = jc.entry("hulk_bin_scatter_values")
    a_bin = (skeys.data_ptr(), N, vbits, hist.data_ptr(), n, stream)
    a_jump = (values.data_ptr(), N, n, got.data_ptr(), stream)
    live_vals = svals[:cnt]
    a_val = (live_vals.data_ptr(), cnt, vhist.data_ptr(), n31, stream)
    iters_live = jump_iterations(values[live], n)
    iters_all = jump_iterations(values, n)
    iters_vals = jump_iterations(live_vals, n31)
    bins64, ones = got.long(), live.int()
    # bytes: the keys or values read once, and each bin they add to read and
    # written once (4 bytes each way)
    out = {
        "fused": dict(ms=device_ms(lambda: f_bin(*a_bin)),
                      plain_ms=time_ms(lambda: bin_scatter_keys_torch(hist0, skeys, vbits)),
                      bound=bound(8 * N + 2 * 4 * touched, 2 * iters_live, FP64_OPS_PER_S),
                      err=err, shape=f"N={N} n={n} ({int(live.sum())} live distinct "
                                     f"keys into {touched} bins, {iters_live} loop "
                                     f"iterations)"),
        "buckets": dict(ms=device_ms(lambda: f_jump(*a_jump)),
                        plain_ms=time_ms(lambda: jump_hash_torch(values, n)),
                        bound=bound(12 * N, 2 * iters_all, FP64_OPS_PER_S), err=berr,
                        shape=f"N={N} n={n} ({iters_all} loop iterations)"),
        "values": dict(ms=device_ms(lambda: f_val(*a_val)),
                       plain_ms=time_ms(lambda: bin_scatter_values_torch(vhist0, live_vals)),
                       bound=bound(8 * cnt + 2 * 4 * vtouched, 2 * iters_vals,
                                   FP64_OPS_PER_S),
                       err=verr, shape=f"N={cnt} n={n31} (the k=31 two-sort batch's live "
                                       f"values into {vtouched} bins, {iters_vals} loop "
                                       f"iterations)"),
        "index_add_ms": device_ms(lambda: hist0.index_add_(0, bins64, ones)),
        "keys": skeys,
        "values_live": live_vals,
    }
    if f_bin(*a_bin) != 0 or f_jump(*a_jump) != 0 or f_val(*a_val) != 0:
        raise SystemExit("FAIL jump_hash: a timed launch was refused")
    torch.cuda.synchronize()
    return out


def sketch_update_times(keys, values_live) -> None:
    """The KMV, KHF and HMH updates a batch (plain PyTorch on the card), on
    the production batch's fused feed and on the two-sort batch's."""
    from hulk_tpu_torch.ops.device_sketches import (SketchStates, hmh_update, khf_update,
                                                    kmv_update)
    from hulk_tpu_torch.ops.device_step import bottom_k_values, distinct_values

    k = PRODUCTION[2]
    n_live = int((keys != -1).sum())
    feeds = {"fused k=21 R=16384": (distinct_values(keys[:n_live], 2 * k + 8), False),
             "two-sort k=31 R=2048": (values_live, True)}
    for tag, (vals, ascending) in feeds.items():
        st = SketchStates.empty(42, kmv=True, khf=True, hmh=True, device=vals.device)
        kmv = time_ms(lambda: kmv_update(st.kmv, vals if ascending else bottom_k_values(vals, 42)))
        khf = time_ms(lambda: khf_update(st.khf, vals))
        hmh = time_ms(lambda: hmh_update(st.hmh, vals))
        print(f"sketch updates a batch, {tag} ({vals.numel()} values fed, s=42): "
              f"KMV {kmv:.4f} ms, KHF {khf:.4f} ms, HMH {hmh:.4f} ms "
              f"(plain PyTorch, CUDA events around one call)", flush=True)


# the JSON rows: (row name, C entry, launch counter key, source, TPU kernel)
ENTRIES = [
    ("minimizer_window", "hulk_minimizer_window_packed", "minimizer_window_packed",
     "minimizer_window.cu", "minimizer_pallas.py:223", "packed"),
    ("jump_hash", "hulk_bin_scatter_keys", "bin_scatter_keys", "jump_hash.cu",
     "jump_pallas.py:284", "fused"),
    ("minimizer_window_u8", "hulk_minimizer_window", "minimizer_window",
     "minimizer_window.cu", "minimizer_pallas.py:223", "u8"),
    ("minimizer_window_cont", "hulk_minimizer_window (cont=1)", "minimizer_window_cont",
     "minimizer_window.cu", "minimizer_pallas.py:223", "cont"),
    ("jump_hash_buckets", "hulk_jump_hash", "jump_hash", "jump_hash.cu",
     "jump_pallas.py:284", "buckets"),
    ("jump_hash_values", "hulk_bin_scatter_values", "bin_scatter_values", "jump_hash.cu",
     "jump_pallas.py:284", "values"),
]


def kernel_phase(rng, dev) -> dict:
    mins = minimizer_checks(rng, dev)
    jumps = jump_checks(rng, dev, mins.pop("batch"), mins.pop("two_sort_batch"))
    results = {**mins, **jumps}
    for name, entry, _, _, _, key in ENTRIES:
        r = results[key]
        print(f"{name} ({entry}) {r['shape']}: device {r['ms']:.4f} ms a launch, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{100 * r['bound'][0] / r['ms']:.1f}% of bound", flush=True)
    print(f"unpack_codes2 (plain, the pass the packed entry replaces): "
          f"{mins['unpack_ms']:.4f} ms; index_add_ of the production batch: "
          f"device {jumps['index_add_ms']:.4f} ms", flush=True)
    sketch_update_times(jumps["keys"], jumps["values_live"])
    rows = {}
    for name, entry, counter, src, rep, key in ENTRIES:
        r = results[key]
        rows[name] = dict(
            name=name, route="cuda", source=f"hulk_tpu_torch/csrc/{src}",
            replaces=f"hulk_tpu/ops/{rep}", entry=entry, counter=counter,
            max_abs_err=r["err"], bit_equal=True, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=None)
    return rows


def jump_iterations(keys, n: int) -> int:
    """Loop iterations these keys need (Go's loop, counted on the card)."""
    import torch

    from hulk_tpu_torch._u64 import srl

    key = keys.clone()
    j = torch.zeros_like(key)
    total = 0
    while key.numel():
        total += key.numel()
        key = key * 2862933555777941757 + 1
        d = (srl(key, 33) + 1).double()
        j = ((j + 1).double() * (2147483648.0 / d)).long()
        keep = j < n
        key, j = key[keep], j[keep]
    return total


def sketch_cli(src: str, out: str, device: str, log_path: str,
               extra=()) -> tuple[float, int]:
    """Run the port's CLI (k=21, s=42 unless extra says otherwise); return
    (seconds, minimizer count from its log)."""
    from hulk_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(["sketch", "-f", src, "-k", "21", "-s", "42", *extra, "-o", out,
                   "--device", device, "--log", log_path])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"FAIL sketch {' '.join(extra)} on {device}: exit code {rc}")
    with open(log_path) as fh:
        found = re.findall(r"found (\d+) minimizers", fh.read())
    if not found:
        raise SystemExit(f"FAIL sketch on {device}: no minimizer count in the log")
    return seconds, int(found[-1])


def check_sketch(path: str, s: int, k: int = 21, algos=("histosketch",)) -> None:
    """The out.json loads through the port's own reader (envelope, version
    and MD5 checks), holds exactly `algos`, and its k histosketch has s
    finite weights over k^4 bins."""
    import numpy as np

    from hulk_tpu_torch.io.sketchio import load_hulk_data

    data = load_hulk_data(path)
    if [a for a, _ in data.signatures] != list(algos):
        raise SystemExit(f"FAIL {path}: sketches {[a for a, _ in data.signatures]}, "
                         f"expected {list(algos)}")
    for algo in algos:
        data.find_sketch(k, algo)
    sk = data.find_sketch(k, "histosketch")
    if sk.mins.shape != (s,) or sk.weights.shape != (s,):
        raise SystemExit(f"FAIL {path}: expected {s} mins and weights")
    if not np.isfinite(sk.weights).all() or (sk.mins >= k ** 4).any():
        raise SystemExit(f"FAIL {path}: non-finite weights or bins out of range")


def reset_launches() -> None:
    from hulk_tpu_torch.ops import jump_cuda, minimizer_cuda

    for d in (minimizer_cuda.launches, jump_cuda.launches):
        d.update(dict.fromkeys(d, 0))


def read_launches() -> dict:
    from hulk_tpu_torch.ops import jump_cuda, minimizer_cuda

    return {**minimizer_cuda.launches, **jump_cuda.launches}


def drive(tag: str, src: str, tmp: str, extra=()) -> tuple[float, int, dict]:
    """One launch-counted run of the main path on the card: every count set
    to 0 just before, read just after; what the run writes to stdout (the
    --stream documents) goes to <tag>.stdout. Returns (seconds, minimizers,
    counts)."""
    reset_launches()
    with captured_stdout() as out:
        seconds, n_min = sketch_cli(src, os.path.join(tmp, tag), "cuda",
                                    os.path.join(tmp, f"{tag}.log"), extra)
    counts = read_launches()
    with open(os.path.join(tmp, f"{tag}.stdout"), "wb") as fh:
        fh.write(out.getvalue())
    print(f"{tag}: {seconds:.3f} s, {n_min} minimizers, launches {counts}", flush=True)
    return seconds, n_min, counts


def card_vs_cpu(label: str, src: str, tmp: str, extra=()) -> str:
    """The same input on the card and with --device cpu: out.json must be
    byte-identical. Returns the card's out.json path."""
    tag = re.sub(r"\W+", "_", label)
    outs = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, f"{tag}_{device}")
        t, _ = sketch_cli(src, out, device, out + ".log", extra)
        with open(out + ".json", "rb") as fh:
            outs[device] = (fh.read(), t)
    if outs["cuda"][0] != outs["cpu"][0]:
        raise SystemExit(f"FAIL {label}: out.json differs between the card and the CPU")
    print(f"{label}: out.json byte-identical (card {outs['cuda'][1]:.3f} s, "
          f"cpu {outs['cpu'][1]:.3f} s)", flush=True)
    return os.path.join(tmp, f"{tag}_cuda.json")


def profiled(tag: str, src: str, tmp: str, extra=()):
    """One `sketch` run under torch.profiler: the device's busy share, the
    operators with the most device time and each kernel's time a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with captured_stdout():  # --stream documents, not needed here
            t_prof, _ = sketch_cli(src, os.path.join(tmp, tag), "cuda",
                                   os.path.join(tmp, f"{tag}.log"), extra)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(f"{tag}, profiled: wall {t_prof:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / t_prof:.1f}% of wall; idle {100 - 100 * busy / t_prof:.1f}%)",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                "minimizer_window_kernel" in e.key or "jump_kernel" in e.key):
            print(f"{tag} profiled kernel {e.key}: {e.count} launches, "
                  f"{e.self_device_time_total / e.count:.1f} us a launch", flush=True)
    return events


def profile_phase(fq: str, tmp: str) -> None:
    """Warm passes over fq: parse alone, `sketch`, and `sketch` profiled."""
    from hulk_tpu_torch.stream.fastq import batch_reads_native

    t0 = time.perf_counter()
    n = sum(int((b.lengths > 0).sum())
            for b in batch_reads_native([fq], batch_size=16384, raw=True))
    t_parse = time.perf_counter() - t0
    print(f"parse alone: {n} reads in {t_parse:.3f} s = {n / t_parse:.0f} reads/s", flush=True)
    t_run, _ = sketch_cli(fq, os.path.join(tmp, "warm"), "cuda", os.path.join(tmp, "warm.log"))
    print(f"sketch, warm: {t_run:.3f} s = {READS / t_run:.0f} reads/s", flush=True)
    events = profiled("sketch", fq, tmp)
    if any("index_add" in e.key for e in events):
        raise SystemExit("FAIL profile: index_add_ ran on the main path")


def head_records(src: str, dst: str, n: int, marker: bytes) -> None:
    """The first n records of a FASTQ.gz (4 lines each) or a FASTA file."""
    if src.endswith(".gz"):
        with gzip.open(src, "rb") as a, gzip.open(dst, "wb", compresslevel=1) as b:
            b.writelines(itertools.islice(a, 4 * n))
        return
    with open(src, "rb") as fh:
        data = fh.read()
    cut, pos = len(data), -1
    for _ in range(n + 1):
        pos = data.find(marker, pos + 1)
        if pos < 0:
            break
        cut = pos
    with open(dst, "wb") as fh:
        fh.write(data[:cut] if pos >= 0 else data)


def long_read_split(src: str) -> None:
    """Host seconds of the long-read path over the long records of src:
    the blockwise scan on the card (ops/longread.py, copies and np.unique
    included) and the host spectrum's binning of its values."""
    import torch

    from hulk_tpu_torch.ops.longread import long_read_minimizers
    from hulk_tpu_torch.sketch.spectrum import KmerSpectrum
    from hulk_tpu_torch.stream.fastq import LongRead, batch_reads_native

    spectrum = KmerSpectrum(21 ** 4)
    t_scan = t_bin = 0.0
    n = n_vals = 0
    for item in batch_reads_native([src], batch_size=16384, fasta=True, raw=True):
        if not isinstance(item, LongRead):
            continue
        t0 = time.perf_counter()
        flat = long_read_minimizers(item.codes, k=21, w=9, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        spectrum.add_hashes(flat)
        t_scan, t_bin = t_scan + t1 - t0, t_bin + time.perf_counter() - t1
        n, n_vals = n + 1, n_vals + flat.size
    print(f"long-read path, {n} long records ({n_vals} distinct values): blockwise scan "
          f"{1e3 * t_scan / max(n, 1):.2f} ms a record, host spectrum binning "
          f"{1e3 * t_bin / max(n, 1):.2f} ms a record", flush=True)


def expected_long_launches(lengths, k: int, w: int) -> tuple[int, int]:
    """(u8 launches, cont launches) of ops/longread.py over contigs of these
    lengths: block 0 of each read of the top length bucket's length or more
    (the native parser's max_read_len), and one cont launch a group of
    DEFAULT_GROUP continuation blocks."""
    from hulk_tpu_torch.ops.longread import DEFAULT_BLOCK, DEFAULT_GROUP
    from hulk_tpu_torch.stream.fastq import DEFAULT_LENGTH_BUCKETS

    H, S = w + k - 1, DEFAULT_BLOCK
    long_ = [int(x) for x in lengths if x >= DEFAULT_LENGTH_BUCKETS[-1]]
    groups = sum(-(-len(range(S - H, L - H, S - H)) // DEFAULT_GROUP) for L in long_)
    return len(long_), groups


@contextlib.contextmanager
def captured_stdout():
    """Collect what is written to sys.stdout (--stream's JSON) as bytes."""
    buf = io.BytesIO()
    out, sys.stdout = sys.stdout, io.TextIOWrapper(buf)
    try:
        yield buf
    finally:
        sys.stdout.flush()
        sys.stdout.detach()
        sys.stdout = out


def json_docs(data: bytes) -> list:
    """The JSON documents of a --stream stdout, one after another."""
    dec, text, pos, docs = json.JSONDecoder(), data.decode(), 0, []
    while pos < len(text):
        doc, pos = dec.raw_decode(text, pos)
        docs.append(doc)
        pos += 1
    return docs


def profiled_device_ms(fn, reps: int = 5, tag: str = "") -> float:
    """Device milliseconds a call of fn (plain PyTorch, many launches), by
    torch.profiler: the card's kernel and copy time over reps calls, after
    one warm-up, divided by reps; with a tag, the operators that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    if tag:
        print(f"{tag}, {reps} calls profiled:", flush=True)
        print(events.table(sort_by="self_device_time_total", row_limit=8), flush=True)
    return device_seconds(events) * 1e3 / reps


def device_seconds(events) -> float:
    import torch

    return sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6


def reset_flush_stats() -> None:
    from hulk_tpu_torch.ops import distance
    from hulk_tpu_torch.stream import pipeline

    pipeline.flush_stats.update(device_flushes=0, margin_fallbacks=0, flush_waits=[])
    distance.recheck_stats["cells"] = 0


def check_launches(tag: str, counts: dict, reads: int) -> int:
    """The main path's two entries once per batch, and nothing else: the
    packed minimizer and the fused binning pass the same number of times,
    at least one batch per 16,384 reads. Returns the batch count."""
    n = counts["minimizer_window_packed"]
    if (n < -(-reads // 16384) or counts["bin_scatter_keys"] != n
            or sum(counts.values()) != 2 * n):
        raise SystemExit(f"FAIL {tag}: launches {counts} for {reads} reads")
    return n


def generate_files(tmp: str, first: str) -> list[str]:
    """Phase 8's ten FASTQ files of 1M reads: phase 3's file, then seeds 1-9
    generated in parallel processes (spawned, so that no child inherits the
    CUDA context), all joined before this returns."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from hulk_tpu_torch.synth import generate

    paths = [os.path.join(tmp, f"part{i}.fq.gz") for i in range(1, 10)]
    with ProcessPoolExecutor(max_workers=min(9, os.cpu_count() or 1),
                             mp_context=mp.get_context("spawn")) as ex:
        list(ex.map(generate, paths, [READS] * 9, [150] * 9, range(1, 10)))
    return [first, *paths]


def flush_stage_times(fq: str) -> dict:
    """One interval's flush, alone, on the histogram of fq's 1M reads: the
    device candidate stage's device time (profiler) beside its bound, the
    device flush's wall time (stage, copy back and host recheck), and the
    exact host flush's wall time (native.flush_exact_native) without and
    with drift, each on a fresh sketch, median of 3."""
    import numpy as np
    import torch

    from hulk_tpu_torch.hashes.cws import get_cws_tables
    from hulk_tpu_torch.parallel import mesh
    from hulk_tpu_torch.sketch.histosketch import HistoSketch
    from hulk_tpu_torch.stream.fastq import batch_reads_native
    from hulk_tpu_torch.stream.pipeline import SketchConfig, _DeviceFlusher, _DeviceStream

    cfg = SketchConfig(kmer_size=21, window_size=9, sketch_size=42, device="cuda")
    dev = _DeviceStream(cfg, NBINS)
    for b in batch_reads_native([fq], batch_size=cfg.resolved_batch_size(), raw=True):
        dev.feed(b)
    hist = dev.take_hist()
    tables = get_cws_tables(42, NBINS)
    flusher = _DeviceFlusher(HistoSketch(21, 42, NBINS, 1.0, tables=tables), NBINS, dev.device)
    stage_ms = profiled_device_ms(lambda: mesh.device_flush_candidates(
        hist, flusher.row_bins, flusher.cms, *flusher.tables), tag="device flush candidate stage")
    depth, width = flusher.cms.shape
    used = int((hist != 0).sum())
    # bytes: histogram, row table, tables read once, CMS read and written;
    # operations: about 6 FP64 a (slot, bin) (subtract, exp, 2 multiplies,
    # divide, compare) and 4 a (row, bin) of the CMS scan
    nbytes = 4 * NBINS + 8 * depth * NBINS + 3 * 8 * 42 * NBINS + 2 * 8 * depth * width
    stage_bound = bound(nbytes, 6 * 42 * NBINS + 4 * depth * NBINS, FP64_OPS_PER_S)

    def wall(fn) -> float:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    def device_flush():
        f = _DeviceFlusher(HistoSketch(21, 42, NBINS, 1.0, tables=tables), NBINS, dev.device)
        t0 = time.perf_counter()
        f.flush_from(hist)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    h = hist.cpu().numpy().astype(np.float64)
    ids = np.nonzero(h)[0].astype(np.int64)
    host = {}
    for decay in (1.0, 0.9):
        def one(decay=decay):
            HistoSketch(21, 42, NBINS, decay, tables=tables).add_elements(ids, h[ids])
        host[decay] = wall(one)
    dev_wall = sorted(device_flush() for _ in range(3))[1]
    print(f"one interval's flush (1M reads, {used} bins used of {NBINS}, s=42): device "
          f"candidate stage {stage_ms:.4f} ms device time (bound {stage_bound[0]:.4f} ms by "
          f"{stage_bound[1]}), device flush {1e3 * dev_wall:.3f} ms wall; host flush alone "
          f"(native) {1e3 * host[1.0]:.3f} ms without drift, {1e3 * host[0.9]:.3f} ms with "
          f"-x 0.9", flush=True)
    return dict(name="device_flush_candidates", source="hulk_tpu_torch/parallel/mesh.py",
                counterpart="hulk_tpu/parallel/mesh.py:330", ms=stage_ms,
                bound_ms=stage_bound[0], bound_by=stage_bound[1],
                shape=f"nbins={NBINS} s=42 depth={depth} width={width}")


def interval_phase(fq: str, small: str, tmp: str, path_launches: dict) -> list:
    """Phase 8 (cell d): BASELINE config 4's stream, 10M reads in ten files,
    -i 1000000 -x 0.9, and the interval machinery around it."""
    from hulk_tpu_torch.stream import pipeline
    from hulk_tpu_torch.stream.fastq import batch_reads_native

    t0 = time.perf_counter()
    files = generate_files(tmp, fq)
    n_reads = READS * len(files)
    print(f"generated {len(files) - 1} more files of {READS} reads in parallel: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    src = ",".join(files)
    every = ("-i", str(READS))

    # (8a) the stream with --stream and a checkpoint at every interval
    reset_flush_stats()
    seconds, _, counts = drive("8a", src, tmp, (*every, "-x", "0.9", "--stream",
                                               "--checkpoint", os.path.join(tmp, "ck.npz")))
    path_launches["8a"] = counts
    check_launches("8a", counts, n_reads)
    with open(os.path.join(tmp, "8a.stdout"), "rb") as fh:
        stdout = fh.read()
    docs = json_docs(stdout)
    if len(docs) != len(files) + 1:
        raise SystemExit(f"FAIL 8a: {len(docs)} JSON documents on stdout, expected "
                         f"{len(files)} intervals and the final sketch")
    with open(os.path.join(tmp, "8a.json"), "rb") as fh:
        want = fh.read()
    if not stdout.endswith(want + b"\n"):
        raise SystemExit("FAIL 8a: the final --stream document is not out.json")
    check_sketch(os.path.join(tmp, "8a.json"), 42)
    waits = pipeline.flush_stats["flush_waits"]
    t_8a = seconds
    print(f"8a: {n_reads} reads, -i {READS} -x 0.9 --stream --checkpoint: {seconds:.3f} s = "
          f"{n_reads / seconds:.0f} reads/s; {len(docs) - 1} interval documents + the final; "
          f"waits on the flush worker {sum(waits):.3f} s in all, per wait "
          f"{[round(x, 4) for x in waits]}", flush=True)
    profiled("8a_files_0_1", ",".join(files[:2]), tmp,
             (*every, "-x", "0.9", "--stream", "--checkpoint", os.path.join(tmp, "ck_prof.npz")))

    # (8b) the host flush against --deviceFlush, no drift
    reset_flush_stats()
    t_host, _, counts = drive("8b_host", src, tmp, every)
    path_launches["8b_host"] = counts
    check_launches("8b host", counts, n_reads)
    t_dev, _, counts = drive("8b_device", src, tmp, (*every, "--deviceFlush"))
    path_launches["8b_device"] = counts
    check_launches("8b device", counts, n_reads)
    stats = dict(pipeline.flush_stats)
    for name in ("8b_host", "8b_device"):
        with open(os.path.join(tmp, f"{name}.json"), "rb") as fh:
            stats[name] = fh.read()
    if stats["8b_host"] != stats["8b_device"]:
        raise SystemExit("FAIL 8b: --deviceFlush out.json differs from the host flush's")
    if stats["margin_fallbacks"] or stats["device_flushes"] != len(files):
        raise SystemExit(f"FAIL 8b: {stats['device_flushes']} device flushes, "
                         f"{stats['margin_fallbacks']} margin fallbacks")
    print(f"8b: host flush {t_host:.3f} s = {n_reads / t_host:.0f} reads/s; --deviceFlush "
          f"{t_dev:.3f} s = {n_reads / t_dev:.0f} reads/s; out.json byte-identical; "
          f"{stats['device_flushes']} device flushes, 0 margin fallbacks", flush=True)
    stage = flush_stage_times(fq)
    stage["launches"] = stats["device_flushes"]

    # (8c) a run killed after file 4, resumed over all ten by seeking
    ck = os.path.join(tmp, "ck_cut.npz")
    flags = (*every, "-x", "0.9")
    _, _, counts_cut = drive("8c_cut", ",".join(files[:5]), tmp, (*flags, "--checkpoint", ck))
    t_res, _, counts = drive("8c_resume", src, tmp, (*flags, "--resume", ck))
    t0 = time.perf_counter()  # the seek alone: skipping file 4's records
    next(iter(batch_reads_native(files, batch_size=16384, start_file=4, skip_reads=READS,
                                 raw=True)))
    t_seek = time.perf_counter() - t0
    path_launches["8c_cut"], path_launches["8c_resume"] = counts_cut, counts
    with open(os.path.join(tmp, "8c_resume.json"), "rb") as fh:
        if fh.read() != want:
            raise SystemExit("FAIL 8c: the resumed run's out.json differs from 8a's")
    with open(os.path.join(tmp, "8c_resume.log")) as fh:
        if f"seek resume: file 4, skipping {READS} records" not in fh.read():
            raise SystemExit("FAIL 8c: the resumed run did not seek to file 4")
    if {k: counts_cut[k] + counts[k] for k in counts} != path_launches["8a"]:
        raise SystemExit(f"FAIL 8c: launches {counts_cut} + {counts}, 8a {path_launches['8a']}")
    print(f"8c: resumed from file 4 (seek, {READS} records skipped): {t_res:.3f} s for the "
          f"last {n_reads // 2} reads, against 8a's {t_8a:.3f} s for all; out.json "
          f"byte-identical to 8a's; the seek to the first batch after it alone "
          f"{t_seek:.3f} s", flush=True)

    # (8d) card against CPU on the first 50,000 reads
    for label, card, cpu in (
            ("--stream --streamAll --kmv --khf --hmh",
             ("-i", "10000", "-x", "0.9", "--stream", "--streamAll", "--kmv", "--khf", "--hmh"),
             None),
            ("--deviceFlush on the card, host flush on the CPU",
             ("-i", "10000", "--deviceFlush"), ("-i", "10000"))):
        got = {}
        for device, extra in (("cuda", card), ("cpu", cpu or card)):
            out_path = os.path.join(tmp, f"8d_{device}")
            with captured_stdout() as out:
                sketch_cli(small, out_path, device, out_path + ".log", extra)
            with open(out_path + ".json", "rb") as fh:
                got[device] = (out.getvalue(), fh.read())
        if got["cuda"] != got["cpu"]:
            raise SystemExit(f"FAIL 8d {label}: stdout or out.json differs card vs CPU")
        print(f"8d {label}, first {SUBSET_READS} reads: stdout ({len(got['cuda'][0])} bytes) "
              f"and out.json byte-identical card vs CPU", flush=True)
    return [stage]


def matrix_bound(n: int, s: int, weighted: bool) -> tuple[float, str]:
    """The smash matrix's least time: the f64 mins (and |weights| and row
    sums) read once and the [n, n] result written once; one FP64 compare a
    (row, column, slot), plus one add where weighted."""
    nbytes = 8 * n * s * (2 if weighted else 1) + 8 * n + 8 * n * n
    return bound(nbytes, n * n * s * (2 if weighted else 1), FP64_OPS_PER_S)


def smash_phase(tmp: str) -> list:
    """Phase 9 (cell e): all-against-all smash of 1,024 synthetic sketches,
    card against CPU; the matrix alone at 4,096."""
    import csv

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hulk_tpu_torch import cli
    from hulk_tpu_torch.ops import distance
    from hulk_tpu_torch.synth import sketch_jsons

    n, s = 1024, 42
    pile = os.path.join(tmp, "sketches")
    os.makedirs(pile)
    t0 = time.perf_counter()
    names = sketch_jsons(pile, n, k=21, s=s, families=16, seed=SEED)
    print(f"generated {n} sketch JSONs (histosketch, KMV, KHF; 16 families): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    stages = []
    for metric in ("weightedjaccard", "jaccard"):
        csvs = {}
        for device in ("cuda", "cpu"):
            reset_flush_stats()
            out = os.path.join(tmp, f"smash_{metric}_{device}")
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                rc = cli.main(["smash", "-d", pile, "-m", metric, "-o", out, "--device", device,
                               "--log", out + ".log"])
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"FAIL smash -m {metric} on {device}: exit code {rc}")
            with open(out + ".hulk-matrix.csv", "rb") as fh:
                csvs[device] = fh.read()
            if device == "cuda":
                dev_ms = device_seconds(prof.key_averages()) * 1e3
                rechecked = distance.recheck_stats["cells"]
                t_card = seconds
        if csvs["cuda"] != csvs["cpu"]:
            raise SystemExit(f"FAIL smash -m {metric}: the CSV differs card vs CPU")
        rows = list(csv.reader(io.StringIO(csvs["cuda"].decode())))
        cells = np.array(rows[1:], dtype=np.float64)
        if cells.shape != (n, n) or not (np.diag(cells) == 100).all():
            raise SystemExit(f"FAIL smash -m {metric}: matrix {cells.shape}, diagonal not 100")
        # the first 40 sketches through the host path (get_distance), cell
        # for cell against the device's block of them
        sub = os.path.join(tmp, f"sub_{metric}")
        os.makedirs(sub)
        for f in names[:40]:
            shutil.copy(f, sub)
        cli.main(["smash", "-d", sub, "-m", metric, "-o", sub + "_host", "--log", sub + ".log"])
        with open(sub + "_host.hulk-matrix.csv") as fh:
            host = list(csv.reader(fh))[1:]
        if [r[:40] for r in rows[1:41]] != host:
            raise SystemExit(f"FAIL smash -m {metric}: the device's cells differ from the "
                             f"host path's on the first 40 sketches")
        spread = np.percentile(cells[~np.eye(n, dtype=bool)], [5, 50, 95])
        print(f"smash -m {metric}, {n} sketches: CSV byte-identical card vs CPU, first 40 "
              f"equal to the host path; card {t_card:.3f} s wall, matrix device time "
              f"{dev_ms:.3f} ms, {rechecked} cells rechecked on the host; similarity "
              f"percentiles 5/50/95 {spread.tolist()}", flush=True)

    rng = np.random.default_rng(SEED)
    big = 4096
    mins = rng.integers(0, NBINS, (big, s)).astype(np.uint64)
    mins[rng.random((big, s)) < 0.5] = 7  # half the slots match somewhere
    weights = rng.exponential(1.0, (big, s))
    for name, weighted, fn in (
            ("smash_matrix_weightedjaccard", True,
             lambda: distance.pairwise_weighted_jaccard_dist(mins, weights, device="cuda")),
            ("smash_matrix_jaccard", False,
             lambda: distance.pairwise_jaccard_sim(mins, device="cuda"))):
        ms = profiled_device_ms(fn, reps=2)
        b = matrix_bound(big, s, weighted)
        print(f"{name} alone, {big} sketches x s={s}: device {ms:.3f} ms, bound {b[0]:.4f} ms "
              f"({b[1]}), {100 * b[0] / ms:.2f}% of bound", flush=True)
        stages.append(dict(name=name, source="hulk_tpu_torch/ops/distance.py",
                           counterpart="hulk_tpu/ops/distance.py:39", ms=ms, bound_ms=b[0],
                           bound_by=b[1], launches=-(-big // 512) * -(-big // 4096),
                           shape=f"N={big} s={s}"))

    a, b2 = names[0], names[1]
    for sub_args in (["print", "-f", a, "-f", b2], ["distance", "-f", a, "-f", b2, "-m",
                                                    "weightedjaccard"]):
        outs = []
        for device in ("cuda", "cpu"):
            with captured_stdout() as out:
                if cli.main([*sub_args, "--device", device]) != 0:
                    raise SystemExit(f"FAIL {sub_args[0]}: non-zero exit")
            outs.append(out.getvalue())
        if outs[0] != outs[1] or not outs[0]:
            raise SystemExit(f"FAIL {sub_args[0]}: output differs between devices")
        print(f"{sub_args[0]} on two sketches: {outs[0][:60]!r}... same with --device cpu",
              flush=True)
    return stages


def lsh_bound(n: int, q: int, s: int) -> tuple[float, str]:
    """The LSH ranking's least time: the int64 index read once and the
    [q, n] u16 counts written once; one INT32 compare and one add a (query,
    row, slot)."""
    return bound(8 * n * s + 2 * q * n, 2 * q * n * s, INT32_OPS_PER_S)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(argv, n: int, tag: str, tmp: str) -> float:
    """n processes, rank r running `python argv(r)`, as one gloo group on
    this machine (HULK_* environment, a free port), each given
    RANK_TIMEOUT; all are killed if one is late. Fails unless every rank
    exits 0. Returns the wall seconds."""
    env = dict(os.environ, HULK_COORDINATOR=f"127.0.0.1:{free_port()}",
               HULK_NUM_PROCS=str(n), PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(n):
            with open(os.path.join(tmp, f"{tag}.rank{r}.out"), "wb") as out:
                procs.append(subprocess.Popen([sys.executable, *argv(r)], cwd=tmp,
                                              env=dict(env, HULK_PROC_ID=str(r)),
                                              stdin=subprocess.DEVNULL, stdout=out,
                                              stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"{tag}.rank{r}.out"), errors="replace") as fh:
                tail = fh.read()[-3000:]
            raise SystemExit(f"FAIL {tag}: rank {r} exit code {p.returncode}:\n{tail}")
    return seconds


# one rank of phase 10c: BASELINE config 5's corpus, this rank's stripe
# p::n indexed, the queries searched, the top-K merged across the ranks
LSH_RANK = r"""
import json, sys, time
import numpy as np
from hulk_tpu_torch.index.lshforest import LSHForest
from hulk_tpu_torch.parallel import distributed as dist
from hulk_tpu_torch.parallel.lsh import multiprocess_lsh_search
from hulk_tpu_torch.synth import lsh_corpus

out, n, nq, s, t, topk, seed = sys.argv[1], *map(int, sys.argv[2:5]), float(sys.argv[5]), \
    int(sys.argv[6]), int(sys.argv[7])
if not dist.init_distributed():
    raise SystemExit("no process group")
mins, queries, _ = lsh_corpus(n, nq, s, seed=seed)
stripe = np.arange(n)[dist.rank()::dist.world_size()]
t0 = time.perf_counter()
forest = LSHForest(kmer_size=21, sketch_size=s, jaccard_thresh=t)
forest.add_batch([f"s{i}" for i in stripe], mins[stripe])
t1 = time.perf_counter()
hits = multiprocess_lsh_search(forest, queries, stripe.astype(np.int64), thresh=t, topk=topk)
t2 = time.perf_counter()
with open(f"{out}.{dist.rank()}.json", "w") as fh:
    json.dump({"build_s": t1 - t0, "search_s": t2 - t1, "rows": int(stripe.size),
               "hits": hits if dist.rank() == 0 else None}, fh)
dist.shutdown()
"""


def lsh_phase(tmp: str, dev) -> list:
    """Phase 10 (cell f): BASELINE config 5 at its own size (10a), the
    dense-candidate branch (10b), two ranks (10c), the `index` CLI over
    phase 9's sketches (10d) and phase 9's weighted smash in two ranks
    (10e)."""
    import numpy as np
    import torch

    from hulk_tpu_torch import cli
    from hulk_tpu_torch.index.lshforest import LSHForest
    from hulk_tpu_torch.parallel import lsh
    from hulk_tpu_torch.synth import lsh_corpus

    n, nq, s, t = LSH
    t0 = time.perf_counter()
    mins, queries, qidx = lsh_corpus(n, nq, s, seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    forest = LSHForest(kmer_size=21, sketch_size=s, jaccard_thresh=t)
    forest.add_batch([f"s{i}" for i in range(n)], mins)
    t_build = time.perf_counter() - t0
    print(f"10a corpus {n} x s={s}, {nq} queries: generated {t_gen:.3f} s, forest built "
          f"{t_build:.3f} s (bands={forest.n_bands} rows={forest.band_rows})", flush=True)

    # 10a: the search on the card's mesh, and the brute force beside it
    lsh.search_stats["device_ranked"] = 0
    t0 = time.perf_counter()
    results = lsh.sharded_lsh_search([dev], forest, queries, t)
    t_search = time.perf_counter() - t0
    engaged = lsh.search_stats["device_ranked"]
    n_cand = sum(forest.candidates(q).size for q in queries)
    t0 = time.perf_counter()
    sims, _ = lsh.sharded_sims([dev], forest, queries)
    t_sims = time.perf_counter() - t0
    plain, _ = lsh.sharded_sims([torch.device("cpu")], forest, queries[:LSH_SUBSET])
    if not np.array_equal(sims[:LSH_SUBSET], plain):
        raise SystemExit(f"FAIL 10a: the card's similarities differ from the CPU's on the "
                         f"first {LSH_SUBSET} queries")
    n_truth = n_hit = 0
    for qi in range(nq):
        truth = set(np.flatnonzero(sims[qi] >= t).tolist())
        got = {int(name[1:]) for name, _ in results[qi]}
        if not got <= truth or any(v != sims[qi, int(name[1:])] for name, v in results[qi]):
            raise SystemExit(f"FAIL 10a: query {qi} returned a hit the brute force does not "
                             f"have, or another similarity")
        n_truth += len(truth)
        n_hit += len(got & truth)
    recall = n_hit / n_truth
    if recall < 0.95 or n_truth < nq or (sims[np.arange(nq), qidx] < t).any():
        raise SystemExit(f"FAIL 10a: recall {recall:.4f} ({n_hit} of {n_truth})")
    print(f"10a search t={t}: {t_search:.3f} s = {nq / t_search:.1f} queries/s "
          f"({n_cand} candidates, {100 * n_cand / (nq * n):.4f}% of Q*N; device ranking "
          f"engaged {engaged} times); brute force on {dev} {t_sims:.3f} s wall; first {LSH_SUBSET} queries equal to the CPU's; recall "
          f"{recall:.4f} ({n_hit} of {n_truth}), precision 1.0", flush=True)

    stripes, _ = lsh.shard_index_mins([dev], forest.mins_matrix)
    q_dev = torch.from_numpy(queries.astype(np.int64)).to(dev)
    ms = profiled_device_ms(lambda: lsh.rank_stripe(q_dev, stripes[0]), reps=3,
                            tag="10a LSH ranking")
    b = lsh_bound(n, nq, s)
    steps = -(-stripes[0].shape[0] // lsh._CHUNK) * -(-nq // lsh._QUERY_BLOCK) * s
    print(f"10a LSH ranking alone, Q={nq} N={n} s={s} on the card: device {ms:.3f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / ms:.2f}% of bound; "
          f"{steps} compare-and-add steps", flush=True)
    stage = dict(name="lsh_ranking", source="hulk_tpu_torch/parallel/lsh.py",
                 counterpart="hulk_tpu/parallel/lsh.py:47", ms=ms, bound_ms=b[0],
                 bound_by=b[1], launches=steps, shape=f"Q={nq} N={n} s={s}")
    del stripes, q_dev, sims, plain

    # 10b: candidates past _DEVICE_RANK_DENSITY of Q*N: the card ranks
    dn, dq, vr, dt = LSH_DENSE
    rng = np.random.default_rng(SEED)
    dmins = rng.integers(0, vr, (dn, s), dtype=np.uint64)
    dqueries = dmins[rng.choice(dn, dq, replace=False)]
    dforest = LSHForest(kmer_size=21, sketch_size=s, jaccard_thresh=dt)
    dforest.add_batch([f"d{i}" for i in range(dn)], dmins)
    lsh.search_stats["device_ranked"] = 0
    t0 = time.perf_counter()
    on_card = lsh.sharded_lsh_search([dev], dforest, dqueries, dt)
    t_card = time.perf_counter() - t0
    if lsh.search_stats["device_ranked"] != 1:
        raise SystemExit("FAIL 10b: the device ranking did not engage")
    t0 = time.perf_counter()
    on_host = lsh.sharded_lsh_search(None, dforest, dqueries, dt)
    t_host = time.perf_counter() - t0
    if on_card != on_host:
        raise SystemExit("FAIL 10b: the card's hit lists differ from the host's")
    dens = sum(dforest.candidates(q).size for q in dqueries) / (dq * dn)
    print(f"10b dense candidates ({dn} rows of mins in [0, {vr}), {dq} queries, t={dt}, "
          f"candidates {100 * dens:.1f}% of Q*N): device branch {t_card:.3f} s, host branch "
          f"{t_host:.3f} s, {sum(map(len, on_card))} hits, the same lists", flush=True)
    del dforest, on_card, on_host

    # 10c: two ranks, each indexing the stripe p::2 of 10a's corpus
    out = os.path.join(tmp, "lsh2")
    script = os.path.join(tmp, "lsh_rank.py")
    with open(script, "w") as fh:
        fh.write(LSH_RANK)
    wall = run_ranks(lambda r: [script, out, str(n), str(nq), str(s), str(t),
                                str(LSH_TOPK), str(SEED)], 2, "10c", tmp)
    ranks = []
    for r in range(2):
        with open(f"{out}.{r}.json") as fh:
            ranks.append(json.load(fh))
    t0 = time.perf_counter()
    one = lsh.multiprocess_lsh_search(forest, queries, np.arange(n, dtype=np.int64), t,
                                      topk=LSH_TOPK)
    t_one = time.perf_counter() - t0
    if ranks[0]["hits"] != json.loads(json.dumps(one)):
        raise SystemExit("FAIL 10c: the two ranks' merged hits differ from one process's")
    print(f"10c two ranks (gloo, stripes p::2, top {LSH_TOPK}): wall {wall:.3f} s with start-up; "
          f"in the ranks build {ranks[0]['build_s']:.3f}/{ranks[1]['build_s']:.3f} s, search "
          f"{ranks[0]['search_s']:.3f}/{ranks[1]['search_s']:.3f} s "
          f"({nq / max(r['search_s'] for r in ranks):.1f} queries/s); one process "
          f"{t_one:.3f} s; merged hits equal", flush=True)
    del forest, one, ranks

    # 10d: `index` over phase 9's sketches, on the card and with --device cpu
    pile = os.path.join(tmp, "sketches")
    got = {}
    for device in (dev.type, "cpu"):
        idx = os.path.join(tmp, f"lsh_{device}.idx")
        log = os.path.join(tmp, f"index_{device}.log")
        t0 = time.perf_counter()
        if cli.main(["index", "-r", "create", "-n", idx, "-d", pile, "-s", str(s), "-j", "0.9",
                     "--device", device, "--log", log]) != 0:
            raise SystemExit(f"FAIL 10d: index create on {device}")
        with captured_stdout() as hits:
            if cli.main(["index", "-r", "search", "-n", idx, "-d", pile, "-s", str(s),
                         "-j", "0.9", "--device", device, "--log", log]) != 0:
                raise SystemExit(f"FAIL 10d: index search on {device}")
        with open(idx, "rb") as fh, open(log) as lf:
            got[device] = (fh.read(), hits.getvalue(), time.perf_counter() - t0, lf.read())
    card = got[dev.type]
    if card[:2] != got["cpu"][:2]:
        raise SystemExit("FAIL 10d: the index or the search stdout differs card vs CPU")
    if f"search: on the host (one device, {dev})" not in card[3]:
        raise SystemExit("FAIL 10d: the card's run did not log the host search of one card")
    n_lines = card[1].count(b"\n")
    if n_lines < 1024:
        raise SystemExit(f"FAIL 10d: {n_lines} hits for 1,024 queries of the index itself")
    print(f"10d index -r create/search -s {s} -j 0.9 over 1,024 sketches: card "
          f"{card[2]:.3f} s, cpu {got['cpu'][2]:.3f} s; index "
          f"({len(card[0])} bytes) and stdout ({n_lines} hits) byte-identical; one card, "
          f"so the search ran on the host (hulk_tpu's one-device path)", flush=True)

    # 10e: phase 9's weighted smash in two ranks on the one card
    logs = [os.path.join(tmp, f"smash2.rank{r}.log") for r in range(2)]
    wall = run_ranks(lambda r: ["-m", "hulk_tpu_torch", "smash", "-d", pile, "-m",
                                "weightedjaccard", "-o", os.path.join(tmp, "smash2"),
                                "--device", dev.type, "--log", logs[r]], 2, "10e", tmp)
    with open(os.path.join(tmp, "smash2.hulk-matrix.csv"), "rb") as a, \
            open(os.path.join(tmp, f"smash_weightedjaccard_{dev.type}.hulk-matrix.csv"),
                 "rb") as b2:
        if a.read() != b2.read():
            raise SystemExit("FAIL 10e: the two ranks' CSV differs from phase 9's")
    for r, log in enumerate(logs):
        with open(log) as fh:
            if f"process {r}/2: 512 of 1024 sketches, on {dev}" not in fh.read():
                raise SystemExit(f"FAIL 10e: rank {r} did not split the sketches")
    print(f"10e smash -m weightedjaccard, 1,024 sketches, two ranks on the one card: "
          f"{wall:.3f} s wall with start-up; CSV byte-identical to phase 9's one process",
          flush=True)
    return [stage]


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "hulk_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only", file=sys.stderr)
        return 2
    from hulk_tpu_torch import native
    from hulk_tpu_torch.hashes.cws import get_cws_tables
    from hulk_tpu_torch.ops import _build
    from hulk_tpu_torch.synth import contig_lengths, generate, generate_fasta

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="hulk_chip_smoke_")
    os.environ.setdefault("HULK_TPU_TORCH_CACHE", os.path.join(tmp, "cache"))
    path_launches: dict[str, dict[str, int]] = {}
    try:
        with phase("1 device"):
            print(f"device: {kind} x{count}; torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}", flush=True)
            smi = nvidia_smi()
            print(f"nvidia-smi: {smi}", flush=True)
            _build.load()
            if _build.build_report is None:
                print("build kernels (nvcc): library was current", flush=True)
            else:
                seconds, ptxas = _build.build_report
                print(f"build kernels (nvcc): {seconds:.2f} s", flush=True)
                for line in ptxas.splitlines():
                    print(f"  ptxas: {line}", flush=True)
            t0 = time.perf_counter()
            if not native.available():
                raise SystemExit("FAIL native host runtime did not build")
            print(f"build native (g++): {time.perf_counter() - t0:.2f} s", flush=True)

        with phase("2 kernels"):
            rows = kernel_phase(np.random.default_rng(SEED), dev)

        fq = os.path.join(tmp, "reads.fq.gz")
        with phase("3 end to end"):
            t0 = time.perf_counter()
            generate(fq, READS, read_len=150, seed=SEED)
            print(f"generated {READS} reads: {time.perf_counter() - t0:.2f} s", flush=True)
            t0 = time.perf_counter()
            get_cws_tables(42, 21 ** 4)
            print(f"CWS tables s=42 d={21 ** 4}: {time.perf_counter() - t0:.2f} s", flush=True)
            seconds, n_min, counts = drive("full", fq, tmp)
            path_launches["3"] = counts
            check_sketch(os.path.join(tmp, "full.json"), 42)
            print(f"sketch {READS} reads on {kind}: {READS / seconds:.0f} reads/s", flush=True)
            # the main path's entries: the packed minimizer and the fused
            # binning pass, once per batch each
            batches = counts["minimizer_window_packed"]
            if (n_min <= 0 or batches <= 0 or counts["bin_scatter_keys"] != batches
                    or sum(counts.values()) != 2 * batches):
                raise SystemExit(f"FAIL main path: minimizers {n_min}, launches {counts}")

        with phase("3b profile"):
            profile_phase(fq, tmp)

        small = os.path.join(tmp, "first50k.fq.gz")
        with phase("4 equality"):
            head_records(fq, small, SUBSET_READS, b"@")
            check_sketch(card_vs_cpu(f"first {SUBSET_READS} reads", small, tmp), 42)

        with phase("5 sketches (a)"):
            flags = ("--kmv", "--khf", "--hmh")
            seconds, n_min, counts = drive("sketches", fq, tmp, flags)
            path_launches["5"] = counts
            check_sketch(os.path.join(tmp, "sketches.json"), 42,
                         algos=("histosketch", "kmv", "khf", "hyperminhash"))
            print(f"sketch --kmv --khf --hmh {READS} reads: {READS / seconds:.0f} reads/s",
                  flush=True)
            if (counts["minimizer_window_packed"] != batches
                    or counts["bin_scatter_keys"] != batches
                    or sum(counts.values()) != 2 * batches):
                raise SystemExit(f"FAIL sketches path: launches {counts}, {batches} batches")
            profiled("sketches", fq, tmp, flags)
            card_vs_cpu(f"sketches, first {SUBSET_READS} reads", small, tmp, flags)

        with phase("6 two-sort (b)"):
            flags = ("-k", "31", "-w", "9", "-s", "42")
            t0 = time.perf_counter()
            get_cws_tables(42, NBINS_K31)
            print(f"CWS tables s=42 d={NBINS_K31}: {time.perf_counter() - t0:.2f} s", flush=True)
            seconds, n_min, counts = drive("two_sort", fq, tmp, flags)
            path_launches["6"] = counts
            check_sketch(os.path.join(tmp, "two_sort.json"), 42, k=31)
            print(f"sketch -k 31 {READS} reads: {READS / seconds:.0f} reads/s", flush=True)
            n2 = counts["minimizer_window_packed"]
            if (n_min <= 0 or n2 < -(-READS // 2048) or counts["bin_scatter_values"] != n2
                    or sum(counts.values()) != 2 * n2):
                raise SystemExit(f"FAIL two-sort path: launches {counts}")
            profiled("two_sort", fq, tmp, flags)
            card_vs_cpu(f"two-sort, first {SUBSET_READS} reads", small, tmp, flags)

        with phase("7 FASTA (c)"):
            n_ctg, lo, hi = CONTIGS
            fa = os.path.join(tmp, "contigs.fa")
            t0 = time.perf_counter()
            generate_fasta(fa, n_ctg, lo=lo, hi=hi, seed=SEED)
            lengths = contig_lengths(np.random.default_rng(SEED), n_ctg, lo, hi)
            print(f"generated {n_ctg} contigs of {lo}-{hi} bases, {int(lengths.sum())} bases: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            flags = ("--fasta", "-w", "9")
            seconds, n_min, counts = drive("fasta", fa, tmp, flags)
            path_launches["7"] = counts
            check_sketch(os.path.join(tmp, "fasta.json"), 42)
            n_u8, n_cont = expected_long_launches(lengths, 21, 9)
            print(f"sketch --fasta: {lengths.sum() / seconds / 1e6:.3f} Mb/s; "
                  f"{n_u8} long contigs, {n_cont} block groups", flush=True)
            if (n_min <= 0 or counts["minimizer_window"] != n_u8
                    or counts["minimizer_window_cont"] != n_cont
                    or counts["minimizer_window_packed"] <= 0
                    or counts["bin_scatter_keys"] != counts["minimizer_window_packed"]
                    or counts["bin_scatter_values"] or counts["jump_hash"]):
                raise SystemExit(f"FAIL FASTA path: launches {counts}, expected u8 {n_u8}, "
                                 f"cont {n_cont}")
            sub = os.path.join(tmp, "first_contigs.fa")
            head_records(fa, sub, SUBSET_CONTIGS, b">")
            card_vs_cpu(f"FASTA, first {SUBSET_CONTIGS} contigs "
                        f"({int(lengths[:SUBSET_CONTIGS].sum())} bases)", sub, tmp, flags)
            profiled("fasta_subset", sub, tmp, flags)
            long_read_split(sub)

        with phase("8 intervals (d)"):
            stages = interval_phase(fq, small, tmp, path_launches)

        with phase("9 smash (e)"):
            stages += smash_phase(tmp)

        with phase("10 LSH (f)"):
            stages += lsh_phase(tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, r in rows.items():
        by_phase = {p: c[r["counter"]] for p, c in path_launches.items()}
        kernels.append(dict(r, launches=sum(by_phase.values()), launches_by_phase=by_phase))
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"device_stages": stages}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
