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
Then one JSON line of kernels (every entry, with its launches summed over
the driven runs of phases 3, 5, 6 and 7), the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Any failure ends the run with a
non-zero exit code and no result line. Nothing is written into the
repository except the gitignored kernel build directory; the inputs and
outputs live in a temporary directory that is removed at the end.
"""
from __future__ import annotations

import contextlib
import gzip
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
    to 0 just before, read just after. Returns (seconds, minimizers,
    counts)."""
    reset_launches()
    seconds, n_min = sketch_cli(src, os.path.join(tmp, tag), "cuda",
                                os.path.join(tmp, f"{tag}.log"), extra)
    counts = read_launches()
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, r in rows.items():
        by_phase = {p: c[r["counter"]] for p, c in path_launches.items()}
        kernels.append(dict(r, launches=sum(by_phase.values()), launches_by_phase=by_phase))
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
