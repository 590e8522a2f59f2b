#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hulk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: the card's name, count and power limit; build the CUDA kernels
     (one nvcc process per source, started together, and a link into one
     library) and the native host runtime (g++); print each build's seconds
     and ptxas's register/spill lines, and the seconds of the backend-stall
     watchdog's probe (16 elements to the card and back).
  2. kernels: each of the eight kernel entries (six C entries, the u8 one
     also in its cont form, the values one also in its dedup form) against
     its plain PyTorch version on the card, at the shapes the driven paths
     launch (with random pad past each read and rows of length 0 where the
     path pads) and on corner cases; all must be bit-equal. The long-read
     record scan runs on records of 65,536 and 200,000 bases with 1% N at
     k=21/w=9 and k=31/w=2, also at a cap of 65,536 (cont chunks), its
     sorted run heads against the plain version's; the dedup form with its
     count on a record's sorted run heads; the two-sort step's values entry
     on its whole SENT-tailed buffer with the device count. The jump loop's
     reciprocal seed checked over all 2^31 divisors against the bound its
     proof assumes, and the loop's boundary keys (adversarial, and quotients
     within 2^-20 of an integer) through all four jump entries; the
     iterations that took the loop's exact step (its counting form). Each
     entry's device time at the shape of its path (50 launches queued
     through its C entry, one event pair; hulk_jump_hash and the u8 entry at
     entry()'s [16384, 160] batch) beside its bound, the plain version's
     time (CUDA events around one call, median of 20 after 3 warm-ups), and
     the values entry's launch floor. Then the KMV, KHF and HMH updates'
     time a batch (plain PyTorch, CUDA events around one call), and the
     two-sort step's binning and sketch feed on the whole buffer against
     the live prefix after a count read.
  3. end to end: `sketch` through hulk_tpu_torch.cli.main on 1,000,000
     synthetic 150 bp reads (gzip FASTQ, seed 0) at k=21, w=9, s=42, with
     every entry's launch count set to 0 just before and read just after;
     the main path's two entries (packed minimizer, fused binning pass) must
     each have launched, once per batch.
  3b. profile: warm passes over the same file: the host parse alone (no
     device), `sketch` end to end, and `sketch` under torch.profiler for the
     device's busy share, the operators with the most device time and each
     kernel's device time a launch; index_add runs only in the flush's CMS
     update, once a row.
  4. equality: the first 50,000 of those reads sketched on the card and with
     --device cpu (the plain versions) must give byte-identical out.json.
  5. sketches: `sketch --kmv --khf --hmh` on the same reads (k=21, w=9,
     s=42): the packed minimizer and the fused binning pass once per batch
     (as many batches as phase 3), out.json holds four sketches; profiled
     once; the first 50,000 reads byte-identical on card and CPU.
  6. two-sort: `sketch -k 31 -w 9 -s 42` on the same reads (R = 2048,
     923,521 bins): the packed minimizer and the values binning entry once
     per batch, the fused binning pass never, and every group step under
     torch's sync debug mode "error" (no host sync a batch); profiled once;
     the first 50,000 reads byte-identical on card and CPU.
  7. FASTA: `sketch --fasta` (k=21, w=9, s=42) on 2,000 synthetic contigs
     of 1-200 kb (about 206 Mb, 60 columns, 1% N, seed 0): each contig of
     65,536 bases or more takes the long-read step, one record-scan launch
     and one dedup binning launch, and never the u8 or cont entries; the
     shorter contigs take the fused step; the first 40 contigs
     byte-identical on card and CPU at k=21 and at -k 31 --kmv --khf
     --hmh, profiled once, and their long records timed through the
     long-read step and through the blockwise path it replaced (scan and
     host spectrum binning), in turns, the two histograms equal.
  8. intervals (BASELINE config 4): ten gzip FASTQ files of 1M reads (phase
     3's and nine generated in parallel processes, seeds 1-9) as one -f
     list: (8a) `-i 1000000 -x 0.9 --stream --checkpoint`, reads/s, ten
     interval documents and the final one on stdout, the streaming
     thread's waits on the flush worker, and a profiled run over files 0-1;
     (8b) the same files without drift, and with --deviceFlush, which takes
     the same exact flush on the card: out.json byte-identical; (8c) a run over files 0-4 with --checkpoint, resumed
     over all ten: it seeks to file 4 and gives 8a's out.json; (8d) the
     first 50,000 reads with -i 10000 --stream --streamAll and the three
     sketches, and with --deviceFlush against the host flush on the CPU:
     stdout and out.json byte-identical card vs CPU. Every run's launches
     are asserted: the packed minimizer and the fused binning pass once per
     batch, and the exact flush's entries once per flush.
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
  11. sharded sketch: the data-parallel stream and the striped exact flush
     on a mesh that names the one card twice ([cuda:0, cuda:0]); none of it
     measures scaling. (11a) run_sketch_pipeline --kmv --khf --hmh over
     phase 3's reads: out.json byte-identical to phase 5's, the packed
     minimizer and the fused binning pass once per (batch, shard), reads/s
     beside phase 5's; (11b) the same at -k 31 (the two-sort step in each
     shard): out.json byte-identical to phase 6's, the values entry once per
     (batch, shard), the group steps under sync debug mode "error"; (11c)
     --deviceFlush with the CWS tables striped over the two entries,
     -i 1000000 over phase 8's files 0-1: out.json byte-identical to a
     one-device run, the exact flush's entries once a (flush, stripe); (11d) `sketch --kmv --khf --hmh` in two
     ranks sharing the card over phase 8's files 0-3: rank 0's out.json
     byte-identical to one process's, rank 1 writes nothing, both runs'
     wall seconds; (11e) sharded_histogram_step over [cuda:0, cuda:0] on one
     [16384, 160] batch equal to the fused step's histogram and count, with
     hulk_jump_hash launched.
  12. flush step and entry points: (12a) sharded_flush_step without drift
     on [cuda:0, cuda:0] (2 stripes of 21 slots) over two interval flushes
     of phase 3's halves (k=21, s=42, 194,481 bins, CMS 7 x 2,000): the CMS,
     the bins and the weights bit-equal to the exact host flush's, two
     stripes bit-equal to one, device time a flush beside its bound;
     (12b) with drift (-x 0.9): the two drift kernel
     entries (the CMS scan, the slot selection) bit-equal to their plain
     versions on a k=9 histogram and on the first 4,096 live bins of phase
     3's first half, the whole two-flush run against HistoSketch(decay=0.9)
     as in 12a with each entry's launches asserted, each entry's device
     time at full width and on the 4,096 bins beside its bound, the
     scan's beside the chain of its live bins' multiplies (a bare FP64
     multiply chain timed at the scan's shape) and a chain of multiply-adds,
     and the plain versions' time on their 4,096 bins, the selection's
     also on Aka strictly decreasing (its worst case); both entries on
     synth's corner cases of their designs; one drift flush's wall ms
     (median of 5) and its device time by operator (torch.profiler, its
     drift launches counted); the Aka entry (hulk_cws_aka) at the first
     half's shape bit-equal to its plain version, its device time beside
     its bound; the exact flush as the stream runs it (_CardFlusher) with
     and without drift, wall ms beside the host flush's at one thread,
     bit for bit the host flush's; (12c) entry()'s step on the card
     against the CPU, on its [64, 128] batch and at [16384, 160], the u8
     minimizer and hulk_jump_hash once each a call; (12d)
     dryrun_multichip(2) on the card against [cpu, cpu].
Then one JSON line of the device stages that have no TPU kernel (the
smash matrix, the LSH ranking, the no-drift sharded_flush_step) with device ms and bound, one
JSON line of kernels (every entry, with its launches summed over the driven
runs of phases 3, 5, 6, 7, 8, 11 and 12), the card's name and power limit,
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
import warnings

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
# the long-read record scan's cases (L, k, w, cap): 1% N, random pad past
# the record; a cap of 65,536 puts a 200 kb record into four chunks, the
# three after the first in the cont form; the first case is timed, with the
# dedup binning of its run heads
RECORD_CASES = [(200_000, 21, 9, None), (65_536, 21, 9, None), (200_000, 21, 9, 65_536),
                (65_536, 31, 2, None), (200_000, 31, 2, None), (200_000, 31, 2, 65_536)]
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
# the exact flush's entries, which every flush of a one-process run on the
# card launches
FLUSH_ENTRIES = ("cws_aka", "drift_select", "cms_drift_scan")
# phase 12's decay ratio (-x) and the live bins over which the plain drift
# versions run on the full-width histogram
DRIFT = 0.9
DRIFT_PREFIX = 4096
# the drift scan's dependency chains: a thread per CMS counter, each n
# dependent FP64 multiplies (the bound of the scan), or n multiply-adds of
# +0 (the parent design's chain), built with the kernels' flags (phase 1)
# and timed at the scan's shape in phase 12
CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
template <bool kAdd>
__global__ void chain(long long n, double dw, double add, int threads, double* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  double c = 1.0 + t;
#pragma unroll 16
  for (long long i = 0; i < n; ++i)
    c = kAdd ? __dadd_rn(__dmul_rn(c, dw), add) : __dmul_rn(c, dw);
  out[t] = c;
}
extern "C" int multiply_chain(long long n, double dw, int threads, void* out, void* stream) {
  chain<false><<<(threads + 63) / 64, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      n, dw, 0.0, threads, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int mul_add_chain(long long n, double dw, int threads, void* out, void* stream) {
  chain<true><<<(threads + 63) / 64, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      n, dw, 0.0, threads, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


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
    for the cont entry, groups of 16 continuation blocks (the shape the
    long-read path launched until it scanned a record in one launch) with 3
    live rows (a contig of up to 200 kb; the first, timed) and with all
    live, at k=21/w=9 and k=31/w=2."""
    from hulk_tpu_torch.ops.longread import DEFAULT_BLOCK as B
    from hulk_tpu_torch.stream.fastq import DEFAULT_LENGTH_BUCKETS
    from hulk_tpu_torch.stream.pipeline import MAX_BATCH_POSITIONS

    top, lo = DEFAULT_LENGTH_BUCKETS[-1], DEFAULT_LENGTH_BUCKETS[-2] + 1
    rows, G = MAX_BATCH_POSITIONS // top, 16
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


def u8_times(c, ln, lengths, k: int, w: int, wm, rep, wm0, rep0, tag: str) -> dict:
    """The u8 entry's device time on codes c [R, L] beside its bound and its
    plain version's time (wm, rep: its outputs, rewritten by each launch)."""
    import torch

    from hulk_tpu_torch.ops import minimizer_cuda as mc
    from hulk_tpu_torch.ops.minimizer import minimizer_window_torch

    R, L = c.shape
    f_u8 = mc.entry("hulk_minimizer_window")
    a_u8 = (c.data_ptr(), ln.data_ptr(), R, L, k, w, 0, wm.data_ptr(), rep.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    out = dict(ms=device_ms(lambda: f_u8(*a_u8)),
               plain_ms=time_ms(lambda: minimizer_window_torch(c, ln, k, w)),
               bound=minimizer_bound(R, L, lengths, packed=False),
               err=max(max_abs_err(wm, wm0), max_abs_err(rep, rep0)), shape=tag)
    if f_u8(*a_u8) != 0:
        raise SystemExit("FAIL minimizer_window: a timed launch was refused")
    torch.cuda.synchronize()
    check_equal(f"minimizer_window {tag} wmin after the timed launches", wm, wm0)
    return out


def minimizer_checks(rng, dev) -> dict:
    """The three minimizer entries against their plain versions on every
    case; at the driven paths' shapes, their device times beside their
    bounds: the packed entry and the u8 entry (entry()'s step and
    sharded_histogram_step) at the production batch, the u8 entry also at a
    long read's block 0 (its shape before entry() gave it a caller), the
    cont entry at a group of continuation blocks."""
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
            # the u8 entry at entry()'s batch; hulk_jump_hash hashes its lanes
            out["u8_batch"] = (wm, rep)
            out["u8"] = u8_times(c, ln, lengths, k, w, wm, rep, wm0, rep0, tag)
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
        if R == 1:  # a long read's block 0: the u8 entry's shape before entry()
            r = u8_times(c, ln, lengths, k, w, wm, rep, wm0, rep0, tag)
            print(f"minimizer_window_u8 at {tag}: device {r['ms']:.4f} ms a launch, bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]})", flush=True)
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


def jump_checks(rng, dev, batch, two_sort_batch, u8_batch) -> dict:
    """The three jump entries against their plain versions: the binning pass
    on the production batch's sorted keys and on synthetic sorted keys
    (mixed, all sentinel, one key repeated) at n = 194,481 and 2^31 - 1; the
    values entry on the k=31 two-sort batch's sorted values (above 2^63),
    the whole buffer with the device count as the step bins it and its live
    prefix, and on synthetic sorted values (full range with runs of equal
    values, all sentinel, one value repeated) at n = 1, 923,521 and
    2^31 - 1; the buckets entry on entry()'s batch (every lane of the u8
    minimizer's per-read values), random and adversarial keys; then the
    loop's boundary keys through all four entries (boundary_checks). Device
    times at the paths' batches beside their bounds."""
    import numpy as np
    import torch

    from hulk_tpu_torch.hashes.jumphash import jump_hash_torch
    from hulk_tpu_torch.ops import jump_cuda as jc
    from hulk_tpu_torch.ops.device_step import (bin_scatter_keys_torch,
                                                bin_scatter_values_torch,
                                                sorted_batch_keys, sorted_batch_values,
                                                stream_bucket)
    from hulk_tpu_torch.ops.minimizer import per_read_distinct
    from hulk_tpu_torch.synth import jump_adversarial_keys, sorted_keys, sorted_values

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
    # included) with the device count, as the step bins it, and its live
    # prefix; then synthetic sorted values
    svals, cnt = sorted_batch_values(*two_sort_batch)
    cnt = int(cnt)
    n31 = NBINS_K31
    above = int((svals[:cnt] < 0).sum())
    if above == 0:
        raise SystemExit("FAIL two-sort batch: no value at or above 2^63")
    vhist = torch.zeros(n31, dtype=torch.int32, device=dev)
    vhist0 = torch.zeros_like(vhist)
    vcount = torch.zeros((), dtype=torch.int64, device=dev)
    vcount0 = torch.zeros_like(vcount)
    for part in (svals, svals[:cnt]):
        for t in (vhist, vhist0, vcount, vcount0):
            t.zero_()
        jc.bin_scatter_values_cuda(vhist, part, count=vcount)
        bin_scatter_values_torch(vhist0, part, count=vcount0)
        check_equal(f"bin_scatter_values two-sort batch N={part.numel()} n={n31}", vhist, vhist0)
        check_equal(f"bin_scatter_values two-sort batch N={part.numel()} count", vcount, vcount0)
        if int(vhist.sum()) != cnt or int(vcount) != cnt:
            raise SystemExit(f"FAIL bin_scatter_values: {int(vhist.sum())} binned, "
                             f"{int(vcount)} counted, {cnt} live")
    verr = max(max_abs_err(vhist, vhist0), max_abs_err(vcount, vcount0))
    vtouched = int((vhist != 0).sum())  # bins the live values add to
    for kind, n_vals in (("mixed", 200_000), ("all_sentinel", 0), ("one_key", 5000)):
        vals = torch.from_numpy(sorted_values(rng, n_vals, one_key=kind == "one_key")
                                .view(np.int64)).to(dev)
        for nb in (1, n31, 2**31 - 1):
            got = torch.zeros(nb, dtype=torch.int32, device=dev)
            want = torch.zeros(nb, dtype=torch.int32, device=dev)
            got_c, want_c = torch.zeros_like(vcount), torch.zeros_like(vcount)
            jc.bin_scatter_values_cuda(got, vals, count=got_c)
            bin_scatter_values_torch(want, vals, count=want_c)
            check_equal(f"bin_scatter_values {kind} n={nb}", got, want)
            check_equal(f"bin_scatter_values {kind} n={nb} count", got_c, want_c)
            del got, want
    print(f"bin_scatter_values two-sort batch k=31 ({svals.numel()} lanes, {cnt} live, "
          f"{above} at or above 2^63), whole with the count and its live prefix, and "
          f"full-range/all-sentinel/one-key values at n=1, {n31} and 2^31-1: bit-equal, "
          f"counts equal", flush=True)

    # the buckets entry at entry()'s batch: every lane of the u8 minimizer's
    # per-read values, SENT for dead lanes, as sketch_accumulate_step hashes
    ekeys = per_read_distinct(*u8_batch)[0].reshape(-1).contiguous()
    got = jc.jump_hash_cuda(ekeys, n)
    want = jump_hash_torch(ekeys, n)
    check_equal(f"jump_hash entry() batch N={ekeys.numel()} n={n}", got, want)
    berr = max_abs_err(got, want)
    live = skeys != -1
    live[1:] &= skeys[1:] != skeys[:-1]
    values = torch.where(live, skeys & ((1 << vbits) - 1), 0)
    check_equal(f"jump_hash production values N={N} n={n}", jc.jump_hash_cuda(values, n),
                jump_hash_torch(values, n))
    rkeys = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=N,
                                          dtype=np.int64)).to(dev)
    check_equal(f"jump_hash random keys N={N}", jc.jump_hash_cuda(rkeys, n),
                jump_hash_torch(rkeys, n))
    adv = torch.from_numpy(jump_adversarial_keys().view(np.int64)).to(dev)
    for nb in (1, 2, 2000, 194481, 2**31 - 1):
        check_equal(f"jump_hash adversarial n={nb}", jc.jump_hash_cuda(adv, nb),
                    jump_hash_torch(adv, nb))
    print(f"jump_hash entry() batch ({ekeys.numel()} keys), the fused batch's values, random "
          f"keys and adversarial keys ({adv.numel()} x 5 n): bit-equal", flush=True)
    boundary_checks(dev)

    stream = torch.cuda.current_stream().cuda_stream
    f_bin, f_jump = jc.entry("hulk_bin_scatter_keys"), jc.entry("hulk_jump_hash")
    f_val = jc.entry("hulk_bin_scatter_values")
    a_bin = (skeys.data_ptr(), N, vbits, hist.data_ptr(), n, stream)
    a_jump = (ekeys.data_ptr(), ekeys.numel(), n, got.data_ptr(), stream)
    a_jump_old = (values.data_ptr(), N, n, got.data_ptr(), stream)
    live_vals = svals[:cnt]
    a_val = (svals.data_ptr(), svals.numel(), vhist.data_ptr(), n31, 0, vcount.data_ptr(),
             stream)
    a_val_live = (live_vals.data_ptr(), cnt, vhist.data_ptr(), n31, 0, None, stream)
    iters_live = jump_iterations(values[live], n)
    iters_all = jump_iterations(ekeys, n)
    iters_vals = jump_iterations(live_vals, n31)
    bins64, ones = jc.jump_hash_cuda(values, n).long(), live.int()
    for tag, keys, nb, iters in (("fused batch's live values", values[live], n, iters_live),
                                 ("entry() batch", ekeys, n, iters_all),
                                 ("two-sort batch's live values", live_vals, n31, iters_vals)):
        total, exact = jc.jump_steps_cuda(keys.contiguous(), nb)
        if total != iters:
            raise SystemExit(f"FAIL jump_hash_steps {tag}: {total} iterations, {iters} "
                             f"by the plain loop")
        print(f"jump loop on the {tag} ({keys.numel()} keys, n={nb}): {total} iterations, "
              f"{exact} of them ({100 * exact / total:.4f}%) took the exact step", flush=True)
    # bytes: the keys or values read once (the live prefix and its first
    # sentinel for the sorted values), and each bin they add to read and
    # written once (4 bytes each way)
    out = {
        "fused": dict(ms=device_ms(lambda: f_bin(*a_bin)),
                      plain_ms=time_ms(lambda: bin_scatter_keys_torch(hist0, skeys, vbits)),
                      bound=bound(8 * N + 2 * 4 * touched, 2 * iters_live, FP64_OPS_PER_S),
                      err=err, shape=f"N={N} n={n} ({int(live.sum())} live distinct "
                                     f"keys into {touched} bins, {iters_live} loop "
                                     f"iterations)"),
        "buckets": dict(ms=device_ms(lambda: f_jump(*a_jump)),
                        plain_ms=time_ms(lambda: jump_hash_torch(ekeys, n)),
                        bound=bound(12 * ekeys.numel(), 2 * iters_all, FP64_OPS_PER_S),
                        err=berr, shape=f"entry()'s batch R={R} L={L}: N={ekeys.numel()} "
                                        f"n={n} ({iters_all} loop iterations)"),
        "values": dict(ms=device_ms(lambda: f_val(*a_val)),
                       plain_ms=time_ms(lambda: bin_scatter_values_torch(vhist0, svals,
                                                                         count=vcount0)),
                       bound=bound(8 * (cnt + 1) + 2 * 4 * vtouched + 8, 2 * iters_vals,
                                   FP64_OPS_PER_S),
                       err=verr, shape=f"the k=31 two-sort batch's whole buffer, N="
                                       f"{svals.numel()} ({cnt} live values into {vtouched} "
                                       f"bins, {iters_vals} loop iterations), n={n31}, "
                                       f"with the device count"),
        "index_add_ms": device_ms(lambda: hist0.index_add_(0, bins64, ones)),
        "buckets_fused_shape_ms": device_ms(lambda: f_jump(*a_jump_old)),
        "values_live_prefix_ms": device_ms(lambda: f_val(*a_val_live)),
        "keys": skeys,
        "two_sort": (svals, cnt),
    }
    print(f"hulk_jump_hash at the fused step's batch ({N} keys, its shape before "
          f"entry()): device {out['buckets_fused_shape_ms']:.4f} ms; "
          f"hulk_bin_scatter_values on the two-sort batch's live prefix ({cnt} values, no "
          f"count): device {out['values_live_prefix_ms']:.4f} ms", flush=True)
    if f_bin(*a_bin) != 0 or f_jump(*a_jump) != 0 or f_val(*a_val) != 0 \
            or f_jump(*a_jump_old) != 0 or f_val(*a_val_live) != 0:
        raise SystemExit("FAIL jump_hash: a timed launch was refused")
    torch.cuda.synchronize()
    return out


def boundary_checks(dev) -> None:
    """The jump loop where its filtered step hands over to the exact one:
    the reciprocal seed's error over all 2^31 divisors within the bound the
    proof assumes, then the adversarial keys and keys whose loop meets a
    quotient within 2^-20 of an integer (synth.jump_boundary_keys) through
    all four entries against their plain versions at n = 1, 194,481,
    923,521 and 2^31 - 1 (the sorted entries on them sorted, SENT tail and
    duplicates added; the keys entry on those below 2^63, vbits = 63), and
    how many of their iterations took the exact step."""
    import math

    import numpy as np
    import torch

    from hulk_tpu_torch._u64 import usort
    from hulk_tpu_torch.hashes.jumphash import jump_hash_torch
    from hulk_tpu_torch.ops import jump_cuda as jc
    from hulk_tpu_torch.ops.device_step import bin_scatter_keys_torch, bin_scatter_values_torch
    from hulk_tpu_torch.synth import jump_adversarial_keys, jump_boundary_keys

    t0 = time.perf_counter()
    e = jc.seed_error_cuda(dev)
    print(f"jump loop reciprocal seed over all 2^31 divisors: max |1 - s r0| = {e:.6e} = "
          f"2^{math.log2(e):.3f} (the proof assumes at most "
          f"2^{math.log2(jc.SEED_ERROR_BOUND):.0f}; {time.perf_counter() - t0:.3f} s)",
          flush=True)
    if not e <= jc.SEED_ERROR_BOUND:
        raise SystemExit(f"FAIL jump loop: the seed's error {e:.6e} passes the proof's bound")
    adv = jump_adversarial_keys()
    raw = np.concatenate([adv, jump_boundary_keys(np.random.default_rng(SEED))])
    keys = torch.from_numpy(raw.view(np.int64)).to(dev)
    tail = torch.full((64,), -1, dtype=torch.int64, device=dev)
    svals = torch.cat([usort(torch.cat([keys, keys[::3]])), tail])
    skeys = torch.cat([usort(keys[keys >= 0]), tail])
    report = []
    for nb in (1, 194481, 923521, 2**31 - 1):
        check_equal(f"jump_hash boundary keys n={nb}", jc.jump_hash_cuda(keys, nb),
                    jump_hash_torch(keys, nb))
        for dedup in (False, True):
            h, h0 = (torch.zeros(nb, dtype=torch.int32, device=dev) for _ in range(2))
            c, c0 = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
            jc.bin_scatter_values_cuda(h, svals, dedup=dedup, count=c)
            bin_scatter_values_torch(h0, svals, dedup=dedup, count=c0)
            check_equal(f"bin_scatter_values boundary values dedup={dedup} n={nb}", h, h0)
            check_equal(f"bin_scatter_values boundary values dedup={dedup} n={nb} count", c, c0)
            del h, h0
        h, h0 = (torch.zeros(nb, dtype=torch.int32, device=dev) for _ in range(2))
        jc.bin_scatter_keys_cuda(h, skeys, 63)
        bin_scatter_keys_torch(h0, skeys, 63)
        check_equal(f"bin_scatter_keys boundary keys n={nb}", h, h0)
        del h, h0
        total, exact = jc.jump_steps_cuda(keys, nb)
        report.append(f"n={nb}: {exact} of {total}")
    print(f"jump loop boundary keys ({adv.size} adversarial, {raw.size - adv.size} within "
          f"2^-20 of an integer) through the buckets, values (plain and dedup, with the "
          f"count) and keys entries at n = 1, 194481, 923521, 2^31-1: bit-equal; exact "
          f"steps of their iterations: {', '.join(report)}", flush=True)


def record_checks(rng, dev) -> dict:
    """The long-read step's two launches against their plain versions: the
    record scan (hulk_minimizer_record; sorted, bit-equal to the plain
    version's run heads) on every RECORD_CASES record, and the values
    entry's dedup form with its count on the first record's sorted run
    heads and on synthetic sorted values (runs of equal values, all
    sentinel, one value repeated) at n = 1, 194,481 and 2^31 - 1. Device
    times at the first record beside their bounds, and the values entry's
    launch floor (one value a launch)."""
    import numpy as np
    import torch

    from hulk_tpu_torch._u64 import usort
    from hulk_tpu_torch.ops import jump_cuda as jc
    from hulk_tpu_torch.ops import minimizer_cuda as mc
    from hulk_tpu_torch.ops.device_step import bin_scatter_values_torch
    from hulk_tpu_torch.ops.longread import record_heads, record_heads_torch
    from hulk_tpu_torch.ops.minimizer import record_run_heads_torch
    from hulk_tpu_torch.synth import sorted_values

    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for L, k, w, cap in RECORD_CASES:
        buf = rng.integers(0, 256, size=L + 4096, dtype=np.uint8)
        buf[:L] = np.where(rng.random(L) < 0.01, 4, rng.integers(0, 4, size=L))
        c = torch.from_numpy(buf).to(dev)[:L]
        heads, count = record_heads(c, k=k, w=w, cap=cap)
        got = usort(heads[:int(count)])
        want = usort(record_heads_torch(c, k=k, w=w, cap=cap or mc.RECORD_CAP))
        tag = f"L={L} k={k} w={w}" + (f" cap={cap}" if cap else "")
        check_equal(f"minimizer_record {tag}", got, want)
        print(f"minimizer_record {tag}: {got.numel()} run heads, sorted bit-equal", flush=True)
        if "record" in out:
            continue
        f_rec = mc.entry("hulk_minimizer_record")
        # room for every timed launch's heads: the count is not reset
        room = torch.empty(64 * L, dtype=torch.int64, device=dev)
        n0 = torch.zeros((), dtype=torch.int64, device=dev)
        a_rec = (c.data_ptr(), L, k, w, 0, room.data_ptr(), n0.data_ptr(), stream)
        out["record"] = dict(
            ms=device_ms(lambda: f_rec(*a_rec)),
            plain_ms=time_ms(lambda: record_run_heads_torch(c, k, w)),
            bound=bound(L + 8 * got.numel() + 8, 2 * MIN_U64_OPS_PER_POS * L,
                        INT32_OPS_PER_S),
            err=max_abs_err(got, want), shape=f"one record, {tag} ({got.numel()} run heads)")
        if f_rec(*a_rec) != 0:
            raise SystemExit("FAIL minimizer_record: a timed launch was refused")
        del room
        svals = got

    # the dedup form on the first record's sorted run heads, k = 21's bins
    n = NBINS
    hist = torch.zeros(n, dtype=torch.int32, device=dev)
    hist0 = torch.zeros_like(hist)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    cnt0 = torch.zeros_like(cnt)
    jc.bin_scatter_values_cuda(hist, svals, dedup=True, count=cnt)
    bin_scatter_values_torch(hist0, svals, dedup=True, count=cnt0)
    distinct = torch.unique(svals)
    check_equal(f"bin_scatter_values dedup, a record's {svals.numel()} run heads", hist, hist0)
    check_equal("bin_scatter_values dedup count", cnt, cnt0)
    if int(cnt) != distinct.numel() or int(hist.sum()) != distinct.numel():
        raise SystemExit(f"FAIL bin_scatter_values dedup: counted {int(cnt)}, binned "
                         f"{int(hist.sum())}, {distinct.numel()} distinct")
    for kind, n_vals in (("mixed", 200_000), ("all_sentinel", 0), ("one_key", 5000)):
        vals = torch.from_numpy(sorted_values(rng, n_vals, one_key=kind == "one_key")
                                .view(np.int64)).to(dev)
        for nb in (1, n, 2**31 - 1):
            got_h = torch.zeros(nb, dtype=torch.int32, device=dev)
            want_h = torch.zeros(nb, dtype=torch.int32, device=dev)
            got_c, want_c = torch.zeros_like(cnt), torch.zeros_like(cnt)
            jc.bin_scatter_values_cuda(got_h, vals, dedup=True, count=got_c)
            bin_scatter_values_torch(want_h, vals, dedup=True, count=want_c)
            check_equal(f"bin_scatter_values dedup {kind} n={nb}", got_h, want_h)
            check_equal(f"bin_scatter_values dedup {kind} n={nb} count", got_c, want_c)
            del got_h, want_h
    print(f"bin_scatter_values dedup with count: a record's {svals.numel()} run heads "
          f"({distinct.numel()} distinct) and full-range/all-sentinel/one-key values at "
          f"n=1, {n} and 2^31-1: bit-equal", flush=True)
    f_val = jc.entry("hulk_bin_scatter_values")
    a_dd = (svals.data_ptr(), svals.numel(), hist.data_ptr(), n, 1, cnt.data_ptr(), stream)
    iters = jump_iterations(distinct, n)
    touched = int((hist != 0).sum())
    err = max(max_abs_err(hist, hist0), max_abs_err(cnt, cnt0))  # before the timed runs
    out["values_dedup"] = dict(
        ms=device_ms(lambda: f_val(*a_dd)),
        plain_ms=time_ms(lambda: bin_scatter_values_torch(hist0, svals, dedup=True,
                                                          count=cnt0)),
        bound=bound(8 * svals.numel() + 2 * 4 * touched + 8, 2 * iters, FP64_OPS_PER_S),
        err=err,
        shape=f"N={svals.numel()} sorted run heads of a 200 kb record ({distinct.numel()} "
              f"distinct into {touched} bins, {iters} loop iterations), n={n}")
    one = svals[:1].clone()
    a_one = (one.data_ptr(), 1, hist.data_ptr(), n, 1, cnt.data_ptr(), stream)
    floor_ms = device_ms(lambda: f_val(*a_one))
    if f_val(*a_dd) != 0 or f_val(*a_one) != 0:
        raise SystemExit("FAIL bin_scatter_values dedup: a timed launch was refused")
    torch.cuda.synchronize()
    print(f"hulk_bin_scatter_values launch floor (dedup, one value a launch): device "
          f"{floor_ms:.4f} ms a launch", flush=True)
    return out


def sketch_update_times(keys, two_sort) -> None:
    """The KMV, KHF and HMH updates a batch (plain PyTorch on the card), on
    the production batch's fused feed and on the two-sort batch's; then the
    two-sort step's binning of the whole SENT-tailed buffer with its sketch
    feed both ways it could run: the whole buffer (no host sync), or the
    live prefix after one read of the count (the step's form), the states
    equal."""
    import torch

    from hulk_tpu_torch.ops.device_sketches import (SketchStates, hmh_update, khf_update,
                                                    kmv_update)
    from hulk_tpu_torch.ops.device_step import (bin_scatter_values, bottom_k_values,
                                                distinct_values, update_sketches)

    k = PRODUCTION[2]
    svals, cnt = two_sort
    n_live = int((keys != -1).sum())
    feeds = {"fused k=21 R=16384": (distinct_values(keys[:n_live], 2 * k + 8), False),
             "two-sort k=31 R=2048": (svals[:cnt], True)}
    for tag, (vals, ascending) in feeds.items():
        st = SketchStates.empty(42, kmv=True, khf=True, hmh=True, device=vals.device)
        kmv = time_ms(lambda: kmv_update(st.kmv, vals if ascending else bottom_k_values(vals, 42)))
        khf = time_ms(lambda: khf_update(st.khf, vals))
        hmh = time_ms(lambda: hmh_update(st.hmh, vals))
        print(f"sketch updates a batch, {tag} ({vals.numel()} values fed, s=42): "
              f"KMV {kmv:.4f} ms, KHF {khf:.4f} ms, HMH {hmh:.4f} ms "
              f"(plain PyTorch, CUDA events around one call)", flush=True)

    dev = svals.device
    count = torch.zeros((), dtype=torch.int64, device=dev)
    dcount = count.clone() + cnt  # the step's device count of the batch
    hist = torch.zeros(NBINS_K31, dtype=torch.int32, device=dev)

    def whole(st):
        bin_scatter_values(hist, svals, count=count)
        update_sketches(st, svals, ascending=True)

    def count_read(st):
        bin_scatter_values(hist, svals, count=count)
        update_sketches(st, svals[:int(dcount)], ascending=True)

    states = {}
    for name, fn in (("whole", whole), ("count_read", count_read)):
        st = SketchStates.empty(42, kmv=True, khf=True, hmh=True, device=dev)
        fn(st)
        states[name] = st
    for a, b in ((states["whole"].kmv, states["count_read"].kmv),
                 (states["whole"].khf, states["count_read"].khf),
                 (states["whole"].hmh, states["count_read"].hmh)):
        check_equal("two-sort sketch feed, whole buffer against live prefix", a, b)
    st = SketchStates.empty(42, kmv=True, khf=True, hmh=True, device=dev)
    t_read, t_whole = [time_ms(lambda: count_read(st))], []
    t_whole += [time_ms(lambda: whole(st)), time_ms(lambda: whole(st))]
    t_read.append(time_ms(lambda: count_read(st)))
    print(f"two-sort step with --kmv --khf --hmh, binning and sketch feed a batch "
          f"({svals.numel()} lanes, {cnt} live; CUDA events around one call, host time "
          f"included, median of 20, in turns): the whole SENT-tailed buffer (no sync) "
          f"{t_whole[0]:.4f}/{t_whole[1]:.4f} ms, the live prefix after one count read "
          f"{t_read[0]:.4f}/{t_read[1]:.4f} ms; states equal", flush=True)


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
    ("minimizer_record", "hulk_minimizer_record", "minimizer_record", "minimizer_window.cu",
     "minimizer_pallas.py:223", "record"),
    ("jump_hash_values_dedup", "hulk_bin_scatter_values (dedup=1)", "bin_scatter_values_dedup",
     "jump_hash.cu", "jump_pallas.py:284", "values_dedup"),
]


def kernel_phase(rng, dev) -> dict:
    mins = minimizer_checks(rng, dev)
    jumps = jump_checks(rng, dev, mins.pop("batch"), mins.pop("two_sort_batch"),
                        mins.pop("u8_batch"))
    results = {**mins, **jumps, **record_checks(rng, dev)}
    for name, entry, _, _, _, key in ENTRIES:
        r = results[key]
        print(f"{name} ({entry}) {r['shape']}: device {r['ms']:.4f} ms a launch, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{100 * r['bound'][0] / r['ms']:.1f}% of bound", flush=True)
    print(f"unpack_codes2 (plain, the pass the packed entry replaces): "
          f"{mins['unpack_ms']:.4f} ms; index_add_ of the production batch: "
          f"device {jumps['index_add_ms']:.4f} ms", flush=True)
    sketch_update_times(jumps["keys"], jumps["two_sort"])
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


@contextlib.contextmanager
def no_host_sync_in_group_step():
    """Run every group step (ops/device_step.py group_scan_body, as the
    stream and the sharded stream's shards call it) under torch's sync
    debug mode "error", so that a host sync inside it fails the run. The
    mode is process-wide and the shards step in threads of their own, so it
    stays on while any call is inside. Yields the number of calls made."""
    import threading

    import torch

    from hulk_tpu_torch.ops import device_step
    from hulk_tpu_torch.stream import pipeline

    body = device_step.group_scan_body
    lock, inside, calls = threading.Lock(), [0], [0]

    def guarded(*args, **kw):
        with lock:
            inside[0] += 1
            calls[0] += 1
            torch.cuda.set_sync_debug_mode("error")
        try:
            return body(*args, **kw)
        finally:
            with lock:
                inside[0] -= 1
                if not inside[0]:
                    torch.cuda.set_sync_debug_mode(0)

    device_step.group_scan_body = pipeline.group_scan_body = guarded
    try:
        yield calls
    finally:
        device_step.group_scan_body = pipeline.group_scan_body = body


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
    from hulk_tpu_torch.ops import cws_aka_cuda, flush_drift_cuda, jump_cuda, minimizer_cuda

    for d in (minimizer_cuda.launches, jump_cuda.launches, flush_drift_cuda.launches,
              cws_aka_cuda.launches):
        d.update(dict.fromkeys(d, 0))


def read_launches() -> dict:
    from hulk_tpu_torch.ops import cws_aka_cuda, flush_drift_cuda, jump_cuda, minimizer_cuda

    return {**minimizer_cuda.launches, **jump_cuda.launches, **flush_drift_cuda.launches,
            **cws_aka_cuda.launches}


def step_launches(counts: dict) -> int:
    """The launches of the stream's step entries: all but the flush's."""
    return sum(v for key, v in counts.items() if key not in FLUSH_ENTRIES)


def check_flush_launches(tag: str, counts: dict, flushes: int, drift: bool,
                         stripes: int = 1) -> None:
    """Each flush of a one-process run on the card through the exact
    flush's entries: the Aka and the selection once a (flush, stripe), the
    drift scan once a flush with -x."""
    want = {"cws_aka": flushes * stripes, "drift_select": flushes * stripes,
            "cms_drift_scan": flushes if drift else 0}
    got = {key: counts[key] for key in want}
    if got != want:
        raise SystemExit(f"FAIL {tag}: flush launches {got}, expected {want}")


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
                "minimizer_window_kernel" in e.key or "minimizer_record_kernel" in e.key
                or "jump_kernel" in e.key):
            print(f"{tag} profiled kernel {e.key}: {e.count} launches, "
                  f"{e.self_device_time_total / e.count:.1f} us a launch", flush=True)
    return events


def profile_phase(fq: str, tmp: str) -> None:
    """Warm passes over fq: parse alone, `sketch`, and `sketch` profiled."""
    import torch

    from hulk_tpu_torch.sketch.countmin import cms_shape
    from hulk_tpu_torch.stream.fastq import batch_reads_native

    t0 = time.perf_counter()
    n = sum(int((b.lengths > 0).sum())
            for b in batch_reads_native([fq], batch_size=16384, raw=True))
    t_parse = time.perf_counter() - t0
    print(f"parse alone: {n} reads in {t_parse:.3f} s = {n / t_parse:.0f} reads/s", flush=True)
    t_run, _ = sketch_cli(fq, os.path.join(tmp, "warm"), "cuda", os.path.join(tmp, "warm.log"))
    print(f"sketch, warm: {t_run:.3f} s = {READS / t_run:.0f} reads/s", flush=True)
    events = profiled("sketch", fq, tmp)
    # the run's one flush (no drift) adds the counts into each CMS row with
    # index_add (parallel/mesh.py:_estimates); the binning takes the jump
    # kernel, so none may run once a batch
    depth = cms_shape()[0]
    adds = {e.key: e.count for e in events if "index_add" in e.key
            and e.device_type == torch.autograd.DeviceType.CPU}
    if any(n != depth for n in adds.values()):
        raise SystemExit(f"FAIL profile: index_add ran on the main path ({adds}; the flush's "
                         f"CMS update takes {depth})")


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


def blockwise_values(codes, k: int, w: int):
    """A long record's distinct values as the long-read path ran until it
    scanned a record in one launch: block 0 [1, S] through the u8 entry,
    the continuation blocks in groups of 16 [16, S] rows filled with 5
    through its cont form, each block's distinct values on the card, the
    union on the host (np.unique)."""
    import numpy as np
    import torch

    from hulk_tpu_torch.ops.longread import DEFAULT_BLOCK as S
    from hulk_tpu_torch.ops.minimizer import minimizer_window, per_read_distinct

    def values(rows, lens, cont):
        c, ln = torch.from_numpy(rows).cuda(), torch.from_numpy(lens).cuda()
        vals, mask = per_read_distinct(*minimizer_window(c, ln, k, w, cont))
        return vals[mask].cpu().numpy().view(np.uint64)

    L, H = codes.shape[0], w + k - 1
    first = np.full((1, S), 5, dtype=np.uint8)
    first[0, :min(L, S)] = codes[:S]
    pieces = [values(first, np.array([min(L, S)], dtype=np.int32), False)]
    starts = list(range(S - H, L - H, S - H))
    for i in range(0, len(starts), 16):
        rows, lens = np.full((16, S), 5, dtype=np.uint8), np.zeros(16, dtype=np.int32)
        for j, g0 in enumerate(starts[i:i + 16]):
            lens[j] = min(L - g0, S)
            rows[j, :lens[j]] = codes[g0:g0 + lens[j]]
        pieces.append(values(rows, lens, True))
    return np.unique(np.concatenate(pieces))


def long_read_times(src: str) -> None:
    """Host milliseconds a long record of src (k=21, w=9), the two paths
    in turns record by record: the long-read step on the card
    (ops/longread.py long_read_step: copy, record scan, the count read,
    sort, dedup binning into a device histogram), and the blockwise path
    it replaced (blockwise_values, then the host spectrum's binning of the
    values). Both histograms must agree. These launches are not counted."""
    import numpy as np
    import torch

    from hulk_tpu_torch.ops.device_sketches import SketchStates
    from hulk_tpu_torch.ops.longread import long_read_step, to_device
    from hulk_tpu_torch.sketch.spectrum import KmerSpectrum
    from hulk_tpu_torch.stream.fastq import LongRead, batch_reads_native

    spectrum = KmerSpectrum(NBINS)
    hist = torch.zeros(NBINS, dtype=torch.int32, device="cuda")
    count = torch.zeros((), dtype=torch.int64, device="cuda")
    t = dict.fromkeys(("step", "scan", "bin"), 0.0)
    n = 0
    for item in batch_reads_native([src], batch_size=16384, fasta=True, raw=True):
        if not isinstance(item, LongRead):
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long_read_step(hist, count, None, to_device(item.codes, "cuda"), k=21, w=9)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flat = blockwise_values(item.codes, 21, 9)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        spectrum.add_hashes(flat)
        t3 = time.perf_counter()
        last = item.codes
        if n:  # the first record warms both paths up
            t["step"] += t1 - t0
            t["scan"] += t2 - t1
            t["bin"] += t3 - t2
        n += 1
    if not np.array_equal(hist.cpu().numpy(), spectrum.bins.astype(np.int32)):
        raise SystemExit("FAIL long-read step: its histogram differs from the blockwise path's")
    n_distinct = int(count)
    if n_distinct != int(spectrum.bins.sum()):
        raise SystemExit("FAIL long-read step: its count differs from the blockwise path's")
    # the host syncs of one record's step with the three sketches on, as
    # torch's sync debug mode reports them
    states = SketchStates.empty(42, kmv=True, khf=True, hmh=True, device="cuda")
    codes = to_device(last, "cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            long_read_step(hist, count, states, codes, k=21, w=9)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing" in str(c.message) for c in caught)
    if syncs > 1:
        raise SystemExit(f"FAIL long-read step: {syncs} host syncs a record")
    m = max(n - 1, 1)
    print(f"long-read path, {n} long records ({n_distinct} distinct values), the first "
          f"left out: long_read_step {1e3 * t['step'] / m:.3f} ms a record (copy, record "
          f"scan, count read, sort, dedup binning on the card); the blockwise path it "
          f"replaced {1e3 * (t['scan'] + t['bin']) / m:.3f} ms (scan "
          f"{1e3 * t['scan'] / m:.3f}, host spectrum binning {1e3 * t['bin'] / m:.3f}); "
          f"histograms equal; {syncs} host sync a record (torch's sync debug mode, "
          f"with --kmv --khf --hmh)", flush=True)


def expected_long_launches(lengths, k: int, w: int) -> tuple[int, int]:
    """(record-scan launches, dedup binning launches) of the long-read step
    over contigs of these lengths: one scan a chunk of RECORD_CAP (one for
    every contig under 2^30 bases) and one binning launch for each read of
    the top length bucket's length or more (the native parser's
    max_read_len)."""
    from hulk_tpu_torch.ops.longread import chunks
    from hulk_tpu_torch.ops.minimizer_cuda import RECORD_CAP
    from hulk_tpu_torch.stream.fastq import DEFAULT_LENGTH_BUCKETS

    long_ = [int(x) for x in lengths if x >= DEFAULT_LENGTH_BUCKETS[-1]]
    return sum(len(chunks(L, RECORD_CAP, k, w)) for L in long_), len(long_)


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


def profiled_device_ms(fn, reps: int = 5, tag: str = "", expect: dict | None = None) -> float:
    """Device milliseconds a call of fn (plain PyTorch, many launches), by
    torch.profiler: the card's kernel and copy time over reps calls, after
    one warm-up, divided by reps; with a tag, the operators that take it.
    `expect` maps a kernel's name (a part of it) to its launches a call: the
    tracer was seen to drop launches of one call in five (H100, CUDA 12.8),
    so a trace short of them is taken again, up to three times, and its
    counts are printed against the expected."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if not expect:
            break
        seen = {part: sum(e.count for e in events if part in e.key
                          and e.device_type == torch.autograd.DeviceType.CUDA)
                for part in expect}
        whole = all(seen[part] == reps * k for part, k in expect.items())
        print(f"{tag or 'profile'}, trace {attempt}: launches {seen}, expected "
              f"{ {part: reps * k for part, k in expect.items()} }: "
              f"{'complete' if whole else 'INCOMPLETE, its device ms short'}", flush=True)
        if whole:
            break
    if tag:
        print(f"{tag}, {reps} calls profiled:", flush=True)
        print(events.table(sort_by="self_device_time_total", row_limit=8), flush=True)
    return device_seconds(events) * 1e3 / reps


def wall_ms(fn, reps: int = 5) -> list:
    """The wall ms of reps calls of fn, each synchronized, sorted."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)


def device_seconds(events) -> float:
    import torch

    return sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6


def reset_flush_stats() -> None:
    from hulk_tpu_torch.ops import distance
    from hulk_tpu_torch.stream import pipeline

    pipeline.flush_stats.update(flush_waits=[])
    distance.recheck_stats["cells"] = 0


def check_launches(tag: str, counts: dict, reads: int) -> int:
    """The main path's two entries once per batch, and no other step entry:
    the packed minimizer and the fused binning pass the same number of
    times, at least one batch per 16,384 reads. Returns the batch count."""
    n = counts["minimizer_window_packed"]
    if (n < -(-reads // 16384) or counts["bin_scatter_keys"] != n
            or step_launches(counts) != 2 * n):
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


def fq_histograms(fq: str, device, cut: int) -> list:
    """The int32 histograms (k=21, w=9) on the device of each `cut` reads of
    fq in turn (cut divides the file's reads), as the interval flushes get
    them."""
    from hulk_tpu_torch.stream.fastq import batch_reads_native
    from hulk_tpu_torch.stream.pipeline import SketchConfig, _DeviceStream

    cfg = SketchConfig(kmer_size=21, window_size=9, sketch_size=42, device="cuda")
    dev = _DeviceStream(cfg, NBINS, device)
    hists = []
    for b in batch_reads_native([fq], batch_size=cfg.resolved_batch_size(), cut_every=cut,
                                raw=True):
        dev.feed(b)
        if b.reads_in_file_end % cut == 0:
            hists.append(dev.take_hist())
    return hists


def flush_step_bound(depth: int, width: int, s: int = 42) -> tuple[float, str]:
    """The no-drift sharded_flush_step's least time. Bytes: histogram, row
    table, tables read once, CMS read and written; operations: about 6 FP64
    a (slot, bin) (subtract, exp, 2 multiplies, divide, compare) and 4 a
    (row, bin) of the CMS prefix sums."""
    nbytes = 4 * NBINS + 8 * depth * NBINS + 3 * 8 * s * NBINS + 2 * 8 * depth * width
    return bound(nbytes, 6 * s * NBINS + 4 * depth * NBINS, FP64_OPS_PER_S)


def interval_phase(fq: str, small: str, tmp: str, path_launches: dict) -> list:
    """Phase 8 (cell d): BASELINE config 4's stream, 10M reads in ten files,
    -i 1000000 -x 0.9, and the interval machinery around it. Returns the
    ten files."""
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
    check_flush_launches("8a", counts, len(files), True)
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

    # (8b) no drift, and --deviceFlush, which takes the same exact flush
    t_host, _, counts = drive("8b_host", src, tmp, every)
    path_launches["8b_host"] = counts
    check_launches("8b host", counts, n_reads)
    check_flush_launches("8b host", counts, len(files), False)
    t_dev, _, counts = drive("8b_device", src, tmp, (*every, "--deviceFlush"))
    path_launches["8b_device"] = counts
    check_launches("8b device", counts, n_reads)
    check_flush_launches("8b device", counts, len(files), False)
    out = {}
    for name in ("8b_host", "8b_device"):
        with open(os.path.join(tmp, f"{name}.json"), "rb") as fh:
            out[name] = fh.read()
    if out["8b_host"] != out["8b_device"]:
        raise SystemExit("FAIL 8b: --deviceFlush out.json differs from the default run's")
    print(f"8b: no drift {t_host:.3f} s = {n_reads / t_host:.0f} reads/s; --deviceFlush "
          f"{t_dev:.3f} s = {n_reads / t_dev:.0f} reads/s; out.json byte-identical", flush=True)

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
    return files


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


def shard_steps(src: str, R: int, ndev: int) -> int:
    """The (batch, shard) steps of the sharded stream over src: each batch
    split by rows as on one device (MAX_BATCH_POSITIONS), each piece into
    ndev blocks of ceil(rows / ndev); a block with no rows steps nothing."""
    from hulk_tpu_torch.parallel.mesh import stripes
    from hulk_tpu_torch.stream.fastq import batch_reads_native
    from hulk_tpu_torch.stream.pipeline import MAX_BATCH_POSITIONS

    n = 0
    for b in batch_reads_native([src], batch_size=R, raw=True):
        rows = max(1, min(R, MAX_BATCH_POSITIONS // b.bucket))
        for start in range(0, b.lengths.shape[0], rows):
            m = min(rows, b.lengths.shape[0] - start)
            n += sum(lo < m for lo, _ in stripes(rows, ndev))
    return n


def sharded_run(tag: str, srcs: list, tmp: str, mesh_devs: list, **kw):
    """run_sketch_pipeline over srcs on the mesh (k=21, w=9, s=42 unless kw
    says otherwise; the CLI's file name), launch-counted: every count set
    to 0 just before, read just after. Writes <tag>.json; returns
    (seconds, counts, out.json bytes)."""
    import torch

    from hulk_tpu_torch.stream.pipeline import SketchConfig, run_sketch_pipeline

    kw = dict(dict(kmer_size=21, window_size=9, sketch_size=42), **kw)
    cfg = SketchConfig(file_name=",".join(srcs) + ",", input_paths=srcs, device="cuda",
                       devices=mesh_devs, **kw)
    reset_launches()
    t0 = time.perf_counter()
    res = run_sketch_pipeline(None, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    path = os.path.join(tmp, f"{tag}.json")
    res.hulk_data.write_json(path)
    with open(path, "rb") as fh:
        data = fh.read()
    print(f"{tag}: {seconds:.3f} s, {res.minimizer_count} minimizers, launches {counts}",
          flush=True)
    return seconds, counts, data


def sharded_phase(fq: str, files: list, tmp: str, dev, path_launches: dict,
                  t5: float) -> None:
    """Phase 11 (cell g): the data-parallel stream and the striped exact
    flush on a mesh that names the one card twice, two ranks sharing the
    card, and sharded_histogram_step. t5: phase 5's seconds."""
    import numpy as np
    import torch

    from hulk_tpu_torch.ops.device_step import (
        bin_scatter_keys,
        sorted_batch_keys,
        stream_bucket,
    )
    from hulk_tpu_torch.ops.minimizer import minimizer_window_packed
    from hulk_tpu_torch.parallel import mesh
    from hulk_tpu_torch.synth import kernel_batch

    two = [dev, dev]
    with open(os.path.join(tmp, "sketches.json"), "rb") as fh:
        want_a = fh.read()
    with open(os.path.join(tmp, "two_sort.json"), "rb") as fh:
        want_b = fh.read()

    # 11a: --kmv --khf --hmh over phase 3's reads, rows sharded in two
    steps = shard_steps(fq, 16384, 2)
    seconds, counts, got = sharded_run("11a", [fq], tmp, two, kmv=True, khf=True, hmh=True)
    path_launches["11a"] = counts
    if got != want_a:
        raise SystemExit("FAIL 11a: the sharded out.json differs from phase 5's")
    if (counts["minimizer_window_packed"] != steps or counts["bin_scatter_keys"] != steps
            or step_launches(counts) != 2 * steps):
        raise SystemExit(f"FAIL 11a: launches {counts}, expected {steps} (batch, shard) steps")
    check_flush_launches("11a", counts, 1, False, stripes=2)
    print(f"11a --kmv --khf --hmh on [{dev}, {dev}]: {READS / seconds:.0f} reads/s "
          f"(phase 5, one device, same card: {READS / t5:.0f} reads/s); out.json "
          f"byte-identical to phase 5's; {steps} (batch, shard) steps, each entry once a "
          f"step", flush=True)

    # 11b: -k 31, the two-sort step in each shard
    steps = shard_steps(fq, 2048, 2)
    with no_host_sync_in_group_step() as groups:
        seconds, counts, got = sharded_run("11b", [fq], tmp, two, kmer_size=31)
    path_launches["11b"] = counts
    if groups[0] <= 0:
        raise SystemExit("FAIL 11b: the shards' group step never ran")
    if got != want_b:
        raise SystemExit("FAIL 11b: the sharded -k 31 out.json differs from phase 6's")
    if (counts["minimizer_window_packed"] != steps or counts["bin_scatter_values"] != steps
            or step_launches(counts) != 2 * steps):
        raise SystemExit(f"FAIL 11b: launches {counts}, expected {steps} (batch, shard) steps")
    check_flush_launches("11b", counts, 1, False, stripes=2)
    print(f"11b -k 31 on [{dev}, {dev}]: {READS / seconds:.0f} reads/s; out.json "
          f"byte-identical to phase 6's; {steps} (batch, shard) steps in {groups[0]} group "
          f"steps, none with a host sync (sync debug mode \"error\")", flush=True)

    # 11c: --deviceFlush with the tables striped over the two entries
    src2 = ",".join(files[:2])
    t_host, _ = sketch_cli(src2, os.path.join(tmp, "11c_host"), "cuda",
                           os.path.join(tmp, "11c_host.log"), ("-i", str(READS)))
    with open(os.path.join(tmp, "11c_host.json"), "rb") as fh:
        want_c = fh.read()
    seconds, counts, got = sharded_run("11c", files[:2], tmp, two, interval=READS,
                                       device_flush=True)
    path_launches["11c"] = counts
    if got != want_c:
        raise SystemExit("FAIL 11c: the striped --deviceFlush out.json differs from the "
                         "one-device run's")
    check_flush_launches("11c", counts, 2, False, stripes=2)
    print(f"11c --deviceFlush -i {READS} over files 0-1 on [{dev}, {dev}]: "
          f"{2 * READS / seconds:.0f} reads/s (one device {2 * READS / t_host:.0f}); "
          f"out.json byte-identical; 2 flushes, each entry once a stripe", flush=True)

    # 11d: two ranks share the card over files 0-3, against one process
    src4 = ",".join(files[:4])
    flags = ["sketch", "-f", src4, "-k", "21", "-s", "42", "--kmv", "--khf", "--hmh",
             "--device", dev.type]
    logs = [os.path.join(tmp, f"11d.rank{r}.log") for r in range(2)]
    wall2 = run_ranks(lambda r: ["-m", "hulk_tpu_torch", *flags, "-o",
                                 os.path.join(tmp, "11d_ranks"), "--log", logs[r]],
                      2, "11d", tmp)
    wall1 = run_ranks(lambda r: ["-m", "hulk_tpu_torch", *flags, "-o",
                                 os.path.join(tmp, "11d_one"), "--log",
                                 os.path.join(tmp, "11d_one.log")], 1, "11d_one", tmp)
    with open(os.path.join(tmp, "11d_ranks.json"), "rb") as x, \
            open(os.path.join(tmp, "11d_one.json"), "rb") as y:
        if x.read() != y.read():
            raise SystemExit("FAIL 11d: the two ranks' out.json differs from one process's")
    texts = []
    for log in logs:
        with open(log) as fh:
            texts.append(fh.read())
    if ("written sketch to disk" not in texts[0] or "written sketch to disk" in texts[1]
            or "output written by process 0" not in texts[1]):
        raise SystemExit("FAIL 11d: rank 0 alone must write out.json")
    for r in range(2):
        if f"process {r}/2 takes 2 of 4 files" not in texts[r]:
            raise SystemExit(f"FAIL 11d: rank {r} did not take two of the four files")
    print(f"11d sketch --kmv --khf --hmh over files 0-3 ({4 * READS} reads): two ranks "
          f"sharing the card {wall2:.3f} s wall, one process {wall1:.3f} s wall (start-up "
          f"included); rank 0's out.json byte-identical to one process's, rank 1 wrote "
          f"nothing", flush=True)

    # 11e: sharded_histogram_step against the fused step on one batch
    R, L = 16384, 160
    codes, lengths, codes2, mask8 = kernel_batch(np.random.default_rng(SEED), R, L, 120, L)
    on = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    wmin, report = minimizer_window_packed(on(codes2), on(mask8), on(lengths), 21, 9)
    skeys, want_count, _ = sorted_batch_keys(wmin, report, k=21, w=9,
                                             bucket=stream_bucket(R, R * L, l=L, k=21, w=9))
    want_hist = torch.zeros(NBINS, dtype=torch.int32, device=dev)
    bin_scatter_keys(want_hist, skeys, 50)
    reset_launches()
    hist, count = mesh.sharded_histogram_step(two, NBINS, 21, 9)(codes, lengths)
    torch.cuda.synchronize()
    counts = read_launches()
    path_launches["11e"] = counts
    if not torch.equal(hist, want_hist) or int(count) != int(want_count):
        raise SystemExit("FAIL 11e: sharded_histogram_step differs from the fused step")
    if counts["jump_hash"] != 2 or counts["minimizer_window"] != 2:
        raise SystemExit(f"FAIL 11e: launches {counts}, expected the u8 minimizer and "
                         f"hulk_jump_hash once a shard")
    print(f"11e sharded_histogram_step on [{dev}, {dev}], one [{R}, {L}] batch: histogram "
          f"and count ({int(count)}) equal to the fused step's; launches {counts}", flush=True)


def host_flushes(hists: list, tables, decay: float):
    """The exact host flush (HistoSketch.add_elements, native) of each
    histogram in turn, the CMS carried."""
    import numpy as np

    from hulk_tpu_torch.sketch.histosketch import HistoSketch

    hs = HistoSketch(21, 42, NBINS, decay, tables=tables)
    for h in hists:
        h = h.cpu().numpy().astype(np.float64)
        ids = np.nonzero(h)[0].astype(np.int64)
        hs.add_elements(ids, h[ids])
    return hs


def check_against_host(tag: str, state, hs) -> None:
    """The step's (cms, sketch, weights) against the host flush: the CMS,
    the bins and the weights bit-equal."""
    import numpy as np

    cms, sk, w = (x.cpu().numpy() for x in state)
    if not np.array_equal(cms.view(np.uint64), hs.cms.sketch.view(np.uint64)):
        raise SystemExit(f"FAIL {tag}: the CMS differs from the host flush's in "
                         f"{int((cms != hs.cms.sketch).sum())} counters")
    if not np.array_equal(sk.astype(np.uint64), hs.sketch):
        raise SystemExit(f"FAIL {tag}: {int((sk.astype(np.uint64) != hs.sketch).sum())} "
                         f"sketch bins differ from the host flush's")
    if not np.array_equal(w.view(np.uint64), hs.sketch_weights.view(np.uint64)):
        raise SystemExit(f"FAIL {tag}: {int((w != hs.sketch_weights).sum())} weights differ "
                         f"from the host flush's")


def aka_entry_times(dev, hist) -> dict:
    """hulk_cws_aka at a flush's shape (s=42, the live bins of hist, the
    counts as estimates, the cached CWS tables): bit-equal to the plain
    version on the card; its device ms a launch (C entry), its bound, and
    the plain version's ms."""
    import torch

    from hulk_tpu_torch.ops import cws_aka_cuda
    from hulk_tpu_torch.ops.cws_aka import cws_aka_torch
    from hulk_tpu_torch.parallel import mesh

    ids = torch.nonzero(hist).flatten()
    n, s = ids.numel(), 42
    esti = hist[ids].double()
    c, b, exp_r = mesh.cached_table_stripes([dev], s, NBINS)[0]
    out = torch.empty(s, n, dtype=torch.float64, device=dev)
    fn, stream = cws_aka_cuda.entry("hulk_cws_aka"), torch.cuda.current_stream().cuda_stream
    ms = device_ms(lambda: fn(esti.data_ptr(), ids.data_ptr(), n, c.data_ptr(), b.data_ptr(),
                              exp_r.data_ptr(), s, NBINS, out.data_ptr(), stream),
                   reps=20, warm=3)
    want = cws_aka_torch(esti, ids, c, b, exp_r)
    check_equal(f"cws_aka at {s} x {n}", out.view(torch.int64), want.view(torch.int64))
    plain_ms = time_ms(lambda: cws_aka_torch(esti, ids, c, b, exp_r), reps=5, warm=1)
    # bytes: c, b, exp_r read and Aka written a (slot, bin), estimate and id
    # a bin; operations: Exp, the subtract, multiply and divide around it
    # (29 FP64 a (slot, bin), a divide as one), Log (25 a bin)
    bd, by = bound(32 * s * n + 16 * n, 29 * s * n + 25 * n, FP64_OPS_PER_S)
    print(f"cws_aka (hulk_cws_aka) {s} x {n} live bins: device {ms:.4f} ms a launch, bound "
          f"{bd:.4f} ms ({by}, {100 * bd / ms:.1f}%), plain {plain_ms:.3f} ms; bit-equal to "
          f"the plain version", flush=True)
    return dict(name="cws_aka", route="cuda", source=cws_aka_cuda.SOURCE,
                replaces="hulk_tpu/parallel/mesh.py:196-315 (XLA exp/log, no Pallas)",
                entry="hulk_cws_aka", counter="cws_aka", max_abs_err=0.0, bit_equal=True,
                ms=ms, plain_ms=plain_ms, plain_shape=f"{s} x {n}, one call", bound_ms=bd,
                bound_by=by, library_ms=None)


def exact_flush_walls(dev, hist, decay: float) -> tuple[list, float]:
    """One flush of hist (-x decay) on a fresh sketch: the card's exact
    flush as the stream runs it (_CardFlusher on [dev], its CMS synced
    back), wall ms of 5, sorted, bit for bit the host flush's; and the
    host flush's ms (HistoSketch.add_elements, native) at one thread, as
    -p 1 runs it."""
    import numpy as np
    import torch

    from hulk_tpu_torch import native
    from hulk_tpu_torch.sketch.histosketch import HistoSketch
    from hulk_tpu_torch.stream.pipeline import _CardFlusher

    walls = []
    for _ in range(5):
        hs = HistoSketch(21, 42, NBINS, decay)
        flusher = _CardFlusher(hs, NBINS, [dev])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flusher.flush_from(hist)
        flusher.sync_cms()
        walls.append((time.perf_counter() - t0) * 1e3)
    h = hist.cpu().numpy().astype(np.float64)
    ids = np.nonzero(h)[0].astype(np.int64)
    host = HistoSketch(21, 42, NBINS, decay)
    native.set_threads(1)
    t0 = time.perf_counter()
    host.add_elements(ids, h[ids])
    host_ms = (time.perf_counter() - t0) * 1e3
    native.set_threads(os.cpu_count() or 1)
    for name in ("sketch", "sketch_weights"):
        if not np.array_equal(getattr(hs, name).view(np.uint64),
                              getattr(host, name).view(np.uint64)):
            raise SystemExit(f"FAIL the card's exact flush: {name} differs from the host's")
    if not np.array_equal(hs.cms.sketch.view(np.uint64), host.cms.sketch.view(np.uint64)):
        raise SystemExit("FAIL the card's exact flush: the CMS differs from the host's")
    return sorted(walls), host_ms


def start_chain_build(tmp: str) -> tuple:
    """Start nvcc on CHAIN_SOURCE (beside the kernels' own build); returns
    the process and the library it writes."""
    from hulk_tpu_torch.ops import _build

    src, so = os.path.join(tmp, "chain.cu"), os.path.join(tmp, "libchain.so")
    with open(src, "w") as fh:
        fh.write(CHAIN_SOURCE)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def chain_times(chain_build, n: int, threads: int, dw: float) -> dict:
    """Device ms of `threads` chains (64 threads a block) of n dependent
    FP64 multiplies ("multiply": the least time of the drift scan's n live
    bins) and of n multiply-adds of +0 ("mul+add": the parent scan's step
    at every bin)."""
    import ctypes

    import torch

    proc, so = chain_build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise SystemExit(f"FAIL nvcc on the multiply chain:\n{log}")
    lib = ctypes.CDLL(so)
    out = torch.empty(threads, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for key, name in (("multiply", "multiply_chain"), ("mul+add", "mul_add_chain")):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong, ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]

        def launch():
            if fn(n, dw, threads, out.data_ptr(), stream) != 0:
                raise SystemExit(f"FAIL the {key} chain did not launch")

        times[key] = device_ms(launch, reps=10, warm=2)
    return times


def drift_bounds(n: int, s: int, depth: int, width: int) -> dict:
    """The drift entries' least times at n live bins. The scan: the counts,
    the int64 row table and the estimates once, the CMS read and written;
    an FP64 multiply a (counter, bin) and an add a (row, bin), where the bin
    hits its counter. The selection: Aka [s, n] and the bins read once; one
    FP64 compare a (slot, bin)."""
    return {"cms_drift_scan": bound(8 * n + 8 * depth * n + 8 * n + 2 * 8 * depth * width,
                                    n * depth * (width + 1), FP64_OPS_PER_S),
            "drift_select": bound(8 * s * n + 8 * n + 4 * 8 * s, s * n, FP64_OPS_PER_S)}


def drift_entry_ms(dev, hist, tables, rb, dw: float, prefix: int | None = None,
                   worst: bool = False) -> dict:
    """Each drift entry's device ms a launch through its C entry (fdc.entry:
    this build's, or another's inside _build.bound), from an empty CMS and
    sketch, over the live bins of hist (its first `prefix`); with `worst`,
    the selection also on Aka strictly decreasing (every bin taken, every
    chunk scanned: "drift_select decreasing"). "out" holds each launch's
    outputs."""
    import numpy as np
    import torch

    from hulk_tpu_torch.ops import flush_drift_cuda as fdc
    from hulk_tpu_torch.ops.cws_aka import cws_aka_torch
    from hulk_tpu_torch.sketch.countmin import cms_shape

    ids = torch.nonzero(hist).flatten()[:prefix]
    n, (depth, width), s = ids.numel(), cms_shape(), tables.c.shape[0]
    freqs, rows = hist[ids].double(), rb[:, ids].contiguous()
    cms0 = torch.zeros(depth, width, dtype=torch.float64, device=dev)
    cms_out = torch.empty_like(cms0)
    est_rows = torch.empty(depth, n, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    scan = fdc.entry("hulk_cms_drift_scan")
    res = {"cms_drift_scan": device_ms(
        lambda: scan(freqs.data_ptr(), rows.data_ptr(), n, cms0.data_ptr(), cms_out.data_ptr(),
                     depth, width, dw, est_rows.data_ptr(), stream), reps=10, warm=2)}
    res["out"] = {"CMS": cms_out, "estimates": est_rows}
    akas = {"drift_select": cws_aka_torch(est_rows.amin(0), torch.arange(n, device=dev), *(
        torch.tensor(np.ascontiguousarray(t[:, ids.cpu().numpy()]), device=dev)
        for t in (tables.c, tables.b, tables.exp_r)))}
    if worst:
        akas["drift_select decreasing"] = torch.from_numpy(
            np.geomspace(1.0, 1e-6, n)[None, :] * (1.0 + np.arange(s))[:, None]).to(dev)
    sk0 = torch.zeros(s, dtype=torch.int64, device=dev)
    w0 = torch.full((s,), np.finfo(np.float64).max, dtype=torch.float64, device=dev)
    chunk = fdc.SELECT_CHUNK
    chunk_min = torch.empty(s, -(-n // chunk), dtype=torch.float64, device=dev)
    select = fdc.entry("hulk_drift_select")
    for key, aka in akas.items():
        sk_out, w_out = torch.empty_like(sk0), torch.empty_like(w0)
        res[key] = device_ms(lambda: select(aka.data_ptr(), ids.data_ptr(), n, s, dw,
                                            sk0.data_ptr(), w0.data_ptr(), sk_out.data_ptr(),
                                            w_out.data_ptr(), chunk_min.data_ptr(), chunk,
                                            stream), reps=10, warm=2)
        res["out"][f"{key} bins"], res["out"][f"{key} weights"] = sk_out, w_out
    return res


def drift_corner_checks(dev, dw: float) -> None:
    """The two drift entries against their plain versions on the card on
    synth's corner cases of their designs (the scan's warp layout, tile
    edges and a CMS carried in; the selection's chunk skip, with ties at
    the threshold, +inf, NaN, Aka strictly decreasing, a carried sketch that
    takes nothing and a walk past 32 chunks): the CMS, the estimates, the
    bins and the weights bit-equal."""
    import numpy as np
    import torch

    from hulk_tpu_torch.ops import flush_drift as fd
    from hulk_tpu_torch.ops import flush_drift_cuda as fdc
    from hulk_tpu_torch.synth import drift_scan_cases, drift_select_cases

    def bits(x):
        return x.view(torch.int64)

    for case, hist, table, cms in drift_scan_cases(np.random.default_rng(SEED)):
        ids = np.flatnonzero(hist)
        freqs = torch.from_numpy(hist[ids].astype(np.float64)).to(dev)
        rows = torch.from_numpy(np.ascontiguousarray(table[:, ids])).to(dev)
        cms = torch.from_numpy(cms).to(dev)
        want = fd.cms_drift_scan_torch(freqs, rows, cms, dw)
        got = fdc.cms_drift_scan_cuda(freqs, rows, cms, dw)
        check_equal(f"cms_drift_scan CMS, {case}", bits(got[0]), bits(want[0]))
        check_equal(f"cms_drift_scan estimates, {case}", bits(got[1]), bits(want[1]))
    for case, aka, sk, w in drift_select_cases(np.random.default_rng(SEED), dw):
        args = [torch.from_numpy(x).to(dev) for x in
                (aka, 5 * np.arange(aka.shape[1], dtype=np.int64) + 3, sk, w)]
        want = fd.drift_select_torch(*args, dw)
        got = fdc.drift_select_cuda(*args, dw)
        check_equal(f"drift_select bins, {case}", got[0], want[0])
        check_equal(f"drift_select weights, {case}", bits(got[1]), bits(want[1]))
    print("drift entries on synth's corner cases: bit-equal to the plain versions", flush=True)


def drift_checks(dev, case: str, hist, tables, row_bins, dw: float,
                 prefix: int | None = None) -> dict:
    """The two drift entries against their plain versions on the card, from
    an empty CMS and sketch, over the live bins of hist (its first `prefix`
    of them): the CMS, the estimates, the bins and the weights bit-equal.
    Returns the plain versions' milliseconds (CUDA events around one call)
    and the largest differences (0)."""
    import numpy as np
    import torch

    from hulk_tpu_torch.ops import flush_drift as fd
    from hulk_tpu_torch.ops import flush_drift_cuda as fdc
    from hulk_tpu_torch.ops.cws_aka import cws_aka_torch
    from hulk_tpu_torch.sketch.countmin import cms_shape

    ids = torch.nonzero(hist).flatten()[:prefix]
    freqs, rows = hist[ids].double(), row_bins[:, ids].contiguous()
    cms = torch.zeros(*cms_shape(), dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    cms_p, esti_p = fd.cms_drift_scan_torch(freqs, rows, cms, dw)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3
    cms_k, esti_k = fdc.cms_drift_scan_cuda(freqs, rows, cms, dw)
    check_equal(f"cms_drift_scan CMS, {case}", cms_k, cms_p)
    check_equal(f"cms_drift_scan estimates, {case}", esti_k, esti_p)
    c, b, exp_r = (torch.tensor(np.ascontiguousarray(t[:, ids.cpu().numpy()]), device=dev)
                   for t in (tables.c, tables.b, tables.exp_r))
    aka = cws_aka_torch(esti_p, torch.arange(ids.numel(), device=dev), c, b, exp_r)
    s = aka.shape[0]
    sk = torch.zeros(s, dtype=torch.int64, device=dev)
    w = torch.full((s,), np.finfo(np.float64).max, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    want = fd.drift_select_torch(aka, ids, sk, w, dw)
    torch.cuda.synchronize()
    select_ms = (time.perf_counter() - t0) * 1e3
    got = fdc.drift_select_cuda(aka, ids, sk, w, dw)
    check_equal(f"drift_select bins, {case}", got[0], want[0])
    check_equal(f"drift_select weights, {case}", got[1], want[1])
    print(f"drift entries on {case} ({ids.numel()} live bins, s={s}): bit-equal to the "
          f"plain versions (plain scan {scan_ms:.1f} ms, plain selection {select_ms:.1f} ms, "
          f"one call each)", flush=True)
    return dict(n=ids.numel(), scan_ms=scan_ms, select_ms=select_ms,
                err=max(max_abs_err(cms_k, cms_p), max_abs_err(esti_k, esti_p),
                        max_abs_err(got[1], want[1])))


def flush_step_phase(fq: str, dev, path_launches: dict,
                     chain_build) -> tuple[list, list]:
    """Phase 12: sharded_flush_step at full width (k=21, s=42, 194,481 bins,
    CMS 7 x 2,000) over two interval flushes of phase 3's halves, without
    drift (12a) and with -x 0.9 through the drift kernels (12b); entry()'s
    step on the card (12c); dryrun_multichip(2) on the card (12d), each
    against the CPU. Returns the device stages and the drift entries'
    kernel rows."""
    import numpy as np
    import torch

    from hulk_tpu_torch import entry as entry_mod
    from hulk_tpu_torch.hashes.cws import get_cws_tables
    from hulk_tpu_torch.hashes.fdlibm import go_exp
    from hulk_tpu_torch.ops import flush_drift_cuda as fdc
    from hulk_tpu_torch.parallel import mesh
    from hulk_tpu_torch.sketch.countmin import cms_row_bins_table, cms_shape

    cpu = torch.device("cpu")
    halves = fq_histograms(fq, dev, READS // 2)
    tables = get_cws_tables(42, NBINS)
    depth, width = cms_shape()
    rb = torch.from_numpy(cms_row_bins_table(NBINS, depth, width).astype(np.int64)).to(dev)
    live = [int((h != 0).sum()) for h in halves]

    def empty():
        return (torch.zeros(depth, width, dtype=torch.float64, device=dev),
                torch.zeros(42, dtype=torch.int64, device=dev),
                torch.full((42,), np.finfo(np.float64).max, dtype=torch.float64, device=dev))

    def flushes(devs, dw: float, drift: bool):
        step = mesh.sharded_flush_step(devs, dw, drift, depth, width)
        stripes = mesh.shard_tables(devs, tables)
        state = empty()
        for h in halves:
            state = step(h, rb, *state, stripes)
        torch.cuda.synchronize()
        return state, step, stripes

    # 12a: no drift, 2 stripes against 1 and against the host flush
    reset_launches()
    two, step2, stripes2 = flushes([dev, dev], 0.0, False)
    path_launches["12a"] = read_launches()
    check_flush_launches("12a", path_launches["12a"], 2, False, stripes=2)
    one, _, _ = flushes([dev], 0.0, False)
    for x, y, name in zip(two, one, ("cms", "sketch", "weights")):
        check_equal(f"12a two stripes' {name} against one stripe's",
                    x.view(torch.int64) if x.is_floating_point() else x,
                    y.view(torch.int64) if y.is_floating_point() else y)
    check_against_host("12a sharded_flush_step, no drift", two, host_flushes(halves, tables, 1.0))
    stage_ms = profiled_device_ms(lambda: step2(halves[0], rb, *empty(), stripes2),
                                  tag="sharded_flush_step, no drift, 2 stripes")
    b12 = flush_step_bound(depth, width)
    print(f"12a sharded_flush_step, no drift, on [{dev}, {dev}]: two flushes of phase 3's "
          f"halves ({live[0]} and {live[1]} bins used of {NBINS}, s=42): CMS, bins and "
          f"weights bit-equal to the host flush's; 2 stripes bit-equal to 1; {stage_ms:.4f} "
          f"ms device time a flush (bound {b12[0]:.4f} ms by {b12[1]})", flush=True)
    stage = dict(name="sharded_flush_step", source="hulk_tpu_torch/parallel/mesh.py",
                 counterpart="hulk_tpu/parallel/mesh.py:237-269", ms=stage_ms,
                 bound_ms=b12[0], bound_by=b12[1], launches=2,
                 shape=f"nbins={NBINS} s=42 depth={depth} width={width}, 2 stripes")

    # 12b: drift, the entries against their plain versions, then the flush
    dw = float(go_exp(-DRIFT))
    nbins9 = 9 ** 4
    rng = np.random.default_rng(SEED)
    hist9 = torch.from_numpy(np.where(rng.random(nbins9) < 0.5, rng.integers(1, 300, nbins9),
                                      0).astype(np.int32)).to(dev)
    rb9 = torch.from_numpy(cms_row_bins_table(nbins9, depth, width).astype(np.int64)).to(dev)
    drift_checks(dev, "a k=9 histogram", hist9, get_cws_tables(42, nbins9), rb9, dw)
    pre = drift_checks(dev, f"the first {DRIFT_PREFIX} live bins of phase 3's first half",
                       halves[0], tables, rb, dw, DRIFT_PREFIX)
    drift_corner_checks(dev, dw)
    reset_launches()
    drifted, step_d, stripes_d = flushes([dev, dev], dw, True)
    path_launches["12b"] = counts = read_launches()
    check_flush_launches("12b", counts, 2, True, stripes=2)
    check_against_host("12b sharded_flush_step, -x 0.9", drifted,
                       host_flushes(halves, tables, DRIFT))
    walls = wall_ms(lambda: step_d(halves[0], rb, *empty(), stripes_d))
    drift_dev_ms = profiled_device_ms(
        lambda: step_d(halves[0], rb, *empty(), stripes_d),
        tag="sharded_flush_step, -x 0.9, 2 stripes",
        expect={"cms_drift_scan_kernel": 1, "cws_aka_kernel": 2, "chunk_min_kernel": 2,
                "drift_select_kernel": 2})
    # each entry's device time by its C entry at the first flush's shape and
    # on the plain versions' prefix; the scan's chains of multiplies and of
    # multiply-adds
    n = live[0]
    full = drift_entry_ms(dev, halves[0], tables, rb, dw, worst=True)
    at_pre = drift_entry_ms(dev, halves[0], tables, rb, dw, DRIFT_PREFIX)
    bounds = drift_bounds(n, 42, depth, width)
    chains = chain_times(chain_build, n, depth * width, dw)
    mul_ms = chains["multiply"]
    print(f"12b sharded_flush_step, -x 0.9, on [{dev}, {dev}]: two flushes, CMS, bins and "
          f"weights bit-equal to the host flush's (HistoSketch(decay=0.9)); launches "
          f"{counts}; one flush {walls[2]:.3f} ms wall (median of 5, "
          f"{walls[0]:.3f}-{walls[-1]:.3f}), {drift_dev_ms:.4f} ms device", flush=True)
    for decay in (DRIFT, 1.0):
        card, host_ms = exact_flush_walls(dev, halves[0], decay)
        print(f"12b the exact flush as the stream runs it (_CardFlusher, one stripe, -x "
              f"{decay}), {live[0]} live bins: {card[2]:.3f} ms wall (median of 5, "
              f"{card[0]:.3f}-{card[-1]:.3f}), bit for bit the host flush's, which took "
              f"{host_ms:.1f} ms at one thread", flush=True)
    for key, ms in chains.items():
        print(f"{key} chain: {depth * width} threads of {n} dependent FP64 steps, "
              f"{ms:.4f} ms device ({1e6 * ms / n:.3f} ns a step)", flush=True)
    rows_out = [aka_entry_times(dev, halves[0])]
    for name, entry, plain_ms in (("cms_drift_scan", "hulk_cms_drift_scan", pre["scan_ms"]),
                                  ("drift_select", "hulk_drift_select", pre["select_ms"])):
        (bd, by), ms = bounds[name], full[name]
        chain = dict(chain_bound_ms=mul_ms, mul_add_chain_ms=chains["mul+add"],
                     binds="chain" if mul_ms > bd else by) \
            if name == "cms_drift_scan" else {}
        binding = (f", the multiply chain {mul_ms:.4f} ms ({100 * mul_ms / ms:.1f}%), the "
                   f"mul+add chain {chains['mul+add']:.4f} ms") if chain else ""
        print(f"{name} ({entry}) n={n} live bins, s=42: device {ms:.4f} ms a launch "
              f"({1e6 * ms / n:.2f} ns a live bin), bound {bd:.4f} ms ({by}, "
              f"{100 * bd / ms:.1f}%){binding}; on the first {pre['n']} live bins "
              f"{at_pre[name]:.4f} ms, plain {plain_ms:.1f} ms ({plain_ms * n / pre['n']:.1f} "
              f"ms scaled to {n} bins)"
              + (f"; on Aka strictly decreasing {full['drift_select decreasing']:.4f} ms"
                 if name == "drift_select" else ""), flush=True)
        rows_out.append(dict(
            name=name, route="cuda", source=fdc.SOURCE,
            replaces="hulk_tpu/parallel/mesh.py:271-296 (lax.scan, no Pallas)", entry=entry,
            counter=name, max_abs_err=pre["err"], bit_equal=True, ms=ms, plain_ms=plain_ms,
            plain_shape=f"the first {pre['n']} live bins of phase 3's first half, one call",
            ms_at_plain_shape=at_pre[name], bound_ms=bd, bound_by=by, **chain,
            **({"chunk": fdc.SELECT_CHUNK, "decreasing_aka_ms": full["drift_select decreasing"]}
               if name == "drift_select" else {}),
            library_ms=None))

    # 12c: entry()'s step on the card against the CPU, then at the
    # production batch
    totals = dict.fromkeys(read_launches(), 0)
    fn, (hist0, codes0, lengths0) = entry_mod.entry(dev)
    big = entry_mod.example_batch(*PRODUCTION[:2])
    for codes, lengths in ((codes0, lengths0), (big.codes, big.lengths)):
        r, l = codes.shape
        args = (torch.zeros_like(hist0), torch.as_tensor(codes).to(dev),
                torch.as_tensor(lengths).to(dev))
        cargs = tuple(a.cpu() for a in args)
        reset_launches()
        hist, count = fn(*args)
        torch.cuda.synchronize()
        counts = read_launches()
        if counts["minimizer_window"] != 1 or counts["jump_hash"] != 1 \
                or sum(counts.values()) != 2:
            raise SystemExit(f"FAIL 12c: launches {counts}, expected the u8 minimizer and "
                             f"hulk_jump_hash once each")
        totals = {key: totals[key] + counts[key] for key in totals}
        chist, ccount = fn(*cargs)
        if not torch.equal(hist.cpu(), chist) or int(count) != int(ccount):
            raise SystemExit(f"FAIL 12c: entry()'s fn on [{r}, {l}] differs card vs CPU")
        print(f"12c entry()'s fn on [{r}, {l}]: histogram and count ({int(count)}) equal card "
              f"vs CPU; launches {counts}", flush=True)
    path_launches["12c"] = totals

    # 12d: dryrun_multichip(2) on the card against the CPU named twice
    reset_launches()
    got = entry_mod.dryrun_multichip(2)
    path_launches["12d"] = read_launches()
    want = entry_mod.dryrun_multichip(2, devices=[cpu, cpu])
    if (got.count != want.count or not np.array_equal(got.sketch, want.sketch)
            or not np.allclose(got.weights, want.weights, rtol=1e-12, atol=0.0)
            or got.result.hulk_data.to_json_bytes() != want.result.hulk_data.to_json_bytes()):
        raise SystemExit("FAIL 12d: dryrun_multichip(2) differs card vs CPU")
    print(f"12d dryrun_multichip(2) on {[str(d) for d in got.devices]}: count ({got.count}), "
          f"flush bins, weights (rtol 1e-12) and the pipeline's out.json equal to "
          f"[cpu, cpu]'s; launches {path_launches['12d']}", flush=True)
    return [stage], rows_out


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
    from hulk_tpu_torch.stream.watchdog import DEADLINE_S, probe_device_roundtrip
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
            chain_build = start_chain_build(tmp)
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
            ok, dt = probe_device_roundtrip(DEADLINE_S, device=dev)
            if not ok:
                raise SystemExit(f"FAIL watchdog probe: no answer from {dev} in "
                                 f"{DEADLINE_S:.0f} s")
            print(f"watchdog probe (16 elements to {dev} and back): {dt:.4f} s", flush=True)

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
                    or step_launches(counts) != 2 * batches):
                raise SystemExit(f"FAIL main path: minimizers {n_min}, launches {counts}")
            check_flush_launches("main path", counts, 1, False)

        with phase("3b profile"):
            profile_phase(fq, tmp)

        small = os.path.join(tmp, "first50k.fq.gz")
        with phase("4 equality"):
            head_records(fq, small, SUBSET_READS, b"@")
            check_sketch(card_vs_cpu(f"first {SUBSET_READS} reads", small, tmp), 42)

        with phase("5 sketches (a)"):
            flags = ("--kmv", "--khf", "--hmh")
            seconds, n_min, counts = drive("sketches", fq, tmp, flags)
            t5 = seconds
            path_launches["5"] = counts
            check_sketch(os.path.join(tmp, "sketches.json"), 42,
                         algos=("histosketch", "kmv", "khf", "hyperminhash"))
            print(f"sketch --kmv --khf --hmh {READS} reads: {READS / seconds:.0f} reads/s",
                  flush=True)
            if (counts["minimizer_window_packed"] != batches
                    or counts["bin_scatter_keys"] != batches
                    or step_launches(counts) != 2 * batches):
                raise SystemExit(f"FAIL sketches path: launches {counts}, {batches} batches")
            check_flush_launches("sketches path", counts, 1, False)
            profiled("sketches", fq, tmp, flags)
            card_vs_cpu(f"sketches, first {SUBSET_READS} reads", small, tmp, flags)

        with phase("6 two-sort (b)"):
            flags = ("-k", "31", "-w", "9", "-s", "42")
            t0 = time.perf_counter()
            get_cws_tables(42, NBINS_K31)
            print(f"CWS tables s=42 d={NBINS_K31}: {time.perf_counter() - t0:.2f} s", flush=True)
            with no_host_sync_in_group_step() as steps:
                seconds, n_min, counts = drive("two_sort", fq, tmp, flags)
            path_launches["6"] = counts
            if steps[0] <= 0:
                raise SystemExit("FAIL two-sort path: the group step never ran")
            print(f"two-sort: {steps[0]} group steps under sync debug mode \"error\": no "
                  f"host sync", flush=True)
            check_sketch(os.path.join(tmp, "two_sort.json"), 42, k=31)
            print(f"sketch -k 31 {READS} reads: {READS / seconds:.0f} reads/s", flush=True)
            n2 = counts["minimizer_window_packed"]
            if (n_min <= 0 or n2 < -(-READS // 2048) or counts["bin_scatter_values"] != n2
                    or step_launches(counts) != 2 * n2):
                raise SystemExit(f"FAIL two-sort path: launches {counts}")
            check_flush_launches("two-sort path", counts, 1, False)
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
            n_rec, n_long = expected_long_launches(lengths, 21, 9)
            print(f"sketch --fasta: {lengths.sum() / seconds / 1e6:.3f} Mb/s; "
                  f"{n_long} long contigs, {n_rec} record scans", flush=True)
            # each long contig: one record scan a chunk, one dedup binning
            # launch; the u8 and cont entries no longer run on this path
            if (n_min <= 0 or counts["minimizer_record"] != n_rec
                    or counts["bin_scatter_values_dedup"] != n_long
                    or counts["minimizer_window"] or counts["minimizer_window_cont"]
                    or counts["minimizer_window_packed"] <= 0
                    or counts["bin_scatter_keys"] != counts["minimizer_window_packed"]
                    or counts["bin_scatter_values"] or counts["jump_hash"]):
                raise SystemExit(f"FAIL FASTA path: launches {counts}, expected record "
                                 f"{n_rec}, dedup binning {n_long}")
            check_flush_launches("FASTA path", counts, 1, False)
            sub = os.path.join(tmp, "first_contigs.fa")
            head_records(fa, sub, SUBSET_CONTIGS, b">")
            label = (f"FASTA, first {SUBSET_CONTIGS} contigs "
                     f"({int(lengths[:SUBSET_CONTIGS].sum())} bases)")
            card_vs_cpu(label, sub, tmp, flags)
            card_vs_cpu(f"{label}, -k 31 --kmv --khf --hmh", sub, tmp,
                        ("--fasta", "-w", "9", "-k", "31", "--kmv", "--khf", "--hmh"))
            profiled("fasta_subset", sub, tmp, flags)
            long_read_times(sub)

        with phase("8 intervals (d)"):
            files = interval_phase(fq, small, tmp, path_launches)

        with phase("9 smash (e)"):
            stages = smash_phase(tmp)

        with phase("10 LSH (f)"):
            stages += lsh_phase(tmp, dev)

        with phase("11 sharded sketch (g)"):
            sharded_phase(fq, files, tmp, dev, path_launches, t5)

        with phase("12 flush step and entry points"):
            more, drift_rows = flush_step_phase(fq, dev, path_launches, chain_build)
            stages += more
            rows.update((r["name"], r) for r in drift_rows)
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
