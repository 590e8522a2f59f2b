#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hulk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: the card's name, count and power limit; build the CUDA kernels
     (one nvcc process per source, started together, and a link into one
     library) and the native host runtime (g++); print each build's seconds
     and ptxas's register/spill lines.
  2. kernels: each of the four kernel entries against its plain PyTorch
     version on the card, at the main path's shapes (with random pad past
     each read) and on corner cases; all must be bit-equal. Each entry's
     device time (50 launches queued through its C entry, one event pair)
     beside its bound, and the plain version's time (CUDA events around one
     call, median of 20 after 3 warm-ups).
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
Then one JSON line of kernels, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failure ends the run with a non-zero exit
code and no result line. Nothing is written into the repository except the
gitignored kernel build directory; the reads and outputs live in a temporary
directory that is removed at the end.
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
# update, canonical pick, hash64, span, sliding minimum), each two int32 ops
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


def minimizer_checks(rng, dev) -> dict:
    """Both minimizer entries against their plain versions on every case;
    at the production shape, their device times beside their bounds."""
    import torch

    from hulk_tpu_torch.ops import minimizer_cuda as mc
    from hulk_tpu_torch.ops.minimizer import (minimizer_window_packed_torch,
                                              minimizer_window_torch, unpack_codes2)
    from hulk_tpu_torch.synth import kernel_batch

    out = {}
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
        if (R, L, k, w) != PRODUCTION:
            continue
        # the main path's batch: the binning pass's keys come from it too
        out["batch"] = (pm, prep)
        stream = torch.cuda.current_stream().cuda_stream
        f_u8, f_pk = mc.entry("hulk_minimizer_window"), mc.entry("hulk_minimizer_window_packed")
        a_u8 = (c.data_ptr(), ln.data_ptr(), R, L, k, w, wm.data_ptr(), rep.data_ptr(), stream)
        a_pk = (c2.data_ptr(), m8.data_ptr(), ln.data_ptr(), R, L, k, w, pm.data_ptr(),
                prep.data_ptr(), stream)
        ops = 2 * MIN_U64_OPS_PER_POS * R * L
        out["packed"] = dict(
            ms=device_ms(lambda: f_pk(*a_pk)),
            plain_ms=time_ms(lambda: minimizer_window_packed_torch(c2, m8, ln, k, w)),
            bound=bound(R * (L // 4 + L // 8 + 4) + 9 * R * L, ops, INT32_OPS_PER_S),
            err=max(max_abs_err(pm, pm0), max_abs_err(prep, prep0)), shape=tag)
        out["u8"] = dict(
            ms=device_ms(lambda: f_u8(*a_u8)),
            plain_ms=time_ms(lambda: minimizer_window_torch(c, ln, k, w)),
            bound=bound(R * (L + 4) + 9 * R * L, ops, INT32_OPS_PER_S), shape=tag)
        out["unpack_ms"] = time_ms(lambda: unpack_codes2(c2, m8, ln))
        if f_pk(*a_pk) != 0 or f_u8(*a_u8) != 0:
            raise SystemExit("FAIL minimizer_window: a timed launch was refused")
        torch.cuda.synchronize()
    return out


def jump_checks(rng, dev, batch) -> dict:
    """Both jump entries against their plain versions: the binning pass on
    the production batch's sorted keys and on synthetic sorted keys (mixed,
    all sentinel, one key repeated) at n = 194,481 and 2^31 - 1; the
    buckets-only entry on random and adversarial keys. Device times at the
    production batch beside their bounds."""
    import numpy as np
    import torch

    from hulk_tpu_torch.hashes.jumphash import jump_hash_torch
    from hulk_tpu_torch.ops import jump_cuda as jc
    from hulk_tpu_torch.ops.device_step import (bin_scatter_keys_torch,
                                                sorted_batch_keys, stream_bucket)
    from hulk_tpu_torch.synth import sorted_keys

    R, L, k, w = PRODUCTION
    vbits, n = 2 * k + 8, NBINS
    bucket = stream_bucket(R, R * L, l=L, k=k, w=w)
    skeys, _ = sorted_batch_keys(*batch, k=k, w=w, bucket=bucket)
    N = skeys.numel()
    hist = torch.zeros(n, dtype=torch.int32, device=dev)
    hist0 = torch.zeros_like(hist)
    jc.bin_scatter_keys_cuda(hist, skeys, vbits)
    bin_scatter_keys_torch(hist0, skeys, vbits)
    check_equal(f"bin_scatter_keys production batch N={N} n={n}", hist, hist0)
    err = max_abs_err(hist, hist0)
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

    live = skeys != -1
    live[1:] &= skeys[1:] != skeys[:-1]
    values = torch.where(live, skeys & ((1 << vbits) - 1), 0)
    got = jc.jump_hash_cuda(values, n)
    want = jump_hash_torch(values, n)
    check_equal(f"jump_hash production values N={N} n={n}", got, want)
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
    a_bin = (skeys.data_ptr(), N, vbits, hist.data_ptr(), n, stream)
    a_jump = (values.data_ptr(), N, n, got.data_ptr(), stream)
    iters_live = jump_iterations(values[live], n)
    iters_all = jump_iterations(values, n)
    bins64, ones = got.long(), live.int()
    out = {
        "fused": dict(ms=device_ms(lambda: f_bin(*a_bin)),
                      plain_ms=time_ms(lambda: bin_scatter_keys_torch(hist0, skeys, vbits)),
                      bound=bound(8 * N + 2 * 4 * n, 2 * iters_live, FP64_OPS_PER_S),
                      err=err, shape=f"N={N} n={n} ({int(live.sum())} live distinct "
                                     f"keys, {iters_live} loop iterations)"),
        "buckets": dict(ms=device_ms(lambda: f_jump(*a_jump)),
                        plain_ms=time_ms(lambda: jump_hash_torch(values, n)),
                        bound=bound(12 * N, 2 * iters_all, FP64_OPS_PER_S),
                        shape=f"N={N} n={n} ({iters_all} loop iterations)"),
        "index_add_ms": device_ms(lambda: hist0.index_add_(0, bins64, ones)),
    }
    if f_bin(*a_bin) != 0 or f_jump(*a_jump) != 0:
        raise SystemExit("FAIL jump_hash: a timed launch was refused")
    torch.cuda.synchronize()
    return out


def kernel_phase(rng, dev) -> dict:
    mins = minimizer_checks(rng, dev)
    jumps = jump_checks(rng, dev, mins.pop("batch"))
    for name, r in (("minimizer_window packed", mins["packed"]),
                    ("minimizer_window u8", mins["u8"]),
                    ("bin_scatter_keys (fused jump)", jumps["fused"]),
                    ("jump_hash buckets only", jumps["buckets"])):
        print(f"{name} {r['shape']}: device {r['ms']:.4f} ms a launch, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{100 * r['bound'][0] / r['ms']:.1f}% of bound", flush=True)
    print(f"unpack_codes2 (plain, the pass the packed entry replaces): "
          f"{mins['unpack_ms']:.4f} ms; index_add_ of the production batch: "
          f"device {jumps['index_add_ms']:.4f} ms", flush=True)
    rows = {}
    for name, src, rep, entry, r in (
            ("minimizer_window", "minimizer_window.cu", "minimizer_pallas.py:223",
             "hulk_minimizer_window_packed", mins["packed"]),
            ("jump_hash", "jump_hash.cu", "jump_pallas.py:284", "hulk_bin_scatter_keys",
             jumps["fused"])):
        rows[name] = dict(
            name=name, route="cuda", source=f"hulk_tpu_torch/csrc/{src}",
            replaces=f"hulk_tpu/ops/{rep}", entry=entry, max_abs_err=r["err"],
            bit_equal=True, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=None)
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


def sketch_cli(fq: str, out: str, device: str, log_path: str) -> tuple[float, int]:
    """Run the port's CLI; return (seconds, minimizer count from its log)."""
    from hulk_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(["sketch", "-f", fq, "-k", "21", "-s", "42", "-o", out,
                   "--device", device, "--log", log_path])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"FAIL sketch on {device}: exit code {rc}")
    with open(log_path) as fh:
        found = re.findall(r"found (\d+) minimizers", fh.read())
    if not found:
        raise SystemExit(f"FAIL sketch on {device}: no minimizer count in the log")
    return seconds, int(found[-1])


def check_sketch(path: str, s: int) -> None:
    """The out.json loads through the port's own reader (envelope, version
    and MD5 checks) and holds one k=21 histosketch of s finite weights."""
    import numpy as np

    from hulk_tpu_torch.io.sketchio import load_hulk_data

    data = load_hulk_data(path)
    sk = data.find_sketch(21, "histosketch")
    if sk.mins.shape != (s,) or sk.weights.shape != (s,):
        raise SystemExit(f"FAIL {path}: expected {s} mins and weights")
    if not np.isfinite(sk.weights).all() or (sk.mins >= 21 ** 4).any():
        raise SystemExit(f"FAIL {path}: non-finite weights or bins out of range")


def profile_phase(fq: str, tmp: str) -> None:
    """Warm passes over fq: parse alone, `sketch`, and `sketch` profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hulk_tpu_torch.stream.fastq import batch_reads_native

    t0 = time.perf_counter()
    n = sum(int((b.lengths > 0).sum())
            for b in batch_reads_native([fq], batch_size=16384, raw=True))
    t_parse = time.perf_counter() - t0
    print(f"parse alone: {n} reads in {t_parse:.3f} s = {n / t_parse:.0f} reads/s", flush=True)
    t_run, _ = sketch_cli(fq, os.path.join(tmp, "warm"), "cuda", os.path.join(tmp, "warm.log"))
    print(f"sketch, warm: {t_run:.3f} s = {READS / t_run:.0f} reads/s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prof, _ = sketch_cli(fq, os.path.join(tmp, "prof"), "cuda",
                               os.path.join(tmp, "prof.log"))
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(f"sketch, profiled: wall {t_prof:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / t_prof:.1f}% of wall; idle {100 - 100 * busy / t_prof:.1f}%)",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=10), flush=True)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                "minimizer_window_kernel" in e.key or "jump_kernel" in e.key):
            print(f"profiled kernel {e.key}: {e.count} launches, "
                  f"{e.self_device_time_total / e.count:.1f} us a launch", flush=True)
    if any("index_add" in e.key for e in events):
        raise SystemExit("FAIL profile: index_add_ ran on the main path")


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
    from hulk_tpu_torch.ops import _build, jump_cuda, minimizer_cuda
    from hulk_tpu_torch.synth import generate

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="hulk_chip_smoke_")
    os.environ.setdefault("HULK_TPU_TORCH_CACHE", os.path.join(tmp, "cache"))
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
            for d in (minimizer_cuda.launches, jump_cuda.launches):
                d.update(dict.fromkeys(d, 0))
            seconds, n_min = sketch_cli(fq, os.path.join(tmp, "full"), "cuda",
                                        os.path.join(tmp, "full.log"))
            counts = {**minimizer_cuda.launches, **jump_cuda.launches}
            check_sketch(os.path.join(tmp, "full.json"), 42)
            print(f"sketch {READS} reads on {kind}: {seconds:.3f} s, "
                  f"{READS / seconds:.0f} reads/s, {n_min} minimizers, "
                  f"launches {counts}", flush=True)
            # the main path's entries: the packed minimizer and the fused
            # binning pass, once per batch each
            launches = {"minimizer_window": counts["minimizer_window_packed"],
                        "jump_hash": counts["bin_scatter_keys"]}
            if (n_min <= 0 or min(launches.values()) <= 0
                    or launches["minimizer_window"] != launches["jump_hash"]):
                raise SystemExit(f"FAIL main path: minimizers {n_min}, launches {counts}")

        with phase("3b profile"):
            profile_phase(fq, tmp)

        with phase("4 equality"):
            small = os.path.join(tmp, "first50k.fq.gz")
            with gzip.open(fq, "rb") as src, gzip.open(small, "wb", compresslevel=1) as dst:
                dst.writelines(itertools.islice(src, 4 * 50_000))
            t_gpu, _ = sketch_cli(small, os.path.join(tmp, "gpu"), "cuda",
                                  os.path.join(tmp, "gpu.log"))
            t_cpu, _ = sketch_cli(small, os.path.join(tmp, "cpu"), "cpu",
                                  os.path.join(tmp, "cpu.log"))
            with open(os.path.join(tmp, "gpu.json"), "rb") as a, \
                    open(os.path.join(tmp, "cpu.json"), "rb") as b:
                if a.read() != b.read():
                    raise SystemExit("FAIL out.json differs between the card and the CPU")
            check_sketch(os.path.join(tmp, "gpu.json"), 42)
            print(f"50,000 reads: out.json byte-identical (card {t_gpu:.3f} s, "
                  f"cpu {t_cpu:.3f} s)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [dict(r, launches=launches[name]) for name, r in rows.items()]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
