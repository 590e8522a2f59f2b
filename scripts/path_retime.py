#!/usr/bin/env python3
"""Time one path of two trees of the port in turns on one card.

    rm -rf build/parent && mkdir -p build/parent
    git archive <commit> | tar -x -C build/parent --exclude=.jax_cache
    python3 scripts/path_retime.py --workload longread --other build/parent
    python3 scripts/path_retime.py --workload two-sort --rounds 5 --other build/parent

Generates the workload's input (seed 0), then runs one child process a
turn, `--rounds` times in the order other, this, this, other (two pairs a
round). Each child imports hulk_tpu_torch from its tree (building that
tree's kernels) and times, at w=9, s=42:
  * longread: one FASTA file of synthetic contigs (synth.generate_fasta:
    300 contigs of 1-200 kb, 1% N), k=21. Each long record of the file
    (65,536 bases or more) through the work that tree's pipeline does for
    one: a tree with ops/longread.py long_read_step runs it into a device
    histogram and count; an older tree runs long_read_minimizers on the
    card and the host spectrum's add_hashes, as its pipeline did. Host
    clock to a synchronize, the first record left out as a warm-up; ms a
    record. Then `sketch --fasta` end to end over the file: Mb/s.
  * two-sort: 1,000,000 reads of 150 bp (gzip FASTQ, as chip_smoke.py
    phase 3), k=31 (923,521 bins; R = 2048, the two-sort step). One group
    of the stream (16 batches, packed and copied as the stream ships it)
    through ops/device_step.py group_scan_body, no secondary sketch: host
    clock to a synchronize, median of 20 after 3 warm-ups; ms a group.
    Then `sketch -k 31` end to end over the file: reads/s.
Every turn must give the same histogram (and count) and the same out.json
bytes. Prints one line a turn, then the pairs this tree won on the timed
step, each tree's median and the other's quartiles over its turns, and,
last, one JSON object of them all, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, S = 9, 42
CONTIGS = (300, 1000, 200_000)
READS = 1_000_000
K = {"longread": 21, "two-sort": 31}


def longread_step(tree: str, fa: str) -> dict:
    """The tree's long-read path a record, on the card."""
    import numpy as np
    import torch

    from hulk_tpu_torch.ops import longread
    from hulk_tpu_torch.sketch.spectrum import KmerSpectrum
    from hulk_tpu_torch.stream.fastq import LongRead, batch_reads_native

    k = K["longread"]
    device_path = hasattr(longread, "long_read_step")
    if device_path:
        hist = torch.zeros(k ** 4, dtype=torch.int32, device="cuda")
        count = torch.zeros((), dtype=torch.int64, device="cuda")

        def one(codes):
            longread.long_read_step(hist, count, None, longread.to_device(codes, "cuda"),
                                    k=k, w=W)
    else:
        spectrum = KmerSpectrum(k ** 4)

        def one(codes):
            spectrum.add_hashes(longread.long_read_minimizers(codes, k=k, w=W,
                                                              device="cuda"))
    times = []
    for item in batch_reads_native([fa], batch_size=16384, fasta=True, raw=True):
        if isinstance(item, LongRead):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one(item.codes)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    bins = hist.cpu().numpy() if device_path else spectrum.bins.astype(np.int32)
    warm = sorted(times[1:])
    return dict(step=("long_read_step" if device_path
                      else "long_read_minimizers + host binning") + f", {len(times)} records",
                ms=1e3 * warm[len(warm) // 2], ms_mean=1e3 * sum(warm) / len(warm),
                hist_sha=hashlib.sha256(bins.tobytes()).hexdigest())


def two_sort_step(tree: str, fq: str) -> dict:
    """One group of the tree's two-sort step, on the card."""
    import torch

    from hulk_tpu_torch.ops.device_step import group_scan_body, ship_group, stream_bucket
    from hulk_tpu_torch.stream.fastq import batch_reads_native
    from hulk_tpu_torch.stream.pipeline import _DeviceStream

    k, r = K["two-sort"], 2048
    dev = torch.device("cuda", 0)
    staged, l = [], None
    for b in batch_reads_native([fq], batch_size=r, raw=True):
        l = l or b.bucket
        if b.bucket == l:
            staged.append((b.codes, b.lengths))
        if len(staged) == _DeviceStream.GROUP:
            break
    flat, g, r = ship_group(staged, l, r, dev)
    kw = dict(g=g, r=r, l=l, k=k, w=W, bucket=stream_bucket(r, r * l, l=l, k=k, w=W))
    hist = torch.zeros(k ** 4, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    group_scan_body(hist, count, flat, **kw)
    torch.cuda.synchronize()
    hist_sha = hashlib.sha256(hist.cpu().numpy().tobytes()).hexdigest() + f" {int(count)}"
    times = []
    for _ in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group_scan_body(hist, count, flat, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm = sorted(times[3:])
    return dict(step=f"group of {g} batches [{r}, {l}]", ms=1e3 * warm[len(warm) // 2],
                ms_quartiles=[1e3 * warm[len(warm) // 4], 1e3 * warm[3 * len(warm) // 4]],
                hist_sha=hist_sha)


def child(workload: str, tree: str, path: str) -> dict:
    """One turn, inside the child process: the tree's timed step and its
    `sketch` end to end."""
    sys.path.insert(0, tree)
    import hulk_tpu_torch
    from hulk_tpu_torch import cli

    if not hulk_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"FAIL imported {hulk_tpu_torch.__file__}, not the tree's")
    r = (longread_step if workload == "longread" else two_sort_step)(tree, path)
    tmp = tempfile.mkdtemp(prefix="hulk_path_retime_")
    out = os.path.join(tmp, "out")
    flags = ["--fasta"] if workload == "longread" else []
    t0 = time.perf_counter()
    rc = cli.main(["sketch", "-f", path, *flags, "-k", str(K[workload]), "-w", str(W),
                   "-s", str(S), "-o", out, "--device", "cuda", "--log", out + ".log"])
    r["sketch_s"] = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"FAIL sketch {' '.join(flags)} in {tree}: exit code {rc}")
    with open(out + ".json", "rb") as fh:
        r["out_sha"] = hashlib.sha256(fh.read()).hexdigest()
    shutil.rmtree(tmp, ignore_errors=True)
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=sorted(K), required=True)
    ap.add_argument("--other", required=True, help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns other, this, this, other (default 1)")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "INPUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.workload, *args.child)), flush=True)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: path_retime.py runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hulk_tpu_torch.synth import contig_lengths, generate, generate_fasta

    smi = cs.nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    k = K[args.workload]
    tmp = tempfile.mkdtemp(prefix="hulk_path_retime_")
    # the CWS tables, made once before the turns, in a cache of the run's own
    os.environ["HULK_TPU_TORCH_CACHE"] = os.path.join(tmp, "cache")
    from hulk_tpu_torch.hashes.cws import get_cws_tables

    get_cws_tables(S, k ** 4)
    if args.workload == "longread":
        n, lo, hi = CONTIGS
        path = generate_fasta(os.path.join(tmp, "contigs.fa"), n, lo=lo, hi=hi, seed=0)
        amount, unit = int(contig_lengths(np.random.default_rng(0), n, lo, hi).sum()) / 1e6, \
            "Mb/s"
    else:
        path = generate(os.path.join(tmp, "reads.fq.gz"), READS, read_len=150, seed=0)
        amount, unit = READS, "reads/s"
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    turns, first = [], None
    for name in ("other", "this", "this", "other") * args.rounds:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--workload",
                              args.workload, "--other", "-", "--child", trees[name], path],
                             cwd=trees[name], capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"FAIL the {name} tree's turn: exit code {run.returncode}")
        r = json.loads(run.stdout.strip().splitlines()[-1])
        r.update(tree=name, wall_s=time.perf_counter() - t0, rate=amount / r["sketch_s"])
        first = first or r
        if (r["hist_sha"], r["out_sha"]) != (first["hist_sha"], first["out_sha"]):
            raise SystemExit(f"FAIL the {name} tree's histogram or out.json differs")
        print(f"{name}: {r['step']} {r['ms']:.3f} ms; sketch {r['sketch_s']:.3f} s = "
              f"{r['rate']:.3f} {unit}; turn {r['wall_s']:.1f} s with start-up", flush=True)
        turns.append(r)
    shutil.rmtree(tmp, ignore_errors=True)
    # pairs (other, this) and (this, other) of each round, on the timed step
    ms = [t["ms"] for t in turns]
    pairs = [(ms[i], ms[i + 1]) for i in range(0, len(ms), 4)] + \
        [(ms[i + 3], ms[i + 2]) for i in range(0, len(ms), 4)]
    won = sum(this < other for other, this in pairs)
    med = {name: float(np.median([t["ms"] for t in turns if t["tree"] == name]))
           for name in trees}
    other_q = [float(q) for q in np.percentile(
        [t["ms"] for t in turns if t["tree"] == "other"], [25, 75])]
    summary = dict(pairs=len(pairs), won_by_this=won, median_ms=med, other_quartiles_ms=other_q)
    print(f"this tree won {won} of {len(pairs)} pairs; median ms this {med['this']:.3f}, "
          f"other {med['other']:.3f} (other's quartiles {other_q[0]:.3f}-{other_q[1]:.3f})",
          flush=True)
    print(json.dumps({"card": smi, "workload": args.workload, "amount": amount, "unit": unit,
                      "summary": summary, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
