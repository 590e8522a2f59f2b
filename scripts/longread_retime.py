#!/usr/bin/env python3
"""Time the long-read path of two trees of the port in turns on one card.

    rm -rf build/parent && mkdir -p build/parent
    git archive <commit> | tar -x -C build/parent --exclude=.jax_cache
    python3 scripts/longread_retime.py --other build/parent

Generates one FASTA file of synthetic contigs (synth.generate_fasta, seed
0: 300 contigs of 1-200 kb, 1% N), then runs one child process a turn, in
the order other, this, this, other. Each child imports hulk_tpu_torch from
its tree (building that tree's kernels) and times, at k=21, w=9, s=42:
  * each long record of the file (65,536 bases or more) through the work
    that tree's pipeline does for one: a tree with ops/longread.py
    long_read_step runs it into a device histogram and count; an older
    tree runs long_read_minimizers on the card and the host spectrum's
    add_hashes, as its pipeline did. Host clock to a synchronize, the
    first record left out as a warm-up; ms a record;
  * `sketch --fasta` end to end over the file (cli.main): seconds and Mb/s.
Every turn must give the same histogram of the long records and the same
out.json bytes. Prints one line a turn and, last, one JSON object of them
all, with the card's name and power limit.
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
CONTIGS = (300, 1000, 200_000)
K, W, S = 21, 9, 42


def child(tree: str, fa: str) -> dict:
    """One turn, inside the child process: the tree's long-read path a
    record and its `sketch --fasta`, on the card."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import hulk_tpu_torch
    from hulk_tpu_torch import cli
    from hulk_tpu_torch.ops import longread
    from hulk_tpu_torch.sketch.spectrum import KmerSpectrum
    from hulk_tpu_torch.stream.fastq import LongRead, batch_reads_native

    if not hulk_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"FAIL imported {hulk_tpu_torch.__file__}, not the tree's")
    nbins = K ** 4
    device_path = hasattr(longread, "long_read_step")
    if device_path:
        hist = torch.zeros(nbins, dtype=torch.int32, device="cuda")
        count = torch.zeros((), dtype=torch.int64, device="cuda")

        def one(codes):
            longread.long_read_step(hist, count, None, longread.to_device(codes, "cuda"),
                                    k=K, w=W)
    else:
        spectrum = KmerSpectrum(nbins)

        def one(codes):
            spectrum.add_hashes(longread.long_read_minimizers(codes, k=K, w=W,
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

    tmp = tempfile.mkdtemp(prefix="hulk_longread_retime_")
    out = os.path.join(tmp, "out")
    t0 = time.perf_counter()
    rc = cli.main(["sketch", "-f", fa, "--fasta", "-k", str(K), "-w", str(W), "-s", str(S),
                   "-o", out, "--device", "cuda", "--log", out + ".log"])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"FAIL sketch --fasta in {tree}: exit code {rc}")
    with open(out + ".json", "rb") as fh:
        out_sha = hashlib.sha256(fh.read()).hexdigest()
    shutil.rmtree(tmp, ignore_errors=True)
    warm = times[1:]
    return dict(path="long_read_step" if device_path else "long_read_minimizers + host binning",
                records=len(times), ms_a_record=1e3 * sum(warm) / len(warm),
                ms_median=1e3 * sorted(warm)[len(warm) // 2],
                hist_sha=hashlib.sha256(bins.tobytes()).hexdigest(), sketch_s=seconds,
                out_sha=out_sha)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other tree")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "FASTA"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(*args.child)), flush=True)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: longread_retime.py runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hulk_tpu_torch.synth import contig_lengths, generate_fasta

    smi = cs.nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    n, lo, hi = CONTIGS
    tmp = tempfile.mkdtemp(prefix="hulk_longread_retime_")
    # the CWS tables, made once before the turns, in a cache of the run's own
    os.environ["HULK_TPU_TORCH_CACHE"] = os.path.join(tmp, "cache")
    from hulk_tpu_torch.hashes.cws import get_cws_tables

    get_cws_tables(S, K ** 4)
    fa = generate_fasta(os.path.join(tmp, "contigs.fa"), n, lo=lo, hi=hi, seed=0)
    bases = int(contig_lengths(np.random.default_rng(0), n, lo, hi).sum())
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    turns, first = [], None
    for name in ("other", "this", "this", "other"):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", "-",
                              "--child", trees[name], fa], cwd=trees[name],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"FAIL the {name} tree's turn: exit code {run.returncode}")
        r = json.loads(run.stdout.strip().splitlines()[-1])
        r.update(tree=name, wall_s=time.perf_counter() - t0, mb_s=bases / r["sketch_s"] / 1e6)
        first = first or r
        if (r["hist_sha"], r["out_sha"]) != (first["hist_sha"], first["out_sha"]):
            raise SystemExit(f"FAIL the {name} tree's histogram or out.json differs")
        print(f"{name} ({r['path']}): {r['records']} long records, {r['ms_a_record']:.3f} ms "
              f"a record (median {r['ms_median']:.3f}); sketch --fasta {r['sketch_s']:.3f} s "
              f"= {r['mb_s']:.3f} Mb/s; turn {r['wall_s']:.1f} s with start-up", flush=True)
        turns.append(r)
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": smi, "contigs": n, "bases": bases, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
