#!/usr/bin/env python3
"""Time the port's sketch stream on one card against the same stream
sharded over several cards of one machine.

    python3 scripts/shard_scaling.py [--reads 1000000] [--configs k21_kmv_khf_hmh,k31]
        [--switch-interval S] [--ranks]

Writes READS synthetic reads of 150 bp (hulk_tpu_torch.synth, seed 0),
times the native parser alone over them (the host's ceiling), then, for
k=21 with --kmv --khf --hmh (the fused step) and for k=31 (the two-sort
step), w=9, s=42, runs run_sketch_pipeline over the file on meshes of 1, 2,
4, ... cards up to every visible card: one warm run on one card, then every
mesh in turns, forward and back (1, 2, 4, 4, 2, 1). The clock covers
parse, pack, copy, step, merge and flush, and stops after every card has
synchronised. Every mesh's sketch JSON must equal one card's byte for byte.
--switch-interval sets sys.setswitchinterval first (the shards' threads
share the GIL).

--ranks also times `python -m hulk_tpu_torch sketch --kmv --khf --hmh` over
one file of READS reads a card (seeds 0, 1, ...): one process on card 0
against one process a card (CUDA_VISIBLE_DEVICES, a gloo group, every n-th
file each), in turns (1, n, n, 1). It reports the wall seconds, start-up
included, and the slowest rank's "finished in" seconds from its log; rank
0's out.json must equal one process's byte for byte.

Prints one line a run, the median of each mesh, and last one JSON object
of them all with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CONFIGS = {
    "k21_kmv_khf_hmh": dict(kmer_size=21, kmv=True, khf=True, hmh=True),
    "k31": dict(kmer_size=31),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--switch-interval", type=float, default=None)
    ap.add_argument("--ranks", action="store_true")
    args = ap.parse_args()
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: shard_scaling.py runs on the card only", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hulk_tpu_torch.stream.fastq import batch_reads_native
    from hulk_tpu_torch.stream.pipeline import SketchConfig, run_sketch_pipeline
    from hulk_tpu_torch.synth import generate

    smi = cs.nvidia_smi()
    ncards = torch.cuda.device_count()
    print(f"nvidia-smi: {smi}; {ncards} cards", flush=True)
    tmp = tempfile.mkdtemp(prefix="hulk_shard_scaling_")
    os.environ.setdefault("HULK_TPU_TORCH_CACHE", os.path.join(tmp, "cache"))
    fq = generate(os.path.join(tmp, "reads.fq.gz"), args.reads, read_len=150, seed=0)
    widths = sorted({d for d in (1, 2, 4, 8) if d <= ncards} | {ncards})
    order = widths + widths[::-1]

    t0 = time.perf_counter()
    for _ in batch_reads_native([fq], batch_size=16384, raw=True):
        pass
    parse_s = time.perf_counter() - t0
    print(f"parse alone: {args.reads / parse_s:.1f} reads/s", flush=True)

    def run(kw: dict, d: int) -> tuple[float, bytes]:
        cfg = SketchConfig(input_paths=[fq], file_name=fq + ",", window_size=9,
                           sketch_size=42, device="cuda",
                           devices=[f"cuda:{i}" for i in range(d)], **kw)
        t0 = time.perf_counter()
        res = run_sketch_pipeline(None, cfg)
        for i in range(d):
            torch.cuda.synchronize(i)
        return time.perf_counter() - t0, res.hulk_data.to_json_bytes()

    result = {"card": smi, "cards": ncards, "reads": args.reads,
              "parse_reads_per_s": args.reads / parse_s,
              "switch_interval": sys.getswitchinterval(),
              "omp_wait_policy": os.environ.get("OMP_WAIT_POLICY"), "configs": {}}
    for name in args.configs.split(","):
        kw = CONFIGS[name]
        _, want = run(kw, 1)
        rates: dict[int, list[float]] = {d: [] for d in widths}
        for d in order:
            seconds, got = run(kw, d)
            if got != want:
                print(f"FAIL {name}: {d} cards' sketch differs from one card's", flush=True)
                return 1
            rates[d].append(args.reads / seconds)
            print(f"{name} on {d} card(s): {seconds:.3f} s = {args.reads / seconds:.1f} reads/s",
                  flush=True)
        medians = {d: statistics.median(r) for d, r in rates.items()}
        for d in widths:
            print(f"{name} median on {d} card(s): {medians[d]:.1f} reads/s "
                  f"({medians[d] / medians[1]:.3f}x one card)", flush=True)
        result["configs"][name] = {str(d): {"runs": rates[d], "median": medians[d]}
                                   for d in widths}
    if args.ranks:
        result["ranks"] = rank_runs(fq, args.reads, ncards, tmp)
        if result["ranks"] is None:
            return 1
    print(json.dumps(result), flush=True)
    return 0


def rank_runs(fq: str, reads: int, n: int, tmp: str) -> dict | None:
    """One process over n files on card 0 against n processes, one card
    each, in turns (1, n, n, 1). Returns {"1"|"n": {"wall": [...],
    "finished": [...]}}, or None when the bytes differ."""
    import multiprocessing as mp
    import re
    import subprocess
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke as cs
    from hulk_tpu_torch.synth import generate

    more = [os.path.join(tmp, f"reads{i}.fq.gz") for i in range(1, n)]
    with ProcessPoolExecutor(max_workers=max(1, len(more)),
                             mp_context=mp.get_context("spawn")) as ex:
        list(ex.map(generate, more, [reads] * len(more), [150] * len(more), range(1, n)))
    files = ",".join([fq, *more])
    argv = [sys.executable, "-m", "hulk_tpu_torch", "sketch", "-f", files, "-k", "21",
            "-w", "9", "-s", "42", "--kmv", "--khf", "--hmh", "--device", "cuda"]

    def run(world: int, tag: str) -> tuple[float, float, bytes]:
        env = dict(os.environ, PYTHONPATH=HERE)
        if world > 1:
            env.update(HULK_COORDINATOR=f"127.0.0.1:{cs.free_port()}",
                       HULK_NUM_PROCS=str(world))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [*argv, "-o", os.path.join(tmp, tag), "--log", os.path.join(tmp, f"{tag}.{r}.log")],
            cwd=tmp, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
            env=dict(env, CUDA_VISIBLE_DEVICES=str(r), HULK_PROC_ID=str(r)))
            for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        finished = []
        for r, p in enumerate(procs):
            with open(os.path.join(tmp, f"{tag}.{r}.log")) as fh:
                text = fh.read()
            if p.returncode != 0:
                raise SystemExit(f"FAIL {tag}: rank {r} exit code {p.returncode}:\n"
                                 f"{text[-3000:]}")
            finished.append(float(re.findall(r"finished in ([0-9.]+)s", text)[-1]))
        with open(os.path.join(tmp, f"{tag}.json"), "rb") as fh:
            return wall, max(finished), fh.read()

    out = {"1": {"wall": [], "finished": []}, "n": {"wall": [], "finished": []}}
    want = None
    for i, world in enumerate((1, n, n, 1)):
        wall, finished, data = run(world, f"ranks{i}")
        want = data if want is None else want
        if data != want:
            print(f"FAIL ranks: {world} processes' out.json differs from one process's",
                  flush=True)
            return None
        key = "1" if world == 1 else "n"
        out[key]["wall"].append(wall)
        out[key]["finished"].append(finished)
        print(f"sketch --kmv --khf --hmh, {n} files of {reads} reads, {world} process(es): "
              f"{wall:.3f} s wall, slowest rank finished in {finished:.3f} s", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
