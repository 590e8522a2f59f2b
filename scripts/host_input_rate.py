#!/usr/bin/env python3
"""Time the host input layer alone at a given -p, with no card: the gunzip
and parse threads of `batch_reads_native` over R1 of the benchmark's mock
sample, and the stream thread's group pack (`pack_group2`) of every 16
batches of 16,384 reads, done here in the calling thread.

    python3 scripts/host_input_rate.py --processors 8 [--passes 15] \\
        [--reads 1000000] [--seed 2300004001] [--dir DIR]

Runs from the checkout in the working directory (so another tree can be
timed with this script). Makes R1 once into --dir (default: a temporary
directory) from hulkbench/configs/reads-k21-s42.json's input at --reads
reads, makes one warm pass, then times --passes passes. Prints one JSON
object: Mbp/s over the timed passes and the process's CPU seconds over
their wall seconds (how many cores the layer kept busy). OpenMP reads its
wait policy from the environment when it loads, so compare policies in
separate processes.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processors", type=int, required=True)
    ap.add_argument("--passes", type=int, default=15)
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=2300004001)
    ap.add_argument("--dir", default=None)
    a = ap.parse_args()
    from hulk_tpu_torch import native
    from hulk_tpu_torch.stream.fastq import batch_reads_native
    from hulkbench.inputs import mock_community

    out_dir = a.dir or tempfile.mkdtemp()
    path = os.path.join(out_dir, "R1.fq.gz")
    if not os.path.exists(path):
        with open(os.path.join("hulkbench", "configs", "reads-k21-s42.json")) as fh:
            prm = dict(json.load(fh)["input"], reads_per_file=a.reads)
        os.makedirs(out_dir, exist_ok=True)
        mock_community.generate(prm, a.seed, out_dir)
    native.set_threads(a.processors)
    out = np.empty(native.group2_nbytes(16, 16384, 160), dtype=np.uint8)

    def one_pass() -> int:
        bases, group = 0, []
        for b in batch_reads_native([path], batch_size=16384, raw=True):
            group.append((b.codes, b.lengths))
            bases += int(np.asarray(b.lengths).sum())
            if len(group) == 16:
                native.pack_group2(group, 16, 16384, 160, out=out)
                group = []
        if group:
            native.pack_group2(group, 16, 16384, 160, out=out)
        return bases

    one_pass()
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    bases = sum(one_pass() for _ in range(a.passes))
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = r1.ru_utime + r1.ru_stime - r0.ru_utime - r0.ru_stime
    print(json.dumps({"processors": a.processors, "wait_policy": os.environ.get("OMP_WAIT_POLICY"),
                      "Mbp_per_s": bases / wall / 1e6, "wall_s": wall, "cores": cpu / wall}))


if __name__ == "__main__":
    main()
