#!/usr/bin/env python3
"""Time the native inflate and the v2 group pack of two trees in turns, on
one host core.

    rm -rf build/parent && mkdir -p build/parent
    git archive <commit> hulk_tpu_torch/native | tar -x -C build/parent
    python3 scripts/inflate_retime.py --other build/parent --rounds 5

Builds each tree's hulk_tpu_torch/native/hulkrt.cpp with the flags the
package builds it with, into build/retime/, and makes three gzip inputs
from `--seed`:
  * sample: R1 of the benchmark's mock community (hulkbench/configs/
    reads-k21-s42.json) cut to `--reads` reads: 150 bp, constant
    qualities, members of 50,000 records at gzip level 1, as the cells
    read it;
  * binned: the same reads with each quality drawn from the four binned
    Illumina symbols (# - 8 F, Q 2/12/23/37, at 2/5/13/80%), level 6;
  * random: 32 MB of random bytes, level 1.
Then, `--rounds` times in the order other, this, this, other, one thread
each (OMP_NUM_THREADS=1): every member of each input through
hulk_inflate_members (MB/s of inflated bytes), and groups of 16 batches of
16,384 reads of the sample, as this tree's parser gives them, through
hulk_pack_group_batch2 at L = 160 (ms a group). Both trees must give the
same bytes.

Last, the per-block cost of this tree's table fill (inf_match in
hulkrt.cpp, run for every dynamic block): a copy of the source with a clock
around each fill inflates each input once (ns a block, blocks a MB).

Prints one line a turn and, last, one JSON object with the host's CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import gzip
import hashlib
import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402

FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC"]
BINNED = (np.frombuffer(b"#-8F", np.uint8), [0.02, 0.05, 0.13, 0.80])

# the fill's clock: this tree's source, each block's table fill timed
FILL_CALL = "inf_match(st->lit, st->dist);"
FILL_TIMED = """{
    const auto t0_ = std::chrono::steady_clock::now();
    inf_match(st->lit, st->dist);
    g_fill_ns += std::chrono::duration<double, std::nano>(std::chrono::steady_clock::now() - t0_).count();
    g_fills++;
}"""
FILL_HEAD = """#include <chrono>
#include <cstdint>
static double g_fill_ns;
static int64_t g_fills;
"""
FILL_TAIL = """
extern "C" void retime_fill(double* ns, int64_t* n) {
    *ns = g_fill_ns;
    *n = g_fills;
    g_fill_ns = 0;
    g_fills = 0;
}
"""


def build(tree: str, name: str, timed: bool = False) -> ctypes.CDLL:
    src = os.path.join(tree, "hulk_tpu_torch", "native", "hulkrt.cpp")
    out = os.path.join(HERE, "build", "retime")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"{name}.so")
    if timed:
        with open(src) as f:
            text = f.read()
        if text.count(FILL_CALL) != 1:
            raise SystemExit(f"{src}: no single `{FILL_CALL}` to time")
        src = os.path.join(out, f"{name}.cpp")
        with open(src, "w") as f:
            f.write(FILL_HEAD + text.replace(FILL_CALL, FILL_TIMED) + FILL_TAIL)
    subprocess.run(["g++", *FLAGS, "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.hulk_inflate_members.restype = ctypes.c_int64
    lib.hulk_pack_group_batch2.restype = None
    return lib


def inputs(seed: int, reads: int, tmp: str) -> dict:
    from hulkbench.inputs import gzip_member, mock_community

    with open(os.path.join(HERE, "hulkbench", "configs", "reads-k21-s42.json")) as f:
        p = dict(json.load(f)["input"])
    p.update(reads_per_file=reads)
    made = mock_community.generate(p, seed, tmp)
    with open(made["files"]["R1"], "rb") as f:
        sample = f.read()
    codes = made["reads"]["R1"][0].reshape(reads, -1)
    rng = np.random.default_rng(seed)
    plain = gzip.decompress(sample)
    recs = np.frombuffer(plain, np.uint8).reshape(reads, -1).copy()
    L = codes.shape[1]
    q0 = recs.shape[1] - L - 1
    recs[:, q0:q0 + L] = BINNED[0][rng.choice(4, size=(reads, L), p=BINNED[1])]
    chunk = int(p["chunk"])
    binned = b"".join(gzip_member(recs[a:a + chunk].tobytes(), 6)
                      for a in range(0, reads, chunk))
    noise = rng.integers(0, 256, 32 << 20, dtype=np.uint8).tobytes()
    rand = gzip_member(noise[:16 << 20], 1) + gzip_member(noise[16 << 20:], 1)
    return {"sample": (sample, made["files"]["R1"]), "binned": (binned, None),
            "random": (rand, None)}


def inflate_all(lib, comp: np.ndarray, out: np.ndarray) -> tuple[float, int]:
    pos, last = ctypes.c_int64(0), ctypes.c_int64(0)
    t0 = time.perf_counter()
    n = lib.hulk_inflate_members(
        ctypes.c_void_p(comp.ctypes.data), ctypes.c_int64(comp.shape[0]), ctypes.byref(pos),
        ctypes.c_void_p(out.ctypes.data), ctypes.c_int64(out.shape[0]),
        ctypes.c_int64(out.shape[0]), ctypes.byref(last))
    dt = time.perf_counter() - t0
    assert n > 0 and pos.value == comp.shape[0], (n, pos.value)
    return dt, n


def groups_of(path: str, n_groups: int) -> list:
    from hulk_tpu_torch.stream.fastq import batch_reads_native

    batches = []
    for b in batch_reads_native([path], batch_size=16384, raw=True):
        batches.append((b.codes, b.lengths))
        if len(batches) == 16 * n_groups:
            break
    return [batches[i:i + 16] for i in range(0, len(batches), 16)]


def pack_all(lib, groups, out: np.ndarray) -> float:
    from hulk_tpu_torch import native

    saved = native._lib
    native._lib = lib
    try:
        t0 = time.perf_counter()
        for g in groups:
            native.pack_group2(g, 16, 16384, 160, out=out)
        return (time.perf_counter() - t0) / len(groups)
    finally:
        native._lib = saved


def fill_cost(lib, comp: np.ndarray, out: np.ndarray) -> dict:
    """ns a block's table fill, and the fills a MB of output."""
    ns, n = ctypes.c_double(0), ctypes.c_int64(0)
    lib.retime_fill(ctypes.byref(ns), ctypes.byref(n))
    _, nbytes = inflate_all(lib, comp, out)
    lib.retime_fill(ctypes.byref(ns), ctypes.byref(n))
    return {"fill_ns_mean": ns.value / max(n.value, 1), "fills": n.value,
            "fills_per_MB": n.value / (nbytes / 1e6)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2_200_000_001)
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    libs = {"other": build(a.other, "other"), "this": build(HERE, "this")}
    timed = build(HERE, "timed", timed=True)
    res = {"cpu": platform.processor() or platform.machine(), "turns": []}
    try:
        with open("/proc/cpuinfo") as f:
            res["cpu"] = next(x.split(":", 1)[1].strip() for x in f if x.startswith("model name"))
    except (OSError, StopIteration):
        pass
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        made = inputs(a.seed, a.reads, tmp)
        groups = groups_of(made["sample"][1], a.groups)
        print(f"inputs in {time.perf_counter() - t0:.1f} s", flush=True)
        comps = {k: np.frombuffer(v[0], np.uint8) for k, v in made.items()}
        sizes = {k: len(gzip.decompress(v[0])) for k, v in made.items()}
        outs = {k: np.zeros(sizes[k] + (1 << 20), np.uint8) for k in made}
        pout = np.zeros(16 * 16384 * (40 + 20 + 2), np.uint8)
        digests = {}
        for rnd in range(a.rounds):
            for who in ("other", "this", "this", "other"):
                turn = {"round": rnd, "tree": who}
                for k in made:
                    dt, n = inflate_all(libs[who], comps[k], outs[k])
                    turn[f"{k}_MB_per_s"] = n / dt / 1e6
                    digests.setdefault(k, set()).add(hashlib.sha256(outs[k][:n]).hexdigest())
                turn["pack_ms_a_group"] = 1e3 * pack_all(libs[who], groups, pout)
                digests.setdefault("pack", set()).add(hashlib.sha256(pout).hexdigest())
                res["turns"].append(turn)
                print(json.dumps(turn), flush=True)
        res["same_bytes"] = {k: len(v) == 1 for k, v in digests.items()}
        res["fill"] = {k: fill_cost(timed, comps[k], outs[k]) for k in made}
    summary = {}
    for key in res["turns"][0]:
        if key in ("round", "tree"):
            continue
        for who in ("other", "this"):
            vals = [t[key] for t in res["turns"] if t["tree"] == who and key in t]
            if vals:
                summary[f"{key}.{who}"] = statistics.median(vals)
    res["median"] = summary
    line = json.dumps(res)
    if a.json:
        os.makedirs(os.path.dirname(a.json) or ".", exist_ok=True)
        with open(a.json, "w") as f:
            f.write(line)
    print(json.dumps({k: res[k] for k in ("cpu", "same_bytes", "fill", "median")}))
    if not all(res["same_bytes"].values()):
        raise SystemExit("the two trees gave different bytes")


if __name__ == "__main__":
    main()
