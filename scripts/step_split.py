#!/usr/bin/env python3
"""Split the stream thread's `stream.step` time of one traced benchmark run
into what torch.profiler saw inside those spans.

    python3 scripts/step_split.py --workload reads-k31.samples --seed 7 \\
        --seconds 25 [--switch-interval 0.0005] [--json out.json]

Runs the harness's cell (hulkbench/run.py run_cell) with --trace 1, from
the checkout in the working directory (so a parent tree can be run with
this script), and reads the Chrome trace of its window once more. Inside
the `stream.step` ranges on the stream thread it sums:
  * each CUDA runtime and driver call by name (the launches, and the calls
    that wait on the card: a synchronize, a blocking copy);
  * the union of the torch operations' host spans (dispatch and launch);
  * the rest: the Python between operations, including each wait to take
    the interpreter lock back after an operation released it.
With the program's spans, it also gives each thread's busy seconds in the
window's jobs (self time of the input and stream spans; `input.gunzip`
summed over the threads that inflate) and the program's counters. --switch-interval
sets sys.setswitchinterval for the run: when the rest shrinks with it, the
rest is the lock's handover, not Python's own work.

Prints the harness's stderr line and, last, one JSON object. A k31 run
takes about four minutes on an H100 host at --seconds 25: set-up, the
window, the trace's export and parse (gigabytes), and the check.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

SPANS = ("stream.step", "stream.pack", "stream.sync", "stream.loop", "stream.input_wait",
         "input.gunzip", "input.parse", "input.chunk_wait", "input.parse_par",
         "input.inflate_wait")


def _inside(se: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """For each interval of se, its length inside the sorted disjoint
    ranges: F(end) - F(start), F(t) the ranges' measure up to t."""
    starts, lens = ranges[:, 0], ranges[:, 1] - ranges[:, 0]
    before = np.concatenate([[0.0], np.cumsum(lens)])

    def f(t):
        k = np.searchsorted(starts, t, side="right") - 1
        kk = np.maximum(k, 0)
        part = np.clip(t - starts[kk], 0, lens[kk])
        return np.where(k < 0, 0.0, before[kk] + part)

    return f(se[:, 1]) - f(se[:, 0])


def split(doc: dict) -> dict:
    """stream.step's seconds in the window of a Chrome trace, and their
    parts."""
    from hulkbench.trace import busy_intervals

    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    win = next(((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "user_annotation" and e.get("name") == "hulkbench.window"),
               None)
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "stream.step"]
    if win is None or not steps:
        return {"error": "no window or no stream.step ranges in the trace"}
    tid = steps[0]["tid"]
    ranges = busy_intervals([[e["name"], e["ts"], e["ts"] + e["dur"]] for e in steps
                             if e["tid"] == tid], *win)
    step_s = float((ranges[:, 1] - ranges[:, 0]).sum()) * 1e-6
    mine = [e for e in events if e.get("tid") == tid]
    ops = busy_intervals([[e["name"], e["ts"], e["ts"] + e["dur"]] for e in mine
                          if e.get("cat") == "cpu_op"], *win)
    ops_s = float(_inside(ops, ranges).sum()) * 1e-6 if ops.shape[0] else 0.0
    cuda = [e for e in mine if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    calls: dict = {}
    if cuda:
        se = np.array([[e["ts"], e["ts"] + e["dur"]] for e in cuda], np.float64)
        inside = _inside(se, ranges) * 1e-6
        for e, s in zip(cuda, inside.tolist()):
            if s > 0:
                c = calls.setdefault(e["name"], [0, 0.0])
                c[0] += 1
                c[1] += s
    top = sorted(calls.items(), key=lambda kv: -kv[1][1])[:12]
    return {"step_s": step_s, "torch_ops_s": ops_s, "outside_ops_s": step_s - ops_s,
            "cuda_calls_s": sum(c[1] for c in calls.values()),
            "cuda_calls": {n: {"n": c[0], "s": c[1]} for n, c in top}}


def thread_seconds() -> dict:
    """Self seconds of the program's spans over the window's jobs."""
    from hulkbench import spans as hs

    recs = hs.records()
    if not recs:
        return {}
    jobs = [r for r in recs if r.name == "job"]
    if not jobs:
        return {}
    t0, t1 = min(r.t0 for r in jobs), max(r.t1 for r in jobs)
    out = {"jobs_s": t1 - t0, "jobs": len(jobs)}
    for name in SPANS:
        out[name] = hs.self_seconds(recs, name, t0, t1)
    return out


def _counters() -> dict:
    """The program's counters over the window (from the readers' start)."""
    from hulkbench import spans as hs

    return hs.counters()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--switch-interval", type=float, default=None)
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    from hulkbench import run, trace

    cell = run.load_cell(a.workload)
    run.set_run_env(cell["config"]["processors"])
    if a.switch_interval is not None:
        sys.setswitchinterval(a.switch_interval)
    got = {}
    read = trace.read_chrome

    class Parsed:
        """json for the harness's reader: the trace already parsed (a
        trace of a k31 window is gigabytes; parse it once)."""

        def __init__(self, doc):
            self.doc = doc

        def load(self, fh):
            return self.doc

    def read_and_split(path):
        with open(path) as fh:
            doc = json.load(fh)
        got.update(split(doc))
        trace.json = Parsed(doc)
        try:
            return read(path)
        finally:
            trace.json = json

    trace.read_chrome = read_and_split
    result = run.run_cell(cell, a.seed, a.seconds, True)
    res = {"workload": a.workload, "seed": a.seed, "cwd": os.getcwd(),
           "switch_interval": sys.getswitchinterval(), "correct": result["correct"],
           "attempted": result["attempted"], "metrics": result["metrics"],
           "device": result["device"], "step_split": got, "threads": thread_seconds(),
           "counters": _counters()}
    line = json.dumps(res)
    if a.json:
        os.makedirs(os.path.dirname(a.json) or ".", exist_ok=True)
        with open(a.json, "w") as f:
            f.write(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
