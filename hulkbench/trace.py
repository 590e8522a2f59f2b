"""The traced window, read from torch.profiler's Chrome trace.

`read_chrome` turns the trace into plain lists in seconds on the trace's
clock: the window (the harness's `hulkbench.window` annotation), every
device operation (kernels, copies, sets) and every host-side torch
operation. The per-layer readers and the breakdown take them from there.
"""
from __future__ import annotations

import json

import numpy as np

WINDOW = "hulkbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_chrome(path: str) -> dict:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    window, device, host = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0)) * 1e-6
        if cat == "user_annotation" and name == WINDOW:
            window = [a, b]
        elif cat in DEVICE_CATS:
            device.append([name, a, b])
        elif cat == "cpu_op":
            host.append([name, a, b])
    return {"window": window, "device_ops": device, "host_ops": host}


def _clipped(ops: list, t0: float, t1: float) -> np.ndarray:
    """[n, 2] starts and ends of ops, clipped to [t0, t1], empty ones out."""
    if not ops:
        return np.zeros((0, 2))
    se = np.clip(np.array([[a, b] for _, a, b in ops], dtype=np.float64), t0, t1)
    return se[se[:, 1] > se[:, 0]]


def busy_intervals(ops: list, t0: float, t1: float) -> np.ndarray:
    """The union of the ops' intervals inside [t0, t1], as sorted disjoint
    [start, end] rows."""
    se = _clipped(ops, t0, t1)
    if se.shape[0] == 0:
        return se
    se = se[np.argsort(se[:, 0], kind="stable")]
    reach = np.maximum.accumulate(se[:, 1])
    new = np.concatenate([[True], se[1:, 0] > reach[:-1]])
    starts = se[new, 0]
    ends = np.maximum.reduceat(se[:, 1], np.flatnonzero(new))
    return np.stack([starts, ends], axis=1)


def busy_seconds(trace: dict) -> float:
    t0, t1 = trace["window"]
    u = busy_intervals(trace["device_ops"], t0, t1)
    return float((u[:, 1] - u[:, 0]).sum())


def kernel_seconds(trace: dict, names: tuple[str, ...]) -> float:
    """Device seconds in the window of the kernels whose name holds one of
    `names`."""
    t0, t1 = trace["window"]
    ops = [op for op in trace["device_ops"] if any(n in op[0] for n in names)]
    se = _clipped(ops, t0, t1)
    return float((se[:, 1] - se[:, 0]).sum())


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time (by name) and the longest
    idle gaps of the device, each named by the host torch operation that
    overlaps it most."""
    t0, t1 = trace["window"]
    by_name: dict[str, float] = {}
    for name, a, b in trace["device_ops"]:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            key = name[:120]
            by_name[key] = by_name.get(key, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    u = busy_intervals(trace["device_ops"], t0, t1)
    edges = np.concatenate([[t0], u.ravel(), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:top]
    host = _clipped(trace["host_ops"], t0, t1)
    names = [n for n, a, b in trace["host_ops"] if min(b, t1) > max(a, t0)]
    idle = []
    for g0, g1 in gaps:
        label = "no torch op on the host (native parse, flush, Python)"
        if host.shape[0]:
            over = np.minimum(host[:, 1], g1) - np.maximum(host[:, 0], g0)
            i = int(np.argmax(over))
            if over[i] > 0:
                label = names[i]
        idle.append([label, float(g1 - g0)])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
