"""Plain-PyTorch forms of the LSH ranking, timed on the card at BASELINE
config 5's shape: the port's (hulk_tpu_torch/parallel/lsh.py rank_stripe)
and the forms it was chosen over.

Each variant maps [Q, s] queries and [n, s] index rows (int64, on the card)
to [Q, n] uint16 positional match counts; all must equal the first. Device
time by torch.profiler over 3 calls after one warm-up, and wall time (CUDA
events around one call, median of 5). The bound is chip_smoke.py's
lsh_bound.

    python scripts/lsh_rank_variants.py [n] [q]      # default 100000 1000
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from hulk_tpu_torch.parallel import lsh  # noqa: E402

S = 42
C = 4096


def broadcast_sum(q, rows, step_bytes=32 << 20):
    """[QB, C, s] bool compare, then sum(-1, dtype=int32) (which first casts
    the bool block to int32)."""
    out = torch.empty((q.shape[0], rows.shape[0]), dtype=torch.uint16, device=rows.device)
    qb = max(1, step_bytes // (C * S))
    for c0 in range(0, rows.shape[0], C):
        chunk = rows[c0:c0 + C]
        for q0 in range(0, q.shape[0], qb):
            out[q0:q0 + qb, c0:c0 + C] = (q[q0:q0 + qb, None, :] == chunk[None]).sum(
                -1, dtype=torch.int32)
    return out


def slot_loop(q, rows, chunk=C, transposed=False):
    """An int32 [Q, chunk] count, one compare and one in-place add a slot
    (the add reads the bool compare without a cast pass)."""
    out = torch.empty((q.shape[0], rows.shape[0]), dtype=torch.uint16, device=rows.device)
    qt = q.T.contiguous() if transposed else None
    acc = torch.empty((q.shape[0], chunk), dtype=torch.int32, device=rows.device)
    for c0 in range(0, rows.shape[0], chunk):
        r = rows[c0:c0 + chunk]
        rt = r.T.contiguous() if transposed else None
        a = acc[:, :r.shape[0]]
        a.zero_()
        for k in range(S):
            if transposed:
                a.add_(qt[k][:, None] == rt[k][None, :])
            else:
                a.add_(q[:, k, None] == r[None, :, k])
        out[:, c0:c0 + chunk] = a
    return out


VARIANTS = {
    "broadcast_sum": broadcast_sum,
    "slot_loop": slot_loop,
    "rank_stripe": lsh.rank_stripe,  # the port's: slot-major, chunk 4096
    "slot_loop_T_8192": lambda q, r: slot_loop(q, r, chunk=8192, transposed=True),
    "slot_loop_T_16384": lambda q, r: slot_loop(q, r, chunk=16384, transposed=True),
}


def main(n: int = 100_000, nq: int = 1_000) -> None:
    from hulk_tpu_torch.synth import lsh_corpus

    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    print(f"{chip_smoke.nvidia_smi()}; Q={nq} N={n} s={S}", flush=True)
    mins, queries, _ = lsh_corpus(n, nq, S, seed=0)
    mins[: n // 2, :21] = 3  # half the rows share half their slots
    dev = torch.device("cuda", 0)
    pad = (-n) % C
    rows = torch.from_numpy(np.vstack([mins, np.zeros((pad, S), np.uint64)]).astype(np.int64)
                            ).to(dev)
    q = torch.from_numpy(queries.astype(np.int64)).to(dev)
    b = chip_smoke.lsh_bound(n, nq, S)
    want = None
    for name, fn in VARIANTS.items():
        got = fn(q, rows)
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise SystemExit(f"FAIL {name}: counts differ from {next(iter(VARIANTS))}")
        dev_ms = chip_smoke.profiled_device_ms(lambda: fn(q, rows), reps=3)
        wall = chip_smoke.time_ms(lambda: fn(q, rows), reps=5, warm=1)
        print(f"{name}: device {dev_ms:.3f} ms, wall {wall:.3f} ms, bound {b[0]:.4f} ms "
              f"({b[1]}), {100 * b[0] / dev_ms:.2f}% of bound", flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
