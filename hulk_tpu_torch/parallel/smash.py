"""All-pairs weighted-Jaccard smash over several devices and processes.

Counterpart of hulk_tpu/parallel/smash.py. The matrix's row blocks go round
robin over the devices of this process (parallel/mesh.make_sketch_mesh), and
every device computes its tiles with the port's exact tile
(ops/distance.wjd_block_body: the host's get_wjd operation for operation),
so every cell is the single-device matrix's, whatever the device count or
process count.

Several processes: each loads its shard of the sketch JSONs
(parallel/distributed.process_read_shard), the [n_i, s] mins and weights
are allgathered (bytes, exact), each process computes a contiguous stripe of
rows on its devices, and the stripes are allgathered so every process holds
the whole matrix (process 0 writes the CSV).
"""
from __future__ import annotations

import numpy as np

from hulk_tpu_torch.ops import distance
from hulk_tpu_torch.parallel import distributed as dist
from hulk_tpu_torch.parallel.mesh import make_sketch_mesh


def _pad_rows_to(x: np.ndarray, m: int) -> np.ndarray:
    p = m - x.shape[0]
    return np.pad(x, ((0, p),) + ((0, 0),) * (x.ndim - 1)) if p else x


def sharded_wjd_rows(mins, weights, lo: int, hi: int, *, devices=None,
                     block: int = 512, col_block: int = 4096) -> np.ndarray:
    """Rows [lo, hi) of the [N, N] weighted-Jaccard distance matrix
    (reference subject-weights semantics), row blocks of `block` rows round
    robin over `devices` (default: every visible CUDA device)."""
    return distance.weighted_jaccard_rows(mins, weights, lo, hi,
                                          make_sketch_mesh(devices=devices), block=block,
                                          col_block=col_block)


def sharded_pairwise_wjd(mins, weights, *, devices=None, block: int = 512,
                         col_block: int = 4096) -> np.ndarray:
    """Full [N, N] matrix on this process's devices."""
    return sharded_wjd_rows(mins, weights, 0, np.asarray(mins).shape[0], devices=devices,
                            block=block, col_block=col_block)


def distributed_pairwise_wjd(local_mins, local_weights, *, devices=None,
                             block: int = 512, col_block: int = 4096):
    """Multi-process all-pairs: allgather each process's n_i rows of s
    mins+weights (arrays or lists of rows; variable n_i: the counts first,
    then blocks padded to the largest), compute this process's contiguous row stripe on its devices,
    allgather the stripes. Returns ([N, s] u64 mins, [N, s] weights,
    [N, N] matrix), identical on every process and in global sorted file
    order when callers shard files with process_read_shard (which hands
    process p the sorted files p, p+nproc, ...)."""
    nproc, pid = dist.world_size(), dist.rank()
    # (rows, s) of every process, s = -1 for rows of several lengths: every
    # process sees every shape, so all raise together on a mismatch rather
    # than leave the others waiting in a collective
    sizes = {len(m) for m in local_mins}
    my_s = -1 if len(sizes) > 1 else sizes.pop() if sizes else 0
    shapes = dist.allgather(np.array([len(local_mins), my_s], dtype=np.int64))
    counts = shapes[:, 0]
    lengths = sorted(set(shapes[counts > 0, 1].tolist()))
    if len(lengths) != 1 or lengths[0] < 0:
        raise ValueError(f"sketch length mismatch across the sketches: {lengths}")
    s = lengths[0]
    nmax = int(counts.max())
    local_mins = np.asarray(local_mins, dtype=np.uint64).reshape(-1, s)
    local_weights = np.asarray(local_weights, dtype=np.float64).reshape(-1, s)
    g_m = dist.allgather(_pad_rows_to(local_mins, nmax))
    g_w = dist.allgather(_pad_rows_to(local_weights, nmax))

    # undo the round-robin file sharding: local index i on process p is
    # global sorted index i*nproc + p
    n = int(counts.sum())
    mins = np.empty((n, s), dtype=np.uint64)
    weights = np.empty((n, s), dtype=np.float64)
    for p in range(nproc):
        idx = np.arange(int(counts[p])) * nproc + p
        mins[idx] = g_m[p, : counts[p]]
        weights[idx] = g_w[p, : counts[p]]

    lo = (n * pid) // nproc
    hi = (n * (pid + 1)) // nproc
    my = sharded_wjd_rows(mins, weights, lo, hi, devices=devices, block=block,
                          col_block=col_block)
    g_rows = dist.allgather(_pad_rows_to(my, -(-n // nproc)))
    out = np.empty((n, n), dtype=np.float64)
    for p in range(nproc):
        plo = (n * p) // nproc
        phi = (n * (p + 1)) // nproc
        out[plo:phi] = g_rows[p, : phi - plo]
    return mins, weights, out
