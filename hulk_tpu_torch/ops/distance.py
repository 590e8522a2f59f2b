"""The all-pairs distance matrix of `smash`, blocked, on one device.

Counterpart of hulk_tpu/ops/distance.py: plain PyTorch, no hand-written
kernel (the reference's version is plain XLA). The reference CLI computes
the N x N matrix with a scalar double loop (cmd/smash.go:209-224); here it
is computed in [block, col_block] tiles, with at most MAX_PENDING_BLOCKS
tiles in flight on the device before the oldest is copied back.

Both metrics compare the mins as the host path does, after a cast to f64
(io/sketchio.py get_distance): two u64 mins that differ below f64's 53 bits
count as equal there, and so here.

With the reference's subject-weights semantics (sketchio.go:293-298: both
weight vectors come from the row's sketch), the weighted Jaccard distance is

    d(i -> j) = 1 - sum_k{ |w_i[k]| * [mins_i[k] == mins_j[k]] } / sum_k |w_i[k]|

The tile sums |w_i[k]| over the matching slots in slot order, left to
right, in f64, and divides by the row's sum taken on the host in the same
order: the host's get_wjd, operation for operation (adding 0.0 for a slot
that does not match changes nothing), so the tile's error against it is
zero. hulk_tpu instead sums row-normalised weights in another order and
casts each cell to f32; wjd_recheck_margin bounds the error of any f64
summation order, and the caller rechecks on the host every cell within it
of a %.2f rounding boundary.
"""
from __future__ import annotations

import numpy as np
import torch

# Tiles in flight on the device before the oldest is copied back: device
# memory for results stays at MAX_PENDING_BLOCKS * block * col_block * 8
# bytes (about 512 MB at the defaults) whatever N is.
MAX_PENDING_BLOCKS = 32

# Cells recomputed on the host by the CLI's boundary recheck, for
# measurement.
recheck_stats = {"cells": 0}


def wjd_recheck_margin(s: int) -> float:
    """A sound bound on |tile d - host d| for a tile summed in any order in
    f64, with 4x slack. Each of the host's two left-to-right sums, and the
    tile's, is within (s - 1) * 2^-53 of the exact sum relative to the row
    total (the terms are non-negative); the divides and the subtraction add
    2^-53 each. The two d's are within (4s + 4) * 2^-53 of each other. A
    cell farther than this from a %.2f boundary prints the host's digits;
    cells inside it are recomputed on the host."""
    return 4.0 * (4 * s + 4) * 2.0 ** -53


def jaccard_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, s] x [C, s] f64 mins -> [B, C] int32 positional match counts."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for k in range(a.shape[1]):
        out += a[:, k, None] == b[None, :, k]
    return out


def wjd_block_body(a: torch.Tensor, wabs: torch.Tensor, union: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """[B, s] f64 mins, their |weights| [B, s] and row sums [B] x [C, s] f64
    mins -> [B, C] f64 distances: the matching weights summed over slots in
    slot order, then 1 - sum / union (module docstring)."""
    inter = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64, device=a.device)
    for k in range(a.shape[1]):
        inter += torch.where(a[:, k, None] == b[None, :, k], wabs[:, k, None], 0.0)
    return 1.0 - inter / union[:, None]


def _tiles(nr: int, nc: int, block: int, col_block: int, tile, post) -> np.ndarray:
    """Run tile(i0, i1, j0, j1) over an [nr, nc] matrix in row blocks and
    column blocks, copying each result back behind a window of
    MAX_PENDING_BLOCKS tiles; post maps a fetched tile to f64."""
    out = np.empty((nr, nc), dtype=np.float64)
    pend: list = []

    def drain(keep: int) -> None:
        while len(pend) > keep:
            i0, i1, j0, j1, t = pend.pop(0)
            out[i0:i1, j0:j1] = post(t.cpu().numpy())

    for i0 in range(0, nr, block):
        i1 = min(i0 + block, nr)
        for j0 in range(0, nc, col_block):
            j1 = min(j0 + col_block, nc)
            pend.append((i0, i1, j0, j1, tile(i0, i1, j0, j1)))
            drain(MAX_PENDING_BLOCKS)
    drain(0)
    return out


def _f64_mins(mins, device) -> torch.Tensor:
    """The mins as the host path compares them: u64 cast to f64."""
    return torch.from_numpy(np.asarray(mins, dtype=np.uint64).astype(np.float64)).to(device)


def pairwise_jaccard_sim(mins, *, block: int = 512, col_block: int = 4096,
                         device="cuda") -> np.ndarray:
    """[N, s] u64 sketch mins -> [N, N] positional-match similarity
    count / s in f64 (exact: integer counts, one IEEE divide)."""
    m = _f64_mins(mins, device)
    n, s = m.shape
    return _tiles(n, n, block, col_block,
                  lambda i0, i1, j0, j1: jaccard_block(m[i0:i1], m[j0:j1]),
                  lambda c: c / s)


def weighted_jaccard_rows(mins, weights, lo: int, hi: int, devices, *, block: int = 512,
                          col_block: int = 4096) -> np.ndarray:
    """Rows [lo, hi) of the [N, N] weighted Jaccard distance matrix of [N, s]
    u64 mins + f64 weights, with the reference's subject-weights semantics
    (row = subject); row blocks go round robin over `devices`, each of which
    holds every row's mins for the columns."""
    wabs = np.abs(np.asarray(weights, dtype=np.float64))
    union = np.zeros(wabs.shape[0])
    for k in range(wabs.shape[1]):  # left to right, as get_wjd sums
        union += wabs[:, k]
    m = [_f64_mins(mins, d) for d in devices]
    wa = [torch.from_numpy(wabs[lo:hi]).to(d) for d in devices]
    un = [torch.from_numpy(union[lo:hi]).to(d) for d in devices]

    def tile(i0, i1, j0, j1):
        d = (i0 // block) % len(devices)
        return wjd_block_body(m[d][lo + i0:lo + i1], wa[d][i0:i1], un[d][i0:i1], m[d][j0:j1])

    return _tiles(hi - lo, wabs.shape[0], block, col_block, tile, lambda d: d)


def pairwise_weighted_jaccard_dist(mins, weights, *, block: int = 512,
                                   col_block: int = 4096, device="cuda") -> np.ndarray:
    """The whole [N, N] weighted Jaccard distance matrix on one device."""
    return weighted_jaccard_rows(mins, weights, 0, len(mins), [device], block=block,
                                 col_block=col_block)
