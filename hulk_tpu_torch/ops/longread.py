"""Minimizers of reads of any length, block by block.

Counterpart of hulk_tpu/ops/longread.py. The batched step works on
[R, L] shapes, and a 10 Mb contig must not become a [R, 10M] tensor, so
one long read is cut into blocks of S bases that overlap by the halo
H = w + k - 1 and scanned with the same window op:

  * block 0 is a normal scan (the span and report ramps at the read start
    are genuine);
  * blocks b >= 1 start at global offset b*(S-H) and take the `cont` form
    (span k everywhere, reporting from local position H), so every
    reported window equals the in-context one and the blocks' reported
    windows tile the read's exactly (derivation in
    hulk_tpu/ops/minimizer.py:minimizer_window's docstring);
  * each block's distinct values are taken on the device, and the union
    over blocks (np.unique) on the host gives the read's distinct set.

Blocks go to the device in fixed [group, S] shapes. On the card block 0
runs the u8 entry of the minimizer kernel and each group of continuation
blocks its cont entry (ops/minimizer_cuda.py); on the CPU, the plain
version.
"""
from __future__ import annotations

import numpy as np
import torch

from hulk_tpu_torch.ops.minimizer import minimizer_window, per_read_distinct

DEFAULT_BLOCK = 1 << 16
DEFAULT_GROUP = 16


def _block_values(rows: np.ndarray, lens: np.ndarray, *, k: int, w: int, cont: bool,
                  device) -> np.ndarray:
    """The distinct reported values of each block row, concatenated (u64)."""
    codes = torch.from_numpy(rows).to(device)
    lengths = torch.from_numpy(lens).to(device)
    vals, mask = per_read_distinct(*minimizer_window(codes, lengths, k, w, cont))
    return vals[mask].cpu().numpy().view(np.uint64)


def long_read_minimizers(codes: np.ndarray, *, k: int, w: int,
                         block: int = DEFAULT_BLOCK, group: int = DEFAULT_GROUP,
                         device="cuda") -> np.ndarray:
    """Distinct minimizer values (sorted uint64) of ONE read of any length.

    codes: [L] uint8 base codes (0-4). Works for any L >= w + k - 1 and is
    bit-identical to scanning the read in one piece."""
    L = int(codes.shape[0])
    if L < w + k - 1:
        raise ValueError("sequence length must be >= w + k - 1")
    H = w + k - 1
    S = block
    if S <= H:
        raise ValueError(f"block must exceed the halo w+k-1 ({H})")

    first = np.full((1, S), 5, dtype=np.uint8)
    n0 = min(L, S)
    first[0, :n0] = codes[:n0]
    pieces = [_block_values(first, np.array([n0], dtype=np.int32), k=k, w=w,
                            cont=False, device=device)]

    # continuation blocks at stride S-H; only blocks longer than H report
    starts = list(range(S - H, L - H, S - H))
    for i in range(0, len(starts), group):
        rows = np.full((group, S), 5, dtype=np.uint8)
        lens = np.zeros(group, dtype=np.int32)
        for j, g0 in enumerate(starts[i:i + group]):
            n = min(L - g0, S)
            rows[j, :n] = codes[g0:g0 + n]
            lens[j] = n
        pieces.append(_block_values(rows, lens, k=k, w=w, cont=True, device=device))
    return np.unique(np.concatenate(pieces))
