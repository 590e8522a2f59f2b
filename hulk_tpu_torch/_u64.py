"""u64 values carried as int64 bit patterns.

`torch.uint64` has no arithmetic on the CPU (no add, shifts, compares,
minimum or sort), so the port keeps every u64 quantity of the reference
(k-mers, hashes, sort keys, jump-hash keys) in int64 tensors holding the same
64 bits. Addition, multiplication, left shift and the bitwise operators wrap
exactly as u64 arithmetic does. Three operations differ, and go through here:

  * unsigned order: flip bit 63 (`x ^ SIGN`) and compare or sort signed;
  * logical right shift: arithmetic shift, then mask off the copied sign;
  * the all-ones sentinel U64MAX is -1.
"""
from __future__ import annotations

import torch

SENT = -1  # U64MAX, the reference's dead-lane sentinel
SIGN = -(1 << 63)  # bit 63 alone, as an int64
I64MAX = (1 << 63) - 1


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by a constant 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def flip(x: torch.Tensor) -> torch.Tensor:
    """Map u64 order onto int64 order (an involution)."""
    return x ^ SIGN


def ugt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a > b as u64."""
    return flip(a) > flip(b)


def usort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sort u64 bit patterns along dim in unsigned order (the sentinel sorts
    last)."""
    return flip(torch.sort(flip(x), dim=dim).values)

