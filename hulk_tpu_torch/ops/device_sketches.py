"""The secondary sketches (KMV, KHF, HyperMinHash) kept on the device.

Counterpart of hulk_tpu/ops/device_sketches.py: the states update from the
same distinct minimizer values as the spectrum, so `sketch --kmv --khf
--hmh` needs no host pull a batch. Plain PyTorch, as the reference left
them to XLA; u64 values travel as int64 bits (hulk_tpu_torch/_u64.py), and
every update is integer-exact, so the states bit-match the host classes
(sketch/minhash.py, sketch/hyperminhash.py) fed the same values.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from hulk_tpu_torch._u64 import I64MAX, SENT, SIGN, flip, srl, usort
from hulk_tpu_torch.sketch.hyperminhash import DEFAULT_P, DEFAULT_Q, DEFAULT_R


def _i64(u: int) -> int:
    """A u64 constant as the int64 of the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


@dataclass
class SketchStates:
    """Device states of the sketches that are on (None for those off):
    kmv [s] the bottom s values ascending in unsigned order, SENT padded;
    khf [s] the minima of (i+1)*v mod 2^64; hmh [2^p] registers (< 2^22)."""
    kmv: torch.Tensor | None = None
    khf: torch.Tensor | None = None
    hmh: torch.Tensor | None = None

    @classmethod
    def empty(cls, s: int, *, kmv: bool, khf: bool, hmh: bool, device) -> "SketchStates":
        full = lambda n, v: torch.full((n,), v, dtype=torch.int64, device=device)  # noqa: E731
        return cls(kmv=full(s, SENT) if kmv else None, khf=full(s, SENT) if khf else None,
                   hmh=full(1 << DEFAULT_P, 0) if hmh else None)


def kmv_update(state: torch.Tensor, svals: torch.Tensor) -> torch.Tensor:
    """state [s]: the bottom s so far. svals: a batch's values whose first s
    are its s smallest in unsigned order (SENT padded). One merge of 2s."""
    s = state.shape[0]
    return usort(torch.cat([state, svals[:s]]))[:s]


def khf_update(state: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """state [s]: the minima of v + i*v = (i+1)*v, wrapping mod 2^64, over
    the live values of vals [N] (SENT marks a dead lane; the mask applies
    after the product, since no input is a maximum under the wrap). The
    [s, N] product is taken in one pass: fed the live distinct prefix, it
    is 42 x 410,901 x 8 bytes = 138 MB at the main path's batch."""
    s, n = state.shape[0], vals.shape[0]
    if n == 0:
        return state
    mult = torch.arange(1, s + 1, dtype=torch.int64, device=vals.device)[:, None]
    mins = torch.where(vals != SENT, (vals * mult) ^ SIGN, I64MAX).amin(dim=1)
    return flip(torch.minimum(flip(state), mins))


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on u64 bits (logical shifts, wrapping
    products)."""
    z = (x ^ srl(x, 30)) * _MIX1
    z = (z ^ srl(z, 27)) * _MIX2
    return z ^ srl(z, 31)


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of u64 bits: x >= 2^sh (unsigned) exactly when
    srl(x, sh) != 0."""
    n = torch.zeros_like(x)
    for sh in (32, 16, 8, 4, 2, 1):
        big = srl(x, sh) != 0
        n += torch.where(big, sh, 0)
        x = torch.where(big, srl(x, sh), x)
    return n + (x != 0).to(torch.int64)


def hmh_update(registers: torch.Tensor, vals: torch.Tensor, *, p: int = DEFAULT_P,
               q: int = DEFAULT_Q, r: int = DEFAULT_R) -> torch.Tensor:
    """Register max of the live values of vals (HyperMinHash.add_hashes):
    bucket = the top p bits of mix64(v), register = (lz << r) | (2^r - 1 -
    low r bits). Registers are < 2^(q+r) <= 2^22, so a signed amax is
    exact; dead lanes add 0 to register 0, which is a no-op."""
    live = vals != SENT
    h = _mix64(vals)
    lz = torch.clamp(64 - _bitlen(h << p) + 1, max=(1 << q) - 1)
    enc = (lz << r) | (((1 << r) - 1) - (h & ((1 << r) - 1)))
    bucket = torch.where(live, srl(h, 64 - p), 0)
    return registers.scatter_reduce(0, bucket, torch.where(live, enc, 0), "amax")
