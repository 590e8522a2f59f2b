"""Go's math/rand default source (rngSource), bit for bit: a frozen copy for
the benchmark's reference.

A 607/273 additive lagged-Fibonacci generator over int64, seeded by a Lehmer
LCG stream XORed with Go's baked-in rngCooked table (_data/rng_cooked.npy;
the known seed-1 outputs 5577006791947779410, 8674665223082153551 hold it).
Float64 is Int63()/2^63 with a redraw when that rounds to 1.0
(math/rand/rand.go).
"""
from __future__ import annotations

import os

import numpy as np

_LEN = 607
_TAP = 273
_FEEDGAP = _LEN - _TAP  # 334
_M31 = (1 << 31) - 1
_MASK63 = np.uint64((1 << 63) - 1)

_COOKED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_data", "rng_cooked.npy")


def _seedrand(x: int) -> int:
    """Go's seedrand: x = 48271 * x mod 2^31 - 1 (Schrage)."""
    hi, lo = divmod(x, 44488)
    x = 48271 * lo - 3399 * hi
    return x + _M31 if x < 0 else x


class GoRand:
    """rand.New(rand.NewSource(seed)), its Int63 and Float64 streams in bulk."""

    def __init__(self, seed: int):
        cooked = np.load(_COOKED).view(np.uint64)
        if cooked.shape != (_LEN,):
            raise ValueError("corrupt rng_cooked table")
        vec = np.zeros(_LEN, dtype=np.uint64)
        x = seed % _M31
        if x == 0:
            x = 89482311
        for i in range(-20, _LEN):
            x = _seedrand(x)
            if i >= 0:
                u = x << 40
                x = _seedrand(x)
                u ^= x << 20
                x = _seedrand(x)
                u ^= x
                u ^= int(cooked[i])
                vec[i] = np.uint64(u & 0xFFFFFFFFFFFFFFFF)
        # history in sequence order: vec[i] holds x_n with (334 - n) mod 607 == i
        idx = np.arange(_LEN)
        self._hist = np.empty(_LEN, dtype=np.uint64)
        self._hist[np.where(idx <= 333, 333 - idx, 940 - idx)] = vec
        self._buf = np.empty(0, dtype=np.int64)
        self._pos = 0

    def _block(self) -> np.ndarray:
        """The next 273 Int63 values: x_m = x_{m-607} + x_{m-273}."""
        h = self._hist
        new = h[0:_TAP] + h[_FEEDGAP:_LEN]
        self._hist = np.concatenate([h[_TAP:], new])
        return (new & _MASK63).view(np.int64)

    def int63_block(self, n: int) -> np.ndarray:
        if self._buf.shape[0] - self._pos < n:
            blocks = [self._buf[self._pos:]]
            have = blocks[0].shape[0]
            while have < n:
                blocks.append(self._block())
                have += _TAP
            self._buf = np.concatenate(blocks)
            self._pos = 0
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def float64_block(self, n: int) -> np.ndarray:
        """n consecutive Float64 draws (a draw of exactly 1.0 is redrawn)."""
        raw = self.int63_block(n).astype(np.float64) / float(1 << 63)
        while np.any(raw == 1.0):
            i = int(np.flatnonzero(raw == 1.0)[0])
            redraw = self.int63_block(1).astype(np.float64) / float(1 << 63)
            raw = np.concatenate([raw[:i], raw[i + 1:], redraw])
        return raw
