"""The CWS tables of the histosketch, worked out from Go's RNG with no help
from the program: three [sketch size, bins] float64 matrices from two Go
rand streams, both seeded with DISTRIBUTION_SEED = 1 (hulk's
src/histosketch/histosketch.go:95-126):

    r[i][j] = Gamma(2, 1)               gamma stream, draw 2 (i * bins + j)
    c[i][j] = Log(Gamma(2, 1))          gamma stream, draw 2 (i * bins + j) + 1
    b[i][j] = Float64() * r[i][j]       uniform stream, draw i * bins + j

and exp_r = Exp(r), which the update uses. They are the same for every run,
so they are kept as .npy files in a cache directory of the benchmark's own
inside the checkout (built once, memory-mapped after).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from hulkbench.reference.fdlibm import go_exp, go_log
from hulkbench.reference.gamma import gamma_block
from hulkbench.reference.gorand import GoRand

DISTRIBUTION_SEED = 1
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         ".cache", "reference")


@dataclass
class Tables:
    c: np.ndarray  # [s, bins]
    b: np.ndarray  # [s, bins]
    exp_r: np.ndarray  # [s, bins]


def build(s: int, bins: int) -> Tables:
    cells = s * bins
    g = gamma_block(GoRand(DISTRIBUTION_SEED), 2 * cells)
    r = g[0::2].reshape(s, bins)
    c = go_log(g[1::2]).reshape(s, bins)
    b = GoRand(DISTRIBUTION_SEED).float64_block(cells).reshape(s, bins) * r
    return Tables(c=c, b=b, exp_r=go_exp(r))


def tables(s: int, bins: int, cache_dir: str = CACHE_DIR) -> Tables:
    """The tables for (s, bins), from the cache or built and cached."""
    base = os.path.join(cache_dir, f"cws_s{s}_d{bins}")
    names = ("c", "b", "exp_r")
    if all(os.path.exists(f"{base}.{n}.npy") for n in names):
        return Tables(*(np.load(f"{base}.{n}.npy", mmap_mode="r") for n in names))
    t = build(s, bins)
    os.makedirs(cache_dir, exist_ok=True)
    for n in names:
        tmp = f"{base}.{n}.part.npy"
        np.save(tmp, getattr(t, n))
        os.replace(tmp, f"{base}.{n}.npy")
    return t
