"""Gamma(2, 1) draws as go_rng's GammaGenerator makes them (Cheng 1977, the
alpha > 1 branch of Python's random.gammavariate), bit for bit, for the CWS
tables.

Each attempt at stream position i takes u1 = u[i] and, when 1e-7 < u1 <
0.9999999, u2 = 1 - u[i+1]; an attempt with u1 out of range consumes one
draw, any other two. Out-of-range draws are rare (2e-7), so the attempts run
at i, i+2, i+4, ... from one such draw to the next one of the same parity,
where the walk steps by one: the walk goes segment by segment, vectorised
inside each.
"""
from __future__ import annotations

import numpy as np

from hulkbench.reference.fdlibm import go_exp, go_log, log4, sg_magicconst
from hulkbench.reference.gorand import GoRand

_CHUNK = 1 << 21


def _attempts(u: np.ndarray) -> tuple[np.ndarray, int]:
    """The attempt positions of a walk from 0 over u, each with its
    lookahead inside u, and the position where the walk goes on."""
    stop = u.shape[0] - 1
    bad = np.flatnonzero(~((1e-7 < u) & (u < 0.9999999)))
    out, p = [], 0
    while True:
        same = bad[(bad >= p) & ((bad - p) % 2 == 0)]
        q = int(same[0]) if same.size else u.shape[0]
        end = min(q, stop)
        out.append(np.arange(p, end, 2))
        if q < stop:
            p = q + 1  # an out-of-range u1 consumes one draw
            continue
        return np.concatenate(out), p + max(0, -(-(end - p) // 2) * 2)


def gamma_block(rng: GoRand, n: int, alpha: float = 2.0) -> np.ndarray:
    """n sequential Gamma(alpha, 1) draws from rng's Float64 stream."""
    ainv = np.sqrt(2.0 * alpha - 1.0)
    bbb = alpha - log4()
    ccc = alpha + ainv
    sg = sg_magicconst()
    parts, got = [], 0
    tail = np.empty(0, dtype=np.float64)
    while got < n:
        u = np.concatenate([tail, rng.float64_block(_CHUNK)])
        pos, nxt = _attempts(u)
        u1, u2 = u[pos], 1.0 - u[pos + 1]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            v = go_log(u1 / (1.0 - u1)) / ainv
            x = alpha * go_exp(v)
            z = u1 * u1 * u2
            r = bbb + ccc * v - x
            accept = (r + sg - 4.5 * z >= 0.0) | (r >= go_log(z))
        took = x[accept]
        parts.append(took)
        got += took.shape[0]
        tail = u[nxt:]
    return np.concatenate(parts)[:n]
