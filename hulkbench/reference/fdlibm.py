"""Go's math.Exp and math.Log, vectorised in NumPy: a frozen copy for the
benchmark's reference.

The histosketch update computes Exp(Log(freq) - b) and the CWS tables take
Log of gamma draws; Go's functions are ports of FreeBSD msun (fdlibm) and
differ from glibc by one ULP on some inputs, so these follow Go's exp.go and
log.go operation for operation.
"""
from __future__ import annotations

import numpy as np

# ---- Go math/exp.go constants -------------------------------------------
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_LOG2E = 1.44269504088896338700e+00
_OVERFLOW = 7.09782712893383973096e+02
_UNDERFLOW = -7.45133219101941108420e+02
_NEAR_ZERO = 1.0 / (1 << 28)

_P1 = 1.66666666666666657415e-01  # Go's expmulti P1, 0x3FC5555555555555
_P2 = -2.77777777770155933842e-03
_P3 = 6.61375632143793436117e-05
_P4 = -1.65339022054652515390e-06
_P5 = 4.13813679705723846039e-08

# ---- Go math/log.go constants -------------------------------------------
_L1 = 6.666666666666735130e-01
_L2 = 3.999999999940941908e-01
_L3 = 2.857142874366239149e-01
_L4 = 2.222219843214978396e-01
_L5 = 1.818357216161805012e-01
_L6 = 1.531383769920937332e-01
_L7 = 1.479819860511658591e-01
_SQRT2_OVER_2 = 0.7071067811865476  # Sqrt2/2 constant fold


def go_exp(x):
    """Go math.Exp, vectorised. Matches Go bit-for-bit on float64 inputs."""
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x)

    with np.errstate(invalid="ignore", over="ignore", under="ignore"):
        # reduce: k = int(Log2e*x ± 0.5), truncated toward zero like Go int()
        kf = np.where(x < 0, _LOG2E * x - 0.5, _LOG2E * x + 0.5)
        k = np.trunc(kf)
        hi = x - k * _LN2_HI
        lo = k * _LN2_LO

        r = hi - lo
        t = r * r
        c = r - t * (_P1 + t * (_P2 + t * (_P3 + t * (_P4 + t * _P5))))
        y = 1.0 - ((lo - (r * c) / (2.0 - c)) - hi)
        out = np.ldexp(y, k.astype(np.int64))

        # special cases (applied last, mirroring Go's early returns)
        near = np.abs(x) < _NEAR_ZERO
        out = np.where(near, 1.0 + x, out)
        out = np.where(x > _OVERFLOW, np.inf, out)
        out = np.where(x < _UNDERFLOW, 0.0, out)
        out = np.where(np.isnan(x), np.nan, out)
        out = np.where(np.isposinf(x), np.inf, out)
        out = np.where(np.isneginf(x), 0.0, out)
    return out[0] if scalar else out


def go_log(x):
    """Go math.Log, vectorised. Matches Go bit-for-bit on float64 inputs."""
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x)

    with np.errstate(invalid="ignore", divide="ignore", under="ignore"):
        f1, ki = np.frexp(x)
        small = f1 < _SQRT2_OVER_2
        f1 = np.where(small, f1 * 2.0, f1)
        ki = np.where(small, ki - 1, ki)
        f = f1 - 1.0
        k = ki.astype(np.float64)

        s = f / (2.0 + f)
        s2 = s * s
        s4 = s2 * s2
        t1 = s2 * (_L1 + s4 * (_L3 + s4 * (_L5 + s4 * _L7)))
        t2 = s4 * (_L2 + s4 * (_L4 + s4 * _L6))
        R = t1 + t2
        hfsq = 0.5 * f * f
        out = k * _LN2_HI - ((hfsq - (s * (hfsq + R) + k * _LN2_LO)) - f)

        out = np.where(x == 0.0, -np.inf, out)
        out = np.where(x < 0.0, np.nan, out)
        out = np.where(np.isnan(x), np.nan, out)
        out = np.where(np.isposinf(x), np.inf, out)
    return out[0] if scalar else out


# Runtime-computed constants exactly as Python's random.py / go_rng do.
def log4() -> float:
    return float(go_log(4.0))


def sg_magicconst() -> float:
    return 1.0 + float(go_log(4.5))
