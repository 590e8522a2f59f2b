"""The histosketch flush's Aka, exact: Go's math.Exp and math.Log in PyTorch.

For each sketch slot j and live bin i of a flush,
Aka[j][i] = c[j][bin_i] / (Exp(Log(esti_i) - b[j][bin_i]) * exp_r[j][bin_i])
(src/histosketch/histosketch.go:129-155), with Go's Exp and Log. The exact
host flush computes it so (native/hulkrt.cpp hulk_flush_exact), and
hashes/fdlibm.py holds the NumPy ports of the two functions. hulk_tpu's
sharded_flush_step takes XLA's exp and log, within a few ULP of Go's.

`go_exp_torch` and `go_log_torch` follow Go's exp.go and log.go operation
for operation, each elementwise op rounded once (float64 tensors; no op
fuses a multiply and an add). frexp is read from the bits and Ldexp is two
multiplies by powers of two, as the kernel does them (csrc/cws_aka.cu), so
the plain version gives the same bits on any device. `cws_aka` takes the
plain version for CPU tensors and the Hopper kernel
(ops/cws_aka_cuda.py) for CUDA tensors.
"""
from __future__ import annotations

import torch

from hulk_tpu_torch.hashes import fdlibm

_TINY = 2.2250738585072014e-308  # smallest normal f64


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e (float64) for int64 e in [-1022, 1023], from its bits."""
    return ((e + 1023) << 52).view(torch.float64)


def go_exp_torch(x: torch.Tensor) -> torch.Tensor:
    """Go's math.Exp of a float64 tensor, elementwise."""
    special = ~((x >= fdlibm._UNDERFLOW) & (x <= fdlibm._OVERFLOW))  # NaN, inf, out of range
    near = x.abs() < fdlibm._NEAR_ZERO
    xs = torch.where(special | near, 0.0, x)
    kx = fdlibm._LOG2E * xs
    k = torch.trunc(torch.where(xs < 0, kx - 0.5, kx + 0.5)).to(torch.int64)
    kd = k.double()
    hi = xs - kd * fdlibm._LN2_HI
    lo = kd * fdlibm._LN2_LO
    r = hi - lo
    t = r * r
    c = r - t * (fdlibm._P1 + t * (fdlibm._P2 + t * (fdlibm._P3 + t * (fdlibm._P4
                                                                       + t * fdlibm._P5))))
    y = 1.0 - ((lo - (r * c) / (2.0 - c)) - hi)
    h = torch.div(k, 2, rounding_mode="trunc")
    out = y * _pow2(h) * _pow2(k - h)  # Ldexp(y, k), rounded once
    out = torch.where(near, 1.0 + x, out)
    out = torch.where(x > fdlibm._OVERFLOW, float("inf"), out)
    out = torch.where(x < fdlibm._UNDERFLOW, 0.0, out)
    return torch.where(torch.isnan(x), x, out)


def go_log_torch(x: torch.Tensor) -> torch.Tensor:
    """Go's math.Log of a float64 tensor, elementwise."""
    ok = (x > 0) & torch.isfinite(x)
    xs = torch.where(ok, x, 1.0)
    sub = xs < _TINY
    xs = torch.where(sub, xs * 2.0 ** 54, xs)  # a subnormal into the normals, exactly
    bits = xs.view(torch.int64)
    ki = ((bits >> 52) & 0x7FF) - 1022 - torch.where(sub, 54, 0)
    f1 = ((bits & ~(0x7FF << 52)) | (1022 << 52)).view(torch.float64)  # frexp: [0.5, 1)
    small = f1 < fdlibm._SQRT2_OVER_2
    f1 = torch.where(small, f1 * 2.0, f1)
    k = (ki - small.to(torch.int64)).double()
    f = f1 - 1.0
    s = f / (2.0 + f)
    s2 = s * s
    s4 = s2 * s2
    t1 = s2 * (fdlibm._L1 + s4 * (fdlibm._L3 + s4 * (fdlibm._L5 + s4 * fdlibm._L7)))
    t2 = s4 * (fdlibm._L2 + s4 * (fdlibm._L4 + s4 * fdlibm._L6))
    R = t1 + t2
    hfsq = 0.5 * f * f
    out = k * fdlibm._LN2_HI - ((hfsq - (s * (hfsq + R) + k * fdlibm._LN2_LO)) - f)
    out = torch.where(x == 0, float("-inf"), out)
    out = torch.where(x < 0, float("nan"), out)
    out = torch.where(x == float("inf"), x, out)
    return torch.where(torch.isnan(x), x, out)


def cws_aka_torch(esti: torch.Tensor, ids: torch.Tensor, c: torch.Tensor, b: torch.Tensor,
                  exp_r: torch.Tensor) -> torch.Tensor:
    """Plain version: esti [n] f64 (the live bins' estimates), ids [n] int64
    (their bin ids), c, b, exp_r [s, nbins] f64 -> Aka [s, n] f64."""
    lf = go_log_torch(esti)
    yka = go_exp_torch(lf[None, :] - b[:, ids])
    return c[:, ids] / (yka * exp_r[:, ids])


def cws_aka(esti: torch.Tensor, ids: torch.Tensor, c: torch.Tensor, b: torch.Tensor,
            exp_r: torch.Tensor) -> torch.Tensor:
    """Aka: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (which raises rather than fall back)."""
    if c.device.type == "cpu":
        return cws_aka_torch(esti, ids, c, b, exp_r)
    from hulk_tpu_torch.ops.cws_aka_cuda import cws_aka_cuda

    return cws_aka_cuda(esti, ids, c, b, exp_r)
