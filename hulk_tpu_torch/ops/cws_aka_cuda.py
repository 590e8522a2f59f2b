"""Wrapper of the Hopper Aka kernel (csrc/cws_aka.cu).

`cws_aka_cuda` computes each slot's Aka of a flush's live bins with Go's
Exp and Log, bit for bit as the exact host flush and the plain version
(ops/cws_aka.py:cws_aka_torch) do. It replaces the XLA exp/log of
hulk_tpu/parallel/mesh.py:sharded_flush_step (no Pallas kernel there). The
wrapper checks its inputs, allocates the output, launches on PyTorch's
current stream and counts its launches in `launches`. The inputs are left
as they are.
"""
from __future__ import annotations

import ctypes

import torch

from hulk_tpu_torch.ops import _build
from hulk_tpu_torch.ops.flush_drift_cuda import _check

SOURCE = "hulk_tpu_torch/csrc/cws_aka.cu"
# launches of the entry in this process
launches = {"cws_aka": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {
    # esti, ids, n, c, b, exp_r, s, nbins, aka, stream
    "hulk_cws_aka": [_P, _P, _LL, _P, _P, _P, _I, _LL, _P, _P],
}


def entry(name: str):
    """The bound C entry (for callers that queue launches themselves)."""
    return _build.entry(name, ARGTYPES[name])


def cws_aka_cuda(esti: torch.Tensor, ids: torch.Tensor, c: torch.Tensor, b: torch.Tensor,
                 exp_r: torch.Tensor) -> torch.Tensor:
    """esti [n] f64 (the live bins' frequency estimates), ids [n] int64
    (their bin ids, each in [0, nbins)), c, b, exp_r [s, nbins] f64 (a
    stripe of the CWS tables), on one CUDA device -> Aka [s, n] f64."""
    what = "cws_aka_cuda"
    _check(what, c.device, esti=(esti, torch.float64, 1), ids=(ids, torch.int64, 1),
           c=(c, torch.float64, 2), b=(b, torch.float64, 2), exp_r=(exp_r, torch.float64, 2))
    s, nbins = c.shape
    n = esti.shape[0]
    if ids.shape[0] != n or b.shape != c.shape or exp_r.shape != c.shape:
        raise ValueError(f"{what}: esti [{n}] needs ids [{n}]; c, b and exp_r one shape")
    aka = torch.empty((s, n), dtype=torch.float64, device=c.device)
    fn = entry("hulk_cws_aka")
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(esti.data_ptr(), ids.data_ptr(), n, c.data_ptr(), b.data_ptr(),
                 exp_r.data_ptr(), s, nbins, aka.data_ptr(), stream)
    _build.check_launch(err, "cws_aka")
    _build.count_launch(launches, "cws_aka")
    return aka
