"""Wrappers of the Hopper jump-hash kernel (csrc/jump_hash.cu).

Replaces hulk_tpu/ops/jump_pallas.py:jump_hash_pallas (and its padding
wrapper jump_hash_tpu: the card needs no lane padding). Three entries share
the kernel's loop: `jump_hash_cuda` returns every key's bucket (plain
version hulk_tpu_torch.hashes.jumphash.jump_hash_torch);
`bin_scatter_keys_cuda` bins the fused step's sorted keys into the
histogram in one pass, dedup and scatter-add included (the device step's
main path; plain version hulk_tpu_torch.ops.device_step.
bin_scatter_keys_torch); `bin_scatter_values_cuda` bins sorted values on
all 64 bits: the two-sort step's, every live one (k >= 23), or, with dedup,
a long record's distinct run heads, adding their number to the stream's
device count (counted apart, under "bin_scatter_values_dedup"; plain
version device_step.bin_scatter_values_torch). Each wrapper checks its
inputs, launches on PyTorch's current stream and counts its launches in
`launches`.

Two more entries measure the loop and are on no path: `jump_steps_cuda`
runs the counting form of the buckets entry (the loop's iterations and how
many took the exact step), and `seed_error_cuda` checks the reciprocal
seed's error over every divisor, the bound the loop's proof assumes.
"""
from __future__ import annotations

import ctypes

import torch

from hulk_tpu_torch.ops import _build

SOURCE = "hulk_tpu_torch/csrc/jump_hash.cu"
# launches of each entry in this process
launches = {"jump_hash": 0, "bin_scatter_keys": 0, "bin_scatter_values": 0,
            "bin_scatter_values_dedup": 0, "jump_hash_steps": 0, "jump_seed_error": 0}
# the loop's proof holds while the seed's relative error is at most this
# (csrc/jump_hash.cu)
SEED_ERROR_BOUND = 2.0**-16

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {
    # keys, N, n, out, stream
    "hulk_jump_hash": [_P, _LL, _LL, _P, _P],
    # skeys, N, vbits, hist, n, stream
    "hulk_bin_scatter_keys": [_P, _LL, _I, _P, _LL, _P],
    # svals, N, hist, n, dedup, count (or null), stream
    "hulk_bin_scatter_values": [_P, _LL, _P, _LL, _I, _P, _P],
    # keys, N, n, steps, stream
    "hulk_jump_hash_steps": [_P, _LL, _LL, _P, _P],
    # maxbits, stream
    "hulk_jump_seed_error": [_P, _P],
}


def entry(name: str):
    """The bound C entry (for callers that queue launches themselves)."""
    return _build.entry(name, ARGTYPES[name])


def _check_keys(what: str, keys: torch.Tensor) -> None:
    if keys.device.type != "cuda":
        raise ValueError(f"{what}: keys must be on a CUDA device")
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"{what}: keys must be a contiguous 1-D int64 tensor")


def _check_buckets(what: str, n: int) -> None:
    if not 0 < n < 2**31:
        raise ValueError(f"{what}: the bucket count must be in [1, 2^31), got {n}")


def _check_hist(what: str, hist: torch.Tensor, keys: torch.Tensor) -> None:
    _check_keys(what, keys)
    if hist.device != keys.device or hist.dtype != torch.int32 or hist.dim() != 1 \
            or not hist.is_contiguous():
        raise ValueError(f"{what}: hist must be a contiguous 1-D int32 tensor on the "
                         "keys' device")
    _check_buckets(what, hist.shape[0])


def jump_hash_cuda(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """keys [N] int64 (u64 bits), contiguous on a CUDA device -> [N] int32
    buckets in [0, num_buckets)."""
    _check_keys("jump_hash_cuda", keys)
    _check_buckets("jump_hash_cuda", num_buckets)
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return out
    fn = entry("hulk_jump_hash")
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(keys.data_ptr(), keys.numel(), num_buckets, out.data_ptr(), stream)
    _build.check_launch(err, "jump_hash")
    _build.count_launch(launches, "jump_hash")
    return out


def bin_scatter_keys_cuda(hist: torch.Tensor, skeys: torch.Tensor, vbits: int) -> None:
    """hist [n] int32 += the binned, adjacent-deduplicated live values of the
    sorted (read_id << vbits | value) keys skeys [N] int64 (u64 bits; the
    all-ones sentinel marks dead lanes), in place, on one CUDA device."""
    _check_hist("bin_scatter_keys_cuda", hist, skeys)
    if not 0 < vbits < 64:
        raise ValueError(f"bin_scatter_keys_cuda: vbits must be in [1, 63], got {vbits}")
    if skeys.numel() == 0:
        return
    fn = entry("hulk_bin_scatter_keys")
    with torch.cuda.device(skeys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(skeys.data_ptr(), skeys.numel(), vbits, hist.data_ptr(),
                 hist.shape[0], stream)
    _build.check_launch(err, "bin_scatter_keys")
    _build.count_launch(launches, "bin_scatter_keys")


def bin_scatter_values_cuda(hist: torch.Tensor, svals: torch.Tensor, *, dedup: bool = False,
                            count: torch.Tensor | None = None) -> None:
    """hist [n] int32 += the binned live values of the sorted svals [N]
    int64 (u64 bits, the all-ones sentinel marks dead lanes), in place, on
    one CUDA device: every one of them (the two-sort step: equal neighbours
    come from different reads), or with dedup each distinct one once.
    count: None, or an int64 [] on the same device that grows by the number
    of values binned."""
    _check_hist("bin_scatter_values_cuda", hist, svals)
    if count is not None and (count.device != svals.device or count.dtype != torch.int64
                              or count.dim() != 0):
        raise ValueError("bin_scatter_values_cuda: count must be an int64 [] on the "
                         "values' device")
    if svals.numel() == 0:
        return
    name = "bin_scatter_values_dedup" if dedup else "bin_scatter_values"
    fn = entry("hulk_bin_scatter_values")
    with torch.cuda.device(svals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(svals.data_ptr(), svals.numel(), hist.data_ptr(), hist.shape[0], int(dedup),
                 None if count is None else count.data_ptr(), stream)
    _build.check_launch(err, name)
    _build.count_launch(launches, name)


def jump_steps_cuda(keys: torch.Tensor, num_buckets: int) -> tuple[int, int]:
    """The counting form of jump_hash_cuda's loop over keys [N] int64 on a
    CUDA device: (iterations, iterations that took the exact step). Reads
    the two counts back."""
    _check_keys("jump_steps_cuda", keys)
    _check_buckets("jump_steps_cuda", num_buckets)
    steps = torch.zeros(2, dtype=torch.int64, device=keys.device)
    if keys.numel():
        fn = entry("hulk_jump_hash_steps")
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(keys.data_ptr(), keys.numel(), num_buckets, steps.data_ptr(), stream)
        _build.check_launch(err, "jump_hash_steps")
        _build.count_launch(launches, "jump_hash_steps")
    iterations, exact = steps.tolist()
    return iterations, exact


def seed_error_cuda(device: torch.device) -> float:
    """The largest |1 - s r0| of the loop's reciprocal seed r0 over all 2^31
    scaled divisors s = d 2^-31, on a CUDA device (read back)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("seed_error_cuda: needs a CUDA device")
    bits = torch.zeros((), dtype=torch.int64, device=device)
    fn = entry("hulk_jump_seed_error")
    with torch.cuda.device(device):
        err = fn(bits.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "jump_seed_error")
    _build.count_launch(launches, "jump_seed_error")
    return float(bits.cpu().view(torch.float64))
