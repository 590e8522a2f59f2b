"""The port's group step (hulk_tpu_torch.ops.device_step.group_scan_body)
against hulk_tpu.ops.device_step.sketch_stream_group_step on the CPU: the
same v2 transfer buffer (native pack_group2) through both, comparing the
histogram and the minimizer count. Covers the compact branch with the
bucket prefix, the full-width branches (a row overflowing the compact
width; live lanes above the bucket), no compaction (C >= L), and sort keys
with bit 63 set (read ids at and above 2^(63 - vbits)).

Tolerance: bit-equality (integer counts of integer keys).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulk_tpu.ops import device_step as jds
from hulk_tpu_torch import native
from hulk_tpu_torch.ops import device_step as tds
from hulk_tpu_torch.ops.minimizer import unpack_codes2
from hulk_tpu_torch.synth import sorted_keys


def make_group(rng, g, r, l, lo, n_frac=0.02):
    batches = []
    for i in range(g):
        rows = r if i == g - 1 else int(rng.integers(r // 2, r + 1))
        lengths = rng.integers(lo, l + 1, size=rows).astype(np.int32)
        codes = rng.choice(5, size=(rows, l), p=[(1 - n_frac) / 4] * 4 + [n_frac])
        batches.append((codes.astype(np.uint8), lengths))
    return native.pack_group2(batches, g, r, l)


def reference(flat, nbins, **kw):
    dummy = [jnp.zeros(1, dtype=jnp.uint64) for _ in range(3)]  # KMV/KHF/HMH off
    h, c, *_ = jds.sketch_stream_group_step(
        jnp.zeros(nbins, dtype=jnp.int32), jnp.zeros((), dtype=jnp.int64),
        *dummy, jnp.asarray(flat), packed2=True, compact=True, **kw)
    return np.asarray(h), int(c)


def port(flat, nbins, **kw):
    hist = torch.zeros(nbins, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int64)
    tds.group_scan_body(hist, count, torch.from_numpy(flat), **kw)
    return hist.numpy(), int(count)


@pytest.mark.parametrize(
    "g,r,l,k,w,bucket_kind,width",
    [
        (3, 64, 160, 11, 5, "stream", None),   # compact branch, bucket prefix
        (2, 64, 160, 11, 5, "small", None),    # live lanes above the bucket
        (2, 64, 160, 11, 5, "stream", 8),      # rows overflow C: full width
        (2, 32, 96, 11, 5, "stream", 96),      # C >= L: no row compaction
        (2, 2112, 64, 22, 9, "stream", None),  # rid >= 2048: key bit 63 set
    ],
)
def test_group_step_matches_reference(g, r, l, k, w, bucket_kind, width, monkeypatch):
    if width is not None:
        monkeypatch.setattr(tds, "compact_width", lambda L, w: min(width, L))
    assert tds.fused_bits_ok(k, r) and jds.fused_bits_ok(k, r)
    rng = np.random.default_rng(g * r + l + k)
    flat = make_group(rng, g, r, l, lo=w + k - 1)
    nbins = k ** 4 if k < 15 else 50_000
    bucket = (tds.stream_bucket(r, r * l, l=l, k=k, w=w)
              if bucket_kind == "stream" else 16)
    assert bucket == jds.stream_bucket(r, r * l, l=l, k=k, w=w) or bucket == 16
    kw = dict(g=g, r=r, l=l, k=k, w=w, bucket=bucket)
    h_ref, c_ref = reference(flat, nbins, **kw)
    h, c = port(flat, nbins, **kw)
    assert c == c_ref > 0
    assert np.array_equal(h, h_ref)


def test_sort_keys_with_bit_63_sort_unsigned():
    from hulk_tpu_torch._u64 import usort

    keys = torch.tensor([-1, 5, -(2**63), 2**62, 0], dtype=torch.int64)
    got = usort(keys).numpy().view(np.uint64)
    assert got.tolist() == sorted(keys.numpy().view(np.uint64).tolist())


def test_unpack_codes2_matches_reference():
    rng = np.random.default_rng(1)
    flat = make_group(rng, 2, 16, 64, lo=1, n_frac=0.2)
    c2, m8, ln = jds._group_views2(jnp.asarray(flat), 2, 16, 64)
    ref = np.asarray(jds.unpack_codes2(c2, m8, ln))
    t2, tm8, tln = tds.group_views2(torch.from_numpy(flat), 2, 16, 64)
    assert np.array_equal(tln.numpy(), np.asarray(ln))
    assert np.array_equal(unpack_codes2(t2, tm8, tln).numpy(), ref)


@pytest.mark.parametrize("L,w", [(160, 9), (96, 5), (64, 1), (2048, 9)])
def test_sizing_helpers_match_reference(L, w):
    assert tds.compact_width(L, w) == jds.compact_width(L, w)
    for r in (1, 64, 16384):
        assert tds.stream_bucket(r, r * L, l=L, k=21, w=w) == jds.stream_bucket(
            r, r * L, l=L, k=21, w=w)
    for k in (11, 21, 22, 25, 31):
        assert tds.fused_bits_ok(k, 16384) == jds.fused_bits_ok(k, 16384)


@pytest.mark.parametrize("kind,n_keys,vbits,nbins", [
    ("mixed", 3000, 50, 194_481),      # k = 21: bit 63 set for read ids >= 8192
    ("mixed", 2000, 30, 2000),
    ("dup_only", 500, 50, 194_481),
    ("all_sentinel", 0, 50, 1000),
])
def test_bin_scatter_keys_matches_reference(kind, n_keys, vbits, nbins):
    rng = np.random.default_rng(n_keys + vbits)
    keys = sorted_keys(rng, n_keys, vbits, dup_only=kind == "dup_only")
    if kind == "mixed":
        assert (keys[:-64] >> np.uint64(63)).any()
    ref = np.asarray(jds.bin_scatter_keys(jnp.zeros(nbins, dtype=jnp.int32),
                                          jnp.asarray(keys), vbits=vbits))
    hist = torch.zeros(nbins, dtype=torch.int32)
    tds.bin_scatter_keys(hist, torch.from_numpy(keys.view(np.int64)), vbits)
    assert np.array_equal(hist.numpy(), ref)
    assert hist.sum() == len(np.unique(keys[keys != np.uint64(2**64 - 1)]))


def test_bin_scatter_cuda_wrapper_refuses_cpu_tensors():
    from hulk_tpu_torch.ops.jump_cuda import bin_scatter_keys_cuda

    with pytest.raises(ValueError):
        bin_scatter_keys_cuda(torch.zeros(10, dtype=torch.int32),
                              torch.zeros(8, dtype=torch.int64), 50)
