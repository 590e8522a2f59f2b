"""The two-sort step (k >= 23 at R = 2048, every R from k = 28) against
hulk_tpu on the CPU: minimizer_scan's per-read distinct values, the step's
histogram, count and sorted value stream (hulk_tpu's sketch_stream_step),
the group step with the secondary sketches, and `sketch` end to end at
k = 23 and k = 31. From k = 28 on reported values reach bit 63, so every
sort and compare must be unsigned; the op-level cases assert they do.

Tolerance: bit-equality (integer arithmetic), byte-identical out.json.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hulk_tpu.cli as jax_cli
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu.ops import device_sketches as jsk
from hulk_tpu.ops import device_step as jds
from hulk_tpu.ops.minimizer import minimizer_scan as jax_scan
from hulk_tpu_torch import native
from hulk_tpu_torch.ops import device_step as tds
from hulk_tpu_torch.ops.device_sketches import SketchStates
from hulk_tpu_torch.ops.minimizer import minimizer_scan
from hulk_tpu_torch.sketch.hyperminhash import DEFAULT_P, DEFAULT_Q, DEFAULT_R
from hulk_tpu_torch.synth import generate, kernel_batch

U64MAX = np.uint64(2**64 - 1)


def batch(k, r=64, l=160, seed=0):
    """u8 codes with random pad, lengths, and the same reads as v2 buffer."""
    return kernel_batch(np.random.default_rng(seed + k), r, l, k + 20, l, n_frac=0.02)


@pytest.mark.parametrize("k,w", [(28, 9), (31, 5), (31, 1)])
def test_minimizer_scan_matches_reference(k, w):
    codes, lengths, _, _ = batch(k)
    vals, mask = minimizer_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k, w)
    ref_codes = np.where(np.arange(codes.shape[1]) < lengths[:, None], codes, 5)
    rv, rm = jax_scan(ref_codes, lengths, k=k, w=w)
    rv, rm = np.asarray(rv), np.asarray(rm)
    assert np.array_equal(mask.numpy(), rm)
    assert np.array_equal(vals.numpy().view(np.uint64)[rm], rv[rm])
    assert (rv[rm] >= np.uint64(2**63)).any()  # the unsigned order matters


@pytest.mark.parametrize("k,w", [(28, 9), (31, 5)])
def test_two_sort_step_matches_reference(k, w):
    """The port's window + sorted_batch_values + bin_scatter_values against
    hulk_tpu's sketch_stream_step (full width, no bucket cut)."""
    codes, lengths, c2, m8 = batch(k, seed=1)
    nbins = 50_000
    ref_codes = np.where(np.arange(codes.shape[1]) < lengths[:, None], codes, 5)
    h_ref, c_ref, sv_ref = jds.sketch_stream_step(
        jnp.zeros(nbins, dtype=jnp.int32), jnp.zeros((), dtype=jnp.int64),
        ref_codes, lengths, k=k, w=w, bucket=ref_codes.size)
    wmin, report = tds.minimizer_window_packed(
        torch.from_numpy(c2), torch.from_numpy(m8), torch.from_numpy(lengths), k, w)
    svals, cnt = tds.sorted_batch_values(wmin, report)
    hist = torch.zeros(nbins, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int64)
    tds.bin_scatter_values(hist, svals, count=count)  # the whole buffer, SENT tail
    sv_ref = np.asarray(sv_ref)
    assert int(cnt) == int(count) == int(c_ref) > 0
    assert np.array_equal(svals.numpy().view(np.uint64), sv_ref)
    assert (sv_ref[:int(cnt)] >= np.uint64(2**63)).any()
    assert np.array_equal(hist.numpy(), np.asarray(h_ref))


def test_bin_scatter_values_counts_equal_neighbours():
    """Equal adjacent values come from different reads: each counts, and
    only the sentinel is skipped (bin_scatter_keys would drop them)."""
    from hulk_tpu_torch.synth import sorted_values

    vals = sorted_values(np.random.default_rng(5), 3000)
    hist = torch.zeros(1000, dtype=torch.int32)
    tds.bin_scatter_values(hist, torch.from_numpy(vals.view(np.int64)))
    ref = np.asarray(jds.bin_scatter_slice(jnp.zeros(1000, dtype=jnp.int32), vals))
    assert hist.sum() == (vals != U64MAX).sum() > 3000
    assert np.array_equal(hist.numpy(), ref)


@pytest.mark.parametrize("k", [23, 27, 31])
def test_group_step_two_sort_bins_whole_buffer(k, monkeypatch):
    """Without sketches the two-sort step bins each batch's whole sorted
    buffer, SENT tail included, and the binning adds the live count to the
    count itself (no host read of it); histogram and count equal hulk_tpu's
    stream_step_body, which adds its count on the device, batch by batch."""
    g, r, l, w, nbins = 2, 2048, 64, 9, 40_000
    assert not tds.fused_bits_ok(k, r)
    rng = np.random.default_rng(100 + k)
    pairs = []
    for _ in range(g):
        lengths = rng.integers(k + w - 1, l + 1, size=r).astype(np.int32)
        codes = rng.choice(5, size=(r, l), p=[0.245] * 4 + [0.02]).astype(np.uint8)
        pairs.append((codes, lengths))
    flat = native.pack_group2(pairs, g, r, l)
    calls = []
    binning = tds.bin_scatter_values

    def spy(hist, svals, **kw):
        calls.append((svals.numel(), kw.get("count") is count))
        binning(hist, svals, **kw)

    monkeypatch.setattr(tds, "bin_scatter_values", spy)
    hist = torch.zeros(nbins, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int64)
    bucket = tds.stream_bucket(r, r * l, l=l, k=k, w=w)
    tds.group_scan_body(hist, count, torch.from_numpy(flat), g=g, r=r, l=l, k=k, w=w,
                        bucket=bucket)
    assert calls == [(r * l, True)] * g

    h = jnp.zeros(nbins, dtype=jnp.int32)
    c = jnp.zeros((), dtype=jnp.int64)
    for codes, lengths in pairs:
        ref_codes = np.where(np.arange(l) < lengths[:, None], codes, 5)
        h, c, _ = jds.stream_step_body(h, c, ref_codes, lengths, k=k, w=w, bucket=bucket)
    assert int(count) == int(c) > 0
    assert np.array_equal(hist.numpy(), np.asarray(h))


@pytest.mark.parametrize("k", [23, 28])
def test_group_step_two_sort_with_sketches(k):
    """group_scan_body takes the two-sort step where read ids do not pack
    above the value bits; histogram, count and KMV/KHF/HMH states equal
    hulk_tpu's per-batch steps with its device sketch updates."""
    g, r, l, w, s, nbins = 2, 2048 if k == 23 else 64, 96, 7, 16, 30_000
    assert not tds.fused_bits_ok(k, r)
    rng = np.random.default_rng(k)
    pairs = []
    for _ in range(g):
        lengths = rng.integers(k + w, l + 1, size=r).astype(np.int32)
        codes = rng.choice(5, size=(r, l), p=[0.245] * 4 + [0.02]).astype(np.uint8)
        pairs.append((codes, lengths))
    flat = native.pack_group2(pairs, g, r, l)
    hist = torch.zeros(nbins, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int64)
    states = SketchStates.empty(s, kmv=True, khf=True, hmh=True, device="cpu")
    tds.group_scan_body(hist, count, torch.from_numpy(flat), g=g, r=r, l=l, k=k, w=w,
                        bucket=tds.stream_bucket(r, r * l, l=l, k=k, w=w), states=states)

    h = jnp.zeros(nbins, dtype=jnp.int32)
    c = jnp.zeros((), dtype=jnp.int64)
    kmv = khf = jnp.full(s, U64MAX, dtype=jnp.uint64)
    hmh = jnp.zeros(1 << DEFAULT_P, dtype=jnp.uint64)
    for codes, lengths in pairs:
        h, c, sv = jds.sketch_stream_step(h, c, codes, lengths, k=k, w=w, bucket=r * l)
        kmv = jsk.kmv_update(kmv, sv)
        khf = jsk.khf_update(khf, sv)
        hmh = jsk.hmh_update(hmh, sv, p=DEFAULT_P, q=DEFAULT_Q, r=DEFAULT_R)
    assert int(count) == int(c) > 0
    assert np.array_equal(hist.numpy(), np.asarray(h))
    for got, want in ((states.kmv, kmv), (states.khf, khf), (states.hmh, hmh)):
        assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    return generate(str(d / "reads.fq.gz"), 2500, read_len=150, seed=23)


@pytest.mark.parametrize("extra", [["-k", "23", "-w", "9"],
                                   ["-k", "31", "-w", "5", "--kmv", "--khf", "--hmh", "-i", "1000"]])
def test_out_json_byte_identical_large_k(reads, tmp_path, monkeypatch, extra):
    """2,500 reads at R = 2048: the first group takes the two-sort step."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    args = ["sketch", "-f", reads, "-s", "8", *extra]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
