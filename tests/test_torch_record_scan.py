"""The long-read record scan and its binning against hulk_tpu on the CPU.

* the record scan's plain version (ops/longread.py:record_heads on a CPU
  tensor, built on ops/minimizer.py:record_run_heads_torch), sorted and
  made unique, against hulk_tpu.ops.longread.long_read_minimizers: records
  of w+k-1 bases up to 300,000 (one past the CPU's chunk of 65,536 and far
  past it), an all-N record, and a cap small enough to force many `cont`
  chunks;
* the run-head multiset against a literal rolling scan of the contract
  (tests/oracle_minimizer.py's monotonic queue, reporting at every
  position): the reported positions whose value differs from the position
  before's, or whose position before did not report;
* the values binning's dedup form with its count against hulk_tpu's
  KmerSpectrum.add_hashes of the distinct values;
* the long-read step (one record into the histogram, the count and the
  KMV/KHF/HMH states) against hulk_tpu's host path for the same record.

Tolerance: bit-equality (sets, multisets, integer counts, sketch states).
"""
from collections import deque

import numpy as np
import pytest
import torch

from hulk_tpu.ops.longread import long_read_minimizers as jax_long_read
from hulk_tpu.sketch.hyperminhash import HyperMinHash as JaxHMH
from hulk_tpu.sketch.minhash import KHFSketch as JaxKHF, KMVSketch as JaxKMV
from hulk_tpu.sketch.spectrum import KmerSpectrum as JaxSpectrum
from hulk_tpu_torch.ops.device_sketches import SketchStates
from hulk_tpu_torch.ops import longread
from hulk_tpu_torch.ops.device_step import bin_scatter_values_torch
from hulk_tpu_torch.ops.longread import (DEFAULT_BLOCK, chunks, long_read_step, record_heads,
                                         sorted_record_values)
from hulk_tpu_torch.ops.minimizer import record_run_heads_torch
from hulk_tpu_torch.sketch.hyperminhash import HyperMinHash
from hulk_tpu_torch.sketch.minhash import KHFSketch, KMVSketch
from hulk_tpu_torch.stream.pipeline import _merge_states
from hulk_tpu_torch.synth import sorted_values

from oracle_minimizer import U64, hash64

SENT = np.uint64(2**64 - 1)


def record(rng, L, n_frac=0.01):
    return np.where(rng.random(L) < n_frac, 4, rng.integers(0, 4, size=L)).astype(np.uint8)


def port_distinct(codes, k, w, cap=None):
    heads, count = record_heads(torch.from_numpy(codes), k=k, w=w, cap=cap)
    return np.unique(heads[:int(count)].numpy().view(np.uint64))


@pytest.mark.parametrize("k,w", [(21, 9), (31, 2), (15, 5)])
@pytest.mark.parametrize("L", ["halo", 65_535, 65_536, 65_537, 300_000])
def test_record_scan_matches_reference(k, w, L):
    L = w + k - 1 if L == "halo" else L
    codes = record(np.random.default_rng(L + 100 * k + w), L)
    want = jax_long_read(codes, k=k, w=w, block=16384, group=4)
    got = port_distinct(codes, k, w)
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)
    if L > w + k - 1:
        assert got.size > 0
    assert len(chunks(L, DEFAULT_BLOCK, k, w)) == (1 if L <= DEFAULT_BLOCK else
                                                  -(-(L - w - k + 1) //
                                                    (DEFAULT_BLOCK - w - k + 1)))


def test_all_n_record_matches_reference():
    """N is shifted into both k-mers as 4 (the reference's quirk), so an
    all-N record still has a few minimizers: the span ramp's."""
    codes = np.full(70_000, 4, dtype=np.uint8)
    want = jax_long_read(codes, k=21, w=9, block=16384, group=4)
    got = port_distinct(codes, 21, 9)
    assert got.dtype == np.uint64 and 0 < got.size < 20
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,w,cap,L", [(21, 9, 1000, 20_000), (31, 2, 33, 2000),
                                       (15, 5, 22, 2000), (3, 64, 128, 5000)])
def test_small_cap_cont_chunks_match_reference(k, w, cap, L):
    """Many chunks in the cont form, down to the smallest cap that holds
    it (w + k - 1 + max(1, w - 2)): every chunk boundary inside the read."""
    codes = record(np.random.default_rng(cap), L, n_frac=0.05)
    assert len(chunks(codes.size, cap, k, w)) > 10
    want = jax_long_read(codes, k=k, w=w, block=4096, group=4)
    assert np.array_equal(port_distinct(codes, k, w, cap=cap), want)


@pytest.mark.parametrize("k,w,cap", [(15, 5, 21), (21, 9, 29), (31, 2, 32)])
def test_cap_below_the_cont_form_raises(k, w, cap):
    """A cap whose second chunk would start before the span reaches k (or
    make no progress) is refused: the cont form would report wrong spans."""
    with pytest.raises(ValueError, match="the cap must be at least"):
        record_heads(torch.zeros(3000, dtype=torch.uint8), k=k, w=w, cap=cap)


def oracle_run_heads(codes: np.ndarray, k: int, w: int) -> list:
    """The contract, literally: the reference's rolling scan
    (tests/oracle_minimizer.py:minimizers_of, minimizer.go:96-204) on base
    codes, the queue front at every reported position, and of those the
    positions whose value differs from the position before's, or whose
    position before did not report."""
    bitmask, shift = (1 << (2 * k)) - 1, 2 * (k - 1)
    fwd = rc = 0
    q = deque()
    heads, prev = [], None
    for i, c in enumerate(int(x) for x in codes):
        window_index = i - w + 1
        span = window_index + 1 if window_index + 1 < k else k
        fwd = ((fwd << 2) | c) & bitmask
        rc = ((rc >> 2) | (((3 ^ c) << shift) & U64)) & U64
        cur = None
        if i >= k - 1 and fwd != rc:
            kmer = rc if fwd > rc else fwd
            x = ((hash64(kmer, bitmask) << 8) & U64) | (span & U64)
            while q and not q[0][1] > i - w:
                q.popleft()
            while q and not q[-1][0] < x:
                q.pop()
            q.append((x, i))
            if window_index >= 0:
                cur = q[0][0]
        if cur is not None and cur != prev:
            heads.append(cur)
        prev = cur
    return heads


@pytest.mark.parametrize("k,w,n_frac", [(21, 9, 0.01), (31, 2, 0.05), (5, 64, 0.05),
                                        (3, 20, 0.2), (11, 1, 0.01)])
def test_run_heads_match_oracle(k, w, n_frac):
    codes = record(np.random.default_rng(k * w), 4000, n_frac)
    got = record_run_heads_torch(torch.from_numpy(codes), k, w).numpy().view(np.uint64)
    want = np.array(oracle_run_heads(codes, k, w), dtype=np.uint64)
    assert want.size > 0
    assert np.array_equal(np.sort(got), np.sort(want))


@pytest.mark.parametrize("n", [1, 2000, 923_521])
def test_dedup_binning_matches_spectrum(n):
    """The dedup form bins each distinct live value once (all 64 bits),
    skips the sentinel and counts what it binned."""
    svals = sorted_values(np.random.default_rng(n), 3000)
    live = np.unique(svals[svals != SENT])
    hist = torch.zeros(n, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int64)
    bin_scatter_values_torch(hist, torch.from_numpy(svals.view(np.int64)), dedup=True,
                             count=count)
    want = JaxSpectrum(n)
    want.add_hashes(live)
    assert int(count) == live.size < svals.size - 64
    assert np.array_equal(hist.numpy(), want.bins)


@pytest.mark.parametrize("k,w,cap,fed", [(31, 9, None, None), (21, 5, 3000, None),
                                         (31, 9, None, 1000)])
def test_long_read_step_matches_host_path(k, w, cap, fed, monkeypatch):
    """One record into hist, count and the sketch states equals hulk_tpu's
    host path (spectrum.add_hashes and each sketch's add_hashes of the
    record's distinct values); at k = 31 values pass 2^63, so KMV's bottom s
    is taken in unsigned order. fed: the sketches take the values in
    slices of that many (SKETCH_SLICE), as a record of millions does."""
    if fed:
        monkeypatch.setattr(longread, "SKETCH_SLICE", fed)
    codes = record(np.random.default_rng(k + w), 90_000)
    nbins, s = 923_521, 16
    hist = torch.zeros(nbins, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int64)
    states = SketchStates.empty(s, kmv=True, khf=True, hmh=True, device="cpu")
    long_read_step(hist, count, states, torch.from_numpy(codes), k=k, w=w, cap=cap)
    flat = jax_long_read(codes, k=k, w=w, block=16384, group=4)
    assert (flat >= 2**63).any() == (k == 31)
    spectrum, objs = JaxSpectrum(nbins), (JaxKMV(k, s), JaxKHF(k, s), JaxHMH(k))
    spectrum.add_hashes(flat)
    for obj in objs:
        obj.add_hashes(flat)
    assert int(count) == flat.size
    assert np.array_equal(hist.numpy(), spectrum.bins)
    kmv, khf, hmh = KMVSketch(k, s), KHFSketch(k, s), HyperMinHash(k)
    _merge_states(states, kmv, khf, hmh, s)
    assert np.array_equal(kmv._values, objs[0]._values)
    assert np.array_equal(khf.sketch, objs[1].sketch)
    assert np.array_equal(hmh.registers, objs[2].registers)


def test_sorted_record_values_are_run_heads():
    """The sorted buffer is the run heads of the one-piece scan, sorted: a
    record within one chunk takes one scan."""
    codes = record(np.random.default_rng(5), 50_000)
    got = sorted_record_values(torch.from_numpy(codes), k=21, w=9)
    want = np.sort(record_run_heads_torch(torch.from_numpy(codes), 21, 9).numpy()
                   .view(np.uint64))
    assert np.array_equal(got.numpy().view(np.uint64), want)
