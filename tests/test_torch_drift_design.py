"""The rules of the two drift kernels (csrc/flush_drift.cu), modelled in
NumPy and held against the port's plain versions and the JAX scan's body on
the CPU.

The CUDA kernels run only on the card, so their own outputs are compared
with the plain versions there (tests/test_torch_gpu.py, chip_smoke.py phase
12b, on the same corner cases, synth.drift_scan_cases and
synth.drift_select_cases). These tests check, here, the rules their designs
rest on:

* hulk_cms_drift_scan gives a warp 32 consecutive counters of one row. Per
  tile of 512 live bins ballots list the warp's hits, in bin order, the same
  list for every lane; between two hits each lane runs bare multiplies c *
  dw (the bins since the last hit, carried across tiles), at a hit c * dw
  + f in the lane hit and c * dw + 0 in the others, and the squash below
  the smallest normal waits for the end. Every counter then sees the
  reference's rounded operations in its order.
* hulk_drift_select takes the minimum of each chunk of C Aka of a slot
  (fmin: a NaN never wins), then walks the chunks in order and scans only
  those whose minimum is below the slot's threshold weight / dw when the
  walk reaches them, 32 Aka at a time by ballot. A skipped chunk holds no
  Aka below the threshold, which changes only at a pick.

Tolerance: bit-equality (IEEE f64 operations rounded once each to nearest,
the same in NumPy as on the card), compared as uint64 views.
"""
import numpy as np
import pytest
import torch

from hulk_tpu_torch.hashes.fdlibm import go_exp
from hulk_tpu_torch.ops.flush_drift import TINY, cms_drift_scan_torch, drift_select_torch
from hulk_tpu_torch.synth import drift_scan_cases, drift_select_cases

from test_torch_flush_step import literal_drift

TILE = 512  # the scan kernel's kTile
DW = float(go_exp(-0.9))
MAX = np.finfo(np.float64).max
SCAN_CASES = drift_scan_cases(np.random.default_rng(14), tile=TILE)
SELECT_CASES = drift_select_cases(np.random.default_rng(15), DW)


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.uint64)


def decay(c: np.ndarray, dw: float, k: int) -> np.ndarray:
    """k bare multiplies, each product rounded once."""
    for _ in range(k):
        c = c * dw
    return c


def warp_walk(rel: np.ndarray, tile: int = TILE):
    """The stepping warp's walk as the kernel keeps it, for one warp (rel:
    the row's counter of each live bin less the warp's first): tile by tile
    the hits in bin order, each with the bare multiplies before it, the
    bins after a tile's last hit carried into the next tile (`pending`,
    `last` reset a tile). Returns ([(bare multiplies, bin, lane)], the bare
    multiplies after the last hit)."""
    n = rel.shape[0]
    steps, pending = [], 0
    for base in range(0, n, tile):
        t, last = rel[base:base + tile], -1
        for i in np.flatnonzero((t >= 0) & (t < 32)):
            steps.append((pending + i - last - 1, base + i, int(t[i])))
            pending, last = 0, i
        pending += min(n - base, tile) - last - 1
    return steps, pending


def scan_model(freqs, rows, cms, dw, tile: int = TILE):
    """hulk_cms_drift_scan's rule, warp by warp: (the CMS after the n live
    bins, each bin's estimate, whether a counter below the smallest normal
    was hit)."""
    depth, width = cms.shape
    n = freqs.shape[0]
    lanes = np.arange(32)
    out = np.empty_like(cms)
    est = np.full((depth, n), np.nan)
    hit_subnormal = False
    for d in range(depth):
        for j0 in range(0, width, 32):
            active = j0 + lanes < width
            c = np.zeros(32)
            c[active] = cms[d, j0:j0 + 32]
            steps, tail = warp_walk(rows[d] - j0, tile)
            for gap, i, lane in steps:
                c = decay(c, dw, gap) * dw
                hit_subnormal |= bool(0.0 < c[lane] < TINY)
                c = c + np.where(lanes == lane, freqs[i], 0.0)
                est[d, i] = c[lane]
            c = decay(c, dw, tail)
            out[d, j0:j0 + 32] = np.where(c >= TINY, c, 0.0)[active]
    assert not np.isnan(est).any()  # every (row, bin) written by exactly the warp it hits
    return out, est.min(0) if n else np.empty(0), hit_subnormal


def select_model(aka, bins, sketch, weights, dw, chunk: int):
    """hulk_drift_select's rule: (sketch, weights, chunks scanned a slot)."""
    s, n = aka.shape
    chunks = -(-n // chunk)
    padded = np.full((s, chunks * chunk), np.inf)
    padded[:, :n] = aka
    mins = np.fmin.reduce(padded.reshape(s, chunks, chunk), axis=2)
    sketch, weights = sketch.copy(), weights.copy()
    scanned = np.zeros(s, dtype=np.int64)
    lanes = np.arange(32)

    def first_below(a, cur, after):
        m = (lanes[:a.shape[0]] > after) & (a < cur)
        return int(np.argmax(m)) if m.any() else None

    with np.errstate(over="ignore", invalid="ignore"):
        for slot in range(s):
            w, pick = weights[slot], -1
            cur = w / dw
            for qb in range(0, chunks, 32):
                cm = mins[slot, qb:qb + 32]
                q = first_below(cm, cur, -1)
                while q is not None:
                    scanned[slot] += 1
                    lo = (qb + q) * chunk
                    for base in range(lo, min(lo + chunk, n), 32):
                        a = padded[slot, base:min(base + 32, lo + chunk, n)]
                        l = first_below(a, cur, -1)
                        while l is not None:
                            w, pick = a[l], base + l
                            cur = w / dw
                            l = first_below(a, cur, l)
                    q = first_below(cm, cur, q)
            weights[slot] = w
            if pick >= 0:
                sketch[slot] = bins[pick]
    return sketch, weights, scanned


@pytest.mark.parametrize("case", range(len(SCAN_CASES)),
                         ids=[c[0] for c in SCAN_CASES])
def test_the_walk_steps_each_counter_once_a_bin(case):
    """Every warp's walk reaches each of its hits at the hit's bin, after
    exactly the bins before it, and ends after the n-th: the bare
    multiplies carried across tiles with no hit are neither lost nor
    counted twice (the case with a gap of two tiles carries them)."""
    name, hist, table, cms = SCAN_CASES[case]
    rows = table[:, np.flatnonzero(hist)]
    n = rows.shape[1]
    carried = False
    for d in range(rows.shape[0]):
        for j0 in range(0, cms.shape[1], 32):
            rel = rows[d] - j0
            steps, tail = warp_walk(rel)
            at = 0
            for gap, i, lane in steps:
                at += gap
                assert at == i and rel[i] == lane
                at += 1
                carried |= gap > TILE
            assert at + tail == n
            assert len(steps) == int(((rel >= 0) & (rel < 32)).sum())
    if name.startswith("row 0's first warp"):
        assert carried


@pytest.mark.parametrize("case", range(len(SCAN_CASES)),
                         ids=[c[0] for c in SCAN_CASES])
def test_scan_model_bit_equal(case):
    """The scan's rule against cms_drift_scan_torch (the squash at every
    step) and the JAX body's literal loop, from a CMS carried in."""
    name, hist, table, cms0 = SCAN_CASES[case]
    ids = np.flatnonzero(hist)
    freqs, rows = hist[ids].astype(np.float64), np.ascontiguousarray(table[:, ids])
    cms, esti, hit_subnormal = scan_model(freqs, rows, cms0, DW)
    got_cms, got_esti = cms_drift_scan_torch(torch.from_numpy(freqs), torch.from_numpy(rows),
                                             torch.from_numpy(cms0), DW)
    assert np.array_equal(bits(cms), bits(got_cms.numpy()))
    assert np.array_equal(bits(esti), bits(got_esti.numpy()))
    want_cms, want_esti, _, _ = literal_drift(hist, table, cms0,
                                              lambda j, e: np.full(1, np.inf),
                                              np.zeros(1, np.int64), np.full(1, MAX), DW)
    assert np.array_equal(bits(cms), bits(want_cms))
    assert np.array_equal(bits(esti), bits(want_esti))
    if name.startswith("width 2000"):
        assert hit_subnormal  # a counter decayed below the smallest normal, then was hit


def test_scan_cases_cover_the_warp_layout():
    """The scan's cases hold what they claim: the last warp of a row
    partial at width 2,000, a warp hit at every bin of a tile, a warp with
    no hit for longer than a tile, and live counts around the tile."""
    (_, hist, table, cms), = [c for c in SCAN_CASES if c[0].startswith("width 2000")]
    assert cms.shape[1] % 32 and (table[:, np.flatnonzero(hist)] >= cms.shape[1] // 32 * 32).any()
    (_, hist, table, _), = [c for c in SCAN_CASES if "every bin" in c[0]]
    assert (table[0, :TILE] < 32).all() and (table[0, TILE + 40:3 * TILE + 40] >= 64).all()
    assert {int((c[1] != 0).sum()) for c in SCAN_CASES} >= {0, 1, 255, 256, 257, TILE - 1,
                                                            TILE, TILE + 1}


@pytest.mark.parametrize("chunk", [32, 256, 1024])
@pytest.mark.parametrize("case", range(len(SELECT_CASES)),
                         ids=[c[0] for c in SELECT_CASES])
def test_select_model_bit_equal(case, chunk):
    """The selection's rule at chunk C against drift_select_torch and the
    JAX body's literal loop; it skips what it may and scans what it must."""
    name, aka, sketch, weights = SELECT_CASES[case]
    s, n = aka.shape
    bins = 5 * np.arange(n, dtype=np.int64) + 3
    sk, w, scanned = select_model(aka, bins, sketch, weights, DW, chunk)
    t = torch.from_numpy
    got_sk, got_w = drift_select_torch(t(aka), t(bins), t(sketch), t(weights), DW)
    assert np.array_equal(sk, got_sk.numpy())
    assert np.array_equal(bits(w), bits(got_w.numpy()))
    hist = np.zeros(5 * n + 3, dtype=np.int64)
    hist[bins] = 1
    _, _, want_sk, want_w = literal_drift(hist, np.zeros((1, hist.shape[0]), np.int64),
                                          np.zeros((1, 1)), lambda j, e: aka[:, (j - 3) // 5],
                                          sketch, weights, DW)
    assert np.array_equal(sk, want_sk)
    assert np.array_equal(bits(w), bits(want_w))
    chunks = -(-n // chunk)
    assert n % chunk or name == "no live bins"
    if name.startswith("strictly decreasing"):
        assert (scanned == chunks).all() and (sk == bins[-1]).all()
    elif name.startswith("random Aka, an empty"):
        assert (scanned >= 1).all() and scanned.sum() < s * chunks
    elif name.startswith("a carried sketch"):
        assert (scanned == 0).all() and np.array_equal(sk, sketch)
    elif name.startswith("Aka equal"):
        # the two picks just below a threshold, neither tie
        assert np.array_equal(bits(w), bits(aka[np.arange(s), 1024 + 64 * np.arange(s)]))
    elif name.startswith("one Aka below the threshold"):
        at = 8300 + 17 * np.arange(s)
        assert (at >= 32 * 256).all() and (scanned == 1).all()
        assert np.array_equal(sk, bins[at]) and np.array_equal(bits(w), bits(aka[np.arange(s), at]))
    elif name.startswith("+inf"):
        assert np.isfinite(w).all()
    elif name == "no live bins":
        assert np.array_equal(sk, sketch) and np.array_equal(bits(w), bits(weights))
