"""The plain reference of `hulk sketch`: what a job's out.json and its
interval snapshots must hold, worked out from the inputs alone.

It imports nothing of the program and takes nothing the program made. The
semantics are hulk's (will-rowe/hulk src/minimizer, kmerspectrum, countmin,
histosketch), as the program's docstrings and tests/golden state them:

  * a record's minimizers: the reported minima of the w-window over its
    k-mers (the N code 4 shifted into both rolling k-mers, symmetric k-mers
    skipped, X = hash64(canonical) << 8 | span), each distinct value once a
    record;
  * each distinct value adds 1 to bin jump(X, k^4) of the spectrum;
  * at each flush (every `interval` records, and at the end) the nonzero
    bins go in ascending order through the count-min sketch (7 x 2000,
    rows at jump(bin + d * bin, 2000); with concept drift every counter is
    multiplied by Exp(-decay) before each add, results below the smallest
    normal float64 set to 0) and, with its estimate, through consistent
    weighted sampling: A = c / (Exp(Log(est) - b) * Exp(r)) per slot, the
    slot taking the bin when A < weight (A < weight / Exp(-decay) with
    drift). The CMS and the sketch carry over from flush to flush.

Minimizers and binning run in plain PyTorch on any device (the card keeps
the check short), from the codes the input generator wrote into the files;
the flush runs in NumPy in float64 with Go's Exp and Log.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hulkbench.reference.fdlibm import go_exp, go_log

SENT = -1  # the all-ones u64, the dead-lane value
MAX_FLOAT64 = float(np.finfo(np.float64).max)
TINY = float(np.finfo(np.float64).tiny)
CMS_DEPTH, CMS_WIDTH = 7, 2000  # EPSILON 0.001, DELTA 0.99
MIN_USED_BINS = 0.01
# NumPy's exp and Go's Exp differ by a few ulps (about 1e-15 relative): an
# element whose approximate A lies further than this share above a slot's
# minimum (or threshold) cannot take the slot
MARGIN = 4e-9
_LCG = 2862933555777941757
BATCH_POSITIONS = 1 << 25  # the reference's rows at a time: int64 [R, L] of 256 MiB


# ---- minimizers and the spectrum (plain PyTorch) ------------------------------

def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    """minimap2's invertible 64-bit mix (hulk src/minimizer/minimizer.go:33-42)."""
    key = (~key + (key << 21)) & mask
    key = key ^ _srl(key, 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ _srl(key, 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ _srl(key, 28)
    return (key + (key << 31)) & mask


def _ugt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sign = -(1 << 63)
    return (a ^ sign) > (b ^ sign)


def distinct_minimizers(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                        w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of codes [R, L] (anything past a row's length ignored) ->
    (row index, value) of each row's distinct reported minimizers."""
    R, L = codes.shape
    dev = codes.device
    c = codes.to(torch.int64)
    mask = (1 << (2 * k)) - 1
    pos = torch.arange(L, device=dev)[None, :]
    in_read = pos < lengths[:, None]
    cf = torch.nn.functional.pad(c, (k - 1, 0))
    fwd = torch.zeros_like(c)
    for j in range(k):
        fwd |= cf[:, k - 1 - j:k - 1 - j + L] << (2 * j)
    fwd &= mask
    comp = 3 ^ torch.nn.functional.pad(c, (k, 0), value=3)
    rc = torch.zeros_like(c)
    for j in range(k):
        rc |= comp[:, k - j:k - j + L] << (2 * (k - 1) - 2 * j)
    rc |= comp[:, 0:L] >> 2
    del cf, comp, c
    valid = (fwd != rc) & (pos >= k - 1) & in_read
    canonical = torch.where(_ugt(fwd, rc), rc, fwd)
    del fwd, rc
    span = torch.clamp(pos - (w - 2), max=k)
    x = torch.where(valid, (_hash64(canonical, mask) << 8) | span, SENT)
    del canonical
    # trailing window minimum in u64 order: flip bit 63, take the signed min
    sign = -(1 << 63)
    fx = torch.nn.functional.pad(x ^ sign, (w - 1, 0), value=SENT ^ sign)
    wmin = fx.unfold(1, w, 1).amin(dim=2) ^ sign
    del fx, x
    report = valid & (pos >= w - 1)
    vals = torch.sort(torch.where(report, wmin, SENT), dim=1).values
    first = torch.ones_like(report)
    first[:, 1:] = vals[:, 1:] != vals[:, :-1]
    keep = first & (vals != SENT)
    rows = torch.arange(R, device=dev)[:, None].expand(R, L)
    return rows[keep], vals[keep]


def jump_bins(keys: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """Lamping-Veach jump hash (dgryski/go-jump) of u64 keys held in int64 ->
    (buckets in [0, n), the loop iterations the keys took in all)."""
    key = keys.clone()
    b = torch.full_like(key, -1)
    j = torch.zeros_like(key)
    idx = torch.arange(key.numel(), device=key.device)
    iters = 0
    while idx.numel():
        iters += idx.numel()
        bi = j[idx]
        ki = key[idx] * _LCG + 1
        d = (_srl(ki, 33) + 1).to(torch.float64)
        ji = ((bi + 1).to(torch.float64) * (2147483648.0 / d)).to(torch.int64)
        b[idx], key[idx], j[idx] = bi, ki, ji
        idx = idx[ji < n]
    return b, iters


class FileBins:
    """One input file's records, binned: for each record's distinct
    minimizers its record index and bin, on `device`, and the work counts
    (bases, distinct minimizers, jump iterations). The records come as the
    input generator made them: codes 0-4 one after another and each
    record's length. They go in order of length, as many rows at a time as
    BATCH_POSITIONS holds, gathered on `device`."""

    def __init__(self, codes: np.ndarray, lengths: np.ndarray, *, k: int, w: int,
                 nbins: int, device):
        self.records = int(lengths.shape[0])
        self.bases = int(lengths.sum())
        flat = torch.from_numpy(codes).to(device)
        offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)[:-1]])).to(device)
        order = np.argsort(lengths, kind="stable")
        recs, bins = [], []
        self.keys = self.iterations = 0
        a = 0
        while a < order.shape[0]:
            b = a + 1
            while b < order.shape[0] and (b + 1 - a) * lengths[order[b]] <= BATCH_POSITIONS:
                b += 1
            ids = torch.from_numpy(order[a:b]).to(device)
            ln = torch.from_numpy(lengths[order[a:b]]).to(device)
            L = int(lengths[order[a:b]].max())
            at = offsets[ids][:, None] + torch.arange(L, device=device)[None, :]
            rows = flat[at.clamp_(max=flat.shape[0] - 1)]
            r, v = distinct_minimizers(rows, ln, k, w)
            bn, it = jump_bins(v, nbins)
            recs.append(ids[r])
            bins.append(bn)
            self.keys += int(v.numel())
            self.iterations += it
            a = b
        self.rec = torch.cat(recs)
        self.bin = torch.cat(bins)

    def histogram(self, lo: int, hi: int, nbins: int) -> np.ndarray:
        """Counts of records [lo, hi)'s distinct minimizers by bin."""
        sel = (self.rec >= lo) & (self.rec < hi)
        return torch.bincount(self.bin[sel], minlength=nbins).cpu().numpy().astype(np.int64)


def job_histograms(files: list[FileBins], interval: int, nbins: int) -> list[np.ndarray]:
    """The spectrum at each flush of a job over `files` in order: one every
    `interval` records (global record index), and the rest at the end; one
    in all without an interval."""
    total = sum(f.records for f in files)
    cuts = list(range(interval, total + 1, interval)) if interval else []
    if not cuts or cuts[-1] != total:
        cuts.append(total)
    hists, lo = [], 0
    for hi in cuts:
        h = np.zeros(nbins, dtype=np.int64)
        base = 0
        for f in files:
            a, b = max(lo - base, 0), min(hi - base, f.records)
            if a < b:
                h += f.histogram(a, b, nbins)
            base += f.records
        hists.append(h)
        lo = hi
    return hists


# ---- the flush (NumPy, float64) ------------------------------------------------

def cms_rows(nbins: int) -> np.ndarray:
    """[depth, nbins]: the CMS column of each bin in each row,
    jump(bin + d * bin, width) (countmin.go's traverse)."""
    e = torch.arange(nbins, dtype=torch.int64)
    return np.stack([jump_bins(e + d * e, CMS_WIDTH)[0].numpy() for d in range(CMS_DEPTH)])


def cms_estimates(bins: np.ndarray, freqs: np.ndarray, rows: np.ndarray,
                  decay: float | None) -> np.ndarray:
    """The CMS estimate after each add of a timeline of (bin, freq) adds
    that starts from an empty sketch: min over rows of the counter just
    added to.

    A counter's value at an add is its value at its last add, multiplied by
    the decay once a step in between, plus the freq. Without decay that is
    a running sum (whole numbers, exact in float64). With decay a gap of G
    steps leaves at most V * (d (1 + 2^-52))^G of the last value, V the sum
    of all freqs; past the gap where that is below half an ulp of 1, the
    add gives the freq exactly. Shorter gaps are multiplied out one step at
    a time, in rounds: each round recomputes every such add from its
    counter's previous add, until a round changes nothing. Rows are
    independent and go one at a time."""
    T = bins.shape[0]
    f = freqs.astype(np.float64)
    est = np.full(T, np.inf)
    reach = 0
    if decay is not None:
        reach = math.ceil((math.log2(float(f.sum())) + 53)
                          / -math.log2(decay * (1 + 2.0 ** -52))) + 1
    for r in range(CMS_DEPTH):
        col = rows[r, bins].astype(np.int16)  # width 2000: a stable radix sort
        order = np.argsort(col, kind="stable")
        cs, fs = col[order], f[order]
        same = np.concatenate([[False], cs[1:] == cs[:-1]])
        if decay is None:
            total = np.cumsum(fs)
            first = np.flatnonzero(~same)
            seg = np.repeat(first, np.diff(np.concatenate([first, [T]])))
            v = total - total[seg] + fs[seg]
        else:
            v = fs.copy()
            gap = np.where(same, order - np.concatenate([[0], order[:-1]]), 0)
            near = np.flatnonzero(same & (gap <= reach))
            g = gap[near]
            while True:
                x = v[near - 1]
                for s in range(1, int(g.max(initial=0)) + 1):
                    x = np.where(s <= g, x * decay, x)
                    x[x < TINY] = 0.0
                new = x + fs[near]
                if np.array_equal(new, v[near]):
                    break
                v[near] = new
        out = np.empty(T)
        out[order] = v
        np.minimum(est, out, out=est)
    return est


def _first_below(a: np.ndarray, cmin: np.ndarray, chunk: int, start: int,
                 thr: float) -> int:
    """The first index >= start with a[i] < thr, or -1 (chunk minima cmin
    skip the chunks with none)."""
    c0 = start // chunk
    if c0 * chunk < start:
        hit = np.flatnonzero(a[start:(c0 + 1) * chunk] < thr)
        if hit.size:
            return start + int(hit[0])
        c0 += 1
    for c in np.flatnonzero(cmin[c0:] < thr):
        base = (c0 + int(c)) * chunk
        return base + int(np.flatnonzero(a[base:base + chunk] < thr)[0])
    return -1


class HistoSketch:
    """The sketch (bins, weights) and its flushes in float64. With dtype
    float32 it is the control: the CMS as in float64 (whole counts), the
    weighted sampling (Log, Exp, A, the comparisons) in float32 with
    NumPy's exp and log, as a device flush in float32 would have it."""

    def __init__(self, s: int, nbins: int, decay_ratio: float, tables,
                 dtype=np.float64):
        self.s, self.nbins, self.dtype = s, nbins, dtype
        self.drift = decay_ratio != 1.0
        self.decay = float(go_exp(-decay_ratio)) if self.drift else None
        self.tables = tables
        self.rows = cms_rows(nbins)
        self.mins = np.zeros(s, dtype=np.uint64)
        self.weights = np.full(s, MAX_FLOAT64, dtype=np.float64)

    def run(self, hists: list[np.ndarray]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Flush each spectrum in turn: the (mins, weights) after each."""
        bins = [np.flatnonzero(h) for h in hists]
        for b in bins:
            if 0 < b.shape[0] < MIN_USED_BINS * self.nbins:
                raise ValueError("fewer than 1% of the bins used")
        allb = np.concatenate(bins)
        freqs = np.concatenate([h[b] for h, b in zip(hists, bins)]).astype(np.float64)
        est = cms_estimates(allb, freqs, self.rows, self.decay)
        lf = go_log(est) if self.dtype == np.float64 else np.log(est.astype(self.dtype))
        out, a = [], 0
        for b in bins:
            self._select(b, lf[a:a + b.shape[0]])
            a += b.shape[0]
            out.append((self.mins.copy(), self.weights.copy()))
        return out

    def _select(self, b: np.ndarray, lf: np.ndarray, slots: int = 6) -> None:
        """The weighted sampling of one flush's elements (bins b, Log of
        their estimates lf), slot by slot. In float64, A goes through
        NumPy's exp first, which is within a few ulps of Go's: only the
        elements within MARGIN of a slot's minimum (of its threshold, with
        drift) get A again with Go's Exp, and those exact values decide."""
        if b.shape[0] == 0:
            return
        t = self.tables
        for j0 in range(0, self.s, slots):
            j1 = min(self.s, j0 + slots)
            c, bb, er = (np.asarray(m[j0:j1])[:, b] for m in (t.c, t.b, t.exp_r))
            with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
                if self.dtype == np.float64:
                    x = lf[None, :] - bb
                    approx = c / (np.exp(x) * er)

                    def exact(jj, idx, c=c, x=x, er=er):
                        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
                            return c[jj, idx] / (go_exp(x[jj, idx]) * er[jj, idx])
                    margin = MARGIN
                else:
                    c, bb, er = (m.astype(self.dtype) for m in (c, bb, er))
                    approx = c / (np.exp(lf[None, :] - bb) * er)

                    def exact(jj, idx, approx=approx):
                        return approx[jj, idx]
                    margin = 0.0
            for j in range(j0, j1):
                self._select_slot(j, approx[j - j0], lambda idx, jj=j - j0: exact(jj, idx),
                                  b, margin)

    def _select_slot(self, j: int, a: np.ndarray, exact, b: np.ndarray,
                     margin: float) -> None:
        """Slot j over the elements in order: a their approximate A,
        exact(idx) the exact A of those at idx; the reference's rule on the
        exact values."""
        with np.errstate(over="ignore", invalid="ignore"):
            w = self.dtype(self.weights[j])
            if not self.drift:
                m = a.min()
                cand = np.flatnonzero(a <= m + margin * abs(m) if np.isfinite(m) else a == m)
                ex = exact(cand)
                k = int(np.argmin(ex))  # the first of the exact minima
                if ex[k] < w:
                    self.mins[j], self.weights[j] = b[cand[k]], ex[k]
                return
            d = self.dtype(self.decay)
            key = np.where(np.isfinite(a), a - margin * np.abs(a), a)  # at most the exact A
            chunk = 1024
            pad = -(-key.shape[0] // chunk) * chunk
            cmin = np.pad(key, (0, pad - key.shape[0]),
                          constant_values=np.inf).reshape(-1, chunk).min(1)
            i = 0
            while True:
                i = _first_below(key, cmin, chunk, i, w / d)
                if i < 0:
                    break
                e = exact(np.array([i]))[0]
                if e < w / d:
                    w = e
                    self.mins[j], self.weights[j] = b[i], e
                i += 1

