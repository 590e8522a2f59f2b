"""LSH Forest index over histosketches.

The port's copy of hulk_tpu/index/lshforest.py: host NumPy, the same
banding, buckets, tie order and JSON, so an index written by either package
loads in the other and answers the same. Only the version constant is the
port's own.

No implementation exists in the reference tree — `hulk index -r
create|search -n NAME -j 0.90 -d DIR --recursive` appears only in the paper's
v0.0.2 notebooks (SURVEY.md §7 item 8) — so this is built from the standard
banded-LSH construction used by the original HULK paper's indexing scheme:

  * a sketch's s slots are split into b bands of r rows; each band's row
    values hash to a bucket key; sketches sharing >=1 band bucket are
    candidates.
  * (b, r) are chosen from the Jaccard threshold t so the S-curve
    midpoint (1/b)^(1/r) sits at t.
  * candidate ranking uses the positional-match Jaccard estimate on the full
    sketch (the same estimator smash uses); per-query candidate sets rank
    vectorised on host, and whole-corpus ranking can run on the devices
    (parallel/lsh.py).
  * `query_topk` implements the LSH *Forest* proper (Bawa et al. 2005):
    each band is a prefix tree kept as r sorted key arrays (depth 1..r);
    a query descends from the longest prefix, unioning equal-prefix runs
    across trees, until >=k candidates surface — so top-k needs no tuned
    threshold. `search` keeps the fixed-band >=t semantics of the v0.0.2
    CLI's `-j` flag (threshold queries); both rank candidates by the exact
    positional estimate.

Construction and banding are fully vectorised (one 64-bit polynomial band
hash over [N, b, r], buckets grouped with one argsort per band), so builds
scale to corpora far beyond what per-sketch Python hashing allowed. The
index serialises to a self-describing JSON envelope ("hulk_index", version
pinned); mins are packed little-endian base64 (the round-1 nested-int-list
form is still accepted on load).
"""
from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass, field

import numpy as np

from hulk_tpu_torch.version import HULK_COMPAT_VERSION


class LSHIndexError(ValueError):
    pass


def choose_bands(sketch_size: int, jaccard_thresh: float) -> tuple[int, int]:
    """Pick (n_bands, band_rows) with b*r <= s and (1/b)^(1/r) closest to t."""
    best = (sketch_size, 1)
    best_err = float("inf")
    for r in range(1, sketch_size + 1):
        b = sketch_size // r
        if b < 1:
            break
        midpoint = (1.0 / b) ** (1.0 / r) if b > 1 else 1.0
        err = abs(midpoint - jaccard_thresh)
        if err < best_err:
            best_err = err
            best = (b, r)
    return best


def _mix64(x: np.ndarray) -> np.ndarray:
    z = x.astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def band_keys(mins: np.ndarray, b: int, r: int) -> np.ndarray:
    """[N, s] sketch mins -> [N, b] u64 band keys (vectorised polynomial of
    mixed row values; one pass over the corpus instead of per-sketch
    hashing)."""
    x = np.ascontiguousarray(mins[:, : b * r]).reshape(-1, b, r).astype(np.uint64)
    acc = np.full(x.shape[:2], np.uint64(r), dtype=np.uint64)
    P = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        for j in range(r):
            acc = acc * P + _mix64(x[:, :, j] + np.uint64(j + 1))
    return _mix64(acc)


@dataclass
class LSHForest:
    kmer_size: int
    sketch_size: int
    jaccard_thresh: float
    n_bands: int = 0
    band_rows: int = 0
    names: list = field(default_factory=list)
    mins: np.ndarray | None = None  # [N, s] uint64
    buckets: list = field(default_factory=list)  # per band: {key: np.ndarray}

    def __post_init__(self):
        if self.n_bands == 0:
            self.n_bands, self.band_rows = choose_bands(
                self.sketch_size, self.jaccard_thresh
            )
        if self.mins is None:
            self.mins = np.empty((0, self.sketch_size), dtype=np.uint64)
        if not self.buckets:
            self.buckets = [dict() for _ in range(self.n_bands)]
        self._pending: list = []
        self._prefix: list | None = None  # per band, per depth sorted keys

    # ---- construction ----------------------------------------------------

    @property
    def mins_matrix(self) -> np.ndarray:
        """[N, s] rows; pending adds are materialised lazily (appending one
        row at a time would be O(N^2) in copies)."""
        if self._pending:
            self.mins = np.vstack([self.mins] + self._pending)
            self._pending = []
        return self.mins

    def add(self, name: str, sketch_mins: np.ndarray) -> None:
        self.add_batch([name], np.asarray(sketch_mins, dtype=np.uint64)[None, :])

    def add_batch(self, names: list, mins: np.ndarray) -> None:
        """Vectorised bulk insert: band keys for the whole batch in one pass,
        buckets extended via one argsort per band."""
        mins = np.asarray(mins, dtype=np.uint64)
        if mins.ndim != 2 or mins.shape[1] != self.sketch_size:
            raise LSHIndexError(
                f"sketch length mismatch: {mins.shape[-1]} vs {self.sketch_size}"
            )
        if len(names) != mins.shape[0]:
            raise LSHIndexError("names/mins length mismatch")
        base = len(self.names)
        self.names.extend(names)
        self._pending.append(mins)
        self._insert_band_keys(mins, base)
        self._prefix = None  # prefix trees are rebuilt lazily after inserts

    def _insert_band_keys(self, mins: np.ndarray, base: int) -> None:
        """Band-hash `mins` rows and extend the buckets with global ids
        base..base+N (one argsort per band)."""
        keys = band_keys(mins, self.n_bands, self.band_rows)  # [N, b]
        idx = np.arange(base, base + mins.shape[0], dtype=np.int64)
        for bi in range(self.n_bands):
            kb = keys[:, bi]
            order = np.argsort(kb, kind="stable")
            ks = kb[order]
            starts = np.flatnonzero(
                np.concatenate([[True], ks[1:] != ks[:-1]])
            )
            bounds = np.concatenate([starts, [ks.shape[0]]])
            bucket = self.buckets[bi]
            for a, z in zip(bounds[:-1], bounds[1:]):
                key = int(ks[a])
                ids = idx[order[a:z]]
                prev = bucket.get(key)
                bucket[key] = ids if prev is None else np.concatenate([prev, ids])

    # ---- query -----------------------------------------------------------

    def candidates(self, query_mins: np.ndarray) -> np.ndarray:
        keys = band_keys(
            np.asarray(query_mins, dtype=np.uint64)[None, :],
            self.n_bands, self.band_rows,
        )[0]
        parts = [
            self.buckets[bi].get(int(keys[bi]))
            for bi in range(self.n_bands)
        ]
        parts = [p for p in parts if p is not None]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(parts))

    def search(self, query_mins: np.ndarray, thresh: float | None = None):
        """-> list of (name, similarity) with sim >= thresh, best first."""
        t = self.jaccard_thresh if thresh is None else thresh
        cand = self.candidates(query_mins)
        if cand.size == 0:
            return []
        sims = (self.mins_matrix[cand] == np.asarray(query_mins)[None, :]).mean(axis=1)
        keep = sims >= t
        order = np.argsort(-sims[keep])
        kept = cand[keep][order]
        return [(self.names[i], float(s)) for i, s in zip(kept, sims[keep][order])]

    # ---- LSH Forest proper: prefix descent top-k -------------------------

    _PREFIX_P = np.uint64(0x9E3779B97F4A7C15)

    def _prefix_chain(self, rows: np.ndarray) -> list:
        """[N, b, r] row values -> per band a list of depth-d key arrays
        (d = 1..r): a running polynomial over the band's first d rows, so a
        depth-d match == the two sketches agree on those d slots."""
        out = []
        with np.errstate(over="ignore"):
            for bi in range(self.n_bands):
                acc = np.full(rows.shape[0], np.uint64(bi + 1), dtype=np.uint64)
                depths = []
                for d in range(self.band_rows):
                    acc = acc * self._PREFIX_P + _mix64(
                        rows[:, bi, d] + np.uint64(d + 1)
                    )
                    depths.append(_mix64(acc))
                out.append(depths)
        return out

    def _ensure_prefix_trees(self) -> None:
        m = self.mins_matrix
        if self._prefix is not None:
            return
        rows = (
            np.ascontiguousarray(m[:, : self.n_bands * self.band_rows])
            .reshape(-1, self.n_bands, self.band_rows)
            .astype(np.uint64)
        )
        chains = self._prefix_chain(rows)
        self._prefix = []
        for bi in range(self.n_bands):
            per_depth = []
            for keys in chains[bi]:
                order = np.argsort(keys, kind="stable").astype(np.int64)
                per_depth.append((keys[order], order))
            self._prefix.append(per_depth)

    def query_topk(self, query_mins: np.ndarray, k: int):
        """Top-k by prefix descent (Bawa et al. 2005): start at the longest
        band prefix (depth r) and shorten until >=k candidates are unioned
        across trees; rank candidates by the exact positional estimate.
        Returns a ranked list of (name, similarity), length <= k."""
        self._ensure_prefix_trees()
        m = self.mins_matrix
        n = m.shape[0]
        if n == 0 or k <= 0:
            return []
        q = np.asarray(query_mins, dtype=np.uint64)
        if q.shape != (self.sketch_size,):
            raise LSHIndexError(
                f"sketch length mismatch: {q.shape[-1]} vs {self.sketch_size}"
            )
        qchain = self._prefix_chain(q[None, :].reshape(1, -1)[
            :, : self.n_bands * self.band_rows
        ].reshape(1, self.n_bands, self.band_rows))
        mask = np.zeros(n, dtype=bool)
        for d in range(self.band_rows - 1, -1, -1):
            for bi in range(self.n_bands):
                keys_sorted, order = self._prefix[bi][d]
                qk = qchain[bi][d][0]
                lo = np.searchsorted(keys_sorted, qk, side="left")
                hi = np.searchsorted(keys_sorted, qk, side="right")
                if hi > lo:
                    mask[order[lo:hi]] = True
            if int(mask.sum()) >= k:
                break
        cand = np.flatnonzero(mask)
        if cand.size == 0:
            return []
        sims = (m[cand] == q[None, :]).mean(axis=1)
        order2 = np.argsort(-sims, kind="stable")[:k]
        return [(self.names[cand[i]], float(sims[i])) for i in order2]

    def search_batch(self, query_mins: np.ndarray, thresh: float | None = None):
        """Per-query LSH prefilter + vectorised candidate ranking (host).
        For whole-corpus, no-prefilter ranking at scale, use the device
        ranking of parallel/lsh.py."""
        return [self.search(query_mins[i], thresh) for i in range(query_mins.shape[0])]

    # kept as an alias for round-1 callers
    search_batch_device = search_batch

    # ---- serialisation ---------------------------------------------------

    def write_json(self, path: str) -> None:
        m = self.mins_matrix
        doc = {
            "class": "hulk_index",
            "version": HULK_COMPAT_VERSION,
            "ksize": self.kmer_size,
            "sketch_size": self.sketch_size,
            "jaccard_thresh": self.jaccard_thresh,
            "n_bands": self.n_bands,
            "band_rows": self.band_rows,
            "names": self.names,
            "mins_b64": base64.b64encode(
                np.ascontiguousarray(m.astype("<u8")).tobytes()
            ).decode("ascii"),
        }
        with open(path, "w") as fh:
            json.dump(doc, fh)

    @classmethod
    def load_json(cls, path: str) -> "LSHForest":
        if not os.path.exists(path):
            raise LSHIndexError(f"file does not exist: {path}")
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("class") != "hulk_index":
            raise LSHIndexError(f"JSON is not a HULK index: {path}")
        if doc.get("version") != HULK_COMPAT_VERSION:
            raise LSHIndexError(
                f"index was created with a different version of HULK: {doc.get('version')}"
            )
        forest = cls(
            kmer_size=doc["ksize"],
            sketch_size=doc["sketch_size"],
            jaccard_thresh=doc["jaccard_thresh"],
            n_bands=doc["n_bands"],
            band_rows=doc["band_rows"],
        )
        n, s = len(doc["names"]), doc["sketch_size"]
        if "mins_b64" in doc:
            # streamed decode: base64 chunks land directly in the final
            # buffer (no whole-blob bytes + frombuffer + astype triple copy)
            mins = np.empty((n, s), dtype="<u8")
            flat = mins.view(np.uint8).reshape(-1)
            b64 = doc["mins_b64"]
            CH = 4 << 20  # multiple of 4 -> chunks decode independently
            pos = off = 0
            while pos < len(b64):
                part = base64.b64decode(b64[pos : pos + CH])
                flat[off : off + len(part)] = np.frombuffer(part, dtype=np.uint8)
                pos += CH
                off += len(part)
            if off != mins.nbytes:
                raise LSHIndexError(f"index mins payload truncated: {path}")
            mins = mins.astype(np.uint64, copy=False)  # no-op on little-endian
        else:  # round-1 nested-int-list form
            mins = np.array(doc["mins"], dtype=np.uint64).reshape(n, s)
        del doc["mins_b64" if "mins_b64" in doc else "mins"]
        if n:
            # set state directly (add_batch would re-buffer + vstack a copy),
            # banding the rows in bounded chunks
            forest.names = list(doc["names"])
            forest.mins = mins
            CHROWS = 1 << 16
            for a in range(0, n, CHROWS):
                forest._insert_band_keys(mins[a : a + CHROWS], a)
        return forest
