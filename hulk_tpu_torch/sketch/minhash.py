"""MinHash sketch variants: KMV (bottom-k) and KHF (k hash functions).

The port's copy of hulk_tpu/sketch/minhash.py (NumPy only), with set_md5
reading the port's own io.sketchio.

Mirror src/minhash/kmv.go and khf.go. Note the reference constructs these but
never feeds them (dead wiring, boss.go:90-95 — `--kmv` crashes at save,
`--khf` saves all-MaxUint64); here they are fed the same per-read-distinct
minimizer stream as the spectrum, making the flags functional as the
documentation intends (see SURVEY.md §2.1).

The Go KMV heap maintains exactly the k smallest values including duplicates,
and serialises them sorted ascending (kmv.go:162-169); a sort-based
maintenance produces identical output, and is the batched form that runs well
as a device kernel (merge + top-k).
"""
from __future__ import annotations

import numpy as np

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


class KMVSketch:
    algorithm = "kmv"

    def __init__(self, kmer_size: int, sketch_size: int):
        self.kmer_size = int(kmer_size)
        self.sketch_size = int(sketch_size)
        self._values = np.empty(0, dtype=np.uint64)  # kept sorted ascending
        self.md5sum = ""

    def add_hash(self, hv: int) -> None:
        self.add_hashes(np.array([hv], dtype=np.uint64))

    def add_hashes(self, hvs: np.ndarray) -> None:
        if hvs.size == 0:
            return
        merged = np.sort(np.concatenate([self._values, hvs.astype(np.uint64)]))
        self._values = merged[: self.sketch_size]

    def get_sketch(self) -> np.ndarray:
        return self._values.copy()

    def get_similarity(self, other: "KMVSketch") -> float:
        """Multiset intersection over the longer sketch (kmv.go:119-159)."""
        if not isinstance(other, KMVSketch):
            raise TypeError("mismatched MinHash types")
        a, b = self._values, other._values
        longer, shorter = (a, b) if a.size > b.size else (b, a)
        if longer.size == 0:
            return 0.0
        vals, counts = np.unique(longer, return_counts=True)
        remaining = dict(zip(vals.tolist(), counts.tolist()))
        intersect = 0
        for v in shorter.tolist():
            c = remaining.get(v, 0)
            if c > 0:
                remaining[v] = c - 1
                intersect += 1
        return intersect / float(longer.size)

    def get_algo(self) -> str:
        return self.algorithm

    def set_md5(self) -> None:
        from hulk_tpu_torch.io.sketchio import md5sum_u64

        self.md5sum = md5sum_u64(self.get_sketch())

    def get_md5(self) -> str:
        return self.md5sum


class KHFSketch:
    algorithm = "khf"

    def __init__(self, kmer_size: int, sketch_size: int):
        self.kmer_size = int(kmer_size)
        self.sketch_size = int(sketch_size)
        self.sketch = np.full(sketch_size, U64MAX, dtype=np.uint64)
        self.md5sum = ""

    def add_hash(self, hv: int) -> None:
        self.add_hashes(np.array([hv], dtype=np.uint64))

    def add_hashes(self, hvs: np.ndarray) -> None:
        """sketch[i] = min over stream of (hv + i*hv), wrapping (khf.go:35-45)."""
        if hvs.size == 0:
            return
        i = np.arange(self.sketch_size, dtype=np.uint64)[:, None]
        vals = hvs.astype(np.uint64)[None, :] + i * hvs.astype(np.uint64)[None, :]
        self.sketch = np.minimum(self.sketch, vals.min(axis=1))

    def merge(self, other: "KHFSketch") -> None:
        self.sketch = np.minimum(self.sketch, other.sketch)

    def get_sketch(self) -> np.ndarray:
        return self.sketch.copy()

    def get_similarity(self, other: "KHFSketch") -> float:
        """Positional-match Jaccard (khf.go:79-100)."""
        a, b = self.sketch, other.sketch
        n = min(a.size, b.size)
        if n == 0:
            return 0.0
        return float(np.count_nonzero(a[:n] == b[:n])) / n

    def get_algo(self) -> str:
        return self.algorithm

    def set_md5(self) -> None:
        from hulk_tpu_torch.io.sketchio import md5sum_u64

        self.md5sum = md5sum_u64(self.sketch)

    def get_md5(self) -> str:
        return self.md5sum
