"""HistoSketch: similarity-preserving sketch of a streaming histogram
(Yang et al., ICDM'17), mirroring src/histosketch/histosketch.go including its
deviations from the paper (pre-multiplied beta*r table; CMS-estimated
frequencies; fixed DISTRIBUTION_SEED=1 making CWS tables identical across
runs/samples — the property that makes sketches comparable).

Update rule per incoming (bin, freq) element (histosketch.go:129-155):
    estiFreq = CMS.Add(bin, freq)                  # sequential state
    for each slot j:
        Yka  = exp(log(estiFreq) - b[j][bin])
        Aka  = c[j][bin] / (Yka * exp(r[j][bin]))
        curMin = weights[j] (/ decayWeight under concept drift)
        if Aka < curMin: sketch[j], weights[j] = bin, Aka

This host implementation uses the Go math.Exp/Log ports so weights match the
reference bit-for-bit; exp(r) is precomputed (a deterministic function of r,
hence bit-identical to calling exp at use time).
"""
from __future__ import annotations

import numpy as np

from hulk_tpu_torch.hashes.cws import CWSTables, get_cws_tables
from hulk_tpu_torch.hashes.fdlibm import go_exp, go_log
from hulk_tpu_torch.sketch.countmin import CountMinSketch

MAX_K = 31
MAX_FLOAT64 = np.finfo(np.float64).max


class HistoSketch:
    algorithm = "histosketch"

    def __init__(
        self,
        kmer_size: int,
        sketch_size: int,
        num_bins: int,
        decay_ratio: float,
        tables: CWSTables | None = None,
    ):
        if kmer_size > MAX_K:
            raise ValueError(f"histosketching only supports k <= {MAX_K}")
        if not 0.0 <= decay_ratio <= 1.0:
            raise ValueError("decay ratio must be between 0.0 and 1.0")
        if num_bins < 2:
            raise ValueError("histogram must have at least 2 bins")
        self.kmer_size = int(kmer_size)
        self.sketch_size = int(sketch_size)
        self.dimensions = int(num_bins)
        self.apply_concept_drift = decay_ratio != 1.0
        self.sketch = np.zeros(self.sketch_size, dtype=np.uint64)
        self.sketch_weights = np.full(self.sketch_size, MAX_FLOAT64, dtype=np.float64)
        self.cms = CountMinSketch(decay_ratio=decay_ratio)
        self.cws = tables if tables is not None else get_cws_tables(self.sketch_size, self.dimensions)
        self.md5sum = ""

    # ---- streaming update ------------------------------------------------

    def add_element(self, bin_id: int, value: float) -> None:
        esti = self.cms.add(bin_id, value)
        self._cws_update(int(bin_id), esti)

    def _cws_update(self, bin_id: int, esti_freq: float) -> None:
        yka = go_exp(go_log(esti_freq) - self.cws.b[:, bin_id])
        aka = self.cws.c[:, bin_id] / (yka * self.cws.exp_r[:, bin_id])
        with np.errstate(over="ignore"):  # MaxFloat64/decay -> +Inf, as in Go
            if self.apply_concept_drift:
                cur_min = self.sketch_weights / self.cms.decay_weight
            else:
                cur_min = self.sketch_weights
        better = aka < cur_min
        self.sketch[better] = np.uint64(bin_id)
        self.sketch_weights[better] = aka[better]

    def add_elements(self, bin_ids: np.ndarray, freqs: np.ndarray) -> None:
        """Flush a dumped spectrum (ascending bins) through the sketch.

        Bit-identical to add_element per (bin, freq) pair, but restructured
        for speed: the only true sequential dependency is the CMS counter
        state (collisions), so phase 1 runs the cheap CMS scan alone; phase 2
        computes every A_ka with one vectorised pass over [n_elements, s]
        (this is where all the exp/log work is); phase 3 reduces — without
        concept drift the Go replace-if-strictly-smaller loop is exactly
        "min + first-argmin", with drift it is a light scan over elements.
        """
        if bin_ids.size == 0:
            return
        n = bin_ids.shape[0]
        from hulk_tpu_torch.sketch.countmin import cms_row_bins_table

        table = cms_row_bins_table(self.dimensions, self.cms.depth, self.cms.width)
        row_bins = table[:, bin_ids]

        # native single-pass flush (bit-identical; tests/test_native.py)
        from hulk_tpu_torch import native

        if native.available() and native.flush_exact_native(
            bin_ids, freqs, row_bins, self.cms.sketch, self.cws.c, self.cws.b,
            self.cws.exp_r, self.sketch, self.sketch_weights,
            self.apply_concept_drift, self.cms.decay_weight,
        ):
            return

        estis = self.cms.add_many(row_bins, freqs.astype(np.float64))

        # phase 2: A_ka for all (element, slot) pairs — [n, s]
        b_t = self.cws.b[:, bin_ids]  # [s, n]
        c_t = self.cws.c[:, bin_ids]
        er_t = self.cws.exp_r[:, bin_ids]
        log_estis = go_log(estis)  # [n]
        with np.errstate(over="ignore", invalid="ignore"):
            yka = go_exp(log_estis[None, :] - b_t)  # [s, n]
            aka = c_t / (yka * er_t)  # [s, n]

        sketch = self.sketch
        weights = self.sketch_weights
        with np.errstate(over="ignore"):
            if not self.apply_concept_drift:
                best = np.argmin(aka, axis=1)  # first index achieving the min
                best_aka = aka[np.arange(aka.shape[0]), best]
                better = best_aka < weights
                sketch[better] = bin_ids[best[better]].astype(np.uint64)
                weights[better] = best_aka[better]
            else:
                dw = self.cms.decay_weight
                for i in range(n):
                    cur_min = weights / dw
                    better = aka[:, i] < cur_min
                    sketch[better] = np.uint64(bin_ids[i])
                    weights[better] = aka[better, i]

    # ---- accessors mirroring the SketchObject interface -------------------

    def get_sketch(self) -> np.ndarray:
        return self.sketch.copy()

    def get_algo(self) -> str:
        return self.algorithm

    def set_md5(self) -> None:
        from hulk_tpu_torch.io.sketchio import md5sum_u64

        self.md5sum = md5sum_u64(self.sketch)

    def get_md5(self) -> str:
        return self.md5sum
