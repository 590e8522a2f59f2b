"""Sketch state carried across from hulk_tpu.

For this system the counterpart of a model's weights is the sketch state:
the k-mer spectrum, the histosketch (signature and weights), its count-min
sketch and the CWS tables, and the KMV, KHF and HyperMinHash sketches where
they are on. `state_arrays` exports that state from either package's
objects as plain numpy arrays (it only reads attributes, so it needs no
import of hulk_tpu), and `from_jax_state` builds the port's objects from
them, so a run stopped in hulk_tpu can go on in the port with bit-identical
results. The secondary sketches' arrays are named as in hulk_tpu's
checkpoint payload (hulk_tpu/stream/pipeline.py:386-391).
"""
from __future__ import annotations

import numpy as np

from hulk_tpu_torch.hashes.cws import CWSTables
from hulk_tpu_torch.sketch.histosketch import HistoSketch
from hulk_tpu_torch.sketch.hyperminhash import HyperMinHash
from hulk_tpu_torch.sketch.minhash import KHFSketch, KMVSketch
from hulk_tpu_torch.sketch.spectrum import KmerSpectrum

KEYS = ("kmer_size", "decay_ratio", "hist", "sketch", "sketch_weights",
        "cms", "decay_weight", "cws_r", "cws_c", "cws_b", "cws_exp_r")


def state_arrays(spectrum, hs, decay_ratio: float, kmv=None, khf=None,
                 hmh=None) -> dict[str, np.ndarray]:
    """Export a spectrum and a histosketch (hulk_tpu's or the port's), and
    the KMV, KHF and HyperMinHash sketches that are given."""
    extra = {}
    if kmv is not None:
        extra["kmv_values"] = np.array(kmv._values, dtype=np.uint64)
    if khf is not None:
        extra["khf_sketch"] = np.array(khf.sketch, dtype=np.uint64)
    if hmh is not None:
        extra["hmh_registers"] = np.array(hmh.registers, dtype=np.uint64)
    return extra | {
        "kmer_size": np.asarray(hs.kmer_size),
        "decay_ratio": np.asarray(decay_ratio, dtype=np.float64),
        "hist": np.array(spectrum.bins, dtype=np.float64),
        "sketch": np.array(hs.sketch, dtype=np.uint64),
        "sketch_weights": np.array(hs.sketch_weights, dtype=np.float64),
        "cms": np.array(hs.cms.sketch, dtype=np.float64),
        "decay_weight": np.asarray(hs.cms.decay_weight, dtype=np.float64),
        "cws_r": np.asarray(hs.cws.r),
        "cws_c": np.asarray(hs.cws.c),
        "cws_b": np.asarray(hs.cws.b),
        "cws_exp_r": np.asarray(hs.cws.exp_r),
    }


def from_jax_state(arrays: dict[str, np.ndarray]) -> tuple:
    """Build the port's (KmerSpectrum, HistoSketch, KMVSketch, KHFSketch,
    HyperMinHash) from exported arrays; each of the last three is None
    where its array is absent."""
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"from_jax_state: missing arrays {missing}")
    hist = np.array(arrays["hist"], dtype=np.float64)
    tables = CWSTables(
        r=np.asarray(arrays["cws_r"], dtype=np.float64),
        c=np.ascontiguousarray(arrays["cws_c"], dtype=np.float64),
        b=np.ascontiguousarray(arrays["cws_b"], dtype=np.float64),
        exp_r=np.ascontiguousarray(arrays["cws_exp_r"], dtype=np.float64),
    )
    s, dims = tables.c.shape
    if hist.shape != (dims,):
        raise ValueError(f"from_jax_state: hist has {hist.shape[0]} bins, tables {dims}")
    spectrum = KmerSpectrum(dims)
    spectrum.bins = hist
    hs = HistoSketch(int(arrays["kmer_size"]), s, dims,
                     float(arrays["decay_ratio"]), tables=tables)
    hs.sketch = np.array(arrays["sketch"], dtype=np.uint64)
    hs.sketch_weights = np.array(arrays["sketch_weights"], dtype=np.float64)
    cms = np.array(arrays["cms"], dtype=np.float64)
    if cms.shape != hs.cms.sketch.shape:
        raise ValueError(f"from_jax_state: CMS shape {cms.shape}, expected {hs.cms.sketch.shape}")
    hs.cms.sketch = cms
    hs.cms.decay_weight = float(arrays["decay_weight"])
    k = hs.kmer_size
    kmv = khf = hmh = None
    if "kmv_values" in arrays:
        kmv = KMVSketch(k, s)
        kmv._values = np.array(arrays["kmv_values"], dtype=np.uint64)
    if "khf_sketch" in arrays:
        khf = KHFSketch(k, s)
        khf.sketch = np.array(arrays["khf_sketch"], dtype=np.uint64)
        if khf.sketch.shape != (s,):
            raise ValueError(f"from_jax_state: KHF sketch has {khf.sketch.shape[0]} "
                             f"entries, expected {s}")
    if "hmh_registers" in arrays:
        hmh = HyperMinHash(k)
        regs = np.array(arrays["hmh_registers"], dtype=np.uint64)
        if regs.shape != hmh.registers.shape:
            raise ValueError(f"from_jax_state: {regs.shape[0]} HyperMinHash registers, "
                             f"expected {hmh.registers.shape[0]}")
        hmh.registers = regs
    return spectrum, hs, kmv, khf, hmh
