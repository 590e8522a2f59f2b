"""Sketch state carried from hulk_tpu into the port (hulk_tpu_torch.state):
a run stopped mid-stream in hulk_tpu continues in the port, and both finish
with the same spectrum, count-min sketch, signature and weights, with and
without concept drift, and with the same KMV, KHF and HyperMinHash
sketches.

Tolerance: bit-equality (the same exact flush on the same state).
"""
import numpy as np
import pytest

from hulk_tpu.sketch.histosketch import HistoSketch as JaxHistoSketch
from hulk_tpu.sketch.hyperminhash import HyperMinHash as JaxHyperMinHash
from hulk_tpu.sketch.minhash import KHFSketch as JaxKHF
from hulk_tpu.sketch.minhash import KMVSketch as JaxKMV
from hulk_tpu.sketch.spectrum import KmerSpectrum as JaxKmerSpectrum
from hulk_tpu_torch.state import from_jax_state, state_arrays

NBINS, S, K = 14641, 20, 11


def flush(spectrum, hs):
    if spectrum.cardinality():
        bins, freqs = spectrum.dump()
        hs.add_elements(bins, freqs)
        spectrum.wipe()


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_continue_in_port_after_stop_in_jax(decay):
    rng = np.random.default_rng(int(decay * 10))
    chunks = [rng.integers(0, 2**50, size=20_000, dtype=np.uint64) for _ in range(4)]
    ref_spec, ref_hs = JaxKmerSpectrum(NBINS), JaxHistoSketch(K, S, NBINS, decay)
    ref_spec.add_hashes(chunks[0])
    flush(ref_spec, ref_hs)
    ref_spec.add_hashes(chunks[1])  # stopped with an unflushed spectrum

    spec, hs, *_ = from_jax_state(state_arrays(ref_spec, ref_hs, decay))
    assert np.array_equal(spec.bins, ref_spec.bins)
    for sp, h in ((ref_spec, ref_hs), (spec, hs)):
        sp.add_hashes(chunks[2])
        flush(sp, h)
        sp.add_hashes(chunks[3])
        flush(sp, h)
    assert np.array_equal(hs.sketch, ref_hs.sketch)
    assert np.array_equal(hs.sketch_weights, ref_hs.sketch_weights)
    assert np.array_equal(hs.cms.sketch, ref_hs.cms.sketch)
    hs.set_md5()
    ref_hs.set_md5()
    assert hs.get_md5() == ref_hs.get_md5()


def test_missing_or_mismatched_arrays_raise():
    spec, hs = JaxKmerSpectrum(NBINS), JaxHistoSketch(K, S, NBINS, 1.0)
    arrays = state_arrays(spec, hs, 1.0)
    with pytest.raises(KeyError):
        from_jax_state({k: v for k, v in arrays.items() if k != "cms"})
    with pytest.raises(ValueError):
        from_jax_state(dict(arrays, hist=np.zeros(10)))


def test_secondary_sketches_continue_in_port():
    rng = np.random.default_rng(5)
    chunks = [rng.integers(0, 2**64 - 1, size=5000, dtype=np.uint64) for _ in range(3)]
    spec, hs = JaxKmerSpectrum(NBINS), JaxHistoSketch(K, S, NBINS, 1.0)
    ref = [JaxKMV(K, S), JaxKHF(K, S), JaxHyperMinHash(K)]
    for obj in ref:
        obj.add_hashes(chunks[0])
    arrays = state_arrays(spec, hs, 1.0, *ref)
    assert {"kmv_values", "khf_sketch", "hmh_registers"} <= set(arrays)
    _, _, *port = from_jax_state(arrays)
    assert all(type(p).__module__.startswith("hulk_tpu_torch.") for p in port)
    for chunk in chunks[1:]:
        for obj in ref + port:
            obj.add_hashes(chunk)
    for p, r in zip(port, ref):
        assert np.array_equal(p.get_sketch(), r.get_sketch())
        p.set_md5()
        r.set_md5()
        assert p.get_md5() == r.get_md5()
    # without the arrays, the sketches are None
    assert from_jax_state(state_arrays(spec, hs, 1.0))[2:] == (None, None, None)
