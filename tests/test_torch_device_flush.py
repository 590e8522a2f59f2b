"""--deviceFlush: the no-drift flush with its candidate stage on the device
(hulk_tpu_torch/parallel/mesh.py, plain PyTorch) and the exact host recheck,
against hulk_tpu's make_device_flush_candidates (one CPU device) and against
the exact host flush.

Tolerance: exact. cms_out and the estimates of shared candidate bins are
equal bit for bit; the histosketch after a flush (mins, weights compared as
u64 bits, CMS) is bit-identical to the host flush's and to hulk_tpu's.
Candidate indices are not compared: topk's order among ties is not
lax.top_k's, and exactness does not depend on it.
"""
import gzip

import numpy as np
import pytest
import torch

import hulk_tpu.cli as jax_cli
import hulk_tpu.stream.pipeline as jax_pipeline
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch.parallel import mesh
from hulk_tpu_torch.sketch.countmin import cms_row_bins_table
from hulk_tpu_torch.sketch.histosketch import HistoSketch
from hulk_tpu_torch.stream import pipeline
from hulk_tpu_torch.stream.pipeline import PipelineError, SketchConfig, run_sketch_pipeline
from hulk_tpu_torch.synth import generate

K, S, NBINS = 11, 8, 11 ** 4


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("reads") / "reads.fq.gz"), 1500, seed=3)


def _flush_inputs(seed: int, prior: bool):
    """A histogram of integer counts over about a third of the bins, the CMS
    row table, and a CMS that is zero or holds an earlier flush's counts."""
    rng = np.random.default_rng(seed)
    hist = np.where(rng.random(NBINS) < 0.35, rng.integers(1, 60, NBINS), 0).astype(np.int32)
    hs = HistoSketch(K, S, NBINS, 1.0)
    if prior:
        ids = np.sort(rng.choice(NBINS, 3000, replace=False)).astype(np.int64)
        hs.add_elements(ids, rng.integers(1, 9, 3000).astype(np.float64))
    depth, width = hs.cms.sketch.shape
    return hist, cms_row_bins_table(NBINS, depth, width), hs


@pytest.mark.parametrize("seed,prior", [(0, False), (1, True), (2, True)])
def test_candidates_match_reference(seed, prior):
    """The candidate stage against hulk_tpu's on one CPU device: cms_out
    exactly equal, the estimates of the bins both pick exactly equal; then
    the flush applied from the port's candidates is bit-identical to the
    exact host flush."""
    import jax

    from hulk_tpu.parallel.mesh import make_device_flush_candidates, make_sketch_mesh

    hist, row_bins, hs = _flush_inputs(seed, prior)
    t = hs.cws
    got = mesh.device_flush_candidates(
        torch.from_numpy(hist), torch.from_numpy(row_bins.astype(np.int64)),
        torch.from_numpy(hs.cms.sketch.copy()),
        *(torch.tensor(x) for x in (t.c, t.b, t.exp_r)))
    fn = make_device_flush_candidates(
        make_sketch_mesh(n_dp=1, n_mp=1, devices=jax.devices()[:1]), *hs.cms.sketch.shape)
    want = [np.asarray(x) for x in fn(hist, row_bins.astype(np.int32), hs.cms.sketch,
                                      np.asarray(t.c), np.asarray(t.b), np.asarray(t.exp_r))]
    cms_out, cb, ce, cl, mc = (x.numpy() for x in got)
    assert np.array_equal(cms_out.view(np.uint64), want[0].view(np.uint64))
    assert cl.all() and (mc >= 1).all() and (mc <= mesh.FLUSH_TOP_T).all()
    for j in range(S):
        shared, a, b = np.intersect1d(cb[j], want[1][j], return_indices=True)
        assert shared.size > 0
        assert np.array_equal(ce[j][a].view(np.uint64), want[2][j][b].view(np.uint64))

    host = HistoSketch(K, S, NBINS, 1.0, tables=t)
    host.cms.sketch = hs.cms.sketch.copy()
    host.sketch, host.sketch_weights = hs.sketch.copy(), hs.sketch_weights.copy()
    ids = np.nonzero(hist)[0].astype(np.int64)
    host.add_elements(ids, hist[ids].astype(np.float64))
    assert hs.apply_flush_candidates(cb, ce, cl, mc, mesh.FLUSH_TOP_T)
    assert np.array_equal(hs.sketch, host.sketch)
    assert np.array_equal(hs.sketch_weights.view(np.uint64), host.sketch_weights.view(np.uint64))
    assert np.array_equal(cms_out, host.cms.sketch)


def _hs_state(res):
    hs = dict(res.hulk_data.signatures)["histosketch"]
    return (np.asarray(hs.sketch, dtype=np.uint64),
            np.asarray(hs.sketch_weights, dtype=np.float64).view(np.uint64),
            np.asarray(hs.cms.sketch, dtype=np.float64))


def _assert_same(a, b, what):
    for x, y, name in zip(_hs_state(a), _hs_state(b), ("mins", "weights", "cms")):
        assert np.array_equal(x, y), (what, name)
    assert (a.seq_count, a.minimizer_count) == (b.seq_count, b.minimizer_count), what
    assert a.hulk_data.to_json_bytes() == b.hulk_data.to_json_bytes(), what


def _port(reads, **kw):
    return run_sketch_pipeline(None, SketchConfig(kmer_size=K, window_size=5, sketch_size=S,
                                                  device="cpu", input_paths=[reads], **kw))


def _reference(reads, **kw):
    kw.setdefault("batch_size", 256)
    cfg = jax_pipeline.SketchConfig(kmer_size=K, window_size=5, sketch_size=S,
                                    input_paths=[reads], device_stream=True,
                                    data_parallel=False, **kw)
    return jax_pipeline.run_sketch_pipeline(None, cfg)


@pytest.mark.parametrize("interval", [0, 400])
def test_device_flush_bit_identical(reads, interval, monkeypatch):
    """--deviceFlush against the port's host flush and against hulk_tpu's
    device_flush=True: mins, weights (u64 bits), CMS, counters and out.json
    bytes. No margin fallback fires."""
    monkeypatch.setitem(pipeline.flush_stats, "margin_fallbacks", 0)
    monkeypatch.setitem(pipeline.flush_stats, "device_flushes", 0)
    host = _port(reads, interval=interval)
    dev = _port(reads, interval=interval, device_flush=True)
    ref = _reference(reads, interval=interval, device_flush=True)
    _assert_same(dev, host, "port device flush vs port host flush")
    _assert_same(dev, ref, "port device flush vs hulk_tpu device flush")
    assert pipeline.flush_stats["device_flushes"] == (1500 // interval if interval else 0) + (
        1500 % interval != 0 if interval else 1)
    assert pipeline.flush_stats["margin_fallbacks"] == 0


def test_margin_overflow_falls_back(reads, monkeypatch):
    """With an absurd margin every live bin is a candidate, the margin count
    exceeds T, and each flush falls back to the exact host flush: the
    output stays bit-identical and the fallback counter says so."""
    monkeypatch.setattr(mesh, "FLUSH_MARGIN_REL", 1e30)
    monkeypatch.setitem(pipeline.flush_stats, "margin_fallbacks", 0)
    host = _port(reads, interval=500)
    dev = _port(reads, interval=500, device_flush=True)
    _assert_same(dev, host, "fallback")
    assert pipeline.flush_stats["margin_fallbacks"] == 3


def test_drift_refused_with_reference_message(reads):
    with pytest.raises(PipelineError) as got:
        _port(reads, decay_ratio=0.9, device_flush=True)
    with pytest.raises(jax_pipeline.PipelineError) as want:
        _reference(reads, decay_ratio=0.9, device_flush=True)
    assert str(got.value) == str(want.value)


def test_cli_device_flush_matches_reference_host_flush(reads, tmp_path):
    """The port's CLI with --deviceFlush writes hulk sketch's out.json."""
    args = ["sketch", "-f", reads, "-k", "11", "-w", "5", "-s", "8", "-i", "500",
            "--kmv", "--khf"]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu",
                                  "--deviceFlush"]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("interval", [0, 2])
def test_fasta_long_contigs_device_flush(tmp_path, interval):
    """--fasta --deviceFlush with contigs past 65,536 bases: the long reads'
    host counts are merged onto the device histogram before each flush
    (_merge_host_hist); the same as the host flush and as hulk_tpu's device
    flush."""
    rng = np.random.default_rng(31)
    recs = [bytes(rng.choice(list(b"ACGT"), size=n).tolist())
            for n in (300, 100_000, 200, 70_000, 5000)]
    path = str(tmp_path / "in.fasta.gz")
    with gzip.open(path, "wb") as fh:
        fh.write(b"".join(b">c%d\n%s\n" % (i, r) for i, r in enumerate(recs)))
    kw = dict(interval=interval, fasta=True, batch_size=32)
    dev = _port(path, device_flush=True, **kw)
    _assert_same(dev, _port(path, **kw), "fasta: port device vs host flush")
    _assert_same(dev, _reference(path, device_flush=True, **kw), "fasta: port vs hulk_tpu")
