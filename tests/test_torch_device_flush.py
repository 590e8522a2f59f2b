"""--deviceFlush: every flush through _CardFlusher (parallel/mesh.py
sharded_flush_step, Go's Exp and Log in their plain versions on the CPU),
against the exact host flush and against hulk_tpu's device_flush=True.

Tolerance: exact. The histosketch after a flush (mins, weights compared as
u64 bits, CMS) is bit-identical to the host flush's and to hulk_tpu's, and
out.json is byte-identical.
"""
import gzip

import numpy as np
import pytest
import torch

import hulk_tpu.cli as jax_cli
import hulk_tpu.stream.pipeline as jax_pipeline
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch import spans
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
    """A histogram of integer counts over about a third of the bins, and a
    sketch whose CMS is zero or holds an earlier flush's counts."""
    rng = np.random.default_rng(seed)
    hist = np.where(rng.random(NBINS) < 0.35, rng.integers(1, 60, NBINS), 0).astype(np.int32)
    hs = HistoSketch(K, S, NBINS, 1.0)
    if prior:
        ids = np.sort(rng.choice(NBINS, 3000, replace=False)).astype(np.int64)
        hs.add_elements(ids, rng.integers(1, 9, 3000).astype(np.float64))
    return hist, hs


@pytest.mark.parametrize("seed,prior", [(0, False), (1, True), (2, True)])
def test_device_flush_route_matches_host_flush(seed, prior):
    """_CardFlusher, the route --deviceFlush takes, on the CPU: one flush is
    bit-identical to the exact host flush (HistoSketch.add_elements) of the
    same histogram in the CMS, the bins and the weights' u64 bits."""
    hist, hs = _flush_inputs(seed, prior)
    host = HistoSketch(K, S, NBINS, 1.0, tables=hs.cws)
    host.cms.sketch = hs.cms.sketch.copy()
    host.sketch, host.sketch_weights = hs.sketch.copy(), hs.sketch_weights.copy()
    ids = np.nonzero(hist)[0].astype(np.int64)
    host.add_elements(ids, hist[ids].astype(np.float64))
    flusher = pipeline._CardFlusher(hs, NBINS, [torch.device("cpu")])
    flusher.flush_from(torch.from_numpy(hist))
    flusher.sync_cms()
    assert np.array_equal(hs.cms.sketch.view(np.uint64), host.cms.sketch.view(np.uint64))
    assert np.array_equal(hs.sketch, host.sketch)
    assert np.array_equal(hs.sketch_weights.view(np.uint64), host.sketch_weights.view(np.uint64))


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


def _flush_counts(run):
    """run() with spans on; returns its result and its flush.* counters."""
    spans.enable(True)
    spans.reset()
    try:
        res = run()
        counts = {k: v for k, v in spans.counters().items() if k.startswith("flush.")}
    finally:
        spans.enable(False)
        spans.reset()
    return res, counts


@pytest.mark.parametrize("interval", [0, 400])
def test_device_flush_bit_identical(reads, interval):
    """--deviceFlush against the port's host flush and against hulk_tpu's
    device_flush=True: mins, weights (u64 bits), CMS, counters and out.json
    bytes. Every flush takes the device route, none the host's."""
    host = _port(reads, interval=interval)
    dev, counts = _flush_counts(lambda: _port(reads, interval=interval, device_flush=True))
    ref = _reference(reads, interval=interval, device_flush=True)
    _assert_same(dev, host, "port device flush vs port host flush")
    _assert_same(dev, ref, "port device flush vs hulk_tpu device flush")
    assert counts == {"flush.device": -(-1500 // interval) if interval else 1}


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
    """--fasta --deviceFlush with contigs past 65,536 bases: the long-read
    step counts them into the device histogram that each flush takes; the
    same as the host flush and as hulk_tpu's device flush."""
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
