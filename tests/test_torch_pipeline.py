"""`sketch` end to end: hulk_tpu.cli.main and hulk_tpu_torch.cli.main
(--device cpu, the plain versions of both kernels) run in-process on the
same seed-generated FASTQ and must write byte-identical out.json, for the
defaults, -s 42, -i (interval flushes) and -x 0.9 (concept drift). k=11,
w=5 keeps the CWS tables small (14,641 bins); one case runs the default
k=21, w=9 with a small -s. Reads of mixed lengths (40-3,000 bp) cover the
length buckets 128 to 4096, the group flush on a change of bucket, the
split by rows past L = 2048 and -i cutting across buckets.

Tolerance: byte-identical JSON (integer histograms, then the same exact host
flush).
"""
import numpy as np
import pytest

import hulk_tpu.cli as jax_cli
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch.stream.pipeline import PipelineError, SketchConfig, run_sketch_pipeline
from hulk_tpu_torch.synth import generate, generate_mixed


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    return generate(str(d / "reads.fq.gz"), 3000, read_len=150, seed=11)


@pytest.mark.parametrize("extra", [[], ["-s", "42"], ["-i", "1000"], ["-x", "0.9"],
                                   ["-i", "700", "-x", "0.9", "-b", "lbl"],
                                   ["-k", "21", "-w", "9", "-s", "8"]])
def test_out_json_byte_identical(reads, tmp_path, monkeypatch, extra):
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    args = ["sketch", "-f", reads, "-k", "11", "-w", "5", *extra]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want


@pytest.fixture(scope="module")
def mixed_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed")
    return generate_mixed(str(d / "mixed.fq.gz"), 2500, lo=40, hi=3000, seed=5)


@pytest.mark.parametrize("extra", [["-i", "333"], ["-i", "700", "-x", "0.9"]])
def test_mixed_lengths_byte_identical(mixed_reads, tmp_path, monkeypatch, extra):
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    args = ["sketch", "-f", mixed_reads, "-k", "11", "-w", "5", *extra]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_reads_iterator_matches_native_path(reads, tmp_path, monkeypatch):
    """STDIN-style input (Python parser, padded batches) gives the same
    sketch and counts as the native parser."""
    from hulk_tpu_torch.stream.fastq import stream_reads

    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    cfg = dict(kmer_size=11, window_size=5, device="cpu", interval=1000)
    a = run_sketch_pipeline(None, SketchConfig(input_paths=[reads], **cfg))
    b = run_sketch_pipeline(stream_reads([reads]), SketchConfig(**cfg))
    assert (a.seq_count, a.length_total, a.minimizer_count) == (
        b.seq_count, b.length_total, b.minimizer_count)
    assert a.seq_count == 3000 and a.minimizer_count > 0
    assert a.hulk_data.to_json_bytes() == b.hulk_data.to_json_bytes()


def test_long_batches_split_by_rows(monkeypatch, tmp_path):
    """R x L stays bounded: a batch past MAX_BATCH_POSITIONS is stepped in
    row slices, with the same result."""
    from hulk_tpu_torch.stream import pipeline

    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    rng = np.random.default_rng(2)
    seqs = [bytes(rng.choice(list(b"ACGT"), size=150).tolist()) for _ in range(900)]
    cfg = dict(kmer_size=11, window_size=5, device="cpu")
    a = run_sketch_pipeline(iter(seqs), SketchConfig(**cfg))
    monkeypatch.setattr(pipeline, "MAX_BATCH_POSITIONS", 160 * 100)
    b = run_sketch_pipeline(iter(seqs), SketchConfig(**cfg))
    assert a.minimizer_count == b.minimizer_count > 0
    assert a.hulk_data.to_json_bytes() == b.hulk_data.to_json_bytes()


@pytest.mark.parametrize("field,value,what", [
    ("checkpoint_path", "x.ckpt", "--checkpoint"), ("device_flush", True, "--deviceFlush"),
    ("on_interval", print, "--stream"),
])
def test_unported_options_raise(field, value, what):
    on_interval = value if field == "on_interval" else None
    cfg = SketchConfig(device="cpu", **({} if on_interval else {field: value}))
    with pytest.raises(PipelineError, match=what):
        run_sketch_pipeline(iter([b"ACGT" * 40]), cfg, on_interval=on_interval)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(PipelineError, match="no CUDA device"):
        run_sketch_pipeline(iter([b"ACGT" * 40]), SketchConfig(device="cuda"))


def test_version(capsys):
    assert torch_cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == "1.0.0"
