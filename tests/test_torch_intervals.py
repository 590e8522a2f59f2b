"""The interval machinery of `sketch`: --stream/--streamAll, the background
interval flush and --checkpoint/--resume, hulk_tpu against the port.

hulk_tpu.cli.main and hulk_tpu_torch.cli.main (--device cpu, the plain
versions of both kernels) run in-process on the same seed-generated input.
k=11, w=5 keeps the CWS tables small (14,641 bins).

Tolerance: byte-identical bytes (stdout of --stream, out.json) and equal
counters. A mid-stream kill is built, as hulk_tpu's tests build it, by a run
on a prefix of the input: its last checkpoint is the one a killed run would
have left.
"""
import gzip
import io
import sys

import numpy as np
import pytest

import hulk_tpu.cli as jax_cli
import hulk_tpu.stream.pipeline as jax_pipeline
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch.stream import pipeline
from hulk_tpu_torch.stream.fastq import batch_reads_native, stream_reads
from hulk_tpu_torch.stream.pipeline import SketchConfig, _load_checkpoint, run_sketch_pipeline
from hulk_tpu_torch.synth import generate, generate_mixed


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("reads") / "reads.fq.gz"), 3000, seed=11)


@pytest.fixture(scope="module")
def mixed_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed")
    return generate_mixed(str(d / "mixed.fq.gz"), 600, lo=40, hi=1200, seed=5)


@pytest.fixture(scope="module")
def two_files(tmp_path_factory):
    """Two FASTQ files of 300 and 260 reads, and the first 100 reads of the
    second (a run killed in the middle of it)."""
    d = tmp_path_factory.mktemp("two")
    rng = np.random.default_rng(12)

    def write(path, seqs):
        with gzip.open(path, "wb") as fh:
            for i, seq in enumerate(seqs):
                fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
        return path

    seqs = [bytes(rng.choice(list(b"ACGT"), size=80).tolist()) for _ in range(560)]
    return (write(str(d / "a.fq.gz"), seqs[:300]), write(str(d / "b.fq.gz"), seqs[300:]),
            write(str(d / "b_head.fq.gz"), seqs[300:400]))


def _cli(main, args) -> bytes:
    """main(args) with sys.stdout captured; returns what went to it."""
    buf = io.BytesIO()
    out, sys.stdout = sys.stdout, io.TextIOWrapper(buf)
    try:
        assert main(args) == 0
        sys.stdout.flush()
    finally:
        sys.stdout.detach()
        sys.stdout = out
    return buf.getvalue()


def _json_docs(data: bytes) -> list:
    """The JSON documents of a --stream stdout, one after another."""
    import json

    dec, text, pos, docs = json.JSONDecoder(), data.decode(), 0, []
    while pos < len(text):
        doc, pos = dec.raw_decode(text, pos)
        docs.append(doc)
        pos += 1  # the newline after each
    return docs


@pytest.mark.parametrize("src,extra,n_snaps", [
    ("reads", ["-i", "1000"], 3),
    ("reads", ["-i", "700", "--kmv", "--khf", "--hmh"], 4),
    ("reads", ["-i", "700", "--streamAll", "--kmv", "--khf", "--hmh"], 4),
    ("reads", ["-i", "1000", "-x", "0.9", "--streamAll", "--kmv"], 3),
    ("mixed_reads", ["-i", "250", "-x", "0.9", "--streamAll", "--khf"], 2),
])
def test_stream_stdout_byte_identical(request, tmp_path, src, extra, n_snaps):
    """--stream: one JSON snapshot per interval on stdout, then the final
    sketch; the log goes to <out>.log. Snapshots carry the histosketch only,
    or with --streamAll every sketch. -i cuts across batches and, on mixed
    lengths (40-1,200 bp), across length buckets."""
    path = request.getfixturevalue(src)
    args = ["sketch", "-f", path, "-k", "11", "-w", "5", "-s", "8", "--stream", *extra]
    want = _cli(jax_cli.main, args + ["-o", str(tmp_path / "jax")])
    got = _cli(torch_cli.main, args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert got == want
    docs = _json_docs(got)
    assert len(docs) == n_snaps + 1
    algos = [[s["Algorithm"] for s in d["signatures"]] for d in docs]
    final = ["histosketch"] + [a for f, a in (("--kmv", "kmv"), ("--khf", "khf"),
                                              ("--hmh", "hyperminhash")) if f in extra]
    assert algos[-1] == final
    want_snap = final if "--streamAll" in extra else ["histosketch"]
    assert all(a == want_snap for a in algos[:-1])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert b"streaming: enabled" in (tmp_path / "port.log").read_bytes()


def _sketch_bytes(res) -> bytes:
    return res.hulk_data.to_json_bytes()


def _counters(res) -> tuple:
    return res.seq_count, res.length_total, res.minimizer_count


KW = dict(kmer_size=11, window_size=9, sketch_size=8, interval=100, kmv=True, khf=True,
          hmh=True, batch_size=64, device="cpu")


@pytest.mark.parametrize("decay", [1.0, 0.8])
def test_seek_resume_native(two_files, tmp_path, decay):
    """Native FASTQ input: the checkpoint of a run killed after file 0
    (origin (0, 300)) or 100 reads into file 1 (origin (1, 100)) resumes by
    seeking and gives the uninterrupted run's sketch and counters."""
    a, b, b_head = two_files
    kw = dict(KW, decay_ratio=decay)
    full = run_sketch_pipeline(None, SketchConfig(**kw, input_paths=[a, b]))
    for prefix, origin in (([a], (0, 300)), ([a, b_head], (1, 100))):
        ck = str(tmp_path / f"ck{len(prefix)}.npz")
        r1 = run_sketch_pipeline(None, SketchConfig(**kw, input_paths=prefix,
                                                    checkpoint_path=ck))
        assert r1.seq_count == 300 + 100 * (len(prefix) - 1)
        from hulk_tpu_torch.sketch.histosketch import HistoSketch

        hs = HistoSketch(11, 8, 11 ** 4, decay)
        sc, _, _, got_origin = _load_checkpoint(ck, SketchConfig(**kw), hs, None, None, None)
        assert (sc, got_origin) == (r1.seq_count, origin)
        r2 = run_sketch_pipeline(None, SketchConfig(**kw, input_paths=[a, b], resume_from=ck))
        assert _sketch_bytes(r2) == _sketch_bytes(full)
        assert _counters(r2) == _counters(full)


def test_seek_reads_only_the_tail(two_files):
    """The seek opens no earlier file and skips the consumed prefix of the
    boundary file by counting lines: the parser is fed file 1's bytes only,
    or two thirds of file 0 and all of file 1."""
    a, b, _ = two_files
    raw_a, raw_b = (len(gzip.open(p, "rb").read()) for p in (a, b))
    progress = {}
    batches = list(batch_reads_native([a, b], batch_size=64, start_file=0, skip_reads=300,
                                      progress=progress))
    assert sum(int((x.lengths > 0).sum()) for x in batches) == 260
    assert progress["parse_bytes"] <= raw_b
    progress = {}
    batches = list(batch_reads_native([a, b], batch_size=64, start_file=0, skip_reads=100,
                                      progress=progress))
    assert sum(int((x.lengths > 0).sum()) for x in batches) == 200 + 260
    assert progress["parse_bytes"] < raw_a * 2 / 3 + raw_b + (1 << 16)
    assert (batches[-1].file_idx, batches[-1].reads_in_file_end) == (1, 260)


def test_replay_resume_iterator(reads, tmp_path):
    """Iterator (STDIN) input cannot seek: resume replays the stream and
    skips the checkpoint's reads."""
    seqs = list(stream_reads([reads]))
    ck = str(tmp_path / "ck.npz")
    kw = dict(KW, interval=250, decay_ratio=0.8, batch_size=128)
    full = run_sketch_pipeline(iter(seqs), SketchConfig(**kw))
    r1 = run_sketch_pipeline(iter(seqs[:1100]), SketchConfig(**kw, checkpoint_path=ck))
    assert r1.seq_count == 1100
    r2 = run_sketch_pipeline(iter(seqs), SketchConfig(**kw, resume_from=ck))
    assert _sketch_bytes(r2) == _sketch_bytes(full)
    assert _counters(r2) == _counters(full)


def test_fasta_long_records_resume_by_replay(tmp_path):
    """--fasta resumes by replay (the seek is FASTQ-only), long records past
    65,536 bases included, each one read of the interval count."""
    rng = np.random.default_rng(31)
    lens = [300, 100_000, 200, 70_000, 5000, 400, 90_000, 3000]
    recs = [bytes(rng.choice(list(b"ACGT"), size=n).tolist()) for n in lens]

    def write(path, rs):
        with open(path, "wb") as fh:
            for i, r in enumerate(rs):
                fh.write(b">c%d\n%s\n" % (i, r))
        return path

    full_fa, head_fa = write(str(tmp_path / "all.fa"), recs), write(str(tmp_path / "h.fa"), recs[:4])
    kw = dict(KW, interval=2, hmh=False, fasta=True, batch_size=0)
    ck = str(tmp_path / "ck.npz")
    full = run_sketch_pipeline(None, SketchConfig(**kw, input_paths=[full_fa]))
    run_sketch_pipeline(None, SketchConfig(**kw, input_paths=[head_fa], checkpoint_path=ck))
    r2 = run_sketch_pipeline(None, SketchConfig(**kw, input_paths=[full_fa], resume_from=ck))
    assert _sketch_bytes(r2) == _sketch_bytes(full)
    assert _counters(r2) == _counters(full)


@pytest.mark.parametrize("writer", ["hulk_tpu", "port"])
def test_cross_package_resume(two_files, tmp_path, writer):
    """A checkpoint that one package writes resumes in the other, and gives
    hulk_tpu's uninterrupted out.json byte for byte: the checkpoint file is
    the same format in both."""
    a, b, b_head = two_files
    flags = ["-k", "11", "-w", "9", "-s", "8", "-i", "100", "-x", "0.9",
             "--kmv", "--khf", "--hmh"]
    cpu = ["--device", "cpu"]
    _cli(jax_cli.main, ["sketch", "-f", a, "-f", b, *flags, "-o", str(tmp_path / "full")])
    ck = str(tmp_path / "ck.npz")
    first, second = (jax_cli, torch_cli) if writer == "hulk_tpu" else (torch_cli, jax_cli)
    _cli(first.main, ["sketch", "-f", a, "-f", b_head, *flags, "--checkpoint", ck,
                      "-o", str(tmp_path / "cut"), *(cpu if first is torch_cli else [])])
    log = _cli(second.main, ["sketch", "-f", a, "-f", b, *flags, "--resume", ck,
                             "-o", str(tmp_path / "resumed"),
                             *(cpu if second is torch_cli else [])])
    assert (tmp_path / "resumed.json").read_bytes() == (tmp_path / "full.json").read_bytes()
    assert b"seek resume: file 1, skipping 100 records" in log


def _error_of(run, *args) -> str:
    with pytest.raises(ValueError) as e:
        run(*args)
    return str(e.value)


def test_resume_errors_match_reference(two_files, tmp_path):
    """A parameter mismatch, a missing checkpoint and resume without -i
    raise hulk_tpu's errors word for word."""
    a, _, _ = two_files
    ck = str(tmp_path / "ck.npz")
    run_sketch_pipeline(None, SketchConfig(**KW, input_paths=[a], checkpoint_path=ck))
    jkw = {k: v for k, v in KW.items() if k != "device"}
    cases = [dict(resume_from=ck, sketch_size=16), dict(resume_from=ck, interval=50),
             dict(resume_from=ck, decay_ratio=0.5), dict(resume_from=ck, interval=0),
             dict(resume_from=str(tmp_path / "none.npz"))]
    for over in cases:
        got = _error_of(run_sketch_pipeline, None, SketchConfig(**{**KW, **over},
                                                                input_paths=[a]))
        want = _error_of(jax_pipeline.run_sketch_pipeline, None, jax_pipeline.SketchConfig(
            **{**jkw, **over}, input_paths=[a], device_stream=False))
        assert got == want, over
    assert "mismatch: sketch_size=8 vs 16" in _error_of(
        run_sketch_pipeline, None, SketchConfig(**{**KW, "sketch_size": 16},
                                                input_paths=[a], resume_from=ck))


def test_flush_worker_overlaps_and_waits(reads, tmp_path, monkeypatch):
    """Each interval's flush is handed to the worker, and the streaming
    thread waits for it before the next drain: one wait an interval, plus
    the final one; the checkpoint's counters include the device's
    minimizers."""
    monkeypatch.setitem(pipeline.flush_stats, "flush_waits", [])
    ck = str(tmp_path / "ck.npz")
    res = run_sketch_pipeline(None, SketchConfig(kmer_size=11, window_size=5, sketch_size=8,
                                                 interval=500, device="cpu",
                                                 input_paths=[reads], checkpoint_path=ck))
    assert len(pipeline.flush_stats["flush_waits"]) == 3000 // 500
    z = np.load(ck)
    assert int(z["seq_count"]) == 3000 and int(z["minimizer_count"]) == res.minimizer_count


def test_slow_flush_worker_stays_exact(tmp_path, monkeypatch):
    """The worker and the streaming thread share the histosketch and the
    host spectrum. With every flush slowed down past an interval's
    streaming and the interpreter switching threads as often as it can,
    the streaming thread runs ahead and must wait before each drain (a
    long record goes to the device stream's carries and waits for
    nothing): stdout and out.json stay the unhurried run's."""
    import time

    from hulk_tpu_torch.sketch.histosketch import HistoSketch

    rng = np.random.default_rng(8)
    lens = [int(n) for n in rng.integers(200, 3000, 40)] + [70_000, 300, 90_000, 500]
    path = str(tmp_path / "in.fa")
    with open(path, "wb") as fh:
        for i, n in enumerate(lens):
            fh.write(b">c%d\n%s\n" % (i, bytes(rng.choice(list(b"ACGT"), size=n).tolist())))
    args = ["sketch", "-f", path, "--fasta", "-k", "11", "-w", "5", "-s", "8", "-i", "7",
            "-x", "0.9", "--kmv", "--khf", "--stream", "--streamAll"]
    calm = _cli(torch_cli.main, args + ["-o", str(tmp_path / "calm"), "--device", "cpu"])
    add = HistoSketch.add_elements

    def slow_add(self, *a):
        time.sleep(0.3)
        return add(self, *a)

    monkeypatch.setattr(HistoSketch, "add_elements", slow_add)
    monkeypatch.setitem(pipeline.flush_stats, "flush_waits", [])
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        busy = _cli(torch_cli.main, args + ["-o", str(tmp_path / "busy"), "--device", "cpu"])
    finally:
        sys.setswitchinterval(switch)
    assert busy == calm
    assert (tmp_path / "busy.json").read_bytes() == (tmp_path / "calm.json").read_bytes()
    assert sum(pipeline.flush_stats["flush_waits"]) > 0.05
