"""hulk_tpu_torch.spans: off by default at the cost of one flag check; on,
the spans of one streamed `sketch` job on its four threads (the stream
thread, hulk-gunzip, hulk-parse and hulk-flush), under one job id, nested
on each thread, with the counts of the work and of the inflated bytes by
route; flush_stats["flush_waits"]
as before either way; and under torch.profiler the calling thread's spans
in the Chrome trace, each inside its own range.

Tiny gzip FASTQ on the CPU (--device cpu, the plain versions), k=11, w=5,
s=8, 4,000 reads in two files of 2,500 and 1,500, -i 1000: four intervals,
five batches (the first file's end cuts the third interval).
"""
import io
import json
import sys
import threading

import pytest

import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch import spans
from hulk_tpu_torch.stream import pipeline
from hulk_tpu_torch.synth import generate

INTERVALS = 4
BATCHES = 5
STREAM = ["-i", "1000", "-x", "0.9", "--stream"]


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    """The port's caches in the test's own directory, fresh flush waits, and
    no records left by an earlier test in this process (--profiling keeps
    its job's spans)."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setitem(pipeline.flush_stats, "flush_waits", [])
    spans.reset()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    return [generate(str(d / "a.fq.gz"), 2500, seed=3),
            generate(str(d / "b.fq.gz"), 1500, seed=4)]


@pytest.fixture
def spans_on():
    spans.enable(True)
    spans.reset()
    try:
        yield
    finally:
        spans.enable(False)
        spans.reset()


def _sketch(reads, out, *flags) -> bytes:
    """One `sketch` job in this thread; returns its stdout."""
    argv = ["sketch", "-k", "11", "-w", "5", "-s", "8", "-o", str(out), "--device", "cpu",
            *flags]
    for r in reads:
        argv += ["-f", r]
    buf = io.BytesIO()
    saved, sys.stdout = sys.stdout, io.TextIOWrapper(buf)
    try:
        assert torch_cli.main(argv) == 0
        sys.stdout.flush()
    finally:
        sys.stdout.detach()
        sys.stdout = saved
    return buf.getvalue()


def test_off_a_span_is_one_shared_null_context(reads, tmp_path, monkeypatch):
    """Off (the default): span() hands out one object and reads no clock,
    count() counts nothing, and a whole sketch leaves no record."""
    assert not spans.enabled()
    with monkeypatch.context() as m:
        m.setattr(spans, "time", None)  # any clock read would raise
        assert spans.span("a") is spans.span("b")
        with spans.span("a"):
            spans.count("stream.batches")
    _sketch(reads[:1], tmp_path / "out")
    assert spans.records() == [] and spans.counters() == {}


def test_on_a_streamed_sketch_is_one_job_on_four_threads(reads, tmp_path, spans_on):
    out = _sketch(reads, tmp_path / "out", *STREAM)
    assert out.count(b"\"class\": \"hulk_sketch\"") == INTERVALS + 1  # snapshots, final
    recs = spans.records()
    me = threading.current_thread().name
    threads = {r.thread for r in recs}
    assert {me, "hulk-gunzip", "hulk-parse"} <= threads
    assert any(t.startswith("hulk-flush") for t in threads), threads
    assert {t for t in threads if t not in (me, "hulk-gunzip", "hulk-parse")} \
        == {t for t in threads if t.startswith("hulk-flush")}

    root = [r for r in recs if r.parent is None]
    assert [r.name for r in root] == ["job"] and root[0].thread == me
    assert {r.job for r in recs} == {root[0].id}
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.t0 <= r.t1
        assert root[0].t0 <= r.t0 and r.t1 <= root[0].t1, r
        if r.parent is None:
            continue
        up = by_id[r.parent]
        if up.thread == r.thread:  # a thread's spans nest
            assert up.t0 <= r.t0 and r.t1 <= up.t1, (up, r)
        else:  # started or submitted from up
            assert up.t0 <= r.t0, (up, r)

    names = {}
    for r in recs:
        names.setdefault(r.name, []).append(r)
    assert {r.thread for r in names["input.gunzip"]} == {"hulk-gunzip"}
    assert {r.thread for r in names["input.parse"]} == {"hulk-parse"}
    assert {by_id[r.parent].name for r in names["input.chunk_wait"]} == {"input.parse"}
    assert {by_id[r.parent].name for r in names["input.gunzip"]} == {"input.parse"}
    assert {by_id[r.parent].name for r in names["stream.input_wait"]} == {"stream.loop"}
    assert len(names["stream.loop"]) == len(names["stream.finish"]) == 1
    # one flush an interval, submitted at a boundary
    assert len(names["flush.interval"]) == INTERVALS
    assert {by_id[r.parent].name for r in names["flush.interval"]} == {"stream.boundary"}
    assert len(names["stream.boundary"]) == INTERVALS
    # one sync a fused batch inside the step; the rest are the drains and
    # the minimizer count
    batches = spans.counters()["stream.batches"]
    assert batches == BATCHES
    in_step = [r for r in names["stream.sync"] if by_id[r.parent].name == "stream.step"]
    assert len(in_step) == batches
    assert len(names["stream.sync"]) == batches + INTERVALS + 2
    # the flush waits: one a wait, from the span's own clock reads
    waits = pipeline.flush_stats["flush_waits"]
    assert waits == [r.t1 - r.t0 for r in names["stream.flush_wait"]]
    assert len(waits) == INTERVALS


def test_a_long_record_is_one_batch_with_one_sync(tmp_path, spans_on):
    """A record past the batched path's length cap takes the long-read step:
    it counts as one batch and its one readback (the run heads' count) is a
    `stream.sync` inside `stream.long_read`."""
    import gzip

    import numpy as np

    rng = np.random.default_rng(5)
    path = tmp_path / "long.fq.gz"
    with gzip.open(path, "wb") as fh:
        for i, n in enumerate([150] * 20 + [70_000] + [150] * 20):
            seq = bytes(rng.choice(list(b"ACGT"), size=n).astype(np.uint8))
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * n))
    _sketch([str(path)], tmp_path / "out")
    recs = spans.records()
    by_id = {r.id: r for r in recs}
    long = [r for r in recs if r.name == "stream.long_read"]
    assert len(long) == 1
    inside = [r for r in recs if r.name == "stream.sync" and r.parent == long[0].id]
    assert len(inside) == 1
    stepped = sum(1 for r in recs if r.name == "stream.sync"
                  and by_id[r.parent].name == "stream.step")
    assert spans.counters()["stream.batches"] == stepped + 1


@pytest.mark.parametrize("cap", [None, 0])
def test_the_inflate_counts_its_bytes_by_route(reads, tmp_path, spans_on, monkeypatch, cap):
    """`input.inflate_member_bytes` and `input.inflate_zlib_bytes` count
    every inflated byte of the job's .gz inputs once, under the route that
    inflated it: the member route, or zlib when the cap (0 here) sends the
    files there; and each inflate step is one `input.gunzip` span."""
    import gzip

    from hulk_tpu_torch.stream import fastq

    if cap is not None:
        monkeypatch.setattr(fastq, "_INFLATE_CAP", cap)
    _sketch(reads, tmp_path / "out")
    total = 0
    for r in reads:
        with gzip.open(r, "rb") as fh:
            total += len(fh.read())
    counts = spans.counters()
    route, other = (("input.inflate_member_bytes", "input.inflate_zlib_bytes") if cap is None
                    else ("input.inflate_zlib_bytes", "input.inflate_member_bytes"))
    assert counts[route] == total and not counts.get(other)
    steps = [r for r in spans.records() if r.name == "input.gunzip"]
    assert len(steps) >= len(reads)


def test_flush_waits_one_entry_a_wait_with_spans_off(reads, tmp_path):
    _sketch(reads, tmp_path / "out", *STREAM)
    assert len(pipeline.flush_stats["flush_waits"]) == INTERVALS
    assert spans.records() == []


def test_the_profiler_holds_the_stream_threads_spans_on_its_clock(reads, tmp_path, spans_on):
    """The spans of the thread that runs the profiler appear in its Chrome
    trace as user_annotation, one range a span, in the same order. The
    range opens before the span reads its start and closes after it reads
    its end, so one shift of perf_counter onto the trace's clock puts every
    span inside its range, to 1 ms; a thread switch between the two stamps
    only widens the range."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sketch(reads[:1], tmp_path / "out", *STREAM)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = {}
    with open(path) as fh:
        for e in json.load(fh)["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation":
                a = float(e["ts"]) * 1e-6
                ranges.setdefault(e["name"], []).append((a, a + float(e["dur"]) * 1e-6))
    me = threading.current_thread().name
    mine = [r for r in spans.records() if r.thread == me]
    assert {"job", "stream.loop", "stream.input_wait", "stream.step"} <= {r.name for r in mine}
    least, most = [], []  # each span's shifts that put it inside its range
    for name in {r.name for r in mine}:
        own = sorted((r.t0, r.t1) for r in mine if r.name == name)
        got = sorted(ranges.get(name, []))
        assert len(got) == len(own), name
        for (a, b), (lo, hi) in zip(own, got):
            least.append(lo - a)
            most.append(hi - b)
    assert max(least) <= min(most) + 1e-3


def test_a_part_hangs_on_its_enclosing_spans_parent(spans_on):
    """spans.part: inside a span in time, a child of that span's parent, so
    that the span's self time (hulkbench.spans.self_seconds) keeps it; with
    no span around it, a root; off, the shared null context."""
    from hulkbench.spans import self_seconds

    with spans.span("job"):
        with spans.span("input.parse") as outer:
            with spans.part("input.parse_par") as inner:
                pass
    with spans.part("alone"):
        pass
    recs = {r.name: r for r in spans.records()}
    assert recs["input.parse_par"].parent == recs["job"].id == recs["input.parse"].parent
    assert recs["input.parse_par"].job == recs["job"].id
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert self_seconds(list(recs.values()), "input.parse", 0.0, 1e12) == \
        pytest.approx(outer.t1 - outer.t0)
    assert recs["alone"].parent is None
    spans.enable(False)
    assert spans.part("a") is spans.span("b")
