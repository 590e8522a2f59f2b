"""The readers of the program's spans (hulkbench/spans.py and the six
metrics that read it) on canned records: spans that straddle the window's
edges count only inside it, and a child on another thread is not taken
from its parent's self time. A program without spans leaves every reader
nothing to read."""
from __future__ import annotations

import importlib
import sys

import pytest

from hulk_tpu_torch.spans import Record
from hulkbench import spans
from hulkbench.run import Context, Job

READERS = ["native.gunzip_Mbp_per_s", "native.parse_self_Mbp_per_s",
           "stream.input_wait_pct", "cli.outside_stream_pct",
           "stream.interval_flush_s", "stream.host_syncs_per_batch"]
MAIN, GUNZIP, PARSE, FLUSH = "MainThread", "hulk-gunzip", "hulk-parse", "hulk-flush_0"


def _r(name, t0, t1, id, parent, thread):
    return Record(name, t0, t1, id, parent, 1, thread)


# the window is [10, 20] on perf_counter
RECORDS = [
    _r("job", 10.0, 15.0, 1, None, MAIN),
    _r("stream.loop", 10.0, 18.0, 2, 1, MAIN),
    _r("stream.loop", 19.0, 21.0, 3, 1, MAIN),  # straddles the end: 1.0 inside
    _r("stream.input_wait", 9.5, 10.5, 4, 2, MAIN),  # straddles the start: 0.5
    _r("stream.input_wait", 12.0, 13.0, 5, 2, MAIN),
    _r("stream.input_wait", 19.5, 20.5, 6, 3, MAIN),  # 0.5 inside
    _r("input.parse", 11.0, 14.0, 10, 2, PARSE),
    _r("input.chunk_wait", 12.0, 13.0, 11, 10, PARSE),  # same thread: not self time
    _r("input.gunzip", 9.0, 11.0, 12, 10, GUNZIP),  # another thread: stays in self time
    _r("input.gunzip", 14.0, 15.0, 13, 10, GUNZIP),
    _r("input.parse", 19.0, 21.0, 14, 2, PARSE),  # 1.0 inside
    _r("input.chunk_wait", 20.0, 20.5, 15, 14, PARSE),  # outside: takes nothing off
    _r("flush.interval", 11.0, 12.0, 20, 2, FLUSH),
    _r("flush.interval", 13.0, 13.5, 21, 2, FLUSH),
    _r("flush.interval", 15.0, 17.0, 22, 2, FLUSH),
    _r("flush.interval", 19.5, 20.5, 23, 2, FLUSH),  # not wholly inside: not in the median
    _r("stream.sync", 9.9, 9.95, 30, 2, MAIN),  # before the window
    _r("stream.sync", 11.0, 11.01, 31, 2, MAIN),
    _r("stream.sync", 12.0, 12.01, 32, 2, MAIN),
    _r("stream.sync", 19.99, 20.1, 33, 3, MAIN),
]


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: list(RECORDS))
    monkeypatch.setattr(spans, "counters", lambda: {"stream.batches": 2})
    return Context(config={}, job_paths=[], window_s=10.0,
                   jobs=[Job("a", 10.0, 15.0, 0, 0.0), Job("b", 15.0, 20.0, 0, 0.0)],
                   work={"bases": 10**9})


def _read(name, ctx):
    return importlib.import_module(f"hulkbench.metrics.{name}").read(ctx)


def test_the_window():
    c = Context(config={}, job_paths=[], window_s=10.0,
                jobs=[Job("a", 10.0, 15.0, 0, 0.0), Job("b", 15.0, 19.9995, 0, 0.0)])
    assert spans.window(c) == (10.0, 20.0)
    assert spans.window(Context(config={}, job_paths=[], jobs=c.jobs)) is None
    assert spans.window(Context(config={}, job_paths=[], window_s=10.0, jobs=[])) is None


def test_self_time_takes_off_same_thread_children_inside_the_window():
    assert spans.seconds(RECORDS, "input.parse", 10.0, 20.0) == pytest.approx(4.0)
    assert spans.self_seconds(RECORDS, "input.parse", 10.0, 20.0) == pytest.approx(3.0)
    assert spans.seconds(RECORDS, "input.gunzip", 10.0, 20.0) == pytest.approx(2.0)


@pytest.mark.parametrize("name,want", [
    ("native.gunzip_Mbp_per_s", 2e9 / 2.0 / 1e6),
    ("native.parse_self_Mbp_per_s", 2e9 / 3.0 / 1e6),
    ("stream.input_wait_pct", 100 * 2.0 / 10),
    ("cli.outside_stream_pct", 100 * (10 - 9.0) / 10),
    ("stream.interval_flush_s", 1.0),
    ("stream.host_syncs_per_batch", 3 / 2),
])
def test_reader_on_canned_records(ctx, name, want):
    assert _read(name, ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_records(ctx, monkeypatch, name):
    monkeypatch.setattr(spans, "records", lambda: [])
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_leaves_the_reader_nothing(monkeypatch, name):
    """An older checkout has no hulk_tpu_torch.spans: start() does not raise
    and read() gives None."""
    import hulk_tpu_torch

    monkeypatch.delattr(hulk_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "hulk_tpu_torch.spans", None)
    c = Context(config={}, job_paths=[], window_s=10.0,
                jobs=[Job("a", 10.0, 20.0, 0, 0.0)], work={"bases": 10**9})
    mod = importlib.import_module(f"hulkbench.metrics.{name}")
    mod.start(c)
    assert mod.read(c) is None


def test_start_turns_the_program_spans_on_and_clears_them():
    from hulk_tpu_torch import spans as program

    try:
        program.enable(True)
        with program.span("old"):
            pass
        spans.start(None)
        assert program.enabled() and program.records() == []
    finally:
        program.enable(False)
        program.reset()
