"""The readers of the parallel parse (native.parse_team_pct and
native.parse_par_Mbp_per_s) on canned counters and spans: the team's share
of -p, and the window's bases over the `input.parse_par` seconds inside the
window. A program without the counters or the span, or one that parsed
nothing in parallel, leaves them nothing to read."""
from __future__ import annotations

import importlib

import pytest

from hulk_tpu_torch.spans import Record
from hulkbench import spans
from hulkbench.run import Context, Job

PARSE = "hulk-parse"


def _r(name, t0, t1, id, parent, thread=PARSE):
    return Record(name, t0, t1, id, parent, 1, thread)


# the window is [10, 20] on perf_counter
RECORDS = [
    _r("job", 10.0, 15.0, 1, None, "MainThread"),
    _r("input.parse", 11.0, 14.0, 10, 1),
    _r("input.parse_par", 11.5, 12.5, 11, 1),  # 1.0
    _r("input.parse_par", 13.0, 13.5, 12, 1),  # 0.5
    _r("input.parse", 19.0, 21.0, 14, 1),
    _r("input.parse_par", 19.5, 20.5, 15, 1),  # straddles the end: 0.5 inside
    _r("input.parse_par", 9.0, 9.5, 16, 1),  # before the window
]


@pytest.fixture
def ctx():
    return Context(config={"processors": 8}, job_paths=[], window_s=10.0,
                   jobs=[Job("a", 10.0, 15.0, 0, 0.0), Job("b", 15.0, 20.0, 0, 0.0)],
                   work={"bases": 10**9})


def _read(name, ctx):
    return importlib.import_module(f"hulkbench.metrics.native.{name}").read(ctx)


@pytest.mark.parametrize("counts,processors,want", [
    ({"input.parse_par_calls": 4, "input.parse_team_threads": 32}, 8, 100.0),
    ({"input.parse_par_calls": 4, "input.parse_team_threads": 24}, 8, 75.0),
    ({"input.parse_par_calls": 3, "input.parse_team_threads": 3}, 1, 100.0),
    ({"input.parse_par_calls": 0, "input.parse_team_threads": 0}, 8, None),
    ({"stream.batches": 2}, 8, None),
    ({}, 8, None),
])
def test_the_team_share_on_canned_counters(ctx, monkeypatch, counts, processors, want):
    monkeypatch.setattr(spans, "counters", lambda: dict(counts))
    ctx.config["processors"] = processors
    got = _read("parse_team_pct", ctx)
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_parse_rate_counts_its_spans_inside_the_window(ctx, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: list(RECORDS))
    # two jobs of 1e9 bases over 2.0 s of parallel parse
    assert _read("parse_par_Mbp_per_s", ctx) == pytest.approx(2 * 1e9 / 2.0 / 1e6)


@pytest.mark.parametrize("recs", [
    [],
    None,
    [r for r in RECORDS if r.name != "input.parse_par"],
    [r for r in RECORDS if r.id == 16],
])
def test_the_parse_rate_reads_nothing_without_its_spans(ctx, monkeypatch, recs):
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert _read("parse_par_Mbp_per_s", ctx) is None


def test_neither_reads_anything_without_jobs(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: list(RECORDS))
    monkeypatch.setattr(spans, "counters", lambda: {})
    empty = Context(config={"processors": 8}, job_paths=[])
    assert _read("parse_par_Mbp_per_s", empty) is None
    assert _read("parse_team_pct", empty) is None
