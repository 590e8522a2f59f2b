"""The reader of native.inflate_ahead_pct on canned counters: the share of
the member route's bytes that tasks gave from a guessed start, and nothing
to read where no byte was inflated ahead or no member was inflated."""
from __future__ import annotations

import importlib

import pytest

from hulkbench import spans
from hulkbench.run import Context, Job


@pytest.fixture
def ctx():
    return Context(config={}, job_paths=[], window_s=10.0,
                   jobs=[Job("a", 10.0, 15.0, 0, 0.0), Job("b", 15.0, 20.0, 0, 0.0)],
                   work={"bases": 10**9})


def _read(ctx):
    return importlib.import_module("hulkbench.metrics.native.inflate_ahead_pct").read(ctx)


@pytest.mark.parametrize("counts,want", [
    ({"input.inflate_member_bytes": 400, "input.inflate_ahead_bytes": 392,
      "input.inflate_tasks": 98}, 98.0),
    ({"input.inflate_member_bytes": 300, "input.inflate_ahead_bytes": 300}, 100.0),
    ({"input.inflate_member_bytes": 500, "input.inflate_zlib_bytes": 10}, None),
    ({"input.inflate_member_bytes": 500, "input.inflate_ahead_bytes": 0}, None),
    ({"input.inflate_ahead_bytes": 7}, None),
    ({"input.inflate_ahead_bytes": 7, "input.inflate_member_bytes": 0}, None),
    ({}, None),
])
def test_the_ahead_share_on_canned_counters(ctx, monkeypatch, counts, want):
    monkeypatch.setattr(spans, "counters", lambda: dict(counts))
    got = _read(ctx)
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_ahead_share_reads_nothing_without_the_program(ctx, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: None)
    monkeypatch.setattr(spans, "counters", lambda: {})
    assert _read(ctx) is None
