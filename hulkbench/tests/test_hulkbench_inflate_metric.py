"""The reader of native.inflate_member_pct on canned counters: the member
route's share of the inflated bytes is 100 when zlib inflated nothing, and
a program that counted no inflated bytes leaves it nothing to read."""
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
    return importlib.import_module("hulkbench.metrics.native.inflate_member_pct").read(ctx)


@pytest.mark.parametrize("counts,want", [
    ({"input.inflate_member_bytes": 5, "stream.batches": 2}, 100.0),
    ({"input.inflate_member_bytes": 300, "input.inflate_zlib_bytes": 100}, 75.0),
    ({"input.inflate_zlib_bytes": 7}, 0.0),
    ({"input.inflate_member_bytes": 0, "input.inflate_zlib_bytes": 0}, None),
    ({"stream.batches": 2}, None),
    ({}, None),
])
def test_the_inflate_share_on_canned_counters(ctx, monkeypatch, counts, want):
    monkeypatch.setattr(spans, "counters", lambda: dict(counts))
    got = _read(ctx)
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_inflate_share_reads_nothing_without_records(ctx, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: [])
    monkeypatch.setattr(spans, "counters", lambda: {})
    assert _read(ctx) is None
