"""stream.device_flush_pct on canned counters: the card's flushes over all
flushes that ran; nothing to read where the program counts no flush."""
from __future__ import annotations

import importlib

import pytest

from hulkbench import spans
from hulkbench.run import Context, Job


@pytest.fixture
def ctx():
    return Context(config={"bins": 194481}, job_paths=[], window_s=10.0,
                   jobs=[Job("a", 10.0, 20.0, 0, 0.0)], work={"bases": 10**9}, trace=None)


@pytest.mark.parametrize("counts,want", [
    ({"flush.device": 66}, 100.0),
    ({"flush.device": 3, "flush.host": 1}, 75.0),
    ({"flush.host": 9, "stream.batches": 800}, 0.0),
    ({"stream.batches": 800}, None),  # a program without the counters
    ({}, None),
])
def test_the_device_flush_share_on_canned_counters(ctx, monkeypatch, counts, want):
    monkeypatch.setattr(spans, "counters", lambda: dict(counts))
    got = importlib.import_module("hulkbench.metrics.stream.device_flush_pct").read(ctx)
    assert got == (pytest.approx(want) if want is not None else None)
