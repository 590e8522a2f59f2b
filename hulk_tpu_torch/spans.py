"""Spans and counters of the program's own work, for measurement.

Off by default: `span()` returns one shared null context after a single
flag check, and `count()` returns at once. Once `enable(True)`, a span
records its name, start and end on `time.perf_counter()`, its id, its
parent's id (the span open around it on its thread, or for a `part()` that
span's parent; for a thread's outermost spans, the span that started the
thread or submitted the task, handed over by `carry()`), its job's id (the
root span's) and its thread's name, in one list in memory until `reset()`.
On a thread that a running torch.profiler records, a span also enters
`record_function(name)`, so it lies in the Chrome trace on the kernels'
clock; elsewhere the range would be dropped, at tens of microseconds a span
where threads contend for the interpreter. PERF.md names each span and
counter with its metric.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import namedtuple
from contextlib import nullcontext

Record = namedtuple("Record", "name t0 t1 id parent job thread")

_on = False
_NULL = nullcontext()
_records: list = []
_counters: dict = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Span:
    __slots__ = ("name", "id", "up", "parent", "job", "t0", "t1", "_rf", "_lift")

    def __init__(self, name: str, lift: bool = False):
        self.name = name
        self._lift = lift

    def __enter__(self):
        from torch.autograd import _profiler_enabled
        from torch.autograd.profiler import record_function

        up = _current()
        if self._lift and up is not None:
            up = up.up
        self.up = up
        self.id = next(_ids)
        self.parent, self.job = (up.id, up.job) if up is not None else (None, self.id)
        _local.__dict__.setdefault("stack", []).append(self)
        self._rf = record_function(self.name) if _profiler_enabled() else None
        if self._rf is not None:
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        _records.append(Record(self.name, self.t0, self.t1, self.id, self.parent, self.job,
                               threading.current_thread().name))
        return False


def _current():
    stack = _local.__dict__.get("stack")
    return stack[-1] if stack else _local.__dict__.get("origin")


def enable(on: bool = True) -> None:
    """Turning spans on enters one record_function, so that its one-time op
    lookup (about a millisecond) falls here, not in a profiler's range."""
    global _on
    if on and not _on:
        from torch.autograd.profiler import record_function

        with record_function("hulk.spans.enable"):
            pass
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop the records and counters."""
    with _lock:
        _records.clear()
        _counters.clear()


def span(name: str):
    """A context manager: a span `name` while on, the shared null context
    while off."""
    if not _on:
        return _NULL
    return _Span(name)


def part(name: str):
    """A span `name` that lies within the thread's current span in time but
    hangs on that span's parent, so that the current span's self time still
    holds it: a part of a span's own work, timed on its own."""
    if not _on:
        return _NULL
    return _Span(name, lift=True)


def timed(name: str, fn) -> tuple[float, float]:
    """Call fn() and return its (start, end) on perf_counter, on or off;
    while on, the same pair is a span `name`."""
    if not _on:
        t0 = time.perf_counter()
        fn()
        return t0, time.perf_counter()
    with _Span(name) as s:
        fn()
    return s.t0, s.t1


def count(name: str, n: int = 1) -> None:
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def carry(fn):
    """fn, made to run under the caller's current span in whatever thread
    runs it (a thread's target, an executor's task); fn itself while off."""
    parent = _current() if _on else None
    if parent is None:
        return fn

    def run(*args, **kwargs):
        _local.origin = parent
        try:
            return fn(*args, **kwargs)
        finally:
            _local.origin = None

    return run


def records() -> list:
    return list(_records)


def counters() -> dict:
    with _lock:
        return dict(_counters)
