"""The four readers of reads-k31.samples on canned counters, spans and
trace events: the two-sort share of the batches, the stream thread's step
rate, the sorts' share of the card's busy time and the values binning's
roofline. Each reads nothing where the program or the trace has nothing
for it: no counter, no `stream.step` span, no sort kernel, no values-mode
launch."""
from __future__ import annotations

import dataclasses
import importlib

import pytest

from hulk_tpu_torch.spans import Record
from hulkbench import peaks, spans
from hulkbench.run import Context, Job

# kernel names as torch.profiler's trace gives them on the card
ROW_SORT = ("void at::native::radixSortKVInPlace<2, -1, 32, 32, long, long, unsigned int>"
            "(at::cuda::detail::TensorInfo<long, unsigned int>, ...)")
FLAT_SORT = ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::"
             "DeviceRadixSortPolicy<long, at::cuda::cub::detail::OpaqueType<8>, "
             "unsigned long long>::Policy900, false, ...>(...)")
VALUES = ("void (anonymous namespace)::jump_kernel<((anonymous namespace)::Mode)2, false>"
          "(unsigned long long const*, long long, int, unsigned long long, int*, "
          "unsigned long long*)")
KEYS = ("void (anonymous namespace)::jump_kernel<((anonymous namespace)::Mode)1, false>"
        "(unsigned long long const*, long long, int, unsigned long long, int*, "
        "unsigned long long*)")
MINIMIZER = "void (anonymous namespace)::minimizer_window_kernel<true>(...)"
FILL = "at::native::(anonymous namespace)::fill_reverse_indices_kernel(long*, int, ...)"

# the window is [10, 20]; busy 10-12 (sorts 10-11.5; the sort's index fill,
# not a sort, 11.5-11.75; minimizer 11-12), 13-14 (values 13-13.5, keys
# 13.5-14) and 19-20 (a copy that straddles the end)
TRACE = {
    "window": [10.0, 20.0],
    "device_ops": [
        [ROW_SORT, 10.0, 11.0],
        [FLAT_SORT, 10.5, 11.5],  # overlaps the row sort: counted once
        [FILL, 11.5, 11.75],
        [MINIMIZER, 11.0, 12.0],
        [VALUES, 13.0, 13.5],
        [KEYS, 13.5, 14.0],
        ["Memcpy HtoD (Pinned -> Device)", 19.0, 21.0],
        [FLAT_SORT, 9.0, 9.5],  # before the window
    ],
    "host_ops": [],
}


def _reader(name):
    return importlib.import_module(f"hulkbench.metrics.{name}")


@pytest.fixture
def ctx():
    return Context(config={"bins": 923521}, job_paths=[], window_s=10.0,
                   jobs=[Job("a", 10.0, 15.0, 0, 0.0), Job("b", 15.0, 20.0, 0, 0.0)],
                   work={"bases": 10**9, "keys": 2 * 10**8, "iterations": 3 * 10**9,
                         "flushes": 1},
                   trace=TRACE)


@pytest.mark.parametrize("counts,want", [
    ({"stream.batches": 4883, "stream.two_sort_batches": 4883}, 100.0),
    ({"stream.batches": 10, "stream.two_sort_batches": 4}, 40.0),
    ({"stream.batches": 10, "stream.two_sort_batches": 0}, 0.0),
    ({"stream.batches": 610}, None),  # a program without the counter
    ({"stream.two_sort_batches": 3}, None),
    ({}, None),
])
def test_the_two_sort_share_on_canned_counters(ctx, monkeypatch, counts, want):
    monkeypatch.setattr(spans, "counters", lambda: dict(counts))
    got = _reader("stream.two_sort_batch_pct").read(ctx)
    assert got == (pytest.approx(want) if want is not None else None)


def _step(t0, t1, id):
    return Record("stream.step", t0, t1, id, 1, 1, "MainThread")


@pytest.mark.parametrize("recs,want", [
    # 2 s of steps inside the window (one straddles its start, one its end)
    ([_step(9.5, 10.5, 2), _step(12.0, 13.0, 3), _step(19.5, 20.5, 4),
      Record("stream.pack", 11.0, 12.0, 5, 1, 1, "MainThread")], 2 * 10**9 / 2.0 / 1e6),
    ([Record("stream.pack", 11.0, 12.0, 5, 1, 1, "MainThread")], None),  # no step span
    ([_step(5.0, 6.0, 2)], None),  # none in the window
    ([], None),  # spans off, or a program without them
])
def test_the_step_rate_on_canned_spans(ctx, monkeypatch, recs, want):
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    got = _reader("stream.step_Mbp_per_s").read(ctx)
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_sort_share_is_the_union_of_sorts_over_the_busy_union(ctx):
    # sorts 10-11.5 (1.5 s) over busy 10-12, 13-14, 19-20 (4 s)
    assert _reader("device.sort_pct").read(ctx) == pytest.approx(100.0 * 1.5 / 4.0)


@pytest.mark.parametrize("trace", [
    None,
    {"window": None, "device_ops": [], "host_ops": []},
    dict(TRACE, device_ops=[op for op in TRACE["device_ops"] if "Sort" not in op[0]]),
])
def test_the_sort_share_reads_nothing_without_a_sort(ctx, trace):
    assert _reader("device.sort_pct").read(dataclasses.replace(ctx, trace=trace)) is None


def test_the_values_roofline_counts_as_the_binning_roofline_over_the_values_kernel(ctx):
    """The accepted reader's count (8 B a key, the histogram once a flush,
    two FP64 operations an iteration, for each job) over the values-mode
    launches' 0.5 s alone, not the keys mode's."""
    jobs = len(ctx.jobs)
    least = peaks.least_seconds((8 * 2 * 10**8 + 4 * 923521) * jobs, 2 * 3 * 10**9 * jobs,
                                peaks.FP64_OPS_PER_S)
    got = _reader("kernels.values_binning_roofline").read(ctx)
    assert got == pytest.approx(100.0 * least / 0.5)
    assert 0 < got < 100
    both = _reader("kernels.binning_roofline").read(ctx)  # values and keys: 1 s
    assert both == pytest.approx(got / 2)


@pytest.mark.parametrize("trace", [
    None,
    {"window": None, "device_ops": [], "host_ops": []},
    dict(TRACE, device_ops=[op for op in TRACE["device_ops"] if op[0] != VALUES]),
])
def test_the_values_roofline_reads_nothing_without_a_values_launch(ctx, trace):
    got = _reader("kernels.values_binning_roofline").read(dataclasses.replace(ctx, trace=trace))
    assert got is None
