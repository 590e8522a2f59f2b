"""Per-layer readers on a canned trace, and every cell and metric of
BENCHMARK.json loaded by name."""
from __future__ import annotations

import importlib
import json
import os

import pytest

from hulkbench import peaks, trace
from hulkbench.run import ROOT, Context, Job, load_cell

CANNED = {
    "window": [10.0, 20.0],
    "device_ops": [
        ["void (anonymous namespace)::minimizer_window_kernel<true>(...)", 9.5, 10.5],
        ["jump_kernel<0>", 12.0, 12.5],
        ["minimizer_record_kernel", 12.25, 13.0],
        ["Memcpy HtoD (Pinned -> Device)", 19.5, 21.0],
    ],
    "host_ops": [["aten::sort", 13.0, 15.0], ["aten::copy_", 16.0, 16.5]],
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_and_metric_loads_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        importlib.import_module(f"hulkbench.inputs.{cell['config']['generator']}")
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "sketch_Mbp_per_s"}
        assert cell["per_layer"], w["name"]
    for m in bench["per_layer"]:
        mod = importlib.import_module(f"hulkbench.metrics.{m['name']}")
        assert callable(mod.read)


def test_busy_union_idle_and_kernel_time():
    assert trace.busy_seconds(CANNED) == pytest.approx(0.5 + 1.0 + 0.5)
    assert trace.kernel_seconds(CANNED, ("minimizer_window_kernel", "minimizer_record_kernel")) \
        == pytest.approx(0.5 + 0.75)
    assert trace.kernel_seconds(CANNED, ("jump_kernel",)) == pytest.approx(0.5)
    ctx = Context(config={}, job_paths=[], trace=CANNED)
    idle = importlib.import_module("hulkbench.metrics.device.idle_pct")
    assert idle.read(ctx) == pytest.approx(80.0)
    assert idle.read(Context(config={}, job_paths=[])) is None


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(CANNED)
    assert b["device_ops"][0] == ["minimizer_record_kernel", pytest.approx(0.75)]
    gaps = dict((round(s, 6), n) for n, s in b["idle_gaps"])
    assert gaps[6.5] == "aten::sort"  # 13.0-19.5
    assert gaps[1.5].startswith("no torch op")  # 10.5-12.0
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_rooflines_count_from_the_input():
    ctx = Context(config={"bins": 1000}, job_paths=[], trace=CANNED,
                  jobs=[Job("a", 0, 1, 0, 0.5), Job("b", 1, 2, 0, 0.5)],
                  work={"bases": 10**9, "keys": 10**8, "iterations": 12 * 10**8, "flushes": 1})
    mini = importlib.import_module("hulkbench.metrics.kernels.minimizer_roofline")
    least = max((3 / 8 * 2e9 + 8 * 2e8) / peaks.HBM_BYTES_PER_S,
                80 * 2e9 / peaks.INT32_OPS_PER_S)
    assert mini.read(ctx) == pytest.approx(100 * least / 1.25)
    binning = importlib.import_module("hulkbench.metrics.kernels.binning_roofline")
    least = max((8 * 2e8 + 4 * 1000 * 2) / peaks.HBM_BYTES_PER_S,
                2 * 24e8 / peaks.FP64_OPS_PER_S)
    assert binning.read(ctx) == pytest.approx(100 * least / 0.5)
    empty = dict(CANNED, device_ops=[])
    assert mini.read(Context(config={}, job_paths=[], trace=empty)) is None


def test_flush_wait_share_reads_the_program_counter():
    from hulk_tpu_torch.stream.pipeline import flush_stats

    waits = importlib.import_module("hulkbench.metrics.stream.flush_wait_pct")
    ctx = Context(config={}, job_paths=[], window_s=4.0)
    flush_stats["flush_waits"].append(9.0)
    waits.start(ctx)
    assert waits.read(ctx) is None
    flush_stats["flush_waits"].extend([0.5, 1.5])
    assert waits.read(ctx) == pytest.approx(50.0)
    flush_stats["flush_waits"].clear()


def test_read_chrome_keeps_the_window_device_and_host_ops(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "hulkbench.window", "ts": 1e6, "dur": 2e6},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "hulkbench.window", "ts": 0, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "jump_kernel", "ts": 1.5e6, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 1.6e6, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 1.2e6, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.read_chrome(str(path))
    assert t["window"] == [1.0, 3.0]
    assert [op[0] for op in t["device_ops"]] == ["jump_kernel", "Memcpy"]
    assert t["host_ops"][0][0] == "aten::sort"
