"""The `-p 8` deployment (cell reads-k21.samples-p8) against the benchmark's
plain reference (hulkbench/reference): `sketch --device cpu` at -p 8,
clamped to this host's CPUs as hulk clamps it, writes the reference's
histosketch, mins and float64 weights bit for bit, and the same out.json
bytes as at -p 1. The files are sized so that the parse takes the parallel
route (chunks of NativeFastqPacker.PAR_MIN_BYTES or more), and every
parallel parse runs with the team -p gives.

Tiny inputs (hulkbench/tests/conftest.py tiny_cell): k=11, w=5, s=8, 1% N,
12,000 reads a file in members of 1,000 (about 4 MB a file inflated)."""
from __future__ import annotations

import functools
import gzip
import importlib
import os

import pytest

from hulk_tpu_torch import spans
from hulk_tpu_torch.native import NativeFastqPacker
from hulkbench import check
from hulkbench.reference import cws
from hulkbench.run import flushes, job_argv, reference, run_job
from hulkbench.tests.conftest import tiny_cell


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("p8-cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cws, "tables", functools.partial(cws.tables, cache_dir=str(root / "reference")))
        mp.setenv("HULK_TPU_TORCH_CACHE", str(root / "program"))
        yield root


def _sketch(cfg, traffic, inputs, out):
    argv = job_argv(cfg, traffic, [inputs["files"][n] for n in traffic["inputs"]], out, "cpu")
    spans.enable(True)
    spans.reset()
    try:
        job = run_job(argv, out, 0)
        counts = spans.counters()
    finally:
        spans.enable(False)
        spans.reset()
    assert job.error is None, job.error
    with open(out + ".json", "rb") as fh:
        return fh.read(), counts


def test_the_p8_deployment_equals_the_reference_and_p1(caches, tmp_path):
    cell = tiny_cell("reads-k21.samples-p8")
    cfg, traffic = cell["config"], cell["traffic"]
    assert cfg["processors"] == 8 and traffic["interval"] == 0
    cfg["input"]["reads_per_file"] = 12_000
    gen = importlib.import_module(f"hulkbench.inputs.{cfg['generator']}")
    inputs = gen.generate(cfg["input"], 2300, str(tmp_path))
    for n in traffic["inputs"]:
        with open(inputs["files"][n], "rb") as fh:
            assert len(gzip.decompress(fh.read())) >= 2 * NativeFastqPacker.PAR_MIN_BYTES

    p8, counts = _sketch(cfg, traffic, inputs, str(tmp_path / "p8"))
    calls = counts.get("input.parse_par_calls", 0)
    assert calls > 0
    assert counts["input.parse_team_threads"] == calls * min(8, os.cpu_count() or 1)

    p1, _ = _sketch(dict(cfg, processors=1), traffic, inputs, str(tmp_path / "p1"))
    assert p8 == p1

    got = check.job_documents(str(tmp_path / "p8"), traffic["stream"])
    hists, work = reference(cfg, traffic, inputs, "cpu")
    want = check.expected_documents(flushes(cfg, traffic, hists), traffic["stream"])
    assert len(got) == len(want) == 1
    assert check.compare(got, want) == {"docs_wrong": 0, "mins_mismatched": 0,
                                        "weights_mismatched": 0}
    assert work["bases"] > 0


def test_the_p8_deployment_inflates_its_members_on_threads(caches, tmp_path, monkeypatch):
    """The same files written as members of 500 reads (24 a file), with
    512 kB inflate steps so that a tiny file holds many: at -p 8 the members
    after each file's first step inflate as tasks on up to 8 threads, every
    task from a guessed start chained (no miss), and out.json is -p 1's
    bytes and the reference's mins and float64 weights bit for bit; at -p 1
    none of the route's counters is written."""
    from hulk_tpu_torch.stream import fastq

    cell = tiny_cell("reads-k21.samples-p8")
    cfg, traffic = cell["config"], cell["traffic"]
    cfg["input"].update(reads_per_file=12_000, chunk=500)
    gen = importlib.import_module(f"hulkbench.inputs.{cfg['generator']}")
    inputs = gen.generate(cfg["input"], 2 ** 31 + 2301, str(tmp_path))
    monkeypatch.setattr(fastq, "_INFLATE_STEP", 512 << 10)
    route = ("input.inflate_tasks", "input.inflate_ahead_bytes", "input.inflate_ahead_misses")

    p8, counts = _sketch(cfg, traffic, inputs, str(tmp_path / "p8"))
    if min(8, os.cpu_count() or 1) > 1:
        assert counts["input.inflate_tasks"] > 0
        assert 0 < counts["input.inflate_ahead_bytes"] < counts["input.inflate_member_bytes"]
        assert "input.inflate_ahead_misses" not in counts
    p1, counts1 = _sketch(dict(cfg, processors=1), traffic, inputs, str(tmp_path / "p1"))
    assert not set(route) & set(counts1)
    assert counts1["input.inflate_member_bytes"] == counts["input.inflate_member_bytes"]
    assert p8 == p1

    got = check.job_documents(str(tmp_path / "p8"), traffic["stream"])
    hists, _ = reference(cfg, traffic, inputs, "cpu")
    want = check.expected_documents(flushes(cfg, traffic, hists), traffic["stream"])
    assert check.compare(got, want) == {"docs_wrong": 0, "mins_mismatched": 0,
                                        "weights_mismatched": 0}
