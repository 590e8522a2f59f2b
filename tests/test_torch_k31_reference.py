"""The port's two-sort step against the benchmark's plain reference
(hulkbench/reference), at k where read ids no longer pack above the value
bits: k = 23, where the step first becomes two-sort (279,841 bins), and
k = 31, hulk's largest k (923,521 bins), where hash64 << 8 wraps past 64
bits, values pass 2^63 and equal neighbours from different reads are
counted. `sketch --device cpu` (the plain versions) must write, document
for document, the reference's histosketch: mins and float64 weights bit for
bit. At k = 23 a group of at most 1,024 rows, as the stream case's
1,000-read intervals make, still packs its read ids into the top bit and
takes the fused step; every other group here takes the two-sort step. Also
the counter `stream.two_sort_batches`, which only the two-sort step counts.

Tiny inputs (hulkbench/tests/conftest.py tiny_cell, with k kept): w=5, s=8,
3,000 reads a file, 1% N."""
from __future__ import annotations

import functools
import importlib
import os

import pytest

from hulkbench import check
from hulkbench.reference import cws
from hulkbench.run import flushes, job_argv, reference, run_job
from hulkbench.tests.conftest import tiny_cell
from hulk_tpu_torch import spans

CELLS = {"sample": "reads-k31.samples", "stream": "reads-k21.stream-drift"}


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The reference's CWS tables and the port's in a directory of this
    module's own: built once for each (s, bins), never in the checkout."""
    root = tmp_path_factory.mktemp("k31-cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cws, "tables", functools.partial(cws.tables, cache_dir=str(root / "reference")))
        mp.setenv("HULK_TPU_TORCH_CACHE", str(root / "program"))
        yield root


def _cell(kind: str, k: int) -> dict:
    cell = tiny_cell(CELLS[kind])
    cell["config"].update(kmer_size=k, bins=k ** 4)
    return cell


def _inputs(cell: dict, seed: int, where) -> dict:
    gen = importlib.import_module(f"hulkbench.inputs.{cell['config']['generator']}")
    return gen.generate(cell["config"]["input"], seed, str(where))


@pytest.mark.parametrize("kind", ["sample", "stream"])
@pytest.mark.parametrize("k", [23, 31])
def test_the_two_sort_step_equals_the_reference(k, kind, caches, tmp_path):
    cell = _cell(kind, k)
    cfg, traffic = cell["config"], cell["traffic"]
    inputs = _inputs(cell, 1800 + k, tmp_path)
    out = str(tmp_path / "port")
    argv = job_argv(cfg, traffic, [inputs["files"][n] for n in traffic["inputs"]], out, "cpu")
    if kind == "stream":
        assert argv[-5:] == ["-i", "1000", "-x", "0.9", "--stream"]
    job = run_job(argv, out, 0)
    assert job.error is None, job.error
    got = check.job_documents(out, traffic["stream"])

    hists, work = reference(cfg, traffic, inputs, "cpu")
    want = check.expected_documents(flushes(cfg, traffic, hists), traffic["stream"])
    assert len(got) == len(want) == (8 if kind == "stream" else 1)
    assert check.compare(got, want) == {"docs_wrong": 0, "mins_mismatched": 0,
                                        "weights_mismatched": 0}
    assert work["iterations"] > work["keys"] > 0


@pytest.mark.parametrize("k", [21, 31])
def test_only_the_two_sort_step_counts_its_batches(k, caches, tmp_path):
    """At k = 31 every batch takes the two-sort step, so the counter equals
    `stream.batches`; at k = 21 every batch takes the fused step and the
    counter is never touched."""
    cell = _cell("sample", k)
    inputs = _inputs(cell, 1900 + k, tmp_path)
    out = str(tmp_path / "port")
    argv = job_argv(cell["config"], cell["traffic"],
                    [inputs["files"][n] for n in cell["traffic"]["inputs"]], out, "cpu")
    spans.enable(True)
    spans.reset()
    try:
        job = run_job(argv, out, 0)
        counts = spans.counters()
    finally:
        spans.enable(False)
        spans.reset()
    assert job.error is None, job.error
    assert os.path.exists(out + ".json")
    assert counts["stream.batches"] >= 2
    if k == 31:
        assert counts["stream.two_sort_batches"] == counts["stream.batches"]
    else:
        assert not counts.get("stream.two_sort_batches")


def test_the_float32_control_fails_at_k31(caches, tmp_path):
    """The comparison is tight enough: the reference's weighted sampling in
    float32, the step below the configuration's float64, put in the port's
    place, comes out not correct at k = 31 too."""
    from hulkbench.control import readings

    checks = readings(_cell("sample", 31), 2**31 + 31, "cpu", str(tmp_path))
    assert checks["weights_mismatched"]["value"] > checks["weights_mismatched"]["limit"]
