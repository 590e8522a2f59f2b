"""CPU tests of the benchmark harness at tiny sizes. Tests that need a card
carry the `gpu` marker and skip without one (decided in the `card`
fixture, never at import)."""
from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs hulk_tpu_torch on a CUDA card; skips without one")


@pytest.fixture(scope="session")
def caches(tmp_path_factory):
    """The program's and the reference's caches in a directory of the
    session's own."""
    from hulkbench import run
    from hulkbench.reference import cws

    root = tmp_path_factory.mktemp("hulkbench-cache")
    saved = run.CACHE, cws.CACHE_DIR
    run.CACHE, cws.CACHE_DIR = str(root), str(root / "reference")
    run.set_run_env()
    yield root
    run.CACHE, cws.CACHE_DIR = saved


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_cell(name: str) -> dict:
    """A BENCHMARK.json cell cut to a size the CPU runs in seconds: k=11
    (14,641 bins), w=5, s=8, thousands of reads, 1% of their bases N (so
    that hulk's N handling is held too)."""
    from hulkbench import run

    cell = run.load_cell(name)
    cfg = cell["config"]
    cfg.update(kmer_size=11, window_size=5, sketch_size=8, bins=11 ** 4)
    cfg["input"].update(genomes=5, genome_bp_min=20_000, genome_bp_max=60_000,
                        reads_per_file=3_000, chunk=1_000, threads=2, n_frac=0.01)
    if cell["traffic"]["interval"]:
        cell["traffic"]["interval"] = 1_000
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def workdir(tmp_path):
    d = tmp_path / "work"
    d.mkdir()
    return str(d)

