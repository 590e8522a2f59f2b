"""Nothing under hulkbench/ imports JAX or the JAX package (top-level
module names compared whole: hulk_tpu_torch begins with hulk_tpu), the
reference imports nothing of the program, no file reads the JAX package's
benchmark, and the harness refuses to run without a card."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from hulkbench.run import FORBIDDEN, HERE, ROOT


def _sources(sub: str = "") -> list[str]:
    out = []
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imported(path) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "hulk_tpu_torch" not in _imported(path), path


def test_no_file_reads_the_jax_benchmark():
    for path in _sources():
        if os.path.samefile(path, __file__):
            continue
        with open(path) as fh:
            text = fh.read()
        assert "bench.py" not in text.replace("hulkbench", "") and "BENCH_r" not in text, path


def test_a_dry_run_of_the_loader_loads_no_jax():
    """Every cell, configuration, generator and metric reader, and the
    reference, imported in a fresh process, which then holds none of the
    forbidden top-level modules."""
    code = """
import importlib, json, sys
from hulkbench.run import FORBIDDEN, ROOT, load_cell
import hulkbench.check, hulkbench.control, hulkbench.reference.sketch, hulkbench.reference.cws
bench = json.load(open(ROOT + "/BENCHMARK.json"))
for w in bench["workloads"]:
    cell = load_cell(w["name"])
    importlib.import_module("hulkbench.inputs." + cell["config"]["generator"])
for m in bench["per_layer"]:
    importlib.import_module("hulkbench.metrics." + m["name"])
import hulk_tpu_torch.cli, hulk_tpu_torch.stream.pipeline
found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
print("found", found)
sys.exit(1 if found else 0)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_without_a_card_the_harness_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = subprocess.run([sys.executable, "-m", "hulkbench", "--workload", "reads-k21.samples",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_with_the_benchmark_files_alone_the_harness_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and hulkbench/: no program."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "hulkbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = subprocess.run([sys.executable, "-m", "hulkbench", "--workload", "reads-k21.samples",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.gpu
def test_a_tiny_cell_runs_correct_on_the_card(card, caches, tiny, workdir):
    from hulkbench.run import run_cell

    res = run_cell(tiny("reads-k21.stream-drift"), 2**31 + 3, 0, True, device=card,
                   workdir=workdir)
    assert res["correct"], res
    assert res["device"]["busy_s"] > 0
