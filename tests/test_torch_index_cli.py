"""`index -r create / add / search`: hulk_tpu_torch.cli.main (--device cpu)
against hulk_tpu.cli.main on the same sketch JSONs: synth.sketch_jsons
(seeded) and tests/golden/. hulk_tpu searches through its 8-device CPU mesh
(sharded_lsh_search), the port on one device (forest.search), so the two
search paths are held to each other too. Tolerance: byte-identical index
files and search stdout, and the same error text."""
import os
import re
import shutil

import pytest

import hulk_tpu.cli as jax_cli
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch.synth import sketch_jsons

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CLIS = {"jax": jax_cli.main, "port": lambda argv: torch_cli.main([*argv, "--device", "cpu"])}


@pytest.fixture(scope="module")
def piles(tmp_path_factory):
    """Sketch directories: 200 synthetic sketches (s=42) in two halves, and
    the three golden sketches (s=50)."""
    root = tmp_path_factory.mktemp("index_piles")
    out = {}
    for name, n, seed in (("a", 120, 1), ("b", 80, 2)):
        d = root / name
        d.mkdir()
        sketch_jsons(str(d), n, s=42, families=12, seed=seed)
        out[name] = str(d)
    g = root / "golden"
    g.mkdir()
    for f in ("fixture-default.json", "part1.json", "part2.json"):
        shutil.copy(os.path.join(GOLDEN, f), g / f)
    out["golden"] = str(g)
    return out


def run(key, argv, tmp_path, capsys):
    """(stdout, log text) of one CLI run that must succeed."""
    log = str(tmp_path / f"{key}.log")
    capsys.readouterr()
    assert CLIS[key]([*argv, "--log", log]) == 0
    with open(log) as fh:
        return capsys.readouterr().out, fh.read()


def index_runs(tmp_path, capsys, steps):
    """Run `steps` (argv lists with {idx} for the index path) in both
    packages; return {key: (index bytes, [stdout of each step])}."""
    out = {}
    for key in CLIS:
        idx = str(tmp_path / f"{key}.idx")
        outs = [run(key, [a.format(idx=idx) for a in argv], tmp_path, capsys)[0]
                for argv in steps]
        with open(idx, "rb") as fh:
            out[key] = (fh.read(), outs)
    return out


@pytest.mark.parametrize("j", ["0.9", "0.5", "0.2"])
def test_create_and_search_synthetic(piles, tmp_path, capsys, j):
    steps = [["index", "-r", "create", "-n", "{idx}", "-d", piles["a"], "-s", "42", "-j", j],
             ["index", "-r", "search", "-n", "{idx}", "-d", piles["a"], "-s", "42", "-j", j],
             ["index", "-r", "search", "-n", "{idx}", "-d", piles["b"], "-s", "42", "-j", j]]
    got = index_runs(tmp_path, capsys, steps)
    assert got["port"] == got["jax"]
    lines = got["port"][1][1].splitlines()
    assert len(lines) >= 120  # every sketch finds itself at similarity 1
    assert all(re.fullmatch(r".+\.json,.+\.json,[01]\.\d{4}", ln) for ln in lines)


def test_create_add_search(piles, tmp_path, capsys):
    steps = [["index", "-r", "create", "-n", "{idx}", "-d", piles["a"], "-s", "42", "-j", "0.6"],
             ["index", "-r", "add", "-n", "{idx}", "-d", piles["b"], "-s", "42"],
             ["index", "-r", "search", "-n", "{idx}", "-d", piles["b"], "-s", "42", "-j", "0.6"]]
    got = index_runs(tmp_path, capsys, steps)
    assert got["port"] == got["jax"]
    assert got["port"][1][2].count("\n") >= 80


def test_golden_sketches(piles, tmp_path, capsys):
    steps = [["index", "-r", "create", "-n", "{idx}", "-d", piles["golden"], "-j", "0.5"],
             ["index", "-r", "search", "-n", "{idx}", "-d", piles["golden"], "-j", "0.9"]]
    got = index_runs(tmp_path, capsys, steps)
    assert got["port"] == got["jax"]
    assert got["port"][1][1].count(",1.0000\n") == 3


def test_index_in_sketch_dir_is_skipped(piles, tmp_path, capsys):
    """The index file inside the sketch directory is neither indexed nor
    searched (it is not a sketch and would fail to load as one)."""
    outs = {}
    for key in CLIS:
        d = tmp_path / key
        shutil.copytree(piles["golden"], d)
        idx = str(d / "my.idx.json")
        run(key, ["index", "-r", "create", "-n", idx, "-d", str(d)], tmp_path, capsys)
        run(key, ["index", "-r", "add", "-n", idx, "-d", str(d)], tmp_path, capsys)
        out, _ = run(key, ["index", "-r", "search", "-n", idx, "-d", str(d)], tmp_path, capsys)
        with open(idx, "rb") as fh:
            outs[key] = (fh.read().replace(str(d).encode(), b"D"), out.replace(str(d), "D"))
    assert outs["port"] == outs["jax"]
    assert b"my.idx" not in outs["port"][0] and "my.idx" not in outs["port"][1]
    assert outs["port"][1].count("\n") == 3 * 2  # each sketch twice in the index


@pytest.mark.parametrize("case", ["create_size", "search_index_size", "search_query_size",
                                  "unknown_op", "missing_index", "no_sketches"])
def test_errors(piles, tmp_path, capsys, case):
    """The same error, in the same words, from both packages (exit code 1)."""
    argv = {
        "create_size": ["-r", "create", "-d", piles["a"], "-s", "40"],
        "search_index_size": ["-r", "search", "-d", piles["a"], "-s", "50"],
        "search_query_size": ["-r", "search", "-d", piles["golden"], "-s", "42"],
        "unknown_op": ["-r", "delete", "-d", piles["a"]],
        "missing_index": ["-r", "search", "-d", piles["a"], "-s", "42"],
        "no_sketches": ["-r", "create", "-d", str(tmp_path / "empty"), "-s", "42"],
    }[case]
    (tmp_path / "empty").mkdir()
    errors = {}
    for key, main in CLIS.items():
        idx = str(tmp_path / f"{key}.idx")
        if case.startswith("search_"):
            run(key, ["index", "-r", "create", "-n", idx, "-d", piles["a"], "-s", "42"],
                tmp_path, capsys)
        log = str(tmp_path / f"{key}_err.log")
        with pytest.raises(SystemExit) as e:
            main(["index", *argv, "-n", idx, "--log", log])
        assert e.value.code == 1
        with open(log) as fh:
            errors[key] = fh.read().split("ERROR---> ")[-1].replace(idx, "IDX")
    assert errors["port"] == errors["jax"]
    assert errors["port"].strip()
