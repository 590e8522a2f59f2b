"""`smash`, `print` and `distance`: hulk_tpu.cli.main against
hulk_tpu_torch.cli.main (--device cpu: the blocked matrix in plain PyTorch
on the CPU) on the same seed-made sketch JSONs (synth.sketch_jsons).

Up to 64 sketches both take the host path; past 64 both take their device
matrix (hulk_tpu's on its CPU backend, over its 8 test devices). Tolerance:
byte-identical CSV, banner matrix and stdout. Where hulk_tpu's two paths
disagree (jaccard on u64 mins that differ below f64's 53 bits), the port is
held to the host path's get_distance, the Go reference's arithmetic.
"""
import csv
import io
import json
import os
import shutil

import numpy as np
import pytest

import hulk_tpu.cli as jax_cli
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu.io.sketchio import load_hulk_data as jax_load
from hulk_tpu_torch.hashes.cws import CWSTables
from hulk_tpu_torch.io.sketchio import HULKData
from hulk_tpu_torch.ops import distance
from hulk_tpu_torch.sketch.histosketch import HistoSketch
from hulk_tpu_torch.sketch.minhash import KMVSketch
from hulk_tpu_torch.synth import sketch_jsons


@pytest.fixture(scope="module")
def piles(tmp_path_factory):
    """Two piles of sketches: 48 (host path) and 200 (device path)."""
    out = {}
    for n in (48, 200):
        d = tmp_path_factory.mktemp(f"pile{n}")
        sketch_jsons(str(d), n, s=16, families=6, seed=n)
        out[n] = str(d)
    return out


def _smash(main, pile, out, *flags):
    assert main(["smash", "-d", pile, "-o", out, *flags]) == 0
    with open(out + ".hulk-matrix.csv", "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("n", [48, 200])
@pytest.mark.parametrize("metric,algo", [("weightedjaccard", "histosketch"),
                                         ("jaccard", "histosketch"), ("jaccard", "kmv"),
                                         ("jaccard", "khf")])
def test_smash_csv_byte_identical(piles, tmp_path, n, metric, algo):
    flags = ["-m", metric, "-a", algo, "--bannerMatrix"]
    want = _smash(jax_cli.main, piles[n], str(tmp_path / "jax"), *flags)
    got = _smash(torch_cli.main, piles[n], str(tmp_path / "port"), *flags, "--device", "cpu")
    assert got == want
    rows = list(csv.reader(io.StringIO(got.decode())))
    assert len(rows) == n + 1 and all(len(r) == n for r in rows)
    cells = np.array(rows[1:], dtype=np.float64)
    assert (np.diag(cells) == 100).all() and cells.min() < 50 < cells.max() - 1
    banner = [(tmp_path / f"{p}.banner-matrix.csv").read_bytes() for p in ("port", "jax")]
    assert banner[0] == banner[1]


def _host_csv(pile: str, metric: str, algo: str) -> bytes:
    """hulk_tpu's host path (its CLI up to 64 sketches) for any number of
    sketches: get_distance for every cell."""
    names = sorted(os.path.join(pile, f) for f in os.listdir(pile) if f.endswith(".json"))
    data = {f: jax_load(f) for f in names}
    buf = io.StringIO()
    wr = csv.writer(buf, lineterminator="\n")
    wr.writerow(names)
    for a in names:
        wr.writerow([f"{100 - data[a].get_distance(data[b], metric, 21, algo) * 100:.2f}"
                     for b in names])
    return buf.getvalue().encode()


def _write(pile: str, i: int, objs) -> None:
    data = HULKData(filename=f"s{i}", banner="b")
    for o in objs:
        data.add(o)
    data.write_json(os.path.join(pile, f"s{i:03d}.json"))


def test_jaccard_past_64_follows_host_path(tmp_path):
    """KMV values above 2^53 that differ only in their low bits: the host
    path (and Go) compare them after the f64 cast and count them equal;
    hulk_tpu's device matrix compares exact integers and does not. The
    port's device matrix gives the host path's CSV."""
    pile = str(tmp_path / "pile")
    os.mkdir(pile)
    rng = np.random.default_rng(9)
    base = np.sort(rng.integers(1 << 60, 1 << 63, 8, dtype=np.uint64))
    for i in range(70):
        kmv = KMVSketch(21, 8)
        kmv._values = base + np.uint64(i % 5)  # same f64, different u64
        if i % 7 == 0:
            kmv._values = np.sort(rng.integers(1 << 60, 1 << 63, 8, dtype=np.uint64))
        _write(pile, i, [kmv])
    flags = ["-m", "jaccard", "-a", "kmv"]
    host = _host_csv(pile, "jaccard", "kmv")
    ref_device = _smash(jax_cli.main, pile, str(tmp_path / "jax"), *flags)
    got = _smash(torch_cli.main, pile, str(tmp_path / "port"), *flags, "--device", "cpu")
    assert ref_device != host  # hulk_tpu's two paths disagree here
    assert got == host


def test_boundary_cells_rechecked(tmp_path, monkeypatch):
    """Weights that put every off-diagonal cell on a %.2f rounding edge
    (similarity 12.345): each such cell is recomputed by the host path, and
    the CSV is the host path's and hulk_tpu's."""
    pile = str(tmp_path / "pile")
    os.mkdir(pile)
    rng = np.random.default_rng(4)
    no_tables = CWSTables(*(np.empty((0, 0)),) * 4)
    w = np.array([0.12345, 0.17655, 0.1, 0.1, 0.1, 0.1, 0.1, 0.2])
    for i in range(70):
        hs = HistoSketch(21, 8, 21 ** 4, 1.0, tables=no_tables)
        hs.sketch = np.concatenate([[0], rng.integers(1, 21 ** 4, 7)]).astype(np.uint64)
        hs.sketch_weights = w.copy()
        _write(pile, i, [hs])
    monkeypatch.setitem(distance.recheck_stats, "cells", 0)
    flags = ["-m", "weightedjaccard"]
    got = _smash(torch_cli.main, pile, str(tmp_path / "port"), *flags, "--device", "cpu")
    assert distance.recheck_stats["cells"] >= 70 * 69
    assert got == _host_csv(pile, "weightedjaccard", "histosketch")
    assert got == _smash(jax_cli.main, pile, str(tmp_path / "jax"), *flags)
    assert b"12.3" in got


def test_device_matrix_equals_host_arithmetic(piles):
    """Past the CSV: the weighted tile equals get_wjd cell for cell, bit for
    bit, and the margin bounds a reassociated sum's error."""
    from hulk_tpu_torch.io.sketchio import _weights_of, load_hulk_data
    from hulk_tpu_torch.sketch.distances import get_wjd

    names = sorted(os.listdir(piles[48]))[:20]
    objs = [load_hulk_data(os.path.join(piles[48], f)).find_sketch(21, "histosketch")
            for f in names]
    mins = np.stack([o.get_sketch() for o in objs])
    weights = np.stack([_weights_of(o) for o in objs])
    d = distance.pairwise_weighted_jaccard_dist(mins, weights, block=7, col_block=6,
                                                device="cpu")
    want = np.array([[get_wjd(mins[i].astype(np.float64), mins[j].astype(np.float64),
                              weights[i], weights[i]) for j in range(20)] for i in range(20)])
    assert np.array_equal(d.view(np.uint64), want.view(np.uint64))
    wn = np.abs(weights) / np.abs(weights).sum(1, keepdims=True)
    reassoc = 1.0 - np.array([[wn[i][::-1][(mins[i] == mins[j])[::-1]].sum()
                               for j in range(20)] for i in range(20)])
    assert np.abs(reassoc - want).max() <= distance.wjd_recheck_margin(16)
    sim = distance.pairwise_jaccard_sim(mins, block=3, col_block=8, device="cpu")
    assert np.array_equal(sim, (mins[:, None, :] == mins[None, :, :]).sum(-1) / 16)


def test_hyperminhash_takes_host_path(tmp_path, monkeypatch):
    """Past 64 sketches too, hyperminhash is compared on the host (its
    estimator is no positional match). Empty sketches keep the host's
    estimator fast."""
    from hulk_tpu_torch.sketch.hyperminhash import HyperMinHash

    pile = str(tmp_path / "pile")
    os.mkdir(pile)
    for i in range(66):
        _write(pile, i, [HyperMinHash(21)])

    def refuse(*a, **k):
        raise AssertionError("the device matrix ran for hyperminhash")

    monkeypatch.setattr(distance, "pairwise_jaccard_sim", refuse)
    monkeypatch.setattr(distance, "pairwise_weighted_jaccard_dist", refuse)
    flags = ["-a", "hyperminhash"]
    want = _smash(jax_cli.main, pile, str(tmp_path / "jax"), *flags)
    assert _smash(torch_cli.main, pile, str(tmp_path / "port"), *flags,
                  "--device", "cpu") == want


def test_device_failure_is_an_error(piles, tmp_path, monkeypatch):
    """No fallback hides the device: no card, or a failure in the matrix,
    ends the run with an error."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["smash", "-d", piles[200], "-o", str(tmp_path / "x")])
    assert e.value.code == 1

    def broken(*a, **k):
        raise RuntimeError("device matrix failed")

    monkeypatch.setattr(distance, "pairwise_weighted_jaccard_dist", broken)
    with pytest.raises(RuntimeError, match="device matrix failed"):
        torch_cli.main(["smash", "-d", piles[200], "-m", "weightedjaccard", "-o",
                        str(tmp_path / "y"), "--device", "cpu"])


@pytest.mark.parametrize("sub,flags", [
    ("print", ["-a", "histosketch"]), ("print", ["-a", "kmv"]),
    ("distance", ["-m", "weightedjaccard"]), ("distance", ["-m", "jaccard", "-a", "khf"]),
])
def test_print_and_distance_stdout(piles, capsys, sub, flags):
    names = sorted(os.listdir(piles[48]))
    files = [a for f in names[:2] for a in ("-f", os.path.join(piles[48], f))]
    assert jax_cli.main([sub, *files, *flags]) == 0
    want = capsys.readouterr().out
    assert torch_cli.main([sub, *files, *flags]) == 0
    assert capsys.readouterr().out == want
    assert want.count("\n") == (2 if sub == "print" else 1)


@pytest.mark.parametrize("sub", ["sketch", "smash"])
def test_profiling_writes_trace(piles, tmp_path, monkeypatch, sub):
    """--profiling writes a torch.profiler trace (Chrome JSON) under the
    working directory's hulk-profile/."""
    from hulk_tpu_torch.synth import generate

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    if sub == "sketch":
        reads = generate(str(tmp_path / "r.fq.gz"), 400, seed=2)
        args = ["sketch", "-f", reads, "-k", "11", "-w", "5", "-s", "8"]
    else:
        args = ["smash", "-d", piles[200], "-m", "weightedjaccard"]
    assert torch_cli.main([*args, "-o", str(tmp_path / "out"), "--profiling",
                           "--device", "cpu"]) == 0
    traces = [f for f in os.listdir(tmp_path / "hulk-profile") if f.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / "hulk-profile" / traces[0]) as fh:
        assert json.load(fh)["traceEvents"]


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("metric,prefix", [("weightedjaccard", "wj"), ("jaccard", "jac")])
def test_smash_matches_pinned_golden(metric, prefix, tmp_path, monkeypatch):
    """BASELINE config 2: `smash` of the three pinned sketches in
    tests/golden, byte-equal to the pinned CSV (no /root/reference)."""
    import shutil

    for f in ("fixture-default.json", "part1.json", "part2.json"):
        shutil.copy(os.path.join(GOLDEN, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    assert torch_cli.main(["smash", "-d", ".", "-m", metric, "-o", prefix,
                           "--device", "cpu"]) == 0
    with open(os.path.join(GOLDEN, f"{prefix}.hulk-matrix.csv"), "rb") as fh:
        assert (tmp_path / f"{prefix}.hulk-matrix.csv").read_bytes() == fh.read()
