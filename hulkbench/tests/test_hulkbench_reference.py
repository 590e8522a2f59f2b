"""The plain reference against Go's known outputs (tests/golden,
tests/fixtures) and against the program's --device cpu output at tiny
sizes."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from hulkbench.reference import cws, sketch
from hulkbench.reference.fdlibm import go_exp, go_log
from hulkbench.reference.gorand import GoRand

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _h2f(h: str) -> float:
    return np.uint64(int(h, 16)).view(np.float64)


def test_go_exp_and_log_match_the_pinned_go_outputs():
    with open(os.path.join(REPO, "tests", "fixtures", "fdlibm_goldens.json")) as fh:
        goldens = json.load(fh)
    for name, fn in (("exp", go_exp), ("log", go_log)):
        rows = goldens[name]
        x = np.array([_h2f(r[0]) for r in rows])
        pinned = np.array([_h2f(r[2]) for r in rows])
        got = fn(x)
        same = (got.view(np.int64) == pinned.view(np.int64)) | (np.isnan(got) & np.isnan(pinned))
        assert same.all(), f"{name}: {int((~same).sum())} of {len(rows)} differ"


def test_go_rand_seed_one_stream():
    assert list(GoRand(1).int63_block(2)) == [5577006791947779410, 8674665223082153551]


def test_cws_tables_match_the_golden_corners(tmp_path):
    """s=42 over the k=21 spectrum (194,481 bins): the draws the benchmark's
    configurations use, corners and a few inner cells."""
    with open(os.path.join(REPO, "tests", "golden", "cws_corners.json")) as fh:
        corners = json.load(fh)
    t = cws.tables(42, 194481, cache_dir=str(tmp_path))
    again = cws.tables(42, 194481, cache_dir=str(tmp_path))  # from the cache
    for key, hexval in corners.items():
        name, i, j = key.split(":")
        if name == "r":
            continue
        want = float.fromhex(hexval)
        assert getattr(t, name)[int(i), int(j)] == want, key
        assert getattr(again, name)[int(i), int(j)] == want, key


def _sequential_cms(bins, freqs, rows, decay):
    q = np.zeros((sketch.CMS_DEPTH, sketch.CMS_WIDTH))
    out = []
    for b, f in zip(bins, freqs):
        if decay is not None:
            q *= decay
            q[q < sketch.TINY] = 0.0
        cols = rows[:, b]
        q[np.arange(sketch.CMS_DEPTH), cols] += f
        out.append(q[np.arange(sketch.CMS_DEPTH), cols].min())
    return np.array(out)


@pytest.mark.parametrize("decay", [None, float(go_exp(-0.9)), float(go_exp(-0.05))])
def test_cms_estimates_equal_the_sequential_loop(decay):
    """Narrow rows (many collisions, short gaps) and heavy counts, so the
    multiplied-out gaps and the rounds are exercised."""
    rng = np.random.default_rng(5)
    nbins = 3000
    rows = rng.integers(0, 40, size=(sketch.CMS_DEPTH, nbins))
    bins = np.concatenate([np.sort(rng.choice(nbins, 900, replace=False)) for _ in range(3)])
    freqs = rng.integers(1, 5000, size=bins.shape[0]).astype(np.float64)
    got = sketch.cms_estimates(bins, freqs, rows, decay)
    want = _sequential_cms(bins, freqs, rows, decay)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("drift", [True, False])
def test_selection_equals_the_sequential_rule(drift):
    """The slot rule over exact A, driven through approximate A a few ulps
    off (as NumPy's exp is from Go's) and exact values at the candidates;
    A of either sign, ties, and a falling sequence that picks at every
    element."""
    rng = np.random.default_rng(9)
    h = sketch.HistoSketch.__new__(sketch.HistoSketch)
    h.s, h.dtype, h.drift = 4, np.float64, drift
    h.decay = float(go_exp(-0.9)) if drift else None
    h.mins = np.zeros(4, dtype=np.uint64)
    h.weights = np.full(4, sketch.MAX_FLOAT64)
    n = 5000
    b = np.arange(n) * 3
    tied = np.log(rng.gamma(2.0, size=n))
    tied[[10, 400, 4000]] = tied.min() - 1.0
    exact = [np.log(rng.gamma(2.0, size=n)), np.linspace(5.0, 0.001, n),
             rng.gamma(0.3, size=n), tied]
    for j, a in enumerate(exact):
        approx = a * (1 + rng.uniform(-4e-15, 4e-15, size=n))
        h._select_slot(j, approx, lambda idx, a=a: a[idx], b, sketch.MARGIN)
        w, m = sketch.MAX_FLOAT64, 0
        with np.errstate(over="ignore"):
            for i in range(n):
                if a[i] < (w / h.decay if drift else w):
                    w, m = a[i], b[i]
        assert (h.mins[j], h.weights[j]) == (m, w)


def _port_documents(tmp, files, argv_extra):
    from hulk_tpu_torch.cli import main

    from hulkbench.check import job_documents
    from hulkbench.run import run_job

    out = os.path.join(tmp, "port")
    argv = ["sketch"] + sum([["-f", f] for f in files], []) + [
        "-k", "11", "-w", "5", "-s", "8", "-o", out, "--log", out + ".log",
        "--device", "cpu", *argv_extra]
    job = run_job(argv, out, 0)
    assert job.error is None, job.error
    del main
    return job_documents(out, "--stream" in argv_extra)


@pytest.mark.parametrize("kind", ["reads", "reads-interval-drift"])
def test_reference_equals_the_port_on_the_cpu(kind, caches, tmp_path, tiny):
    from hulkbench import check
    from hulkbench.run import flushes, reference

    cell = tiny("reads-k21.stream-drift" if "interval" in kind else "reads-k21.samples")
    cfg, traffic = cell["config"], cell["traffic"]
    gen = __import__(f"hulkbench.inputs.{cfg['generator']}", fromlist=["generate"])
    inputs = gen.generate(cfg["input"], 77, str(tmp_path))
    files = [inputs["files"][n] for n in traffic["inputs"]]
    extra = ["-i", str(traffic["interval"]), "-x", "0.9", "--stream"] if traffic["interval"] else []
    got = _port_documents(str(tmp_path), files, extra)
    hists, work = reference(cfg, traffic, inputs, "cpu")
    want = check.expected_documents(flushes(cfg, traffic, hists), traffic["stream"])
    assert len(got) == len(want)
    n = check.compare(got, want)
    assert n == {"docs_wrong": 0, "mins_mismatched": 0, "weights_mismatched": 0}
    assert work["bases"] == sum(inputs["bases"][k] for k in traffic["inputs"])
    assert work["iterations"] > work["keys"] > 0
