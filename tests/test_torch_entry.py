"""The port's driver entry points (hulk_tpu_torch/entry.py) and their step
(ops/device_step.py sketch_accumulate_step) against __graft_entry__.py and
hulk_tpu's functions, on the CPU.

entry()'s fn runs on the same numpy-seeded [64, 128] batch in both
packages; dryrun_multichip(n, devices=[cpu] * n) for n = 1, 2, 8 against
the same steps built from hulk_tpu's functions on n of its virtual CPU
devices (tests/conftest.py), and against what __graft_entry__'s own
dryrun_multichip prints. Tolerance: none for the histogram, the counts,
the flush's sketch bins and the pipeline's out.json bytes; the flush's
weights within rtol 1e-12 (each package's exp/log on the CPU).
"""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulk_tpu.hashes.cws import build_cws_tables as jax_cws_tables
from hulk_tpu.ops.device_step import sketch_accumulate_step as jax_accumulate_step
from hulk_tpu.parallel.mesh import make_sketch_mesh, shard_tables, sharded_flush_step
from hulk_tpu.parallel.mesh import sharded_histogram_step as jax_histogram_step
from hulk_tpu.sketch.countmin import cms_row_bins_table, cms_shape
from hulk_tpu.stream import pipeline as jax_pipeline
from hulk_tpu_torch import entry as port_entry
from hulk_tpu_torch.ops.device_step import sketch_accumulate_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import __graft_entry__ as graft  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _cache(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path_factory.mktemp("cws")))
    yield
    mp.undo()


def test_example_batch_is_graft_entrys():
    for r, l, seed in ((64, 128, 0), (16, 64, 0), (8, 96, 3)):
        got, want = port_entry.example_batch(r, l, seed), graft._example_batch(r, l, seed)
        assert np.array_equal(got.codes, want.codes)
        assert np.array_equal(got.lengths, want.lengths)


def test_entry_fn_matches_graft_entry():
    """entry()'s fn on the CPU against __graft_entry__.entry()'s fn."""
    fn, args = port_entry.entry("cpu")
    assert [a.device for a in args] == [CPU] * 3
    hist, count = fn(*args)
    jfn, jargs = graft.entry()
    jhist, jcount = jfn(*jargs)
    assert np.array_equal(hist.numpy(), np.asarray(jhist))
    assert int(count) == int(jcount) > 0


@pytest.mark.parametrize("r,l,k,w", [(32, 150, 21, 9), (16, 300, 31, 2), (8, 40, 5, 16)])
def test_sketch_accumulate_step_matches_hulk_tpu(r, l, k, w):
    """Two steps into one histogram (it accumulates), reads with N and
    lengths 0-l, against hulk_tpu's step."""
    rng = np.random.default_rng(r + l + k)
    nbins = 11 ** 4
    hist = torch.zeros(nbins, dtype=torch.int32)
    jhist = jnp.zeros(nbins, dtype=jnp.int32)
    for _ in range(2):
        codes = rng.integers(0, 5, size=(r, l), dtype=np.uint8)
        lengths = rng.integers(0, l + 1, size=r).astype(np.int32)
        codes[np.arange(l)[None, :] >= lengths[:, None]] = 5
        hist, count = sketch_accumulate_step(hist, torch.from_numpy(codes),
                                             torch.from_numpy(lengths), k=k, w=w)
        jhist, jcount = jax_accumulate_step(jhist, codes, lengths, k=k, w=w)
        assert int(count) == int(jcount)
    assert np.array_equal(hist.numpy(), np.asarray(jhist))


def jax_dryrun(n: int) -> dict:
    """__graft_entry__.dryrun_multichip's steps, built from hulk_tpu's
    functions on n virtual CPU devices, with what they compute returned."""
    n_mp = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_sketch_mesh(n_dp=n // n_mp, n_mp=n_mp, devices=jax.devices()[:n])
    k, w, s = 7, 5, 8
    nbins = k ** 4
    packed = graft._example_batch(r=8 * max(1, n // n_mp), l=64)
    hist, count = jax_histogram_step(mesh, nbins, k, w)(packed.codes, packed.lengths)
    depth, width = cms_shape()
    flush = sharded_flush_step(mesh, 0.0, False, depth, width)
    _, sk, wts = flush(hist, jnp.asarray(cms_row_bins_table(nbins, depth, width)),
                       jnp.zeros((depth, width), dtype=jnp.float64),
                       jnp.zeros(s, dtype=jnp.int64), jnp.full(s, np.finfo(np.float64).max),
                       *shard_tables(mesh, jax_cws_tables(s, nbins)))
    rng = np.random.default_rng(1)
    reads = [bytes(rng.choice(list(b"ACGTN"), size=96, p=[0.24] * 4 + [0.04]).tolist())
             for _ in range(256)]
    cfg = jax_pipeline.SketchConfig(
        kmer_size=k, window_size=w, sketch_size=s, spectrum_size=nbins, kmv=True, khf=True,
        hmh=True, device_stream=True, data_parallel=True, batch_size=64)
    res = jax_pipeline.run_sketch_pipeline(iter(reads), cfg)
    return dict(count=int(count), sketch=np.asarray(sk), weights=np.asarray(wts), result=res)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip_matches_hulk_tpu(n, capsys):
    got = port_entry.dryrun_multichip(n, devices=["cpu"] * n)
    printed = capsys.readouterr().out
    n_mp = 2 if n % 2 == 0 else 1
    assert (got.n_dp, got.n_mp, got.devices) == (n // n_mp, n_mp, [CPU] * n)
    assert f"mesh: dp={n // n_mp} x mp={n_mp} over [{', '.join(['cpu'] * n)}]" in printed
    want = jax_dryrun(n)
    assert got.count == want["count"] > 0
    assert np.array_equal(got.sketch, want["sketch"])
    np.testing.assert_allclose(got.weights, want["weights"], rtol=1e-12)
    res, ref = got.result, want["result"]
    assert (res.seq_count, res.minimizer_count) == (ref.seq_count, ref.minimizer_count)
    hs, ref_hs = (dict(x.hulk_data.signatures)["histosketch"] for x in (res, ref))
    assert np.array_equal(hs.get_sketch(), ref_hs.get_sketch())
    assert np.array_equal(hs.sketch_weights.view(np.uint64),
                          ref_hs.sketch_weights.view(np.uint64))
    assert res.hulk_data.to_json_bytes() == ref.hulk_data.to_json_bytes()

    # what __graft_entry__'s own dry run prints: the count, the flush's and
    # the pipeline's first four bins
    graft.dryrun_multichip(n)
    line = capsys.readouterr().out
    m = re.search(r"minimizers=(\d+), sketch=(\[[^\]]*\]).*: (\d+) minimizers, "
                  r"sketch=(\[[^\]]*\])", line)
    assert m, line
    assert (int(m[1]), m[2], int(m[3]), m[4]) == (
        got.count, str(got.sketch[:4].tolist()), res.minimizer_count,
        str(hs.get_sketch()[:4].tolist()))


def test_default_mesh_needs_a_card_or_names(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="needs 2 names"):
        port_entry.dryrun_multichip(2, devices=["cpu"])


def test_entry_main_on_the_cpu(capsys):
    assert port_entry.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry ok: 1428 minimizers" in out
    assert f"dryrun_multichip mesh: dp=4 x mp=2 over [{', '.join(['cpu'] * 8)}]" in out
