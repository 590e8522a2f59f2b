"""The flush as one device step over slot stripes (parallel/mesh.py
sharded_flush_step) and its drift parts (ops/flush_drift.py), on the CPU.

The same numpy-seeded histograms go through the port's step on 1, 2 and 3
stripes that all name the CPU, through hulk_tpu's sharded_flush_step on its
virtual CPU devices (tests/conftest.py, as tests/test_parallel.py:48-146
runs it) and through the port's exact host flush (HistoSketch.add_elements).
Tolerance: the CMS is exactly equal (integer-valued sums, or the same IEEE
decay sequence) and the sketch bins equal; the weights equal the host
flush's bit for bit (the port's step and the host flush both take Go's
Exp and Log) and hulk_tpu's within rtol 1e-12 (its step uses XLA's exp and
log, within a few ULP of Go's). Stripes join bit-equal. The drift parts'
plain versions equal a literal per-bin loop bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulk_tpu.parallel.mesh import make_sketch_mesh as jax_mesh
from hulk_tpu.parallel.mesh import shard_tables as jax_shard_tables
from hulk_tpu.parallel.mesh import sharded_flush_step as jax_flush_step
from hulk_tpu_torch.hashes.cws import build_cws_tables
from hulk_tpu_torch.hashes.fdlibm import go_exp
from hulk_tpu_torch.ops.encode import pack_reads
from hulk_tpu_torch.ops.flush_drift import (
    TINY,
    cms_drift_scan,
    cms_drift_scan_torch,
    drift_select,
    drift_select_torch,
)
from hulk_tpu_torch.parallel import mesh
from hulk_tpu_torch.sketch.countmin import cms_row_bins_table, cms_shape
from hulk_tpu_torch.sketch.histosketch import HistoSketch

K, W, S = 9, 5, 8
NBINS = K ** 4
DECAY = 0.9
CPU = torch.device("cpu")
DEPTH, WIDTH = cms_shape()
MAX = np.finfo(np.float64).max


@pytest.fixture(scope="module")
def tables():
    return build_cws_tables(S, NBINS)


@pytest.fixture(scope="module")
def row_bins():
    return cms_row_bins_table(NBINS, DEPTH, WIDTH)


def read_hists(seed: int, rounds: int = 2) -> list:
    """Histograms of `rounds` batches of 64 random ACGT reads of 96 bases
    (numpy seed), from the port's sharded_histogram_step on the CPU."""
    rng = np.random.default_rng(seed)
    step = mesh.sharded_histogram_step([CPU] * 2, NBINS, K, W)
    hists = []
    for _ in range(rounds):
        seqs = [bytes(rng.choice(list(b"ACGT"), size=96).tolist()) for _ in range(64)]
        packed = pack_reads(seqs, pad_to=96, n_reads=64)
        hists.append(step(packed.codes, packed.lengths)[0].numpy())
    return hists


def corpus_hist(seed: int) -> np.ndarray:
    """tests/test_parallel.py's corpus: NBINS // 12 random bins of counts
    1-299."""
    r = np.random.default_rng(seed)
    hist = np.zeros(NBINS, dtype=np.int32)
    ids = r.choice(NBINS, NBINS // 12, replace=False)
    hist[ids] = r.integers(1, 300, ids.shape[0])
    return hist


def port_flushes(hists, tables, row_bins, stripes: int, drift: bool):
    """The port's step over `stripes` CPU stripes, one flush a histogram,
    the CMS carried: (cms, sketch, weights) as numpy."""
    devices = [CPU] * stripes
    dw = float(go_exp(-DECAY)) if drift else 0.0
    step = mesh.sharded_flush_step(devices, dw, drift, DEPTH, WIDTH)
    table_stripes = mesh.shard_tables(devices, tables)
    rb = torch.from_numpy(row_bins.astype(np.int64))
    cms = torch.zeros(DEPTH, WIDTH, dtype=torch.float64)
    sk = torch.zeros(S, dtype=torch.int64)
    wts = torch.full((S,), MAX, dtype=torch.float64)
    for h in hists:
        cms, sk, wts = step(torch.from_numpy(h), rb, cms, sk, wts, table_stripes)
    return cms.numpy(), sk.numpy(), wts.numpy()


def jax_flushes(hists, tables, row_bins, n_mp: int, drift: bool):
    """hulk_tpu's sharded_flush_step on a (8 // n_mp) x n_mp mesh of its
    virtual CPU devices, the same flushes."""
    m = jax_mesh(n_dp=8 // n_mp, n_mp=n_mp)
    dw = float(go_exp(-DECAY)) if drift else 0.0
    flush = jax_flush_step(m, dw, drift, DEPTH, WIDTH)
    c_sh, b_sh, er_sh = jax_shard_tables(m, tables)
    rb = jnp.asarray(row_bins)
    cms = jnp.zeros((DEPTH, WIDTH), dtype=jnp.float64)
    sk = jnp.zeros(S, dtype=jnp.int64)
    wts = jnp.full(S, MAX)
    for h in hists:
        cms, sk, wts = flush(jnp.asarray(h), rb, cms, sk, wts, c_sh, b_sh, er_sh)
    return np.asarray(cms), np.asarray(sk), np.asarray(wts)


def host_flushes(hists, tables, drift: bool) -> HistoSketch:
    host = HistoSketch(K, S, NBINS, DECAY if drift else 1.0, tables=tables)
    for h in hists:
        ids = np.nonzero(h)[0].astype(np.int64)
        host.add_elements(ids, h.astype(np.float64)[ids])
    return host


def assert_matches(got, jax_out, host):
    cms, sk, wts = got
    assert np.array_equal(cms, jax_out[0])
    assert np.array_equal(sk, jax_out[1])
    np.testing.assert_allclose(wts, jax_out[2], rtol=1e-12)
    assert np.array_equal(cms, host.cms.sketch)
    assert np.array_equal(sk.astype(np.uint64), host.sketch)
    assert np.array_equal(wts.view(np.uint64), host.sketch_weights.view(np.uint64))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("drift", [False, True], ids=["no_drift", "drift"])
@pytest.mark.parametrize("stripes", [1, 2])
def test_flush_step_matches_hulk_tpu_and_host(stripes, drift, tables, row_bins):
    """Two interval flushes of read histograms, the CMS carried across."""
    hists = read_hists(11)
    got = port_flushes(hists, tables, row_bins, stripes, drift)
    assert_matches(got, jax_flushes(hists, tables, row_bins, stripes, drift),
                   host_flushes(hists, tables, drift))


@pytest.mark.parametrize("drift", [False, True], ids=["no_drift", "drift"])
def test_stripes_join_bit_equal(drift, tables, row_bins):
    """1, 2 and 3 stripes (8 slots: 3, 3 and 2) give the same bits."""
    hists = read_hists(12)
    one = port_flushes(hists, tables, row_bins, 1, drift)
    for stripes in (2, 3):
        got = port_flushes(hists, tables, row_bins, stripes, drift)
        for a, b in zip(got, one):
            assert np.array_equal(a.view(np.uint64), b.view(np.uint64))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("seed", range(6))
def test_flush_corpus_sweep(seed, tables, row_bins):
    """tests/test_parallel.py's corpus sweep, seed by seed: no drift on 1
    stripe against hulk_tpu's 8 x 1 mesh, and drift on 2 stripes against
    its 4 x 2 mesh, both against the host flush."""
    hists = [corpus_hist(seed)]
    for stripes, drift in ((1, False), (2, True)):
        got = port_flushes(hists, tables, row_bins, stripes, drift)
        assert_matches(got, jax_flushes(hists, tables, row_bins, stripes, drift),
                       host_flushes(hists, tables, drift))


def literal_drift(hist, row_bins, cms, aka_of, sketch, weights, dw):
    """The JAX scan's body (hulk_tpu/parallel/mesh.py:274-291) over every
    bin, in numpy: (cms, estimates of the live bins, sketch, weights);
    aka_of(bin, estimate) gives the bin's Aka of every slot."""
    cms, sketch, weights = cms.copy(), sketch.copy(), weights.copy()
    rows = np.arange(cms.shape[0])
    estis = []
    for jbin in range(hist.shape[0]):
        freq = float(hist[jbin])
        if freq == 0.0:
            continue
        scaled = cms * dw
        cms = np.where(scaled >= TINY, scaled, 0.0)
        cms[rows, row_bins[:, jbin]] += freq
        esti = cms[rows, row_bins[:, jbin]].min()
        estis.append(esti)
        with np.errstate(over="ignore"):
            better = aka_of(jbin, esti) < weights / dw
        sketch = np.where(better, jbin, sketch)
        weights = np.where(better, aka_of(jbin, esti), weights)
    return cms, np.array(estis), sketch, weights


@pytest.mark.parametrize("seed", [3, 4])
def test_drift_parts_match_literal_loop(seed, tables, row_bins):
    """cms_drift_scan_torch and drift_select_torch against the literal loop,
    from a CMS carried in and a sketch already half filled; the dispatching
    entry points take the plain versions for CPU tensors."""
    rng = np.random.default_rng(seed)
    hist = corpus_hist(seed)
    cms0 = np.where(rng.random((DEPTH, WIDTH)) < 0.3, rng.integers(1, 50, (DEPTH, WIDTH)),
                    0).astype(np.float64)
    sk0 = np.where(rng.random(S) < 0.5, rng.integers(0, NBINS, S), 0).astype(np.int64)
    w0 = np.where(sk0 > 0, rng.random(S) * 1e-3, MAX)
    dw = float(go_exp(-DECAY))

    def aka_of(jbin, esti):
        return tables.c[:, jbin] / (np.exp(np.log(esti) - tables.b[:, jbin])
                                    * tables.exp_r[:, jbin])

    want_cms, want_esti, want_sk, want_w = literal_drift(hist, row_bins, cms0, aka_of, sk0,
                                                         w0, dw)
    ids = np.nonzero(hist)[0]
    t = torch.from_numpy
    freqs, rb = t(hist[ids].astype(np.float64)), t(row_bins[:, ids].astype(np.int64))
    cms, esti = cms_drift_scan_torch(freqs, rb, t(cms0), dw)
    assert np.array_equal(cms.numpy().view(np.uint64), want_cms.view(np.uint64))
    assert np.array_equal(esti.numpy().view(np.uint64), want_esti.view(np.uint64))
    aka = np.stack([aka_of(j, e) for j, e in zip(ids, want_esti)], axis=1)
    sk, w = drift_select_torch(t(aka), t(ids.astype(np.int64)), t(sk0), t(w0), dw)
    assert np.array_equal(sk.numpy(), want_sk)
    assert np.array_equal(w.numpy().view(np.uint64), want_w.view(np.uint64))
    cms2, esti2 = cms_drift_scan(freqs, rb, t(cms0), dw)
    sk2, w2 = drift_select(t(aka), t(ids.astype(np.int64)), t(sk0), t(w0), dw)
    for a, b in ((cms2, cms), (esti2, esti), (sk2, sk), (w2, w)):
        assert torch.equal(a, b)


def test_scan_with_the_squash_at_the_end_is_bit_equal():
    """The CUDA scan's arithmetic (csrc/flush_drift.cu: decay without the
    squash, which waits for the end) in NumPy against cms_drift_scan_torch
    (the squash at every step): the same CMS and estimates, over enough
    live bins that most counters decay below the smallest normal between
    two hits."""
    rng = np.random.default_rng(8)
    hist = np.where(rng.random(NBINS) < 0.6, rng.integers(1, 300, NBINS), 0)
    ids = np.nonzero(hist)[0]
    rb = np.ascontiguousarray(cms_row_bins_table(NBINS, DEPTH, WIDTH)[:, ids], dtype=np.int64)
    freqs = hist[ids].astype(np.float64)
    dw = float(go_exp(-DECAY))
    cms0 = np.where(rng.random((DEPTH, WIDTH)) < 0.3, 7.0, 0.0)
    cms, rows = cms0.copy(), np.arange(DEPTH)
    esti = np.empty(ids.shape[0])
    went_subnormal = np.zeros((DEPTH, WIDTH), dtype=bool)
    for i in range(ids.shape[0]):
        cms = cms * dw
        went_subnormal |= (cms > 0) & (cms < TINY)
        cms[rows, rb[:, i]] += freqs[i]
        esti[i] = cms[rows, rb[:, i]].min()
    cms = np.where(cms >= TINY, cms, 0.0)
    assert went_subnormal.mean() > 0.5
    got_cms, got_esti = cms_drift_scan_torch(torch.from_numpy(freqs), torch.from_numpy(rb),
                                             torch.from_numpy(cms0), dw)
    assert np.array_equal(got_cms.numpy().view(np.uint64), cms.view(np.uint64))
    assert np.array_equal(got_esti.numpy().view(np.uint64), esti.view(np.uint64))


@pytest.mark.parametrize("stripes", [1, 2])
def test_ties_keep_the_first_bin(stripes, tables, row_bins):
    """Two live bins with equal counts and equal CWS columns have equal Aka
    in every slot: without drift each slot keeps the first (the reference's
    strictly-smaller scan), as the host flush does."""
    from hulk_tpu_torch.hashes.cws import CWSTables

    first, second = 3, 5
    cols = [np.array(t, copy=True) for t in (tables.r, tables.c, tables.b, tables.exp_r)]
    for t in cols:
        t[:, second] = t[:, first]
    tied = CWSTables(*cols)
    hist = np.zeros(NBINS, dtype=np.int32)
    hist[[first, second]] = 7
    _, sk, _ = port_flushes([hist], tied, row_bins, stripes, False)
    assert (sk == first).all()
    assert (host_flushes([hist], tied, False).sketch == first).all()


def test_drift_selection_ties_at_the_threshold():
    """An Aka equal to weight / dw does not replace (strictly below), one
    below it does, in bin order: dw = 0.5, so the thresholds are exact."""
    t = torch.tensor
    aka = t([[1.0, 2.0, 3.0], [1.0, 1.5, 2.5]], dtype=torch.float64)
    sk, w = drift_select_torch(aka, t([10, 11, 12]), t([0, 0]), t([MAX, MAX]), 0.5)
    assert sk.tolist() == [10, 12] and w.tolist() == [1.0, 2.5]
