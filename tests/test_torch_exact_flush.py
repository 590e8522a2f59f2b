"""Go's Exp and Log in PyTorch (ops/cws_aka.py) and the exact flush on the
stream's devices (parallel/mesh.py sharded_flush_step, stream/pipeline.py
_CardFlusher), on the CPU with the plain versions of its parts.

Tolerance: none. The plain Exp and Log equal hashes/fdlibm.py and the
native ports (hulkrt.cpp hulk_go_exp, hulk_go_log) bit for bit, a NaN as a
NaN; the flush equals the exact host flush (HistoSketch.add_elements) in
the CMS, the bins and the weights as u64 bits, over three interval
histograms with the CMS carried; the pipeline's documents through the
card's route equal the host route's bytes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hulk_tpu_torch import native, spans
from hulk_tpu_torch.hashes import fdlibm
from hulk_tpu_torch.hashes.cws import build_cws_tables
from hulk_tpu_torch.ops.cws_aka import cws_aka_torch, go_exp_torch, go_log_torch
from hulk_tpu_torch.ops.flush_drift import cms_drift_scan_torch
from hulk_tpu_torch.parallel import mesh
from hulk_tpu_torch.sketch.countmin import cms_row_bins_table, cms_shape
from hulk_tpu_torch.sketch.histosketch import HistoSketch
from hulk_tpu_torch.sketch.spectrum import SpectrumError
from hulk_tpu_torch.stream import pipeline
from hulk_tpu_torch.stream.pipeline import SketchConfig, run_sketch_pipeline
from hulk_tpu_torch.synth import generate

K, S, NBINS = 9, 8, 9 ** 4
DEPTH, WIDTH = cms_shape()
DECAY = 0.9
CPU = torch.device("cpu")
MAX = np.finfo(np.float64).max


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))


def _around(x: float, n: int = 3) -> list:
    """x and its n neighbours on each side."""
    out, lo, hi = [x], x, x
    for _ in range(n):
        lo, hi = np.nextafter(lo, -np.inf), np.nextafter(hi, np.inf)
        out += [lo, hi]
    return out


def _inputs(fn: str, kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "sweep" and fn == "exp":
        return np.concatenate([np.linspace(-746.0, 710.0, 20001), rng.normal(0, 3, 5000),
                               rng.uniform(-1e-8, 1e-8, 2000)])
    if kind == "sweep":  # log: magnitudes from the subnormals to the largest
        return np.concatenate([np.exp(rng.uniform(-744.0, 709.0, 20000)),
                               rng.integers(1, 10**9, 5000).astype(np.float64),
                               rng.uniform(0.5, 2.0, 5000), -rng.random(100)])
    specials = [0.0, -0.0, 5e-324, -5e-324, 1e-310, 2.2250738585072014e-308,
                np.inf, -np.inf, np.nan, 1.0, -1.0, MAX, -MAX]
    if fn == "exp":
        edges = [fdlibm._OVERFLOW, fdlibm._UNDERFLOW, fdlibm._NEAR_ZERO,
                 -fdlibm._NEAR_ZERO, -708.4, -709.1, -740.0, -744.5]
        # where Log2e * x + 0.5 crosses an integer: k changes there
        edges += [(m - 0.5) / fdlibm._LOG2E for m in (-1074, -1, 1, 2, 1023, 1024)]
        edges += [(m + 0.5) / fdlibm._LOG2E for m in (-1075, -1022, -2, -1)]
    else:
        edges = [fdlibm._SQRT2_OVER_2, 2 * fdlibm._SQRT2_OVER_2, 0.5, 2.0, 1.0, 4.0,
                 2.2250738585072014e-308, 4.9e-324 * 3, 2.0 ** -1030]
    return np.array(specials + [v for e in edges for v in _around(float(e))],
                    dtype=np.float64)


def _same_bits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), what
    assert np.array_equal(got[~nan].view(np.uint64), want[~nan].view(np.uint64)), what


@pytest.mark.parametrize("kind", ["sweep", "edges"])
@pytest.mark.parametrize("fn", ["exp", "log"])
def test_go_exp_log_bit_equal_to_fdlibm_and_native(fn, kind):
    x = _inputs(fn, kind)
    plain = {"exp": go_exp_torch, "log": go_log_torch}[fn]
    got = plain(torch.from_numpy(x)).numpy()
    with np.errstate(all="ignore"):
        _same_bits(got, {"exp": fdlibm.go_exp, "log": fdlibm.go_log}[fn](x), "fdlibm.py")
    lib = native._load()
    if lib is not None:
        one = {"exp": lib.hulk_go_exp, "log": lib.hulk_go_log}[fn]
        _same_bits(got, np.array([one(float(v)) for v in x]), "hulkrt.cpp")


@pytest.fixture(scope="module")
def tables():
    return build_cws_tables(S, NBINS)


def _hists(seed: int) -> list:
    """Three interval histograms over about a third of the bins, counts
    1-299."""
    rng = np.random.default_rng(seed)
    return [np.where(rng.random(NBINS) < 0.3, rng.integers(1, 300, NBINS), 0).astype(np.int32)
            for _ in range(3)]


def _estimates(hist: np.ndarray, drift: bool) -> np.ndarray:
    """Each live bin's estimate in a first flush from an empty CMS."""
    ids = np.flatnonzero(hist)
    rows = torch.from_numpy(cms_row_bins_table(NBINS, DEPTH, WIDTH)[:, ids].astype(np.int64))
    dw = float(fdlibm.go_exp(-DECAY)) if drift else 1.0
    cms = torch.zeros(DEPTH, WIDTH, dtype=torch.float64)
    return cms_drift_scan_torch(torch.from_numpy(hist[ids].astype(np.float64)), rows, cms,
                                dw)[1].numpy()


def _ties(tables, hists: list, drift: bool):
    """Tables and a first histogram with two live bins j1 < j2 of one
    count, one estimate and one b and exp_r in every slot, with Aka far
    below every other bin's: j2's Aka equal to j1's without drift (a tie at
    the minimum, where the first index keeps the slot), and equal to j1's
    Aka / dw with drift (a tie at the threshold, which does not replace).
    Returns (tables, hists, j1)."""
    c, b, exp_r = (np.array(t) for t in (tables.c, tables.b, tables.exp_r))
    hist = hists[0].copy()
    ids = np.flatnonzero(hist)
    j1 = int(ids[10])
    for j2 in ids[11:]:
        hist[j2] = hist[j1]
        esti = dict(zip(np.flatnonzero(hist), _estimates(hist, drift)))
        if esti[j2] == esti[j1]:
            break
        hist[j2] = hists[0][j2]
    else:
        raise AssertionError("no bin to tie with")
    j2 = int(j2)
    b[:, [j1, j2]], exp_r[:, [j1, j2]], c[:, j1] = 0.5, 1.0, -1e6
    one = lambda col: cws_aka_torch(  # noqa: E731
        torch.tensor([esti[j1]]), torch.tensor([0]), *(torch.from_numpy(t[:, [col]].copy())
                                                        for t in (c, b, exp_r)))[:, 0].numpy()
    a1 = one(j1)
    want = a1 / float(fdlibm.go_exp(-DECAY)) if drift else a1
    c[:, j2] = want * (c[:, j1] / a1)  # c2 / D == want, D = c1 / a1, to a few ULP
    for _ in range(64):  # step c2 by ULPs until each slot's Aka is exactly `want`
        a2 = one(j2)
        if np.array_equal(a2, want):
            break
        c[:, j2] = np.where(a2 < want, np.nextafter(c[:, j2], 0.0),
                            np.where(a2 > want, np.nextafter(c[:, j2], -np.inf), c[:, j2]))
    assert np.array_equal(one(j2), want), "no exact tie"
    return dataclasses.replace(tables, c=c, b=b, exp_r=exp_r), [hist, *hists[1:]], j1


def _card_route(hists, tables, stripes: int, drift: bool):
    """The flush step over `stripes` CPU stripes, a flush a histogram."""
    devices = [CPU] * stripes
    hs = HistoSketch(K, S, NBINS, DECAY if drift else 1.0, tables=tables)
    step = mesh.sharded_flush_step(devices, hs.cms.decay_weight, drift, DEPTH, WIDTH)
    rb = torch.from_numpy(cms_row_bins_table(NBINS, DEPTH, WIDTH).astype(np.int64))
    state = (torch.zeros(DEPTH, WIDTH, dtype=torch.float64), torch.zeros(S, dtype=torch.int64),
             torch.full((S,), MAX, dtype=torch.float64))
    firsts = None
    for h in hists:
        state = step(torch.from_numpy(h), rb, *state, mesh.shard_tables(devices, tables))
        firsts = state[1].numpy().copy() if firsts is None else firsts
    return [x.numpy() for x in state], firsts


@pytest.mark.parametrize("case", ["reads", "ties"])
@pytest.mark.parametrize("stripes", [1, 2])
@pytest.mark.parametrize("drift", [False, True], ids=["no_drift", "drift"])
def test_exact_flush_matches_host_flush(drift, stripes, case, tables):
    """Three interval flushes, the CMS carried: the CMS, the bins and the
    weights' bits equal the host flush's; in the tie case each slot keeps
    j1 after the first flush, as the host does."""
    hists = _hists(21)
    j1 = None
    if case == "ties":
        tables, hists, j1 = _ties(tables, hists, drift)
    (cms, sk, wts), firsts = _card_route(hists, tables, stripes, drift)
    host = HistoSketch(K, S, NBINS, DECAY if drift else 1.0, tables=tables)
    for i, h in enumerate(hists):
        ids = np.flatnonzero(h).astype(np.int64)
        host.add_elements(ids, h[ids].astype(np.float64))
        if i == 0 and j1 is not None:
            assert (host.sketch == j1).all() and (firsts == j1).all()
    assert np.array_equal(cms.view(np.uint64), host.cms.sketch.view(np.uint64))
    assert np.array_equal(sk.astype(np.uint64), host.sketch)
    assert np.array_equal(wts.view(np.uint64), host.sketch_weights.view(np.uint64))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("reads") / "reads.fq.gz"), 1500, seed=9)


def _run(reads, monkeypatch, card: bool, **kw):
    """run_sketch_pipeline at k=11, s=8, -i 400, --stream snapshots
    collected, with every flush through the card's route (forced onto the
    CPU) or the host's; spans on. Returns (snapshots, out.json bytes, the
    final histosketch, the flush counters)."""
    monkeypatch.setattr(pipeline, "_flush_on_card", lambda devices, multi_process: card)
    snaps = []
    spans.enable(True)
    spans.reset()
    try:
        res = run_sketch_pipeline(None, SketchConfig(
            kmer_size=11, window_size=5, sketch_size=S, interval=400, device="cpu",
            input_paths=[reads], **kw), on_interval=lambda d: snaps.append(d.to_json_bytes()))
        counts = {k: v for k, v in spans.counters().items() if k.startswith("flush.")}
    finally:
        spans.enable(False)
        spans.reset()
    return snaps, res.hulk_data.to_json_bytes(), dict(res.hulk_data.signatures)["histosketch"], \
        counts


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]], ids=["one", "striped"])
@pytest.mark.parametrize("decay", [1.0, DECAY])
def test_pipeline_card_route_writes_the_host_routes_bytes(reads, monkeypatch, decay, devices):
    """1,500 reads at -i 400: three interval flushes and the last, each
    snapshot and the final document byte for byte the host route's, the
    CMS bit-equal, each flush counted by its route."""
    card = _run(reads, monkeypatch, True, decay_ratio=decay, devices=devices)
    host = _run(reads, monkeypatch, False, decay_ratio=decay, devices=devices)
    assert len(card[0]) == 3 and card[0] == host[0]
    assert card[1] == host[1]
    assert np.array_equal(card[2].cms.sketch.view(np.uint64), host[2].cms.sketch.view(np.uint64))
    assert card[3] == {"flush.device": 4} and host[3] == {"flush.host": 4}


def test_card_flusher_raises_as_the_host_flush(monkeypatch):
    """An untouched histogram is a no-op; one below MIN_USED_BINS raises the
    host flush's SpectrumError; the tables go to the devices once."""
    hs = HistoSketch(11, S, 11 ** 4, 1.0)
    flusher = pipeline._CardFlusher(hs, 11 ** 4, [CPU])
    before = hs.sketch_weights.copy()
    flusher.flush_from(torch.zeros(11 ** 4, dtype=torch.int32))
    assert np.array_equal(hs.sketch_weights, before)
    sparse = torch.zeros(11 ** 4, dtype=torch.int32)
    sparse[:10] = 3
    with pytest.raises(SpectrumError, match="not used yet") as got:
        flusher.flush_from(sparse)
    spectrum = pipeline.KmerSpectrum(11 ** 4)
    spectrum.add_dense(sparse.numpy().astype(np.float64))
    with pytest.raises(SpectrumError) as want:
        spectrum.dump()
    assert str(got.value) == str(want.value)
    again = pipeline._CardFlusher(HistoSketch(11, S, 11 ** 4, 1.0), 11 ** 4, [CPU])
    assert again.stripes is flusher.stripes and again.row_bins is flusher.row_bins


def test_flush_route_follows_the_devices_and_processes():
    assert pipeline._flush_on_card([torch.device("cuda", 0)], False)
    assert pipeline._flush_on_card([torch.device("cuda", 0)] * 2, False)
    assert not pipeline._flush_on_card([torch.device("cuda", 0)], True)
    assert not pipeline._flush_on_card([CPU], False)
    assert not pipeline._flush_on_card([CPU, torch.device("cuda", 0)], False)
