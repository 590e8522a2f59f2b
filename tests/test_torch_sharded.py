"""The data-parallel sketch (stream/pipeline.py _ShardedDeviceStream,
parallel/mesh.py) on D "devices" that all name the CPU, the way hulk_tpu's
tests run its sharded path on 8 virtual CPU devices (tests/conftest.py).

The batch size is 255, a multiple of none of D = 2, 3, 8, and interval
cuts and length buckets leave batches of fewer rows, so some shards get no
rows of a batch. The same reads (hulk_tpu_torch.synth, seeded) go through
the port's sharded pipeline, the port's one-device pipeline and hulk_tpu's
SketchConfig(device_stream=True, data_parallel=True) on its 8 virtual
devices. Tolerance: none. The sketch JSON bytes and the counters are
identical, and the flush step with its tables striped equals the one-stripe
step array for array, bit for bit.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import hulk_tpu.stream.pipeline as jax_pipeline
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu.ops.encode import pack_reads
from hulk_tpu.parallel.mesh import make_sketch_mesh as jax_mesh
from hulk_tpu.parallel.mesh import sharded_histogram_step as jax_histogram_step
from hulk_tpu_torch.hashes.fdlibm import go_exp
from hulk_tpu_torch.parallel import mesh
from hulk_tpu_torch.sketch.countmin import cms_row_bins_table
from hulk_tpu_torch.sketch.histosketch import HistoSketch
from hulk_tpu_torch.stream import pipeline
from hulk_tpu_torch.stream.pipeline import SketchConfig, run_sketch_pipeline
from hulk_tpu_torch.synth import generate, generate_mixed

BATCH = 255
CPU = torch.device("cpu")

# (reads fixture, config shared by both packages)
CASES = {
    "k21_sketches": ("reads", dict(kmer_size=21, window_size=9, sketch_size=8,
                                   kmv=True, khf=True, hmh=True)),
    "k31": ("reads", dict(kmer_size=31, window_size=9, sketch_size=8,
                          spectrum_size=11 ** 4, kmv=True)),
    "mixed_lengths": ("mixed", dict(kmer_size=11, window_size=5, sketch_size=8,
                                    khf=True)),
    "intervals": ("reads", dict(kmer_size=11, window_size=5, sketch_size=8,
                                interval=400)),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    return {"reads": generate(str(d / "reads.fq.gz"), 1500, read_len=150, seed=21),
            "mixed": generate_mixed(str(d / "mixed.fq.gz"), 600, lo=40, hi=3000, seed=22)}


@pytest.fixture(scope="module", autouse=True)
def _cache(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path_factory.mktemp("cws")))
    yield
    mp.undo()


def _summary(res):
    return (res.hulk_data.to_json_bytes(), res.seq_count, res.length_total,
            res.minimizer_count)


def _port(src, devices=None, **kw):
    return _summary(run_sketch_pipeline(None, SketchConfig(
        device="cpu", devices=devices, input_paths=[src], batch_size=BATCH, **kw)))


_want: dict = {}


def _wanted(inputs, case):
    """(hulk_tpu's data-parallel result, the port's one-device result) of a
    case, computed once."""
    if case not in _want:
        name, kw = CASES[case]
        ref = jax_pipeline.run_sketch_pipeline(None, jax_pipeline.SketchConfig(
            input_paths=[inputs[name]], batch_size=BATCH, device_stream=True,
            data_parallel=True, **kw))
        _want[case] = (_summary(ref), _port(inputs[name], **kw))
    return _want[case]


@pytest.mark.parametrize("ndev", [2, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_pipeline_byte_identical(inputs, case, ndev, monkeypatch):
    """D shards: the sketch JSON and counters equal the port's one device's
    and hulk_tpu's data-parallel run's on its 8 virtual devices."""
    assert len(jax.devices()) == 8
    shards_without_rows = []
    step = mesh.sharded_group_step

    def spy(hists, counts, states, shards, **kw):
        shards_without_rows.append(sum(s is None for s in shards))
        step(hists, counts, states, shards, **kw)

    monkeypatch.setattr(mesh, "sharded_group_step", spy)
    name, kw = CASES[case]
    ref, one = _wanted(inputs, case)
    got = _port(inputs[name], devices=[CPU] * ndev, **kw)
    assert got == one
    assert got == ref
    assert len(shards_without_rows) > 0
    if case == "intervals" and ndev == 8:
        assert max(shards_without_rows) > 0  # 145-row batches leave shards 5-7 empty


@pytest.mark.parametrize("devices,sharded", [
    (["cpu", "cpu"], True), (["cpu"], False), (None, False)])
def test_stream_selection(inputs, devices, sharded, monkeypatch):
    """The sharded stream when there is more than one device (hulk_tpu's
    pipeline.py:905-923); else one device's."""
    made = []
    init = pipeline._ShardedDeviceStream.__init__

    def spy(self, *a):
        made.append(True)
        init(self, *a)

    monkeypatch.setattr(pipeline._ShardedDeviceStream, "__init__", spy)
    _port(inputs["reads"], devices=devices, kmer_size=11, window_size=5, sketch_size=8)
    assert bool(made) == sharded


def test_cuda_means_one_card(monkeypatch):
    """device "cuda" runs on one card however many are visible: four cards
    in one process measured slower than one (scripts/shard_scaling.py)."""
    monkeypatch.setattr("torch.cuda.device_count", lambda: 4)
    assert SketchConfig(device="cuda").resolved_devices() == [torch.device("cuda")]
    assert SketchConfig(devices=["cuda:0", "cuda:1"]).resolved_devices() == [
        torch.device("cuda", 0), torch.device("cuda", 1)]


def test_cli_device_list_shards(inputs, tmp_path, monkeypatch):
    """sketch --device cpu,cpu,cpu shards the reads over the three devices
    listed and writes the bytes that --device cpu writes."""
    made = []
    init = pipeline._ShardedDeviceStream.__init__

    def spy(self, cfg, nbins, devices):
        made.append(len(devices))
        init(self, cfg, nbins, devices)

    monkeypatch.setattr(pipeline._ShardedDeviceStream, "__init__", spy)
    outs = {}
    for device in ("cpu", "cpu,cpu,cpu"):
        out = str(tmp_path / device.replace(",", "_"))
        torch_cli.main(["sketch", "-f", inputs["reads"], "-k", "11", "-w", "5", "--kmv",
                        "-o", out, "--device", device, "--log", out + ".log"])
        with open(out + ".json", "rb") as fh:
            outs[device] = fh.read()
    assert made == [3]
    assert outs["cpu,cpu,cpu"] == outs["cpu"]


def test_shards_step_concurrently(inputs, monkeypatch):
    """Each shard packs and steps its rows in a thread of its own: a step
    that waits at a barrier for the other shards' steps completes only if
    all three run at once (a serial step would break the barrier)."""
    from hulk_tpu_torch.ops import device_step

    kw = dict(kmer_size=11, window_size=5, sketch_size=8, kmv=True)
    want = _port(inputs["reads"], **kw)
    # 1,500 reads of 150 bp in batches of 255: one group, every shard with
    # rows of every batch
    barrier = threading.Barrier(3, timeout=60)
    threads = []
    body = device_step.group_scan_body

    def spy(*a, **k):
        threads.append(threading.current_thread().name)
        barrier.wait()
        body(*a, **k)

    monkeypatch.setattr(device_step, "group_scan_body", spy)
    assert _port(inputs["reads"], devices=[CPU] * 3, **kw) == want
    assert len(threads) == len(set(threads)) == 3
    assert all(t.startswith("hulk-shard") for t in threads)


@pytest.mark.parametrize("nstripes", [1, 2, 3])
def test_striped_device_flush(inputs, nstripes):
    """--deviceFlush with the CWS tables striped over 1, 2 and 3 devices
    (the stream sharded over them too): the one-device device flush's
    output, the host flush's, and hulk_tpu's device flush (its tables
    striped over its 8 devices)."""
    kw = dict(kmer_size=11, window_size=5, sketch_size=8, interval=400)
    src = inputs["reads"]
    got = _port(src, devices=[CPU] * nstripes, device_flush=True, **kw)
    assert got == _port(src, device_flush=True, **kw)
    assert got == _port(src, **kw)
    ref = jax_pipeline.run_sketch_pipeline(None, jax_pipeline.SketchConfig(
        input_paths=[src], batch_size=BATCH, device_stream=True, data_parallel=False,
        device_flush=True, **kw))
    assert got == _summary(ref)


def _flush_inputs(seed: int, k: int = 11, s: int = 8):
    """A histogram over about a third of the bins, the CMS row table, and
    the CMS, sketch and weights of an earlier flush, as tensors; and the
    CWS tables."""
    nbins = k ** 4
    rng = np.random.default_rng(seed)
    hist = np.where(rng.random(nbins) < 0.35, rng.integers(1, 60, nbins), 0).astype(np.int32)
    hs = HistoSketch(k, s, nbins, 1.0)
    ids = np.sort(rng.choice(nbins, 3000, replace=False)).astype(np.int64)
    hs.add_elements(ids, rng.integers(1, 9, 3000).astype(np.float64))
    depth, width = hs.cms.sketch.shape
    return (torch.from_numpy(hist),
            torch.from_numpy(cms_row_bins_table(nbins, depth, width).astype(np.int64)),
            torch.from_numpy(hs.cms.sketch.copy()), torch.from_numpy(hs.sketch.view(np.int64)),
            torch.from_numpy(hs.sketch_weights.copy()), hs.cws)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("drift", [False, True], ids=["no_drift", "drift"])
@pytest.mark.parametrize("nstripes", [1, 2, 3, 5, 9])
def test_striped_flush_step_equals_one_device(nstripes, drift):
    """sharded_flush_step with the CWS tables striped over nstripes devices
    against one stripe, from a CMS and sketch that hold an earlier flush:
    the CMS, the bins and the weights bit for bit. Nine stripes of eight
    slots leave one empty."""
    hist, row_bins, cms, sketch, weights, tables = _flush_inputs(0)
    dw = float(go_exp(-0.9)) if drift else 1.0

    def run(n: int):
        devices = [CPU] * n
        stripes = mesh.shard_tables(devices, tables)
        step = mesh.sharded_flush_step(devices, dw, drift, *cms.shape)
        return stripes, step(hist, row_bins, cms, sketch, weights, stripes)

    stripes, got = run(nstripes)
    assert [c.shape[0] for c, _, _ in stripes] == [hi - lo for lo, hi in mesh.stripes(8, nstripes)]
    _, want = run(1)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n,d,want", [
    (255, 8, [(0, 32), (32, 64), (64, 96), (96, 128), (128, 160), (160, 192), (192, 224),
              (224, 255)]),
    (145, 8, [(0, 19), (19, 38), (38, 57), (57, 76), (76, 95), (95, 114), (114, 133),
              (133, 145)]),
    (5, 3, [(0, 2), (2, 4), (4, 5)]),
    (8, 9, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8), (8, 8)])])
def test_stripes(n, d, want):
    """Contiguous blocks of ceil(n / d), the last ones shorter or empty."""
    assert mesh.stripes(n, d) == want


@pytest.mark.parametrize("ndev", [8, 3])
def test_sharded_histogram_step_matches_reference(ndev):
    """sharded_histogram_step on D CPU devices against hulk_tpu's on its
    8-device dp mesh: the same histogram and count, bit for bit."""
    k, w, nbins = 9, 5, 9 ** 4
    rng = np.random.default_rng(11)
    seqs = [bytes(rng.choice(list(b"ACGTN"), p=[0.24] * 4 + [0.04], size=96).tolist())
            for _ in range(64)]
    packed = pack_reads(seqs, pad_to=96, n_reads=64)
    codes, lengths = np.asarray(packed.codes), np.asarray(packed.lengths)
    want_hist, want_count = jax_histogram_step(jax_mesh(n_dp=8, n_mp=1), nbins, k, w)(
        codes, lengths)
    hist, count = mesh.sharded_histogram_step([CPU] * ndev, nbins, k, w)(codes, lengths)
    assert hist.dtype == torch.int32
    assert np.array_equal(hist.numpy(), np.asarray(want_hist))
    assert int(count) == int(want_count) > 0


def test_cli_cuda_without_a_card_fails(inputs, tmp_path, monkeypatch):
    """--device cuda with no card: the run fails with the pipeline's
    message and writes nothing; nothing falls back to the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["sketch", "-f", inputs["reads"], "-k", "11", "-w", "5", "-o", str(out),
                        "--device", "cuda", "--log", str(tmp_path / "log")])
    assert ei.value.code == 1
    assert "no CUDA device is available" in (tmp_path / "log").read_text()
    assert not (tmp_path / "out.json").exists()
