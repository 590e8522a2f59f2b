"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test decides inside itself whether a card is present and
skips here, on a machine without one. These tests import only the port,
torch and numpy (no JAX), so they also run on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: bit-equality (integer arithmetic, and f64 operations rounded once
each to nearest on both sides).
"""
import numpy as np
import pytest
import torch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("R,L,k,w", [(2048, 160, 21, 9), (64, 300, 31, 2),
                                     (64, 300, 5, 64), (8, 3000, 21, 9), (1, 65536, 21, 9)])
def test_minimizer_kernel_matches_plain(R, L, k, w):
    from hulk_tpu_torch.ops.minimizer import minimizer_window_torch
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_cuda

    dev = _card()
    rng = np.random.default_rng(R + L + k + w)
    codes = rng.integers(0, 5, size=(R, L), dtype=np.uint8)
    lengths = rng.integers(1, L + 1, size=R).astype(np.int32)
    c, ln = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    wm, rep = minimizer_window_cuda(c, ln, k, w)
    wm0, rep0 = minimizer_window_torch(c, ln, k, w)
    assert torch.equal(rep, rep0)
    assert torch.equal(wm, wm0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 2000, 194481, 2**31 - 1])
def test_jump_kernel_matches_plain(n):
    from hulk_tpu_torch.hashes.jumphash import jump_hash_torch
    from hulk_tpu_torch.ops.jump_cuda import jump_hash_cuda

    dev = _card()
    keys = torch.from_numpy(np.random.default_rng(n).integers(
        -(2**63), 2**63 - 1, size=100_000, dtype=np.int64)).to(dev)
    assert torch.equal(jump_hash_cuda(keys, n), jump_hash_torch(keys, n))


# the cases chip_smoke.py holds the packed kernel to (R, L, k, w, lo, hi,
# rows with a read): the production batch, corners, and the FASTA path's
# top length bucket at its most rows and padded with empty rows
PACKED_CASES = [(16384, 160, 21, 9, 120, 160, 16384), (256, 200, 31, 2, 40, 200, 256),
                (256, 304, 5, 64, 60, 304, 256), (64, 5000, 21, 9, 100, 5000, 64),
                (128, 96, 3, 20, 1, 96, 128), (512, 65536, 21, 9, 16385, 65536, 512),
                (64, 65536, 21, 9, 16385, 65536, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,L,k,w,lo,hi,live", PACKED_CASES)
def test_packed_minimizer_kernel_matches_plain(R, L, k, w, lo, hi, live):
    from hulk_tpu_torch.ops.minimizer import minimizer_window_packed_torch
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_packed_cuda
    from hulk_tpu_torch.synth import kernel_batch

    dev = _card()
    _, lengths, codes2, mask8 = kernel_batch(np.random.default_rng(R + L + k + w), R, L, lo, hi,
                                             live=live)
    c2, m8, ln = (torch.from_numpy(a).to(dev) for a in (codes2, mask8, lengths))
    wm, rep = minimizer_window_packed_cuda(c2, m8, ln, k, w)
    wm0, rep0 = minimizer_window_packed_torch(c2, m8, ln, k, w)
    assert torch.equal(rep, rep0)
    assert torch.equal(wm, wm0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [194481, 2**31 - 1])
@pytest.mark.parametrize("kind", ["mixed", "all_sentinel", "dup_only"])
def test_bin_scatter_kernel_matches_plain(kind, n):
    from hulk_tpu_torch.ops.device_step import bin_scatter_keys_torch
    from hulk_tpu_torch.ops.jump_cuda import bin_scatter_keys_cuda
    from hulk_tpu_torch.synth import sorted_keys

    dev = _card()
    n_keys = {"mixed": 200_000, "all_sentinel": 0, "dup_only": 5000}[kind]
    keys = sorted_keys(np.random.default_rng(n_keys), n_keys, 50, dup_only=kind == "dup_only")
    skeys = torch.from_numpy(keys.view(np.int64)).to(dev)
    got = torch.zeros(n, dtype=torch.int32, device=dev)
    bin_scatter_keys_cuda(got, skeys, 50)
    want = torch.zeros(n, dtype=torch.int32, device=dev)
    bin_scatter_keys_torch(want, skeys, 50)
    assert torch.equal(got, want)
    del got, want


@pytest.mark.gpu
@pytest.mark.parametrize("k,w,live", [(21, 9, 16), (31, 2, 16), (21, 9, 3)])
def test_cont_minimizer_kernel_matches_plain(k, w, live):
    """The cont form on long-read blocks [16, 65536], random pad; with 3
    live rows, as a contig of up to 200 kb fills a group."""
    from hulk_tpu_torch.ops.minimizer import minimizer_window_torch
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_cuda
    from hulk_tpu_torch.synth import kernel_batch

    dev = _card()
    codes, lengths, _, _ = kernel_batch(np.random.default_rng(k + w), 16, 65536, 100, 65536,
                                        live=live)
    c, ln = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    wm, rep = minimizer_window_cuda(c, ln, k, w, cont=True)
    wm0, rep0 = minimizer_window_torch(c, ln, k, w, cont=True)
    assert rep0.any()
    assert torch.equal(rep, rep0)
    assert torch.equal(wm, wm0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 923521, 2**31 - 1])
@pytest.mark.parametrize("kind", ["mixed", "all_sentinel", "one_key"])
def test_bin_scatter_values_kernel_matches_plain(kind, n):
    from hulk_tpu_torch.ops.device_step import bin_scatter_values_torch
    from hulk_tpu_torch.ops.jump_cuda import bin_scatter_values_cuda
    from hulk_tpu_torch.synth import sorted_values

    dev = _card()
    n_vals = {"mixed": 200_000, "all_sentinel": 0, "one_key": 5000}[kind]
    vals = sorted_values(np.random.default_rng(n_vals), n_vals, one_key=kind == "one_key")
    svals = torch.from_numpy(vals.view(np.int64)).to(dev)
    got = torch.zeros(n, dtype=torch.int32, device=dev)
    bin_scatter_values_cuda(got, svals)
    want = torch.zeros(n, dtype=torch.int32, device=dev)
    bin_scatter_values_torch(want, svals)
    assert int(want.sum()) == int((vals != np.uint64(2**64 - 1)).sum())
    assert torch.equal(got, want)
    del got, want


@pytest.mark.gpu
def test_two_sort_batch_values_kernel_matches_plain():
    """The values entry on a k=31 two-sort batch (values reach bit 63)."""
    from hulk_tpu_torch.ops.device_step import bin_scatter_values_torch, sorted_batch_values
    from hulk_tpu_torch.ops.jump_cuda import bin_scatter_values_cuda
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_packed_cuda
    from hulk_tpu_torch.synth import kernel_batch

    dev = _card()
    _, lengths, codes2, mask8 = kernel_batch(np.random.default_rng(31), 2048, 160, 120, 160)
    c2, m8, ln = (torch.from_numpy(a).to(dev) for a in (codes2, mask8, lengths))
    svals, cnt = sorted_batch_values(*minimizer_window_packed_cuda(c2, m8, ln, 31, 9))
    assert bool((svals[:cnt] < 0).any())  # bit 63 set
    got = torch.zeros(923521, dtype=torch.int32, device=dev)
    want = torch.zeros_like(got)
    bin_scatter_values_cuda(got, svals)
    bin_scatter_values_torch(want, svals)
    assert int(want.sum()) == cnt
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_sketch_card_matches_cpu(tmp_path, monkeypatch):
    from hulk_tpu_torch import cli
    from hulk_tpu_torch.synth import generate

    _card()
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    fq = generate(str(tmp_path / "r.fq.gz"), 20_000, seed=3)
    for dev in ("cuda", "cpu"):
        assert cli.main(["sketch", "-f", fq, "-k", "11", "-w", "5",
                         "-o", str(tmp_path / dev), "--device", dev]) == 0
    assert (tmp_path / "cuda.json").read_bytes() == (tmp_path / "cpu.json").read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [["--kmv", "--khf", "--hmh", "-i", "7000"],
                                   ["-k", "31", "-s", "8", "--kmv"], ["--fasta"]])
def test_sketch_options_card_match_cpu(extra, tmp_path, monkeypatch):
    """Secondary sketches, the two-sort step (k=31) and FASTA with contigs
    past 65,536 bases (the long-read blocks): card and CPU agree."""
    from hulk_tpu_torch import cli
    from hulk_tpu_torch.synth import generate, generate_fasta

    _card()
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    if "--fasta" in extra:
        src = generate_fasta(str(tmp_path / "c.fa"), 12, lo=1000, hi=200_000, seed=4)
    else:
        src = generate(str(tmp_path / "r.fq.gz"), 20_000, seed=3)
    for dev in ("cuda", "cpu"):
        assert cli.main(["sketch", "-f", src, "-k", "11", "-w", "5", *extra,
                         "-o", str(tmp_path / dev), "--device", dev]) == 0
    assert (tmp_path / "cuda.json").read_bytes() == (tmp_path / "cpu.json").read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("prior", [False, True])
def test_device_flush_candidates_card_match_cpu(prior, tmp_path, monkeypatch):
    """The flush's candidate stage (plain PyTorch) on the card against the
    CPU: cms_out and every live bin's estimate bit-equal, and the flush
    applied from the card's candidates bit-identical to the exact host
    flush."""
    from hulk_tpu_torch.parallel import mesh
    from hulk_tpu_torch.sketch.countmin import cms_row_bins_table
    from hulk_tpu_torch.sketch.histosketch import HistoSketch

    dev = _card()
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    k, s, n = 11, 16, 11 ** 4
    rng = np.random.default_rng(int(prior))
    hist = np.where(rng.random(n) < 0.35, rng.integers(1, 60, n), 0).astype(np.int32)
    hs = HistoSketch(k, s, n, 1.0)
    if prior:
        ids = np.sort(rng.choice(n, 3000, replace=False)).astype(np.int64)
        hs.add_elements(ids, rng.integers(1, 9, 3000).astype(np.float64))
    rows = cms_row_bins_table(n, *hs.cms.sketch.shape).astype(np.int64)
    args = [hist, rows, hs.cms.sketch, hs.cws.c, hs.cws.b, hs.cws.exp_r]
    cpu = mesh.device_flush_candidates(*(torch.tensor(a) for a in args))
    card = [x.cpu() for x in mesh.device_flush_candidates(
        *(torch.tensor(a, device=dev) for a in args))]
    assert torch.equal(card[0], cpu[0])
    for j in range(s):  # the estimates of the bins both picked
        both, a, b = np.intersect1d(card[1][j].numpy(), cpu[1][j].numpy(), return_indices=True)
        assert both.size and torch.equal(card[2][j][a], cpu[2][j][b])
    host = HistoSketch(k, s, n, 1.0, tables=hs.cws)
    host.cms.sketch = hs.cms.sketch.copy()
    host.sketch, host.sketch_weights = hs.sketch.copy(), hs.sketch_weights.copy()
    live = np.nonzero(hist)[0].astype(np.int64)
    host.add_elements(live, hist[live].astype(np.float64))
    assert hs.apply_flush_candidates(*(x.numpy() for x in card[1:]), mesh.FLUSH_TOP_T)
    assert np.array_equal(hs.sketch, host.sketch)
    assert np.array_equal(hs.sketch_weights.view(np.uint64), host.sketch_weights.view(np.uint64))
    assert np.array_equal(card[0].numpy(), host.cms.sketch)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["weightedjaccard", "jaccard"])
def test_smash_matrix_card_matches_cpu(metric, tmp_path):
    """smash past 64 sketches (the blocked device matrix): the CSV from the
    card equals the CPU's."""
    from hulk_tpu_torch import cli
    from hulk_tpu_torch.synth import sketch_jsons

    _card()
    sketch_jsons(str(tmp_path), 300, s=42, families=8, seed=5)
    for dev in ("cuda", "cpu"):
        assert cli.main(["smash", "-d", str(tmp_path), "-m", metric, "-o",
                         str(tmp_path / f"m_{dev}"), "--device", dev]) == 0
    want = (tmp_path / "m_cpu.hulk-matrix.csv").read_bytes()
    assert (tmp_path / "m_cuda.hulk-matrix.csv").read_bytes() == want


@pytest.mark.gpu
def test_interval_device_flush_card_matches_cpu(tmp_path, monkeypatch):
    """-i with --deviceFlush and --checkpoint: the background flush worker
    drives the card's candidate stage while the next interval streams; the
    out.json and the checkpoint equal the CPU's, with no margin fallback."""
    from hulk_tpu_torch import cli
    from hulk_tpu_torch.stream import pipeline
    from hulk_tpu_torch.synth import generate

    _card()
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setitem(pipeline.flush_stats, "margin_fallbacks", 0)
    fq = generate(str(tmp_path / "r.fq.gz"), 20_000, seed=6)
    for dev in ("cuda", "cpu"):
        assert cli.main(["sketch", "-f", fq, "-k", "11", "-w", "5", "-i", "3000",
                         "--deviceFlush", "--checkpoint", str(tmp_path / f"{dev}.npz"),
                         "-o", str(tmp_path / dev), "--device", dev]) == 0
    assert (tmp_path / "cuda.json").read_bytes() == (tmp_path / "cpu.json").read_bytes()
    a, b = np.load(tmp_path / "cuda.npz"), np.load(tmp_path / "cpu.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[f], b[f]) for f in a.files)
    assert pipeline.flush_stats["margin_fallbacks"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,nq", [(31, 3), (20_000, 200), (9000, 700)])
def test_sharded_sims_card_matches_cpu(n, nq):
    """The LSH ranking on the card (every visible card, and cuda:0 alone)
    against the CPU's plain run: the same [Q, N] similarities, padding
    dropped; 700 queries take several query blocks a step."""
    from hulk_tpu_torch.index.lshforest import LSHForest
    from hulk_tpu_torch.parallel.lsh import sharded_sims
    from hulk_tpu_torch.parallel.mesh import make_sketch_mesh
    from hulk_tpu_torch.synth import lsh_corpus

    dev = _card()
    mins, queries, qidx = lsh_corpus(n, nq, 42, seed=n)
    mins[: n // 2, :21] = 3  # half the rows share half their slots
    queries[qidx < n // 2, :21] = 3
    forest = LSHForest(kmer_size=21, sketch_size=42, jaccard_thresh=0.9)
    forest.add_batch([f"s{i}" for i in range(n)], mins)
    want, _ = sharded_sims([torch.device("cpu")], forest, queries)
    for devices in (make_sketch_mesh(), [dev]):
        got, got_n = sharded_sims(devices, forest, queries)
        assert got_n == n and np.array_equal(got, want)
    assert (want[np.arange(nq), qidx] >= 40 / 42).all()
