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
@pytest.mark.parametrize("L,k,w,cap", [(65_536, 21, 9, None), (200_000, 31, 2, None),
                                       (200_000, 21, 9, 65_536), (5000, 15, 5, 100),
                                       (29, 21, 9, None)])
def test_record_scan_kernel_matches_cpu(L, k, w, cap):
    """The record scan on the card (random pad past the record; a cap puts
    the chunks after the first through the cont form) against the plain
    version on the CPU: the same run heads, sorted."""
    from hulk_tpu_torch._u64 import usort
    from hulk_tpu_torch.ops.longread import record_heads, record_heads_torch
    from hulk_tpu_torch.ops.minimizer_cuda import RECORD_CAP

    dev = _card()
    rng = np.random.default_rng(L + k + w)
    buf = rng.integers(0, 256, size=L + 4096, dtype=np.uint8)
    buf[:L] = np.where(rng.random(L) < 0.01, 4, rng.integers(0, 4, size=L))
    heads, count = record_heads(torch.from_numpy(buf).to(dev)[:L], k=k, w=w, cap=cap)
    want = record_heads_torch(torch.from_numpy(buf[:L]), k=k, w=w, cap=cap or RECORD_CAP)
    assert int(count) == want.numel() > 0
    assert torch.equal(usort(heads[:int(count)]).cpu(), usort(want))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 194481, 923521])
@pytest.mark.parametrize("kind", ["mixed", "all_sentinel", "one_key"])
def test_dedup_values_kernel_matches_cpu(kind, n):
    """The values entry's dedup form with its count on the card against the
    plain version on the CPU."""
    from hulk_tpu_torch.ops.device_step import bin_scatter_values_torch
    from hulk_tpu_torch.ops.jump_cuda import bin_scatter_values_cuda
    from hulk_tpu_torch.synth import sorted_values

    dev = _card()
    n_vals = {"mixed": 200_000, "all_sentinel": 0, "one_key": 5000}[kind]
    vals = torch.from_numpy(sorted_values(np.random.default_rng(n_vals), n_vals,
                                          one_key=kind == "one_key").view(np.int64))
    got = torch.zeros(n, dtype=torch.int32, device=dev)
    got_count = torch.zeros((), dtype=torch.int64, device=dev)
    bin_scatter_values_cuda(got, vals.to(dev), dedup=True, count=got_count)
    want = torch.zeros(n, dtype=torch.int32)
    want_count = torch.zeros((), dtype=torch.int64)
    bin_scatter_values_torch(want, vals, dedup=True, count=want_count)
    assert int(want_count) == int(want.sum()) == np.unique(vals.numpy()[vals.numpy() != -1]).size
    assert int(got_count) == int(want_count)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_long_read_step_card_matches_cpu():
    """One 150 kb record through the long-read step with the three sketches,
    on the card and on the CPU: the same histogram, count and states."""
    from hulk_tpu_torch.ops.device_sketches import SketchStates
    from hulk_tpu_torch.ops.longread import long_read_step, to_device

    dev = _card()
    rng = np.random.default_rng(150)
    codes = np.where(rng.random(150_000) < 0.01, 4,
                     rng.integers(0, 4, size=150_000)).astype(np.uint8)
    out = {}
    for d in (dev, torch.device("cpu")):
        hist = torch.zeros(923521, dtype=torch.int32, device=d)
        count = torch.zeros((), dtype=torch.int64, device=d)
        st = SketchStates.empty(42, kmv=True, khf=True, hmh=True, device=d)
        long_read_step(hist, count, st, to_device(codes, d), k=31, w=9)
        out[d.type] = [t.cpu() for t in (hist, count, st.kmv, st.khf, st.hmh)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_long_read_step_syncs_once():
    """The long-read step on the card reads the run heads' count back and
    makes no other host sync (torch's sync debug mode), sketches on."""
    import warnings

    from hulk_tpu_torch.ops.device_sketches import SketchStates
    from hulk_tpu_torch.ops.longread import long_read_step, to_device

    dev = _card()
    codes = np.random.default_rng(7).integers(0, 5, size=100_000).astype(np.uint8)
    hist = torch.zeros(194481, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    st = SketchStates.empty(42, kmv=True, khf=True, hmh=True, device=dev)
    long_read_step(hist, count, st, to_device(codes, dev), k=21, w=9)  # warm-up
    c = to_device(codes, dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            long_read_step(hist, count, st, c, k=21, w=9)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert sum("called a synchronizing" in str(w.message) for w in caught) == 1


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
    cnt = int(cnt)
    assert bool((svals[:cnt] < 0).any())  # bit 63 set
    for part in (svals, svals[:cnt]):  # the whole SENT-tailed buffer, the live prefix
        got = torch.zeros(923521, dtype=torch.int32, device=dev)
        want = torch.zeros_like(got)
        got_c = torch.zeros((), dtype=torch.int64, device=dev)
        want_c = torch.zeros_like(got_c)
        bin_scatter_values_cuda(got, part, count=got_c)
        bin_scatter_values_torch(want, part, count=want_c)
        assert int(want.sum()) == int(want_c) == cnt
        assert torch.equal(got, want)
        assert torch.equal(got_c, want_c)


@pytest.mark.gpu
def test_two_sort_group_step_makes_no_host_sync():
    """Without sketches the two-sort group step bins the whole buffer and
    counts on the card: no host sync (torch's sync debug mode "error"); the
    histogram and count equal the CPU's."""
    from hulk_tpu_torch import native
    from hulk_tpu_torch.ops.device_step import group_scan_body, stream_bucket

    dev = _card()
    g, r, l, k, w = 2, 2048, 160, 31, 9
    rng = np.random.default_rng(11)
    pairs = [(rng.integers(0, 5, size=(r, l)).astype(np.uint8),
              rng.integers(40, l + 1, size=r).astype(np.int32)) for _ in range(g)]
    flat = torch.from_numpy(native.pack_group2(pairs, g, r, l))
    kw = dict(g=g, r=r, l=l, k=k, w=w, bucket=stream_bucket(r, r * l, l=l, k=k, w=w))
    out = {}
    for d in (dev, torch.device("cpu")):
        hist = torch.zeros(923521, dtype=torch.int32, device=d)
        count = torch.zeros((), dtype=torch.int64, device=d)
        buf = flat.to(d)
        if d.type == "cuda":
            group_scan_body(hist.clone(), count.clone(), buf, **kw)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            group_scan_body(hist, count, buf, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[d.type] = (hist.cpu(), count.cpu())
    assert int(out["cpu"][1]) > 0
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 194481, 923521, 2**31 - 1])
def test_jump_entries_at_the_loops_boundaries(n):
    """Keys whose loop meets a quotient within 2^-20 of an integer (where
    the kernel's filtered step hands over to its exact one) and the
    adversarial keys, through all four jump entries, against the plain
    versions; the counting form takes the plain loop's iterations."""
    from hulk_tpu_torch._u64 import usort
    from hulk_tpu_torch.hashes.jumphash import jump_hash_torch
    from hulk_tpu_torch.ops import jump_cuda as jc
    from hulk_tpu_torch.ops.device_step import bin_scatter_keys_torch, bin_scatter_values_torch
    from hulk_tpu_torch.synth import jump_adversarial_keys, jump_boundary_keys

    dev = _card()
    raw = np.concatenate([jump_adversarial_keys(), jump_boundary_keys(np.random.default_rng(0))])
    keys = torch.from_numpy(raw.view(np.int64)).to(dev)
    assert torch.equal(jc.jump_hash_cuda(keys, n), jump_hash_torch(keys, n))
    tail = torch.full((64,), -1, dtype=torch.int64, device=dev)
    svals = torch.cat([usort(torch.cat([keys, keys[::3]])), tail])
    for dedup in (False, True):
        got, want = (torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(2))
        got_c, want_c = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
        jc.bin_scatter_values_cuda(got, svals, dedup=dedup, count=got_c)
        bin_scatter_values_torch(want, svals, dedup=dedup, count=want_c)
        assert torch.equal(got, want)
        assert torch.equal(got_c, want_c)
        del got, want
    skeys = torch.cat([usort(keys[keys >= 0]), tail])
    got, want = (torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(2))
    jc.bin_scatter_keys_cuda(got, skeys, 63)
    bin_scatter_keys_torch(want, skeys, 63)
    assert torch.equal(got, want)
    del got, want
    total, exact = jc.jump_steps_cuda(keys, n)
    j, iterations = np.zeros(raw.size, dtype=np.int64), 0
    key, live = raw.copy(), np.ones(raw.size, dtype=bool)
    while live.any():  # Go's loop, counting its iterations
        iterations += int(live.sum())
        key[live] = key[live] * np.uint64(2862933555777941757) + np.uint64(1)
        d = ((key[live] >> np.uint64(33)) + np.uint64(1)).astype(np.float64)
        nxt = ((j[live] + 1).astype(np.float64) * (2147483648.0 / d)).astype(np.int64)
        idx = np.flatnonzero(live)
        j[idx] = np.where(nxt < n, nxt, j[idx])
        live[idx[nxt >= n]] = False
    assert total == iterations
    assert 0 < exact < total


@pytest.mark.gpu
def test_jump_seed_error_within_the_proofs_bound():
    from hulk_tpu_torch.ops import jump_cuda as jc

    e = jc.seed_error_cuda(_card())
    assert 0 < e <= jc.SEED_ERROR_BOUND


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
    drives the card's exact flush while the next interval streams, and the
    CPU runs the same route in its plain versions; the out.json and the
    checkpoint equal the CPU's."""
    from hulk_tpu_torch import cli
    from hulk_tpu_torch.synth import generate

    _card()
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    fq = generate(str(tmp_path / "r.fq.gz"), 20_000, seed=6)
    for dev in ("cuda", "cpu"):
        assert cli.main(["sketch", "-f", fq, "-k", "11", "-w", "5", "-i", "3000",
                         "--deviceFlush", "--checkpoint", str(tmp_path / f"{dev}.npz"),
                         "-o", str(tmp_path / dev), "--device", dev]) == 0
    assert (tmp_path / "cuda.json").read_bytes() == (tmp_path / "cpu.json").read_bytes()
    a, b = np.load(tmp_path / "cuda.npz"), np.load(tmp_path / "cpu.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[f], b[f]) for f in a.files)


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


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(kmv=True, khf=True, hmh=True, interval=7000),
                                dict(kmer_size=31, sketch_size=8, kmv=True),
                                dict(interval=3000, device_flush=True)])
def test_sharded_pipeline_card_matches_cpu(kw, tmp_path, monkeypatch):
    """The data-parallel stream on a mesh that names the card twice, the
    flush's CWS tables striped over it (with and without --deviceFlush):
    out.json bytes equal one CPU device's."""
    from hulk_tpu_torch.stream.pipeline import SketchConfig, run_sketch_pipeline
    from hulk_tpu_torch.synth import generate

    dev = _card()
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    fq = generate(str(tmp_path / "r.fq.gz"), 20_000, seed=7)
    kw = dict(dict(kmer_size=11, window_size=5), **kw)
    card = run_sketch_pipeline(None, SketchConfig(
        input_paths=[fq], device="cuda", devices=[dev, dev], **kw))
    cpu = run_sketch_pipeline(None, SketchConfig(input_paths=[fq], device="cpu", **kw))
    assert card.hulk_data.to_json_bytes() == cpu.hulk_data.to_json_bytes()
    assert card.minimizer_count == cpu.minimizer_count


@pytest.mark.gpu
def test_sharded_histogram_step_card_matches_cpu():
    """sharded_histogram_step over [card, card]: the u8 minimizer and
    hulk_jump_hash kernels give the CPU's histogram and count."""
    from hulk_tpu_torch.ops import jump_cuda
    from hulk_tpu_torch.parallel import mesh
    from hulk_tpu_torch.synth import kernel_batch

    dev = _card()
    codes, lengths, _, _ = kernel_batch(np.random.default_rng(8), 1000, 160, 60, 160)
    before = jump_cuda.launches["jump_hash"]
    card = mesh.sharded_histogram_step([dev, dev], 9 ** 4, 9, 5)(codes, lengths)
    cpu = mesh.sharded_histogram_step([torch.device("cpu")], 9 ** 4, 9, 5)(codes, lengths)
    assert jump_cuda.launches["jump_hash"] == before + 2
    assert torch.equal(card[0].cpu(), cpu[0]) and int(card[1]) == int(cpu[1]) > 0


def _drift_inputs(seed: int, nbins: int, live: float):
    """A histogram with a `live` share of bins used (counts 1-299), its
    live ids, counts and CMS rows, a CMS carried in, and dw = Go's
    exp(-0.9)."""
    from hulk_tpu_torch.hashes.fdlibm import go_exp
    from hulk_tpu_torch.sketch.countmin import cms_row_bins_table, cms_shape

    rng = np.random.default_rng(seed)
    depth, width = cms_shape()
    hist = np.where(rng.random(nbins) < live, rng.integers(1, 300, nbins), 0)
    ids = np.nonzero(hist)[0]
    cms = np.where(rng.random((depth, width)) < 0.3, rng.integers(1, 50, (depth, width)), 0)
    rows = np.ascontiguousarray(cms_row_bins_table(nbins, depth, width)[:, ids], dtype=np.int64)
    return (torch.from_numpy(hist[ids].astype(np.float64)), torch.from_numpy(rows),
            torch.from_numpy(cms.astype(np.float64)), torch.from_numpy(ids.astype(np.int64)),
            float(go_exp(-0.9)))


@pytest.mark.gpu
@pytest.mark.parametrize("nbins,live", [(9 ** 4, 0.5), (9 ** 4, 1.0), (21 ** 4, 0.01),
                                        (9 ** 4, 0.01), (9 ** 4, 0.0)])
def test_drift_kernels_match_plain(nbins, live):
    """hulk_cms_drift_scan and hulk_drift_select against their plain
    versions on the card: the CMS, the estimates, the sketch and the weights
    bit-equal, from a half-filled sketch."""
    from hulk_tpu_torch.ops import flush_drift as fd
    from hulk_tpu_torch.ops import flush_drift_cuda as fdc

    dev = _card()
    freqs, rows, cms, ids, dw = (x.to(dev) if torch.is_tensor(x) else x
                                 for x in _drift_inputs(nbins, nbins, live))
    cms_k, esti_k = fdc.cms_drift_scan_cuda(freqs, rows, cms, dw)
    cms_p, esti_p = fd.cms_drift_scan_torch(freqs, rows, cms, dw)
    assert torch.equal(cms_k, cms_p) and torch.equal(esti_k, esti_p)
    rng = np.random.default_rng(nbins)
    s = 42
    aka = torch.from_numpy(rng.exponential(size=(s, ids.shape[0])) / esti_p.cpu().numpy()).to(dev)
    sk = torch.from_numpy(np.where(rng.random(s) < 0.5, rng.integers(0, nbins, s), 0)).to(dev)
    w = torch.from_numpy(np.where(sk.cpu().numpy() > 0, rng.random(s) * 1e-3,
                                  np.finfo(np.float64).max)).to(dev)
    got = fdc.drift_select_cuda(aka, ids, sk, w, dw)
    want = fd.drift_select_torch(aka, ids, sk, w, dw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_drift_kernels_match_plain_on_corner_cases():
    """The same two entries on synth's corner cases of their designs (the
    scan's warp layout and tile edges; the selection's chunk skip, with
    ties, +inf, NaN, Aka strictly decreasing and a walk past 32 chunks):
    bit-equal to the plain versions."""
    from hulk_tpu_torch.hashes.fdlibm import go_exp
    from hulk_tpu_torch.ops import flush_drift as fd
    from hulk_tpu_torch.ops import flush_drift_cuda as fdc
    from hulk_tpu_torch.synth import drift_scan_cases, drift_select_cases

    dev = _card()
    dw = float(go_exp(-0.9))
    for _, hist, table, cms in drift_scan_cases(np.random.default_rng(14)):
        ids = np.flatnonzero(hist)
        freqs = torch.from_numpy(hist[ids].astype(np.float64)).to(dev)
        rows = torch.from_numpy(np.ascontiguousarray(table[:, ids])).to(dev)
        cms = torch.from_numpy(cms).to(dev)
        got, want = fdc.cms_drift_scan_cuda(freqs, rows, cms, dw), \
            fd.cms_drift_scan_torch(freqs, rows, cms, dw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for _, aka, sk, w in drift_select_cases(np.random.default_rng(15), dw):
        args = [torch.from_numpy(x).to(dev) for x in
                (aka, 5 * np.arange(aka.shape[1], dtype=np.int64) + 3, sk, w)]
        want = fd.drift_select_torch(*args, dw)
        got = fdc.drift_select_cuda(*args, dw)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int64), want[1].view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("drift", [False, True])
def test_sharded_flush_step_card_matches_cpu(drift):
    """sharded_flush_step over [card, card] against [cpu, cpu] on a k=9
    histogram, two flushes: the CMS, the bins and the weights bit-equal
    (Go's Exp and Log in the Aka kernel and in the plain version)."""
    from hulk_tpu_torch.hashes.cws import build_cws_tables
    from hulk_tpu_torch.hashes.fdlibm import go_exp
    from hulk_tpu_torch.parallel import mesh
    from hulk_tpu_torch.sketch.countmin import cms_row_bins_table, cms_shape

    dev, cpu = _card(), torch.device("cpu")
    nbins, s = 9 ** 4, 8
    depth, width = cms_shape()
    tables = build_cws_tables(s, nbins)
    rb = torch.from_numpy(cms_row_bins_table(nbins, depth, width).astype(np.int64))
    rng = np.random.default_rng(5)
    hists = [torch.from_numpy(np.where(rng.random(nbins) < 0.3, rng.integers(1, 300, nbins),
                                       0).astype(np.int32)) for _ in range(2)]
    dw = float(go_exp(-0.9)) if drift else 0.0
    outs = []
    for d in (dev, cpu):
        step = mesh.sharded_flush_step([d, d], dw, drift, depth, width)
        stripes = mesh.shard_tables([d, d], tables)
        state = (torch.zeros(depth, width, dtype=torch.float64, device=d),
                 torch.zeros(s, dtype=torch.int64, device=d),
                 torch.full((s,), np.finfo(np.float64).max, dtype=torch.float64, device=d))
        for h in hists:
            state = step(h.to(d), rb.to(d), *state, stripes)
        outs.append([x.cpu() for x in state])
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2].view(torch.int64), outs[1][2].view(torch.int64))


@pytest.mark.gpu
def test_entry_card_matches_cpu():
    """entry()'s fn on the card (u8 minimizer and hulk_jump_hash once each)
    against the same fn on the CPU."""
    from hulk_tpu_torch.entry import entry
    from hulk_tpu_torch.ops import jump_cuda, minimizer_cuda

    _card()
    fn, args = entry()
    before = (minimizer_cuda.launches["minimizer_window"], jump_cuda.launches["jump_hash"])
    hist, count = fn(*args)
    assert (minimizer_cuda.launches["minimizer_window"],
            jump_cuda.launches["jump_hash"]) == (before[0] + 1, before[1] + 1)
    cfn, cargs = entry("cpu")
    chist, ccount = cfn(*cargs)
    assert torch.equal(hist.cpu(), chist) and int(count) == int(ccount) > 0


@pytest.mark.gpu
def test_drift_select_kernel_ties_at_the_threshold():
    """An Aka equal to weight / dw does not replace, one below it does (dw =
    0.5, exact thresholds), as in the plain version."""
    from hulk_tpu_torch.ops import flush_drift as fd
    from hulk_tpu_torch.ops import flush_drift_cuda as fdc

    dev = _card()
    aka = torch.tensor([[1.0, 2.0, 3.0], [1.0, 1.5, 2.5]], dtype=torch.float64, device=dev)
    args = (torch.tensor([10, 11, 12], device=dev), torch.zeros(2, dtype=torch.int64, device=dev),
            torch.full((2,), np.finfo(np.float64).max, dtype=torch.float64, device=dev), 0.5)
    got, want = fdc.drift_select_cuda(aka, *args), fd.drift_select_torch(aka, *args)
    assert got[0].tolist() == want[0].tolist() == [10, 12]
    assert got[1].tolist() == want[1].tolist() == [1.0, 2.5]


def _aka_tables(rng, s: int, nbins: int):
    """CWS-like tables [s, nbins] drawn as the reference draws them (r and
    the exponent of c from Gamma(2, 1), b = u * r), and exp(r)."""
    r = rng.gamma(2.0, 1.0, (s, nbins))
    return (np.log(rng.gamma(2.0, 1.0, (s, nbins))), rng.random((s, nbins)) * r, np.exp(r))


@pytest.mark.gpu
@pytest.mark.parametrize("nbins", [194481, 923521])
def test_cws_aka_kernel_matches_plain(nbins):
    """hulk_cws_aka against cws_aka_torch at 42 slots and every bin live, and
    estimates a drift flush leaves (counts decayed by Go's exp(-0.9)): bit
    for bit on the card, and on 2,000 bins against the plain version on the
    CPU."""
    from hulk_tpu_torch.hashes.fdlibm import go_exp
    from hulk_tpu_torch.ops import cws_aka_cuda
    from hulk_tpu_torch.ops.cws_aka import cws_aka_torch

    dev = _card()
    rng = np.random.default_rng(nbins)
    tabs = [torch.from_numpy(t) for t in _aka_tables(rng, 42, nbins)]
    esti = rng.integers(1, 5000, nbins) * float(go_exp(-0.9)) ** rng.integers(0, 3, nbins)
    esti, ids = torch.from_numpy(esti.astype(np.float64)), torch.arange(nbins)
    before = cws_aka_cuda.launches["cws_aka"]
    got = cws_aka_cuda.cws_aka_cuda(esti.to(dev), ids.to(dev), *(t.to(dev) for t in tabs))
    assert cws_aka_cuda.launches["cws_aka"] == before + 1
    want = cws_aka_torch(esti.to(dev), ids.to(dev), *(t.to(dev) for t in tabs))
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    part = torch.arange(0, nbins, nbins // 2000)[:2000]
    cpu = cws_aka_torch(esti[part], part, *tabs)
    assert torch.equal(got[:, part.to(dev)].cpu().view(torch.int64), cpu.view(torch.int64))


@pytest.mark.gpu
def test_cws_aka_kernel_on_exp_and_log_edges():
    """The kernel's Exp at the edges of its range (through b, with the
    estimate 1, c 1 and exp_r 1: Aka = 1 / Exp(-b)) and its Log at the edges
    of its (through the estimate, b 0): the plain version's bits, NaN as NaN."""
    from hulk_tpu_torch.hashes import fdlibm
    from hulk_tpu_torch.ops.cws_aka import cws_aka_torch
    from hulk_tpu_torch.ops.cws_aka_cuda import cws_aka_cuda

    dev = _card()
    big = np.finfo(np.float64).max
    exp_at = [fdlibm._OVERFLOW, fdlibm._UNDERFLOW, fdlibm._NEAR_ZERO, -fdlibm._NEAR_ZERO, 0.0,
              -708.4, -709.1, -740.0, -744.5, 709.5, np.inf, -np.inf, np.nan, big, -big]
    exp_at += [(m - 0.5) / fdlibm._LOG2E for m in (-1074, -1, 1, 1023, 1024)]
    exp_at += list(np.linspace(-746.0, 710.0, 4001))
    log_at = [0.0, 5e-324, 1e-310, 2.2250738585072014e-308, fdlibm._SQRT2_OVER_2, 0.5, 1.0,
              2.0, big, np.inf, np.nan, -1.0, -np.inf]
    log_at += list(np.exp(np.random.default_rng(3).uniform(-744.0, 709.0, 4000)))
    near = lambda v: [np.nextafter(v, -np.inf), v, np.nextafter(v, np.inf)]  # noqa: E731
    with np.errstate(over="ignore"):  # past the largest double: inf
        x = np.array([u for v in exp_at for u in near(v)])
        y = np.array([u for v in log_at for u in near(v)])
    esti = np.concatenate([np.ones_like(x), y])
    b = np.concatenate([-x, np.zeros_like(y)])[None, :]
    args = [torch.from_numpy(a).to(dev) for a in
            (esti, np.arange(esti.shape[0]), np.ones_like(b), b, np.ones_like(b))]
    got, want = cws_aka_cuda(*args), cws_aka_torch(*args)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int64), want[~nan].view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [["-i", "7000", "-x", "0.9", "--stream"],
                                   ["-i", "7000", "--stream"]])
def test_interval_card_flush_matches_cpu(extra, tmp_path, monkeypatch, capsys):
    """The stream's flushes on the card (the exact Aka, the drift scan with
    -x, each slot's selection) against --device cpu's host flush: each
    --stream snapshot on stdout and out.json byte-identical, every flush
    through the card's entries."""
    from hulk_tpu_torch import cli
    from hulk_tpu_torch.ops import cws_aka_cuda
    from hulk_tpu_torch.synth import generate

    _card()
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    fq = generate(str(tmp_path / "r.fq.gz"), 20_000, seed=7)
    got = {}
    for dev in ("cuda", "cpu"):
        before = cws_aka_cuda.launches["cws_aka"]
        capsys.readouterr()
        assert cli.main(["sketch", "-f", fq, "-k", "11", "-w", "5", *extra,
                         "-o", str(tmp_path / dev), "--device", dev]) == 0
        got[dev] = (capsys.readouterr().out, (tmp_path / f"{dev}.json").read_bytes(),
                    cws_aka_cuda.launches["cws_aka"] - before)
    assert got["cuda"][0].count('"signatures"') == 20_000 // 7000 + 1  # the snapshots, the last
    assert got["cuda"][:2] == got["cpu"][:2]
    assert (got["cuda"][2], got["cpu"][2]) == (20_000 // 7000 + 1, 0)
