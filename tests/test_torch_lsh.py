"""parallel/lsh.py: the port's sharded ranking and search against
hulk_tpu's, on the same seeded inputs. hulk_tpu runs on its 8-device CPU
mesh (conftest); the port on a mesh of CPU devices (plain PyTorch).
Tolerance: exact equality (similarities are integer counts over s)."""
import numpy as np
import pytest
import torch

from hulk_tpu.index.lshforest import LSHForest as JaxForest
from hulk_tpu.parallel import lsh as jax_plsh
from hulk_tpu.parallel.mesh import make_sketch_mesh as jax_mesh
from hulk_tpu_torch.index.lshforest import LSHForest
from hulk_tpu_torch.parallel import lsh
from hulk_tpu_torch.parallel.mesh import make_sketch_mesh
from hulk_tpu_torch.synth import lsh_corpus

CPU8 = [torch.device("cpu")] * 8


def forests(mins, s, t, k=21):
    names = [f"s{i}" for i in range(mins.shape[0])]
    out = []
    for cls in (JaxForest, LSHForest):
        f = cls(kmer_size=k, sketch_size=s, jaccard_thresh=t)
        f.add_batch(names, mins)
        out.append(f)
    return out


def near_corpus(n, s, seed, value_range=2**40):
    """n rows of s mins below value_range; queries: rows 0 and 1 and a copy
    of row 0 with 2 slots drawn anew."""
    rng = np.random.default_rng(seed)
    mins = rng.integers(0, value_range, (n, s), dtype=np.uint64)
    q = mins[0].copy()
    q[rng.choice(s, 2, replace=False)] = rng.integers(0, value_range, 2, dtype=np.uint64)
    return mins, np.stack([mins[0], mins[1], q])


def test_make_sketch_mesh():
    assert make_sketch_mesh(devices=CPU8) == CPU8
    assert make_sketch_mesh(3, devices=["cpu"] * 4) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_sketch_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            make_sketch_mesh()


@pytest.mark.parametrize("devices", [CPU8, [torch.device("cpu")]], ids=["cpu8", "cpu1"])
@pytest.mark.parametrize("n,s", [(31, 42), (5000, 16), (8192, 42)])
def test_sharded_sims_equal_hulk_tpu(devices, n, s):
    """[Q, N] f64 sims, array for array, with every stripe padded (31 rows
    on 8 devices) or none; the padding never reaches the result."""
    mins, queries = near_corpus(n, s, seed=n + s, value_range=4)
    jf, pf = forests(mins, s, 0.5)
    want, wn = jax_plsh.sharded_sims(jax_mesh(n_dp=8, n_mp=1), jf, queries)
    got, gn = lsh.sharded_sims(devices, pf, queries)
    assert gn == wn == n and got.shape == (3, n) and got.dtype == np.float64
    assert np.array_equal(got, want)
    assert (got[0, 0], got[1, 1]) == (1.0, 1.0)


def test_rank_stripe_counts_u16(monkeypatch):
    """The device ranking's counts before the divide: u16, and equal to a
    plain broadcast count, over several blocks of queries and of rows, the
    last of each partial."""
    monkeypatch.setattr(lsh, "_QUERY_BLOCK", 16)
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(-3, 3, (lsh._CHUNK + 100, 42)))
    q = torch.from_numpy(rng.integers(-3, 3, (16 * 3 + 7, 42)))
    got = lsh.rank_stripe(q, rows)
    assert got.dtype == torch.uint16
    want = (q[:, None, :] == rows[None, :, :]).sum(-1)
    assert torch.equal(got.long(), want)


@pytest.mark.parametrize("branch", ["host", "device"])
def test_sharded_lsh_search_equal_hulk_tpu(branch, monkeypatch):
    """t = 0.9 on mins in [0, 2^40): sparse candidates, the host scoring.
    Mins in [0, 3) at t = 0.3: the candidates are 92% of Q*N (past 25%),
    the device ranking engages (in both packages), and many hits tie."""
    if branch == "host":
        mins, queries, _ = lsh_corpus(3000, 40, 42, seed=1)
        t = 0.9
    else:
        mins, queries = near_corpus(600, 42, seed=2, value_range=3)
        t = 0.3
    jf, pf = forests(mins, 42, t)
    monkeypatch.setitem(lsh.search_stats, "device_ranked", 0)
    got = lsh.sharded_lsh_search(CPU8, pf, queries, t)
    assert lsh.search_stats["device_ranked"] == (branch == "device")
    want = jax_plsh.sharded_lsh_search(jax_mesh(n_dp=8, n_mp=1), jf, queries, t)
    assert got == want
    assert got == [pf.search(q, t) for q in queries]
    assert lsh.sharded_lsh_search(None, pf, queries, t) == got
    assert sum(map(len, got)) >= len(queries)


@pytest.mark.parametrize("topk", [1, 16, 128])
def test_multiprocess_lsh_search_one_rank(topk):
    mins, queries, qidx = lsh_corpus(3000, 12, 16, seed=0)
    jf, pf = forests(mins, 16, 0.5, k=11)
    ids = np.arange(3000, dtype=np.int64)
    got = lsh.multiprocess_lsh_search(pf, queries, ids, topk=topk)
    assert got == jax_plsh.multiprocess_lsh_search(jf, queries, ids, topk=topk)
    for qi, hits in enumerate(got):
        assert 0 < len(hits) <= topk and hits[0][0] == int(qidx[qi])


def test_scale_recall_vs_bruteforce_device_ranking():
    """BASELINE config 5's acceptance at 20k x 200 (tests/test_lshforest.py's
    case): recall >= 0.95 against the brute-force ranking, precision 1.0,
    and every returned similarity equal to the brute force's."""
    S, t, n, nq = 42, 0.9, 20_000, 200
    rng = np.random.default_rng(7)
    mins = rng.integers(0, 2**40, (n, S), dtype=np.uint64)
    qidx = rng.choice(n, nq, replace=False)
    queries = mins[qidx].copy()
    for qi in range(nq):
        ch = rng.choice(S, 2, replace=False)
        queries[qi, ch] = rng.integers(0, 2**40, 2, dtype=np.uint64)
    forest = LSHForest(kmer_size=21, sketch_size=S, jaccard_thresh=t)
    forest.add_batch([f"s{i}" for i in range(n)], mins)

    results = lsh.sharded_lsh_search(CPU8, forest, queries, thresh=t)
    sims, _ = lsh.sharded_sims(CPU8, forest, queries)
    n_truth = n_hit = 0
    for qi in range(nq):
        truth = set(np.flatnonzero(sims[qi] >= t))
        got = set(int(nm[1:]) for nm, _ in results[qi])
        assert got <= truth
        n_truth += len(truth)
        n_hit += len(got & truth)
        for nm, v in results[qi]:
            assert v == sims[qi, int(nm[1:])]
    assert n_truth >= nq
    assert n_hit / n_truth >= 0.95
