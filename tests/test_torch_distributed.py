"""Runs of several processes (parallel/distributed.py, a gloo group): OS
processes of the port on this machine (--device cpu), each with a time
limit, against one process of the port and of hulk_tpu. Tolerance: equal
hit lists and byte-identical CSVs."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import hulk_tpu.cli as jax_cli
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu.index.lshforest import LSHForest as JaxForest
from hulk_tpu.parallel.lsh import multiprocess_lsh_search as jax_multiprocess_search
from hulk_tpu_torch.index.lshforest import LSHForest
from hulk_tpu_torch.parallel import distributed as dist
from hulk_tpu_torch.parallel.lsh import multiprocess_lsh_search
from hulk_tpu_torch.synth import lsh_corpus, sketch_jsons

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 180  # seconds a rank may take before the test fails


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, n: int, cwd) -> list:
    """Start n processes, rank r running argv(r), as one group; each must end
    within RANK_TIMEOUT (all are killed otherwise). Returns (rc, output) of
    each."""
    port = _free_port()
    env = dict(os.environ, HULK_COORDINATOR=f"127.0.0.1:{port}", HULK_NUM_PROCS=str(n))
    env["PYTHONPATH"] = REPO_ROOT + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen([sys.executable, *argv(r)], env=dict(env, HULK_PROC_ID=str(r)),
                              cwd=cwd, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(n)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, o.decode(errors="replace")) for p, o in zip(procs, outs)]


def test_helpers_without_a_group():
    """One process: world of 1, rank 0, allgather adds the leading axis."""
    x = np.arange(6, dtype=np.uint64).reshape(2, 3) << np.uint64(62)
    assert (dist.world_size(), dist.rank()) == (1, 0)
    assert np.array_equal(dist.allgather(x), x[None])
    assert np.array_equal(dist.allreduce_sum(x), x)
    assert dist.process_read_shard(["a", "b", "c"]) == ["a", "b", "c"]
    assert dist.init_distributed() is False  # no HULK_COORDINATOR here


def test_sharded_pairwise_wjd_equals_one_device():
    """Row blocks round robin over three devices, any row range: the cells
    of the one-device matrix, bit for bit."""
    import torch

    from hulk_tpu_torch.ops.distance import pairwise_weighted_jaccard_dist
    from hulk_tpu_torch.parallel.smash import sharded_pairwise_wjd, sharded_wjd_rows

    rng = np.random.default_rng(11)
    mins = rng.integers(0, 6, (70, 24)).astype(np.uint64)
    weights = rng.exponential(1.0, (70, 24))
    want = pairwise_weighted_jaccard_dist(mins, weights, device="cpu")
    cpu3 = [torch.device("cpu")] * 3
    got = sharded_pairwise_wjd(mins, weights, devices=cpu3, block=8, col_block=16)
    assert np.array_equal(got, want)
    rows = sharded_wjd_rows(mins, weights, 23, 51, devices=cpu3, block=8, col_block=16)
    assert np.array_equal(rows, want[23:51])
    assert (np.diag(want) == 0).all() and 0.5 < want.max() <= 1.0


_LSH_RANK = r"""
import json, sys
import numpy as np
from hulk_tpu_torch.index.lshforest import LSHForest
from hulk_tpu_torch.parallel import distributed as dist
from hulk_tpu_torch.parallel.lsh import multiprocess_lsh_search
from hulk_tpu_torch.synth import lsh_corpus

assert dist.init_distributed()
mins, queries, _ = lsh_corpus(3000, 12, 16, seed=0)
stripe = np.arange(3000)[dist.rank()::dist.world_size()]
forest = LSHForest(kmer_size=11, sketch_size=16, jaccard_thresh=0.5)
forest.add_batch([f"s{i}" for i in stripe], mins[stripe])
shapes = dist.allgather(np.array([dist.rank(), stripe.size], dtype=np.int64))
res = multiprocess_lsh_search(forest, queries, stripe.astype(np.int64), topk=128)
with open(sys.argv[1] + f".{dist.rank()}", "w") as fh:
    json.dump({"hits": res, "shapes": shapes.tolist()}, fh)
dist.shutdown()
"""


def test_two_rank_lsh_search(tmp_path):
    """Stripes p::2 of a 3,000-row corpus, top-128 per query: both ranks
    hold the merged result, equal to one process's over the whole corpus
    (the port's and hulk_tpu's)."""
    script = tmp_path / "rank.py"
    script.write_text(_LSH_RANK)
    out = str(tmp_path / "hits")
    for rc, text in run_ranks(lambda r: [str(script), out], 2, tmp_path):
        assert rc == 0, text[-3000:]
    mins, queries, qidx = lsh_corpus(3000, 12, 16, seed=0)
    names = [f"s{i}" for i in range(3000)]
    one = []
    for cls, search in ((LSHForest, multiprocess_lsh_search),
                        (JaxForest, jax_multiprocess_search)):
        f = cls(kmer_size=11, sketch_size=16, jaccard_thresh=0.5)
        f.add_batch(names, mins)
        one.append(search(f, queries, np.arange(3000, dtype=np.int64), topk=128))
    assert one[0] == one[1]
    want = json.loads(json.dumps(one[0]))
    for r in range(2):
        with open(f"{out}.{r}") as fh:
            doc = json.load(fh)
        assert doc["shapes"] == [[0, 1500], [1, 1500]]
        assert doc["hits"] == want
    assert all(hits[0][0] == int(q) for hits, q in zip(one[0], qidx))


@pytest.fixture(scope="module")
def pile(tmp_path_factory):
    """100 synthetic sketches: past 64, where the single-process CLIs take
    their device matrix."""
    d = tmp_path_factory.mktemp("dist_pile")
    sketch_jsons(str(d), 100, s=24, families=8, seed=5)
    return str(d)


@pytest.mark.parametrize("metric", ["weightedjaccard", "jaccard"])
def test_two_rank_smash(pile, tmp_path, metric):
    """weightedjaccard takes the split path (each rank loads half the files
    and computes half the rows), jaccard the fallback (each rank computes
    everything); in both, rank 0 alone writes the CSV, byte-identical to
    one process's (the port's and hulk_tpu's)."""
    argv = ["-m", "hulk_tpu_torch", "smash", "-d", pile, "-m", metric, "-o",
            str(tmp_path / "ranks"), "--device", "cpu", "--log"]
    for rc, text in run_ranks(lambda r: [*argv, str(tmp_path / f"rank{r}.log")], 2, tmp_path):
        assert rc == 0, text[-3000:]
    logs = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    csv = (tmp_path / "ranks.hulk-matrix.csv").read_bytes()

    assert torch_cli.main(["smash", "-d", pile, "-m", metric, "-o", str(tmp_path / "one"),
                           "--device", "cpu", "--log", str(tmp_path / "one.log")]) == 0
    assert jax_cli.main(["smash", "-d", pile, "-m", metric, "-o", str(tmp_path / "jax"),
                         "--log", str(tmp_path / "jax.log")]) == 0
    assert csv == (tmp_path / "one.hulk-matrix.csv").read_bytes()
    assert csv == (tmp_path / "jax.hulk-matrix.csv").read_bytes()
    assert csv.count(b"\n") == 101
    assert ["written similarity matrix" in log for log in logs] == [True, False]
    for r, log in enumerate(logs):
        split = f"process {r}/2: 50 of 100 sketches" in log
        assert split == (metric == "weightedjaccard")


def test_smash_rank_without_files(pile, tmp_path):
    """Three ranks over two sketch files: rank 2 loads nothing and still
    takes part in every collective; the CSV is one process's."""
    two = tmp_path / "two"
    two.mkdir()
    for f in sorted(os.listdir(pile))[:2]:
        (two / f).write_bytes((open(os.path.join(pile, f), "rb").read()))
    argv = ["-m", "hulk_tpu_torch", "smash", "-d", str(two), "-m", "weightedjaccard",
            "-o", str(tmp_path / "ranks"), "--device", "cpu", "--log"]
    for rc, text in run_ranks(lambda r: [*argv, str(tmp_path / f"rank{r}.log")], 3, tmp_path):
        assert rc == 0, text[-3000:]
    assert "process 2/3: 0 of 2 sketches" in (tmp_path / "rank2.log").read_text()
    assert torch_cli.main(["smash", "-d", str(two), "-m", "weightedjaccard", "-o",
                           str(tmp_path / "one"), "--device", "cpu", "--log",
                           str(tmp_path / "one.log")]) == 0
    assert ((tmp_path / "ranks.hulk-matrix.csv").read_bytes()
            == (tmp_path / "one.hulk-matrix.csv").read_bytes())
