"""index/lshforest.py: the port's copy against hulk_tpu's on the same seeded
NumPy inputs. Tolerance: exact equality (band keys are u64, similarities
are integer counts over s, and the JSON is compared byte for byte)."""
import json

import numpy as np
import pytest

import hulk_tpu.index.lshforest as jax_lsh
import hulk_tpu_torch.index.lshforest as port_lsh

PACKAGES = {"jax": jax_lsh, "port": port_lsh}
THRESHOLDS = [0.0, 0.05, 0.1, 0.25, 0.5, 0.7, 0.8, 0.9, 0.95, 1.0]


def corpus(seed: int, s: int = 42, levels=(0.15, 0.35, 0.55, 0.75, 0.9, 0.95),
           per_level: int = 20, n_noise: int = 200):
    """(query, names, mins): rows that keep round(s*level) of the query's
    slots, and noise rows, all u64 (some above 2^63)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2**64 - 1, s, dtype=np.uint64, endpoint=True)
    rows, names = [], []
    for lv in levels:
        keep = int(round(s * lv))
        for i in range(per_level):
            r = rng.integers(0, 2**64 - 1, s, dtype=np.uint64, endpoint=True)
            pos = rng.permutation(s)[:keep]
            r[pos] = q[pos]
            rows.append(r)
            names.append(f"lv{lv:.2f}_{i}")
    rows += list(rng.integers(0, 2**64 - 1, (n_noise, s), dtype=np.uint64, endpoint=True))
    names += [f"noise_{i}" for i in range(n_noise)]
    return q, names, np.stack(rows)


def both_forests(names, mins, s=42, t=0.7):
    out = {}
    for key, mod in PACKAGES.items():
        f = mod.LSHForest(kmer_size=21, sketch_size=s, jaccard_thresh=t)
        f.add_batch(list(names), mins)
        out[key] = f
    return out


@pytest.mark.parametrize("t", THRESHOLDS)
def test_choose_bands(t):
    got = [port_lsh.choose_bands(s, t) for s in range(1, 65)]
    assert got == [jax_lsh.choose_bands(s, t) for s in range(1, 65)]


@pytest.mark.parametrize("n,s,b,r", [(100, 42, 14, 3), (100, 42, 42, 1), (37, 16, 2, 8),
                                     (5, 64, 1, 64), (300, 50, 7, 7)])
def test_band_keys(n, s, b, r):
    mins = np.random.default_rng(n + s + b).integers(0, 2**64 - 1, (n, s), dtype=np.uint64,
                                                     endpoint=True)
    got = port_lsh.band_keys(mins, b, r)
    assert got.dtype == np.uint64 and got.shape == (n, b)
    assert np.array_equal(got, jax_lsh.band_keys(mins, b, r))


@pytest.mark.parametrize("t", [0.5, 0.7, 0.9])
@pytest.mark.parametrize("op", ["candidates", "search", "search_batch", "query_topk",
                                "query_topk_after_add"])
def test_queries(op, t):
    q, names, mins = corpus(int(t * 100))
    forests = both_forests(names, mins, t=t)
    queries = np.stack([q, mins[5], mins[100], mins[-1]])

    def answer(f):
        if op == "candidates":
            return [f.candidates(x).tolist() for x in queries]
        if op == "search":
            return [f.search(x) for x in queries] + [f.search(q, thresh=0.3)]
        if op == "search_batch":
            return f.search_batch(queries)
        if op == "query_topk_after_add":
            f.query_topk(q, 3)
            f.add("exact_dup", q)
        return [f.query_topk(x, k) for x in queries for k in (1, 5, 15, 40)]

    got, want = answer(forests["port"]), answer(forests["jax"])
    assert got == want
    assert any(got)
    if op == "query_topk_after_add":
        assert got[0] == [("exact_dup", 1.0)]


def test_add_batch_matches_sequential_add():
    rng = np.random.default_rng(8)
    s, n = 16, 300
    mins = rng.integers(0, 2**40, (n, s), dtype=np.uint64)
    seq = {key: mod.LSHForest(kmer_size=11, sketch_size=s, jaccard_thresh=0.8)
           for key, mod in PACKAGES.items()}
    for i in range(n):
        for f in seq.values():
            f.add(f"s{i}", mins[i])
    batch = port_lsh.LSHForest(kmer_size=11, sketch_size=s, jaccard_thresh=0.8)
    batch.add_batch([f"s{i}" for i in range(n)], mins)
    q = mins[17].copy()
    q[3] = 12345
    for f in (seq["port"], batch):
        assert np.array_equal(f.candidates(q), seq["jax"].candidates(q))
        assert f.search(q) == seq["jax"].search(q)
        assert f.names == seq["jax"].names
        assert np.array_equal(f.mins_matrix, seq["jax"].mins_matrix)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_index_json_across_packages(tmp_path, writer, reader):
    """write_json's bytes are the same from both packages; an index written
    by one loads in the other, writes the same bytes again and answers the
    same queries."""
    q, names, mins = corpus(3)
    forests = both_forests(names, mins)
    paths = {key: str(tmp_path / f"{key}.json") for key in PACKAGES}
    for key, f in forests.items():
        f.write_json(paths[key])
    blobs = {key: open(p, "rb").read() for key, p in paths.items()}
    assert blobs["port"] == blobs["jax"]

    loaded = PACKAGES[reader].LSHForest.load_json(paths[writer])
    again = str(tmp_path / "again.json")
    loaded.write_json(again)
    assert open(again, "rb").read() == blobs[writer]
    assert loaded.names == forests[writer].names
    assert np.array_equal(loaded.mins_matrix, mins)
    for x in (q, mins[7]):
        assert loaded.search(x) == forests[writer].search(x)
        assert loaded.query_topk(x, 10) == forests[writer].query_topk(x, 10)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_round1_nested_list_form(tmp_path, reader):
    q, names, mins = corpus(4)
    forest = port_lsh.LSHForest(kmer_size=21, sketch_size=42, jaccard_thresh=0.7)
    forest.add_batch(names, mins)
    p = tmp_path / "idx.json"
    forest.write_json(str(p))
    doc = json.loads(p.read_text())
    doc.pop("mins_b64")
    doc["mins"] = [[int(v) for v in row] for row in mins]
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps(doc))
    loaded = PACKAGES[reader].LSHForest.load_json(str(legacy))
    assert np.array_equal(loaded.mins_matrix, mins)
    assert loaded.search(q) == forest.search(q)
    assert loaded.query_topk(q, 5) == forest.query_topk(q, 5)


def _bad_index(tmp_path, what: str) -> str:
    """An index file with one fault, written by the port."""
    _, names, mins = corpus(5, per_level=2, n_noise=3)
    f = port_lsh.LSHForest(kmer_size=21, sketch_size=42, jaccard_thresh=0.7)
    f.add_batch(names, mins)
    p = str(tmp_path / "idx.json")
    f.write_json(p)
    doc = json.load(open(p))
    if what == "class":
        doc["class"] = "hulk_sketch"
    elif what == "version":
        doc["version"] = "0.0.2"
    elif what == "truncated":
        doc["mins_b64"] = doc["mins_b64"][:-400]
    json.dump(doc, open(p, "w"))
    return p


@pytest.mark.parametrize("case", ["missing", "class", "version", "truncated",
                                  "add_length", "add_names", "topk_length"])
def test_index_errors(tmp_path, case):
    """LSHIndexError with the same message from both packages."""
    msgs = {}
    for key, mod in PACKAGES.items():
        p = str(tmp_path / "none.json") if case == "missing" else _bad_index(tmp_path, case)
        f = mod.LSHForest(kmer_size=21, sketch_size=42, jaccard_thresh=0.7)
        with pytest.raises(mod.LSHIndexError) as e:
            if case == "add_length":
                f.add_batch(["a"], np.zeros((1, 40), dtype=np.uint64))
            elif case == "add_names":
                f.add_batch(["a", "b"], np.zeros((1, 42), dtype=np.uint64))
            elif case == "topk_length":
                f.add("a", np.zeros(42, dtype=np.uint64))
                f.query_topk(np.zeros(41, dtype=np.uint64), 3)
            else:
                mod.LSHForest.load_json(p)
        msgs[key] = str(e.value)
        assert isinstance(e.value, ValueError)
    assert msgs["port"] == msgs["jax"]
