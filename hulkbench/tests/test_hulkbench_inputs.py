"""The input generator: one seed gives the same bytes twice, every seed
the same amount of work, and the files hold the codes handed to the
reference."""
from __future__ import annotations

import gzip
import hashlib
import importlib

import numpy as np

SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
SEQ_NT4[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)


def _digests(files: dict) -> dict:
    out = {}
    for name, path in files.items():
        with open(path, "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _fastq_codes(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(codes, lengths) of a gzip FASTQ file of 4-line records."""
    with gzip.open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    assert all(h.startswith(b"@") for h in lines[0:-1:4])
    seqs = lines[1:-1:4]
    codes = SEQ_NT4[np.frombuffer(b"".join(seqs), dtype=np.uint8)]
    return codes, np.array([len(s) for s in seqs], dtype=np.int64)


def test_same_seed_same_bytes_other_seed_same_sizes(tiny, tmp_path):
    cfg = tiny("reads-k21.samples")["config"]
    gen = importlib.import_module(f"hulkbench.inputs.{cfg['generator']}")
    runs = []
    for i, seed in enumerate([2**31 + 17, 2**31 + 17, 5]):
        d = tmp_path / str(i)
        d.mkdir()
        runs.append(gen.generate(cfg["input"], seed, str(d)))
    a, b, c = (_digests(r["files"]) for r in runs)
    assert a == b
    assert a.keys() == c.keys() and all(a[k] != c[k] for k in a)
    assert runs[0]["bases"] == runs[2]["bases"]
    assert runs[0]["records"] == runs[2]["records"]
    for name, path in runs[0]["files"].items():
        codes, lengths = _fastq_codes(path)
        assert lengths.shape[0] == runs[0]["records"][name]
        assert int(lengths.sum()) == codes.shape[0] == runs[0]["bases"][name]
        want_codes, want_lengths = runs[0]["reads"][name]
        assert np.array_equal(codes, want_codes) and np.array_equal(lengths, want_lengths)
        n_share = float((codes == 4).mean())
        assert 0.005 < n_share < 0.015


def test_mock_community_sizes_are_fixed_and_shuffled():
    from hulkbench.inputs import mock_community
    from hulkbench.run import load_cell

    p = load_cell("reads-k21.samples")["config"]["input"]
    l1, a1, s1 = mock_community.community(p, np.random.default_rng(1))
    l2, a2, s2 = mock_community.community(p, np.random.default_rng(2))
    assert sorted(l1) == sorted(l2) and sorted(a1) == sorted(a2)
    assert not np.array_equal(l1, l2)
    assert l1.min() >= p["genome_bp_min"] and l1.max() <= p["genome_bp_max"]
    assert abs(np.median(np.log(a1)) - p["abundance_mu"]) < 0.1
    assert abs(s1.sum() - 1.0) < 1e-12


def test_the_sample_is_config_4s_ten_million_reads_with_no_n(tmp_path):
    """The configuration as run: 2 x 5M reads; the reads carry no N."""
    from hulkbench.inputs import mock_community
    from hulkbench.run import load_cell

    cfg = load_cell("reads-k21.samples")["config"]
    p = cfg["input"]
    assert 2 * p["reads_per_file"] == cfg["reads"] == 10_000_000
    small = dict(p, genome_bp_min=20_000, genome_bp_max=60_000, reads_per_file=2_000,
                 chunk=500, threads=2)
    out = mock_community.generate(small, 3, str(tmp_path))
    assert all(int((c == 4).sum()) == 0 for c, _ in out["reads"].values())
