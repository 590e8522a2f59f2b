"""The native inflater's match entries (hulkrt.cpp inf_match): a length
with the distance code after it, filled into the main table for every
block, so that a short match decodes in one lookup. The decoder gives
zlib's bytes wherever they are filled -- the benchmark's mock sample, FASTQ
with binned qualities at levels 1, 6 and 9, random bytes, fixed-Huffman
blocks, windows of 512 bytes to 32 KB (other distance codes), streams that
end within the fast loop's margin of the output's end -- and refuses a
member that does not fit (-2) without writing past its room. Tolerance:
none.
"""
import gzip
import json
import os
import zlib

import numpy as np
import pytest

from hulk_tpu_torch import native

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="native runtime unavailable")

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINNED = np.frombuffer(b"#-8F", np.uint8)  # Illumina's binned Q 2/12/23/37


@pytest.fixture(scope="module")
def mock(tmp_path_factory):
    """The benchmark generator's R1 at a tiny size: 3,000 records of 150 bp
    in gzip members of 1,000, level 1; (the file's bytes, its records)."""
    from hulkbench.inputs import mock_community

    with open(os.path.join(HERE, "hulkbench", "configs", "reads-k21-s42.json")) as f:
        p = dict(json.load(f)["input"])
    p.update(genomes=5, genome_bp_min=20_000, genome_bp_max=60_000, reads_per_file=3_000,
             chunk=1_000, threads=2)
    made = mock_community.generate(p, 2_200_000_007, str(tmp_path_factory.mktemp("mock")))
    with open(made["files"]["R1"], "rb") as f:
        comp = f.read()
    return comp, gzip.decompress(comp)


def binned(records: bytes, seed: int) -> bytes:
    """The records with each quality drawn from the four binned symbols."""
    recs = np.frombuffer(records, np.uint8).reshape(3_000, -1).copy()
    q0 = recs.shape[1] - 151
    rng = np.random.default_rng(seed)
    recs[:, q0:q0 + 150] = BINNED[rng.choice(4, size=(3_000, 150), p=[0.02, 0.05, 0.13, 0.80])]
    return recs.tobytes()


def compress(data: bytes, level: int, strategy: int = zlib.Z_DEFAULT_STRATEGY,
             wbits: int = 15) -> bytes:
    z = zlib.compressobj(level, zlib.DEFLATED, 16 + wbits, 8, strategy)
    return z.compress(data) + z.flush()


def inflate(comp: bytes, cap: int | None = None, guard: int = 64):
    """(bytes written, offset reached, the bytes), the output in a buffer of `cap` bytes with `guard` bytes after it that must
    stay untouched."""
    src = np.frombuffer(comp, np.uint8)
    cap = cap if cap is not None else 4 * len(comp) + (1 << 20)
    backing = np.full(cap + guard, 0xEE, np.uint8)
    n, pos, _ = native.inflate_members(src, 0, backing[:cap], 1 << 62)
    assert (backing[cap:] == 0xEE).all(), "the inflater wrote past its room"
    return n, pos, backing[:max(n, 0)].tobytes()


def _random(rng) -> bytes:
    return rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()


def _random200(rng) -> bytes:
    """Random bytes over 200 symbols: Huffman-coded (7-8 bits a code), not
    stored."""
    return rng.integers(0, 200, 300_000, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["mock", "binned", "random", "random200"])
def test_the_inflater_gives_zlibs_bytes(mock, kind, level):
    rng = np.random.default_rng(level)
    data = {"mock": lambda: mock[1], "binned": lambda: binned(mock[1], level),
            "random": lambda: _random(rng), "random200": lambda: _random200(rng)}[kind]()
    comp = mock[0] if kind == "mock" and level == 1 else compress(data, level)
    n, pos, out = inflate(comp)
    assert (n, pos) == (len(data), len(comp))
    assert out == data


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("kind", ["mock", "binned"])
def test_fixed_huffman_blocks_give_zlibs_bytes(mock, kind, level):
    data = mock[1] if kind == "mock" else binned(mock[1], 3)
    comp = compress(data, level, zlib.Z_FIXED)
    n, pos, out = inflate(comp)
    assert (n, pos, out) == (len(data), len(comp), data)


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("wbits", [9, 10, 12, 14])
def test_small_windows_give_zlibs_bytes(mock, wbits, level):
    """A window of 2**wbits bytes caps the distances, so each block codes
    them with fewer, shorter distance codes: more matches fit the index
    bits whole."""
    data = binned(mock[1], wbits)
    comp = compress(data, level, wbits=wbits)
    n, pos, out = inflate(comp)
    assert (n, pos, out) == (len(data), len(comp), data)


@pytest.mark.parametrize("strategy", ["default", "huffman_only", "rle"])
def test_streams_ending_within_the_fast_loops_margin(mock, strategy):
    """Output buffers of exactly the inflated size and a little more, and
    streams whose sizes fall across the fast loop's margin (INF_FAST_OUT,
    274 bytes): every byte right, none written past the room."""
    strat = {"default": zlib.Z_DEFAULT_STRATEGY, "huffman_only": zlib.Z_HUFFMAN_ONLY,
             "rle": zlib.Z_RLE}[strategy]
    records = binned(mock[1], 5)
    for size in (1, 7, 100, 273, 274, 275, 600, 4_095, 70_001):
        data = records[:size]
        comp = compress(data, 6, strat)
        for extra in (0, 1, 7, 8, 100, 273, 274, 275, 400):
            n, pos, out = inflate(comp, cap=size + extra, guard=300)
            assert (n, pos, out) == (size, len(comp), data), (size, extra)


@pytest.mark.parametrize("short", [1, 8, 273, 5_000])
def test_a_member_that_does_not_fit_is_minus_two(mock, short):
    data = binned(mock[1], 9)[:200_000]
    for level in (1, 6):
        comp = compress(data, level)
        n, pos, _ = inflate(comp, cap=len(data) - short, guard=300)
        assert (n, pos) == (-2, 0)
