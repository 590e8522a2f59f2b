"""The v2 transfer layout of native.pack_group2 (hulk_pack_group_batch2)
against an independent NumPy build of it, byte for byte: 2-bit codes
[g, r, l/4] (position p in bits 2*(p%4) of byte p/4), the N mask
[g, r, l/8] in np.packbits order, LE u16 lengths [g, r]; positions past a
read's length (capped at l) pack as 0 in both, dead rows and batches as 0
with length 0.

The native runtime packs a vector at a time where the compiler offers AVX2,
a base at a time elsewhere. Each case runs the library the package loads,
and the same source built with AVX2's macro undefined (the scalar path).
Tolerance: none.
"""
import ctypes
import subprocess

import numpy as np
import pytest

from hulk_tpu_torch import native

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="native runtime unavailable")

BUILDS = {"loaded": None, "scalar": ["-U__AVX2__"]}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """hulk_pack_group_batch2 of each build."""
    out = {}
    d = tmp_path_factory.mktemp("pack2")
    for name, undef in BUILDS.items():
        if undef is None:
            out[name] = native._load()
            continue
        so = str(d / f"hulkrt_{name}.so")
        subprocess.run(["g++", "-O2", "-march=native", *undef, "-fopenmp", "-shared",
                        "-fPIC", "-o", so, native._SRC], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        lib.hulk_pack_group_batch2.restype = None
        lib.hulk_pack_group_batch2.argtypes = native._load().hulk_pack_group_batch2.argtypes
        out[name] = lib
    return out


def pack_numpy(batches, g: int, r: int, l: int) -> np.ndarray:
    codes2 = np.zeros((g, r, l // 4), np.uint8)
    mask8 = np.zeros((g, r, l // 8), np.uint8)
    lens = np.zeros((g, r), "<u2")
    for i, (codes, lengths) in enumerate(batches):
        rows = codes.shape[0]
        n = np.minimum(lengths.astype(np.int64), l)
        full = np.zeros((rows, l), np.uint8)
        w = min(l, codes.shape[1])
        full[:, :w] = codes[:, :w]
        live = np.arange(l)[None, :] < n[:, None]
        is_n = live & (full >= 4)
        c = np.where(live & ~is_n, full, 0).reshape(rows, l // 4, 4)
        codes2[i, :rows] = (c << np.array([0, 2, 4, 6], np.uint8)).sum(axis=2, dtype=np.uint8)
        mask8[i, :rows] = np.packbits(is_n, axis=1)
        lens[i, :rows] = n
    return np.concatenate([codes2.ravel(), mask8.ravel(), lens.view(np.uint8).ravel()])


def _batch(rng, rows: int, stride: int, lengths) -> tuple[np.ndarray, np.ndarray]:
    """Codes 0-3 with N (4) at random and at every position mod 32 (row i
    has one at each position p with p % 32 == i % 32); past each length,
    any byte."""
    codes = rng.choice(np.arange(5, dtype=np.uint8), size=(rows, stride),
                       p=[0.24, 0.24, 0.24, 0.24, 0.04])
    codes[(np.arange(stride)[None, :] - np.arange(rows)[:, None]) % 32 == 0] = 4
    lengths = np.asarray(lengths, dtype=np.int32)
    past = np.arange(stride)[None, :] >= lengths[:, None]
    codes[past] = rng.integers(0, 256, size=int(past.sum()), dtype=np.uint8)
    return codes, lengths


def _lengths(rng, rows: int, l: int, stride: int) -> np.ndarray:
    """0, 1, l-1, l, the stride (past l when the stride is), lengths not
    divisible by 4, 8 or 32, then any; none past the stride (a row's bytes)."""
    fixed = [x for x in (0, 1, l - 1, l, stride, 3, 5, 7, 9, 13, 17, 31, 33, 63, 65, 95, 97,
                         127, 129, 150, 151, 155) if x <= stride]
    more = rng.integers(0, stride + 1, size=max(rows - len(fixed), 0))
    return np.array((fixed + list(more))[:rows], dtype=np.int32)


CASES = {
    **{f"l{l}": dict(l=l, stride=l, rows=[40], r=40, g=1) for l in (8, 64, 152, 160, 2048)},
    **{f"l{l}-stride": dict(l=l, stride=l + 13, rows=[40], r=40, g=1) for l in (8, 152, 160)},
    "l2048-stride": dict(l=2048, stride=2048 + 40, rows=[33], r=33, g=1),
    "dead-rows": dict(l=160, stride=160, rows=[25, 7], r=40, g=2),
    "dead-batches": dict(l=152, stride=200, rows=[30, 40], r=40, g=5),
    "stride-below-l": dict(l=160, stride=150, rows=[40], r=40, g=1),
    "one-row": dict(l=64, stride=64, rows=[1], r=3, g=2),
}


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_group2_matches_a_numpy_build(libs, monkeypatch, case, build):
    c = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    batches = []
    for rows in c["rows"]:
        batches.append(_batch(rng, rows, c["stride"], _lengths(rng, rows, c["l"], c["stride"])))
    monkeypatch.setattr(native, "_lib", libs[build])
    got = native.pack_group2(batches, c["g"], c["r"], c["l"])
    want = pack_numpy(batches, c["g"], c["r"], c["l"])
    assert got.shape == want.shape
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, f"{bad.size} bytes differ, first at {bad[:5]}"
    # a pinned buffer's view is filled the same, whatever it held before
    out = np.full(native.group2_nbytes(c["g"], c["r"], c["l"]), 0xA5, np.uint8)
    native.pack_group2(batches, c["g"], c["r"], c["l"], out=out)
    assert np.array_equal(out, want)

