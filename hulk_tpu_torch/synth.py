"""Synthetic inputs, all from numpy default_rng(seed), with 1% N to
exercise the reference's N-corruption quirk:

  * `generate`: FASTQ(.gz) of reads of one length (the port's copy of
    scripts/gen_synth_fastq.py's `generate`);
  * `generate_mixed`: FASTQ(.gz) of reads of lengths spread over a range;
  * `generate_fasta`: FASTA(.gz) of contigs wrapped at 60 columns, by
    default about the size of a metagenome assembly (2,000 contigs of
    1-200 kb, about 200 Mb);
  * `kernel_batch`, `sorted_keys`, `sorted_values`: kernel inputs;
  * `drift_scan_cases`, `drift_select_cases`: the drift kernels' corner
    cases;
  * `sketch_jsons`: sketch JSON files of families of related samples, for
    smash;
  * `lsh_corpus`: sketch mins with near-duplicate queries, for LSH search.
"""
from __future__ import annotations

import gzip
import os

import numpy as np

ALPHABET = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _opener(path: str, gz_level: int):
    if path.endswith(".gz"):
        return lambda p: gzip.open(p, "wb", compresslevel=gz_level)
    return lambda p: open(p, "wb")


def _bases(rng, n: int) -> np.ndarray:
    return ALPHABET[rng.choice(5, size=n, p=[0.2475] * 4 + [0.01])]


def generate(path: str, n_reads: int, read_len: int = 150, seed: int = 0,
             gz_level: int = 1) -> str:
    rng = np.random.default_rng(seed)
    opener = _opener(path, gz_level)
    qual = b"I" * read_len
    tmp = path + f".tmp{os.getpid()}"
    chunk = 20_000
    with opener(tmp) as fh:
        written = 0
        while written < n_reads:
            n = min(chunk, n_reads - written)
            idx = rng.choice(5, size=(n, read_len), p=[0.2475] * 4 + [0.01])
            seqs = ALPHABET[idx]
            parts = []
            for i in range(n):
                parts.append(b"@r%d\n" % (written + i))
                parts.append(seqs[i].tobytes())
                parts.append(b"\n+\n")
                parts.append(qual)
                parts.append(b"\n")
            fh.write(b"".join(parts))
            written += n
    os.replace(tmp, path)
    return path


def generate_mixed(path: str, n_reads: int, lo: int = 40, hi: int = 3000,
                   seed: int = 0, gz_level: int = 1) -> str:
    """FASTQ(.gz) of n_reads reads of lengths uniform in [lo, hi]."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, size=n_reads)
    seqs = _bases(rng, int(lengths.sum()))
    ends = np.cumsum(lengths)
    tmp = path + f".tmp{os.getpid()}"
    with _opener(path, gz_level)(tmp) as fh:
        for i, (e, n) in enumerate(zip(ends, lengths)):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[e - n:e].tobytes(), b"I" * int(n)))
    os.replace(tmp, path)
    return path


def contig_lengths(rng, n_contigs: int, lo: int, hi: int) -> np.ndarray:
    """The contig lengths generate_fasta draws first from its generator."""
    return rng.integers(lo, hi + 1, size=n_contigs)


def generate_fasta(path: str, n_contigs: int = 2000, lo: int = 1000,
                   hi: int = 200_000, seed: int = 0, width: int = 60,
                   gz_level: int = 1) -> str:
    """FASTA(.gz) of n_contigs contigs of lengths uniform in [lo, hi],
    wrapped at `width` columns."""
    rng = np.random.default_rng(seed)
    lengths = contig_lengths(rng, n_contigs, lo, hi)
    tmp = path + f".tmp{os.getpid()}"
    with _opener(path, gz_level)(tmp) as fh:
        for i, n in enumerate(lengths):
            seq = _bases(rng, int(n))
            full = int(n) // width * width
            lines = np.concatenate(
                [seq[:full].reshape(-1, width),
                 np.full((full // width, 1), ord("\n"), dtype=np.uint8)], axis=1)
            tail = seq[full:].tobytes() + b"\n" if full < n else b""
            fh.write(b">contig%d\n%s%s" % (i, lines.tobytes(), tail))
    os.replace(tmp, path)
    return path


def kernel_batch(rng, R: int, L: int, lo: int, hi: int, n_frac=0.01, live=None):
    """One batch for the minimizer kernels: R reads of lengths in [lo, hi]
    (rows from `live` on, when given, of length 0, as the pipeline's padded
    rows and a long read's unused blocks are) with a share n_frac of N (a
    scalar, or [R, 1] for one share a read), as
    u8 codes [R, L] (0-4 in the read, random bytes past it, as uninitialised
    pad may be) and lengths [R] int32, and the same reads in the v2 transfer
    layout (native.pack_group2): codes2 [R, L/4] and mask8 [R, L/8] with
    random bits past each read's length. L % 8 == 0."""
    from hulk_tpu_torch import native

    codes = np.where(rng.random((R, L)) < n_frac, 4,
                     rng.integers(0, 4, size=(R, L))).astype(np.uint8)
    lengths = rng.integers(lo, hi + 1, size=R).astype(np.int32)
    if live is not None:
        lengths[live:] = 0
    flat = native.pack_group2([(codes, lengths)], 1, R, L)
    if flat is None:
        raise RuntimeError("kernel_batch: the native runtime did not build")
    codes2 = flat[:R * L // 4].reshape(R, L // 4).copy()
    mask8 = flat[R * L // 4:R * L // 4 + R * L // 8].reshape(R, L // 8).copy()
    past = np.arange(L)[None, :] >= lengths[:, None]
    codes[past] = rng.integers(0, 256, size=int(past.sum()), dtype=np.uint8)
    pad2 = (past.reshape(R, L // 4, 4) * (3 << (2 * np.arange(4)))).sum(-1).astype(np.uint8)
    pad1 = (past.reshape(R, L // 8, 8) * (1 << (7 - np.arange(8)))).sum(-1).astype(np.uint8)
    codes2 = (codes2 & ~pad2) | (rng.integers(0, 256, size=codes2.shape, dtype=np.uint8) & pad2)
    mask8 = (mask8 & ~pad1) | (rng.integers(0, 256, size=mask8.shape, dtype=np.uint8) & pad1)
    return codes, lengths, codes2, mask8


def sorted_keys(rng, n_keys: int, vbits: int, *, dup_only: bool = False,
                tail: int = 64):
    """Sorted (read_id << vbits | value) keys as u64, the input of the
    binning pass: duplicate runs, read ids high enough to set bit 63, and a
    tail of all-ones sentinels (dup_only: one key repeated)."""
    if dup_only:
        keys = np.full(n_keys, (np.uint64(9000) << np.uint64(vbits)) | np.uint64(12345))
    else:
        rid = rng.integers(0, 1 << (64 - vbits), size=n_keys, dtype=np.uint64)
        val = rng.integers(0, 1 << vbits, size=n_keys, dtype=np.uint64)
        keys = np.repeat((rid << np.uint64(vbits)) | val, rng.integers(1, 5, size=n_keys))
    return np.concatenate([np.sort(keys), np.full(tail, 2**64 - 1, dtype=np.uint64)])


def sorted_values(rng, n_values: int, *, one_key: bool = False, tail: int = 64):
    """Sorted u64 values, the input of the two-sort step's binning pass:
    the full range (about half above 2^63), runs of equal values (the same
    minimizer in several reads), and a tail of all-ones sentinels
    (one_key: one value repeated)."""
    if one_key:
        vals = np.full(n_values, np.uint64(0xC0FFEE0123456789))
    else:
        vals = rng.integers(0, 2**64 - 1, size=n_values, dtype=np.uint64)
        vals = np.repeat(vals, rng.integers(1, 5, size=n_values))
    return np.concatenate([np.sort(vals), np.full(tail, 2**64 - 1, dtype=np.uint64)])


def jump_adversarial_keys() -> np.ndarray:
    """u64 keys whose first divisor d = (key>>33)+1 hits the f64 rounding
    boundaries of the jump hash: d = 1, d = 2^31, powers of two and their
    neighbours (as hulk_tpu's tests/test_jump_pallas.py builds them)."""
    ds = [1, 2, 3]
    for p in range(2, 32):
        ds += [(1 << p) - 1, 1 << p, (1 << p) + 1]
    ds = [d for d in ds if 1 <= d <= (1 << 31)]
    keys = np.array([(d - 1) << 33 for d in ds], dtype=np.uint64)
    return np.concatenate([keys, keys | np.uint64(0x1FFFFFFFF), keys | np.uint64(1)])


def jump_boundary_keys(rng, n_keys: int = 1 << 20, within: float = 2.0**-20) -> np.ndarray:
    """u64 keys whose jump-hash loop meets, at some iteration before j
    reaches 2^31 - 1, a quotient x = (b+1) 2^31 / d within `within` of an
    integer (tested exactly, in integers): the iterations on which the jump
    kernel's filtered step hands over to its exact one. The ones found among
    n_keys random keys (about 40 for 2^20 keys at 2^-20)."""
    keys = rng.integers(0, 2**64 - 1, size=n_keys, dtype=np.uint64, endpoint=True)
    key = keys.copy()
    j = np.zeros(n_keys, dtype=np.int64)
    live = np.ones(n_keys, dtype=bool)
    hit = np.zeros(n_keys, dtype=bool)
    scale = round(1 / within)
    while live.any():
        idx = np.flatnonzero(live)
        key[idx] = key[idx] * np.uint64(2862933555777941757) + np.uint64(1)
        d = ((key[idx] >> np.uint64(33)) + np.uint64(1)).astype(np.int64)
        rem = ((j[idx] + 1) << 31) % d
        hit[idx[np.minimum(rem, d - rem) * scale < d]] = True
        # Go's next j: RN((b+1) RN(2^31/d)), truncated
        nxt = ((j[idx] + 1).astype(np.float64) * (2147483648.0 / d.astype(np.float64))
               ).astype(np.int64)
        go = nxt < 2**31 - 1
        j[idx[go]] = nxt[go]
        live[idx[~go]] = False
    return keys[hit]


def drift_scan_cases(rng, depth: int = 7, width: int = 2000, tile: int = 512) -> list:
    """Corner cases of the drift CMS scan (csrc/flush_drift.cu
    hulk_cms_drift_scan: a warp holds 32 counters of a row and steps tiles
    of `tile` live bins), each (name, hist [nbins] int64 with 0 where a bin
    is not live and counts 1-299 elsewhere, row table [depth, nbins] int64
    in [0, cms width), cms [depth, cms width] f64 carried in, 0 or 1-49):
    a CMS `width` wide whose counters decay below the smallest normal f64
    between hits (the last warp of a row partial at 2,000), one 32 wide
    (one warp a row, hit at every bin), row 0's first warp hit at every bin
    of a tile and then not for two tiles, and 0, 1, 255-257 (half a tile),
    tile - 1, tile and tile + 1 live bins."""
    def case(name, nbins, live, w, table=None):
        hist = np.where(rng.random(nbins) < live, rng.integers(1, 300, nbins), 0)
        if table is None:
            table = rng.integers(0, w, size=(depth, nbins))
        cms = np.where(rng.random((depth, w)) < 0.3, rng.integers(1, 50, (depth, w)), 0)
        return name, hist.astype(np.int64), table.astype(np.int64), cms.astype(np.float64)

    cases = [case(f"width {width}, a carried CMS decaying below the smallest normal",
                  3000, 0.9, width),
             case("width 32", 700, 0.8, 32)]
    nbins = 4 * tile + 100
    table = rng.integers(0, width, size=(depth, nbins))
    table[0, :tile + 40] = rng.integers(0, 32, tile + 40)
    table[0, tile + 40:3 * tile + 40] = rng.integers(64, width, 2 * tile)
    cases.append(case("row 0's first warp hit at every bin of a tile, then a gap of two "
                      "tiles", nbins, 1.0, width, table))
    for n in sorted({0, 1, 255, 256, 257, tile - 1, tile, tile + 1}):
        name, hist, table, cms = case(f"{n} live bins", 2 * tile + 64, 0.0, width)
        hist[np.sort(rng.choice(hist.shape[0], n, replace=False))] = rng.integers(1, 300, n)
        cases.append((name, hist, table, cms))
    return cases


def drift_select_cases(rng, dw: float, s: int = 8, n: int = 2500) -> list:
    """Corner cases of the drift slot selection (csrc/flush_drift.cu
    hulk_drift_select: chunk minima, then a walk that scans only the chunks
    below each slot's threshold weight / dw), each (name, aka [s, n] f64,
    sketch [s] int64, weights [s] f64); n is 2,500, 8,500 or 0, a multiple
    of no power of two above 4. Random Aka from an empty sketch and from a
    half-filled one;
    Aka strictly decreasing (every bin taken, every chunk scanned); twice
    an Aka exactly weight / dw (not taken) and one just below it (taken),
    at chunk edges, every other Aka above any threshold; +inf and NaN,
    spread and in whole chunks (never taken); a carried sketch whose
    weights take nothing; one Aka a slot below its threshold, all in the
    33rd chunk of 256 (8,500 bins: the walk skips a whole group of 32 chunk
    minima); no live bins."""
    empty_sk = np.zeros(s, dtype=np.int64)
    empty_w = np.full(s, np.finfo(np.float64).max)
    esti = rng.integers(1, 300, n).astype(np.float64)
    rand = rng.exponential(size=(s, n)) / esti
    half_sk = np.where(rng.random(s) < 0.5, rng.integers(1, 1 << 20, s), 0)
    half_w = np.where(half_sk > 0, rng.random(s) * 1e-3, np.finfo(np.float64).max)
    cases = [("random Aka, an empty sketch", rand, empty_sk, empty_w),
             ("random Aka, a half-filled sketch", rand, half_sk, half_w)]
    dec = np.geomspace(1.0, 1e-6, n)[None, :] * (1.0 + np.arange(s))[:, None]
    cases.append(("strictly decreasing Aka", dec, empty_sk, empty_w))
    w = 0.25 + rng.random(s)
    tie = (w / dw ** 4)[:, None] * (1.0 + rng.random((s, n)))
    for slot in range(s):
        wt = w[slot]
        for p in (255 + 32 * slot, 1023 + 64 * slot):
            tie[slot, p] = wt / dw
            tie[slot, p + 1] = wt = np.nextafter(wt / dw, 0.0)
    cases.append(("Aka equal to weight / dw (and just below) at chunk edges", tie,
                  rng.integers(1, 1 << 20, s), w))
    odd = rand.copy()
    odd[rng.random((s, n)) < 0.2] = np.inf
    odd[rng.random((s, n)) < 0.05] = np.nan
    odd[:, :300] = np.inf
    odd[:, 300:600] = np.nan
    cases.append(("+inf and NaN Aka, spread and in whole chunks", odd, empty_sk, empty_w))
    cases.append(("a carried sketch whose weights take nothing", rand + 1e-3, half_sk + 1,
                  np.full(s, 1e-300)))
    # weights 1 (threshold 1 / dw, below 2.5): only Aka below 1 are taken
    far = 1e6 * (1.0 + rng.random((s, 8500)))
    far[np.arange(s), 8300 + 17 * np.arange(s)] = 0.5 + 0.5 * rng.random(s)
    cases.append(("one Aka below the threshold, past the first 32 chunks of 256", far,
                  rng.integers(1, 1 << 20, s), np.ones(s)))
    cases.append(("no live bins", np.empty((s, 0)), half_sk, half_w))
    return cases


def sketch_jsons(out_dir: str, n: int, *, k: int = 21, s: int = 42, families: int = 32,
                 seed: int = 0) -> list[str]:
    """n sketch JSONs (histosketch, KMV and KHF) of `families` families of
    one ancestor: each family keeps the ancestor's values in a random share
    of the slots and each sample its family's (shares uniform in [0, 1]),
    the rest drawn anew, so that similarities spread over 0-100 within and
    across families. Files are sample{i:05d}.json, with banner label
    family{f}."""
    from hulk_tpu_torch.hashes.cws import CWSTables
    from hulk_tpu_torch.io.sketchio import HULKData
    from hulk_tpu_torch.sketch.histosketch import HistoSketch
    from hulk_tpu_torch.sketch.minhash import KHFSketch, KMVSketch

    rng = np.random.default_rng(seed)
    nbins = k ** 4
    no_tables = CWSTables(*(np.empty((0, 0)),) * 4)  # writing needs none
    u64 = lambda size: rng.integers(0, 2**64 - 1, size, dtype=np.uint64, endpoint=True)  # noqa: E731
    draw = dict(mins=lambda shape: rng.integers(0, nbins, shape),
                weights=lambda shape: rng.exponential(1.0, shape), kmv=u64, khf=u64)
    ancestor = {key: f((s,)) for key, f in draw.items()}
    keep = rng.random((families, s)) < rng.random((families, 1))
    base = {key: np.where(keep, ancestor[key], f((families, s))) for key, f in draw.items()}
    paths = []
    for i in range(n):
        f = int(rng.integers(families))
        keep = rng.random(s) < rng.random()
        hs = HistoSketch(k, s, nbins, 1.0, tables=no_tables)
        hs.sketch = np.where(keep, base["mins"][f], rng.integers(0, nbins, s)).astype(np.uint64)
        hs.sketch_weights = np.where(keep, base["weights"][f], rng.exponential(1.0, s))
        kmv = KMVSketch(k, s)
        kmv._values = np.sort(np.where(keep, base["kmv"][f], u64(s)))
        khf = KHFSketch(k, s)
        khf.sketch = np.where(keep, base["khf"][f], u64(s))
        data = HULKData(filename=f"sample{i}", banner=f"family{f}")
        for obj in (hs, kmv, khf):
            data.add(obj)
        path = os.path.join(out_dir, f"sample{i:05d}.json")
        data.write_json(path)
        paths.append(path)
    return paths


def lsh_corpus(n: int, nq: int, s: int = 42, seed: int = 0):
    """(mins [n, s], queries [nq, s], qidx [nq]): u64 mins uniform in
    [0, 2^40), and each query a copy of corpus row qidx with 2 slots drawn
    anew (a near-duplicate at similarity (s-2)/s or more). The counterpart
    of scripts/lsh_demo.py's make_corpus, draw for draw."""
    rng = np.random.default_rng(seed)
    mins = rng.integers(0, 2**40, (n, s), dtype=np.uint64)
    qidx = rng.choice(n, nq, replace=False)
    queries = mins[qidx].copy()
    for qi in range(nq):
        ch = rng.choice(s, 2, replace=False)
        queries[qi, ch] = rng.integers(0, 2**40, 2, dtype=np.uint64)
    return mins, queries, qidx
