"""Synthetic inputs, all from numpy default_rng(seed), with 1% N to
exercise the reference's N-corruption quirk:

  * `generate`: FASTQ(.gz) of reads of one length (the port's copy of
    scripts/gen_synth_fastq.py's `generate`);
  * `generate_mixed`: FASTQ(.gz) of reads of lengths spread over a range;
  * `generate_fasta`: FASTA(.gz) of contigs wrapped at 60 columns, by
    default about the size of a metagenome assembly (2,000 contigs of
    1-200 kb, about 200 Mb);
  * `kernel_batch`, `sorted_keys`, `sorted_values`: kernel inputs.
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
