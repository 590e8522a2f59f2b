"""A paired-end shotgun sample of a mock microbial community, from a seed.

The community is `genomes` random genomes with lengths spread evenly over
[genome_bp_min, genome_bp_max] and log-normal abundances (mu
`abundance_mu`, sigma `abundance_sigma`, CAMISIM's default community
design) at evenly spaced quantiles: the same sizes for every seed, which
only shuffles them over the genomes and draws the bases. Each of
`reads_per_file` fragments (lengths uniform in [fragment_min,
fragment_max]) comes from a genome with probability proportional to its
abundance times its length, at a uniform position, from either strand; R1
holds its first `read_length` bases, R2 the reverse complement of its last.
A share `n_frac` of the bases of each read is N (none when it is 0). The
files are FASTQ, gzip at `gzip_level`, written as members of `chunk`
records; the draws are made in order on the calling thread, and `threads`
threads cut the reads, write and compress each chunk.

The reads' codes (0-3 for ACGT, 4 for N) are returned beside the files,
for the reference: what the files hold, without parsing them again.

A vectorised frozen counterpart of hulk_tpu_torch/synth.py's `generate`
(random reads, gzip level 1), with genomes and pairs added.
"""
from __future__ import annotations

import os
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from hulkbench.inputs import gzip_member

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _fastq(codes: np.ndarray, first: int, mate: int) -> bytes:
    """FASTQ records of equal-length reads: @r<index, 9 digits>/<mate>."""
    n, L = codes.shape
    ids = np.arange(first, first + n, dtype=np.int64)
    digits = (ids[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + ord("0")
    head = np.concatenate([np.full((n, 2), (ord("@"), ord("r")), dtype=np.uint8),
                           digits.astype(np.uint8),
                           np.full((n, 3), (ord("/"), ord("0") + mate, 10), dtype=np.uint8)],
                          axis=1)
    sep = np.full((n, 3), (10, ord("+"), 10), dtype=np.uint8)
    qual = np.full((n, L + 1), ord("I"), dtype=np.uint8)
    qual[:, -1] = 10
    return np.concatenate([head, ASCII[codes], sep, qual], axis=1).tobytes()


def community(p: dict, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(genome lengths, abundances, read shares): the fixed sizes, shuffled."""
    g = int(p["genomes"])
    q = (np.arange(g) + 0.5) / g
    lengths = np.round(p["genome_bp_min"] + (p["genome_bp_max"] - p["genome_bp_min"]) * q)
    z = np.array([statistics.NormalDist().inv_cdf(x) for x in q])
    abundance = np.exp(p["abundance_mu"] + p["abundance_sigma"] * z)
    lengths, abundance = rng.permutation(lengths).astype(np.int64), rng.permutation(abundance)
    share = abundance * lengths
    return lengths, abundance, share / share.sum()


def generate(p: dict, seed: int, outdir: str) -> dict:
    rng = np.random.default_rng(seed)
    lengths, _, share = community(p, rng)
    genome = rng.integers(0, 4, size=int(lengths.sum()), dtype=np.uint8)
    start = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    n, L, level = int(p["reads_per_file"]), int(p["read_length"]), int(p["gzip_level"])
    chunk, threads = int(p["chunk"]), int(p["threads"])
    col = np.arange(L)
    codes = {m: np.empty((n, L), dtype=np.uint8) for m in ("R1", "R2")}
    paths = {m: os.path.join(outdir, f"{m}.fq.gz") for m in ("R1", "R2")}

    def cut(a, pos, frag, minus, nmask):
        """Chunk a's reads into codes, and its two gzip members."""
        m = pos.shape[0]
        fwd = genome[pos[:, None] + col]
        rev = 3 - genome[(pos + frag - 1)[:, None] - col]
        r1, r2 = codes["R1"][a:a + m], codes["R2"][a:a + m]
        np.copyto(r1, np.where(minus[:, None], rev, fwd))
        np.copyto(r2, np.where(minus[:, None], fwd, rev))
        for r, nm in zip((r1, r2), nmask):
            if nm is not None:
                r[nm] = 4
        return gzip_member(_fastq(r1, a, 1), level), gzip_member(_fastq(r2, a, 2), level)

    with open(paths["R1"], "wb") as f1, open(paths["R2"], "wb") as f2, \
            ThreadPoolExecutor(threads) as pool:
        pending = []
        for a in range(0, n, chunk):
            m = min(chunk, n - a)
            g = rng.choice(lengths.shape[0], size=m, p=share)
            frag = rng.integers(p["fragment_min"], p["fragment_max"] + 1, size=m)
            pos = start[g] + (rng.random(m) * (lengths[g] - frag + 1)).astype(np.int64)
            minus = rng.random(m) < 0.5
            nmask = [rng.random((m, L), dtype=np.float32) < p["n_frac"] if p["n_frac"] else None
                     for _ in range(2)]
            pending.append(pool.submit(cut, a, pos, frag, minus, nmask))
            while len(pending) > 2 * threads or (pending and a + m >= n):
                z1, z2 = pending.pop(0).result()
                f1.write(z1)
                f2.write(z2)
    flat = np.full(n, L, dtype=np.int64)
    return {"files": paths,
            "records": {"R1": n, "R2": n}, "bases": {"R1": n * L, "R2": n * L},
            "reads": {m: (c.reshape(-1), flat) for m, c in codes.items()}}
