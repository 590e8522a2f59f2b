"""The arithmetic of the two Hopper kernels, modelled in NumPy and held
against the port's plain versions on the CPU.

The CUDA kernels run only on the card, so their own outputs are compared
with the plain versions there (tests/test_torch_gpu.py, chip_smoke.py).
These tests check, here, the identities their designs rest on:

* csrc/minimizer_window.cu builds both k-mers of a position from 64-bit
  fields of the packed rows (codes at bits 2p, N flags spread to bits 2p):
  rc = (~G & mask) | N and fwd = revpairs(G | N >> 4) >> (64 - 2k), and
  takes window minima as min(suffix[t], prefix[t + w - 1]) over blocks of w
  (van Herk / Gil-Werman); its cont form (the long-read chunks) sets the
  span to k and reports from position w + k - 1; its record scan stages one
  more entry a segment (E = P + w, from position p0 - w) so that the run-head
  test at a segment's first position sees position p0 - 1's window, with
  the van Herk blocks starting afresh at every segment;
* csrc/jump_hash.cu reads floor(Y) and 14 fraction bits of a product Y
  within 2^-47 p of Go's p from RZ(Y + 2^38), takes Go's own p where Y
  lies within 2^-14 of an integer, and goes on while the floor is below n
  (tests/test_torch_jump_filter.py holds the rule on keys and steps near
  those boundaries); its
  values entry bins every live value, equal neighbours included, on all 64
  bits, or in its dedup form each distinct one once, with its count.

Tolerance: bit-equality (integer arithmetic and IEEE f64 operations rounded
once each to nearest, the same in NumPy as on the card).
"""
import numpy as np
import pytest
import torch

from hulk_tpu_torch.hashes.jumphash import jump_hash_np
from hulk_tpu_torch.ops import minimizer as tm

from hulk_tpu_torch.ops.device_step import bin_scatter_values_torch
from hulk_tpu_torch.ops.longread import chunks
from hulk_tpu_torch.synth import kernel_batch as tm_kernel_batch
from hulk_tpu_torch.synth import sorted_values

from test_torch_jump import adversarial_keys
from test_torch_minimizer import packed_batch

U64 = np.uint64
MAX = U64(2**64 - 1)
# 2-bit groups of a byte in reverse order
_REV_PAIRS = np.array([((b & 3) << 6) | (((b >> 2) & 3) << 4) | (((b >> 4) & 3) << 2) | (b >> 6)
                       for b in range(256)], dtype=np.uint8)


def reverse_pairs(v: np.ndarray) -> np.ndarray:
    b = _REV_PAIRS[v.byteswap().view(np.uint8)]
    return b.view(np.uint64)


def hash64(key: np.ndarray, m: int) -> np.ndarray:
    m = U64(m)
    key = (~key + (key << U64(21))) & m
    key = key ^ (key >> U64(24))
    key = ((key + (key << U64(3))) + (key << U64(8))) & m
    key = key ^ (key >> U64(14))
    key = ((key + (key << U64(2))) + (key << U64(4))) & m
    key = key ^ (key >> U64(28))
    return (key + (key << U64(31))) & m


def staged_rows(c2: np.ndarray, m8: np.ndarray):
    """The kernel's staging: per read, little-endian 64-bit words of 2-bit
    codes (position p at bit 2p) and of N flags spread to the same pitch,
    with one word of zeros before position 0 and one after the row."""
    r, l4 = c2.shape
    bits = np.unpackbits(m8, axis=1)  # bit 7-(p%8) of byte p/8 -> column p
    spread = np.zeros((r, 2 * bits.shape[1]), dtype=np.uint8)
    spread[:, ::2] = bits
    n16 = np.packbits(spread, axis=1, bitorder="little")
    pad = lambda a: np.concatenate(  # noqa: E731
        [np.zeros((r, 8), np.uint8), a, np.zeros((r, 8 + (-a.shape[1]) % 8), np.uint8)], axis=1)
    return pad(c2).view(np.uint64), pad(n16).view(np.uint64)


def field(words: np.ndarray, o: np.ndarray) -> np.ndarray:
    """64 bits of each row starting at bit o[r, i]."""
    wi, sh = o >> 6, (o & 63).astype(np.uint64)
    lo = np.take_along_axis(words, wi, 1) >> sh
    hi = np.take_along_axis(words, wi + 1, 1) << ((U64(64) - sh) & U64(63))
    return np.where(sh == 0, lo, lo | hi)


def model_entries(c2, m8, lengths, k, w, cont=False):
    """The kernel's entries x [r, l] (U64MAX where invalid) and validity."""
    r, l = c2.shape[0], 4 * c2.shape[1]
    cw, nw = staged_rows(c2, m8)
    mask, nlim = U64((1 << (2 * k)) - 1), U64((1 << (2 * k + 1)) - 1)
    q = np.broadcast_to(np.arange(l), (r, l))
    o = 2 * (np.maximum(q - k, -32) + 32)  # bit of position q - k; word 0 is before the read
    n = field(nw, o) & nlim
    c = field(cw, o) & ~(n * U64(3))
    g = (c >> U64(2)) & mask
    rc = (~g & mask) | n
    fwd = reverse_pairs(g | (n >> U64(4))) >> U64(64 - 2 * k)
    valid = (q >= k - 1) & (q < lengths[:, None]) & (fwd != rc)
    canon = np.minimum(fwd, rc)
    span = np.full(q.shape, k) if cont else np.minimum(q - (w - 2), k)
    span = span.astype(np.int64).view(np.uint64)
    return np.where(valid, (hash64(canon, int(mask)) << U64(8)) | span, MAX), valid


def van_herk(e: np.ndarray, w: int):
    """Prefix and suffix minima over blocks of w entries from entry 0."""
    r = e.shape[0]
    nblk = -(-e.shape[1] // w)
    blk = np.concatenate([e, np.full((r, nblk * w - e.shape[1]), MAX)], 1).reshape(r, nblk, w)
    pre = np.minimum.accumulate(blk, axis=2).reshape(r, -1)
    suf = np.minimum.accumulate(blk[..., ::-1], axis=2)[..., ::-1].reshape(r, -1)
    return pre, suf


def model_minimizer_packed(c2, m8, lengths, k, w, cont=False):
    x, valid = model_entries(c2, m8, lengths, k, w, cont)
    r, l = x.shape
    q = np.arange(l)[None, :]
    # van Herk / Gil-Werman over entries e = 0.. (e = position + w - 1)
    pre, suf = van_herk(np.concatenate([np.full((r, w - 1), MAX), x], axis=1), w)
    wmin = np.minimum(suf[:, :l], pre[:, w - 1:w - 1 + l])
    return wmin, valid & (q >= (w + k - 1 if cont else w - 1))


def model_record_heads(x, valid, k, w, cont, P):
    """hulk_minimizer_record on one record's entries x [L]: segments of P
    positions, each with entries from position p0 - w (invalid before the
    record), van Herk blocks from the segment's entry 0, and position
    p0 + h's window the entries h+1 .. h+w for h = -1 .. Pe-1; a head where
    h >= 0 reports and h - 1 does not, or reports another minimum."""
    L, first = x.shape[0], w + k - 1 if cont else w - 1
    heads = []
    for p0 in range(0, L, P):
        Pe = min(P, L - p0)
        q = np.arange(p0 - w, p0 + Pe)
        xe = np.where(q >= 0, x[np.maximum(q, 0)], MAX)
        ve = (q >= 0) & valid[np.maximum(q, 0)]
        pre, suf = van_herk(xe[None, :], w)
        h = np.arange(-1, Pe)
        m = np.minimum(suf[0, h + 1], pre[0, h + w])
        rep = ve[h + w] & (p0 + h >= first)
        head = rep[1:] & ~(rep[:-1] & (m[:-1] == m[1:]))
        heads.append(m[1:][head])
    return np.concatenate(heads)


@pytest.mark.parametrize("k", [1, 3, 21, 31])
@pytest.mark.parametrize("w", [1, 2, 9, 64])
def test_packed_kmer_and_window_identities(k, w):
    rng = np.random.default_rng(7 * k + w)
    c2, m8, ln = packed_batch(rng, 16, 160)
    wm, rep = model_minimizer_packed(c2, m8, ln, k, w)
    wm0, rep0 = tm.minimizer_window_packed_torch(
        torch.from_numpy(c2), torch.from_numpy(m8), torch.from_numpy(ln), k, w)
    assert rep0.numpy().any()
    assert np.array_equal(rep, rep0.numpy())
    assert np.array_equal(wm, wm0.numpy().view(np.uint64))


@pytest.mark.parametrize("k,w", [(1, 1), (3, 20), (21, 9), (31, 2), (31, 64)])
def test_cont_form_identities(k, w):
    """The cont form on u8 codes (minimizer_window_torch(cont=True)) against
    the model of the same reads staged from the packed layout, as the
    kernel's u8 staging builds the same bit rows."""
    rng = np.random.default_rng(11 * k + w)
    codes, ln, c2, m8 = tm_kernel_batch(rng, 16, 320, 1, 320)
    wm, rep = model_minimizer_packed(c2, m8, ln, k, w, cont=True)
    wm0, rep0 = tm.minimizer_window_torch(torch.from_numpy(codes), torch.from_numpy(ln),
                                          k, w, cont=True)
    assert rep0.numpy().any()
    assert np.array_equal(rep, rep0.numpy())
    assert np.array_equal(wm, wm0.numpy().view(np.uint64))


TWO31 = 2147483648.0
FRAC_BITS = 14
FRAC_MASK = (1 << FRAC_BITS) - 1
# csrc/jump_hash.cu's bound on |y - p| / p while the seed's error is at most
# 2^-16: x (2^-47.6) over x, rounded up
REL_BOUND = 2.0**-47


def filtered_step(j: np.ndarray, d: np.ndarray, perturb: float = 0.0):
    """One iteration of csrc/jump_hash.cu's loop for b = j and divisors d
    (float64, exact): (floor, in_range, exact). Go's p = RN((b+1)
    RN(2^31/d)) is computed exactly; Y = p (1 + perturb) stands for the
    kernel's seed-and-FMA product, |perturb| <= REL_BOUND. The kernel reads
    z = RZ(Y + 2^38), whose mantissa is floor(Y 2^14) for Y < 2^38: F =
    floor(Y) and 14 fraction bits; a fraction of 0 or 2^14 - 1 (Y within
    2^-14 of an integer) takes p itself, the exact step. The loop goes on
    while z < 2^38 + n: in range and F < n."""
    p = (j + 1.0) * (TWO31 / d)
    y = p * (1.0 + perturb)
    code = np.floor(np.minimum(y, 2.0**38) * 2.0**FRAC_BITS).astype(np.int64)
    c = code & FRAC_MASK
    exact = (y < 2.0**38) & ((c == 0) | (c == FRAC_MASK))
    code[exact] = np.floor(p[exact] * 2.0**FRAC_BITS).astype(np.int64)
    v = np.where(exact, p, y)
    return code >> FRAC_BITS, v < 2.0**38, exact


def model_jump(keys: np.ndarray, n: int, perturb: float = 0.0):
    """csrc/jump_hash.cu's loop: (buckets, exact steps). d and j as doubles,
    then filtered_step; the lane goes on while the floor is in range and
    below n, and its bucket is its last j."""
    key = keys.astype(np.uint64).copy()
    j = np.zeros(key.shape, dtype=np.int64)
    live = np.ones(key.shape, dtype=bool)
    exact_steps = 0
    while live.any():
        idx = np.flatnonzero(live)
        key[idx] = key[idx] * U64(2862933555777941757) + U64(1)
        d = ((key[idx] >> U64(33)) + U64(1)).astype(np.float64)
        f, in_range, exact = filtered_step(j[idx].astype(np.float64), d, perturb)
        exact_steps += int(exact.sum())
        go = in_range & (f < n)
        j[idx[go]] = f[go]
        live[idx[~go]] = False
    return j.astype(np.int32), exact_steps


@pytest.mark.parametrize("n", [1, 2, 2000, 194481, 2**31 - 1])
def test_jump_loop_identities(n):
    rng = np.random.default_rng(n)
    keys = np.concatenate([adversarial_keys(),
                           rng.integers(0, 2**64 - 1, size=5000, dtype=np.uint64, endpoint=True)])
    for perturb in (-REL_BOUND, 0.0, REL_BOUND):
        assert np.array_equal(model_jump(keys, n, perturb)[0], jump_hash_np(keys, n))


@pytest.mark.parametrize("n", [1, 2, 923521, 5_000_000])
def test_values_binning_identities(n):
    """The values entry: skip only the sentinel, no dedup (equal neighbours
    come from different reads), the loop on all 64 bits, one atomic add per
    live value."""
    svals = np.concatenate([sorted_values(np.random.default_rng(n), 3000),
                            np.full(5, 0xFFFFFFFFFFFFFFFE, dtype=np.uint64)])
    svals.sort()
    live = svals != MAX
    model = np.bincount(model_jump(svals[live], n)[0], minlength=n)
    hist = torch.zeros(n, dtype=torch.int32)
    bin_scatter_values_torch(hist, torch.from_numpy(svals.view(np.int64)))
    assert hist.sum() == live.sum() > 3000
    assert np.array_equal(hist.numpy(), model)


@pytest.mark.parametrize("k,w", [(1, 1), (3, 20), (21, 9), (31, 2), (15, 64)])
@pytest.mark.parametrize("cont", [False, True])
def test_record_scan_identities(k, w, cont):
    """The record scan's segments (the kernel's P, and small ones that put
    many segment boundaries inside short runs) with their one-entry halo
    give exactly the run heads of the one-piece scan, as a multiset."""
    rng = np.random.default_rng(13 * k + w + cont)
    L = 2000
    codes, ln, c2, m8 = tm_kernel_batch(rng, 1, L, L, L, n_frac=0.05)
    x, valid = model_entries(c2, m8, ln, k, w, cont)
    want = np.sort(tm.record_run_heads_torch(torch.from_numpy(codes[0]), k, w, cont)
                   .numpy().view(np.uint64))
    assert want.size > 0
    nseg = -(-L // 256)
    for P in (-(-L // nseg), 7, 1, 64):
        got = model_record_heads(x[0], valid[0], k, w, cont, P)
        assert np.array_equal(np.sort(got), want), P


def test_chunk_bound_of_the_cont_form():
    """chunks() refuses a cap whose second chunk's first window entry,
    cap - H + k, lies before position H - 1, where the span reaches k."""
    for k, w in ((15, 5), (21, 9), (31, 2), (3, 64), (11, 1)):
        H = w + k - 1
        low = H + max(1, w - 2)
        assert (low - H) + k >= H - 1
        assert chunks(10_000, low, k, w)[1][0] == low - H
        with pytest.raises(ValueError):
            chunks(10_000, low - 1, k, w)
