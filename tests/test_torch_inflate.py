"""The inflate of .gz inputs in hulk_tpu_torch/stream/fastq.py: whole gzip
members in the native inflater, a few MB a step, into a pool of reused
output buffers, with zlib (Python's gzip) taking over from a member too
large for the cap, from the start when the gzip trailer's size passes it,
and from a member the native inflater finds corrupt.

The native inflater alone gives zlib's bytes for every kind of DEFLATE
stream zlib writes (stored, fixed and dynamic blocks; every strategy; small
windows), and refuses what zlib refuses: a flipped bit, a cut-short member.

Each case reads one input through `batch_reads_native` twice: by the member
route (the default cap) and by the zlib route (the module-level cap set to
0, so every file takes Python's gzip from its start). The two give the same
reads in the same order with the same origins: every row's bases and its
(file index, index in its file), taken from the batches' codes, lengths,
`file_idx` and `reads_in_file_end`. The two routes cut the stream into
chunks at different places, so the rows may split into batches otherwise;
interval cuts (`cut_every`) fall on the same reads. The counters
`input.inflate_member_bytes` and `input.inflate_zlib_bytes` show which
route inflated what. Tolerance: none.
"""
import gzip
import threading
import time
import zlib

import numpy as np
import pytest

from hulk_tpu_torch import native, spans
from hulk_tpu_torch.stream import fastq
from hulk_tpu_torch.stream.fastq import LongRead, batch_reads_native

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="native runtime unavailable")

LD, ZL = "input.inflate_member_bytes", "input.inflate_zlib_bytes"


@pytest.fixture(autouse=True)
def _spans(monkeypatch):
    """Spans on for the counters, and a pool of its own for each test."""
    monkeypatch.setattr(fastq, "_free_bufs", [])
    spans.enable(True)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


def member(data: bytes, level: int = 1) -> bytes:
    z = zlib.compressobj(level, zlib.DEFLATED, 31)
    return z.compress(data) + z.flush()


def fastq_bytes(rng, n: int, start: int = 0) -> bytes:
    out = []
    for i in range(n):
        L = int(rng.integers(50, 200))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                         p=[0.249, 0.249, 0.249, 0.249, 0.004]).tobytes()
        out.append(b"@r%d\n%s\n+\n%s\n" % (start + i, seq, b"I" * L))
    return b"".join(out)


def fasta_bytes(rng, n: int) -> bytes:
    out = []
    for i in range(n):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(rng.integers(100, 900)))
        lines = [seq[a:a + 60].tobytes() for a in range(0, seq.shape[0], 60)]
        out.append(b">c%d\n" % i + b"\n".join(lines) + b"\n")
    return b"".join(out)


def members_at(data: bytes, cuts) -> bytes:
    """data as gzip members cut at the byte offsets `cuts` (mid-line
    wherever they fall)."""
    edges = [0, *cuts, len(data)]
    return b"".join(member(data[a:b]) for a, b in zip(edges, edges[1:]))


def rows(paths, **kw):
    """Each read the batches carry: (file index, index in the file, bases)."""
    out = []
    for b in batch_reads_native([str(p) for p in paths], batch_size=500, raw=True, **kw):
        if isinstance(b, LongRead):
            out.append((b.file_idx, b.reads_in_file_end - 1, b.codes.tobytes()))
            continue
        R = b.lengths.shape[0]
        for i in range(R):
            out.append((b.file_idx, b.reads_in_file_end - R + i,
                        b.codes[i, :b.lengths[i]].tobytes()))
    return out


def both_routes(monkeypatch, paths, **kw):
    """(member route rows, its counters, zlib route rows, its counters)."""
    spans.reset()
    got = rows(paths, **kw)
    got_counts = spans.counters()
    spans.reset()
    with monkeypatch.context() as m:
        m.setattr(fastq, "_INFLATE_CAP", 0)
        want = rows(paths, **kw)
    return got, got_counts, want, spans.counters()


def inflated(path) -> int:
    with gzip.open(path, "rb") as fh:
        return len(fh.read())


def _multi(tmp_path, rng):
    data = fastq_bytes(rng, 3000)
    p = tmp_path / "multi.fq.gz"
    # members of mixed size, one empty, each cut mid-line
    edges = [7, 5000, 5000, 90_001, 310_457, 311_000, len(data) - 3]
    parts = [data[a:b] for a, b in zip([0] + edges, edges + [len(data)])]
    p.write_bytes(b"".join(member(x, level) for x, level in zip(parts, [1, 6, 1, 9, 1, 1, 1, 1])))
    return [p]


def _single(tmp_path, rng):
    p = tmp_path / "single.fq.gz"
    p.write_bytes(member(fastq_bytes(rng, 2000)))
    return [p]


def _cat_lanes(tmp_path, rng):
    """Two lane files joined with cat: one file of both lanes' members."""
    lanes = [members_at(fastq_bytes(rng, 1200, 1200 * k), [40_000, 123_456]) for k in range(2)]
    p = tmp_path / "joined.fq.gz"
    p.write_bytes(lanes[0] + lanes[1])
    return [p]


def _nul_padded(tmp_path, rng):
    p = tmp_path / "padded.fq.gz"
    data = fastq_bytes(rng, 1500)
    p.write_bytes(member(data[:100_000]) + b"\0" * 37 + member(data[100_000:]) + b"\0" * 511)
    return [p]


def _two_files(tmp_path, rng):
    out = []
    for k in range(2):
        p = tmp_path / f"lane{k}.fq.gz"
        p.write_bytes(members_at(fastq_bytes(rng, 1000), [33_333, 66_666]))
        out.append(p)
    return out


CASES = {"multi_member": _multi, "single_member": _single, "cat_lanes": _cat_lanes,
         "nul_padding": _nul_padded, "two_files": _two_files}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_member_route_gives_the_zlib_routes_reads(tmp_path, monkeypatch, case):
    paths = CASES[case](tmp_path, np.random.default_rng(zlib.crc32(case.encode())))
    got, got_counts, want, want_counts = both_routes(monkeypatch, paths)
    assert len(want) > 1000 and got == want
    total = sum(inflated(p) for p in paths)
    assert got_counts.get(LD) == total and not got_counts.get(ZL)
    assert want_counts.get(ZL) == total and not want_counts.get(LD)


def test_fasta_takes_the_member_route(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    data = fasta_bytes(rng, 400)
    p = tmp_path / "contigs.fa.gz"
    p.write_bytes(members_at(data, [1000, 77_777, 150_001]))
    got, got_counts, want, _ = both_routes(monkeypatch, [p], fasta=True)
    assert len(want) == 400 and got == want
    assert got_counts.get(LD) == len(data)


@pytest.mark.parametrize("every", [250, 1000])
def test_interval_cuts_fall_on_the_same_reads(tmp_path, monkeypatch, every):
    paths = _two_files(tmp_path, np.random.default_rng(12))

    def ends(**kw):
        total, out = 0, []
        for b in batch_reads_native([str(p) for p in paths], batch_size=500, raw=True,
                                    cut_every=every, **kw):
            total += b.lengths.shape[0]
            out.append(total)
        return out

    got = ends()
    with monkeypatch.context() as m:
        m.setattr(fastq, "_INFLATE_CAP", 0)
        want = ends()
    cuts = set(range(every, 2000, every))
    assert cuts <= set(got) and cuts <= set(want)
    got_rows, _, want_rows, _ = both_routes(monkeypatch, paths, cut_every=every)
    assert got_rows == want_rows


@pytest.mark.parametrize("skip", [10, 999, 1000, 1001, 1999])
def test_seek_resume_skips_inside_and_across_members(tmp_path, monkeypatch, skip):
    """Members of exactly 1,000 records: 999 and 1,001 skip inside a member,
    1,000 to its boundary, 1,999 through two members into the third."""
    rng = np.random.default_rng(13)
    recs = [fastq_bytes(rng, 1000, 1000 * k) for k in range(3)]
    p = tmp_path / "resume.fq.gz"
    p.write_bytes(b"".join(member(r) for r in recs))
    progress = {}
    got, got_counts, want, _ = both_routes(monkeypatch, [p], skip_reads=skip)
    assert len(got) == 3000 - skip and got == want
    assert got[0][1] == skip  # the first row's index in its file
    assert got_counts.get(LD) == sum(map(len, recs))
    list(batch_reads_native([str(p)], batch_size=500, raw=True, skip_reads=skip,
                            progress=progress))
    assert progress["parse_bytes"] == len(b"".join(recs)[_line_offset(recs, 4 * skip):])


def _line_offset(recs, n_lines: int) -> int:
    data = b"".join(recs)
    at = 0
    for _ in range(n_lines):
        at = data.index(b"\n", at) + 1
    return at


def _count_calls(monkeypatch):
    """Wrap the native inflate; returns the list of each call's result."""
    calls = []
    real = native.inflate_members

    def counted(src, pos, out, want, stop=None):
        r = real(src, pos, out, want, stop)
        calls.append((r[0], out.shape[0]))
        return r

    monkeypatch.setattr(native, "inflate_members", counted)
    return calls


def test_a_member_past_the_cap_takes_zlib_from_its_own_offset(tmp_path, monkeypatch):
    """The cap below the pool's least buffer: every buffer is the cap, so the
    member past it costs one failed attempt, and zlib inflates from it on."""
    rng = np.random.default_rng(14)
    small = [fastq_bytes(rng, 200, 200 * k) for k in range(2)]
    big = fastq_bytes(rng, 3000, 400)
    tail = fastq_bytes(rng, 200, 3400)
    p = tmp_path / "big.fq.gz"
    p.write_bytes(member(small[0]) + member(small[1]) + member(big) + member(tail))
    monkeypatch.setattr(fastq, "_INFLATE_CAP", 200_000)
    assert len(small[0]) + len(small[1]) < 200_000 < len(big)
    calls = _count_calls(monkeypatch)
    spans.reset()
    got = rows([p])
    counts = spans.counters()
    assert [n for n, _ in calls if n < 0] == [-2]
    assert counts[LD] == len(small[0]) + len(small[1])
    assert counts[ZL] == len(big) + len(tail)
    monkeypatch.setattr(fastq, "_INFLATE_CAP", 0)
    assert got == rows([p])


def test_a_member_past_the_buffer_grows_it_once_to_the_cap(tmp_path, monkeypatch):
    """A member larger than the buffer the last members asked for fails once
    there; the buffer then grows straight to the cap and takes it."""
    rng = np.random.default_rng(15)
    small = fastq_bytes(rng, 100)
    big = fastq_bytes(rng, 4000, 100)
    p = tmp_path / "grow.fq.gz"
    p.write_bytes(member(big[:10]) + member(small) + member(big) + member(small[:5]))
    monkeypatch.setattr(fastq, "_INFLATE_MIN", 64 << 10)
    monkeypatch.setattr(fastq, "_INFLATE_CAP", 4 << 20)
    calls = _count_calls(monkeypatch)
    spans.reset()
    got = rows([p])
    failed = [(n, cap) for n, cap in calls if n < 0]
    assert failed == [(-2, 64 << 10)]
    assert any(cap == 4 << 20 and n > 0 for n, cap in calls)
    assert spans.counters()[LD] == 10 + len(small) + len(big) + 5 and not spans.counters().get(ZL)
    monkeypatch.setattr(fastq, "_INFLATE_CAP", 0)
    assert got == rows([p])


def test_a_trailer_size_past_the_cap_goes_straight_to_zlib(tmp_path, monkeypatch):
    rng = np.random.default_rng(16)
    data = fastq_bytes(rng, 2000)
    p = tmp_path / "one.fq.gz"
    p.write_bytes(member(data))
    monkeypatch.setattr(fastq, "_INFLATE_CAP", len(data) - 1)
    calls = _count_calls(monkeypatch)
    spans.reset()
    got = rows([p])
    assert calls == []
    assert spans.counters() == {ZL: len(data)}
    monkeypatch.setattr(fastq, "_INFLATE_CAP", len(data))
    assert got == rows([p]) and spans.counters()[LD] == len(data)


def _truncated(data: bytes) -> bytes:
    z = members_at(data, [100_000])
    return z[:len(z) - 5000]


def _corrupt(data: bytes) -> bytes:
    z = bytearray(members_at(data, [100_000]))
    z[len(z) - 5000:len(z) - 4990] = b"\xff" * 10
    return bytes(z)


def _bad_crc(data: bytes) -> bytes:
    z = bytearray(members_at(data, [100_000]))
    z[-8] ^= 0x01
    return bytes(z)


def _trailing_junk(data: bytes) -> bytes:
    return members_at(data, [100_000]) + b"not gzip"


@pytest.mark.parametrize("spoil", [_truncated, _corrupt, _bad_crc, _trailing_junk],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_bad_file_raises_what_the_zlib_route_raises(tmp_path, monkeypatch, spoil):
    p = tmp_path / "bad.fq.gz"
    p.write_bytes(spoil(fastq_bytes(np.random.default_rng(17), 1500)))

    def error():
        with pytest.raises(Exception) as e:
            rows([p])
        return type(e.value), str(e.value)

    got = error()
    monkeypatch.setattr(fastq, "_INFLATE_CAP", 0)
    assert got == error()


def test_the_pool_lends_at_most_depth_plus_two_buffers(tmp_path, monkeypatch):
    """Many small members, 16 KB steps and a slow consumer that keeps every
    batch, over three files back to back: every batch still equals the zlib
    route's at the end (no buffer was written while the packer read it or
    a batch held it), and the pool made no more than depth + 2 buffers."""
    rng = np.random.default_rng(18)
    paths = []
    for k in range(3):
        data = fastq_bytes(rng, 1500, 1500 * k)
        p = tmp_path / f"many{k}.fq.gz"
        p.write_bytes(members_at(data, list(range(3000, len(data), 3000))))
        paths.append(p)
    monkeypatch.setattr(fastq, "_INFLATE_MIN", 64 << 10)
    monkeypatch.setattr(fastq, "_INFLATE_STEP", 16 << 10)
    made = []
    real = fastq._new_buffer
    monkeypatch.setattr(fastq, "_new_buffer", lambda n: made.append(n) or real(n))
    kept = []
    for b in batch_reads_native([str(p) for p in paths], batch_size=100, raw=True):
        kept.append(b)
        time.sleep(0.002)
    assert 0 < len(made) <= fastq._PREFETCH + 2
    assert len(fastq._free_bufs) == len(made)
    got = []
    for b in kept:
        R = b.lengths.shape[0]
        got += [(b.file_idx, b.reads_in_file_end - R + i, b.codes[i, :b.lengths[i]].tobytes())
                for i in range(R)]
    monkeypatch.setattr(fastq, "_INFLATE_CAP", 0)
    assert got == rows(paths)


def test_leaving_the_batches_mid_file_stops_the_inflate_thread(tmp_path, monkeypatch):
    rng = np.random.default_rng(19)
    data = fastq_bytes(rng, 3000)
    p = tmp_path / "left.fq.gz"
    p.write_bytes(members_at(data, list(range(2000, len(data), 2000))))
    monkeypatch.setattr(fastq, "_INFLATE_MIN", 64 << 10)
    monkeypatch.setattr(fastq, "_INFLATE_STEP", 8 << 10)

    def inflating():
        return [t for t in threading.enumerate() if t.name == "hulk-gunzip"]

    before = set(inflating())
    it = batch_reads_native([str(p)], batch_size=50, raw=True)
    next(it)
    time.sleep(0.3)  # the inflate fills the queue and waits for a buffer
    it.close()
    deadline = time.monotonic() + 5
    while set(inflating()) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not set(inflating()) - before


def _streams():
    rng = np.random.default_rng(20)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    runs = b"".join(bytes(rng.choice(np.frombuffer(b"xyzw", np.uint8), size=int(k)))
                    * int(r) for k, r in zip(rng.integers(1, 40, 3000), rng.integers(1, 20, 3000)))
    return {
        "empty": b"",
        "one_byte": b"a",
        "random": rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(),
        "one_letter": b"A" * 100_000,
        "bases": rng.choice(acgt, size=50_000).tobytes(),
        "fastq": fastq_bytes(rng, 2000),
        "repeats": runs,
    }


STREAMS = _streams()
STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED,
              "huffman_only": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE, "fixed": zlib.Z_FIXED}


def _inflate(comp: bytes, cap: int | None = None, want: int = 1 << 62):
    src = np.frombuffer(comp, np.uint8)
    out = np.empty(cap if cap is not None else 4 * len(comp) + (1 << 20), np.uint8)
    n, pos, _ = native.inflate_members(src, 0, out, want)
    return n, pos, out[:max(n, 0)].tobytes()


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_the_native_inflater_gives_zlibs_bytes(kind, level, strategy):
    data = STREAMS[kind]
    for wbits in (9, 15):
        z = zlib.compressobj(level, zlib.DEFLATED, 16 + wbits, 8, STRATEGIES[strategy])
        comp = z.compress(data) + z.flush()
        assert _inflate(comp) == (len(data), len(comp), data)


def test_the_native_inflater_refuses_what_zlib_refuses():
    """A flipped bit anywhere past the header: the native inflater gives
    zlib's bytes or refuses the member (-1) wherever zlib raises; a member
    cut short is refused; a member past the room is -2 at its offset."""
    rng = np.random.default_rng(21)
    data = STREAMS["fastq"]
    for t in range(200):
        comp = bytearray(member(data, [1, 6][t % 2]))
        comp[int(rng.integers(10, len(comp)))] ^= 1 << int(rng.integers(0, 8))
        try:
            want = zlib.decompress(bytes(comp), 31)
        except zlib.error:
            want = None
        n, _, got = _inflate(bytes(comp))
        assert (n == -1) if want is None else got == want
    comp = member(data)
    for cut in [1, 4, 8, 9, 20, len(comp) // 2]:
        assert _inflate(comp[:-cut])[0] == -1
    assert _inflate(comp, cap=1000)[:2] == (-2, 0)
    two = member(data[:1000]) + member(data[1000:])
    assert _inflate(two, want=1)[:2] == (1000, len(member(data[:1000])))


def test_readers_in_many_threads_share_the_buffers_safely(tmp_path, monkeypatch):
    """Twelve readers at once, more than the cores, with a short switch
    interval: each gets the zlib route's reads, and the shared free list
    ends holding no more buffers than the readers could lend out at once."""
    import sys

    rng = np.random.default_rng(22)
    paths = []
    for k in range(3):
        p = tmp_path / f"shared{k}.fq.gz"
        p.write_bytes(members_at(fastq_bytes(rng, 600, 600 * k), list(range(2500, 100_000, 2500))))
        paths.append(p)
    want = {}
    with monkeypatch.context() as m:
        m.setattr(fastq, "_INFLATE_CAP", 0)
        for p in paths:
            want[p] = rows([p])
    monkeypatch.setattr(fastq, "_INFLATE_MIN", 64 << 10)
    monkeypatch.setattr(fastq, "_INFLATE_STEP", 8 << 10)
    readers = 12
    got, errors = {}, []

    def read(i):
        try:
            got[i] = rows([paths[i % 3]])
        except BaseException as e:  # reported below
            errors.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=read, args=(i,)) for i in range(readers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(got[i] == want[paths[i % 3]] for i in range(readers))
    assert len(fastq._free_bufs) <= readers * (fastq._PREFETCH + 2)
