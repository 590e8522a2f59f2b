"""The member inflate of a multi-member .gz on several threads
(hulk_tpu_torch/stream/fastq.py, `_Members.ahead`): after a first step in
the gunzip thread, the members inflate as ordered tasks on up to W threads,
each later task from a member start it guessed (native.next_member), and a
task's bytes are used only when its start is the exact end of the bytes
before it. Whatever the input, the bytes are the one-thread route's.

Every case reads one file through `_chunks_of` at W = 1, 2, 3 and 8 and
compares the bytes with the one-thread route's (W = 1) and with Python's
gzip. The nested case stores a whole gzip member inside another member's
stored block: the guess finds it, it inflates clean with a good CRC-32, and
only the chain check drops it. Tolerance: none.
"""
import gzip
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from hulk_tpu_torch import native, spans
from hulk_tpu_torch.stream import fastq
from hulk_tpu_torch.stream.fastq import batch_reads_native

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="native runtime unavailable")

WORKERS = [2, 3, 8]
TASKS, AHEAD, MISSES = ("input.inflate_tasks", "input.inflate_ahead_bytes",
                        "input.inflate_ahead_misses")
ROUTE = (TASKS, AHEAD, MISSES)


@pytest.fixture(autouse=True)
def _spans(monkeypatch):
    """Spans on for the counters, small steps and buffers (so that a small
    file has many tasks), and a pool of its own for each test."""
    monkeypatch.setattr(fastq, "_free_bufs", [])
    monkeypatch.setattr(fastq, "_INFLATE_MIN", 1 << 20)
    monkeypatch.setattr(fastq, "_INFLATE_STEP", 16 << 10)
    spans.enable(True)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


def member(data: bytes, level: int = 1) -> bytes:
    z = zlib.compressobj(level, zlib.DEFLATED, 31)
    return z.compress(data) + z.flush()


def stored_member(blocks: list) -> bytes:
    """One gzip member of stored DEFLATE blocks, one a piece of `blocks`
    (each at most 65,535 bytes), so that each piece lies whole, byte for
    byte, in the compressed file."""
    out = [b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"]
    for i, b in enumerate(blocks):
        out.append(bytes([i == len(blocks) - 1]) + struct.pack("<HH", len(b), len(b) ^ 0xFFFF) + b)
    data = b"".join(blocks)
    out.append(struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF))
    return b"".join(out)


def bgzf_block(data: bytes) -> bytes:
    """A BGZF block (htslib's layout): a gzip member with an FEXTRA field
    'BC' holding the block's size less one."""
    z = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = z.compress(data) + z.flush()
    bsize = 18 + len(body) + 8 - 1
    head = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + struct.pack("<HBBHH", 6, 66, 67, 2, bsize)
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def fastq_bytes(rng, n: int, start: int = 0) -> bytes:
    out = []
    for i in range(n):
        L = int(rng.integers(50, 200))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                         p=[0.249, 0.249, 0.249, 0.249, 0.004]).tobytes()
        out.append(b"@r%d\n%s\n+\n%s\n" % (start + i, seq, b"I" * L))
    return b"".join(out)


def members_at(data: bytes, step: int, level: int = 1) -> bytes:
    return b"".join(member(data[a:a + step], level) for a in range(0, len(data), step))


def read(path, workers: int) -> bytes:
    """The bytes `_chunks_of` yields at `workers`, each chunk given back to
    the pool once copied."""
    pool = fastq._InflatePool(fastq._PREFETCH + 1 + workers)
    out = []
    for c in fastq._chunks_of(str(path), pool, workers):
        out.append(bytes(c))
        pool.give(c)
    return b"".join(out)


def counted(path, workers: int) -> tuple[bytes, dict]:
    spans.reset()
    got = read(path, workers)
    return got, spans.counters()


def _mock(tmp_path):
    from hulkbench.inputs import mock_community
    from hulkbench.tests.conftest import tiny_cell

    p = dict(tiny_cell("reads-k21.samples-p8")["config"]["input"], reads_per_file=2400, chunk=150)
    return mock_community.generate(p, 2 ** 31 + 11, str(tmp_path))["files"]["R1"]


def _bgzf(tmp_path):
    data = fastq_bytes(np.random.default_rng(31), 3000)
    p = tmp_path / "reads.fq.bgz.gz"
    blocks = [bgzf_block(data[a:a + 65280]) for a in range(0, len(data), 65280)]
    p.write_bytes(b"".join(blocks) + bgzf_block(b""))  # BGZF's empty last block
    return p


def _padded(tmp_path):
    rng = np.random.default_rng(32)
    data = fastq_bytes(rng, 2500)
    parts = [member(data[a:a + 30_000]) + b"\0" * int(rng.integers(0, 3000))
             for a in range(0, len(data), 30_000)]
    p = tmp_path / "padded.fq.gz"
    p.write_bytes(b"".join(parts))
    return p


def _nested(tmp_path):
    """Members of FASTQ, one of them a stored member whose blocks hold, deep
    inside, a whole gzip member (FASTQ text around it has no 0x1f)."""
    rng = np.random.default_rng(33)
    data = fastq_bytes(rng, 2500)
    inner = member(fastq_bytes(rng, 40, 90_000), 6)
    filler = fastq_bytes(rng, 800, 50_000)
    outer = stored_member([filler[:60_000], filler[60_000:100_000] + inner + filler[:20_000],
                           filler[100_000:160_000]])
    p = tmp_path / "nested.fq.gz"
    p.write_bytes(members_at(data[:60_000], 20_000) + outer + members_at(data[60_000:], 20_000))
    return p


def _single(tmp_path):
    p = tmp_path / "single.fq.gz"
    p.write_bytes(member(fastq_bytes(np.random.default_rng(34), 2000)))
    return p


def _varied(tmp_path):
    """Members from 1 byte to 120 kB at mixed levels, one empty."""
    rng = np.random.default_rng(35)
    data = fastq_bytes(rng, 3000)
    cuts = np.sort(rng.choice(len(data), size=40, replace=False))
    edges = [0, *cuts.tolist(), cuts[-1], len(data)]
    p = tmp_path / "varied.fq.gz"
    p.write_bytes(b"".join(member(data[a:b], int(rng.choice([0, 1, 6, 9])))
                           for a, b in zip(edges, edges[1:])))
    return p


CASES = {"mock_generator": _mock, "bgzf_64k": _bgzf, "nul_padding": _padded,
         "nested_member": _nested, "single_member": _single, "varied_members": _varied}


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_tasks_give_the_one_thread_routes_bytes(tmp_path, case, workers):
    path = CASES[case](tmp_path)
    with open(path, "rb") as fh:
        want = gzip.decompress(fh.read())
    one, one_counts = counted(path, 1)
    got, counts = counted(path, workers)
    assert one == want
    assert got == want
    assert not set(ROUTE) & set(one_counts)
    assert counts["input.inflate_member_bytes"] == len(want)
    if case == "single_member":
        assert not set(ROUTE) & set(counts)
    else:
        assert counts[TASKS] > 0 and counts[AHEAD] > 0
    if case == "nested_member":
        assert counts[MISSES] > 0
    if case in ("mock_generator", "bgzf_64k"):
        assert MISSES not in counts


def test_the_nested_member_is_found_by_the_guess(tmp_path):
    """The guess does land on the member stored inside the other one, and
    that member inflates clean: only the chain check can drop it."""
    path = _nested(tmp_path)
    src = np.fromfile(path, np.uint8)
    raw = src.tobytes()
    outer = raw.index(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff\x00")
    at = native.next_member(src, outer + 1, src.shape[0])
    assert outer < at and raw[at:at + 3] == b"\x1f\x8b\x08"
    out = np.empty(1 << 20, np.uint8)
    n, end, _ = native.inflate_members(src, at, out, 1 << 62, at + 1)
    assert n > 0 and gzip.decompress(raw[at:end]) == out[:n].tobytes()
    assert gzip.decompress(raw).find(raw[at:end]) > 0  # it is the outer member's data


@pytest.mark.parametrize("workers", WORKERS)
def test_a_corrupt_member_mid_file_raises_what_gzip_raises(tmp_path, monkeypatch, workers):
    data = fastq_bytes(np.random.default_rng(36), 3000)
    z = bytearray(members_at(data, 20_000))
    bad = len(z) // 2
    z[bad:bad + 12] = b"\xff" * 12
    p = tmp_path / "bad.fq.gz"
    p.write_bytes(bytes(z))

    def outcome(w):
        pool = fastq._InflatePool(fastq._PREFETCH + 1 + w)
        out = []
        with pytest.raises(Exception) as e:
            for c in fastq._chunks_of(str(p), pool, w):
                out.append(bytes(c))
                pool.give(c)
        return b"".join(out), type(e.value), str(e.value)

    got, one = outcome(workers), outcome(1)
    assert got == one
    with monkeypatch.context() as m:
        m.setattr(fastq, "_INFLATE_CAP", 0)  # Python's gzip from the start
        assert outcome(workers)[1:] == got[1:]


@pytest.mark.parametrize("workers", WORKERS)
def test_a_member_past_the_cap_takes_zlib_from_its_offset(tmp_path, monkeypatch, workers):
    rng = np.random.default_rng(37)
    data = fastq_bytes(rng, 3000)
    big = fastq_bytes(rng, 2000, 3000)
    p = tmp_path / "big.fq.gz"
    p.write_bytes(members_at(data[:150_000], 15_000) + member(big) + members_at(data[150_000:], 15_000))
    monkeypatch.setattr(fastq, "_INFLATE_CAP", 200_000)
    monkeypatch.setattr(fastq, "_INFLATE_MIN", 64 << 10)
    assert len(big) > 200_000
    got, counts = counted(p, workers)
    assert got == read(p, 1) == data[:150_000] + big + data[150_000:]
    assert counts["input.inflate_member_bytes"] == 150_000
    assert counts["input.inflate_zlib_bytes"] == len(big) + len(data) - 150_000


def _threads(prefix):
    return {t for t in threading.enumerate() if t.name.startswith(prefix)}


def test_leaving_with_tasks_in_flight_hangs_on_no_buffer(tmp_path):
    """The consumer leaves after one batch with tasks in flight: the gunzip
    thread and the workers end, the chunks it still holds are never written
    again, and no buffer is in the free list twice."""
    rng = np.random.default_rng(38)
    paths = []
    for k in range(2):
        p = tmp_path / f"left{k}.fq.gz"
        p.write_bytes(members_at(fastq_bytes(rng, 4000, 4000 * k), 12_000))
        paths.append(str(p))
    before = _threads("hulk-gunzip") | _threads("hulk-inflate")
    kept = []
    it = batch_reads_native(paths[:1], batch_size=50, raw=True, inflate_workers=8)
    for _ in range(3):
        b = next(it)
        kept.append((b, b.codes.tobytes()))
    time.sleep(0.3)  # the tasks run ahead and wait on the full queue
    it.close()
    deadline = time.monotonic() + 10
    while (_threads("hulk-gunzip") | _threads("hulk-inflate")) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not (_threads("hulk-gunzip") | _threads("hulk-inflate")) - before
    ids = [id(b) for b in fastq._free_bufs]
    assert len(ids) == len(set(ids))
    for w in (8, 1):  # more reads take buffers from the free list
        list(batch_reads_native(paths, batch_size=500, raw=True, inflate_workers=w))
    ids = [id(b) for b in fastq._free_bufs]
    assert len(ids) == len(set(ids))
    assert all(b.codes.tobytes() == codes for b, codes in kept)


def test_at_one_worker_no_thread_or_counter_is_added(tmp_path, monkeypatch):
    """-p 1: the gunzip thread alone inflates; no worker pool starts, and
    none of the route's counters or its wait span is written."""
    rng = np.random.default_rng(39)
    p = tmp_path / "p1.fq.gz"
    p.write_bytes(members_at(fastq_bytes(rng, 3000), 10_000))

    def refuse(*a, **k):
        raise AssertionError("a worker pool started at one worker")

    monkeypatch.setattr(fastq, "ThreadPoolExecutor", refuse)
    before = threading.active_count()
    seen = []
    for _ in batch_reads_native([str(p)], batch_size=200, raw=True, inflate_workers=1):
        seen.append({t.name for t in threading.enumerate()})
    assert all(not any(n.startswith("hulk-inflate") for n in names) for names in seen)
    assert max(len(names) for names in seen) <= before + 1
    assert not set(ROUTE) & set(spans.counters())
    assert not any(r.name == "input.inflate_wait" for r in spans.records())
    assert {r.thread for r in spans.records() if r.name == "input.gunzip"} == {"hulk-gunzip"}


def test_the_tasks_run_on_their_own_threads_under_the_job(tmp_path):
    """At W > 1 each task is an `input.gunzip` span in the worker that ran
    it, under the span the file's read started in; the gunzip thread waits
    for each in `input.inflate_wait`."""
    p = tmp_path / "w.fq.gz"
    p.write_bytes(members_at(fastq_bytes(np.random.default_rng(40), 3000), 10_000))
    with spans.span("job"):
        list(batch_reads_native([str(p)], batch_size=200, raw=True, inflate_workers=3))
    recs = spans.records()
    job = next(r for r in recs if r.name == "job")
    workers = {r.thread for r in recs if r.name == "input.gunzip"} - {"hulk-gunzip"}
    assert workers and all(t.startswith("hulk-inflate") for t in workers)
    assert all(r.job == job.id for r in recs if r.name == "input.gunzip")
    assert any(r.name == "input.inflate_wait" and r.thread == "hulk-gunzip" for r in recs)


def test_the_guess_needs_a_header_that_parses(tmp_path):
    """next_member passes over bytes that begin like a header but are not
    one (a flag bit 5-7 set, a field past the end, block type 3) and
    returns the range's end when it finds none."""
    good = member(b"ACGT" * 100)
    junk = [b"\x1f\x8b\x08\xe0" + bytes(20), b"\x1f\x8b\x08\x00" + bytes(6) + b"\x07" + bytes(12),
            b"\x1f\x8b\x07\x00" + bytes(20), b"\x1f\x8b\x08\x00" + bytes(4)]
    for j in junk:
        src = np.frombuffer(b"AC" + j + b"GT" + good, np.uint8)
        assert native.next_member(src, 0, src.shape[0]) == 4 + len(j)
        assert native.next_member(src, 0, 4 + len(j)) == 4 + len(j)
    src = np.frombuffer(b"\x1f\x8b\x08\x08" + b"no end to the name", np.uint8)
    assert native.next_member(src, 0, src.shape[0]) == src.shape[0]
