"""Host input pipeline: FASTQ/FASTA(.gz) streaming -> fixed-shape batches.

Line-level behaviour mirrors the reference pipeline (src/pipeline/sketch.go):
FASTQ reads are consumed 4 lines at a time with no validation beyond the '@'
leader (DataStreamer + FastqHandler, sketch.go:40-161); FASTA mode
accumulates sequence lines until the next '>' header; gzip is detected by
filename suffix. Quality data is parsed but unused, as in the reference.

Batches are padded to fixed shapes from a small set of length buckets so XLA
compiles once per bucket rather than per batch.
"""
from __future__ import annotations

import gzip
import mmap
import os
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Iterable, Iterator, NamedTuple

import numpy as np

from hulk_tpu_torch import spans
from hulk_tpu_torch.ops.encode import PackedReads, pack_reads


class FastqError(ValueError):
    pass


@dataclass
class LongRead:
    """ONE read too long for the fixed-shape batched path (> the top length
    bucket). The pipeline scans it blockwise (ops/longread.py) with bounded
    memory; it occupies one global read index (interval accounting) like any
    other read. The reference has no length cap (minimizer.go:62-76)."""

    codes: np.ndarray  # [L] uint8 base codes (0-4)
    file_idx: int | None = None
    reads_in_file_end: int | None = None


@dataclass
class RawReads:
    """An UNPADDED batch straight from the native parser: codes is the
    parser's strided [rows, stride] array with garbage beyond each read's
    length (the native transfer-group packer applies pad-5 semantics from
    `lengths` when nibble-packing, so the padded intermediate is never
    materialised). Only the single-device stream consumes these; every other
    consumer gets padded PackedReads."""

    codes: np.ndarray  # [rows, stride] uint8, C-contiguous, rows == live reads
    lengths: np.ndarray  # [rows] int32 (0 allowed: empty records, as padded)
    bucket: int  # the length bucket this batch's device shape uses
    file_idx: int | None = None
    reads_in_file_end: int | None = None


def prefetch_batches(batches, depth: int, name: str, span_names: tuple):
    """Run a batch iterator in a background thread with a bounded queue.

    The host input path (gunzip + parse + pack, all GIL-releasing) then
    overlaps the device stream dispatch instead of serialising with it —
    the reference gets the same overlap from its DataStreamer/FastqHandler
    goroutines (src/pipeline/pipeline.go:61-70). Exceptions raised by the
    producer propagate to the consumer; the producer stops if the consumer
    abandons the iterator.

    The caller names the thread and its two spans (hulk_tpu_torch.spans):
    each next() of the iterator in the thread and each get in the consumer,
    in that order in span_names. A step span of None leaves the spans of the
    thread's work to the iterator itself.
    """
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    step, get = span_names

    def put(b) -> bool:
        while not stop.is_set():
            try:
                q.put(b, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            it = iter(batches)
            while True:
                with spans.span(step) if step else nullcontext():
                    b = next(it, done)
                if b is done:
                    break
                if not put(b):
                    return
            put(done)
        except BaseException as e:  # propagate to the consumer
            put(e)

    t = threading.Thread(target=spans.carry(worker), daemon=True, name=name)
    t.start()
    try:
        while True:
            with spans.span(get):
                item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _open_lines(path: str) -> Iterator[bytes]:
    fh = gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")
    with fh:
        for line in fh:
            yield line.rstrip(b"\r\n")


def stream_reads(paths: list[str], fasta: bool = False, stdin=None) -> Iterator[bytes]:
    """Yield raw sequences (bytes) from files or STDIN, reference order."""
    if stdin is not None or not paths:
        source: Iterable[bytes] = (
            line.rstrip(b"\r\n") for line in (stdin or sys.stdin.buffer)
        )
        yield from _parse(source, fasta)
    else:
        for p in paths:
            yield from _parse(_open_lines(p), fasta)


def _parse(lines: Iterable[bytes], fasta: bool) -> Iterator[bytes]:
    if fasta:
        header = None
        seq = b""
        for line in lines:
            if len(line) == 0:
                break  # reference FASTA loop breaks on empty line (sketch.go:104-105)
            if line[0:1] == b">":
                if header is not None:
                    yield seq
                header, seq = line, b""
            else:
                seq += line
        if header is None:
            raise FastqError("no FASTA records found")
        yield seq
    else:
        group = []
        for line in lines:
            group.append(line)
            if len(group) == 4:
                l1, l2, _l3, _l4 = group
                if not l1.startswith(b"@"):
                    raise FastqError(
                        f"read ID in fastq file does not begin with @: {l1.decode(errors='replace')}"
                    )
                yield l2
                group = []
        # trailing partial group is silently dropped (as in the reference,
        # where FastqHandler only emits complete 4-line groups)


# finer steps at short-read lengths: the whole device pipeline's width is
# R x bucket, so a 150 bp read in a 256 bucket wastes 40% of every pass
DEFAULT_LENGTH_BUCKETS = (
    128, 160, 192, 256, 320, 512, 1024, 2048, 4096, 8192, 16384, 65536
)


def _skip_lines(chunks: Iterator[bytes], n_lines: int, drop=None) -> Iterator[bytes]:
    """Drop the first n_lines newline-terminated lines of a decompressed
    chunk stream by COUNTING newlines (memchr speed, no parsing) — the
    seek path for checkpoint resume. gzip itself is not random-accessible,
    so .gz inputs still decompress the skipped prefix; everything else
    (parse, pack, batch, transfer, device) is skipped. `drop`, when given,
    is called with each chunk that is skipped whole (a pool buffer goes
    back)."""
    remaining = n_lines
    for c in chunks:
        if remaining:
            buf = c if isinstance(c, np.ndarray) else np.frombuffer(c, dtype=np.uint8)
            nl = np.flatnonzero(buf == 0x0A)
            if nl.shape[0] < remaining:
                remaining -= int(nl.shape[0])
            else:
                cut = int(nl[remaining - 1]) + 1
                remaining = 0
                if cut < len(c):
                    yield c[cut:]
                    continue
            if drop is not None:
                drop(c)
        else:
            yield c


# The inflate of a .gz: whole gzip members in the native inflater
# (native.inflate_members), a few MB a step, into a per-file pool of output
# buffers (_InflatePool). A member whose inflated size passes _INFLATE_CAP
# (what the old whole-file route could allocate: 8x a 128 MB file), and a
# file whose gzip trailer says its last member does, take zlib instead, from
# that member on. At -p > 1 the members after the first step inflate as
# ordered tasks on up to p threads (_Members.ahead).
_INFLATE_CAP = 1 << 30
_INFLATE_MIN = 32 << 20  # a pool buffer's least size
_INFLATE_STEP = 4 << 20  # a step inflates whole members until it holds this
_PREFETCH = 4  # inflated chunks queued ahead of the parse

# the pool buffers not lent out, shared by every file and job: they only
# grow, and are pre-touched once (a fresh one page-faults at ~17 us a page)
_free_bufs: list = []
_free_lock = threading.Lock()


def _new_buffer(nbytes: int) -> np.ndarray:
    from hulk_tpu_torch import native

    buf = np.empty(nbytes, dtype=np.uint8)
    native.touch_pages(buf)
    return buf


class _InflatePool:
    """At most `n` output buffers lent out to one file's inflate at a time.
    The consumer gives each chunk back once the packer is done with it;
    only then may the inflate write into that buffer again. close() wakes
    an inflate that waits for a buffer (the consumer has left); buffers
    still lent out then are dropped, never reused."""

    def __init__(self, n: int):
        self._slots = threading.Semaphore(n)
        self._lent: dict = {}
        self._closed = False

    def take(self, nbytes: int) -> np.ndarray | None:
        """A buffer of at least nbytes; None once closed."""
        while not self._slots.acquire(timeout=0.2):
            if self._closed:
                return None
        with _free_lock:
            buf = _free_bufs.pop() if _free_bufs else None
        if buf is None or buf.shape[0] < nbytes:
            buf = _new_buffer(nbytes)
        self._lent[id(buf)] = buf
        return buf

    def grow(self, buf: np.ndarray, nbytes: int) -> np.ndarray:
        """A buffer of nbytes in the place of the lent-out buf."""
        del self._lent[id(buf)]
        buf = _new_buffer(nbytes)
        self._lent[id(buf)] = buf
        return buf

    def give(self, chunk) -> None:
        """Take back the buffer chunk lies in (a view of it); a chunk of
        bytes (the zlib route, a plain file) holds no buffer."""
        while isinstance(chunk, np.ndarray):
            buf = self._lent.pop(id(chunk), None)
            if buf is not None:
                with _free_lock:
                    _free_bufs.append(buf)
                self._slots.release()
                return
            chunk = chunk.base

    def close(self) -> None:
        self._closed = True


class _Task(NamedTuple):
    """What one inflate task gave: the offset of its first member, the
    offset of the first member it did not take, the bytes written (or -1,
    -2 as native.inflate_members gives them) and the last member's inflated
    size."""

    start: int
    end: int
    n: int
    last: int


def _inflate_task(src: np.ndarray, start: int, stop: int, buf: np.ndarray,
                  scan: bool) -> _Task:
    """Inflate the members of src that start in [start, stop), in a worker
    thread, as an `input.gunzip` span. A scanned task starts at the first
    place native.next_member finds in the range whose member inflates clean
    (-2 ends the search too); a task that finds none is empty (start ==
    end == stop)."""
    from hulk_tpu_torch import native

    with spans.span("input.gunzip"):
        while True:
            if scan:
                start = native.next_member(src, start, stop)
                if start >= stop:
                    return _Task(stop, stop, 0, 0)
            n, end, last = native.inflate_members(
                src, start, buf[:_INFLATE_CAP], 1 << 62, stop)
            if n != -1 or not scan:
                return _Task(start, end, n, last)
            start += 1


class _Members:
    """One .gz file's member route. `pos` is exact: the offset of the first
    member not yet inflated, the end of the members yielded before it.
    `state` says why the last walk ended: "end" (pos reached its stop),
    "bad" (the member at pos is not clean gzip or passes the cap: zlib takes
    over from pos) or "closed" (the consumer left)."""

    def __init__(self, src: np.ndarray, pool: _InflatePool, last: int):
        self.src, self.pool, self.last = src, pool, last
        self.pos = 0
        self.state = "end"

    def _buffer(self) -> np.ndarray | None:
        buf = self.pool.take(min(_INFLATE_CAP, max(_INFLATE_MIN, 2 * self.last)))
        if buf is None:
            self.state = "closed"
        return buf

    def exact(self, stop: int, once: bool = False) -> Iterator:
        """Steps of whole members from pos in this thread, each an
        `input.gunzip` span that inflates until it holds _INFLATE_STEP
        bytes, while pos < stop (one step when `once`)."""
        from hulk_tpu_torch import native

        while self.pos < stop:
            buf = self._buffer()
            if buf is None:
                return
            with spans.span("input.gunzip"):
                n, at, got = native.inflate_members(
                    self.src, self.pos, buf[:_INFLATE_CAP], _INFLATE_STEP, stop)
                if n == -2 and buf.shape[0] < _INFLATE_CAP:
                    buf = self.pool.grow(buf, _INFLATE_CAP)
                    n, at, got = native.inflate_members(
                        self.src, self.pos, buf, _INFLATE_STEP, stop)
            self.pos = at
            if n < 0:
                self.pool.give(buf)
                self.state = "bad"
                return
            spans.count("input.inflate_member_bytes", n)
            self.last = got
            yield buf[:n]
            if once:
                return

    def ahead(self, workers: int, span: int) -> Iterator:
        """The members from pos to the end as ordered tasks on up to
        `workers` threads, started once for the file: consecutive ranges of
        `span` compressed bytes, the first from the exact pos, each later one
        from the first member native.next_member finds in it. A task's bytes
        are yielded only when its start equals pos, the exact end of what
        was yielded before it; otherwise they are dropped (a guess fooled by
        compressed or stored data, or a member it could not take) and this
        thread inflates the range from pos itself (`exact`). So the bytes
        are the one-thread walk's, whatever the input. The wait for the next
        task in order is an `input.inflate_wait` span; the counters
        `input.inflate_tasks` (tasks whose bytes were yielded),
        `input.inflate_ahead_bytes` (their bytes, of tasks that started at a
        guess) and `input.inflate_ahead_misses` (guesses dropped) count the
        route."""
        size = self.src.shape[0]
        reach = self.pos  # where the next task's range starts
        tasks: deque = deque()  # (future, stop, buffer, guessed), in file order
        ex = ThreadPoolExecutor(workers, thread_name_prefix="hulk-inflate")
        try:
            while True:
                while len(tasks) < workers and reach < size:
                    buf = self._buffer()
                    if buf is None:
                        return
                    stop, guessed = min(size, reach + span), reach != self.pos
                    fut = ex.submit(spans.carry(_inflate_task), self.src, reach,
                                    stop, buf, guessed)
                    tasks.append((fut, stop, buf, guessed))
                    reach = stop
                if not tasks:
                    return
                fut, stop, buf, guessed = tasks.popleft()
                with spans.span("input.inflate_wait"):
                    t = fut.result()
                if t.n >= 0 and t.start == self.pos and t.end > t.start:
                    spans.count("input.inflate_tasks")
                    spans.count("input.inflate_member_bytes", t.n)
                    if guessed:
                        spans.count("input.inflate_ahead_bytes", t.n)
                    self.pos, self.last = t.end, t.last
                    yield buf[:t.n]
                else:
                    if guessed and t.start < stop:
                        spans.count("input.inflate_ahead_misses")
                    self.pool.give(buf)
                yield from self.exact(stop)
                if self.state != "end":
                    return
        finally:
            for fut, *_ in tasks:
                fut.cancel()
            ex.shutdown(wait=True)  # no worker writes a buffer after this
            for _, _, buf, _ in tasks:
                self.pool.give(buf)


def _chunks_of(path: str, pool: _InflatePool, workers: int = 1) -> Iterator:
    """The decompressed bytes of one input file, a step at a time, each step
    an `input.gunzip` span. A .gz inflates member by member in the native
    inflater into pool buffers, and yields views of them: in this thread at
    `workers` 1, and after a first step here on up to `workers` threads
    (_Members.ahead) otherwise, with the same bytes. zlib (Python's gzip)
    takes over from a member too large for _INFLATE_CAP, or from the start
    when the gzip trailer's size (ISIZE, the last member's, mod 2**32)
    passes it, and from a member the native inflater finds bad, so that a
    bad file raises what Python's gzip raises. The counters
    `input.inflate_member_bytes` and `input.inflate_zlib_bytes` count each
    route's inflated bytes."""
    from hulk_tpu_torch import native

    if not path.endswith(".gz"):
        with open(path, "rb") as fh:
            yield from _read_chunks(fh)
        return
    pos = 0
    size = os.path.getsize(path)
    if size and native.available():
        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        mm.madvise(mmap.MADV_SEQUENTIAL)
        src = np.frombuffer(mm, dtype=np.uint8)
        last = int.from_bytes(mm[-4:], "little") if size >= 18 else 0
        if last <= _INFLATE_CAP:
            members = _Members(src, pool, last)
            yield from members.exact(size, once=workers > 1)
            if members.state == "end" and members.pos < size:
                yield from members.ahead(workers, members.pos)
            if members.state == "closed" or members.pos >= size:
                return
            pos = members.pos
    with open(path, "rb") as fh:
        fh.seek(pos)
        yield from _read_chunks(gzip.GzipFile(fileobj=fh, mode="rb"),
                                "input.inflate_zlib_bytes")


def _read_chunks(f, counter: str | None = None) -> Iterator[bytes]:
    """4 MB reads of an open file, each an `input.gunzip` span, their bytes
    counted under `counter` when given."""
    while True:
        with spans.span("input.gunzip"):
            chunk = f.read(1 << 22)
        if not chunk:
            return
        if counter:
            spans.count(counter, len(chunk))
        yield chunk


def batch_reads_native(
    paths: list[str],
    batch_size: int = 2048,
    length_buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS,
    cut_every: int | None = None,
    max_read_len: int = 65536,
    fasta: bool = False,
    start_file: int = 0,
    skip_reads: int = 0,
    progress: dict | None = None,
    raw: bool = False,
    inflate_workers: int = 1,
) -> Iterator[PackedReads]:
    """FASTQ/FASTA batches via the native C++ parser/packer (files only).

    Reads are packed at max_read_len then column-sliced to the smallest
    length bucket covering the batch (keeps XLA compilations bounded).
    Batches are split at cut_every global-read-index multiples so interval
    flush boundaries match the Python path exactly. Reads at or beyond
    max_read_len are emitted in stream order as LongRead items for the
    blockwise scanner (ops/longread.py) — there is NO length cap, matching
    the reference (minimizer.go:62-76).

    start_file/skip_reads implement seek-based checkpoint resume (FASTQ
    only): files before start_file are never opened; the first skip_reads
    records of the start file are skipped by newline counting (4 lines per
    record) instead of parse+pack+stream replay. Each emitted batch carries
    its (file_idx, reads_in_file_end) origin so checkpoints can record the
    seek target. `progress`, when given, accrues "parse_bytes" — the bytes
    actually fed to the parser (tests assert resume re-parses only the
    tail).

    raw=True emits RawReads (the parser's strided output, no padded copy)
    for the single-device stream, whose native group packer applies the
    identical pad-5 semantics during nibble-packing — bit-identical device
    input, ~2 fewer full host passes per batch.

    inflate_workers (the CLI's -p) is the most threads that inflate one
    .gz's members at once; at 1 the gunzip thread alone inflates them.
    """
    from hulk_tpu_torch import native

    if skip_reads and fasta:
        raise FastqError("seek-based resume supports FASTQ only")
    cls = native.NativeFastaPacker if fasta else native.NativeFastqPacker
    packer = cls(cap_reads=batch_size, cap_len=max_read_len)
    emitted = 0
    cur_file = start_file
    file_emitted = skip_reads

    def finish(codes, lengths):
        nonlocal emitted, file_emitted
        if lengths.shape[0] == 0:
            return
        if (lengths >= max_read_len).any():
            raise FastqError(f"read exceeds max supported length {max_read_len}")
        maxlen = int(lengths.max())
        bucket = next((x for x in length_buckets if maxlen <= x), max_read_len)
        R = lengths.shape[0]
        emitted += R
        file_emitted += R
        if raw:
            yield RawReads(
                codes=np.ascontiguousarray(codes), lengths=lengths,
                bucket=bucket, file_idx=cur_file,
                reads_in_file_end=file_emitted,
            )
            return
        out_codes = np.empty((batch_size, bucket), dtype=np.uint8)
        out_codes[:R] = codes[:, :bucket]
        # pad positions beyond each read's length (the packer leaves them
        # untouched so large cap_len rows stay unmapped)
        col = np.arange(bucket, dtype=np.int32)[None, :]
        out_len = np.zeros(batch_size, dtype=np.int32)
        out_len[:R] = lengths
        np.putmask(out_codes, col >= out_len[:, None], np.uint8(5))
        yield PackedReads(
            codes=out_codes, lengths=out_len, file_idx=cur_file,
            reads_in_file_end=file_emitted,
        )

    def emit_item(item):
        """Route one packer item: a (codes, lengths) pair splits into
        batches; a LongSeq (record past the stride cap) emits as ONE
        LongRead occupying one global read index — interval accounting and
        checkpoint origins stay exact."""
        nonlocal emitted, file_emitted
        if isinstance(item, native.LongSeq):
            emitted += 1
            file_emitted += 1
            yield LongRead(
                codes=item.codes, file_idx=cur_file,
                reads_in_file_end=file_emitted,
            )
            return
        codes, lengths = item
        yield from splits(codes, lengths)

    def splits(codes, lengths):
        """Slice a packed pair to batch size (the parallel parser returns one
        big [nreads, stride] pair per chunk), then at interval boundaries —
        the same boundary set the serial per-batch packer produces."""
        for s0 in range(0, lengths.shape[0], batch_size):
            yield from _cuts(
                codes[s0 : s0 + batch_size], lengths[s0 : s0 + batch_size]
            )

    def _cuts(codes, lengths):
        if cut_every is None:
            yield from finish(codes, lengths)
            return
        start = 0
        n = lengths.shape[0]
        while start < n:
            room = cut_every - ((emitted + 0) % cut_every)
            take = min(n - start, room)
            yield from finish(codes[start : start + take], lengths[start : start + take])
            start += take

    for fi, p in enumerate(paths):
        if fi < start_file:
            continue
        cur_file = fi
        if fi > start_file:
            file_emitted = 0
        # the inflate in its own thread (the native inflater and zlib
        # release the GIL), overlapped with native packing here; its
        # buffers come back to the pool once the packer is done with each
        # chunk; each inflate worker past the first holds one more
        pool = _InflatePool(_PREFETCH + 1 + inflate_workers)
        chunk_src = _chunks_of(p, pool, inflate_workers)
        if fi == start_file and skip_reads:
            chunk_src = _skip_lines(chunk_src, 4 * skip_reads, pool.give)
        chunks = prefetch_batches(
            chunk_src, depth=_PREFETCH, name="hulk-gunzip",
            span_names=(None, "input.chunk_wait"))
        try:
            for chunk in chunks:
                if progress is not None:
                    progress["parse_bytes"] = progress.get("parse_bytes", 0) + len(chunk)
                for item in packer.feed(chunk):
                    yield from emit_item(item)
                pool.give(chunk)
        finally:
            pool.close()
            chunks.close()
        try:
            tail = packer.end_of_file()
        except ValueError as e:
            raise FastqError(str(e)) from None
        for item in tail:
            yield from emit_item(item)


def batch_reads(
    reads: Iterator[bytes],
    batch_size: int = 512,
    length_buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS,
    cut_every: int | None = None,
) -> Iterator[PackedReads]:
    """Group reads into fixed-shape padded batches ([batch_size, bucket]
    always, so XLA compiles once per bucket; unused rows have length 0 and
    are inert in the kernels).

    cut_every forces batch boundaries at global read indices that are
    multiples of it (the `-i` interval flush boundary), so flushes happen at
    deterministic positions regardless of batching.
    """
    buf: list[bytes] = []
    cur_bucket = None
    emitted = 0

    def flush():
        nonlocal buf, cur_bucket, emitted
        if buf:
            emitted += len(buf)
            yield pack_reads(buf, pad_to=cur_bucket, n_reads=batch_size)
            buf, cur_bucket = [], None

    from hulk_tpu_torch.ops.encode import encode_seq

    for r in reads:
        L = len(r)
        b = next((x for x in length_buckets if L <= x), None)
        if b is None:
            # beyond the top bucket: emit as a LongRead for the blockwise
            # scanner (unbounded length, bounded memory) instead of an
            # exact-size one-off compile whose [R, L] intermediates would
            # explode for contig-scale L
            yield from flush()
            emitted += 1
            yield LongRead(codes=encode_seq(r))
            continue
        if cur_bucket is not None and (b != cur_bucket or len(buf) >= batch_size):
            yield from flush()
        if cur_bucket is None:
            cur_bucket = b
        buf.append(r)
        if cut_every is not None and (emitted + len(buf)) % cut_every == 0:
            yield from flush()
    yield from flush()
