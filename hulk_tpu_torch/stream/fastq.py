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
import sys
from dataclasses import dataclass
from typing import Iterable, Iterator

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
    in that order in span_names.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    step, get = span_names

    def worker():
        try:
            it = iter(batches)
            while True:
                with spans.span(step):
                    b = next(it, done)
                if b is done:
                    break
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(done)
        except BaseException as e:  # propagate to the consumer
            q.put(e)

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


def _skip_lines(chunks: Iterator[bytes], n_lines: int) -> Iterator[bytes]:
    """Drop the first n_lines newline-terminated lines of a decompressed
    chunk stream by COUNTING newlines (memchr speed, no parsing) — the
    seek path for checkpoint resume. gzip itself is not random-accessible,
    so .gz inputs still decompress the skipped prefix; everything else
    (parse, pack, batch, transfer, device) is skipped."""
    remaining = n_lines
    for c in chunks:
        if remaining:
            buf = c if isinstance(c, np.ndarray) else np.frombuffer(c, dtype=np.uint8)
            nl = np.flatnonzero(buf == 0x0A)
            if nl.shape[0] < remaining:
                remaining -= int(nl.shape[0])
                continue
            cut = int(nl[remaining - 1]) + 1
            remaining = 0
            if cut < len(c):
                yield c[cut:]
        else:
            yield c


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

    # whole-buffer libdeflate fast path for .gz up to this compressed size
    # (~3x zlib; raw output is typically 3-8x compressed, kept in memory);
    # larger files take the memory-bounded zlib streaming path
    _LIBDEFLATE_MAX_COMPRESSED = 128 << 20

    def chunks_of(path):
        import os as _os

        if (
            path.endswith(".gz")
            and _os.path.getsize(path) <= _LIBDEFLATE_MAX_COMPRESSED
        ):
            from hulk_tpu_torch import native as _native

            if _native.available() and _native.gunzip_available():
                with open(path, "rb") as fh:
                    comp = fh.read()
                # copy=False: the persistent-buffer view is fully consumed
                # by the parser before the next gunzip call (files parse
                # sequentially; the prefetch wrapper is per-file). Yielded
                # as ONE ndarray so the packer parses it zero-copy in a
                # single OMP call — byte-chunk feeding costs ~3 full-stream
                # copies (concat, cut-slice, tobytes).
                decomp = _native.gunzip_bytes(comp, copy=False)
                if decomp is not None:
                    yield decomp
                    return
                # not clean gzip: fall through to the zlib streaming path
        fh = gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")
        with fh:
            while True:
                chunk = fh.read(1 << 22)
                if not chunk:
                    return
                yield chunk

    for fi, p in enumerate(paths):
        if fi < start_file:
            continue
        cur_file = fi
        if fi > start_file:
            file_emitted = 0
        chunk_src = chunks_of(p)
        if fi == start_file and skip_reads:
            chunk_src = _skip_lines(chunk_src, 4 * skip_reads)
        # decompression in its own thread (zlib releases the GIL), overlapped
        # with native packing here
        for chunk in prefetch_batches(
                chunk_src, depth=4, name="hulk-gunzip",
                span_names=("input.gunzip", "input.chunk_wait")):
            if progress is not None:
                progress["parse_bytes"] = progress.get("parse_bytes", 0) + len(chunk)
            for item in packer.feed(chunk):
                yield from emit_item(item)
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
