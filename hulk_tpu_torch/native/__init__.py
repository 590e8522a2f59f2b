"""Native runtime bindings (ctypes).

Builds hulkrt.cpp with g++ on first use into the package's build directory
(gitignored, beside the CUDA kernels' libraries), exposing:
  * go_exp/go_log (fdlibm ports, cross-validated against hashes/fdlibm.py)
  * GoRand + CWS table fill (native, ~50x faster than the Python generator)
  * hulk_flush_exact (the full exact flush loop)
  * hulk_pack_fastq (FASTQ line parser + code packer)
  * hulk_inflate_range (gzip members inflated into caller-owned memory) and
    hulk_next_member (a guess at where a member starts)

Everything has a pure-Python fallback; `available()` reports whether the
native library loaded.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from hulk_tpu_torch import spans

_SRC = os.path.join(os.path.dirname(__file__), "hulkrt.cpp")
_lib = None
_tried = False


def _build_dir() -> str:
    from hulk_tpu_torch.ops._build import build_dir

    return build_dir()


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so_path = os.path.join(_build_dir(), "hulkrt.so")
    try:
        src_mtime = os.path.getmtime(_SRC)
        if not os.path.exists(so_path) or os.path.getmtime(so_path) < src_mtime:
            os.makedirs(_build_dir(), exist_ok=True)
            tmp = so_path + f".tmp{os.getpid()}.so"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off",
                 "-fopenmp", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
    except (OSError, subprocess.CalledProcessError):
        _lib = None
        return None

    lib.hulk_go_exp.restype = ctypes.c_double
    lib.hulk_go_exp.argtypes = [ctypes.c_double]
    lib.hulk_go_log.restype = ctypes.c_double
    lib.hulk_go_log.argtypes = [ctypes.c_double]
    lib.hulk_gorand_sizeof.restype = ctypes.c_int32
    lib.hulk_gorand_seed.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.hulk_gorand_float64.restype = ctypes.c_double
    lib.hulk_gorand_float64.argtypes = [ctypes.c_void_p]
    lib.hulk_gorand_int63.restype = ctypes.c_int64
    lib.hulk_gorand_int63.argtypes = [ctypes.c_void_p]
    lib.hulk_cws_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hulk_flush_exact.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_double,
    ]
    lib.hulk_pack_fastq.restype = ctypes.c_int64
    lib.hulk_pack_fastq.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.hulk_set_threads.argtypes = [ctypes.c_int32]
    lib.hulk_set_threads.restype = None
    lib.hulk_count_lines.restype = ctypes.c_int64
    lib.hulk_count_lines.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hulk_pack_fastq_par.restype = ctypes.c_int64
    lib.hulk_pack_fastq_par.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hulk_pack_fasta.restype = ctypes.c_int64
    lib.hulk_pack_fasta.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.hulk_inflate_range.restype = ctypes.c_int64
    lib.hulk_inflate_range.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hulk_next_member.restype = ctypes.c_int64
    lib.hulk_next_member.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.hulk_pack_group_batch.restype = None
    lib.hulk_pack_group_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hulk_pack_group_batch2.restype = ctypes.c_int32
    lib.hulk_pack_group_batch2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.hulk_touch_pages.restype = None
    lib.hulk_touch_pages.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def set_threads(n: int) -> None:
    """The team of every OpenMP pass of the native runtime, in whichever
    thread it runs: the CLI's -p (the reference's GOMAXPROCS = p)."""
    lib = _load()
    if lib is not None:
        lib.hulk_set_threads(int(n))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---- CWS tables ------------------------------------------------------------

def cws_fill_native(sketch_size: int, dims: int):
    """Native CWS table generation; returns (r, c, b, exp_r) or None."""
    lib = _load()
    if lib is None:
        return None
    from hulk_tpu_torch.hashes.gorand import _rng_cooked

    cooked = np.ascontiguousarray(_rng_cooked().view(np.int64))
    shape = (sketch_size, dims)
    r = np.empty(shape)
    c = np.empty(shape)
    b = np.empty(shape)
    er = np.empty(shape)
    lib.hulk_cws_fill(sketch_size, dims, _ptr(cooked), _ptr(r), _ptr(c), _ptr(b), _ptr(er))
    return r, c, b, er


# ---- exact flush -----------------------------------------------------------

def flush_exact_native(bins, freqs, row_bins, cms, c_t, b_t, er_t, sketch,
                       weights, drift: bool, decay_weight: float) -> bool:
    """Run the exact flush natively, mutating cms/sketch/weights in place.
    Returns False (caller falls back) when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    n = bins.shape[0]
    depth, width = cms.shape
    s, dims = c_t.shape
    bins64 = np.ascontiguousarray(bins, dtype=np.int64)
    freqs64 = np.ascontiguousarray(freqs, dtype=np.float64)
    rb = np.ascontiguousarray(row_bins.T, dtype=np.int32)  # [n, depth]
    # hard errors, not asserts: python -O would strip asserts and a
    # non-contiguous array here becomes a silent native out-of-bounds read
    if not (cms.flags.c_contiguous and sketch.flags.c_contiguous
            and weights.flags.c_contiguous):
        raise ValueError("flush_exact_native requires C-contiguous state arrays")
    lib.hulk_flush_exact(
        n, _ptr(bins64), _ptr(freqs64), _ptr(rb), _ptr(cms), depth, width,
        s, dims, _ptr(c_t), _ptr(b_t), _ptr(er_t), _ptr(sketch), _ptr(weights),
        1 if drift else 0, decay_weight,
    )
    return True


# ---- gzip inflate -----------------------------------------------------------

def inflate_members(src: np.ndarray, pos: int, out: np.ndarray,
                    want: int, stop: int | None = None) -> tuple[int, int, int]:
    """Inflate whole gzip members of `src` (uint8) from offset `pos` into
    `out`, while a member starts before `stop` (the end of `src` when None)
    and `out` holds fewer than `want` bytes (hulk_inflate_range,
    hulkrt.cpp's own DEFLATE decoder; the GIL is released meanwhile).
    Returns (bytes written, the offset of the first member not inflated,
    the inflated size of the last member inflated). Bytes written is -2
    when the member at `pos` does not fit in `out`, -1 when it is not clean
    gzip (header, data, CRC-32 or size); the offset is then that
    member's."""
    for a in (src, out):
        if a.dtype != np.uint8 or a.ndim != 1 or not a.flags.c_contiguous:
            raise ValueError("inflate_members takes contiguous 1-D uint8 arrays")
    if not 0 <= pos <= src.shape[0]:
        raise ValueError(f"inflate_members: offset {pos} outside 0..{src.shape[0]}")
    p, last = ctypes.c_int64(pos), ctypes.c_int64(0)
    n = _load().hulk_inflate_range(
        _ptr(src), src.shape[0], ctypes.byref(p),
        src.shape[0] if stop is None else stop, _ptr(out), out.shape[0],
        want, ctypes.byref(last),
    )
    return int(n), p.value, last.value


def next_member(src: np.ndarray, start: int, stop: int) -> int:
    """The first offset in [start, stop) of `src` where a gzip member could
    start (hulk_next_member: its header parses and its first block's type is
    valid), or `stop`: a guess, which compressed or stored data can fool."""
    if src.dtype != np.uint8 or src.ndim != 1 or not src.flags.c_contiguous:
        raise ValueError("next_member takes a contiguous 1-D uint8 array")
    if not 0 <= start <= stop:
        raise ValueError(f"next_member: range {start}..{stop} is not one")
    return int(_load().hulk_next_member(_ptr(src), src.shape[0], start, stop))


def touch_pages(a: np.ndarray) -> None:
    """Fault a fresh array's pages in, in parallel (hulk_touch_pages)."""
    _load().hulk_touch_pages(_ptr(a), a.nbytes)


# ---- transfer-group packing ------------------------------------------------

def pack_group(batches, g: int, r: int, l: int) -> np.ndarray | None:
    """Fused native equivalent of ops.device_step.build_group_buffer, fed
    straight from the parser's strided output: `batches` is a list of up to
    `g` (codes[rows, stride] u8 C-contiguous, lengths[rows] i32) pairs; rows
    beyond each batch's live count and batches beyond len(batches) become
    dead pad (codes 5, length 0). Returns the flat u8 buffer (nibble-packed
    codes [g, r, ceil(l/2)] + LE u16 lengths [g, r]) bit-identical to the
    NumPy construction, or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    l2 = (l + 1) // 2
    ncodes = g * r * l2
    out = np.empty(ncodes + g * r * 2, dtype=np.uint8)
    zero_rows = np.zeros(0, dtype=np.int32)
    for i in range(g):
        if i < len(batches):
            codes, lengths = batches[i]
            if not codes.flags.c_contiguous:
                raise ValueError("pack_group requires C-contiguous codes")
            rows, stride = codes.shape
            lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        else:
            codes, lengths, rows, stride = zero_rows, zero_rows, 0, 0
        lib.hulk_pack_group_batch(
            _ptr(codes), rows, stride, _ptr(lengths), r, l,
            _ptr(out[i * r * l2:]), _ptr(out[ncodes + i * r * 2:]),
        )
    return out


def group2_nbytes(g: int, r: int, l: int) -> int:
    """Size of the v2 flat transfer buffer of pack_group2."""
    return g * r * (l // 4 + l // 8 + 2)


def pack_group2(batches, g: int, r: int, l: int,
                out: np.ndarray | None = None) -> np.ndarray | None:
    """v2 flat transfer buffer: 2-bit codes [g, r, l/4] + N bitmask
    [g, r, l/8] + LE u16 lengths [g, r] (see hulk_pack_group_batch2).
    Requires l % 8 == 0; same batch contract as pack_group, plus: in-read
    codes must be the parser alphabet 0..4 (NT4 output — any >= 4 rebuilds
    as 4 on device, whereas the nibble layout passes bytes through).
    `out`, when given, is the C-contiguous u8 buffer of group2_nbytes bytes
    to fill (a pinned host tensor's view, for an asynchronous copy)."""
    lib = _load()
    if lib is None:
        return None
    if l % 8 != 0:
        raise ValueError("pack_group2 requires l % 8 == 0")
    l4, l8 = l // 4, l // 8
    ncodes = g * r * l4
    nmask = g * r * l8
    if out is None:
        out = np.empty(group2_nbytes(g, r, l), dtype=np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (group2_nbytes(g, r, l),)
          or not out.flags.c_contiguous):
        raise ValueError("pack_group2: out must be a contiguous u8 buffer "
                         "of group2_nbytes(g, r, l) bytes")
    zero_rows = np.zeros(0, dtype=np.int32)
    for i in range(g):
        if i < len(batches):
            codes, lengths = batches[i]
            if not codes.flags.c_contiguous:
                raise ValueError("pack_group2 requires C-contiguous codes")
            rows, stride = codes.shape
            lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        else:
            codes, lengths, rows, stride = zero_rows, zero_rows, 0, 0
        lib.hulk_pack_group_batch2(
            _ptr(codes), rows, stride, _ptr(lengths), r, l,
            _ptr(out[i * r * l4:]), _ptr(out[ncodes + i * r * l8:]),
            _ptr(out[ncodes + nmask + i * r * 2:]),
        )
    return out


# ---- FASTQ packing ---------------------------------------------------------


class LongSeq:
    """One record too long for the strided packers (>= cap_len bases).

    The packers emit these IN STREAM ORDER among the normal (codes, lengths)
    pairs; the caller routes them to the blockwise scanner
    (ops/longread.py). The reference has no length cap
    (src/minimizer/minimizer.go:62-76), so neither does this parser."""

    __slots__ = ("codes",)

    def __init__(self, codes: np.ndarray):
        self.codes = codes  # [L] uint8 base codes (0-4)


def _nt4_table() -> np.ndarray:
    from hulk_tpu_torch.ops.encode import SEQ_NT4_TABLE

    return SEQ_NT4_TABLE

def _rfind_nl(a: np.ndarray) -> int:
    """Index of the last 0x0A in a uint8 array (-1 if none): backward block
    scan, so whole-buffer feeds don't pay a full-array pass."""
    end = a.shape[0]
    step = 1024
    while end > 0:
        s = max(0, end - step)
        idx = np.flatnonzero(a[s:end] == 0x0A)
        if idx.shape[0]:
            return s + int(idx[-1])
        end = s
        step *= 8
    return -1

class NativeFastqPacker:
    """Streaming FASTQ parser+packer over decompressed chunks.

    Row stride adapts to the stream: batches allocate [cap_reads, stride]
    with stride = the current read-length bucket; a read longer than the
    stride rewinds the parser state and retries that range with a doubled
    stride (rare — once per upward length jump)."""

    def __init__(self, cap_reads: int, cap_len: int, initial_stride: int = 256):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.cap_reads = cap_reads
        self.cap_len = cap_len
        self.stride = min(initial_stride, cap_len)
        self.phase = np.zeros(1, dtype=np.int32)
        self._leftover = b""
        self._pool: list = []  # reusable [rows, stride] codes bases

    def _codes_buf(self, cap: int) -> np.ndarray:
        """Pooled codes allocation: page faults cost ~17 us each here, so a
        fresh ~13 MB array per chunk costs more than parsing it. A base is
        reusable once nothing outside the pool references it (the emitted
        row-slices hold their base alive, so refcount==3 — pool entry, loop
        var, getrefcount arg — proves all views are gone)."""
        import sys

        for a in self._pool:
            if (
                a.shape[0] >= cap
                and a.shape[1] == self.stride
                and sys.getrefcount(a) == 3
            ):
                return a
        rows = max(cap, 1 << 16)
        a = np.empty((rows, self.stride), dtype=np.uint8)
        self._lib.hulk_touch_pages(_ptr(a), a.nbytes)
        self._pool = [x for x in self._pool if x.shape[1] == self.stride][-3:]
        self._pool.append(a)
        return a

    # chunks at least this big take the OMP two-pass parser (below this the
    # parallel ramp-up costs more than it saves)
    PAR_MIN_BYTES = 1 << 20

    def feed(self, chunk):
        """Consume a chunk (bytes, or a uint8 ndarray that stays valid until
        this call returns); yields (codes [R, stride], lengths [R]) pairs.
        Large chunks parse in parallel into ONE big strided pair (the caller
        slices to batch size); small chunks take the serial per-cap loop.
        Both produce identical rows."""
        if isinstance(chunk, np.ndarray):
            if self._leftover:
                data = np.concatenate(
                    [np.frombuffer(self._leftover, dtype=np.uint8), chunk]
                )
            else:
                data = chunk
            cut = _rfind_nl(data) + 1
            self._leftover = data[cut:].tobytes()
            buf = data[:cut]
            if buf.shape[0] >= self.PAR_MIN_BYTES:
                return self._feed_par(buf)
            return self._feed_serial(bytes(buf))
        data = self._leftover + chunk
        # only whole lines go to the parser
        cut = data.rfind(b"\n") + 1
        self._leftover = data[cut:]
        data = data[:cut]
        buf = np.frombuffer(data, dtype=np.uint8)
        if buf.shape[0] >= self.PAR_MIN_BYTES:
            return self._feed_par(buf)
        return self._feed_serial_buf(buf)

    def _feed_serial(self, data: bytes):
        return self._feed_serial_buf(np.frombuffer(data, dtype=np.uint8))

    def _feed_serial_buf(self, buf):
        pos = 0
        out = []
        while pos < buf.shape[0]:
            saved_phase = int(self.phase[0])
            codes = np.empty((self.cap_reads, self.stride), dtype=np.uint8)
            lengths = np.zeros(self.cap_reads, dtype=np.int32)
            consumed = np.zeros(1, dtype=np.int64)
            nreads = self._lib.hulk_pack_fastq(
                _ptr(buf[pos:]), buf.shape[0] - pos, _ptr(self.phase),
                _ptr(codes), _ptr(lengths), self.cap_reads, self.stride,
                _ptr(consumed),
            )
            if nreads and int(lengths[:nreads].max()) >= self.stride:
                # a read was truncated: rewind and retry with a larger stride
                self.phase[0] = saved_phase
                if self.stride >= self.cap_len:
                    # a sequence line at/over the stride cap: line-level
                    # parse of the remainder, long reads emitted as LongSeq
                    out.extend(self._feed_overflow(buf[pos:]))
                    return out
                self.stride = min(self.stride * 4, self.cap_len)
                continue
            pos += int(consumed[0])
            if nreads == 0:
                break
            out.append((codes[:nreads], lengths[:nreads]))
        return out

    def _feed_overflow(self, buf):
        """Whole-lines buffer containing >= 1 sequence line at/over the
        stride cap: native-parse the normal line segments, emit oversize
        sequence lines (in order) as LongSeq. Rows for the normal reads are
        bit-identical to an all-native parse (the segment sub-parses run
        the same hulk_pack_fastq with the correct starting phase)."""
        nt4 = _nt4_table()
        nl = np.flatnonzero(buf == 0x0A)
        starts = np.concatenate([[0], nl[:-1] + 1]) if nl.shape[0] else nl
        # a line's length without its CR, as the native parser counts it
        raw_len = nl - starts
        if nl.shape[0]:
            raw_len = raw_len - ((raw_len > 0) & (buf[np.maximum(nl - 1, 0)] == 0x0D))
        base_phase = int(self.phase[0])
        phases = (base_phase + np.arange(nl.shape[0])) & 3
        long_idx = np.flatnonzero((phases == 1) & (raw_len >= self.cap_len))
        out = []

        def native_segment(line_lo: int, line_hi: int):
            if line_hi <= line_lo:
                return
            sub = buf[int(starts[line_lo]) : int(nl[line_hi - 1]) + 1]
            saved = int(self.phase[0])
            self.phase[0] = int(phases[line_lo])
            # segments contain no oversize sequence lines, so neither path
            # can recurse back here
            if sub.shape[0] >= self.PAR_MIN_BYTES:
                out.extend(self._feed_par(np.ascontiguousarray(sub)))
            else:
                out.extend(self._feed_serial_buf(sub))
            self.phase[0] = saved

        seg = 0
        for li in long_idx:
            native_segment(seg, int(li))
            s, e = int(starts[li]), int(nl[li])
            if e > s and buf[e - 1] == 0x0D:
                e -= 1
            out.append(LongSeq(nt4[buf[s:e]]))
            seg = int(li) + 1
        native_segment(seg, nl.shape[0])
        self.phase[0] = (base_phase + nl.shape[0]) & 3
        return out

    def _feed_par(self, buf: np.ndarray):
        """OMP two-pass parse of a whole-lines buffer (hulk_pack_fastq_par):
        one [nreads, stride] pair out, rows identical to the serial loop.
        The native calls, retries included, are an `input.parse_par` span;
        the counters `input.parse_par_calls` and `input.parse_team_threads`
        add one and the team the pack ran with."""
        team = np.zeros(1, dtype=np.int32)
        overflow = False
        with spans.part("input.parse_par"):
            nlines = self._lib.hulk_count_lines(_ptr(buf), buf.shape[0])
            cap = nlines // 4 + 2
            while True:
                codes = self._codes_buf(cap)
                lengths = np.zeros(cap, dtype=np.int32)
                consumed = np.zeros(1, dtype=np.int64)
                phase_out = np.zeros(1, dtype=np.int32)
                n = self._lib.hulk_pack_fastq_par(
                    _ptr(buf), buf.shape[0], int(self.phase[0]), _ptr(codes),
                    _ptr(lengths), cap, self.stride, _ptr(consumed),
                    _ptr(phase_out), _ptr(team),
                )
                if n < 0:
                    raise RuntimeError(
                        "native parser overflow despite cap sized from "
                        "hulk_count_lines"
                    )
                if n and int(lengths[:n].max()) >= self.stride:
                    if self.stride >= self.cap_len:
                        overflow = True
                        break
                    self.stride = min(self.stride * 4, self.cap_len)
                    continue
                break
        spans.count("input.parse_par_calls")
        spans.count("input.parse_team_threads", int(team[0]))
        if overflow:
            # oversize sequence line(s): line-level parse, LongSeq emission
            # in order (phase untouched by the failed attempts — the par
            # parser commits it only on success)
            return self._feed_overflow(buf)
        if int(consumed[0]) != buf.shape[0]:  # buffer must end on a newline
            raise RuntimeError(
                "native parser consumed a partial buffer "
                f"({int(consumed[0])} of {buf.shape[0]} bytes)"
            )
        self.phase[0] = int(phase_out[0])
        return [(codes[:n], lengths[:n])] if n else []

    def end_of_file(self):
        """Complete a final line missing its newline; resets the 4-line phase."""
        out = self.feed(b"\n") if self._leftover else []
        self._leftover = b""
        self.phase[0] = 0
        return out


class NativeFastaPacker:
    """Streaming FASTA parser+packer over decompressed chunks (see
    hulk_pack_fasta for the reference semantics it replicates). Records can
    span chunks via the carry buffer; end_of_file() emits the trailing record
    and errors if the file had no records."""

    def __init__(self, cap_reads: int, cap_len: int, initial_stride: int = 256):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.cap_reads = cap_reads
        self.cap_len = cap_len
        self.stride = min(initial_stride, cap_len)
        self.state = np.zeros(4, dtype=np.int32)  # header/terminated/carry/any
        self.carry = np.zeros(cap_len, dtype=np.uint8)
        self._leftover = b""
        # long-record mode: [parts...] of an in-progress record whose total
        # exceeds cap_len (contigs have no length cap); None when the
        # native strided path owns the carry. Pre-header junk is tracked by
        # LENGTH only (_long_junk) — it is always discarded, so memory
        # stays bounded however large the junk prefix is.
        self._long_parts: list | None = None
        self._long_header = False
        self._long_junk = 0

    def feed(self, chunk):
        if isinstance(chunk, np.ndarray):  # a view of an inflate buffer
            chunk = chunk.tobytes()
        data = self._leftover + chunk
        cut = data.rfind(b"\n") + 1
        self._leftover = data[cut:]
        data = data[:cut]
        buf = np.frombuffer(data, dtype=np.uint8)
        pos = 0
        out = []
        while pos < buf.shape[0]:
            if self._long_parts is not None:
                pos = self._consume_long(buf, pos, out)
                continue
            saved_state = self.state.copy()
            saved_carry = self.carry[: self.stride].copy()
            codes = np.empty((self.cap_reads, self.stride), dtype=np.uint8)
            lengths = np.zeros(self.cap_reads, dtype=np.int32)
            consumed = np.zeros(1, dtype=np.int64)
            nreads = self._lib.hulk_pack_fasta(
                _ptr(buf[pos:]), buf.shape[0] - pos, _ptr(self.state),
                _ptr(self.carry), _ptr(codes), _ptr(lengths), self.cap_reads,
                self.stride, _ptr(consumed),
            )
            truncated = int(self.state[2]) >= self.stride or (
                nreads and int(lengths[:nreads].max()) >= self.stride
            )
            if truncated:
                # the native parser CLIPS overflowing lines (bases dropped),
                # so every truncation restores the pre-attempt snapshot and
                # re-parses; at the stride cap, re-parsing switches to the
                # Python record loop (no length cap — reference parity,
                # minimizer.go:62-76; ops/longread.py scans the result)
                self.state[:] = saved_state
                self.carry[: saved_carry.shape[0]] = saved_carry
                if self.stride >= self.cap_len:
                    self._long_header = bool(self.state[0])
                    if self._long_header:
                        self._long_parts = [
                            self.carry[: int(self.state[2])].copy()
                        ]
                        self._long_junk = 0
                    else:
                        # pre-header junk is NEVER emitted (discarded at the
                        # first '>'): track only its length, bounding memory
                        self._long_parts = []
                        self._long_junk = int(self.state[2])
                    self.state[2] = 0
                    continue
                self.stride = min(self.stride * 4, self.cap_len)
                continue
            pos += int(consumed[0])
            if nreads == 0:
                if int(consumed[0]) == 0:
                    break
                continue
            out.append((codes[:nreads], lengths[:nreads]))
        return out

    def _emit_long_record(self, out) -> bool:
        """Emit the accumulated record; True when it was genuinely long."""
        total = (
            np.concatenate(self._long_parts)
            if self._long_parts
            else np.empty(0, dtype=np.uint8)
        )
        self._long_parts = []
        L = int(total.shape[0])
        self.state[3] = 1  # emitted_any
        if L >= self.cap_len:
            out.append(LongSeq(total))
            return True
        # the record ahead of the long one (or after a discarded junk
        # prefix) fits after all: emit a normal single-row pair
        codes = np.full((1, self.stride), 5, dtype=np.uint8)  # pad code past L
        codes[0, :L] = total
        out.append((codes, np.array([L], dtype=np.int32)))
        return False

    def _consume_long(self, buf, pos: int, out) -> int:
        """Python record loop engaged at a stride-cap overflow: parse
        records line by line (same state machine as hulk_pack_fasta),
        emitting oversize ones as LongSeq, until the overflowing record has
        been emitted — then hand back to the native strided path. Returns
        the new position."""
        nt4 = _nt4_table()
        n = buf.shape[0]
        nl = np.flatnonzero(buf[pos:] == 0x0A) + pos  # one pass
        s = pos
        for e in map(int, nl):
            le = e
            if le > s and buf[le - 1] == 0x0D:
                le -= 1
            if le == s:  # empty line: terminate file parse
                if self._long_header:
                    self._emit_long_record(out)
                self._long_parts, self._long_header = None, False
                self.state[1] = 1  # terminated: rest of file is discarded
                return n
            if buf[s] == 0x3E:  # '>': record boundary
                resolved = False
                if self._long_header:
                    resolved = self._emit_long_record(out)
                elif self._long_junk >= self.cap_len:
                    # the discarded junk prefix WAS the overflow cause:
                    # nothing long lies ahead necessarily — hand back
                    resolved = True
                # (pre-header accumulation is discarded at the first '>')
                self._long_parts = []
                self._long_junk = 0
                self._long_header = True
                if resolved:
                    # overflow resolved: native path resumes at this header
                    self._long_parts = None
                    self._long_header = False
                    self.state[0] = 1
                    self.state[2] = 0
                    return e + 1
            elif self._long_header:
                self._long_parts.append(nt4[buf[s:le]])
            else:
                self._long_junk += le - s  # junk: length only (discarded)
            s = e + 1
        return n  # record spans feeds: stay in the Python loop

    def end_of_file(self):
        """Emit the trailing record; error if the file had no records; reset
        per-file state (header/terminated flags) for the next file."""
        out = self.feed(b"\n") if self._leftover else []
        self._leftover = b""
        if self._long_parts is not None:  # Python record loop at EOF
            if self._long_header:
                self._emit_long_record(out)
            self._long_parts, self._long_header = None, False
        elif self.state[0]:  # in-progress record at EOF
            L = int(self.state[2])
            codes = np.full((1, self.stride), 5, dtype=np.uint8)
            codes[0, :L] = self.carry[:L]
            out.append((codes, np.array([L], dtype=np.int32)))
            self.state[3] = 1
        if not self.state[3]:
            raise ValueError("no FASTA records found")
        self.state[:] = 0
        return out
