"""The sketch pipeline: reads -> minimizers -> spectrum -> histosketch.

Counterpart of hulk_tpu/stream/pipeline.py (SketchConfig, the single-device
_DeviceStream, the checkpoint format, _DeviceFlusher and
run_sketch_pipeline) on one PyTorch device. The native parser feeds
fixed-shape batches of FASTQ reads or FASTA records; groups of GROUP batches
are packed into one pinned host buffer (native pack_group2), copied to the
device once, and stepped batch by batch (ops/device_step.py) into an int32
histogram and the KMV/KHF/HMH states, which stay on the device: the
histogram until an interval boundary or the end, where the exact flush
turns it into the histosketch, the secondary sketches until the end. A read
of 65,536 bases or more arrives alone (LongRead) and is scanned block by
block (ops/longread.py) into the host spectrum and sketch objects. Interval
boundaries are global read indices, as in the reference, so the output does
not depend on batching or on the device.

Each interval's flush runs in one background worker while the next
interval streams: the exact host flush (native), or with device_flush the
device candidate stage (parallel/mesh.py) and the exact host recheck. At
most one flush is in flight. After it, the --stream callback gets a
snapshot and, with checkpoint_path, the state goes to disk in hulk_tpu's
checkpoint format, so that a run checkpointed by either package resumes in
the other.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from hulk_tpu_torch.io.sketchio import HULKData
from hulk_tpu_torch.ops.device_sketches import SketchStates
from hulk_tpu_torch.ops.device_step import (
    fused_bits_ok,
    group_scan_body,
    stream_bucket,
)
from hulk_tpu_torch.ops.longread import long_read_minimizers
from hulk_tpu_torch.ops.minimizer import short_read_mask
from hulk_tpu_torch.sketch.histosketch import HistoSketch
from hulk_tpu_torch.sketch.hyperminhash import HyperMinHash
from hulk_tpu_torch.sketch.minhash import KHFSketch, KMVSketch
from hulk_tpu_torch.sketch.spectrum import KmerSpectrum
from hulk_tpu_torch.stream.fastq import (
    LongRead,
    batch_reads,
    batch_reads_native,
    prefetch_batches,
)

log = logging.getLogger("hulk")

# Bound on the positions of one batch (R x L), so that each of the step's
# [R, L] int64 intermediates holds at most 16384 x 2048 x 8 bytes: R = 16384
# up to L = 2048, and longer length buckets take proportionally fewer rows.
MAX_BATCH_POSITIONS = 16384 * 2048

CHECKPOINT_MAGIC = "hulk_checkpoint_v1"

# Counters of the interval machinery, for measurement: device flushes run,
# margin-overflow fallbacks to the host flush, and the seconds the
# streaming thread waited on the flush worker, one entry a wait. Callers
# reset them as they see fit.
flush_stats = {"device_flushes": 0, "margin_fallbacks": 0, "flush_waits": []}


@dataclass
class SketchConfig:
    kmer_size: int = 21
    window_size: int = 9
    sketch_size: int = 50
    spectrum_size: int = 0  # 0 -> k^4 (cmd/sketch.go:118)
    decay_ratio: float = 1.0
    interval: int = 0
    fasta: bool = False
    kmv: bool = False
    khf: bool = False
    hmh: bool = False
    banner_label: str = "blank"
    file_name: str = ""
    batch_size: int = 0  # 0 -> auto: largest fused-step-capable R (<= 16384)
    device: str = "cuda"
    device_flush: bool = False  # no-drift flush's candidate stage on the device
    input_paths: list | None = None  # set -> native C++ parser feeds batches
    checkpoint_path: str | None = None  # write a snapshot after each interval
    resume_from: str | None = None  # restore a snapshot and skip its reads
    # interval snapshots (on_interval) also carry KMV/KHF/HMH, at the cost
    # of one device-state readback an interval (--streamAll)
    interval_secondary: bool = False

    def resolved_spectrum_size(self) -> int:
        return self.spectrum_size if self.spectrum_size else self.kmer_size ** 4

    def resolved_batch_size(self) -> int:
        """The largest power-of-two R (<= 16384) whose read ids still pack
        above the value bits of the fused step's sort key; 2048 where none
        does (k >= 23), which takes the two-sort step."""
        if self.batch_size:
            return self.batch_size
        r = 16384
        while r > 2048 and not fused_bits_ok(self.kmer_size, r):
            r //= 2
        return r


@dataclass
class SketchResult:
    hulk_data: HULKData
    seq_count: int = 0
    length_total: int = 0
    minimizer_count: int = 0


class PipelineError(ValueError):
    pass


class _DeviceStream:
    """Device-resident histogram (int32), minimizer count (int64) and the
    KMV/KHF/HMH states of the sketches that are on.

    Batches are staged on the host in groups of GROUP and shipped as one
    pinned v2 buffer (2-bit codes + N bitmask + u16 lengths) per group with
    one asynchronous copy. Each group's row count r is its largest batch's,
    rounded up to 64 (at most R): rows past a batch's reads are dead (length
    0) and inert in every kernel.
    """

    GROUP = 16

    def __init__(self, cfg: SketchConfig, nbins: int):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.R = cfg.resolved_batch_size()
        self.nbins = nbins
        self.hist = torch.zeros(nbins, dtype=torch.int32, device=self.device)
        self.count = torch.zeros((), dtype=torch.int64, device=self.device)
        self.states = (
            SketchStates.empty(cfg.sketch_size, kmv=cfg.kmv, khf=cfg.khf, hmh=cfg.hmh,
                               device=self.device)
            if cfg.kmv or cfg.khf or cfg.hmh else None
        )
        self._staged: list = []
        self._staged_l = None

    def feed(self, batch) -> None:
        """Stage one batch (parser RawReads or padded PackedReads), split by
        rows so that R x L stays within MAX_BATCH_POSITIONS."""
        l = batch.bucket if hasattr(batch, "bucket") else batch.codes.shape[1]
        rows = max(1, min(self.R, MAX_BATCH_POSITIONS // l))
        if self._staged and self._staged_l != l:
            self._flush_staged()
        self._staged_l = l
        for s in range(0, batch.lengths.shape[0], rows):
            self._staged.append(
                (batch.codes[s:s + rows], batch.lengths[s:s + rows])
            )
            if len(self._staged) >= self.GROUP:
                self._flush_staged()

    def _flush_staged(self) -> None:
        from hulk_tpu_torch import native

        if not self._staged:
            return
        staged, self._staged = self._staged, []
        cfg, l, g = self.cfg, self._staged_l, len(staged)
        r = min(self.R, -(-max(c.shape[0] for c, _ in staged) // 64) * 64)
        host = torch.empty(native.group2_nbytes(g, r, l), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        native.pack_group2(staged, g, r, l, out=host.numpy())
        group_scan_body(
            self.hist, self.count, host.to(self.device, non_blocking=True),
            g=g, r=r, l=l, k=cfg.kmer_size, w=cfg.window_size,
            bucket=stream_bucket(r, r * l, l=l, k=cfg.kmer_size,
                                 w=cfg.window_size),
            states=self.states,
        )

    def minimizer_total(self) -> int:
        self._flush_staged()
        return int(self.count)

    def take_hist(self) -> torch.Tensor:
        """Hand the device histogram to the caller and start a new one, with
        no copy to the host (the device flush consumes it where it is)."""
        self._flush_staged()
        h = self.hist
        self.hist = torch.zeros(self.nbins, dtype=torch.int32, device=self.device)
        return h

    def drain_into(self, spectrum: KmerSpectrum) -> None:
        """Add the device histogram to the host spectrum and reset it."""
        self._flush_staged()
        h = self.hist.cpu().numpy().astype(np.float64)
        if h.any():
            spectrum.add_dense(h)
            self.hist.zero_()

    def collect(self, kmv, khf, hmh) -> None:
        """Merge the device states into the host objects (bottom-s union,
        elementwise minimum, register maximum: each sketch's exact merge, so
        the host's own long-read values and a resumed state survive)."""
        self._flush_staged()
        st = self.states
        u64 = lambda t: t.cpu().numpy().view(np.uint64)  # noqa: E731
        if kmv is not None:
            vals = u64(st.kmv)
            vals = vals[vals != np.uint64(0xFFFFFFFFFFFFFFFF)]
            kmv._values = np.sort(np.concatenate([kmv._values, vals]))[: self.cfg.sketch_size]
        if khf is not None:
            khf.sketch = np.minimum(khf.sketch, u64(st.khf))
        if hmh is not None:
            hmh.registers = np.maximum(hmh.registers, u64(st.hmh))


def _save_checkpoint(path, *, seq_count, length_total, minimizer_count, hs,
                     kmv, khf, hmh, cfg, origin=None):
    """Atomic snapshot of the stream's persistent state at an interval
    boundary (the spectrum is empty there: the flush has just wiped it), in
    hulk_tpu's format: the same np.savez keys, so either package resumes
    the other's checkpoints."""
    payload = dict(
        magic=CHECKPOINT_MAGIC,
        kmer_size=cfg.kmer_size, window_size=cfg.window_size,
        sketch_size=cfg.sketch_size, spectrum_size=cfg.resolved_spectrum_size(),
        decay_ratio=cfg.decay_ratio, interval=cfg.interval,
        seq_count=seq_count, length_total=length_total,
        minimizer_count=minimizer_count,
        hs_sketch=hs.sketch, hs_weights=hs.sketch_weights, cms=hs.cms.sketch,
    )
    if kmv is not None:
        payload["kmv_values"] = kmv._values
    if khf is not None:
        payload["khf_sketch"] = khf.sketch
    if hmh is not None:
        payload["hmh_registers"] = hmh.registers
    if origin is not None and origin[0] is not None:
        # the input's seek target at this boundary: (file index, records
        # consumed from it), so that resume opens no earlier file and skips
        # the consumed prefix by counting lines
        payload["resume_file_idx"] = int(origin[0])
        payload["resume_reads_in_file"] = int(origin[1])
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz", path)


def _load_checkpoint(path, cfg, hs, kmv, khf, hmh):
    """Restore a snapshot into hs and the sketch objects; returns
    (seq_count, length_total, minimizer_count, origin). Raises
    PipelineError on any parameter mismatch."""
    if not os.path.exists(path):
        raise PipelineError(f"checkpoint does not exist: {path}")
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != CHECKPOINT_MAGIC:
        raise PipelineError(f"not a hulk checkpoint: {path}")
    for key, want in (
        ("kmer_size", cfg.kmer_size), ("window_size", cfg.window_size),
        ("sketch_size", cfg.sketch_size),
        ("spectrum_size", cfg.resolved_spectrum_size()),
        ("decay_ratio", cfg.decay_ratio), ("interval", cfg.interval),
    ):
        got = z[key].item()
        if got != want:
            raise PipelineError(
                f"checkpoint parameter mismatch: {key}={got} vs {want}"
            )
    hs.sketch = z["hs_sketch"].copy()
    hs.sketch_weights = z["hs_weights"].copy()
    hs.cms.sketch = z["cms"].copy()
    for obj, key, attr, what in (
        (kmv, "kmv_values", "_values", "KMV"), (khf, "khf_sketch", "sketch", "KHF"),
        (hmh, "hmh_registers", "registers", "HyperMinHash"),
    ):
        if obj is not None:
            if key not in z:
                raise PipelineError(f"checkpoint has no {what} state")
            setattr(obj, attr, z[key].copy())
    origin = None
    if "resume_file_idx" in z:
        origin = (int(z["resume_file_idx"]), int(z["resume_reads_in_file"]))
    return (
        int(z["seq_count"]), int(z["length_total"]),
        int(z["minimizer_count"]), origin,
    )


def _merge_host_hist(hist: torch.Tensor, spectrum: KmerSpectrum) -> torch.Tensor:
    """Add the host spectrum's counts (long reads') onto a device histogram
    and wipe the host side: the device flush's merge point (exact, integer
    counts). The copy to the device is made from an owned int32 copy of the
    counts and finishes before the wipe: torch.from_numpy shares memory,
    and a non-blocking copy of spectrum.bins itself could read it after
    wipe() has zeroed it."""
    host = torch.from_numpy(spectrum.bins.astype(np.int32))
    out = hist + host.to(hist.device)
    spectrum.wipe()
    return out


class _DeviceFlusher:
    """The no-drift histosketch flush with its candidate stage on the
    device: the CMS update and the frequency estimates exact on the device,
    the CWS argmin there with the device's exp/log, and the top-T
    candidates of each slot rechecked on the host with the Go ports
    (HistoSketch.apply_flush_candidates): bit-identical to the host flush,
    with a full host flush in the rare case that the margin count exceeds T.

    The CMS stays on the device between flushes; the CWS tables go to the
    device once. hs.sketch and hs.sketch_weights stay on the host and are
    updated after every flush; hs.cms.sketch is brought up to date on
    demand (checkpoints, end of run)."""

    def __init__(self, hs: HistoSketch, nbins: int, device: torch.device):
        from hulk_tpu_torch.parallel.mesh import FLUSH_TOP_T
        from hulk_tpu_torch.sketch.countmin import cms_row_bins_table
        from hulk_tpu_torch.sketch.spectrum import MIN_USED_BINS, SpectrumError

        self.hs = hs
        self.nbins = nbins
        self._min_used = MIN_USED_BINS
        self._spectrum_error = SpectrumError
        self.top_t = FLUSH_TOP_T
        depth, width = hs.cms.sketch.shape
        self.row_bins = torch.from_numpy(
            cms_row_bins_table(nbins, depth, width).astype(np.int64)).to(device)
        # torch.tensor copies: the tables are read-only memory maps
        self.tables = tuple(torch.tensor(t, device=device)
                            for t in (hs.cws.c, hs.cws.b, hs.cws.exp_r))
        # owned copy (astype copies): on the CPU, .to() would share the
        # memory of hs.cms.sketch, which the fallback flush mutates in place
        self.cms = torch.from_numpy(hs.cms.sketch.astype(np.float64)).to(device)

    def flush_from(self, hist: torch.Tensor) -> None:
        """Consume a device histogram [nbins] (the reference's flush: a
        no-op when untouched, fatal below MIN_USED_BINS)."""
        from hulk_tpu_torch.parallel import mesh

        used = int((hist != 0).sum())
        if used == 0:
            return
        if used / float(self.nbins) < self._min_used:
            raise self._spectrum_error("not used yet")
        flush_stats["device_flushes"] += 1
        cms_out, cb, ce, cl, mc = mesh.device_flush_candidates(
            hist, self.row_bins, self.cms, *self.tables, top_t=self.top_t)
        if self.hs.apply_flush_candidates(
            cb.cpu().numpy(), ce.cpu().numpy(), cl.cpu().numpy(), mc.cpu().numpy(),
            self.top_t,
        ):
            self.cms = cms_out
            return
        # margin overflow: the exact host flush instead, so that exactness
        # never rests on the device's exp/log
        flush_stats["margin_fallbacks"] += 1
        log.info("\tdevice flush margin overflow; host fallback")
        self.hs.cms.sketch = self.cms.cpu().numpy().astype(np.float64)
        h = hist.cpu().numpy().astype(np.float64)
        ids = np.nonzero(h)[0].astype(np.int64)
        self.hs.add_elements(ids, h[ids])
        self.cms = torch.from_numpy(
            self.hs.cms.sketch.astype(np.float64)).to(self.cms.device)

    def sync_cms(self) -> None:
        """Bring hs.cms.sketch up to date from the device (an owned copy)."""
        self.hs.cms.sketch = self.cms.cpu().numpy().astype(np.float64)


def _skip_resumed(batches, skip: int):
    """Replay resume: drop the first `skip` reads of the stream (FASTA and
    iterator input, which cannot seek)."""
    done = 0
    for b in batches:
        if done < skip:
            done += 1 if isinstance(b, LongRead) else int((b.lengths > 0).sum())
            if done > skip:
                raise PipelineError("resume point does not align with batch cuts")
            continue
        yield b


def run_sketch_pipeline(
    reads: Iterator[bytes] | None, cfg: SketchConfig, on_interval=None
) -> SketchResult:
    """Sketch `reads` (or cfg.input_paths through the native parser when
    reads is None) on cfg.device.

    on_interval: optional callable, called from the flush worker with a
    HULKData snapshot after every interval flush (--stream): the
    histosketch only, or with cfg.interval_secondary the KMV/KHF/HMH
    sketches too."""
    k, w = cfg.kmer_size, cfg.window_size
    if not 0 < k < 32:
        raise PipelineError("k size must be: 0 < k < 32")
    if not 0 < w < 257:
        raise PipelineError("w must be: 0 < w < 257")
    if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
        raise PipelineError(
            f"device {cfg.device!r} requested but no CUDA device is available "
            "(use --device cpu for the plain PyTorch versions)"
        )
    from hulk_tpu_torch import native

    if not native.available():
        raise PipelineError("the native host runtime (g++) is unavailable")
    nbins = cfg.resolved_spectrum_size()
    spectrum = KmerSpectrum(nbins)
    hs = HistoSketch(k, cfg.sketch_size, nbins, cfg.decay_ratio)
    kmv = KMVSketch(k, cfg.sketch_size) if cfg.kmv else None
    khf = KHFSketch(k, cfg.sketch_size) if cfg.khf else None
    hmh = HyperMinHash(k) if cfg.hmh else None

    seq_count = 0
    length_total = 0
    minimizer_count = 0
    resume_origin = None
    if cfg.resume_from:
        if not cfg.interval:
            raise PipelineError("resume requires interval mode (snapshots are taken at interval flushes)")
        seq_count, length_total, minimizer_count, resume_origin = _load_checkpoint(
            cfg.resume_from, cfg, hs, kmv, khf, hmh
        )
        log.info("\tresumed from checkpoint at %d sequences", seq_count)
    resume_base = seq_count
    next_report = (seq_count // 100_000 + 1) * 100_000

    flusher = None
    if cfg.device_flush:
        if cfg.decay_ratio != 1.0:
            raise PipelineError(
                "device flush supports decayRatio=1.0 only (the drift "
                "selection is order-dependent and a device scan measures "
                "~5x slower than the overlapped host flush — decision "
                "record in docs/PERF.md; the host flush handles drift "
                "exactly at zero wall-time cost)"
            )
    dev = _DeviceStream(cfg, nbins)
    if cfg.device_flush:
        flusher = _DeviceFlusher(hs, nbins, dev.device)

    def flush():
        # boss.go:112-128: flush is a no-op on an untouched spectrum;
        # otherwise dump (ascending bins) -> histosketch, then wipe
        if spectrum.cardinality() != 0:
            bins, freqs = spectrum.dump()
            hs.add_elements(bins, freqs)
            spectrum.wipe()

    def interval_flush(hist, counters, snap_states, origin):
        """One interval's flush, snapshot and checkpoint (flush worker)."""
        if flusher is not None:
            flusher.flush_from(hist)
            if cfg.checkpoint_path:
                flusher.sync_cms()
        flush()
        if on_interval is not None:
            snap = HULKData(filename=cfg.file_name, banner=cfg.banner_label)
            snap.add(hs)
            if cfg.interval_secondary:
                for obj in snap_states:
                    if obj is not None:
                        snap.add(obj)
            on_interval(snap)
        if cfg.checkpoint_path:
            sc, lt, mc = counters
            _save_checkpoint(
                cfg.checkpoint_path, seq_count=sc, length_total=lt,
                minimizer_count=mc, hs=hs, kmv=snap_states[0], khf=snap_states[1],
                hmh=snap_states[2], cfg=cfg, origin=origin,
            )

    cut = cfg.interval if cfg.interval else None
    seek_resume = (
        resume_base > 0 and resume_origin is not None and reads is None
        and not cfg.fasta
    )
    if reads is None:
        if cfg.input_paths is None:
            raise PipelineError("no input: give reads or cfg.input_paths")
        kw = {}
        if seek_resume:
            # earlier files are never opened; the boundary file's consumed
            # prefix is skipped by counting lines
            kw = dict(start_file=resume_origin[0], skip_reads=resume_origin[1])
            log.info("\tseek resume: file %d, skipping %d records",
                     resume_origin[0], resume_origin[1])
        batches = batch_reads_native(
            cfg.input_paths, batch_size=cfg.resolved_batch_size(),
            cut_every=cut, fasta=cfg.fasta, raw=True, **kw,
        )
    else:
        batches = batch_reads(
            reads, batch_size=cfg.resolved_batch_size(), cut_every=cut
        )
    if resume_base and not seek_resume:
        batches = _skip_resumed(batches, resume_base)
    batches = prefetch_batches(batches, depth=2 * dev.GROUP)

    # The flush of an interval runs in one background worker, overlapped
    # with the next interval's streaming. One flush at most is in flight
    # (the histosketch is sequential across intervals): the streaming
    # thread waits for it before each drain and before a long read touches
    # the host spectrum, which the worker owns meanwhile. Both threads
    # issue device work to the same (default) stream, so it runs in issue
    # order, and the worker holds its histogram until it is done with it.
    pool = ThreadPoolExecutor(1)
    pending = None

    def wait_flush():
        nonlocal pending
        if pending is not None:
            t0 = time.perf_counter()
            pending.result()
            flush_stats["flush_waits"].append(time.perf_counter() - t0)
            pending = None

    want_snap = bool(cfg.checkpoint_path) or (
        cfg.interval_secondary and on_interval is not None)
    last_origin = None
    try:
        for batch in batches:
            if batch.file_idx is not None:
                last_origin = (batch.file_idx, batch.reads_in_file_end)
            if isinstance(batch, LongRead):
                # past the batched path's length cap: the blockwise scan,
                # into the host spectrum and sketch objects (hulk_tpu's
                # pipeline.py:1023-1052); the device states merge with them
                # at the end
                wait_flush()
                L = int(batch.codes.shape[0])
                if L < w + k - 1:
                    raise PipelineError("sequence length must be >= w + k - 1")
                flat = long_read_minimizers(batch.codes, k=k, w=w, device=dev.device)
                minimizer_count += int(flat.shape[0])
                if flat.shape[0]:
                    spectrum.add_hashes(flat)
                    for obj in (kmv, khf, hmh):
                        if obj is not None:
                            obj.add_hashes(flat)
                n_in_batch = 1
                seq_count += 1
                length_total += L
            else:
                active = batch.lengths > 0
                if (short_read_mask(batch.lengths, k, w) & active).any():
                    raise PipelineError("sequence length must be >= w + k - 1")
                dev.feed(batch)
                n_in_batch = int(active.sum())
                seq_count += n_in_batch
                length_total += int(batch.lengths.sum())
            while seq_count >= next_report:
                log.info("\tprocessed %d sequences", next_report)
                next_report += 100_000
            if cut is not None and seq_count % cut == 0 and n_in_batch > 0:
                log.info("\treached interval %d -> histosketching", seq_count // cut)
                wait_flush()
                hist = None
                if flusher is not None:
                    hist = dev.take_hist()
                    if spectrum.cardinality() != 0:
                        hist = _merge_host_hist(hist, spectrum)
                else:
                    dev.drain_into(spectrum)
                snap_states = (kmv, khf, hmh)
                if want_snap:
                    # one device-state readback an interval
                    snap_states = tuple(copy.deepcopy(o) for o in snap_states)
                    dev.collect(*snap_states)
                counters = None
                if cfg.checkpoint_path:
                    counters = (seq_count, length_total,
                                minimizer_count + dev.minimizer_total())
                pending = pool.submit(interval_flush, hist, counters, snap_states,
                                      last_origin)

        log.info("generating final histosketch of k-mer spectra...")
        wait_flush()
        if flusher is not None:
            h = dev.take_hist()
            if spectrum.cardinality() != 0:
                h = _merge_host_hist(h, spectrum)
            flusher.flush_from(h)
            flusher.sync_cms()
        else:
            dev.drain_into(spectrum)
        dev.collect(kmv, khf, hmh)
        minimizer_count += dev.minimizer_total()
        flush()
    finally:
        pool.shutdown(wait=False)
    if seq_count == 0:
        raise PipelineError("no sequences received")

    hulk_data = HULKData(filename=cfg.file_name, banner=cfg.banner_label)
    for obj in (hs, kmv, khf, hmh):
        if obj is not None:
            hulk_data.add(obj)
    return SketchResult(
        hulk_data=hulk_data,
        seq_count=seq_count,
        length_total=length_total,
        minimizer_count=minimizer_count,
    )
