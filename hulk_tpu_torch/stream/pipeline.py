"""The sketch pipeline: reads -> minimizers -> spectrum -> histosketch.

Counterpart of hulk_tpu/stream/pipeline.py (SketchConfig, _DeviceStream,
the data-parallel _ShardedDeviceStream, the checkpoint format, the device
flusher and run_sketch_pipeline) on a list of PyTorch devices. The native
parser feeds
fixed-shape batches of FASTQ reads or FASTA records; groups of GROUP batches
are packed into one pinned host buffer (native pack_group2), copied to the
device once, and stepped batch by batch (ops/device_step.py) into an int32
histogram and the KMV/KHF/HMH states, which stay on the device: the
histogram until an interval boundary or the end, where the exact flush
turns it into the histosketch, the secondary sketches until the end. A read
of 65,536 bases or more arrives alone (LongRead) and goes through the
long-read step (ops/longread.py) on the stream's device (shard 0 of a
sharded stream) into the same histogram, count and states. Interval
boundaries are global read indices, as in the reference, so the output does
not depend on batching or on the device.

Each interval's flush runs in one background worker while the next
interval streams. On CUDA devices in one process, or with device_flush,
every flush, the interval flushes and the last, runs exactly on the
stream's devices (_CardFlusher: mesh.sharded_flush_step, Go's Exp and Log
in a kernel on the card, their plain versions on the CPU); otherwise, on
the CPU or with several processes, the exact host flush (native). Both
routes give the same bits. At most one flush is in flight. After it, the
--stream callback gets a snapshot and, with checkpoint_path, the state
goes to disk in hulk_tpu's checkpoint format, so that a run checkpointed
by either package resumes in the other.

Given more than one device (SketchConfig.devices) the stream shards each
batch's rows over them (_ShardedDeviceStream, each device with its own
carries, stepped in a thread of its own) and _CardFlusher stripes the
CWS tables over them by slots (parallel/mesh.py). hulk_tpu's
per-batch _dispatch_legacy is not ported: it serves hosts without the
native library and k too large for the fused step, and the port needs the
native library while group_scan_body takes the two-sort step at k >= 23.
With more than one process (parallel/distributed.py) each process
sketches its own files and the partial states merge exactly at the end
(integer histogram sums, bottom-s union, minima, maxima) before the one
flush, which every process runs alike.
"""
from __future__ import annotations

import copy
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from hulk_tpu_torch import spans
from hulk_tpu_torch.io.sketchio import HULKData
from hulk_tpu_torch.ops.device_sketches import SketchStates
from hulk_tpu_torch.ops.device_step import (
    fused_bits_ok,
    group_scan_body,
    ship_group,
    stream_bucket,
)
from hulk_tpu_torch.ops.longread import long_read_step, to_device
from hulk_tpu_torch.ops.minimizer import short_read_mask
from hulk_tpu_torch.parallel import distributed as dist
from hulk_tpu_torch.parallel import mesh
from hulk_tpu_torch.sketch.histosketch import HistoSketch
from hulk_tpu_torch.sketch.hyperminhash import HyperMinHash
from hulk_tpu_torch.sketch.minhash import KHFSketch, KMVSketch
from hulk_tpu_torch.sketch.spectrum import MIN_USED_BINS, KmerSpectrum, SpectrumError
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

# The seconds the streaming thread waited on the flush worker, one entry a
# wait, for measurement. Callers reset them as they see fit.
flush_stats = {"flush_waits": []}


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
    device_flush: bool = False  # every flush on the devices (_CardFlusher), as on CUDA
    input_paths: list | None = None  # set -> native C++ parser feeds batches
    checkpoint_path: str | None = None  # write a snapshot after each interval
    resume_from: str | None = None  # restore a snapshot and skip its reads
    # interval snapshots (on_interval) also carry KMV/KHF/HMH, at the cost
    # of one device-state readback an interval (--streamAll)
    interval_secondary: bool = False
    # the devices to shard the stream over (make_sketch_mesh(devices=...));
    # may name one more than once. None: [device]. Several cards in one
    # process measured slower than one (PERF.md), so none is the default.
    devices: list | None = None
    # the most threads that inflate one .gz input at once (the CLI's -p)
    processors: int = 1

    def resolved_devices(self) -> list:
        if self.devices is not None:
            return mesh.make_sketch_mesh(devices=self.devices)
        return [torch.device(self.device)]

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

    def __init__(self, cfg: SketchConfig, nbins: int, device: torch.device):
        self.cfg = cfg
        self.device = device
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

    def _rows(self, l: int) -> int:
        """The rows of one step at length l: R, fewer where R x L would pass
        MAX_BATCH_POSITIONS."""
        return max(1, min(self.R, MAX_BATCH_POSITIONS // l))

    def feed(self, batch) -> None:
        """Stage one batch (parser RawReads or padded PackedReads), split by
        rows so that R x L stays within MAX_BATCH_POSITIONS."""
        l = batch.bucket if hasattr(batch, "bucket") else batch.codes.shape[1]
        rows = self._rows(l)
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
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        cfg, l = self.cfg, self._staged_l
        flat, g, r = ship_group(staged, l, self.R, self.device)
        group_scan_body(
            self.hist, self.count, flat,
            g=g, r=r, l=l, k=cfg.kmer_size, w=cfg.window_size,
            bucket=stream_bucket(r, r * l, l=l, k=cfg.kmer_size,
                                 w=cfg.window_size),
            states=self.states,
        )

    def long_read(self, codes: np.ndarray) -> None:
        """One record past the batched path's length cap into the histogram,
        count and states of the stream's (first) device: one copy, one
        record scan, one sort and one binning launch (ops/longread.py)."""
        cfg = self.cfg
        spans.count("stream.batches")
        with spans.span("stream.long_read"):
            long_read_step(self.hist, self.count, self.states, to_device(codes, self.device),
                           k=cfg.kmer_size, w=cfg.window_size)

    def minimizer_total(self) -> int:
        self._flush_staged()
        with spans.span("stream.sync"):
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
        with spans.span("stream.sync"):
            h = self.hist.cpu().numpy().astype(np.float64)
        if h.any():
            spectrum.add_dense(h)
            self.hist.zero_()

    def collect(self, kmv, khf, hmh) -> None:
        """Merge the device states into the host objects (bottom-s union,
        elementwise minimum, register maximum: each sketch's exact merge, so
        a resumed state survives)."""
        self._flush_staged()
        _merge_states(self.states, kmv, khf, hmh, self.cfg.sketch_size)


def _merge_states(st: SketchStates | None, kmv, khf, hmh, s: int) -> None:
    """Merge device sketch states into the host objects: bottom-s union of
    the multisets, elementwise minimum, register maximum. Each is the
    sketch's exact merge, so merging shard after shard gives the merge of
    all, and a resumed state survives. No state (no sketch on): nothing to
    read."""
    if st is None:
        return
    u64 = lambda t: t.cpu().numpy().view(np.uint64)  # noqa: E731
    with spans.span("stream.sync"):
        if kmv is not None:
            vals = u64(st.kmv)
            vals = vals[vals != np.uint64(0xFFFFFFFFFFFFFFFF)]
            kmv._values = np.sort(np.concatenate([kmv._values, vals]))[:s]
        if khf is not None:
            khf.sketch = np.minimum(khf.sketch, u64(st.khf))
        if hmh is not None:
            hmh.registers = np.maximum(hmh.registers, u64(st.hmh))


class _ShardedDeviceStream(_DeviceStream):
    """The data-parallel stream (hulk_tpu's _ShardedDeviceStream,
    pipeline.py:448-713): each device owns an int32 histogram, an int64
    minimizer count and the sketch states, and steps its own rows with no
    collectives. Each staged batch (already split by rows, as on one
    device) goes to the devices in contiguous blocks of ceil(rows / D)
    rows; each device packs its blocks into its own pinned v2 buffer and
    copies it over. A device that got no rows of a batch steps nothing for
    it. Long records go to shard 0 (hists[0], counts[0] and
    shard_states[0] are the one-device stream's own). The shards merge
    exactly where the one-device stream hands its state over (take_hist,
    drain_into, collect, minimizer_total), so the rest of the pipeline does
    not change. The shards pack, copy and step in a thread each
    (mesh.sharded_group_step), each with its host syncs (one a batch in the
    fused step, none in the two-sort step without sketches)."""

    def __init__(self, cfg: SketchConfig, nbins: int, devices: list):
        super().__init__(cfg, nbins, devices[0])
        self.devices = devices
        self.hists = [self.hist] + [torch.zeros(nbins, dtype=torch.int32, device=d)
                                    for d in devices[1:]]
        self.counts = [self.count] + [torch.zeros((), dtype=torch.int64, device=d)
                                      for d in devices[1:]]
        self.shard_states = [self.states] + [
            SketchStates.empty(cfg.sketch_size, kmv=cfg.kmv, khf=cfg.khf, hmh=cfg.hmh,
                               device=d) if self.states is not None else None
            for d in devices[1:]]

    def _flush_staged(self) -> None:
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        cfg, l = self.cfg, self._staged_l
        shards = []
        for lo, hi in mesh.stripes(self._rows(l), len(self.devices)):
            mine = [(c[lo:hi], n[lo:hi]) for c, n in staged if min(hi, n.shape[0]) > lo]
            shards.append((mine, hi - lo) if mine else None)
        mesh.sharded_group_step(self.hists, self.counts, self.shard_states, shards,
                                l=l, k=cfg.kmer_size, w=cfg.window_size)

    def minimizer_total(self) -> int:
        self._flush_staged()
        with spans.span("stream.sync"):
            return sum(int(c) for c in self.counts)

    def _sum_hists(self) -> torch.Tensor:
        """The shards' histograms summed in int64 on devices[0] (hulk_tpu's
        _sum_shards), and each reset."""
        total = torch.zeros(self.nbins, dtype=torch.int64, device=self.device)
        for h in self.hists:
            total += h.to(self.device)
            h.zero_()
        return total

    def take_hist(self) -> torch.Tensor:
        self._flush_staged()
        return self._sum_hists()

    def drain_into(self, spectrum: KmerSpectrum) -> None:
        self._flush_staged()
        with spans.span("stream.sync"):
            h = self._sum_hists().cpu().numpy().astype(np.float64)
        if h.any():
            spectrum.add_dense(h)

    def collect(self, kmv, khf, hmh) -> None:
        self._flush_staged()
        for st in self.shard_states:
            _merge_states(st, kmv, khf, hmh, self.cfg.sketch_size)


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


class _CardFlusher:
    """Every histosketch flush on the stream's devices, exact: the CMS scan
    with drift (or the exact prefix sums without), Aka with Go's Exp and
    Log, and each slot's replace-if-below scan in bin order
    (mesh.sharded_flush_step), bit for bit the host flush's
    (HistoSketch.add_elements), drift or not, any number of stripes.

    The CMS stays on devices[0] between flushes; the CWS tables go to the
    devices once a process, striped over them by slots
    (mesh.cached_table_stripes). Only the sketch's bins and weights come
    back after a flush, into hs, where the snapshots and the final document
    read them; hs.cms.sketch is brought up to date on demand (sync_cms:
    checkpoints, end of run). The reference's errors come at the same
    points: a no-op on an untouched histogram, SpectrumError below
    MIN_USED_BINS."""

    def __init__(self, hs: HistoSketch, nbins: int, devices: list):
        self.hs = hs
        self.nbins = nbins
        device = devices[0]
        depth, width = hs.cms.sketch.shape
        self.row_bins = mesh.cached_row_bins(device, nbins, depth, width)
        self.stripes = mesh.cached_table_stripes(devices, hs.sketch_size, nbins)
        # owned copy (astype copies): on the CPU, .to() would share the
        # memory of hs.cms.sketch, which HistoSketch.add_elements updates
        # in place
        self.cms = torch.from_numpy(hs.cms.sketch.astype(np.float64)).to(device)
        self.step = mesh.sharded_flush_step(devices, hs.cms.decay_weight,
                                            hs.apply_concept_drift, depth, width)

    def flush_from(self, hist: torch.Tensor) -> None:
        """Consume a device histogram [nbins] (the reference's flush: a
        no-op when untouched, fatal below MIN_USED_BINS)."""
        used = int((hist != 0).sum())
        if used == 0:
            return
        if used / float(self.nbins) < MIN_USED_BINS:
            raise SpectrumError("not used yet")
        spans.count("flush.device")
        hs, home = self.hs, self.cms.device
        self.cms, sk, wt = self.step(
            hist, self.row_bins, self.cms, torch.tensor(hs.sketch.view(np.int64), device=home),
            torch.tensor(hs.sketch_weights, device=home), self.stripes)
        hs.sketch[:] = sk.cpu().numpy().view(np.uint64)
        hs.sketch_weights[:] = wt.cpu().numpy()

    def sync_cms(self) -> None:
        """Bring hs.cms.sketch up to date from the device (an owned copy)."""
        self.hs.cms.sketch = self.cms.cpu().numpy().astype(np.float64)


def _flush_on_card(devices: list, multi_process: bool) -> bool:
    """Whether every flush runs on the card (_CardFlusher): the stream's
    devices are CUDA devices and one process sketches. Several processes
    merge their spectra on the host and flush there; on the CPU the native
    host flush stays unless device_flush asks for _CardFlusher."""
    return not multi_process and all(d.type == "cuda" for d in devices)


def _merge_processes(spectrum, kmv, khf, hmh, counters, s: int) -> tuple:
    """Merge the processes' partial states, exactly, as hulk_tpu does
    (pipeline.py:1152-1176): the spectra's integer counts and the counters
    summed, the KMV values (padded with SENT to s) gathered and the
    bottom s kept, KHF minima, HMH register maxima. Every process ends with
    the same state, and so with the same flush. Returns the summed
    counters."""
    log.info("\tmerging %d process shards...", dist.world_size())
    spectrum.bins = dist.allreduce_sum(spectrum.bins)
    counters = dist.allreduce_sum(np.array(counters, dtype=np.int64))
    if kmv is not None:
        sent = np.uint64(0xFFFFFFFFFFFFFFFF)
        padded = np.full(s, sent, dtype=np.uint64)
        padded[: kmv._values.shape[0]] = kmv._values
        vals = np.sort(dist.allgather(padded).reshape(-1))
        kmv._values = vals[vals != sent][:s]
    if khf is not None:
        khf.sketch = dist.allgather(khf.sketch).min(axis=0)
    if hmh is not None:
        hmh.registers = dist.allgather(hmh.registers).max(axis=0)
    return tuple(int(x) for x in counters)


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
    reads is None) on cfg.resolved_devices(); with several processes, each
    sketches its own reads and all end with the merged result.

    on_interval: optional callable, called from the flush worker with a
    HULKData snapshot after every interval flush (--stream): the
    histosketch only, or with cfg.interval_secondary the KMV/KHF/HMH
    sketches too."""
    k, w = cfg.kmer_size, cfg.window_size
    if not 0 < k < 32:
        raise PipelineError("k size must be: 0 < k < 32")
    if not 0 < w < 257:
        raise PipelineError("w must be: 0 < w < 257")
    asked = [cfg.device] if cfg.devices is None else cfg.devices
    if any(torch.device(d).type == "cuda" for d in asked) and not torch.cuda.is_available():
        raise PipelineError(
            f"device {cfg.device!r} requested but no CUDA device is available "
            "(use --device cpu for the plain PyTorch versions)"
        )
    from hulk_tpu_torch import native

    if not native.available():
        raise PipelineError("the native host runtime (g++) is unavailable")
    nbins = cfg.resolved_spectrum_size()
    with spans.span("stream.setup"):
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

    multi_process = dist.world_size() > 1
    if multi_process and cfg.interval:
        raise PipelineError(
            "interval flushing requires a single process (multi-host runs "
            "shard whole files; use interval=0)"
        )
    if multi_process and (cfg.checkpoint_path or cfg.resume_from):
        raise PipelineError(
            "checkpoint/resume requires a single process (snapshots are "
            "per-interval, and intervals are single-process)"
        )
    if cfg.device_flush:
        if cfg.decay_ratio != 1.0:
            raise PipelineError(
                "device flush supports decayRatio=1.0 only (the drift "
                "selection is order-dependent and a device scan measures "
                "~5x slower than the overlapped host flush — decision "
                "record in docs/PERF.md; the host flush handles drift "
                "exactly at zero wall-time cost)"
            )
        if multi_process:
            raise PipelineError(
                "device flush requires a single process (the reference "
                "merges spectra before flushing once)"
            )
    with spans.span("stream.setup"):
        devices = cfg.resolved_devices()
        if len(devices) > 1:
            dev = _ShardedDeviceStream(cfg, nbins, devices)
        else:
            dev = _DeviceStream(cfg, nbins, devices[0])
        flusher = (_CardFlusher(hs, nbins, devices)
                   if cfg.device_flush or _flush_on_card(devices, multi_process) else None)

    def flush():
        # boss.go:112-128: flush is a no-op on an untouched spectrum;
        # otherwise dump (ascending bins) -> histosketch, then wipe
        if spectrum.cardinality() != 0:
            bins, freqs = spectrum.dump()
            spans.count("flush.host")
            hs.add_elements(bins, freqs)
            spectrum.wipe()

    def interval_flush(hist, counters, snap_states, origin):
        """One interval's flush, snapshot and checkpoint (flush worker)."""
        with spans.span("flush.interval"):
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
            cut_every=cut, fasta=cfg.fasta, raw=True,
            inflate_workers=cfg.processors, **kw,
        )
    else:
        batches = batch_reads(
            reads, batch_size=cfg.resolved_batch_size(), cut_every=cut
        )
    if resume_base and not seek_resume:
        batches = _skip_resumed(batches, resume_base)
    batches = prefetch_batches(
        batches, depth=2 * dev.GROUP, name="hulk-parse",
        span_names=("input.parse", "stream.input_wait"))

    # The flush of an interval runs in one background worker, overlapped
    # with the next interval's streaming. One flush at most is in flight
    # (the histosketch is sequential across intervals): the streaming
    # thread waits for it before each drain into the host spectrum, which
    # the worker owns meanwhile. Long reads go to the device's carries, as
    # short reads do, and need no wait: the worker holds only the histogram
    # handed to it (take_hist starts a new one; drain_into copies to the
    # host and zeroes it before the hand-off) and deep copies of the host
    # sketch objects. Both threads issue device work to the same (default)
    # stream, so it runs in issue order.
    pool = ThreadPoolExecutor(1, thread_name_prefix="hulk-flush")
    pending = None

    def wait_flush():
        nonlocal pending
        if pending is not None:
            t0, t1 = spans.timed("stream.flush_wait", pending.result)
            flush_stats["flush_waits"].append(t1 - t0)
            pending = None

    want_snap = bool(cfg.checkpoint_path) or (
        cfg.interval_secondary and on_interval is not None)
    last_origin = None
    try:
        with spans.span("stream.loop"):
            for batch in batches:
                if batch.file_idx is not None:
                    last_origin = (batch.file_idx, batch.reads_in_file_end)
                if isinstance(batch, LongRead):
                    # past the batched path's length cap (hulk_tpu's
                    # pipeline.py:1023-1052, which scans it blockwise into the
                    # host spectrum): the long-read step on the device
                    L = int(batch.codes.shape[0])
                    if L < w + k - 1:
                        raise PipelineError("sequence length must be >= w + k - 1")
                    dev.long_read(batch.codes)
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
                    with spans.span("stream.boundary"):
                        wait_flush()
                        hist = None
                        if flusher is not None:
                            hist = dev.take_hist()
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
                        pending = pool.submit(spans.carry(interval_flush), hist, counters,
                                              snap_states, last_origin)

        with spans.span("stream.finish"):
            log.info("generating final histosketch of k-mer spectra...")
            wait_flush()
            if flusher is not None:
                flusher.flush_from(dev.take_hist())
                flusher.sync_cms()
            else:
                dev.drain_into(spectrum)
            dev.collect(kmv, khf, hmh)
            minimizer_count += dev.minimizer_total()
            if multi_process:
                seq_count, length_total, minimizer_count = _merge_processes(
                    spectrum, kmv, khf, hmh, (seq_count, length_total, minimizer_count),
                    cfg.sketch_size)
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
