"""The sketch pipeline: reads -> minimizers -> spectrum -> histosketch.

Counterpart of hulk_tpu/stream/pipeline.py (SketchConfig, the single-device
_DeviceStream and run_sketch_pipeline) on one PyTorch device. The native
parser feeds fixed-shape batches of FASTQ reads or FASTA records; groups of
GROUP batches are packed into one pinned host buffer (native pack_group2),
copied to the device once, and stepped batch by batch (ops/device_step.py)
into an int32 histogram and the KMV/KHF/HMH states, which stay on the
device: the histogram until an interval boundary or the end, where the
exact host flush (native, bit-identical to the reference) turns it into the
histosketch, the secondary sketches until the end. A read of 65,536 bases
or more arrives alone (LongRead) and is scanned block by block
(ops/longread.py) into the host spectrum and sketch objects. Interval
boundaries are global read indices, as in the reference, so the output does
not depend on batching or on the device.

What this slice of the port does not take raises PipelineError:
--checkpoint/--resume, --stream and --deviceFlush.
"""
from __future__ import annotations

import logging
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
    device_flush: bool = False
    input_paths: list | None = None  # set -> native C++ parser feeds batches
    checkpoint_path: str | None = None
    resume_from: str | None = None

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


def _not_ported(cfg: SketchConfig, on_interval) -> str | None:
    """The first option of cfg that this slice of the port does not take."""
    for on, what in [
        (cfg.checkpoint_path or cfg.resume_from, "--checkpoint/--resume"),
        (on_interval is not None, "--stream"),
        (cfg.device_flush, "--deviceFlush"),
    ]:
        if on:
            return what
    return None


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
        the host's own long-read values survive)."""
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


def run_sketch_pipeline(
    reads: Iterator[bytes] | None, cfg: SketchConfig, on_interval=None
) -> SketchResult:
    """Sketch `reads` (or cfg.input_paths through the native parser when
    reads is None) on cfg.device. on_interval is the --stream callback of
    the reference, which this slice does not take."""
    k, w = cfg.kmer_size, cfg.window_size
    if not 0 < k < 32:
        raise PipelineError("k size must be: 0 < k < 32")
    if not 0 < w < 257:
        raise PipelineError("w must be: 0 < w < 257")
    missing = _not_ported(cfg, on_interval)
    if missing:
        raise PipelineError(f"{missing} is not ported to hulk_tpu_torch yet")
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
    dev = _DeviceStream(cfg, nbins)

    def flush():
        # boss.go:112-128: flush is a no-op on an untouched spectrum;
        # otherwise dump (ascending bins) -> histosketch, then wipe
        if spectrum.cardinality() != 0:
            bins, freqs = spectrum.dump()
            hs.add_elements(bins, freqs)
            spectrum.wipe()

    cut = cfg.interval if cfg.interval else None
    if reads is None:
        if cfg.input_paths is None:
            raise PipelineError("no input: give reads or cfg.input_paths")
        batches = batch_reads_native(
            cfg.input_paths, batch_size=cfg.resolved_batch_size(),
            cut_every=cut, fasta=cfg.fasta, raw=True,
        )
    else:
        batches = batch_reads(
            reads, batch_size=cfg.resolved_batch_size(), cut_every=cut
        )
    batches = prefetch_batches(batches, depth=2 * dev.GROUP)

    seq_count = 0
    length_total = 0
    minimizer_count = 0
    next_report = 100_000
    for batch in batches:
        if isinstance(batch, LongRead):
            # past the batched path's length cap: the blockwise scan, into
            # the host spectrum and sketch objects (hulk_tpu's pipeline.py
            # :1023-1052); the device states merge with them at the end
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
            dev.drain_into(spectrum)
            flush()

    log.info("generating final histosketch of k-mer spectra...")
    dev.drain_into(spectrum)
    dev.collect(kmv, khf, hmh)
    minimizer_count += dev.minimizer_total()
    flush()
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
