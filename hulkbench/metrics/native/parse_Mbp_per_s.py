"""native.parse_Mbp_per_s: the host input layer alone (the native gunzip
and parse, stream/fastq.py batch_reads_native, at the job's batch size and
thread count), over one job's input after the window, on the host clock:
bases parsed, in Mbp, over its seconds."""
from __future__ import annotations

import time


def read(ctx) -> float | None:
    from hulk_tpu_torch import native
    from hulk_tpu_torch.stream.fastq import LongRead, batch_reads_native
    from hulk_tpu_torch.stream.pipeline import SketchConfig

    cfg = ctx.config
    native.set_threads(cfg["processors"])
    batch = SketchConfig(kmer_size=cfg["kmer_size"]).resolved_batch_size()
    t0 = time.perf_counter()
    bases = 0
    for b in batch_reads_native(ctx.job_paths, batch_size=batch, fasta=cfg["fasta"], raw=True):
        bases += b.codes.shape[0] if isinstance(b, LongRead) else int(b.lengths.sum())
    dt = time.perf_counter() - t0
    return bases / dt / 1e6 if bases and dt > 0 else None
