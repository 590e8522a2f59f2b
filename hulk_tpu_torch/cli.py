"""The port's command line: `sketch` and `version`.

Counterpart of hulk_tpu/cli.py (flags and defaults at :45-75, run_sketch at
:120, main at :718). Flag names, shorthands and defaults are hulk sketch's
(themselves the Go reference's), plus --device, so that

    python -m hulk_tpu_torch sketch -f reads.fq.gz -k 21 -w 9 -s 42 -o out

writes the same out.json byte for byte as `hulk sketch` does. Options that
this slice of the port does not take end the run with an error naming them.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from hulk_tpu_torch.version import HULK_COMPAT_VERSION

log = logging.getLogger("hulk")

_EXTS = ["fastq", "fq", "fasta", "fna", "fa"]


def _default_outfile() -> str:
    return "./hulk-" + time.strftime("%Y%m%d%H%M%S")


def _setup_log(log_file: str | None) -> None:
    # Go's log package format: "2009/01/23 01:23:23 message"
    handler = (
        logging.FileHandler(log_file) if log_file else logging.StreamHandler(sys.stdout)
    )
    handler.setFormatter(
        logging.Formatter(fmt="%(asctime)s %(message)s", datefmt="%Y/%m/%d %H:%M:%S")
    )
    log.handlers.clear()
    log.addHandler(handler)
    log.setLevel(logging.INFO)


def _error_check(msg: str) -> None:
    log.error("ERROR---> %s", msg)
    raise SystemExit(1)


def _add_global_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-k", "--kmerSize", type=int, default=21, help="minimizer k-mer length")
    p.add_argument(
        "-o", "--outFile", type=str, default=_default_outfile(),
        help="directory and basename for saving the outfile(s)",
    )
    p.add_argument("--log", dest="log_file", type=str, default="", help="filename for log file")
    p.add_argument("-p", "--processors", type=int, default=1, help="number of processors to use")
    p.add_argument("--profiling", action="store_true", help="write a profiler trace (not ported yet)")
    p.add_argument("--device", type=str, default="cuda", help="PyTorch device to sketch on (cuda, cuda:N or cpu)")


def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(prog="hulk", description="Histosketching Using Little Kmers (PyTorch/CUDA port)")
    sub = root.add_subparsers(dest="subcommand")

    ps = sub.add_parser("sketch", help="Create a sketch from a set of reads")
    _add_global_flags(ps)
    ps.add_argument("-f", "--fastq", action="append", default=[], help="FASTQ file(s) to sketch (can also pipe in STDIN)")
    ps.add_argument("--fasta", action="store_true", help="input is FASTA format")
    ps.add_argument("-w", "--windowSize", type=int, default=9, help="minimizer window size")
    ps.add_argument("-i", "--interval", type=int, default=0, help="size of k-mer sampling interval (0 = no interval)")
    ps.add_argument("-s", "--sketchSize", type=int, default=50, help="size of sketch")
    ps.add_argument("-x", "--decayRatio", type=float, default=1.0, help="decay ratio used for concept drift (1.0 = disabled)")
    ps.add_argument("--stream", action="store_true", help="print sketches to STDOUT after every interval (not ported yet)")
    ps.add_argument("-b", "--bannerLabel", type=str, default="blank", help="adds a label to the sketch object, for use with BANNER")
    ps.add_argument("--khf", action="store_true", help="also generate a MinHash K-Hash Functions sketch")
    ps.add_argument("--kmv", action="store_true", help="also generate a MinHash K-Minimum Values sketch")
    ps.add_argument("--hmh", "--hyperminhash", dest="hmh", action="store_true", help="also generate a HyperMinHash sketch")
    ps.add_argument("--deviceFlush", "--device-flush", dest="device_flush", action="store_true", help="run the histosketch flush on the device (not ported yet)")
    ps.add_argument("--checkpoint", type=str, default="", help="write a resumable state snapshot after every interval flush (not ported yet)")
    ps.add_argument("--resume", type=str, default="", help="resume a sketch run from a --checkpoint snapshot (not ported yet)")

    pv = sub.add_parser("version", help="prints current version and exits")
    _add_global_flags(pv)
    return root


def _split_fastq_args(vals: list[str]) -> list[str]:
    out: list[str] = []
    for v in vals:
        out.extend([x for x in v.split(",") if x])
    return out


def run_sketch(args) -> None:
    from hulk_tpu_torch import native
    from hulk_tpu_torch.stream.fastq import stream_reads
    from hulk_tpu_torch.stream.pipeline import (
        PipelineError,
        SketchConfig,
        run_sketch_pipeline,
    )

    _setup_log(args.log_file or None)
    start = time.time()
    log.info("this is hulk (version %s)", HULK_COMPAT_VERSION)
    log.info("please cite Rowe et al. 2019, doi: https://doi.org/10.1186/s40168-019-0653-2")
    log.info("starting the sketch subcommand")
    log.info("checking parameters...")
    if args.stream:
        _error_check("--stream is not ported to hulk_tpu_torch yet")
    if args.profiling:
        _error_check("--profiling is not ported to hulk_tpu_torch yet")

    fastq = _split_fastq_args(args.fastq)

    # sketchParamCheck (cmd/sketch.go:185-214)
    out_dir = os.path.dirname(args.outFile)
    if out_dir and out_dir != ".":
        os.makedirs(out_dir, mode=0o700, exist_ok=True)
    nproc = os.cpu_count() or 1
    if args.processors <= 0 or args.processors > nproc:
        args.processors = nproc
    native.set_threads(args.processors)
    if not fastq:
        if sys.stdin.isatty():
            _error_check("no STDIN found")
        log.info("\tinput file: using STDIN")
    else:
        for f in fastq:
            if not os.path.exists(f):
                _error_check(f"file does not exist: {f}")
            parts = f.split(".")
            idx = -2 if parts[-1] == "gz" else -1
            if parts[idx] not in _EXTS:
                _error_check(f"file does not have recognised extension: {f}")

    log.info("\tmode: %s", "FASTA" if args.fasta else "FASTQ")
    log.info("\tno. processors: %d", args.processors)
    log.info("\tminimizer k-mer size: %d", args.kmerSize)
    log.info("\tminimizer window size: %d", args.windowSize)
    log.info("\tsketch size: %d", args.sketchSize)
    log.info("\tstreaming: disabled")
    if args.decayRatio == 1:
        log.info("\tconcept drift: disabled")
    else:
        log.info("\tconcept drift: enabled")
        log.info("\tdecay ratio: %.2f", args.decayRatio)
    spectrum_size = args.kmerSize ** 4
    log.info("\tnumber of bins in k-mer spectrum: %d", spectrum_size)
    log.info("\tadding KHF sketch: %s", str(args.khf).lower())
    log.info("\tadding KMV sketch: %s", str(args.kmv).lower())
    if args.hmh:
        log.info("\tadding HyperMinHash sketch: true")
    log.info("\tdevice: %s", args.device)

    cfg = SketchConfig(
        kmer_size=args.kmerSize,
        window_size=args.windowSize,
        sketch_size=args.sketchSize,
        spectrum_size=spectrum_size,
        decay_ratio=args.decayRatio,
        interval=args.interval,
        fasta=args.fasta,
        kmv=args.kmv,
        khf=args.khf,
        hmh=args.hmh,
        banner_label=args.bannerLabel,
        file_name=(",".join(fastq) + ",") if fastq else "STDIN",
        device=args.device,
        device_flush=args.device_flush,
        checkpoint_path=args.checkpoint or None,
        resume_from=args.resume or None,
    )
    log.info("initialising sketching pipeline...")
    log.info("finding minimizers...")
    if fastq and native.available():
        cfg.input_paths = fastq
        reads = None
    else:
        reads = stream_reads(fastq, fasta=args.fasta, stdin=None if fastq else sys.stdin.buffer)
    try:
        result = run_sketch_pipeline(reads, cfg)
    except (PipelineError, ValueError) as e:
        _error_check(str(e))
        return

    mean_rl = int(result.length_total / result.seq_count)
    log.info("\tprocessed %d sequences in total", result.seq_count)
    log.info("\tmean sequence length: %d", mean_rl)
    log.info("\tfound %d minimizers", result.minimizer_count)
    log.info("\thistosketching across %d bins", spectrum_size)
    log.info("cleaning up...")
    result.hulk_data.write_json(args.outFile + ".json")
    log.info("\twritten sketch to disk: %s", args.outFile + ".json")
    log.info("finished in %.6fs", time.time() - start)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.subcommand == "sketch":
        run_sketch(args)
    elif args.subcommand == "version":
        print(HULK_COMPAT_VERSION)
    else:
        build_parser().print_help()
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
