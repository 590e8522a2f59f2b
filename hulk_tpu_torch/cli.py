"""The port's command line: `sketch`, `smash`, `index`, `print`, `distance`
and `version`.

Counterpart of hulk_tpu/cli.py (flags and defaults at :45-104, run_sketch at
:120, run_smash at :287 and _run_smash_distributed at :434, print and
distance at :570-600, run_index at :603, main at :718). Flag names,
shorthands and defaults are hulk's (themselves the Go reference's), plus
--device, so that

    python -m hulk_tpu_torch sketch -f reads.fq.gz -k 21 -w 9 -s 42 -o out
    python -m hulk_tpu_torch smash -d sketches/ -m weightedjaccard -o matrix
    python -m hulk_tpu_torch index -r create -n my.idx -d sketches/ -s 42
    python -m hulk_tpu_torch index -r search -n my.idx -d queries/ -s 42 -j 0.9

write the same bytes as `hulk sketch`, `hulk smash` and `hulk index` do.

Several processes (parallel/distributed.py) join one gloo group from the
environment, for example two on one machine:

    HULK_COORDINATOR=localhost:29500 HULK_NUM_PROCS=2 HULK_PROC_ID=0 \
        python -m hulk_tpu_torch smash -d sketches/ -m weightedjaccard -o m &
    HULK_COORDINATOR=localhost:29500 HULK_NUM_PROCS=2 HULK_PROC_ID=1 \
        python -m hulk_tpu_torch smash -d sketches/ -m weightedjaccard -o m

Each process runs on the devices it sees (CUDA_VISIBLE_DEVICES gives each
its own cards; add --device cpu for the plain versions) and process 0 alone
writes. `sketch` over several processes gives each process every N-th file
and merges their states exactly before the one flush; within a process,
`sketch --device cuda:0,cuda:1` shards the reads over the cards listed.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

from hulk_tpu_torch import spans
from hulk_tpu_torch.parallel import distributed as dist
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
    p.add_argument("--profiling", action="store_true", help="write a torch.profiler trace under ./hulk-profile")
    p.add_argument("--device", type=str, default="cuda", help="PyTorch device to run on: cuda or cuda:N (one card), cpu, or (sketch) a comma-separated list of devices to shard the reads over")


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
    ps.add_argument("--stream", action="store_true", help="print sketches to STDOUT after every interval (log redirected to disk; snapshots carry the histosketch only unless --streamAll)")
    ps.add_argument("--streamAll", dest="stream_all", action="store_true", help="with --stream: interval snapshots also carry the KMV/KHF/HMH signatures (costs one device-state sync per interval)")
    ps.add_argument("-b", "--bannerLabel", type=str, default="blank", help="adds a label to the sketch object, for use with BANNER")
    ps.add_argument("--khf", action="store_true", help="also generate a MinHash K-Hash Functions sketch")
    ps.add_argument("--kmv", action="store_true", help="also generate a MinHash K-Minimum Values sketch")
    ps.add_argument("--hmh", "--hyperminhash", dest="hmh", action="store_true", help="also generate a HyperMinHash sketch")
    ps.add_argument("--deviceFlush", "--device-flush", dest="device_flush", action="store_true", help="run the histosketch flush on the device (exact output, requires decayRatio=1.0)")
    ps.add_argument("--checkpoint", type=str, default="", help="write a resumable state snapshot after every interval flush (requires -i)")
    ps.add_argument("--resume", type=str, default="", help="resume a sketch run from a --checkpoint snapshot")

    pm = sub.add_parser("smash", help="Smash a bunch of sketches and return a distance matrix")
    _add_global_flags(pm)
    pm.add_argument("-d", "--sketchDir", type=str, default="./", help="the directory containing the sketches to smash")
    pm.add_argument("--recursive", action="store_true", help="recursively search the supplied sketch directory")
    pm.add_argument("-a", "--algorithm", type=str, default="histosketch", help="which sketching algorithm to use [histosketch, kmv, khf]")
    pm.add_argument("-m", "--metric", type=str, default="jaccard", help="which distance metric to use [jaccard, weightedjaccard]")
    pm.add_argument("--bannerMatrix", action="store_true", help="write a matrix file for banner")

    pi = sub.add_parser("index", help="Create or search an LSH Forest index of histosketches")
    _add_global_flags(pi)
    pi.add_argument("-r", "--run", type=str, required=True, help="index operation [create, add, search]")
    pi.add_argument("-n", "--indexName", type=str, required=True, help="index file name")
    pi.add_argument("-j", "--jsThresh", type=float, default=0.90, help="Jaccard similarity threshold for search")
    pi.add_argument("-d", "--sketchDir", type=str, default="./", help="directory containing sketches to index/query")
    pi.add_argument("--recursive", action="store_true", help="recursively search the supplied sketch directory")
    pi.add_argument("-s", "--sketchSize", type=int, default=50, help="sketch size the index holds")

    pp = sub.add_parser("print", help="print sketch values as CSV rows (v0.0.2 surface)")
    _add_global_flags(pp)
    pp.add_argument("-f", "--file", action="append", default=[], required=True, help="sketch JSON file(s) to print")
    pp.add_argument("-a", "--algorithm", type=str, default="histosketch", help="which sketch to print [histosketch, kmv, khf]")

    pd = sub.add_parser("distance", help="distance between two sketches (v0.0.2 surface)")
    _add_global_flags(pd)
    pd.add_argument("-f", "--file", action="append", default=[], required=True, help="exactly two sketch JSON files")
    pd.add_argument("-a", "--algorithm", type=str, default="histosketch", help="which sketching algorithm to use [histosketch, kmv, khf]")
    pd.add_argument("-m", "--metric", type=str, default="jaccard", help="which distance metric to use [jaccard, weightedjaccard]")

    pv = sub.add_parser("version", help="prints current version and exits")
    _add_global_flags(pv)
    return root


@contextlib.contextmanager
def _profiling(on: bool, device: str):
    """--profiling: a torch.profiler trace of the run, written under
    ./hulk-profile (hulk_tpu's path) as a Chrome trace; the card's
    activity is traced too when the run is on one. The program's spans
    (hulk_tpu_torch.spans) are on meanwhile, so the calling thread's spans
    lie in the trace beside the kernels."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    was = spans.enabled()
    spans.enable(True)
    try:
        with profile(activities=acts, on_trace_ready=tensorboard_trace_handler("./hulk-profile")):
            yield
    finally:
        spans.enable(was)


def _split_fastq_args(vals: list[str]) -> list[str]:
    out: list[str] = []
    for v in vals:
        out.extend([x for x in v.split(",") if x])
    return out


def run_sketch(args) -> None:
    """One sketch job: the span `job`, the root of the job's spans, from
    the parameter check to the last write."""
    with _profiling(args.profiling, args.device), spans.span("job"):
        _sketch_job(args)


def _sketch_job(args) -> None:
    from hulk_tpu_torch import native
    from hulk_tpu_torch.stream.fastq import stream_reads
    from hulk_tpu_torch.stream.pipeline import (
        PipelineError,
        SketchConfig,
        run_sketch_pipeline,
    )

    if args.stream and not args.log_file:
        args.log_file = args.outFile + ".log"
    _setup_log(args.log_file or None)
    start = time.time()
    log.info("this is hulk (version %s)", HULK_COMPAT_VERSION)
    log.info("please cite Rowe et al. 2019, doi: https://doi.org/10.1186/s40168-019-0653-2")
    log.info("starting the sketch subcommand")
    log.info("checking parameters...")

    fastq = _split_fastq_args(args.fastq)
    devices = [d for d in args.device.split(",") if d]

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
    log.info("\tstreaming: %s", "enabled" if args.stream else "disabled")
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
        device=devices[0],
        devices=devices if len(devices) > 1 else None,
        device_flush=args.device_flush,
        checkpoint_path=args.checkpoint or None,
        resume_from=args.resume or None,
        interval_secondary=args.stream_all,
        processors=args.processors,
    )

    # several processes: each takes a static shard of the files; the
    # pipeline merges the partial states exactly and process 0 writes
    multi_process = dist.world_size() > 1
    if multi_process:
        if not fastq:
            _error_check("multi-host runs require file inputs (no STDIN)")
        all_files = fastq
        fastq = dist.process_read_shard(fastq)
        cfg.file_name = ",".join(all_files) + ","
        log.info("\tmulti-host: process %d/%d takes %d of %d files",
                 dist.rank(), dist.world_size(), len(fastq), len(all_files))

    # backend-stall watchdog (stream/watchdog.py): probe the card before
    # consuming input; a hung context fails the run instead of hanging it
    from hulk_tpu_torch.stream.watchdog import guard_backend

    guard_backend(log, device=devices[0])

    log.info("initialising sketching pipeline...")
    log.info("finding minimizers...")
    if fastq and native.available():
        cfg.input_paths = fastq
        reads = None
    elif not fastq and multi_process:
        # more processes than files: this process's shard is empty, but it
        # still takes part in the final merge, and must not read STDIN
        reads = iter(())
    else:
        reads = stream_reads(fastq, fasta=args.fasta, stdin=None if fastq else sys.stdin.buffer)

    # --stream: the sketch to STDOUT after every interval flush (the Go
    # reference's documented behaviour, cmd/sketch.go:56), one JSON a line,
    # written by the flush worker, in order since one flush at most is in
    # flight
    on_interval = None
    if args.stream and args.interval:
        def on_interval(snap):
            sys.stdout.buffer.write(snap.to_json_bytes())
            sys.stdout.buffer.write(b"\n")
            sys.stdout.buffer.flush()

    try:
        result = run_sketch_pipeline(reads, cfg, on_interval=on_interval)
    except (PipelineError, ValueError) as e:
        _error_check(str(e))
        return

    mean_rl = int(result.length_total / result.seq_count)
    log.info("\tprocessed %d sequences in total", result.seq_count)
    log.info("\tmean sequence length: %d", mean_rl)
    log.info("\tfound %d minimizers", result.minimizer_count)
    log.info("\thistosketching across %d bins", spectrum_size)
    log.info("cleaning up...")
    if dist.rank() != 0:
        log.info("finished in %.6fs (output written by process 0)", time.time() - start)
        return
    with spans.span("job.write"):
        result.hulk_data.write_json(args.outFile + ".json")
        log.info("\twritten sketch to disk: %s", args.outFile + ".json")
        if args.stream:
            sys.stdout.buffer.write(result.hulk_data.to_json_bytes())
            sys.stdout.buffer.write(b"\n")
            sys.stdout.buffer.flush()
    log.info("finished in %.6fs", time.time() - start)


# ---- smash ----------------------------------------------------------------

def run_smash(args) -> None:
    import csv

    from hulk_tpu_torch.io.sketchio import (
        AVAIL_ALGORITHMS,
        SketchIOError,
        collect_jsons,
        load_hulk_data,
    )
    from hulk_tpu_torch.sketch.distances import AVAIL_METRICS

    _setup_log(args.log_file or None)
    log.info("this is hulk (version %s)", HULK_COMPAT_VERSION)
    log.info("starting the smash subcommand")
    if args.metric not in AVAIL_METRICS:
        _error_check(
            f"supplied distance metric is not available: {args.metric}\n"
            f"please select one of the following: {AVAIL_METRICS}"
        )
    if args.algorithm not in AVAIL_ALGORITHMS:
        _error_check(
            f"supplied algorithm not available: {args.algorithm}\n"
            f"please select one of the following: {AVAIL_ALGORITHMS}"
        )
    out_dir = os.path.dirname(args.outFile)
    if out_dir and out_dir != ".":
        os.makedirs(out_dir, mode=0o700, exist_ok=True)
    if not os.path.isdir(args.sketchDir):
        _error_check(f"directory does not exist: {args.sketchDir}")

    sketch_dir = args.sketchDir
    if not sketch_dir.endswith("/"):
        sketch_dir += "/"
    try:
        json_files = collect_jsons(sketch_dir, args.recursive)
    except SketchIOError as e:
        _error_check(str(e))
        return

    # several processes: shard the JSON loads round robin, allgather the
    # [n_i, s] mins+weights, compute each process's stripe of matrix rows on
    # its devices, allgather the rows; process 0 writes. Only the
    # weighted-Jaccard histosketch path (the reference smash default) is
    # split; every other combination loads everything in every process, and
    # process 0 alone writes
    if (
        dist.world_size() > 1
        and args.metric == "weightedjaccard"
        and args.algorithm == "histosketch"
        and not args.bannerMatrix
        and len(json_files) >= 2
    ):
        _run_smash_distributed(args, sorted(json_files))
        return
    try:
        sketches = {jf: load_hulk_data(jf) for jf in json_files}
    except SketchIOError as e:
        _error_check(str(e))
        return
    if len(sketches) < 2:
        _error_check(
            f"{len(sketches)} sketches found in the supplied directory, HULK needs at least 2 to smash!"
        )

    log.info("checking parameters and collecting sketches...")
    log.info("\talgorithm: %s", args.algorithm)
    log.info("\tk-mer size: %d", args.kmerSize)
    log.info("\tcreate matrix for banner: %s", str(args.bannerMatrix).lower())
    log.info("\tnumber of sketch objects: %d", len(sketches))
    log.info("HULK SMASH!")

    ordering = sorted(sketches.keys())
    matrix_path = args.outFile + ".hulk-matrix.csv"
    import torch

    if args.device.startswith("cuda") and len(ordering) > 64 and not torch.cuda.is_available():
        _error_check(f"device {args.device!r} requested but no CUDA device is available "
                     "(use --device cpu for the plain PyTorch versions)")
    try:
        with _profiling(args.profiling, args.device):
            # more than 64 sketches: the blocked matrix on the device, with
            # no fallback (a failure there ends the run); fewer keep the
            # host path, whose summation order is the reference's
            if len(ordering) > 64 and args.algorithm != "hyperminhash":
                matrix = _smash_matrix_device(sketches, ordering, args.metric,
                                              args.kmerSize, args.algorithm, args.device)
            else:
                matrix = [[sketches[f1].get_distance(sketches[f2], args.metric,
                                                     args.kmerSize, args.algorithm)
                           for f2 in ordering] for f1 in ordering]
    except SketchIOError as e:
        _error_check(str(e))
        return
    if dist.rank() != 0:
        log.info("finished")  # only process 0 writes output files
        return
    with open(matrix_path, "w", newline="") as fh:
        wr = csv.writer(fh, lineterminator="\n")
        wr.writerow(ordering)
        for row in matrix:
            wr.writerow([f"{100 - d * 100:.2f}" for d in row])
    log.info("\twritten similarity matrix to disk: %s", matrix_path)

    if args.bannerMatrix:
        banner_path = args.outFile + ".banner-matrix.csv"
        with open(banner_path, "w", newline="") as fh:
            wr = csv.writer(fh, lineterminator="\n")
            for f1 in ordering:
                try:
                    obj = sketches[f1].find_sketch(args.kmerSize, args.algorithm)
                except SketchIOError as e:
                    _error_check(str(e))
                    return
                row = [str(int(v)) for v in obj.get_sketch()]
                row.append(sketches[f1].banner)
                wr.writerow(row)
        log.info("\twritten banner matrix to disk: %s", banner_path)
    log.info("finished")


def _run_smash_distributed(args, ordering: list) -> None:
    """Weighted-Jaccard smash over several processes (see run_smash): this
    process loads its round-robin shard of `ordering`, the mins and weights
    are allgathered, each process computes its stripe of rows on its
    devices, the rows are allgathered, cells within wjd_recheck_margin of a
    %.2f boundary are recomputed with get_wjd from the gathered arrays (the
    reference's subject-weights semantics), and process 0 writes the CSV."""
    import csv

    import numpy as np

    from hulk_tpu_torch.io.sketchio import SketchIOError, _weights_of, load_hulk_data
    from hulk_tpu_torch.ops import distance
    from hulk_tpu_torch.parallel.smash import distributed_pairwise_wjd
    from hulk_tpu_torch.sketch.distances import get_wjd

    devices = _devices(args.device)
    my_files = dist.process_read_shard(ordering)
    local_mins, local_weights = [], []
    for jf in my_files:
        try:
            obj = load_hulk_data(jf).find_sketch(args.kmerSize, args.algorithm)
        except SketchIOError as e:
            _error_check(str(e))
            return
        local_mins.append(np.asarray(obj.get_sketch(), dtype=np.uint64))
        local_weights.append(np.asarray(_weights_of(obj), dtype=np.float64))
    log.info("\tprocess %d/%d: %d of %d sketches, on %s", dist.rank(), dist.world_size(),
             len(my_files), len(ordering), ", ".join(map(str, devices)))
    try:
        mins, weights, d = distributed_pairwise_wjd(local_mins, local_weights,
                                                    devices=devices)
    except ValueError as e:  # sketch lengths differ, seen alike by every process
        _error_check(str(e))
        return
    if mins.shape[0] != len(ordering):
        _error_check("sketch shard gather lost rows")
        return

    cells = 100.0 - d * 100.0
    frac = np.abs(cells * 100.0 - np.floor(cells * 100.0) - 0.5)
    risky = np.argwhere(frac < distance.wjd_recheck_margin(mins.shape[1]) * 10000.0)
    f64 = mins.astype(np.float64)  # the host path compares f64 casts
    for i, j in risky:
        d[i, j] = get_wjd(f64[i], f64[j], weights[i], weights[i])
    distance.recheck_stats["cells"] += len(risky)
    if len(risky):
        log.info("\trechecked %d boundary cells on the host", len(risky))

    if dist.rank() == 0:
        matrix_path = args.outFile + ".hulk-matrix.csv"
        with open(matrix_path, "w", newline="") as fh:
            wr = csv.writer(fh, lineterminator="\n")
            wr.writerow(ordering)
            for row in d:
                wr.writerow([f"{100 - v * 100:.2f}" for v in row])
        log.info("\twritten similarity matrix to disk: %s", matrix_path)
    log.info("finished")


def _devices(device: str) -> list:
    """The devices this process computes on: every visible card for
    `cuda`, else the one device named. `cuda` with no card is an error."""
    import torch

    from hulk_tpu_torch.parallel.mesh import make_sketch_mesh

    if device.startswith("cuda") and not torch.cuda.is_available():
        _error_check(f"device {device!r} requested but no CUDA device is available "
                     "(use --device cpu for the plain PyTorch versions)")
    return make_sketch_mesh() if device == "cuda" else [torch.device(device)]


def _smash_matrix_device(sketches, ordering, metric, ksize, algo, device):
    """[N, N] distance matrix through the blocked device matrix
    (ops/distance.py), equal to the host path's get_distance cell for cell.

    Both metrics compare the mins after the host's f64 cast. jaccard's
    match counts are exact integers, and 1 - count/s is the host's own
    arithmetic. weightedjaccard's cells within wjd_recheck_margin of a
    %.2f rounding boundary are recomputed by the host path, so the CSV is
    the host path's whatever order the device summed in."""
    import numpy as np

    from hulk_tpu_torch.io.sketchio import SketchIOError, _weights_of
    from hulk_tpu_torch.ops import distance

    objs = [sketches[f].find_sketch(ksize, algo) for f in ordering]
    sizes = [len(o.get_sketch()) for o in objs]
    for n in sizes:
        if n != sizes[0]:  # the host path's first failing cell, (0, j)
            raise SketchIOError(f"sketch length mismatch: {sizes[0]} vs {n}")
    mins = np.stack([np.asarray(o.get_sketch(), dtype=np.uint64) for o in objs])
    if metric != "weightedjaccard":
        return 1.0 - distance.pairwise_jaccard_sim(mins, device=device)
    weights = [_weights_of(o) for o in objs]
    if any(wt is None for wt in weights):
        raise SketchIOError("weighted jaccard is only supported for histosketches")
    d = distance.pairwise_weighted_jaccard_dist(mins, np.stack(weights), device=device)
    cells = 100.0 - d * 100.0
    frac = np.abs(cells * 100.0 - np.floor(cells * 100.0) - 0.5)
    risky = np.argwhere(frac < distance.wjd_recheck_margin(mins.shape[1]) * 10000.0)
    for i, j in risky:
        d[i, j] = sketches[ordering[i]].get_distance(sketches[ordering[j]], metric, ksize, algo)
    distance.recheck_stats["cells"] += len(risky)
    if len(risky):
        log.info("\trechecked %d boundary cells on the host", len(risky))
    return d


# ---- print / distance (v0.0.2 surface reconstructions) ---------------------
# hulk_tpu's `print` row format is the banner matrix's (sketch ints, then the
# file path as the label); `distance` prints one distance to six places.

def run_print(args) -> None:
    from hulk_tpu_torch.io.sketchio import SketchIOError, load_hulk_data

    _setup_log(args.log_file or None)
    for f in args.file:
        try:
            obj = load_hulk_data(f).find_sketch(args.kmerSize, args.algorithm)
        except SketchIOError as e:
            _error_check(str(e))
            return
        row = ",".join(str(int(v)) for v in obj.get_sketch())
        sys.stdout.write(f"{row},{f}\n")


def run_distance(args) -> None:
    from hulk_tpu_torch.io.sketchio import SketchIOError, load_hulk_data

    _setup_log(args.log_file or None)
    if len(args.file) != 2:
        _error_check("distance needs exactly two sketch files (-f A -f B)")
    try:
        a = load_hulk_data(args.file[0])
        b = load_hulk_data(args.file[1])
        d = a.get_distance(b, args.metric, args.kmerSize, args.algorithm)
    except SketchIOError as e:
        _error_check(str(e))
        return
    print(f"{d:.6f}")


# ---- index ----------------------------------------------------------------

def run_index(args) -> None:
    from hulk_tpu_torch.index.lshforest import LSHForest, LSHIndexError
    from hulk_tpu_torch.io.sketchio import SketchIOError, collect_jsons, load_hulk_data

    _setup_log(args.log_file or None)
    log.info("this is hulk (version %s)", HULK_COMPAT_VERSION)
    log.info("starting the index subcommand")
    if args.run not in ("create", "add", "search"):
        _error_check(f"unknown index operation: {args.run} (use create/add/search)")

    sketch_dir = args.sketchDir
    if not sketch_dir.endswith("/"):
        sketch_dir += "/"

    def load_mins():
        out = []
        for jf in collect_jsons(sketch_dir, args.recursive):
            # the index itself may live in the sketch directory; it is never
            # a query/input sketch
            if os.path.abspath(jf) == os.path.abspath(args.indexName):
                continue
            data = load_hulk_data(jf)
            obj = data.find_sketch(args.kmerSize, "histosketch")
            out.append((jf, obj.get_sketch()))
        return out

    def check_size(got: int, what: str) -> None:
        if got != args.sketchSize:
            _error_check(
                f"sketch size mismatch: {what} has {got} values but the index "
                f"holds sketches of size {args.sketchSize} (pass -s {got})"
            )

    import numpy as np

    try:
        if args.run in ("create", "add"):
            entries = load_mins()
            if not entries:
                _error_check(
                    f"no sketches found in the supplied directory: {sketch_dir}"
                )
            check_size(len(entries[0][1]), entries[0][0])
            if args.run == "create":
                forest = LSHForest(
                    kmer_size=args.kmerSize,
                    sketch_size=args.sketchSize,
                    jaccard_thresh=args.jsThresh,
                )
            else:
                forest = LSHForest.load_json(args.indexName)
                check_size(forest.sketch_size, f"index {args.indexName}")
            forest.add_batch(
                [name for name, _ in entries],
                np.stack([m for _, m in entries]),
            )
            forest.write_json(args.indexName)
            log.info(
                "\tindexed %d sketches (bands=%d rows=%d) -> %s",
                len(forest.names), forest.n_bands, forest.band_rows, args.indexName,
            )
        else:  # search
            forest = LSHForest.load_json(args.indexName)
            check_size(forest.sketch_size, f"index {args.indexName}")
            queries = load_mins()
            if not queries:
                _error_check(
                    f"no query sketches found in the supplied directory: {sketch_dir}"
                )
            for name, mins in queries:
                check_size(len(mins), name)
            devices = _devices(args.device)
            if len(devices) > 1:
                # index rows striped over the devices: each ranks its own 1/D
                # of the corpus where the candidates are dense
                # (parallel/lsh.py)
                from hulk_tpu_torch.parallel.lsh import sharded_lsh_search

                log.info("\tsearch: index sharded over %d devices", len(devices))
                qmat = np.stack([m for _, m in queries]).astype(np.uint64)
                all_hits = sharded_lsh_search(devices, forest, qmat, args.jsThresh)
            else:
                log.info("\tsearch: on the host (one device, %s)", devices[0])
                all_hits = [
                    forest.search(mins, args.jsThresh) for _, mins in queries
                ]
            for (name, _), hits in zip(queries, all_hits):
                if not hits:
                    log.info("\tquery %s: no matches >= %.2f", name, args.jsThresh)
                for hit, sim in hits:
                    print(f"{name},{hit},{sim:.4f}")
            log.info("\tsearched %d queries against %d entries", len(queries),
                     len(forest.names))
    except (LSHIndexError, SketchIOError) as e:
        _error_check(str(e))
        return
    log.info("finished")


def main(argv=None) -> int:
    dist.init_distributed()
    try:
        args = build_parser().parse_args(argv)
        if args.subcommand == "sketch":
            run_sketch(args)
        elif args.subcommand == "smash":
            run_smash(args)
        elif args.subcommand == "index":
            run_index(args)
        elif args.subcommand == "print":
            run_print(args)
        elif args.subcommand == "distance":
            run_distance(args)
        elif args.subcommand == "version":
            print(HULK_COMPAT_VERSION)
        else:
            build_parser().print_help()
            return 1
        return 0
    finally:
        dist.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
