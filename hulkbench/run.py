"""One run of one benchmark cell of hulk_tpu_torch, from the checkout's root:

    python3 -m hulkbench --workload reads-k21.samples --seed 7 --seconds 40 --trace 0

The cell (BENCHMARK.json `workloads`) names a configuration
(hulkbench/configs/<config>.json: sketch sizes, guarantee, the input
generator hulkbench/inputs/<generator>.py and its parameters) and a traffic
mix (hulkbench/traffic/<traffic>.json: which generated files a job
sketches, its interval, decay and --stream). A run

  1. makes the inputs from --seed under TMPDIR and warms up with one job
     on the cell's own shapes (set-up: everything up to here, setup_s);
  2. runs jobs back to back, one client in a closed loop, each a call of
     the user's entry hulk_tpu_torch.cli.main(["sketch", ...]) in this
     process, until --seconds have passed; the job in flight then runs to
     its end and counts;
  3. with --trace 1, does the same under torch.profiler, and reads the
     per-layer metrics (hulkbench/metrics/<layer>/<name>.py);
  4. works out with the plain reference (hulkbench/reference) what every
     job must have written, compares (hulkbench/check.py), and prints the
     numbers compared beside their limits on stderr, then one JSON line on
     stdout.

It exits non-zero and prints no result when there is no CUDA card (or
fewer than the cell asks for), or when jax, jaxlib, flax or hulk_tpu (the
JAX package) are loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "hulk_tpu")


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    mix and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next((c for c in bench["workloads"] if c["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "chips": cell["chips"], "config": config, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def set_run_env(processors: int = 1) -> None:
    """Every cache of the program inside the checkout, at fixed paths; no
    process group from the environment; OpenMP held to the configuration's
    processors (-p) in every thread. The program applies -p to the OpenMP
    passes of the thread that parses the flags only, so without this the
    parse thread and the flush worker take every core of the host."""
    os.environ["OMP_NUM_THREADS"] = str(processors)
    os.environ["HULK_TPU_TORCH_CACHE"] = os.path.join(CACHE, "program")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    for var in list(os.environ):
        if var.startswith("HULK_") and var != "HULK_TPU_TORCH_CACHE" or var in (
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
            del os.environ[var]


@dataclass
class Job:
    out: str
    t0: float
    t1: float
    bases: int
    cpu: float  # this process's CPU seconds in the job
    error: str | None = None


@dataclass
class Context:
    """What a per-layer reader may read."""

    config: dict
    job_paths: list  # the files one job sketches, in order
    jobs: list = field(default_factory=list)  # the window's jobs
    window_s: float = 0.0  # host seconds from the window's start to its last job's end
    trace: dict | None = None  # hulkbench.trace.read_chrome's
    work: dict = field(default_factory=dict)  # one job's work, from the reference


def job_argv(config: dict, traffic: dict, paths: list, out: str, device: str) -> list:
    argv = ["sketch"]
    for p in paths:
        argv += ["-f", p]
    argv += ["-k", str(config["kmer_size"]), "-w", str(config["window_size"]),
             "-s", str(config["sketch_size"]), "-p", str(config["processors"]),
             "-o", out, "--log", out + ".log", "--device", device]
    if config["fasta"]:
        argv.append("--fasta")
    if traffic["interval"]:
        argv += ["-i", str(traffic["interval"])]
    if traffic["decay_ratio"] != 1.0:
        argv += ["-x", repr(traffic["decay_ratio"])]
    if traffic["stream"]:
        argv.append("--stream")
    return argv


def run_job(argv: list, out: str, bases: int) -> Job:
    """One call of the CLI's main, its stdout to out.stdout; log handlers
    closed after it, as a process's exit would."""
    from hulk_tpu_torch import cli

    logger = logging.getLogger("hulk")
    err = None
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    with open(out + ".stdout", "w") as fh:
        saved, sys.stdout = sys.stdout, fh
        try:
            rc = cli.main(argv)
            if rc:
                err = f"exit code {rc}"
        except SystemExit as e:
            if e.code:
                err = f"exit code {e.code}"
        except Exception:  # noqa: BLE001 -- a failed job is judged, not fatal
            err = traceback.format_exc()
        finally:
            sys.stdout = saved
            for h in list(logger.handlers):
                h.close()
                logger.removeHandler(h)
    return Job(out=out, t0=t0, t1=time.perf_counter(), bases=bases,
               cpu=time.process_time() - cpu0, error=err)


def reference(config: dict, traffic: dict, inputs: dict, device: str) -> tuple[list, dict]:
    """The spectrum at each flush of a job, and one job's work."""
    import torch

    from hulkbench.reference import sketch

    k, w, nbins = config["kmer_size"], config["window_size"], config["bins"]
    files = {n: sketch.FileBins(*inputs["reads"][n], k=k, w=w, nbins=nbins, device=device)
             for n in dict.fromkeys(traffic["inputs"])}
    job = [files[n] for n in traffic["inputs"]]
    hists = sketch.job_histograms(job, traffic["interval"], nbins)
    work = {"bases": sum(f.bases for f in job), "keys": sum(f.keys for f in job),
            "iterations": sum(f.iterations for f in job), "flushes": len(hists)}
    del files, job
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return hists, work


def flushes(config: dict, traffic: dict, hists: list, dtype=None) -> list:
    """(mins, weights) after each flush of those spectra: float64, or the
    control's float32."""
    import numpy as np

    from hulkbench.reference import cws, sketch

    s, nbins = config["sketch_size"], config["bins"]
    return sketch.HistoSketch(s, nbins, traffic["decay_ratio"], cws.tables(s, nbins),
                              dtype or np.float64).run(hists)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             workdir: str | None = None) -> dict:
    """Set-up, window, check and metrics of one run; the result's fields."""
    import torch

    from hulkbench import check
    from hulkbench.trace import breakdown, busy_seconds, read_chrome

    config, traffic = cell["config"], cell["traffic"]
    rundir = tempfile.mkdtemp(prefix="hulkbench-", dir=workdir)
    try:
        gen = importlib.import_module(f"hulkbench.inputs.{config['generator']}")
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.zeros(1, device=device)  # the CUDA context
        t_gen = time.perf_counter()
        inputs = gen.generate(config["input"], seed, rundir)
        os.sync()  # the inputs on disk before the window, not written back during it
        t_warm = time.perf_counter()

        def argv_for(names, out):
            return job_argv(config, traffic, [inputs["files"][n] for n in names], out, device)

        warm = traffic.get("warmup_inputs", traffic["inputs"])
        job = run_job(argv_for(warm, os.path.join(rundir, "warmup")),
                      os.path.join(rundir, "warmup"), 0)
        if job.error:
            raise RuntimeError(f"the warm-up job failed: {job.error}")
        if cuda:
            torch.cuda.synchronize()
        bases = sum(inputs["bases"][n] for n in traffic["inputs"])
        ctx = Context(config=config,
                      job_paths=[inputs["files"][n] for n in traffic["inputs"]])
        readers = {m["name"]: importlib.import_module(f"hulkbench.metrics.{m['name']}")
                   for m in cell["per_layer"]} if trace else {}
        for r in readers.values():
            if hasattr(r, "start"):
                r.start(ctx)

        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        setup_s = time.perf_counter() - T_START
        cpu_open = time.process_time()
        t_open = time.perf_counter()
        with (record_function("hulkbench.window") if trace else contextlib.nullcontext()):
            while True:
                out = os.path.join(rundir, f"job{len(ctx.jobs)}")
                job = run_job(argv_for(traffic["inputs"], out), out, bases)
                ctx.jobs.append(job)
                if job.error or time.perf_counter() - t_open >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
        t_close = time.perf_counter()
        cpu_window = time.process_time() - cpu_open
        if prof is not None:
            prof.stop()
        ctx.window_s = t_close - t_open
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        errors = [j.error for j in ctx.jobs if j.error]
        if prof is not None:
            path = os.path.join(rundir, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            ctx.trace = read_chrome(path)
            os.remove(path)

        t_ref = time.perf_counter()
        hists, ctx.work = reference(config, traffic, inputs, device)
        want = check.expected_documents(flushes(config, traffic, hists), traffic["stream"])
        checks, failed = check.judge(
            [check.job_documents(j.out, traffic["stream"]) for j in ctx.jobs], want)

        print(f"set-up: {setup_s:.3f} s, of which imports and the CUDA context {t_gen - T_START:.3f}, "
              f"inputs {t_warm - t_gen:.3f}, warm-up job {t_open - t_warm:.3f}; jobs "
              f"{[round(j.t1 - j.t0, 3) for j in ctx.jobs]} s, CPU a job "
              f"{[round(j.cpu, 3) for j in ctx.jobs]} s; process CPU {cpu_window:.3f} s in the "
              f"window's {ctx.window_s:.3f}; check {time.perf_counter() - t_ref:.3f} s",
              file=sys.stderr)
        metrics = {}
        if trace:
            for m in cell["per_layer"]:
                v = readers[m["name"]].read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = {"setup_s": setup_s,
                      "sketch_Mbp_per_s": sum(j.bases for j in ctx.jobs) / ctx.window_s / 1e6}
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        result = {
            "correct": failed == 0 and not errors and all(
                c["value"] <= c["limit"] for c in checks.values()),
            "attempted": len(ctx.jobs),
            "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                       "count": cell["chips"], "memory_peak_bytes": peak},
        }
        if ctx.trace and ctx.trace["window"]:
            t0, t1 = ctx.trace["window"]
            result["device"].update(busy_s=busy_seconds(ctx.trace), window_s=t1 - t0)
            result["breakdown"] = breakdown(ctx.trace)
        result["errors"] = [e[-2000:] for e in errors]
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hulkbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    set_run_env(cell["config"]["processors"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"hulkbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        importlib.import_module("hulk_tpu_torch")
    except ImportError as e:
        print(f"hulkbench: the program is not here ({e})", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"hulkbench: the JAX side was loaded in this process: {found}", file=sys.stderr)
        return 3
    for e in result["errors"]:
        print(f"job error:\n{e}", file=sys.stderr)
    del result["errors"]
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
