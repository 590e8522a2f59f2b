"""The control of `correct`: the reference with its weighted sampling in
float32 (the step below the float64 the histosketch states: NumPy's exp
and log and every comparison in float32, the CMS as in float64), put in
the program's place and judged as a run's jobs are. It has to come out as
not correct. Not part of a benchmark run; on the chip, at a cell's own
size, from the checkout's root:

    python3 -m hulkbench.control --workload reads-k21.samples --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile


def as_document(mins, weights) -> dict:
    """A sketch document as the program writes it, histosketch only."""
    return {"signatures": [{"Algorithm": "histosketch",
                            "Sketch": {"mins": [int(m) for m in mins],
                                       "weights": [float(x) for x in weights]}}]}


def readings(cell: dict, seed: int, device: str, workdir: str | None = None) -> dict:
    """The numbers compared, with the control's documents in place of a
    job's."""
    import importlib

    import numpy as np

    from hulkbench import check
    from hulkbench.run import flushes, reference

    config, traffic = cell["config"], cell["traffic"]
    rundir = tempfile.mkdtemp(prefix="hulkbench-control-", dir=workdir)
    try:
        gen = importlib.import_module(f"hulkbench.inputs.{config['generator']}")
        inputs = gen.generate(config["input"], seed, rundir)
        hists, _ = reference(config, traffic, inputs, device)
        stream = traffic["stream"]
        want = check.expected_documents(flushes(config, traffic, hists), stream)
        low = check.expected_documents(flushes(config, traffic, hists, np.float32), stream)
        checks, _ = check.judge([[as_document(*d) for d in low]], want)
        return checks
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


def main(argv=None) -> int:
    from hulkbench.run import load_cell, set_run_env

    p = argparse.ArgumentParser(prog="hulkbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    set_run_env(cell["config"]["processors"])
    for seed in args.seeds:
        checks = readings(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "float32",
                          "correct": all(c["value"] <= c["limit"] for c in checks.values()),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
