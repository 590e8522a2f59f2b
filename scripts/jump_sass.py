#!/usr/bin/env python3
"""Count the instructions of one iteration of the jump-hash loop in SASS.

    python3 scripts/jump_sass.py [--csrc DIR] [--listing FILE]

Compiles DIR/jump_hash.cu (default: this tree's hulk_tpu_torch/csrc) to a
cubin with the library's nvcc flags, disassembles it (cuobjdump -sass) and,
for each instantiation of jump_kernel, walks the hot path of its loop: from
the target of the loop's back edge (the shortest backward branch whose body
holds a MUFU.RCP64H) to that branch, as a lane that carries on and takes no
rare branch runs it. A forward branch is taken on the hot path when the
code it skips loads a key (LDG: a lane's next key), calls (CALL: the slow
path of the correctly rounded reciprocal), stores or adds atomically (an
exit); a branch past the back edge leaves the loop and is not taken. Prints the
FP64, MUFU and other instructions of that path for each instantiation and,
with --listing, writes the path's instructions. Needs nvcc and cuobjdump
(the card's machine); the last line is one JSON object of the counts.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

MODES = {"0": "buckets", "1": "dedup_keys", "2": "values", "3": "dedup_values"}
RARE = ("LDG", "CALL", "STG", "ATOM", "RED")
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass(csrc: str) -> str:
    from hulk_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "jump_hash.cubin")
        flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v", "-Xcompiler", "-fPIC")]
        subprocess.run([_nvcc(), *flags, "-cubin", "-o", cubin,
                        os.path.join(csrc, "jump_hash.cu")], check=True)
        return subprocess.run(["cuobjdump", "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout


def functions(text: str) -> dict[str, list[tuple[int, str]]]:
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "jump_kernel" not in name:
            continue
        mode = MODES[re.search(r"ModeE(\d)", name).group(1)]
        if re.search(r"ELb1E", name):
            mode += "_counting"
        out[mode] = [(int(m.group(1), 16), m.group(2)) for m in LINE.finditer(chunk)]
    return out


def branch(ins: str) -> tuple[bool, int] | None:
    """(conditional, target) of a BRA, else None."""
    m = re.match(r"(@!?U?P\w+\s+)?BRA\s+0x([0-9a-f]+)", ins)
    if not m:
        return None
    return m.group(1) is not None, int(m.group(2), 16)


def opclass(ins: str) -> str:
    op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
    if op.startswith("MUFU"):
        return "mufu"
    if op.split(".")[0] in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX") or ".F64" in op:
        return "fp64"
    return "other"


def hot_path(code: list[tuple[int, str]]) -> list[tuple[int, str]]:
    at = {a: i for i, (a, _) in enumerate(code)}
    mufu = [a for a, ins in code if "MUFU.RCP64H" in ins]
    backs = [(a, b[1]) for a, ins in code if (b := branch(ins)) and b[1] < a
             and any(b[1] <= m < a for m in mufu)]
    if not backs:
        raise SystemExit("no loop back edge found")
    back, head = min(backs, key=lambda e: e[0] - e[1])
    path, i = [], at[head]
    while True:
        a, ins = code[i]
        path.append((a, ins))
        if a == back:
            return path
        b = branch(ins)
        if b is None:
            i += 1
            continue
        cond, target = b
        if not cond:
            i = at[target]
        elif target > back or target < a:
            i += 1
        else:
            rare = any(r in ins2 for _, ins2 in code[i + 1:at[target]] for r in RARE)
            i = at[target] if rare else i + 1
        if len(path) > 10_000:
            raise SystemExit("hot path walk did not reach the back edge")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=os.path.join(HERE, "hulk_tpu_torch", "csrc"))
    ap.add_argument("--listing", help="write each hot path's instructions here")
    args = ap.parse_args()
    counts, listing = {}, []
    for mode, code in sorted(functions(sass(args.csrc)).items()):
        path = hot_path(code)
        c = {"fp64": 0, "mufu": 0, "other": 0}
        for _, ins in path:
            c[opclass(ins)] += 1
        c["total"] = len(path)
        counts[mode] = c
        print(f"jump_kernel<{mode}>: one iteration's hot path: {c['fp64']} FP64, "
              f"{c['mufu']} MUFU, {c['other']} other, {c['total']} instructions", flush=True)
        listing.append(f"== jump_kernel<{mode}>")
        listing += [f"{a:04x} {opclass(ins):5s} {ins}" for a, ins in path]
    if args.listing:
        with open(args.listing, "w") as fh:
            fh.write("\n".join(listing) + "\n")
    print(json.dumps({"csrc": os.path.relpath(args.csrc, HERE), "hot_path": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
