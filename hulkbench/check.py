"""The comparison that decides `correct`: every document a timed job wrote
against the reference's.

A job writes out.json, and with --stream one document a flush on stdout and
the final one after them. Each histosketch is held to the reference's
(mins, weights) after the same flush, exactly: the weights bit for bit.
"""
from __future__ import annotations

import json

import numpy as np

LIMITS = {"docs_wrong": 0, "mins_mismatched": 0, "weights_mismatched": 0}


def documents(text: str) -> list:
    """The JSON documents written one after another in text."""
    dec, out, pos = json.JSONDecoder(), [], 0
    while True:
        pos = text.find("{", pos)
        if pos < 0:
            return out
        try:
            doc, pos = dec.raw_decode(text, pos)
        except json.JSONDecodeError:
            return out
        out.append(doc)


def histosketch(doc) -> tuple[list, list] | None:
    try:
        for sig in doc["signatures"]:
            if sig["Algorithm"] == "histosketch":
                return sig["Sketch"]["mins"], sig["Sketch"]["weights"]
    except (KeyError, TypeError):
        return None
    return None


def job_documents(out: str, stream: bool) -> list:
    """What a job wrote: out.json's document, then (stream) stdout's."""
    docs = []
    for path in [out + ".json"] + ([out + ".stdout"] if stream else []):
        try:
            with open(path) as fh:
                docs.extend(documents(fh.read()))
        except OSError:
            pass
    return docs


def expected_documents(flushes: list, stream: bool) -> list:
    """The (mins, weights) each job's documents must hold, in order:
    out.json's (the last flush's), then with --stream every flush's and the
    last again."""
    return [flushes[-1]] + (list(flushes) + [flushes[-1]] if stream else [])


def compare(got: list, want: list) -> dict:
    """Counts of one job's documents missing, unreadable or extra, and of
    slots whose bin or whose weight differs from the reference's."""
    n = {"docs_wrong": max(0, len(got) - len(want)), "mins_mismatched": 0,
         "weights_mismatched": 0}
    for i, (mins, weights) in enumerate(want):
        sk = histosketch(got[i]) if i < len(got) else None
        if sk is None:
            n["docs_wrong"] += 1
            continue
        gm, gw = sk
        s = len(mins)
        if len(gm) != s or len(gw) != s:
            n["mins_mismatched"] += s
            n["weights_mismatched"] += s
            continue
        n["mins_mismatched"] += int((np.array(gm, dtype=np.uint64) != mins).sum())
        gw = np.array(gw, dtype=np.float64).view(np.int64)
        n["weights_mismatched"] += int((gw != np.asarray(weights, dtype=np.float64).view(np.int64)).sum())
    return n


def judge(jobs: list, want: list) -> tuple[dict, int]:
    """Sum compare() over the jobs' documents (a failed job counts every
    document wrong): ({name: {"value", "limit"}}, jobs that failed)."""
    total = dict.fromkeys(LIMITS, 0)
    failed = 0
    for docs in jobs:
        n = compare(docs, want)
        failed += any(n.values())
        for k, v in n.items():
            total[k] += v
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in total.items()}, failed
