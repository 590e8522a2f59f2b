"""Sharded LSH-Forest similarity search (BASELINE config 5).

Counterpart of hulk_tpu/parallel/lsh.py, in plain PyTorch (hulk_tpu's
ranking is plain XLA, no Pallas kernel). The index's [N, s] sketch matrix
is cut row-wise into one contiguous stripe per device of the mesh (a list
of torch.devices, parallel/mesh.make_sketch_mesh); the [Q, s] query block
is copied to every device, and each device ranks its stripe with positional
match counts. The [Q, N] counts come back to the host in the global index
order, so the host applies the LSH candidate mask and threshold. Several
processes: each searches the stripe it indexed, and one allgather of the
[Q, K] best hits merges them (multiprocess_lsh_search).

Banding stays on the host in NumPy's wrapping u64 arithmetic
(index/lshforest.py); the device only compares int64 bit patterns for
equality, which is the same test as comparing the u64 values.
"""
from __future__ import annotations

import numpy as np
import torch

_CHUNK = 4096  # index rows ranked per step
_QUERY_BLOCK = 4096  # queries ranked per step: the int32 count stays at 64 MB

# Searches whose candidate similarities were read out of the device
# ranking (the dense-candidate branch of sharded_lsh_search), for tests and
# measurement.
search_stats = {"device_ranked": 0}


def shard_index_mins(devices: list, mins: np.ndarray):
    """[N, s] index rows -> (one int64 stripe a device, N). N pads to
    D*_CHUNK so every stripe is a whole number of ranking chunks and the
    global row order is kept (padding sits only at the global tail)."""
    n_dp = len(devices)
    n = mins.shape[0]
    pad = (-n) % (n_dp * _CHUNK)
    padded = np.vstack([mins, np.zeros((pad, mins.shape[1]), dtype=mins.dtype)])
    padded = padded.astype(np.int64)
    per = padded.shape[0] // n_dp
    return [torch.from_numpy(padded[d * per:(d + 1) * per]).to(dev)
            for d, dev in enumerate(devices)], n


def rank_stripe(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[Q, s] x [n, s] int64 on one device -> [Q, n] uint16 positional match
    counts (s <= 65535, so a count fits). Step by step over blocks of
    _QUERY_BLOCK queries and _CHUNK rows, an int32 count gains one compare a
    slot: slot-major copies of both sides make each compare read contiguous
    columns, and the in-place add reads the bool compare with no cast pass
    (a [Q, C, s] compare summed over s casts all of it to int32 first, and
    took twice as long on the card: scripts/lsh_rank_variants.py)."""
    nq, s = queries.shape
    out = torch.empty((nq, rows.shape[0]), dtype=torch.uint16, device=rows.device)
    acc = torch.empty((min(nq, _QUERY_BLOCK), _CHUNK), dtype=torch.int32, device=rows.device)
    for q0 in range(0, nq, _QUERY_BLOCK):
        qt = queries[q0:q0 + _QUERY_BLOCK].T.contiguous()
        for c0 in range(0, rows.shape[0], _CHUNK):
            rt = rows[c0:c0 + _CHUNK].T.contiguous()
            a = acc[:qt.shape[1], :rt.shape[1]]
            a.zero_()
            for k in range(s):
                a.add_(qt[k][:, None] == rt[k][None, :])
            out[q0:q0 + qt.shape[1], c0:c0 + rt.shape[1]] = a
    return out


def sharded_similarity(devices: list):
    """-> rank(queries [Q, s] int64, stripes) -> [Q, N padded] uint16 counts
    on the host: the queries copied to every device, every stripe ranked
    (all devices launched before the first result is copied back), the
    stripes' counts joined in global row order. The [Q, N] result crosses
    to the host as u16: 200 MB at 100k x 1k, not the 1.6 GB of f64; the host
    does the one f64 divide."""
    def rank(queries: np.ndarray, stripes: list) -> np.ndarray:
        q = torch.from_numpy(np.ascontiguousarray(queries.astype(np.int64, copy=False)))
        outs = [rank_stripe(q.to(dev), st) for dev, st in zip(devices, stripes)]
        return np.concatenate([o.cpu().numpy() for o in outs], axis=1)

    return rank


def _candidate_sims(forest, query_mins: np.ndarray, cands=None):
    """LSH candidates per query + their exact positional similarities.

    The LSH tables already narrow each query to a handful of candidates, so
    similarity is computed ONLY at candidate positions (vectorised over the
    flattened (query, candidate) pair list) — same f64 value the device
    ranking produces (integer match count / s), without materialising or
    transferring a [Q, N] matrix. Returns (cands list, sims list)."""
    mins = forest.mins_matrix
    if cands is None:
        cands = [forest.candidates(query_mins[qi]) for qi in range(query_mins.shape[0])]
    qi_flat = np.repeat(np.arange(len(cands)), [c.size for c in cands])
    c_flat = np.concatenate(cands) if cands else np.empty(0, dtype=np.int64)
    if c_flat.size == 0:
        return cands, [np.empty(0)] * len(cands)
    counts = (
        query_mins[qi_flat].astype(np.uint64) == mins[c_flat.astype(np.intp)]
    ).sum(axis=1)
    sims_flat = counts.astype(np.float64) / query_mins.shape[-1]
    splits = np.cumsum([c.size for c in cands])[:-1]
    return cands, np.split(sims_flat, splits)


# Candidate-set density above which the device ranking of the whole [Q, N]
# replaces the host's scoring of each candidate: at this density the host
# pass costs about Q*N*s either way (hulk_tpu's constant).
_DEVICE_RANK_DENSITY = 0.25


def sharded_lsh_search(devices, forest, query_mins: np.ndarray, thresh: float | None = None):
    """Full LSH search: host candidate filter + exact candidate-only
    similarity (see _candidate_sims). When the candidate sets are a large
    fraction of the corpus (low thresholds make banding unselective), the
    per-candidate host scoring degenerates to an O(Q*N*s) host pass — the
    `devices` then rank the whole corpus (sharded_sims) and the candidate
    similarities are read out of the [Q, N] matrix instead. Both paths
    produce the identical f64 value (integer match count / s), so results
    do not depend on which engaged. devices=None keeps the host path."""
    t = forest.jaccard_thresh if thresh is None else thresh
    mins = forest.mins_matrix
    n = mins.shape[0]
    cands = [forest.candidates(query_mins[qi]) for qi in range(query_mins.shape[0])]
    total_cand = sum(c.size for c in cands)
    if (
        devices is not None
        and n > 0
        and query_mins.shape[0] > 0
        and total_cand >= _DEVICE_RANK_DENSITY * query_mins.shape[0] * n
    ):
        sims_full, _ = sharded_sims(devices, forest, query_mins)
        csims = [sims_full[qi, c.astype(np.intp)] for qi, c in enumerate(cands)]
        search_stats["device_ranked"] += 1
    else:
        cands, csims = _candidate_sims(forest, query_mins, cands)
    out = []
    for qi in range(query_mins.shape[0]):
        cand, s = cands[qi], csims[qi]
        keep = s >= t
        order = np.argsort(-s[keep])
        kept = cand[keep][order]
        out.append([(forest.names[i], float(v)) for i, v in zip(kept, s[keep][order])])
    return out


def sharded_sims(devices, forest, query_mins: np.ndarray):
    """Device-ranked [Q, N] similarity matrix for a forest's corpus (the
    brute-force reference the LSH filter narrows); returns (sims, N)."""
    stripes, n = shard_index_mins(devices, forest.mins_matrix)
    counts = sharded_similarity(devices)(query_mins.astype(np.int64), stripes)[:, :n]
    return counts.astype(np.float64) / query_mins.shape[-1], n


def multiprocess_lsh_search(forest, query_mins: np.ndarray,
                            local_ids: np.ndarray, thresh: float | None = None,
                            topk: int = 64):
    """Cross-process sharded search (BASELINE config 5 at scale): every
    process owns the corpus stripe it indexed (its `forest`, with
    `local_ids` giving each local row's global id), filters its stripe with
    its LSH tables, computes exact candidate-only similarities, and keeps
    its top-K per query. One small allgather of the fixed [Q, K] (id, sim)
    blocks then merges identically on every process — the only
    cross-process traffic, ~Q*K*16 bytes per process regardless of corpus
    size.

    Exactness: banding is per-row, so the union of per-stripe candidate
    sets IS the whole-corpus candidate set, and the merged result equals
    the single-process search wherever K bounds nothing. Returns
    [(global_id, sim), ...] per query, sorted by similarity (ties by id)."""
    from hulk_tpu_torch.parallel import distributed as dist

    t = forest.jaccard_thresh if thresh is None else thresh
    Q = query_mins.shape[0]
    cands, csims = _candidate_sims(forest, query_mins)
    ids_out = np.full((Q, topk), -1, dtype=np.int64)
    sims_out = np.zeros((Q, topk), dtype=np.float64)
    for qi in range(Q):
        cand, s = cands[qi], csims[qi]
        if not cand.size:
            continue
        keep = s >= t
        sel, sv = cand[keep], s[keep]
        order = np.lexsort((local_ids[sel], -sv))[:topk]
        ids_out[qi, : order.size] = local_ids[sel][order]
        sims_out[qi, : order.size] = sv[order]
    # one allgather: the sims travel as their f64 bit patterns beside the ids
    both = dist.allgather(np.stack([ids_out, sims_out.view(np.int64)]))
    gid, gsim = both[:, 0], both[:, 1].view(np.float64)
    out = []
    for qi in range(Q):
        ids = gid[:, qi, :].reshape(-1)
        sv = gsim[:, qi, :].reshape(-1)
        live = ids >= 0
        ids, sv = ids[live], sv[live]
        order = np.lexsort((ids, -sv))
        out.append([(int(i), float(v)) for i, v in zip(ids[order], sv[order])])
    return out
