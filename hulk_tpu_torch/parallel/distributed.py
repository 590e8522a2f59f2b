"""Runs of several processes, on torch.distributed.

Counterpart of hulk_tpu/parallel/distributed.py, which starts
jax.distributed. Here the processes form one gloo group: every collective
of the port moves host arrays (LSH hit blocks, sketch rows, distance rows),
and two processes that share one card cannot form an NCCL group, which
refuses a duplicate GPU. Each process computes on the devices visible to it;
a launcher gives processes their own cards with CUDA_VISIBLE_DEVICES.

Environment (hulk_tpu's names, the JAX ones as aliases):
  HULK_COORDINATOR  host:port of process 0 (or JAX_COORDINATOR_ADDRESS)
  HULK_NUM_PROCS    total process count   (or JAX_NUM_PROCESSES)
  HULK_PROC_ID      this process's id     (or JAX_PROCESS_ID)
"""
from __future__ import annotations

import datetime
import os

import numpy as np

# How long a process waits for the others, at start-up and in every
# collective, before it fails: a process that died leaves the others waiting.
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed() -> bool:
    """Join the process group the environment names; returns True if the
    run has more than one process."""
    coord = os.environ.get("HULK_COORDINATOR") or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if not coord:
        return False
    nprocs = int(
        os.environ.get("HULK_NUM_PROCS") or os.environ.get("JAX_NUM_PROCESSES") or 1
    )
    pid = int(os.environ.get("HULK_PROC_ID") or os.environ.get("JAX_PROCESS_ID") or 0)
    if nprocs <= 1:
        return False
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=nprocs,
                            rank=pid, timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def allgather(x) -> np.ndarray:
    """Gather a host array from every process -> [nprocs, ...] on all of
    them, byte for byte (any dtype). All processes must pass the same shape
    and dtype."""
    import torch
    import torch.distributed as dist

    x = np.ascontiguousarray(x)
    n = world_size()
    if n == 1:
        return x[None].copy()
    mine = torch.from_numpy(x.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine)
    return torch.stack(parts).numpy().view(x.dtype).reshape((n,) + x.shape)


def allreduce_sum(x) -> np.ndarray:
    """Exact cross-process sum of a host array (integer-valued f64 histogram
    counts and scalar counters sum exactly)."""
    return allgather(x).sum(axis=0)


def process_read_shard(paths: list[str]) -> list[str]:
    """Static file-level sharding of the input across processes: process i
    takes files i, i+N, i+2N... (deterministic)."""
    return paths[rank()::world_size()]
