"""Process-group bring-up and cross-process metric reduction — counterpart
of the JAX package's ``parallel/multihost.py``.

Single-process use is zero-config: every helper is a no-op or an identity
when ``torch.distributed`` is not initialised.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Optional[timedelta] = None) -> None:
    """Bring up ``torch.distributed``.

    With no arguments, reads the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them); a
    lone process without ``MASTER_ADDR`` is left alone.  The backend is NCCL
    unless one is named, and NCCL raises without a card: ranks on the CPU
    pass ``backend="gloo"``.  With NCCL each process takes the card of its
    local rank (``LOCAL_RANK``, else its rank modulo the cards of its
    host)."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None \
            and "MASTER_ADDR" not in os.environ:
        return  # single-process run
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: the NCCL backend needs "
                               "a CUDA device (pass backend='gloo' for ranks "
                               "on the CPU)")
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (int(os.environ["RANK"]) if rank is None else rank) \
                % torch.cuda.device_count()
        torch.cuda.set_device(int(local))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)


def process_local_batch(global_batch: int) -> int:
    """This process's share of a global batch."""
    n = _world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def allsum_metrics(partial_metrics: dict) -> dict:
    """Sum each process's partial metric accumulators (sums and counts) into
    global totals, identically on every process (one ``all_reduce``);
    ratios are formed after the reduction.  Single process: identity."""
    if _world() == 1:
        return dict(partial_metrics)
    names = sorted(partial_metrics)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    vals = torch.tensor([float(partial_metrics[k]) for k in names],
                        dtype=torch.float64, device=device)
    dist.all_reduce(vals)
    return {k: float(v) for k, v in zip(names, vals.tolist())}
