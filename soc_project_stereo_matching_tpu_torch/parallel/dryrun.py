"""Multi-device dry run: the sharded engine across a schedule x mesh sweep,
each result held bit-equal to the single-device engine — counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m soc_project_stereo_matching_tpu_torch.parallel.dryrun 4 [--device cpu]

spawns one process per rank: over NCCL with one card each by default (it
needs ``n`` cards and raises without them), over gloo on the CPU only when
``--device cpu`` (``device="cpu"``) asks for it.
"""

from __future__ import annotations

import argparse
import multiprocessing
import socket
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..config import EngineConfig, SGMOptions

from ..data.synthetic import synthetic_pair
from ..models.sgm import SGMEngine
from . import multihost
from .mesh import make_mesh

TIMEOUT = timedelta(seconds=120)    # any collective or hop of the run


def sweep(n: int) -> list:
    """(data, tile, tile_mode) configurations for ``n`` ranks: both exact
    schedules on every multi-tile mesh, the pure data-parallel mesh once."""
    configs = []
    mid = next((t for t in (4, 2) if 1 < t < n and n % t == 0), None)
    if mid is not None:
        configs += [(n // mid, mid, "pipelined"), (n // mid, mid, "exact")]
    if n > 1:
        configs += [(1, n, "exact"), (1, n, "pipelined")]
    return configs + [(n, 1, "pipelined")]


def _rank_main(rank: int, n: int, port: int, backend: str) -> None:
    multihost.initialize(f"tcp://127.0.0.1:{port}", n, rank, backend,
                         timeout=TIMEOUT)
    try:
        device = "cuda" if backend == "nccl" else "cpu"
        options = SGMOptions(max_disparity=64, min_speckle_area=8)
        single = SGMEngine(options, device=device)
        w = 160
        for data, tile, mode in sweep(n):
            h, b = max(32, 8 * tile), max(2, data)
            left, right, _ = synthetic_pair(0, 1, h, w, (10, 20, 35))
            want = single.match(left[0], right[0])
            mesh = make_mesh(data, tile, timeout=TIMEOUT)
            engine = SGMEngine(options, EngineConfig(tile_mode=mode),
                               device=device, mesh=mesh)
            got = engine.match_batch(np.repeat(left, b, 0),
                                     np.repeat(right, b, 0))
            if got.shape != (b, h, w):
                raise AssertionError(f"shape {tuple(got.shape)} != {(b, h, w)}")
            for i in range(b):
                if not torch.equal(got[i], want):
                    raise AssertionError(
                        f"rank {rank}: sharded output {i} != single-device "
                        f"engine for mesh=({data}x{tile}) tile_mode={mode}")
            if rank == 0:
                print(f"dryrun_multichip: mesh=({data}x{tile}) "
                      f"tile_mode={mode} {backend} out={tuple(got.shape)} "
                      f"valid_frac={torch.isfinite(got).float().mean():.3f} "
                      "bit-equal=True", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = 600.0) -> None:
    """Run ``sweep(n_devices)`` on ``n_devices`` spawned ranks; raises if a
    rank fails, disagrees with the single-device engine or is still running
    after ``timeout_s``.  ``device`` None or "cuda": one card per rank over
    NCCL, and an error without ``n_devices`` cards; "cpu": gloo ranks."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    backend = "nccl" if device.type == "cuda" else "gloo"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and cards < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards; "
                           f"{cards} visible (pass device='cpu' to run the "
                           "ranks over gloo on the CPU)")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_devices, port, backend))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} still ran after {timeout_s} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if failed:
        raise RuntimeError(f"dryrun_multichip: ranks failed {failed}")
    print(f"dryrun_multichip OK: {n_devices} ranks over {backend}, "
          f"{len(sweep(n_devices))} schedule/mesh configs bit-equal to the "
          "single-device engine")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, help="number of ranks (devices)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda: NCCL, one card per rank (default); "
                             "cpu: gloo ranks")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
