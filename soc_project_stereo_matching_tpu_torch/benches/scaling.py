"""Frames/s against the number of cards — the port's counterpart of
``scripts/scaling_bench.py``.

    python -m soc_project_stereo_matching_tpu_torch.benches scaling \
        [--mode data|tile] [--batch 8] [--iters 5] [--height 368] \
        [--width 450] [--max-disparity 64] \
        [--cross-tile exact|pipelined|local] \
        [--device cuda|cpu] [--out chiprun_out/scaling.json]

For each size n of 1, 2, 4, 8, ... up to the cards present, n ranks are
spawned, one card each over NCCL (``--device cpu``: sizes 1 and 2 in gloo
ranks on the CPU), and build the tiled engine
(``EngineConfig(tile_mode=<cross-tile>)``) on a mesh of n x 1 (``--mode
data``: the batch split, ``--batch`` frames a rank) or 1 x n (``--mode
tile``: the rows split, ``--batch`` frames).  Every rank passes the global
batch of a seeded synthetic pair and gets the global disparity back.

Before timing, each size's output must equal the single-rank engine's
(``SGMEngine`` without a mesh on the same batch) bit for bit; in ``tile``
mode with ``local`` paths, which restart at tile boundaries by design, only
size 1 is held so.  Then each rank times ``--iters`` steps, each between a
barrier and a synchronise by CUDA events; a step's time is the largest over
the ranks (one ``all_reduce``), and a row's ``ms_per_step`` the median of
its steps.  ``scaling_eff`` is fps over n times the size-1 fps.  Each rank
counts the kernel launches of its timed steps (``ops.kernels.LAUNCHES``);
rank 0's are in the row.  A rank still running after ``RUN_TIMEOUT_S`` is
killed and the run fails.  On the CPU the steps run once, untimed.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import statistics
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import EngineConfig, SGMEngine, SGMOptions
from ..data.synthetic import synthetic_pair
from ..ops import kernels
from ..parallel import multihost
from ..parallel.mesh import make_mesh
from . import (SEED, document, fmt, levels, log, out_path, resolve_device,
               write)

SIZES = (1, 2, 4, 8, 16, 32)
TIMEOUT = timedelta(seconds=120)        # any collective or hop of a rank
RUN_TIMEOUT_S = 600.0                   # a size's whole world
SHAPE = dict(batch=8, height=368, width=450, max_disparity=64)  # :29-33
CPU_SHAPE = dict(batch=2, height=32, width=64, max_disparity=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, backend: str, cfg: dict,
               results) -> None:
    """One rank of a size-n world; rank 0 puts the row into ``results``."""
    multihost.initialize(f"tcp://127.0.0.1:{port}", n, rank, backend,
                         timeout=TIMEOUT)
    try:
        cuda = backend == "nccl"
        device = torch.device("cuda" if cuda else "cpu")
        if not cuda:
            torch.set_num_threads(1)
        data, tile = (n, 1) if cfg["mode"] == "data" else (1, n)
        opt = SGMOptions(max_disparity=cfg["max_disparity"])
        b, h, w = cfg["batch"] * data, cfg["height"], cfg["width"]
        left, right, _ = synthetic_pair(SEED, b, h, w,
                                        levels(0, opt.max_disparity))
        left, right = (torch.from_numpy(x).to(device) for x in (left, right))
        engine = SGMEngine(opt, EngineConfig(tile_mode=cfg["cross_tile"]),
                           device=device,
                           mesh=make_mesh(data, tile, timeout=TIMEOUT))
        got = engine.match_batch(left, right)
        bit_equal = None
        if cfg["cross_tile"] != "local" or tile == 1:
            want = SGMEngine(opt, device=device).match_batch(left, right)
            bit_equal = torch.equal(got, want)
            if not bit_equal:
                raise AssertionError(f"rank {rank}: mesh {data}x{tile} differs "
                                     "from the single-rank engine")
        steps = cfg["iters"] if cuda else 1
        kernels.reset_launch_counts()
        ms = []
        for _ in range(steps):
            dist.barrier()
            if cuda:
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            engine.match_batch(left, right)
            if cuda:
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
        launches = dict(kernels.LAUNCHES)
        step_ms = None
        if cuda:
            slowest = torch.tensor(ms, dtype=torch.float64, device=device)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
            step_ms = statistics.median(slowest.tolist())
        if rank == 0:
            results.put({"devices": n, "mesh": f"{data}x{tile}", "batch": b,
                         "ms_per_step": step_ms,
                         "fps": None if step_ms is None else b * 1e3 / step_ms,
                         "bit_equal": bit_equal, "steps": steps,
                         "launches": {k: v for k, v in launches.items() if v}})
    finally:
        dist.destroy_process_group()


def run_size(n: int, backend: str, cfg: dict, timeout_s: float) -> dict:
    """Spawn one world of ``n`` ranks; returns rank 0's row.  Raises if a
    rank fails or runs past ``timeout_s`` (the hung ranks are killed)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend, cfg, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    row = None
    try:
        # drain the queue before joining: a rank that put its row exits
        # only once the row is read off the pipe
        while row is None and time.monotonic() < deadline:
            try:
                row = results.get(timeout=0.5)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise TimeoutError(f"size {n}: ranks {hung} still ran after "
                           f"{timeout_s} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if failed or row is None:
        raise RuntimeError(f"size {n}: ranks failed {failed}")
    return row


def run(device=None, mode="data", batch=None, iters=5, height=None,
        width=None, max_disparity=None, cross_tile="exact") -> dict:
    """The rows of every size up to the cards present (2 gloo ranks on the
    CPU).  Unset sizes are the JAX script's on the card and ``CPU_SHAPE`` on
    the CPU."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    ranks = torch.cuda.device_count() if cuda else 2
    cfg = dict(SHAPE if cuda else CPU_SHAPE, mode=mode, iters=iters,
               cross_tile=cross_tile)
    for key, v in dict(batch=batch, height=height, width=width,
                       max_disparity=max_disparity).items():
        if v is not None:
            cfg[key] = v
    sizes = [n for n in SIZES if n <= ranks]
    rows = []
    for n in sizes:
        row = run_size(n, "nccl" if cuda else "gloo", cfg, RUN_TIMEOUT_S)
        fps, base = row["fps"], rows[0]["fps"] if rows else row["fps"]
        row["scaling_eff"] = None if fps is None else fps / (base * n)
        rows.append(row)
        log(f"devices={n:2d} mesh=({row['mesh']}) batch={row['batch']:3d} "
            f"{fmt(row['ms_per_step'])} ms/step {fmt(fps)} fps "
            f"scaling-eff={fmt(row['scaling_eff'])} "
            f"bit-equal={row['bit_equal']}")
    not_run = [n for n in (2, 4, 8) if n > ranks]    # the sizes of one host
    note = None
    if not_run:
        note = (f"sizes {not_run}: not run: {ranks} "
                f"{'CUDA device' if cuda else 'rank'}"
                f"{'' if ranks == 1 else 's'}")
        log(note)
    return document("scaling", device, mode=mode, cross_tile=cross_tile,
                    shape={"batch_per_device": cfg["batch"],
                           "h": cfg["height"], "w": cfg["width"],
                           "d": cfg["max_disparity"]},
                    iters=iters, ranks=ranks, rows=rows, not_run=note)


def arguments(ap) -> None:
    ap.add_argument("--mode", choices=("data", "tile"), default="data",
                    help="scale the batch axis (data) or the H-tile axis")
    for key, v in SHAPE.items():
        ap.add_argument(f"--{key.replace('_', '-')}", type=int, default=None,
                        help=f"default {v} ({CPU_SHAPE[key]} on the CPU)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cross-tile", choices=("exact", "pipelined", "local"),
                    default="exact")


def main(args) -> int:
    path = out_path("scaling", args.out)
    write(run(args.device, args.mode, args.batch, args.iters, args.height,
              args.width, args.max_disparity, args.cross_tile), path)
    log(f"wrote {path}")
    return 0
