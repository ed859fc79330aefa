"""The host-fed 720p stream on the card — the port's counterpart of
``scripts/streaming_bench.py``.

    python -m soc_project_stereo_matching_tpu_torch.benches streaming \
        [--device cuda|cpu] [--out chiprun_out/streaming.json]

The DrivingStereo-style configuration of ``BASELINE.json`` at the
firmware's frame (1280x720, D=64, B=8, 24 batches: the JAX script's
``W, H, D``, ``BATCH``, ``N_BATCHES``), on a seeded synthetic pair.  Four
measurements, each of ``SGMEngine.match_batch``:

* ``fps_streaming``: fresh numpy batches (the top-left byte of each left
  frame differs from batch to batch) fed by a producer thread through
  ``data/pipeline.PrefetchIterator`` at depth 3; the engine copies each
  from pageable memory on the current stream inside the call.  Host clock
  between two synchronises, since it includes the host;
* ``fps_device_resident``: the same batches put on the card beforehand,
  one call each, the same clock;
* the copy alone: one fresh pageable left and right batch ``.to("cuda")``
  between CUDA events, the least of 6 runs, in ms and GB/s;
* ``fps_device_only``: the window timer on one resident batch, as many
  calls back to back as the stream has batches (the JAX script's chained
  timing).

``overlap_efficiency`` is streaming over device-only; ``attribution`` splits
the gap into the copy not hidden by the prefetch (streaming against
resident) and the per-call cost (resident against device-only).  The three
loops' disparities must be equal batch for batch, and the first batch's at
least 0.95 within 1 of the true disparity where finite.  ``--device cpu``
runs the loops at a small size, checks them and reports every time as None.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import SGMEngine, SGMOptions
from ..data.pipeline import PrefetchIterator
from . import (document, first_call_ms, fmt, host_pair, log, out_path,
               resolve_device, sync, truth_check, window_ms, write)

W, H, D = 1280, 720, 64     # scripts/streaming_bench.py:41-43
BATCH = 8
N_BATCHES = 24
DEPTH = 3                   # the prefetch depth
COPY_RUNS = 6
CPU_SHAPE = dict(batch=2, h=24, w=64, dmax=16, batches=3)


def fresh(lefts0: np.ndarray, i: int) -> np.ndarray:
    """A new host batch whose left frames' top-left byte is xor-ed with
    ``i + 1``, so that no two batches of the stream are the same array."""
    left = lefts0.copy()
    left[:, 0, 0] ^= np.uint8((i + 1) % 256)
    return left


def loops(engine, lefts0: np.ndarray, rights0: np.ndarray, batches: int):
    """The three measured loops; returns ({"streaming_s", "resident_s",
    "device_only_ms", "device_only_enqueue_ms"} with None times on the CPU,
    {"streaming", "resident": [disparity per batch], "device_only":
    disparity})."""
    device = engine.device
    cuda = device.type == "cuda"

    def produce():
        for i in range(batches):
            yield fresh(lefts0, i), rights0

    outs = {"streaming": [], "resident": []}
    sync(device)
    t0 = time.perf_counter()
    with PrefetchIterator(produce(), depth=DEPTH) as stream:
        for left, right in stream:
            outs["streaming"].append(engine.match_batch(left, right))
    sync(device)
    streaming_s = time.perf_counter() - t0

    staged = [(torch.from_numpy(fresh(lefts0, i)).to(device),
               torch.from_numpy(rights0).to(device)) for i in range(batches)]
    sync(device)
    t0 = time.perf_counter()
    for left, right in staged:
        outs["resident"].append(engine.match_batch(left, right))
    sync(device)
    resident_s = time.perf_counter() - t0
    del staged

    left, right = (torch.from_numpy(x).to(device) for x in (lefts0, rights0))
    outs["device_only"] = engine.match_batch(left, right)
    device_only = enqueue = None
    if cuda:
        device_only, enqueue = window_ms(
            lambda: engine.match_batch(left, right), batches)
    times = {"streaming_s": streaming_s if cuda else None,
             "resident_s": resident_s if cuda else None,
             "device_only_ms": device_only, "device_only_enqueue_ms": enqueue}
    return times, outs


def copy_ms(lefts0: np.ndarray, rights0: np.ndarray) -> float:
    """CUDA-event ms of one fresh pageable left and right batch copied to
    the card, the least of ``COPY_RUNS``."""
    runs = []
    for i in range(COPY_RUNS):
        left, right = fresh(lefts0, 100 + i), rights0.copy()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        torch.from_numpy(left).to("cuda")
        torch.from_numpy(right).to("cuda")
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return min(runs)


def run(device=None, batches=None) -> dict:
    """The four measurements over ``batches`` batches; the sizes are the
    JAX script's on the card and ``CPU_SHAPE`` on the CPU.  Raises if the
    loops' disparities differ or the truth check fails."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    shape = dict(batch=BATCH, h=H, w=W, dmax=D, batches=N_BATCHES) if cuda \
        else dict(CPU_SHAPE)
    if batches is not None:
        shape["batches"] = batches
    b, n = shape["batch"], shape["batches"]
    lefts0, rights0, field = host_pair(b, shape["h"], shape["w"], 0,
                                       shape["dmax"])
    engine = SGMEngine(SGMOptions(max_disparity=shape["dmax"]), device=device)
    first, first_ms = first_call_ms(
        lambda: engine.match_batch(lefts0, rights0), device)
    check = truth_check(first, torch.from_numpy(field).to(device), "streaming")

    times, outs = loops(engine, lefts0, rights0, n)
    for i, (s, r) in enumerate(zip(outs["streaming"], outs["resident"],
                                   strict=True)):
        if not torch.equal(s, r):
            raise AssertionError(f"streaming: batch {i} host-fed differs from "
                                 "resident")
    if not torch.equal(outs["device_only"], first):
        raise AssertionError("streaming: the device-only batch differs from "
                             "the first batch")
    frames = n * b
    mb = 2 * lefts0.nbytes / 1e6
    doc = document("streaming", device,
                   config={"width": shape["w"], "height": shape["h"],
                           "max_disparity": shape["dmax"], "batch": b,
                           "batches": n, "prefetch_depth": DEPTH},
                   first_batch_ms=first_ms, **check,
                   engine_calls=1 + 2 * n + 1 + (n if cuda else 0),
                   fps_streaming=None, fps_device_resident=None,
                   fps_device_only=None,
                   device_only_ms=times["device_only_ms"],
                   device_only_enqueue_ms=times["device_only_enqueue_ms"],
                   overlap_efficiency=None,
                   h2d_transfer_ms_per_batch=None, h2d_transfer_gb_s=None,
                   h2d_mb_per_batch=mb, attribution=None)
    if cuda:
        fps_stream = frames / times["streaming_s"]
        fps_resident = frames / times["resident_s"]
        fps_dev = b * 1e3 / times["device_only_ms"]
        t_h2d = copy_ms(lefts0, rights0)
        doc.update(
            fps_streaming=fps_stream, fps_device_resident=fps_resident,
            fps_device_only=fps_dev, overlap_efficiency=fps_stream / fps_dev,
            h2d_transfer_ms_per_batch=t_h2d, h2d_transfer_gb_s=mb / t_h2d,
            attribution={
                "transfer_loss": 1 - fps_stream / fps_resident,
                "dispatch_loss": 1 - fps_resident / fps_dev,
                "note": "streaming/resident gap = the host-to-device copy "
                        "(pageable, on the current stream) not hidden by "
                        "the prefetch thread; resident/device-only gap = "
                        "what a call at a time costs over calls back to "
                        "back"})
    log(f"streaming: {doc['card']}, {doc['power_limit']}; {shape['w']}x"
        f"{shape['h']} D={shape['dmax']} B={b}, {n} batches")
    log(f"first batch {fmt(first_ms)} ms; frames/s streaming "
        f"{fmt(doc['fps_streaming'])}, resident "
        f"{fmt(doc['fps_device_resident'])}, device only "
        f"{fmt(doc['fps_device_only'])} ({fmt(doc['device_only_ms'])} ms a "
        f"batch, host enqueue {fmt(doc['device_only_enqueue_ms'])}); overlap "
        f"{fmt(doc['overlap_efficiency'])}; copy "
        f"{fmt(doc['h2d_transfer_ms_per_batch'])} ms for {mb:.1f} MB "
        f"({fmt(doc['h2d_transfer_gb_s'])} GB/s)")
    return doc


def main(args) -> int:
    path = out_path("streaming", args.out)
    write(run(args.device), path)
    log(f"wrote {path}")
    return 0
