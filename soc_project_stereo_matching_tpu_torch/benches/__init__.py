"""Benchmark tools of the port: the counterparts of the JAX package's
``bench.py`` (``soc_project_stereo_matching_tpu_torch.bench``) and of its
``scripts/`` benches, run as

    python -m soc_project_stereo_matching_tpu_torch.benches \
        <big_configs|streaming|loopback|scaling> [--device cuda|cpu] [--out PATH]

    big_configs   the four large geometries of ``scripts/big_config_bench.py``
                  (KITTI-2012, KITTI-2015, Middlebury-2014 half, untiled and
                  tiled on a 1x1 mesh)
    streaming     ``scripts/streaming_bench.py``: the 720p stream fed from the
                  host through ``data/pipeline.PrefetchIterator``, beside the
                  same batches resident on the card, the copy alone and one
                  resident batch back to back
    loopback      ``scripts/compat_loopback_fps.py``: frames/s of the wire
                  protocol with an echo client and with the engine client
    scaling       ``scripts/scaling_bench.py``: frames/s against the number
                  of ranks, one card a rank over NCCL

Each writes its JSON document to ``chiprun_out/<name>.json`` (never to
``results/``, which holds the TPU's records) with the card's name and power
limit.  On the card (the default; without one they raise) every time is a
CUDA-event or host-clock time around work that ends in a synchronise; with
``device="cpu"`` the same code runs the plain ops at a small size, checks
what it can and reports every time as None, since a time is a device number.

The other ``scripts/`` of the JAX package and their counterparts here:

    profile_stages.py          -> ``stage_breakdown.py``
    ablation_profile.py        -> ``probes/ablation.py``
    recurrence_floor.py, aggr_transpose_probe.py, mosaic_int16_probe.py,
    speckle_probe.py, speckle_tail_probe.py -> ``probes/``
    scan_variant_bench.py, bidir_fuse_probe.py, block_rows_probe.py
                               -> ``kernel_ab.py`` where a kernel is held
                                  against another commit's; otherwise none:
                                  they tune the TPU's VMEM block sizes and
                                  chunk knobs, which the CUDA kernels do not
                                  have
    pyr_cap_probe.py, strip_pyr_probe.py, speckle_compile_probe.py,
    compile_profile.py         -> none: they measure Mosaic compile time and
                                  VMEM caps; the port has no XLA compile
                                  (``_build.py`` builds with nvcc once)
    engine_vs_reference_table.py -> not yet: it needs the reference's pairs
                                  (``data/datasets.reference_data_pairs``)
                                  and OpenCV's ``StereoSGBM``

The helpers below are what the tools share: the seeded inputs, the timers
and the output path; the device rule (``resolve_device``: ``cuda`` by
default, raising without a card, ``cpu`` only when asked) is the probes'.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import reference_data_pairs
from ..data.synthetic import synthetic_pair
from ..probes import fmt, resolve_device  # noqa: F401  (re-exported)
from ..utils import profiling

SEED = 0                    # of every bench's synthetic pair
REPEATS = 5                 # repeats of a whole measurement, at least
MIN_GOOD = 0.95             # finite pixels within 1 of the true disparity
SOURCES = ("synthetic", "cone")
OUT_DIR = Path("chiprun_out")
REPO = Path(__file__).resolve().parents[2]


def log(msg: str) -> None:
    """A bench's progress and numbers go to stderr; stdout stays the
    headline bench's one line."""
    print(msg, file=sys.stderr, flush=True)


def levels(dmin: int, dmax: int) -> tuple:
    """Disparities of the synthetic field, strictly inside [dmin, dmax): the
    probes' rule (10, 20 and 35 of every 64 levels) offset by ``dmin``."""
    return tuple(dmin + max(1, (dmax - dmin) * f // 64) for f in (10, 20, 35))


def host_pair(batch: int, h: int, w: int, dmin: int, dmax: int,
              source: str = "synthetic", seed: int = SEED):
    """(left, right, true disparity or None): uint8 (batch, H, W) numpy.

    ``synthetic``: ``data/synthetic.synthetic_pair`` with ``levels(dmin,
    dmax)``.  ``cone``: the reference's cone pair (its ``cone`` folder of
    ``data/datasets.reference_data_pairs``) resized to (W, H) as
    ``scripts/big_config_bench.py`` resizes it, the same frame ``batch``
    times, no truth; it raises when the pair is absent."""
    if source == "synthetic":
        return synthetic_pair(seed, batch, h, w, levels(dmin, dmax))
    if source != "cone":
        raise ValueError(f"unknown input {source!r}: expected one of {SOURCES}")
    from ..data.imageio import load_image_gray_stb, resize_image

    cone = [p for p in reference_data_pairs() if p.name == "cone"]
    if not cone:
        raise FileNotFoundError("--input cone needs the reference's cone "
                                "pair (data/datasets.reference_data_pairs "
                                "finds none)")
    left, right = (resize_image(load_image_gray_stb(cone[0] / name), w, h)
                   for name in ("im2.png", "im6.png"))
    return (np.ascontiguousarray(np.broadcast_to(left, (batch, h, w))),
            np.ascontiguousarray(np.broadcast_to(right, (batch, h, w))), None)


def device_pair(device, batch: int, h: int, w: int, dmin: int, dmax: int,
                source: str = "synthetic", seed: int = SEED):
    """``host_pair`` as tensors on ``device``, copied before any timing."""
    left, right, field = host_pair(batch, h, w, dmin, dmax, source, seed)
    to = lambda x: torch.from_numpy(x).to(device)
    return to(left), to(right), None if field is None else to(field)


def truth_check(out: torch.Tensor, field: Optional[torch.Tensor],
                what: str) -> dict:
    """{"valid_frac", "good_frac"}: the finite share of the disparity and
    the share of the finite pixels within 1 of the true disparity (None
    without a truth).  Raises if fewer than ``MIN_GOOD`` of them are."""
    valid = torch.isfinite(out)
    rec = {"valid_frac": valid.float().mean().item(), "good_frac": None}
    if field is not None:
        good = ((out - field).abs() <= 1.0)[valid].float().mean().item()
        rec["good_frac"] = good
        if not good >= MIN_GOOD:
            raise AssertionError(f"{what}: only {good} of the finite pixels "
                                 f"lie within 1 of the true disparity "
                                 f"(want >= {MIN_GOOD})")
    return rec


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def first_call_ms(fn: Callable[[], object], device: torch.device):
    """(result, host ms of the first call until the card is done); the ms is
    None on the CPU."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms if device.type == "cuda" else None


def window_ms(fn: Callable[[], object], iters: int) -> tuple:
    """(CUDA-event ms, host ms to enqueue) per call of ``iters`` back-to-back
    calls between one pair of events, the card drained before.  The host's
    time holds its waits too: for a launch queue full of earlier calls'
    work, or at a call that synchronises (a copy from pageable memory).  It
    is the host's own work only where it stays well under the device's;
    ``per_call_ms`` gives that work, the card drained before each call."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def per_call_ms(fn: Callable[[], object], iters: int):
    """([CUDA-event ms], [host enqueue ms]) of ``iters`` calls, each between
    its own events with a synchronise after it; the enqueue is the host's
    ``perf_counter`` from the call until it returns."""
    calls, enqueues = [], []
    torch.cuda.synchronize()
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        fn()
        enqueues.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        calls.append(start.elapsed_time(end))
    return calls, enqueues


def percentiles(xs: Sequence[float]) -> dict:
    """{"median", "p95", "p99", "min", "max", "n"} of the samples (linear
    interpolation between order statistics)."""
    return {"median": statistics.median(xs),
            "p95": float(np.percentile(xs, 95)),
            "p99": float(np.percentile(xs, 99)),
            "min": min(xs), "max": max(xs), "n": len(xs)}


def spread(xs: Sequence[float]) -> dict:
    """{"median", "min", "max", "max_over_min", "runs"} of repeated
    measurements."""
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "max_over_min": max(xs) / min(xs), "runs": list(xs)}


def measure(fn: Callable[[], object], device: torch.device, iters: int,
            repeats: int = REPEATS) -> dict:
    """The timers, ``repeats`` times over (``REPEATS``, 5, for every bench):
    the window (``iters`` calls back to back) and ``iters`` calls one at a
    time.  Returns {"window_ms", "window_enqueue_ms": ``spread`` of the
    repeats' device ms and host ms to enqueue a call, "call_ms" and
    "enqueue_ms": ``percentiles`` of every call of every repeat, "iters",
    "repeats", "calls"}.  On the CPU ``fn()`` runs once and every time is
    None."""
    if device.type != "cuda":
        fn()
        return {"window_ms": None, "window_enqueue_ms": None, "call_ms": None,
                "enqueue_ms": None, "iters": iters, "repeats": repeats,
                "calls": 1}
    if repeats < 1 or iters < 1:
        raise ValueError(f"iters {iters} and repeats {repeats} must be >= 1")
    windows, hosts, calls, enqueues = [], [], [], []
    for _ in range(repeats):
        ms, host = window_ms(fn, iters)
        windows.append(ms)
        hosts.append(host)
        c, e = per_call_ms(fn, iters)
        calls += c
        enqueues += e
    return {"window_ms": spread(windows), "window_enqueue_ms": spread(hosts),
            "call_ms": percentiles(calls),
            "enqueue_ms": percentiles(enqueues), "iters": iters,
            "repeats": repeats, "calls": 2 * iters * repeats}


def engine_cell(engine, left: torch.Tensor, right: torch.Tensor,
                field: Optional[torch.Tensor], iters: int, what: str):
    """One geometry through ``engine.match_batch`` on inputs already on the
    device: the first call timed alone (``first_batch_ms``), the truth
    checked on its output, then ``measure``.  Returns (record, the first
    call's disparity); the record's "engine_calls" counts every
    ``match_batch`` it made.  "fps_per_chip" is the windows' median rate
    and "fps_all_windows" every window's frames over their summed time, a
    rate that a stall inside one window does move."""
    device = left.device
    out, first = first_call_ms(lambda: engine.match_batch(left, right), device)
    rec = {"first_batch_ms": first, **truth_check(out, field, what)}
    timing = measure(lambda: engine.match_batch(left, right), device, iters)
    rec["engine_calls"] = 1 + timing.pop("calls")
    batch = left.shape[0]
    window = timing["window_ms"]
    rec["ms_per_frame"] = None if window is None else window["median"] / batch
    rec["fps_per_chip"] = None if window is None \
        else batch * 1e3 / window["median"]
    rec["fps_all_windows"] = None if window is None \
        else batch * 1e3 / statistics.fmean(window["runs"])
    return {**rec, **timing}, out


def document(name: str, device: torch.device, **fields) -> dict:
    """The head of a bench's JSON document: what ran, where and when."""
    doc = {"bench": name, "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
           "device": device.type, "card": None, "power_limit": None}
    if device.type == "cuda":
        doc["card"], doc["power_limit"] = profiling.card()
    return {**doc, **fields}


def out_path(name: str, out=None) -> Path:
    """``out`` or ``chiprun_out/<name>.json``; a path inside the repo's
    ``results/`` (the TPU's records) is refused."""
    path = Path(out) if out is not None else OUT_DIR / f"{name}.json"
    if (REPO / "results") in path.resolve().parents:
        raise ValueError(f"{path}: results/ holds the TPU's records; the "
                         "benches write elsewhere (default chiprun_out/)")
    return path


def write(doc: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1))


