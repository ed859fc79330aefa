"""One run of one cell: set-up, the measured window, the traced reading,
the check of correctness, the result.

Set-up makes the cell's inputs from the seed, builds the engine, and warms
up the cell's own shape through the same feed the window drives, so that
nothing builds or loads inside the window.  ``setup_s`` runs from the
process's start (``t0``, taken by ``run.py`` before any import) to the
window's start.  The peak of device memory is reset once the CUDA context
is up and read when the window closes, before any correctness work.

A ``--trace 1`` run makes the same untraced window first, from which the
metrics on the host's clock are read, and then a second window of the
same length under ``torch.profiler``, from which the device's are read:
the profiler's own cost on the host stays out of the host's numbers.
The program's counters (its main path's launches, its planning queries,
the bytes its engine uploaded) are read just before and after the traced
window, and the window's counts go on the record beside the program's
spans and the device seconds of the operations launched under each.
"""

from __future__ import annotations

import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np

from . import check, drive, spec, trace, traffic as traffic_gen

WARMUP_CALLS = 2


def card_name_and_limit(torch) -> tuple:
    """(the card's name, its power limit as ``nvidia-smi`` gives it)."""
    name = torch.cuda.get_device_name(0)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        limit = line.splitlines()[0].strip() if line else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return name, limit


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def program_counts(kernels, engine) -> dict:
    """The program's counters as they stand: launches of the main path's
    C entries by counter (``kernels.LAUNCHES`` but the ``probe_*``
    entries), ``PLAN_QUERIES`` in all, ``upload_bytes`` of the engine."""
    launches = {k: n for k, n in kernels.LAUNCHES.items()
                if not k.startswith("probe_")}
    return {"launches": launches,
            "plan_queries": sum(kernels.PLAN_QUERIES.values()),
            "upload_bytes": engine.upload_bytes}


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, *, device: str = "cuda",
             t0: Optional[float] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> dict:
    """The result object of one run (``run.py`` prints it).  ``config``
    and ``traffic`` default to the cell's files; ``device="cpu"`` runs the
    port's plain path with the host's clock (the tests)."""
    import torch

    from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                       SGMOptions)
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    t0 = time.perf_counter() if t0 is None else t0
    marks = [("imports", time.perf_counter())]      # the set-up's phases
    cell = spec.workload(bench, cell_name)
    config = config or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    check.checkable(config)
    feed = spec.feed(traffic["feed"])
    on_card = device == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        clock = drive.CardClock(torch)
    else:
        clock = drive.HostClock()
    marks.append(("context", time.perf_counter()))

    lefts, rights, field = traffic_gen.pool(seed, config, traffic)
    marks.append(("inputs", time.perf_counter()))
    options = config["options"]
    engine = SGMEngine(SGMOptions(**options), EngineConfig(**config["engine"]),
                       device=device)
    sample = drive.Sample(len(lefts), traffic["keep"], seed)
    feed_l, feed_r = feed.inputs(lefts, rights, device)
    marks.append(("engine", time.perf_counter()))
    # warm the shape, and the memory the sample and the calls in flight hold
    held = [feed.call(engine, feed_l[k % len(feed_l)], feed_r[k % len(feed_l)])
            for k in range(WARMUP_CALLS + sample.size)]
    del held
    clock.sync()

    setup_s = time.perf_counter() - t0
    marks.append(("warm-up", t0 + setup_s))
    window = feed.window(engine, feed_l, feed_r, seconds, clock, sample)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    batch = traffic["batch"]
    record = SimpleNamespace(
        cell=cell_name, config=config, traffic=traffic, batch=batch,
        height=config["height"], width=config["width"],
        disparities=options["max_disparity"] - options["min_disparity"],
        paths=options["num_paths"], frames=window.calls * batch,
        elapsed_s=window.elapsed_s, frame_ms=window.frame_ms,
        host_call_s=window.host_call_s, setup_s=setup_s, peak_bytes=peak,
        traced=None)
    name, limit = card_name_and_limit(torch) if on_card else ("cpu", "none")
    log(f"card {name}, power limit {limit}; cell {cell_name}, seed {seed}, "
        f"{window.calls} calls of {batch} frames in {window.elapsed_s:.6f} s "
        f"(set-up {setup_s:.6f} s)")
    log("set-up s by phase: " + ", ".join(
        f"{phase} {b - a:.3f}" for (_, a), (phase, b) in zip([("", t0)] + marks, marks)))
    if window.frame_ms:
        log(f"frame ms: {len(window.frame_ms)} samples, median "
            f"{float(np.median(window.frame_ms)):.6f}")
    calls = window.calls
    reached = min(len(lefts), calls)    # pool entries a window drove
    breakdown = None
    if traced:
        prof = trace.profiler()
        before = program_counts(kernels, engine)
        prof.__enter__()
        tw = feed.window(engine, feed_l, feed_r, seconds, clock, sample, True)
        prof.__exit__(None, None, None)
        after = program_counts(kernels, engine)
        tr = trace.collect(prof)
        del prof
        calls += tw.calls
        reached = min(len(lefts), max(window.calls, tw.calls))
        layers = trace.layer_of(tr.device, spec.layer_patterns())
        launched = {k: n - before["launches"][k]
                    for k, n in after["launches"].items()
                    if n != before["launches"][k]}
        record.traced = SimpleNamespace(
            frames=tw.calls * batch, calls=tw.calls,
            window_s=tw.window_ms / 1e3,
            busy_s=trace.busy_seconds(tr.device),
            layer_s=trace.seconds_by_layer(tr.device, layers),
            idle_s=trace.idle_by_span(tr.device, tr.host),
            span_s=trace.span_seconds(tr.host),
            span_device_s=trace.seconds_by_span(tr),
            launches=sum(launched.values()),
            plan_queries=after["plan_queries"] - before["plan_queries"],
            upload_bytes=after["upload_bytes"] - before["upload_bytes"])
        breakdown = {"device_ops": trace.device_ops(tr.device),
                     "idle_gaps": trace.idle_gaps(tr.device, tr.host)}
        t = record.traced
        log(f"traced window: {tw.calls} calls in {tw.elapsed_s:.6f} s; device "
            f"seconds by layer: {t.layer_s}; busy {t.busy_s:.6f} of "
            f"{t.window_s:.6f} s")
        log("device seconds by program span: " + str(
            {span: sum(by_op.values()) for span, by_op in t.span_device_s.items()}))
        log(f"program counts in the traced window: launches {launched}, "
            f"plan queries {t.plan_queries}, upload bytes {t.upload_bytes}; "
            f"host seconds by program span: {t.span_s}")
        log(f"host ms a call in match_batch: untraced "
            f"{sum(window.host_call_s) * 1e3 / window.calls:.6f}, traced "
            f"{sum(tw.host_call_s) * 1e3 / tw.calls:.6f}")
        others = [op for op in tr.device if layers[op.name] == trace.OTHER]
        log(f"other: {trace.device_ops(others)}")

    metrics = {}
    for m in spec.metrics_of(bench, cell_name, traced):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del engine, feed_l, feed_r          # the program's state, before the reference
    if on_card:
        torch.cuda.empty_cache()
    items = sample.items
    t_ref = time.perf_counter()
    expected, = check.reference_outputs(lefts, rights, [k for k, _ in items],
                                        config, device)
    verdict = check.compare(items, expected, reached * batch)
    log(f"reference: {len(expected)} pool entries in "
        f"{time.perf_counter() - t_ref:.3f} s")
    log(check.truth_line(items, field))
    check.print_numbers(verdict["numbers"])

    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if record.traced is not None:
        dev["busy_s"] = record.traced.busy_s
        dev["window_s"] = record.traced.window_s
    result = {"correct": verdict["correct"], "attempted": calls * batch,
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = check.as_json(verdict["numbers"])
    return result
