"""Where the time of one ``match_batch`` goes on the card.

    python -m soc_project_stereo_matching_tpu_torch.stage_breakdown \
        [--batch 32] [--h 375] [--w 450] [--dmax 64] [--reps 10] \
        [--host-fed] [--out chiprun_out/stage_breakdown.json]

Needs one CUDA device.  On a seeded synthetic pair at the given geometry
(default: the cone geometry, 450x375, D=64, B=32) with default
``SGMOptions`` otherwise, it measures:

* a ``torch.profiler`` window over ``--reps`` calls of
  ``SGMEngine.match_batch`` after one untimed call, read through the
  program's own spans (``utils.profiling.span``: ``sgm.match`` and inside
  it ``sgm.upload``, ``sgm.census``, ``sgm.aggregate``, ``sgm.finalize``,
  ``sgm.lr_check``, ``sgm.speckle``, ``sgm.median``; ``sgm.plan`` around
  each query of a planning C entry).  Each device operation belongs to the
  span open around the host event that launched it (the CUDA runtime's
  call, matched by its correlation id), and a span's device range runs
  from its first operation's start to its last one's end: the stages'
  milliseconds, median and [min, max] over the calls, ``sgm.match`` the
  whole call.  From the same window: the device idle share, 1 - (union of
  the device activity intervals) / (CUDA-event window), with the
  profiler's annotation rows left out; the idle time between device
  operations by the innermost ``sgm.*`` span open on the host
  (``outside`` where none is), per call; and per call the main path's
  launches (``kernels.LAUNCHES`` but the ``probe_*`` entries, in all and
  by counter: ``horizontal_paths`` is the horizontal pair's path scan,
  ``horizontal_partial`` its group-kernel route past D = 512), the
  planning queries (``kernels.PLAN_QUERIES``) and the bytes uploaded
  (``SGMEngine.upload_bytes``).  The window's outputs (the last, where
  host-fed) are checked bit-equal to the untimed call's.  The window's Chrome trace is written
  to ``<--out without .json>/trace.json``.  ``--host-fed`` gives the calls
  uint8 numpy pairs, as a camera does, and brings each disparity back to
  host memory (``.cpu()``) before the next call;
* the end-to-end batch time and the host's enqueue time (wall clock from the
  call to ``match_batch`` until it returns, before synchronising);
* the K2 scans as the main path runs them (the horizontal pair's path
  scan, one launch, with its three transposes, and beside it the group
  kernel's two-order scan of the pair; the vertical pair's two-order scan
  with the WTA epilogue, its two launches together and each alone) and the vertical pair's two-order
  scan without the epilogue (the volume, as ``aggregate_paths`` makes it),
  median of five calls, and beside them each
  of the eight directions alone by the first design's kernel
  (``scan_direction``, a warp per path), with the bytes one such direction
  must move (1 cost byte read + a 2-byte read and a 2-byte write of the
  uint16 sum per volume element).

Prints one line per figure and writes all of them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

from . import SGMEngine, SGMOptions
from .benches import per_call_ms
from .data.synthetic import synthetic_pair
from .ops import aggregation, kernels
from .utils.profiling import SPAN_PREFIX, card, cuda_time, summary, trace

STAGES = tuple(SPAN_PREFIX + s for s in (
    "upload", "census", "aggregate", "finalize", "lr_check", "speckle",
    "median"))
MATCH = SPAN_PREFIX + "match"
OUTSIDE = "outside"


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    correlation: int


class Profile(NamedTuple):
    """A profiler window's events, each sorted by start.  ``device``: the
    operations the card ran, ``correlation`` the id of the host function
    open around their launch; ``host``: the host's recorded functions
    (PyTorch's operators, the program's spans), ``correlation`` their own
    id; ``spans``: the program's ``sgm.*`` spans among them."""
    device: List[Event]
    host: List[Event]
    spans: List[Event]


def collect(prof) -> Profile:
    """The ``Profile`` of a finished ``torch.profiler.profile``.  The
    profiler's annotation rows on the device's timeline (the ranges it draws
    for user-scope ``record_function`` spans) are not device work, and the
    CUDA runtime's host calls, linked to the function open around them,
    are not recorded functions."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(Event(e.name(), start, start + e.duration_ns(),
                                    e.linked_correlation_id()))
        elif e.linked_correlation_id() == 0:
            host.append(Event(e.name(), start, start + e.duration_ns(),
                              e.correlation_id()))
    device.sort(key=lambda e: e.start_ns)
    host.sort(key=lambda e: e.start_ns)
    return Profile(device, host,
                   [e for e in host if e.name.startswith(SPAN_PREFIX)])


def enclosing(times, spans: List[Event]) -> List[int]:
    """For each time, the index in ``spans`` of the innermost span open at
    it, or -1; the spans nest or are disjoint."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    out = [-1] * len(times)
    stack, j = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(order) and spans[order[j]].start_ns <= t:
            stack.append(order[j])
            j += 1
        # a span ends before any span open around it: the top is the
        # innermost once the closed ones above it are gone
        while stack and spans[stack[-1]].end_ns <= t:
            stack.pop()
        out[k] = stack[-1] if stack else -1
    return out


def device_ranges(profile: Profile, names) -> Dict[str, List[float]]:
    """{span name: [ms]}: for each span of those ``names`` that launched
    device work, the time from its first operation's start to its last
    one's end.  An operation belongs to the innermost of those spans open
    at the start of the host function that launched it (the function open
    around its launch: a PyTorch operator, or a span itself)."""
    started = {e.correlation: e.start_ns for e in profile.host}
    spans = [s for s in profile.spans if s.name in names]
    ops = [op for op in profile.device if op.correlation in started]
    owner = enclosing([started[op.correlation] for op in ops], spans)
    lo: Dict[int, int] = {}
    hi: Dict[int, int] = {}
    for op, i in zip(ops, owner):
        if i >= 0:
            lo[i] = min(lo.get(i, op.start_ns), op.start_ns)
            hi[i] = max(hi.get(i, op.end_ns), op.end_ns)
    out: Dict[str, List[float]] = defaultdict(list)
    for i in sorted(lo):
        out[spans[i].name].append((hi[i] - lo[i]) / 1e6)
    return dict(out)


def merged(ops: List[Event]) -> List[List[int]]:
    """The union of the operations' intervals, disjoint and sorted."""
    out: List[List[int]] = []
    for op in sorted(ops, key=lambda o: o.start_ns):
        if out and op.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end_ns)
        else:
            out.append([op.start_ns, op.end_ns])
    return out


def busy_ms(profile: Profile) -> float:
    return sum(hi - lo for lo, hi in merged(profile.device)) / 1e6


def idle_by_span(profile: Profile) -> Dict[str, float]:
    """{innermost ``sgm.*`` span open on the host, or ``OUTSIDE``: ms}: the
    time between the first and the last device operation in which none
    ran, cut at the spans' starts and ends."""
    busy = merged(profile.device)
    cuts = sorted({t for s in profile.spans for t in (s.start_ns, s.end_ns)})
    pieces = []
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        points = [g0] + cuts[bisect.bisect_right(cuts, g0):
                             bisect.bisect_left(cuts, g1)] + [g1]
        pieces += zip(points, points[1:])
    owners = enclosing([(a + b) / 2 for a, b in pieces], profile.spans)
    out: Dict[str, float] = defaultdict(float)
    for (a, b), i in zip(pieces, owners):
        out[profile.spans[i].name if i >= 0 else OUTSIDE] += (b - a) / 1e6
    return dict(out)


def main_counts() -> Dict[str, int]:
    """Launches of the main path's C entries so far (``LAUNCHES`` but the
    probes'), by counter."""
    return {name: n for name, n in kernels.LAUNCHES.items()
            if not name.startswith("probe_")}


class Window(NamedTuple):
    profile: Profile
    window_ms: float        # CUDA events around the calls
    calls: int
    launches: int           # main-path launches in the window
    plan_queries: int       # PLAN_QUERIES in the window
    upload_bytes: int       # engine.upload_bytes in the window
    outputs: list
    by_counter: Dict[str, int]  # the window's launches by counter, if any


def profiled_window(engine, left, right, calls: int, host_fed: bool,
                    trace_dir) -> Window:
    """``calls`` calls of ``engine.match_batch`` under ``torch.profiler``
    (``utils.profiling.trace``, its Chrome trace to ``trace_dir``); where
    ``host_fed`` each output is brought to host memory before the next
    call, and only the last is kept (a download onto fresh host pages each
    call would time the page faults)."""
    counts, plans = main_counts(), sum(kernels.PLAN_QUERIES.values())
    uploaded = engine.upload_bytes
    outputs = []
    torch.cuda.synchronize()
    with trace(trace_dir) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            out = engine.match_batch(left, right)
            if host_fed:    # keep the last download only, as a camera does
                outputs[:] = [out.cpu()]
            else:
                outputs.append(out)
        end.record()
        torch.cuda.synchronize()
    by_counter = {name: n - counts[name] for name, n in main_counts().items()
                  if n > counts[name]}
    return Window(collect(prof), start.elapsed_time(end), calls,
                  sum(by_counter.values()),
                  sum(kernels.PLAN_QUERIES.values()) - plans,
                  engine.upload_bytes - uploaded, outputs, by_counter)


def stage_summary(window: Window) -> Dict[str, dict]:
    """{span: summary of its device ranges in ms}: the stages in pipeline
    order, then ``sgm.match``."""
    ranges = device_ranges(window.profile, STAGES)
    ranges.update(device_ranges(window.profile, (MATCH,)))
    return {name: summary(ranges[name]) for name in STAGES + (MATCH,)
            if name in ranges}


def stage_times(engine, left, right, reps: int) -> Dict[str, dict]:
    """``stage_summary`` of ``reps`` calls after an untimed one, inputs on
    the card."""
    engine.match_batch(left, right)
    return stage_summary(profiled_window(engine, left, right, reps, False,
                                         None))


def batch_and_enqueue(engine, left, right, reps):
    """(ms a batch, host enqueue ms) over ``reps`` calls after a warm-up,
    each call between its own events (``benches.per_call_ms``)."""
    call = lambda: engine.match_batch(left, right)
    call()
    batch_ms, enqueue_ms = per_call_ms(call, reps)
    return summary(batch_ms), summary(enqueue_ms)


def scan_directions(left, right, opt, reps=5):
    """Milliseconds of each DIRECTIONS_8 scan launched alone, by the first
    design's kernel (one warp per path)."""
    cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                      opt.max_disparity)
    aggr = torch.zeros(cost.shape, dtype=torch.uint16, device=cost.device)
    out = {}
    for axis, reverse, roll in aggregation.DIRECTIONS_8:
        out[f"{axis} reverse={reverse} roll={roll}"] = cuda_time(
            lambda: kernels.scan_direction(cost, left, axis, reverse, roll,
                                           opt.p1, opt.p2_init, out=aggr),
            reps)["median"]
    return out, cost.numel() * 5


def scan_groups(left, right, opt, reps=5):
    """Milliseconds of the launches of ``kernels.aggregate_paths_wta``: the
    horizontal pair (its transposes and its path scan, the transposes
    alone, the path scan alone and the group kernel's two-order scan of the
    pair, its route past D = 512), then the vertical pair's two-order scan
    adding onto its sum with the WTA epilogue, each of its two launches
    alone, and the same scan without the epilogue (``aggregate_paths``'s)."""
    cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                      opt.max_disparity)
    p1, p2 = opt.p1, opt.p2_init
    out = {"horizontal pair (3 transposes and its scan)":
           cuda_time(lambda: kernels.horizontal_partial(cost, left, p1, p2,
                                                        False),
                     reps)["median"]}
    aggr = kernels.horizontal_partial(cost, left, p1, p2, False)
    pitch, h = kernels.TRANSPOSED_PITCH, cost.shape[1]
    aggr_t = kernels.volume_transpose(aggr, pad_to=pitch)
    out["its transposes alone (cost, image, sum)"] = cuda_time(
        lambda: (kernels.volume_transpose(cost, pad_to=pitch),
                 kernels.image_transpose(left, pad_to=pitch),
                 kernels.volume_transpose(aggr_t, inner=h)), reps)["median"]
    cost_t = kernels.volume_transpose(cost, pad_to=pitch)
    left_t = kernels.image_transpose(left, pad_to=pitch)
    if kernels.horizontal_route(cost.shape[2]) == "paths":
        out["its path scan alone (1 launch)"] = cuda_time(
            lambda: kernels.horizontal_paths(cost_t, left_t, p1, p2),
            reps)["median"]
    out["the group kernel's two-order scan of the pair (2 launches)"] = \
        cuda_time(lambda: kernels._bidir(cost_t, left_t, None, (0,), (0,), p1,
                                         p2, False, None,
                                         "horizontal_partial"),
                  reps)["median"]
    del cost_t, left_t
    (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
    wta = (opt.min_disparity, True)
    # the sums these launches add onto wrap around over the runs: their
    # time does not depend on the values
    out["vertical pair, two-order scan with the WTA epilogue (2 launches)"] = \
        cuda_time(lambda: kernels.directional_scan_group_bidir(
            cost, left, aggr, rf, rb, p1, p2, False, wta), reps)["median"]
    launches, _ = kernels.bidir_launches(cost, left, aggr, rf, rb, p1, p2,
                                         False, wta, "aggregate_paths_wta",
                                         True)
    names = ("its first launch (each order over its first half)",
             "its second launch (each order over the other half, the WTA "
             "epilogue)")
    if len(launches) == len(names):     # the group in one part
        for name, launch in zip(names, launches):
            out[name] = cuda_time(launch, reps)["median"]
    out["vertical pair, two-order scan (the volume)"] = cuda_time(
        lambda: kernels.directional_scan_group_bidir(cost, left, aggr, rf, rb,
                                                     p1, p2, False),
        reps)["median"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--h", type=int, default=375)
    ap.add_argument("--w", type=int, default=450)
    ap.add_argument("--dmax", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--host-fed", action="store_true")
    ap.add_argument("--out", default="chiprun_out/stage_breakdown.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_breakdown: needs a CUDA device")

    name_and_limit = ", ".join(card())
    opt = SGMOptions(max_disparity=args.dmax)
    engine = SGMEngine(opt, device="cuda")
    levels = tuple(args.dmax * f // 64 for f in (10, 20, 35))
    host_l, host_r, _ = synthetic_pair(2, args.batch, args.h, args.w, levels)
    left, right = torch.from_numpy(host_l).cuda(), torch.from_numpy(host_r).cuda()
    fed_l, fed_r = (host_l, host_r) if args.host_fed else (left, right)

    want = engine.match_batch(fed_l, fed_r).cpu()
    win = profiled_window(engine, fed_l, fed_r, args.reps, args.host_fed,
                          Path(args.out).with_suffix(""))
    if not all(torch.equal(out.cpu(), want) for out in win.outputs):
        raise AssertionError("a profiled call's output differs from "
                             "match_batch's")
    stages = stage_summary(win)
    busy = busy_ms(win.profile)
    idle = 1.0 - busy / win.window_ms if busy > 0 else None
    gaps = {name: ms / win.calls for name, ms in sorted(
        idle_by_span(win.profile).items(), key=lambda x: -x[1])}
    per_call = {"launches": win.launches / win.calls,
                "launches_by_counter": {name: n / win.calls for name, n
                                        in win.by_counter.items()},
                "plan_queries": win.plan_queries / win.calls,
                "upload_bytes": win.upload_bytes / win.calls}
    batch, enqueue = batch_and_enqueue(engine, fed_l, fed_r, args.reps)
    groups = scan_groups(left, right, opt)
    scans, scan_bytes = scan_directions(left, right, opt)

    result = {"card": name_and_limit, "batch": args.batch, "h": args.h,
              "w": args.w, "d": args.dmax, "host_fed": args.host_fed,
              "stages_ms": stages, "idle_ms_per_call_by_span": gaps,
              "per_call": per_call, "batch_ms": batch,
              "enqueue_ms": enqueue, "idle_share": idle,
              "device_busy_ms": busy, "profiler_window_ms": win.window_ms,
              "scan_group_ms": groups,
              "scan_direction_ms": scans, "scan_direction_bytes": scan_bytes}
    print(name_and_limit)
    total = stages[MATCH]["median"]
    for stage, s in stages.items():
        print(f"stage {stage}: {s['median']:.4f} ms [{s['min']:.4f}, "
              f"{s['max']:.4f}] {100 * s['median'] / total:.1f}%")
    print(f"idle ms a call by the innermost span: {json.dumps(gaps)}")
    print(f"a call: {json.dumps(per_call)}")
    print(f"batch {batch['median']:.4f} ms, host enqueue "
          f"{enqueue['median']:.4f} ms; idle share {idle} "
          f"(device {busy:.3f} of {win.window_ms:.3f} ms)")
    for name, ms in groups.items():
        print(f"scan group {name}: {ms:.4f} ms")
    for name, ms in scans.items():
        print(f"scan direction alone, first design, {name}: {ms:.4f} ms")
    print(f"bytes per scan direction of the first design: "
          f"{scan_bytes / 1e9:.4f} GB")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
