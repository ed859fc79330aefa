"""Where the time of one ``match_batch`` goes on the card.

    python -m soc_project_stereo_matching_tpu_torch.stage_breakdown \
        [--batch 32] [--h 375] [--w 450] [--dmax 64] [--reps 10] \
        [--out chiprun_out/stage_breakdown.json]

Needs one CUDA device.  On a seeded synthetic pair at the given geometry
(default: the cone geometry, 450x375, D=64, B=32) with default
``SGMOptions`` otherwise, it measures:

* per stage of ``sgm_forward`` (the kernel path), the CUDA-event milliseconds
  of its span, median and [min, max] over ``--reps`` batches; the staged
  output is checked bit-equal to ``SGMEngine.match_batch``;
* the end-to-end batch time and the host's enqueue time (wall clock from the
  call to ``match_batch`` until it returns, before synchronising);
* the device idle share over a three-batch ``torch.profiler`` window:
  1 - (union of the device activity intervals) / (CUDA-event window); the
  window's Chrome trace is written to ``<--out without .json>/trace.json``;
* the K2 scans as the main path runs them (the group kernel: the
  horizontal pair's two-order scan, two launches, with its three
  transposes; the vertical pair's two-order scan with the WTA epilogue, its
  two launches together and each alone) and the vertical pair's two-order
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
import json
from pathlib import Path

import torch

from . import SGMEngine, SGMOptions
from .benches import per_call_ms
from .data.synthetic import synthetic_pair
from .ops import aggregation, kernels
from .ops.postprocess import median_filter_3x3
from .ops.wta import finalize_disparity
from .utils.profiling import StageTimer, card, cuda_time, summary, trace


def staged_forward(left, right, opt: SGMOptions, timer: StageTimer):
    """``sgm_forward`` on the kernel path, each stage a span of ``timer``
    and the whole a span named "total"."""
    with timer.span("total"):
        with timer.span("census_cost (K1)"):
            cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                              opt.max_disparity)
        with timer.span("scans + WTA epilogue (K2)"):
            fwd, inv = kernels.aggregate_paths_wta(cost, left, opt,
                                                   include_inverse=True)
        with timer.span("2x finalize_disparity (plain)"):
            dl, dr = finalize_disparity(fwd, opt), finalize_disparity(inv, opt)
        with timer.span("lr_check (K3)"):
            disp = kernels.lr_check(dl, dr, opt.lrcheck_thres, opt.max_disparity)
        with timer.span("speckle (K4)"):
            disp = kernels.remove_speckles(disp, 1.0, opt.min_speckle_area)
        with timer.span("median (plain)"):
            disp = median_filter_3x3(disp)
    return disp


def stage_times(left, right, opt, reps):
    timer = StageTimer()
    for _ in range(reps + 1):          # the first batch is a warm-up
        staged_forward(left, right, opt, timer)
    times = timer.times()
    stages = [s for s in times if s != "total"] + ["total"]
    return {stage: summary(times[stage][1:]) for stage in stages}


def batch_and_enqueue(engine, left, right, reps):
    """(ms a batch, host enqueue ms) over ``reps`` calls after a warm-up,
    each call between its own events (``benches.per_call_ms``)."""
    call = lambda: engine.match_batch(left, right)
    call()
    batch_ms, enqueue_ms = per_call_ms(call, reps)
    return summary(batch_ms), summary(enqueue_ms)


def idle_share(engine, left, right, trace_dir, batches=3):
    """(idle share, device busy ms, window ms) over ``batches`` batches: busy
    is the union of the device activity intervals the profiler recorded, the
    window the CUDA-event time around the batches; share None if the
    profiler recorded no device activity.  The window's Chrome trace goes to
    ``trace_dir``."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with trace(trace_dir) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(batches):
            engine.match_batch(left, right)
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    busy = busy_us / 1e3
    return (1.0 - busy / window if busy > 0 else None), busy, window


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
    horizontal pair (its transposes and its two-order scan's two launches,
    and the transposes alone), then the vertical pair's two-order scan
    adding onto its sum with the WTA epilogue, each of its two launches
    alone, and the same scan without the epilogue (``aggregate_paths``'s)."""
    cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                      opt.max_disparity)
    p1, p2 = opt.p1, opt.p2_init
    out = {"horizontal pair (3 transposes, a two-order scan of 2 launches)":
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
    ap.add_argument("--out", default="chiprun_out/stage_breakdown.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_breakdown: needs a CUDA device")

    name_and_limit = ", ".join(card())
    opt = SGMOptions(max_disparity=args.dmax)
    engine = SGMEngine(opt, device="cuda")
    levels = tuple(args.dmax * f // 64 for f in (10, 20, 35))
    left, right, _ = synthetic_pair(2, args.batch, args.h, args.w, levels)
    left, right = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()

    staged = staged_forward(left, right, opt, StageTimer())
    if not torch.equal(staged, engine.match_batch(left, right)):
        raise AssertionError("staged pipeline differs from match_batch")

    stages = stage_times(left, right, opt, args.reps)
    batch, enqueue = batch_and_enqueue(engine, left, right, args.reps)
    idle, busy, window = idle_share(engine, left, right,
                                    Path(args.out).with_suffix(""))
    groups = scan_groups(left, right, opt)
    scans, scan_bytes = scan_directions(left, right, opt)

    result = {"card": name_and_limit, "batch": args.batch, "h": args.h, "w": args.w,
              "d": args.dmax, "stages_ms": stages, "batch_ms": batch,
              "enqueue_ms": enqueue, "idle_share": idle,
              "device_busy_ms": busy, "profiler_window_ms": window,
              "scan_group_ms": groups,
              "scan_direction_ms": scans, "scan_direction_bytes": scan_bytes}
    print(name_and_limit)
    total = stages["total"]["median"]
    for stage, s in stages.items():
        print(f"stage {stage}: {s['median']:.4f} ms [{s['min']:.4f}, "
              f"{s['max']:.4f}] {100 * s['median'] / total:.1f}%")
    print(f"batch {batch['median']:.4f} ms, host enqueue "
          f"{enqueue['median']:.4f} ms; idle share {idle} "
          f"(device {busy:.3f} of {window:.3f} ms)")
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
