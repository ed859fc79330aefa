#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: require CUDA; print ``nvidia-smi`` name and power limit;
2. build: compile ``csrc/*.cu`` with nvcc and load it; print the seconds;
3. per kernel: K1-K4 (K2's WTA with and without the inverse view) against
   their plain PyTorch versions on the card, bit for bit, at the cone shape
   (B=2, 375x450, D=64) and an off shape (B=2, 37x53, D=48, dmin=8; there
   K4 also on ``data.synthetic.speckle_frames``: tile corners, a snake
   across every tile, NaN / -inf, frames that must not connect); median
   CUDA-event times of kernel and plain version at the cone shape.  The K2
   scan is the group kernel (one launch per vertical scan order, the
   horizontal pair on the transposed volume): it is also held against the
   sum of the first design's launches (``scan_direction``, one per
   direction), and the horizontal pair against that design's two launches
   along W;
4. slice: ``SGMEngine(SGMOptions(), device="cuda").match_batch`` on a B=8
   synthetic 375x450 pair, with every launch counter reset before and read
   after (the K2 scans must count 2 vertical groups, 2 horizontal scans and
   3 transposes); the result must be bit-equal to the plain path on the
   card, a 96x160 crop bit-equal to the same engine on the CPU (the plain
   ops, which the CPU tests hold bit-equal to the JAX package and its numpy
   oracle), and most finite pixels within 1 of the pair's true disparity;
   frames/s at B=32, and the K2 scan times per group at cone B=2, 8 and 32
   and at 1000x1500 D=256 B=1, beside the first design's; the launches of
   every main-path entry per ``match_batch`` are asserted (K1, the WTA, K3
   and K4 once each); K1 and K4 at the same four shapes (K1 at 1000x1500
   also in the halo mode) and the WTA (both views, on the volume the
   engine's scans make), each bit-equal to its plain version, with its time
   beside its bound; beside the WTA, ``amin`` over D of the same volume, a
   PyTorch call that reads it once (a read floor, not the same function);
5. tile phase (the spatial-tiling path):
   a. kernels: the halo census and the carry-in/out group scan against their
      plain versions, bit for bit, on the H-tiles of the cone shape (B=2,
      K=3 tiles of 125 rows) and of Middlebury-half (1000x1500, D=256, B=1,
      K=4 tiles of 250 rows), both direction groups (all six vertical
      directions of ``DIRECTIONS_8``), wrap and restart.  The tiles are
      chained on the one card in the exact schedule's order, and the chained
      output must equal the untiled kernel's; with the tile-local
      horizontal pair it must sum to ``aggregate_paths``.  Median CUDA-event
      times of kernel and plain version at the cone shape;
   b. engine: ``SGMEngine(..., EngineConfig(tile_mode="exact"),
      mesh=make_mesh(1, 1))`` at Middlebury-half D=256 (counters reset
      before, read after) bit-equal to the untiled kernel engine, and the
      frame time of both; all three tile modes at cone B=8 bit-equal too;
   c. multi-card: with two or more cards, ``dryrun_multichip(2)`` over NCCL
      (tile=2, exact and pipelined); with one card a line says it did not run;
6. probe phase (the aggregation probe path, cone pair B=8, 375x450, D=64):
   a. kernels: ``chain`` and ``chainio`` (every variant of the ladder, both
      launch shapes, at the step counts the probe times: 375 and 450), the
      volume transpose (uint8 and uint16, both ways), every rung of the
      16-bit ladder and ``scan16`` (forward and reverse, wrap and restart)
      against their plain versions, bit for bit; the same at an off shape
      (37x45, D=48), there also ``hpart_T`` against the shipped horizontal
      pair and ``scan16`` against the shipped K2 group scan;
   b. the path: ``probes.recurrence_floor.run``, ``aggr_transpose.run`` and
      ``int16_recurrence.run`` (counters reset before, read after), which
      hold ``hpart_T`` and ``scan16`` against the shipped kernels at the cone
      pair; each printed with the card's name and power limit;
   c. the "scan16" ladder: ``scan16`` (one launch per group where its 16-bit
      state fits, the capacity split where it does not) beside the shipped
      group scan (``prod3``) and the chain floor (P1 ``chain3``) on the
      vertical forward group, at cone B=2, 8, 32 and 1000x1500 D=256 B=1,
      in turns, each held bit-equal to the group scan first;
7. speckle probe phase (the speckle probe path, cone pair B=8, 375x450, D=64,
   ``min_area`` 50, and an off shape 37x45, D=48, B=4, ``min_area`` 8; at each
   shape the engine's pre-speckle disparity and four hand-made frames: a
   full-height line, components of exactly ``min_area`` and ``min_area - 1``
   pixels, NaN and -inf pixels, a frame with no finite pixel):
   a. kernels: S1 ``speckle_labels`` in all five modes against its plain
      version, labels and rounds; the exact modes against each other and K4's
      label stage (after the map to S1's format) against ``base``; S2
      ``speckle_hist`` with plain and aggregated adds and S3
      ``speckle_verdict`` against their plain versions; S4
      ``speckle_tail_fused`` (both adds) against S2 -> ``root_small`` -> S3;
      the verdict applied to the disparity against K4
      (``kernels.remove_speckles``) and its plain version; K4's two stage
      entries (the tile-local label stage and the aggregated tail) against
      theirs, each counted once.  Tolerance zero;
   b. the path: ``probes.speckle.run`` and ``probes.speckle_tail.run``
      (counters reset before, read after), their ladders printed with the
      card's name and power limit;
   c. the "S1" ladder: S1 in every mode (block4 where B is a multiple of 4)
      beside K4 whole and K4's label stage, on the engine's pre-speckle
      disparity at cone B=2, 8, 32 and 1000x1500 D=256 B=1, S1's labels held
      equal to K4's first;
   d. the "S4" ladder: at the same four shapes, on the grouped labels of
      S1 ``base``, S4 ``speckle_tail_fused`` in both modes held bit-equal
      to its plain version and to S2 -> ``root_small`` -> S3, one launch a
      call asserted; its device time (``torch.profiler``) beside its byte
      bound and its share of it, beside K4's tail (``count_verdict``) and
      the two-launch tail;
8. the per-kernel JSON line (each kernel's time beside its plain version's,
   its bound from this run's shapes and, where one PyTorch call computes the
   same function, that call's time), then the contract line
   ``{"ok": true, "device": {...}}`` last.

Inputs are seeded synthetic pairs (no dataset is needed).  Neither JAX nor
any module of the JAX package is imported, here or by the port: the last
phase checks ``sys.modules`` for both.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

CONE = dict(batch=2, h=375, w=450, dmin=0, dmax=64, levels=(10, 20, 35))
OFF = dict(batch=2, h=37, w=53, dmin=8, dmax=56, levels=(14, 20, 30))
SLICE_BATCH, FPS_BATCH = 8, 32
TILE_CONE = dict(CONE, k=3)
MIDDLEBURY_HALF = dict(batch=1, h=1000, w=1500, dmin=0, dmax=256,
                       levels=(40, 90, 150, 200), k=4)
GROUPS = (((0, 1, -1), False), ((0, -1, 1), True))   # (rolls, reverse)
HORIZONTAL_PAIR = (("h", False, 0), ("h", True, 0))  # (axis, reverse, roll)
CROP = (96, 160)
MIN_GOOD = 0.95     # finite pixels within 1 of the true disparity, at least
PROBE = dict(batch=8, h=375, w=450, dmax=64)
PROBE_OFF = dict(batch=2, h=37, w=45, dmax=48)
SPECKLE = dict(PROBE, min_area=50)
SPECKLE_OFF = dict(PROBE_OFF, batch=4, min_area=8)   # block4 takes 4 frames
RUN = 10            # back-to-back launches between two events (WTA ladder)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, device memory
OPS_PER_S = 67e12           # H100 SXM, 32-bit operations outside the tensor cores
PALLAS = "soc_project_stereo_matching_tpu/ops/pallas_kernels.py"
CSRC = "soc_project_stereo_matching_tpu_torch/csrc"
KERNELS = {  # wrapper -> (source, Pallas kernel it replaces)
    "census_cost_volume": (f"{CSRC}/census_cost.cu", f"{PALLAS}:1619"),
    "aggregate_paths": (f"{CSRC}/aggregate.cu", f"{PALLAS}:178"),
    "horizontal_partial": (f"{CSRC}/aggregate.cu", f"{PALLAS}:500"),
    "volume_transpose": (f"{CSRC}/transpose.cu",
                         "scripts/aggr_transpose_probe.py:176"),
    "wta_reduce": (f"{CSRC}/wta.cu", f"{PALLAS}:1073"),
    "lr_check": (f"{CSRC}/lr_check.cu", f"{PALLAS}:1754"),
    "remove_speckles": (f"{CSRC}/speckle.cu", f"{PALLAS}:1306"),
    # the tiled path's modes: mask_rows=False, and the cin_*/cout_* refs
    "census_cost_volume_halo": (f"{CSRC}/census_cost.cu", f"{PALLAS}:1619"),
    "directional_scan_group": (f"{CSRC}/aggregate.cu", f"{PALLAS}:178"),
    # the probe path
    "probe_chain": (f"{CSRC}/probe_recurrence.cu",
                    "scripts/recurrence_floor.py:122"),
    "probe_chainio": (f"{CSRC}/probe_recurrence.cu",
                      "scripts/recurrence_floor.py:202"),
    "probe_int16": (f"{CSRC}/probe_int16.cu",
                    "scripts/mosaic_int16_probe.py:102"),
    # the speckle probe path
    "probe_speckle_labels": (f"{CSRC}/probe_speckle.cu",
                             "scripts/speckle_probe.py:216"),
    "probe_speckle_hist": (f"{CSRC}/probe_speckle.cu",
                           "scripts/speckle_tail_probe.py:60"),
    "probe_speckle_verdict": (f"{CSRC}/probe_speckle.cu",
                              "scripts/speckle_tail_probe.py:86"),
    "probe_speckle_fused": (f"{CSRC}/probe_speckle.cu",
                            "scripts/speckle_tail_probe.py:110"),
}
MAIN_PATH = ("census_cost_volume", "aggregate_paths", "horizontal_partial",
             "volume_transpose", "wta_reduce", "lr_check", "remove_speckles")
# launches of the K2 scans per match_batch: the two vertical group scans, the
# two scans of the horizontal pair and the three transposes around them
SCAN_LAUNCHES = {"aggregate_paths": 2, "horizontal_partial": 2,
                 "volume_transpose": 3}
# C entry calls per match_batch of every main-path wrapper: one each for K1,
# the WTA, K3 and K4 (whose entry makes its four launches)
MAIN_LAUNCHES = {"census_cost_volume": 1, **SCAN_LAUNCHES, "wta_reduce": 1,
                 "lr_check": 1, "remove_speckles": 1}
TILE_PATH = ("census_cost_volume_halo", "directional_scan_group")
PROBE_PATH = ("probe_chain", "probe_chainio", "probe_int16")
SPECKLE_PATH = ("probe_speckle_labels", "probe_speckle_hist",
                "probe_speckle_verdict", "probe_speckle_fused")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` runs, after
    one warm-up run."""
    from soc_project_stereo_matching_tpu_torch.utils.profiling import cuda_time

    return cuda_time(fn, reps)["median"]


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (inputs read once, outputs written once) over the
    memory rate and its operations over the peak 32-bit rate.  The operation
    counts are the arithmetic of the plain formulation, to the nearest few
    per element."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def max_abs_err(got, want) -> float:
    """Raise unless ``got`` equals ``want`` exactly (same inf/NaN masks, equal
    finite values); return the max |difference| over finite values (0.0)."""
    import torch

    got, want = got.to(torch.float64), want.to(torch.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(mask(got), mask(want)):
            raise AssertionError(f"{mask.__name__} masks differ")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    if err != 0.0:
        raise AssertionError(f"values differ, max |err| = {err}")
    return err


def planes_err(got, want) -> float:
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def pair(cfg, batch=None, seed=0):
    """(left, right, true disparity) on the card."""
    import torch

    from soc_project_stereo_matching_tpu_torch.data.synthetic import synthetic_pair

    left, right, field = synthetic_pair(seed, batch or cfg["batch"], cfg["h"],
                                        cfg["w"], cfg["levels"])
    return tuple(torch.from_numpy(x).cuda() for x in (left, right, field))


def check_kernels(cfg, timed: bool) -> dict:
    """Each kernel vs its plain version at one shape; returns per-wrapper
    {"max_abs_err", "ms", "plain_ms"} (times only if ``timed``)."""
    import dataclasses

    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.data.synthetic import (
        speckle_frames)
    from soc_project_stereo_matching_tpu_torch.ops import (aggregation, kernels,
                                                           postprocess, wta)

    opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
    left, right, _ = pair(cfg)
    out = {}
    before = dict(kernels.LAUNCHES)

    b, h, w = left.shape
    d = opt.disp_range
    px, vol = b * h * w, b * h * w * d      # pixels, volume elements

    def record(name, err, kernel_fn, plain_fn, nbytes, ops, plain_reps=3):
        out[name] = {"max_abs_err": err, "library_ms": None,
                     **bound(nbytes, ops)}
        if timed:
            out[name]["ms"] = cuda_ms(kernel_fn, 20)
            out[name]["plain_ms"] = cuda_ms(plain_fn, plain_reps)

    # K1
    cc = lambda: kernels.census_cost_volume(left, right, opt.min_disparity,
                                            opt.max_disparity)
    cc_plain = lambda: kernels.census_cost_volume_plain(
        left, right, opt.min_disparity, opt.max_disparity)
    cost = cc()
    # 2 images in, the volume out; 24 compares + shifts per census bit
    # string, xor + popcount per volume element
    record("census_cost_volume", max_abs_err(cost, cc_plain()), cc, cc_plain,
           2 * px + vol, 2 * px * 48 + 2 * vol)

    # K2 scans: the main path's wrap mode, plus restart and 4 paths off-shape
    modes = [(opt, "wrap")]
    if not timed:
        modes += [(opt, "restart"),
                  (dataclasses.replace(opt, num_paths=4), "wrap")]
    err = max(max_abs_err(kernels.aggregate_paths(cost, left, o, mode).to(torch.int32),
                          aggregation.aggregate_paths(cost, left, o, mode).to(torch.int32))
              for o, mode in modes)
    aggr = kernels.aggregate_paths(cost, left, opt)
    # the group kernel against the first design's kernel, one launch per
    # direction, and the horizontal pair against that kernel's two launches
    for o, mode in modes:
        dirs = (aggregation.DIRECTIONS_8 if o.num_paths == 8
                else aggregation.DIRECTIONS_4)
        max_abs_err(kernels.aggregate_paths(cost, left, o, mode),
                    kernels.scan_directions(cost, left, dirs, o.p1, o.p2_init,
                                            mode == "restart"))
    record("aggregate_paths", err,
           lambda: kernels.aggregate_paths(cost, left, opt),
           lambda: aggregation.aggregate_paths(cost, left, opt),
           # cost and image in, the uint16 volume out; per element and
           # direction 3 mins, 4 adds, a mask, the min over D, the sum
           vol + px + 2 * vol, 8 * 10 * vol, plain_reps=1)
    hp = lambda: kernels.horizontal_partial(cost, left, opt.p1, opt.p2_init,
                                            False)
    hp_plain = lambda: kernels.horizontal_partial_plain(
        cost, left, opt.p1, opt.p2_init, False)
    hp_old = lambda: kernels.scan_directions(cost, left, HORIZONTAL_PAIR,
                                             opt.p1, opt.p2_init)
    err = max(max_abs_err(hp(), hp_plain()), max_abs_err(hp_old(), hp()))
    record("horizontal_partial", err, hp, hp_plain,
           vol + px + 2 * vol, 2 * 10 * vol, plain_reps=1)
    if timed:
        out["horizontal_partial"]["first_design_ms"] = cuda_ms(hp_old, 20)

    # K2 WTA, with and without the inverse view
    fwd, inv = kernels.wta_reduce(aggr, opt, include_inverse=True)
    pf, pi = kernels.wta_reduce_plain(aggr, opt, include_inverse=True)
    err = max(planes_err(fwd, pf), planes_err(inv, pi))
    only_fwd, none = kernels.wta_reduce(aggr, opt, include_inverse=False)
    if none is not None:
        raise AssertionError("wta_reduce(include_inverse=False) returned planes")
    err = max(err, planes_err(only_fwd, pf))
    record("wta_reduce", err,
           lambda: kernels.wta_reduce(aggr, opt, include_inverse=True),
           lambda: kernels.wta_reduce_plain(aggr, opt, include_inverse=True),
           # the volume in, 10 int32 planes out; compare + 2 selects per
           # element and view
           2 * vol + 40 * px, 2 * 3 * vol)

    # K3 on the pipeline's own maps, and off-shape on NaN / -inf / +inf too
    dl = wta.finalize_disparity(fwd, opt)
    dr = wta.finalize_disparity(inv, opt)
    cases = [(dl, dr)]
    if not timed:
        g = torch.Generator().manual_seed(3)
        noisy = []
        for m in (dl, dr):
            m = m.clone()
            r = torch.rand(m.shape, generator=g).to(m.device)
            m[r < 0.05] = float("nan")
            m[(r >= 0.05) & (r < 0.1)] = float("-inf")
            m[(r >= 0.1) & (r < 0.15)] = float("inf")
            m[(r >= 0.15) & (r < 0.2)] += 100.0       # out-of-band shifts
            noisy.append(m)
        cases.append(tuple(noisy))
    err = max(max_abs_err(kernels.lr_check(a, b, opt.lrcheck_thres, opt.max_disparity),
                          postprocess.lr_check(a, b, opt.lrcheck_thres, opt.max_disparity))
              for a, b in cases)
    checked = kernels.lr_check(dl, dr, opt.lrcheck_thres, opt.max_disparity)
    record("lr_check", err,
           lambda: kernels.lr_check(dl, dr, opt.lrcheck_thres, opt.max_disparity),
           lambda: postprocess.lr_check(dl, dr, opt.lrcheck_thres, opt.max_disparity),
           12 * px, 8 * px)       # two f32 maps in, one out

    # K4 on the checked map, on a noisy small-integer map and on the
    # hand-made frames (tile corners, a snake across every tile, NaN / -inf,
    # two frames that must not connect)
    g = torch.Generator().manual_seed(4)
    rough = torch.randint(0, 8, checked.shape, generator=g).float()
    rough[torch.rand(checked.shape, generator=g) < 0.35] = float("inf")
    cases = [(checked, opt.min_speckle_area), (rough.cuda(), 9)]
    if not timed:
        cases += [(torch.from_numpy(speckle_frames(40, 70, 8)).cuda(), 8)]
    err = max(max_abs_err(kernels.remove_speckles(m, 1.0, area),
                          postprocess.remove_speckles(m, 1.0, area))
              for m, area in cases)
    record("remove_speckles", err,
           lambda: kernels.remove_speckles(checked, 1.0, opt.min_speckle_area),
           lambda: postprocess.remove_speckles(checked, 1.0, opt.min_speckle_area),
           # one f32 map in, one out; 8 neighbour tests of ~4 operations (the
           # union rounds beyond one visit depend on the data: not counted)
           8 * px, 32 * px)

    torch.cuda.synchronize()
    for name in MAIN_PATH:
        if kernels.LAUNCHES[name] <= before[name]:
            raise AssertionError(f"{name}: launch counter did not move")
    return out


def scan_ladder() -> None:
    """Print the K2 scan times per direction group: the group kernel beside
    the first design's per-direction launches, for the vertical groups and
    the horizontal pair, and all of ``aggregate_paths``; cone B=2, 8, 32 and 1000x1500
    D=256 B=1.  The first design is checked equal at every shape."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    shapes = [(dict(CONE, batch=b), 5) for b in (2, 8, 32)]
    shapes.append((MIDDLEBURY_HALF, 3))
    for cfg, reps in shapes:
        opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
        left, right, _ = pair(cfg, seed=6)
        cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                          opt.max_disparity)
        p1, p2 = opt.p1, opt.p2_init
        acc = kernels.horizontal_partial(cost, left, p1, p2, False)
        rows = {}
        for name, (rolls, reverse) in zip(("v_forward", "v_reverse"), GROUPS):
            new = lambda: kernels.directional_scan_group(
                cost, left, acc, rolls, reverse, p1, p2, False)
            dirs = [("v", reverse, roll) for roll in rolls]
            old = lambda: kernels.scan_directions(cost, left, dirs, p1, p2,
                                                  out=acc)
            max_abs_err(
                kernels.directional_scan_group(cost, left, None, rolls,
                                               reverse, p1, p2, False),
                kernels.scan_directions(cost, left, dirs, p1, p2))
            rows[name] = (cuda_ms(new, reps), cuda_ms(old, reps))
        rows["horizontal"] = (
            cuda_ms(lambda: kernels.horizontal_partial(cost, left, p1, p2,
                                                       False), reps),
            cuda_ms(lambda: kernels.scan_directions(cost, left,
                                                    HORIZONTAL_PAIR, p1, p2),
                    reps))
        whole = cuda_ms(lambda: kernels.aggregate_paths(cost, left, opt), reps)
        del acc
        torch.cuda.empty_cache()
        print(f"K2 scans, {cfg['h']}x{cfg['w']} D={opt.disp_range} "
              f"B={cfg['batch']} (ms per launch group: group kernel / first "
              f"design): " + ", ".join(
                  f"{name} {new:.4f} / {old:.4f}"
                  for name, (new, old) in rows.items())
              + f"; aggregate_paths {whole:.4f}")


def k1_k4_ladder() -> None:
    """Print K1's and K4's times beside their bounds at cone B=2, 8, 32 and
    at 1000x1500 D=256 B=1 (there K1 also in the halo mode the tiled engine
    runs on a 1x1 mesh), each output held bit-equal to its plain version
    first.  K4's input is the engine's own pre-speckle disparity."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels, postprocess
    from soc_project_stereo_matching_tpu_torch.probes import (
        prespeckle_disparity)

    for cfg in [dict(CONE, batch=b) for b in (2, 8, 32)] + [MIDDLEBURY_HALF]:
        b, h, w, dmax = cfg["batch"], cfg["h"], cfg["w"], cfg["dmax"]
        left, right, _ = pair(cfg, seed=7)
        runs = [("", left, right)]
        if h == MIDDLEBURY_HALF["h"]:
            runs.append(("halo ", *(torch.nn.functional.pad(x, (0, 0, 2, 2))
                                    for x in (left, right))))
        px, vol = b * h * w, b * h * w * dmax
        k1_bound = bound(2 * px + vol, 2 * px * 48 + 2 * vol)["bound_ms"]
        for mode, il, ir in runs:
            halo = bool(mode)
            fn = lambda: kernels.census_cost_volume(il, ir, 0, dmax, halo)
            max_abs_err(fn(), kernels.census_cost_volume_plain(il, ir, 0, dmax,
                                                               halo))
            ms = cuda_ms(fn, 20)
            print(f"K1 census_cost_volume {mode}{h}x{w} D={dmax} B={b}: "
                  f"{ms:.4f} ms, bound {k1_bound:.4f} ms ({k1_bound / ms:.1%} "
                  f"of it), bit-equal")
        del left, right, runs
        opt, disp = prespeckle_disparity(torch.device("cuda"), b, h, w, dmax)
        area = opt.min_speckle_area
        max_abs_err(kernels.remove_speckles(disp, 1.0, area),
                    postprocess.remove_speckles(disp, 1.0, area))
        ms = cuda_ms(lambda: kernels.remove_speckles(disp, 1.0, area), 20)
        k4_bound = bound(8 * px, 32 * px)["bound_ms"]
        print(f"K4 remove_speckles {h}x{w} B={b} (pre-speckle disparity, "
              f"min_area {area}): {ms:.4f} ms, bound {k4_bound:.4f} ms, "
              f"bit-equal")
        del disp
        torch.cuda.empty_cache()


def wta_ladder() -> None:
    """Print the WTA's time beside its bound at cone B=2, 8, 32 and at
    1000x1500 D=256 B=1, on the volume ``aggregate_paths`` makes of a
    synthetic pair, both views held bit-equal to the plain version first;
    beside it the min over D of the volume by one PyTorch call, which reads
    the volume once (a read floor; the WTA does more).  A call's events also
    hold the wrapper's host time when the card waits for it, so the time a
    launch takes in a run of RUN back-to-back launches is printed too."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    for cfg in [dict(CONE, batch=b) for b in (2, 8, 32)] + [MIDDLEBURY_HALF]:
        opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
        left, right, _ = pair(cfg, seed=8)
        cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                          opt.max_disparity)
        aggr = kernels.aggregate_paths(cost, left, opt)
        del cost
        b, h, d, w = aggr.shape
        fn = lambda: kernels.wta_reduce(aggr, opt, include_inverse=True)
        got = fn()
        want = kernels.wta_reduce_plain(aggr, opt, include_inverse=True)
        max_abs_err(torch.stack(got[0] + got[1]), torch.stack(want[0] + want[1]))
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(fn, 20)
        run = cuda_ms(lambda: [fn() for _ in range(RUN)], 5) / RUN
        floor = cuda_ms(lambda: aggr.view(torch.int16).amin(dim=2), 20)
        px, vol = b * h * w, b * h * w * d
        lim = bound(2 * vol + 40 * px, 2 * 3 * vol)["bound_ms"]
        print(f"WTA wta_reduce {h}x{w} D={d} B={b}: {ms:.4f} ms a call, "
              f"{run:.4f} a launch in runs of {RUN}; bound {lim:.4f} ms "
              f"({lim / ms:.1%} / {lim / run:.1%} of it); read floor "
              f"aggr.amin(dim=2) {floor:.4f} ms; both views bit-equal")
        del aggr, left, right
        torch.cuda.empty_cache()


def halo_tiles(img, k: int) -> list:
    """The (B, H/K + 4, W) halo images of an image's K H-tiles, with zeros
    beyond the image: what ``halo_exchange_rows`` gives each rank."""
    import torch

    ht = img.shape[1] // k
    padded = torch.nn.functional.pad(img, (0, 0, 2, 2))
    return [padded[:, i * ht:i * ht + ht + 4].contiguous() for i in range(k)]


def chain_group(cost, img, rolls, reverse, p1, p2, restart, k):
    """One direction group over K H-tiles chained in the exact schedule's
    order (tile 0 -> K-1, or K-1 -> 0 for a reverse group): each tile takes
    the upstream tile's carry and boundary gray row.  Each tile's kernel
    output and carry are held against the plain version on the same
    inputs.  Returns (the tiles' outputs concatenated, the max error)."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels

    ht = cost.shape[1] // k
    parts, carry, err = [None] * k, None, 0.0
    for i in (range(k - 1, -1, -1) if reverse else range(k)):
        rows = slice(i * ht, (i + 1) * ht)
        prev = None
        if carry is not None:
            edge = (i + 1) * ht if reverse else i * ht - 1
            prev = img[:, edge].contiguous()
        args = (cost[:, rows].contiguous(), img[:, rows].contiguous(), None,
                rolls, reverse, p1, p2, restart)
        kw = dict(carry_in=carry, want_carry=True, prev_gray=prev)
        parts[i], carry = kernels.directional_scan_group(*args, **kw)
        want, want_carry = kernels.directional_scan_group_plain(*args, **kw)
        err = max(err, max_abs_err(parts[i], want), planes_err(carry, want_carry))
    return torch.cat(parts, dim=1), err


def check_tile_kernels(cfg, timed: bool) -> dict:
    """The tiled path's kernel modes vs their plain versions on the K
    H-tiles of one shape; returns per-wrapper {"max_abs_err"} (+ "ms" and
    "plain_ms" for one middle tile if ``timed``)."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
    dmin, dmax, p1, p2, k = opt.min_disparity, opt.max_disparity, opt.p1, \
        opt.p2_init, cfg["k"]
    left, right, _ = pair(cfg)
    h = left.shape[1]
    ht = h // k
    out = {}
    before = dict(kernels.LAUNCHES)

    # halo census: per tile vs plain; the tiles together equal the untiled
    # volume except the global border rows, which the tiled caller fixes
    err, vols = 0.0, []
    tiles = list(zip(halo_tiles(left, k), halo_tiles(right, k)))
    for tl, tr in tiles:
        vols.append(kernels.census_cost_volume(tl, tr, dmin, dmax,
                                               img_has_halo=True))
        err = max(err, max_abs_err(vols[-1], kernels.census_cost_volume_plain(
            tl, tr, dmin, dmax, img_has_halo=True)))
    cost = kernels.census_cost_volume(left, right, dmin, dmax)
    max_abs_err(torch.cat(vols, dim=1)[:, 2:h - 2], cost[:, 2:h - 2])
    out["census_cost_volume_halo"] = {"max_abs_err": err}

    # group scans with carries: each tile vs plain on the same carry-in; the
    # chain equals the untiled group and the first design's untiled
    # launches, and with the tile-local horizontal pair the sum is the main
    # path's aggregate_paths
    err = 0.0
    for restart in (False, True):
        mode = "restart" if restart else "wrap"
        total = kernels.horizontal_partial(cost, left, p1, p2, restart).int()
        for i in range(k):
            rows = slice(i * ht, (i + 1) * ht)
            c, g = cost[:, rows].contiguous(), left[:, rows].contiguous()
            max_abs_err(kernels.horizontal_partial(c, g, p1, p2, restart),
                        total[:, rows])
        for rolls, reverse in GROUPS:
            chained, e = chain_group(cost, left, rolls, reverse, p1, p2,
                                     restart, k)
            err = max(err, e)
            max_abs_err(chained, kernels.directional_scan_group(
                cost, left, None, rolls, reverse, p1, p2, restart))
            # ... and the first design's launches, one per direction
            max_abs_err(chained, kernels.scan_directions(
                cost, left, [("v", reverse, roll) for roll in rolls], p1, p2,
                restart))
            total += chained.int()
        max_abs_err(total, kernels.aggregate_paths(cost, left, opt, mode).int())
    out["directional_scan_group"] = {"max_abs_err": err}

    torch.cuda.synchronize()
    for name in TILE_PATH:
        if kernels.LAUNCHES[name] <= before[name]:
            raise AssertionError(f"{name}: launch counter did not move")

    if timed:       # the middle tile, its carry from the tile above
        tl, tr = tiles[1]
        first = slice(0, ht)
        _, carry = kernels.directional_scan_group(
            cost[:, first].contiguous(), left[:, first].contiguous(), None,
            GROUPS[0][0], False, p1, p2, False, want_carry=True)
        args = (cost[:, ht:2 * ht].contiguous(), left[:, ht:2 * ht].contiguous(),
                None, GROUPS[0][0], False, p1, p2, False)
        kw = dict(carry_in=carry, want_carry=True,
                  prev_gray=left[:, ht - 1].contiguous())
        for name, fn, plain in (
                ("census_cost_volume_halo",
                 lambda: kernels.census_cost_volume(tl, tr, dmin, dmax,
                                                    img_has_halo=True),
                 lambda: kernels.census_cost_volume_plain(tl, tr, dmin, dmax,
                                                          img_has_halo=True)),
                ("directional_scan_group",
                 lambda: kernels.directional_scan_group(*args, **kw),
                 lambda: kernels.directional_scan_group_plain(*args, **kw))):
            out[name]["ms"] = cuda_ms(fn, 20)
            out[name]["plain_ms"] = cuda_ms(plain, 3)
            out[name]["library_ms"] = None
        b, w, d = left.shape[0], left.shape[2], dmax - dmin
        px, vol = b * ht * w, b * ht * w * d
        # the two halo images in, the tile's volume out
        out["census_cost_volume_halo"].update(
            bound(2 * b * (ht + 4) * w + vol, 2 * b * (ht + 4) * w * 48 + 2 * vol))
        # cost, image and boundary row in, the uint16 sum out, and the int32
        # carry (3 directions of D + 1 planes) in and out
        out["directional_scan_group"].update(
            bound(vol + px + b * w + 2 * vol + 2 * 4 * b * 3 * (d + 1) * w,
                  3 * 10 * vol))
    return out


def tile_engine_phase() -> dict:
    """The tiled engine on a 1x1 mesh vs the untiled kernel engine; returns
    the launch counts of its Middlebury-half run."""
    import torch

    from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                       SGMOptions)
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

    big = SGMOptions(max_disparity=MIDDLEBURY_HALF["dmax"])
    left, right, field = pair(MIDDLEBURY_HALF, seed=3)
    untiled = SGMEngine(big, device="cuda")
    tiled = SGMEngine(big, EngineConfig(tile_mode="exact"), device="cuda",
                      mesh=make_mesh(1, 1))
    want = untiled.match_batch(left, right)
    kernels.reset_launch_counts()
    got = tiled.match_batch(left, right)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in TILE_PATH}
    missing = [name for name in TILE_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"tiled path launched no {missing}")
    if launches["directional_scan_group"] != 2:     # one launch per group
        raise AssertionError(f"tiled path launched {launches}, want 2 group "
                             f"scans")
    max_abs_err(got, want)
    valid = torch.isfinite(got)
    good = ((got - field).abs() <= 1.0)[valid].float().mean().item()
    if good < MIN_GOOD:
        raise AssertionError(f"tiled Middlebury-half: only {good} of the "
                             f"finite pixels lie within 1 of the truth")
    ms = {name: [] for name in ("untiled", "tiled")}
    for name in ("untiled", "tiled", "tiled", "untiled"):
        engine = tiled if name == "tiled" else untiled
        ms[name].append(cuda_ms(lambda: engine.match_batch(left, right), 3))
    print(f"tile engine: exact on a 1x1 mesh bit-equal to the untiled engine "
          f"(1000x1500 D=256 B=1; finite {valid.float().mean().item():.4f}, "
          f"{good:.4f} of them within 1 of the truth); frame "
          f"{min(ms['tiled']):.3f} ms tiled vs {min(ms['untiled']):.3f} ms "
          f"untiled (each the lower of two medians of 3)")

    cone_l, cone_r, _ = pair(CONE, batch=SLICE_BATCH, seed=4)
    want = SGMEngine(SGMOptions(), device="cuda").match_batch(cone_l, cone_r)
    for mode in ("exact", "pipelined", "local"):
        engine = SGMEngine(SGMOptions(), EngineConfig(tile_mode=mode),
                           device="cuda", mesh=make_mesh(1, 1))
        max_abs_err(engine.match_batch(cone_l, cone_r), want)
    print(f"tile engine: exact, pipelined and local on a 1x1 mesh bit-equal "
          f"to the untiled engine (cone B={SLICE_BATCH})")
    return launches


def probe_kernel_checks(cfg, full: bool) -> dict:
    """P1-P4 vs their plain versions, bit for bit, at one geometry.  With
    ``full`` (the cone pair) also the times for the kernels line: kernel,
    plain version, bound and, for the transpose, the PyTorch call; without
    it (the off shape) also ``hpart_T`` and ``scan16`` vs the shipped
    kernels, which the probes' own runs check at the cone pair."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.probes import (
        aggr_transpose, pair_and_cost, random_tensor)
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    dev = torch.device("cuda")
    b, h, w = cfg["batch"], cfg["h"], cfg["w"]
    opt, left, _, cost = pair_and_cost(dev, b, h, w, cfg["dmax"], seed=5)
    d, p1, p2 = cost.shape[2], opt.p1, opt.p2_init
    group, ring = (0, 1, -1), 4
    out = {}

    # P1 / P2 at both launch shapes: (x, steps, directions)
    shapes = {"3": (random_tensor(11, 0, 65536, (b, d, w), torch.uint16, dev),
                    h, group),
              "1": (random_tensor(12, 0, 65536, (b, d, h), torch.uint16, dev),
                    w, (0,))}
    err = 0.0
    for x, steps, rolls in shapes.values():
        err = max(err, max_abs_err(pk.chain(x, steps, rolls, p1),
                                   pk.chain_plain(x, steps, rolls, p1)))
    out["probe_chain"] = {"max_abs_err": err}
    err, rings = 0.0, {}
    for key, (x, steps, rolls) in shapes.items():
        p = x.shape[2]
        rings[key] = (
            random_tensor(13, 0, 256, (b, ring, d, p), torch.int32, dev),
            random_tensor(14, p1, p2 + 1, (b, len(rolls), ring, p),
                          torch.int32, dev))
        for extra in (0, 1, 2):          # the f, m and b pass shapes
            for n in (steps, ring - 1):  # as timed, and less than one lap
                args = (x, *rings[key], n, rolls, extra, p1)
                err = max(err, max_abs_err(pk.chainio(*args),
                                           pk.chainio_plain(*args)))
    out["probe_chainio"] = {"max_abs_err": err}

    # P3: uint8 and uint16, both ways, contiguous and with the pitch the
    # main path gives its transposed volumes
    part = kernels.horizontal_partial(cost, left, p1, p2, False)
    pitch = kernels.TRANSPOSED_PITCH
    err = 0.0
    for vol in (cost, part):
        for pad_to in (1, pitch):
            there = pk.volume_transpose(vol, pad_to=pad_to)
            want = pk.volume_transpose_plain(vol, None, pad_to)
            back = pk.volume_transpose(there, inner=h)
            err = max(err, max_abs_err(there, want), max_abs_err(back, vol))
    if not full:
        max_abs_err(aggr_transpose.hpart_T(cost, left, p1, p2), part)
    out["volume_transpose"] = {"max_abs_err": err}

    # P4: every rung, and scan16 vs its plain version and vs the K2 scan
    err = 0.0
    for i, name in enumerate(pk.RUNGS):
        rows = 8 if name in pk.LOOP_RUNGS else d
        x = random_tensor(20 + i, 0, 256, (b, rows, w), torch.uint8, dev)
        err = max(err, max_abs_err(pk.rung(name, x), pk.rung_plain(name, x)))
    for reverse in (False, True):
        for restart in (False, True):
            args = (cost, left, group, reverse, p1, p2, restart)
            got = pk.scan16(*args)
            err = max(err, max_abs_err(got, pk.scan16_plain(*args)))
            if not full:
                max_abs_err(got, kernels.directional_scan_group(
                    cost, left, None, group, reverse, p1, p2, restart))
    out["probe_int16"] = {"max_abs_err": err}
    torch.cuda.synchronize()
    if not full:
        return out

    # times at the cone pair: chain1, chainio1 with one read-add (the shipped
    # accumulating launch's shape), the uint16 transpose, scan16's group
    x, steps, rolls = shapes["1"]
    paths, vol = b * h, b * h * d * w
    io_args = (x, *rings["1"], steps, rolls, 1, p1)
    part_t = pk.volume_transpose(part, pad_to=pitch)
    timed = {
        "probe_chain": (
            lambda: pk.chain(x, steps, rolls, p1),
            lambda: pk.chain_plain(x, steps, rolls, p1),
            # one row in, one out; ~10 operations per step and disparity
            bound(4 * b * d * h, 10 * paths * steps * d), None),
        "probe_chainio": (
            lambda: pk.chainio(*io_args), lambda: pk.chainio_plain(*io_args),
            # + the rings in; ~14 operations per step and disparity
            bound(4 * b * d * h + 4 * b * ring * (d + 1) * h,
                  14 * paths * steps * d), None),
        # the main path's largest: the padded uint16 sums back to (B, H, D, W)
        "volume_transpose": (
            lambda: pk.volume_transpose(part_t, inner=h),
            lambda: pk.volume_transpose_plain(part_t, h),
            bound(2 * 2 * vol, 0),
            lambda: part_t[..., :h].permute(0, 3, 2, 1).contiguous()),
        "probe_int16": (
            lambda: pk.scan16(cost, left, group, False, p1, p2, False),
            lambda: pk.scan16_plain(cost, left, group, False, p1, p2, False),
            # cost and image in, the uint16 sum out; 3 directions of ~10
            # operations per element, two elements to an operation.  Its
            # dependent chain (P1 chain3, the "scan16" ladder) is a floor the
            # card's rates do not count
            bound(vol + b * h * w + 2 * vol, 3 * 5 * vol), None),
    }
    for name, (fn, plain, bnd, library) in timed.items():
        out[name].update(bnd, ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain, 1),
                         library_ms=cuda_ms(library, 20) if library else None)
    return out


def probe_phase() -> tuple:
    """(per-kernel records, launch counts of the probe path's run)."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.probes import (
        aggr_transpose, int16_recurrence, recurrence_floor)

    probe_kernel_checks(PROBE_OFF, full=False)
    records = probe_kernel_checks(PROBE, full=True)
    kernels.reset_launch_counts()
    docs = [probe.run(device="cuda", reps=5, **PROBE)
            for probe in (recurrence_floor, aggr_transpose, int16_recurrence)]
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in PROBE_PATH}
    missing = [name for name in PROBE_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"probe path launched no {missing}")
    for probe, doc in zip((recurrence_floor, aggr_transpose, int16_recurrence),
                          docs):
        print(f"probe {doc['probe']} ({doc['card']}, {doc['power_limit']}; "
              f"B={doc['batch']} {doc['h']}x{doc['w']} D={doc['d']}, ms per "
              f"frame = ms per launch / B):")
        print(probe.report(doc))
    scan16_ladder()
    return records, launches


def in_turns(fns: dict, reps: int) -> dict:
    """{name: median ms}: each timed twice in the order a, b, ..., b, a and
    the two medians averaged."""
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(cuda_ms(fns[name], reps))
    return {name: sum(v) / len(v) for name, v in times.items()}


def scan16_ladder() -> None:
    """Print ``scan16`` beside the group scan (``prod3``) and the chain
    floor (``chain3``, three directions of H dependent steps) per launch
    group at cone B=2, 8, 32 and 1000x1500 D=256 B=1, in turns."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.probes import pair_and_cost
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    rolls = (0, 1, -1)
    shapes = [dict(CONE, batch=b) for b in (2, 8, 32)] + [MIDDLEBURY_HALF]
    for cfg in shapes:
        b, h, w, dmax = cfg["batch"], cfg["h"], cfg["w"], cfg["dmax"]
        opt, left, _, cost = pair_and_cost(torch.device("cuda"), b, h, w, dmax)
        p1, p2 = opt.p1, opt.p2_init
        max_abs_err(pk.scan16(cost, left, rolls, False, p1, p2, False),
                    kernels.directional_scan_group(cost, left, None, rolls,
                                                   False, p1, p2, False))
        x = torch.zeros((b, dmax, w), dtype=torch.uint16, device=cost.device)
        ms = in_turns({
            "scan16": lambda: pk.scan16(cost, left, rolls, False, p1, p2,
                                        False),
            "prod3": lambda: kernels.directional_scan_group(
                cost, left, None, rolls, False, p1, p2, False),
            "chain3": lambda: pk.chain(x, h, rolls, p1),
            # one diagonal alone: one launch of each kernel at every shape
            "scan16 (1,)": lambda: pk.scan16(cost, left, (1,), False, p1, p2,
                                             False),
            "group scan (1,)": lambda: kernels.directional_scan_group(
                cost, left, None, (1,), False, p1, p2, False)}, 5)
        launches = -(-len(rolls) // pk.scan16_capacity(cost))
        print(f"scan16 ladder, {h}x{w} D={dmax} B={b} (ms per launch group, "
              f"in turns): scan16 {ms['scan16']:.4f} ({launches} launch"
              f"{'es' if launches > 1 else ''}), prod3 {ms['prod3']:.4f}, "
              f"chain3 {ms['chain3']:.4f}; scan16 / prod3 "
              f"{ms['scan16'] / ms['prod3']:.3f}; one diagonal: scan16 "
              f"{ms['scan16 (1,)']:.4f}, group scan "
              f"{ms['group scan (1,)']:.4f}; bit-equal")
        del cost, left, x
        torch.cuda.empty_cache()


def speckle_ladder() -> None:
    """Print S1 in every mode beside K4 whole and K4's label stage on the
    engine's pre-speckle disparity at cone B=2, 8, 32 and 1000x1500 D=256
    B=1, S1's labels held equal to K4's first."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.probes import (
        prespeckle_disparity)
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    shapes = [dict(CONE, batch=b) for b in (2, 8, 32)] + [MIDDLEBURY_HALF]
    for cfg in shapes:
        b, h, w = cfg["batch"], cfg["h"], cfg["w"]
        opt, disp = prespeckle_disparity(torch.device("cuda"), b, h, w,
                                         cfg["dmax"])
        area = opt.min_speckle_area
        labels, rounds = pk.speckle_labels(disp, 1.0, "base")
        max_abs_err(labels, pk.flat_to_root_labels(
            kernels.union_find_labels(disp, 1.0)))
        modes = [m for m in pk.LABEL_MODES
                 if m != "block4" or b % pk.BLOCK_FRAMES == 0]
        fns = {m: (lambda m=m: pk.speckle_labels(disp, 1.0, m)) for m in modes}
        fns["K4 labels"] = lambda: kernels.union_find_labels(disp, 1.0)
        fns["K4"] = lambda: kernels.remove_speckles(disp, 1.0, area)
        ms = in_turns(fns, 10)
        print(f"S1 ladder, {h}x{w} B={b} (ms per launch, in turns; base "
              f"rounds up to {int(rounds.max())}): " + ", ".join(
                  f"{name} {t:.4f}" for name, t in ms.items()))
        del disp, labels
        torch.cuda.empty_cache()


def s4_ladder() -> None:
    """Hold S4 in both modes bit-equal to its plain version and to S2 ->
    ``root_small`` -> S3 at cone B=2, 8, 32 and 1000x1500 D=256 B=1, one
    launch a call; print its device time beside its byte bound, K4's tail
    and the two-launch tail."""
    import torch

    from soc_project_stereo_matching_tpu_torch.kernel_ab import kernel_ms
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.probes import (
        prespeckle_disparity)
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    shapes = [dict(CONE, batch=b) for b in (2, 8, 32)] + [MIDDLEBURY_HALF]
    for cfg in shapes:
        b, h, w = cfg["batch"], cfg["h"], cfg["w"]
        opt, disp = prespeckle_disparity(torch.device("cuda"), b, h, w,
                                         cfg["dmax"])
        area = opt.min_speckle_area
        labels, _ = pk.speckle_labels(disp, 1.0, "base")
        grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area)

        def two_launch():
            counts = pk.speckle_hist(grouped, h_hist, lo_bits)
            return pk.speckle_verdict(grouped, pk.root_small(counts, area))

        want = pk.speckle_tail_fused_plain(grouped, area, h_hist, lo_bits)
        max_abs_err(two_launch(), want)
        for aggregate in (True, False):
            before = kernels.LAUNCHES["probe_speckle_fused"]
            max_abs_err(pk.speckle_tail_fused(grouped, area, h_hist, lo_bits,
                                              aggregate), want)
            torch.cuda.synchronize()
            if kernels.LAUNCHES["probe_speckle_fused"] != before + 1:
                raise AssertionError("S4 did not count one launch a call")
        flat = kernels.union_find_labels(disp, 1.0)
        device = {name: sum(kernel_ms(fn).values()) for name, fn in {
            "S4": lambda: pk.speckle_tail_fused(grouped, area, h_hist,
                                                lo_bits),
            "S4 one add a pixel": lambda: pk.speckle_tail_fused(
                grouped, area, h_hist, lo_bits, aggregate=False),
            "K4's tail": lambda: kernels.count_verdict(disp, flat, area),
            "S2 -> root_small -> S3": two_launch}.items()}
        nbytes = 8 * grouped.numel()    # the labels in, the verdict out
        bnd = bound(nbytes, 5 * grouped.numel())["bound_ms"]
        share = (f"{100 * bnd / device['S4']:.0f}%" if device["S4"]
                 else "not measured")
        plan = pk.speckle_tail_plan(b, grouped[0].numel())
        print(f"S4 ladder, {h}x{w} B={b} (device ms a call, torch.profiler; "
              f"{plan['rounds']} round(s) of {plan['blocks']} blocks): "
              + ", ".join(f"{name} {t:.4f}" for name, t in device.items())
              + f"; S4's bound {bnd:.5f} ms ({nbytes} bytes), {share} of "
              f"it; bit-equal in both modes")
        del disp, labels, grouped, want, flat
        torch.cuda.empty_cache()


def hard_frames(b: int, h: int, w: int, area: int):
    """f32 (b, h, w) hand-made speckle inputs on the card (b >= 4): frame 0
    noise with a full-height line and components of exactly ``area`` and
    ``area - 1`` pixels, frame 1 a plateau with NaN and -inf pixels, frame 2
    a ramp (one component), the rest without a finite pixel."""
    import torch

    g = torch.Generator().manual_seed(9)
    d = torch.full((b, h, w), float("inf"))
    d[0] = torch.randint(0, 6, (h, w), generator=g).float()
    d[0][torch.rand((h, w), generator=g) < 0.55] = float("inf")
    d[0, :, 9:12] = float("inf")
    d[0, :, 10] = 3.0
    r0, c0 = h // 2, w // 2
    d[0, r0 - 1:r0 + 2, c0 - 1:c0 + area + 1] = float("inf")
    d[0, r0, c0:c0 + area] = 3.0                    # exactly area: kept
    d[0, r0 + 3:r0 + 6, c0 - 1:c0 + area] = float("inf")
    d[0, r0 + 4, c0:c0 + area - 1] = 3.0            # area - 1: removed
    d[1] = 2.0
    d[1, 5:9, 5:9] = float("nan")
    d[1, h // 2, :] = float("-inf")
    d[1, h - 6:h - 3, 3:6] = float("inf")
    d[1, h - 5, 4] = 7.0
    d[2] = torch.arange(h)[:, None] * 0.5 + torch.arange(w)[None, :] * 0.25
    return d.cuda()


def check_speckle_input(disp, area: int) -> dict:
    """S1-S4 and K4's stage entries on one input vs their plain versions and
    each other; returns {"labels", "grouped", "h_hist", "lo_bits", "small",
    "rounds", "err"}, ``err`` the largest measured difference per kernel."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels, postprocess
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk
    from soc_project_stereo_matching_tpu_torch.probes.speckle import EXACT

    _, h, w = disp.shape
    labels, rounds = {}, {}
    err = dict.fromkeys(SPECKLE_PATH, 0.0)

    def hold(name, got, want):
        err[name] = max(err[name], max_abs_err(got, want))

    s1, s2, s3, s4 = SPECKLE_PATH
    for mode in pk.LABEL_MODES:
        labels[mode], rounds[mode] = pk.speckle_labels(disp, 1.0, mode)
        want, want_rounds = pk.speckle_labels_plain(disp, 1.0, mode)
        hold(s1, labels[mode], want)
        hold(s1, rounds[mode], want_rounds)
    for mode in EXACT:
        hold(s1, labels[mode], labels["base"])
    hold(s1, rounds["pyr"], rounds["base"])
    before = kernels.LAUNCHES["remove_speckles"]
    flat = kernels.union_find_labels(disp, 1.0)      # K4's label stage
    max_abs_err(flat, kernels.union_find_labels_plain(disp, 1.0))
    hold(s1, pk.flat_to_root_labels(flat), labels["base"])

    grouped, h_hist, lo_bits = pk.group_labels(disp, labels["base"], area)
    counts = pk.speckle_hist(grouped, h_hist, lo_bits)
    hold(s2, counts, pk.speckle_hist_plain(grouped, h_hist, lo_bits))
    hold(s2, pk.speckle_hist(grouped, h_hist, lo_bits, False), counts)
    small = pk.root_small(counts, area)
    verdict = pk.speckle_verdict(grouped, small)
    hold(s3, verdict, pk.speckle_verdict_plain(grouped, small))
    hold(s4, pk.speckle_tail_fused_plain(grouped, area, h_hist, lo_bits),
         verdict)
    for aggregate in (False, True):
        hold(s4, pk.speckle_tail_fused(grouped, area, h_hist, lo_bits,
                                       aggregate), verdict)
    got = pk.apply_verdict(disp, pk.ungroup_verdict(verdict, h, w))
    hold(s3, got, kernels.remove_speckles(disp, 1.0, area))
    hold(s3, got, postprocess.remove_speckles(disp, 1.0, area))
    max_abs_err(kernels.count_verdict(disp, flat, area), got)  # its tail
    torch.cuda.synchronize()
    # the label stage, the tail and K4 whole: one count per C entry call
    if kernels.LAUNCHES["remove_speckles"] != before + 3:
        raise AssertionError("K4's entries did not count one launch each")
    return {"labels": labels["base"], "grouped": grouped, "h_hist": h_hist,
            "lo_bits": lo_bits, "small": small, "rounds": rounds["base"],
            "err": err}


def speckle_kernel_checks(cfg, full: bool) -> dict:
    """S1-S4 at one geometry, on the engine's pre-speckle disparity and on
    the hand-made frames.  With ``full`` (the cone pair) also the times for
    the kernels line."""
    import torch

    from soc_project_stereo_matching_tpu_torch.probes import (
        prespeckle_disparity)
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    b, h, w, area = cfg["batch"], cfg["h"], cfg["w"], cfg["min_area"]
    _, disp = prespeckle_disparity(torch.device("cuda"), b, h, w, cfg["dmax"])
    hard = check_speckle_input(hard_frames(b, h, w, area), area)
    # frame 0 holds a component of min_area - 1 pixels: the verdict is not empty
    if not bool(hard["small"][0].any()) or bool(hard["small"][3:].any()):
        raise AssertionError("hand-made frames: unexpected root_small")
    real = check_speckle_input(disp, area)
    out = {name: {"max_abs_err": max(hard["err"][name], real["err"][name])}
           for name in SPECKLE_PATH}
    if not full:
        return out

    grouped, h_hist, lo_bits, small = (real[k] for k in (
        "grouped", "h_hist", "lo_bits", "small"))
    px, grp, size = b * h * w, grouped.numel(), h_hist << lo_bits
    valid, idx = pk.label_index(grouped, size)
    idx = idx + torch.arange(b, device=idx.device)[:, None] * size
    counted = idx[valid]

    def verdict_library():
        """S3's function by PyTorch calls alone, everything inside the timed
        call: the range test, the int64 index, one gather, f32 0/1 of the
        labels' shape, 0 for a label outside the root plane."""
        lab = grouped.reshape(b, -1)
        inside = (lab >= 0) & (lab < size)
        hit = small.reshape(b, size).gather(
            1, lab.clamp(0, size - 1).to(torch.int64)) != 0
        return (inside & hit).to(torch.float32).reshape(grouped.shape)

    max_abs_err(verdict_library(), pk.speckle_verdict_plain(grouped, small))
    timed = {
        "probe_speckle_labels": (
            lambda: pk.speckle_labels(disp, 1.0, "base"),
            lambda: pk.speckle_labels_plain(disp, 1.0, "base"),
            # the disparity in, the labels out; per pixel and round about 20
            # operations, for the rounds this input's frames ran: that count
            # is the propagation's own, not the least any labelling needs.
            # Neither bounds it: a round pair is 4 steps between cluster
            # barriers, each a chain of dependent trips to the L2 and to
            # shared memory
            bound(8 * px, 20 * h * w * int(real["rounds"].sum())), None),
        "probe_speckle_hist": (
            lambda: pk.speckle_hist(grouped, h_hist, lo_bits),
            lambda: pk.speckle_hist_plain(grouped, h_hist, lo_bits),
            # the labels in, the root plane out; a compare and an add
            bound(4 * grp + 4 * b * size, 2 * grp),
            lambda: torch.bincount(counted, minlength=b * size)),
        "probe_speckle_verdict": (
            lambda: pk.speckle_verdict(grouped, small),
            lambda: pk.speckle_verdict_plain(grouped, small),
            # the labels in, the verdict out; of the int8 root plane only the
            # entries that labels point at are read, which is not counted
            bound(8 * grp, 2 * grp), verdict_library),
        "probe_speckle_fused": (
            lambda: pk.speckle_tail_fused(grouped, area, h_hist, lo_bits),
            lambda: pk.speckle_tail_fused_plain(grouped, area, h_hist, lo_bits),
            # the labels in, the verdict out; the counts (a zero and an add
            # per distinct label of a block) stay in the L2
            bound(8 * grp, 5 * grp), None),
    }
    for name, (fn, plain, bnd, library) in timed.items():
        out[name].update(bnd, ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain, 3),
                         library_ms=cuda_ms(library, 20) if library else None)
    control = cuda_ms(lambda: pk.speckle_hist(grouped, h_hist, lo_bits, False),
                      20)
    print(f"S2 speckle_hist, B={b} {h}x{w}: merged (the default) "
          f"{out['probe_speckle_hist']['ms']:.4f} ms a call, one add a pixel "
          f"(the control) {control:.4f}")
    return out


def speckle_phase() -> tuple:
    """(per-kernel records, launch counts of the two speckle probes' run)."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.probes import (speckle,
                                                              speckle_tail)

    off = speckle_kernel_checks(SPECKLE_OFF, full=False)
    records = speckle_kernel_checks(SPECKLE, full=True)
    for name in SPECKLE_PATH:
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           off[name]["max_abs_err"])
    kernels.reset_launch_counts()
    docs = [probe.run(device="cuda", reps=5, **PROBE)
            for probe in (speckle, speckle_tail)]
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in SPECKLE_PATH}
    missing = [name for name in SPECKLE_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"speckle probe path launched no {missing}")
    for probe, doc in zip((speckle, speckle_tail), docs):
        print(f"probe {doc['probe']} ({doc['card']}, {doc['power_limit']}; "
              f"B={doc['batch']} {doc['h']}x{doc['w']} D={doc['d']}, ms per "
              f"frame = ms per launch / B):")
        print(probe.report(doc))
    speckle_ladder()
    s4_ladder()
    return records, launches


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", file=sys.stderr)

    from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions, _build
    from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    # 3. per kernel
    check_kernels(OFF, timed=False)
    cone = check_kernels(CONE, timed=True)
    for name, rec in cone.items():
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
              f"(cone B=2 375x450 D=64, bit-equal)")
    print(f"the horizontal pair by the first design's two launches along W: "
          f"{cone['horizontal_partial']['first_design_ms']:.4f} ms")

    # 4. slice
    engine = SGMEngine(SGMOptions(), device="cuda")
    left, right, field = pair(CONE, batch=SLICE_BATCH, seed=1)
    kernels.reset_launch_counts()
    disp = engine.match_batch(left, right)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in MAIN_PATH}
    missing = [name for name in MAIN_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    scans = {name: launches[name] for name in SCAN_LAUNCHES}
    if launches != MAIN_LAUNCHES:
        raise AssertionError(f"main path launched {launches}, want "
                             f"{MAIN_LAUNCHES}")
    if not (disp.is_cuda and disp.dtype == torch.float32
            and disp.shape == left.shape):
        raise AssertionError(f"bad output {disp.dtype} {tuple(disp.shape)} "
                             f"on {disp.device}")
    max_abs_err(disp, sgm_forward(left, right, SGMOptions(), use_kernels=False))
    ch, cw = CROP
    crop_l, crop_r = left[0, :ch, :cw].cpu().numpy(), right[0, :ch, :cw].cpu().numpy()
    max_abs_err(engine.match(crop_l, crop_r).cpu(),
                SGMEngine(SGMOptions(), device="cpu").match(crop_l, crop_r))
    valid = torch.isfinite(disp)
    finite = valid.float().mean().item()
    if not 0.5 < finite < 1.0:
        raise AssertionError(f"finite fraction {finite} is not plausible")
    good = ((disp - field).abs() <= 1.0)[valid].float().mean().item()
    if good < MIN_GOOD:
        raise AssertionError(f"only {good} of the finite pixels lie within 1 "
                             f"of the true disparity (want >= {MIN_GOOD})")
    big_l, big_r, _ = pair(CONE, batch=FPS_BATCH, seed=2)
    ms = cuda_ms(lambda: engine.match_batch(big_l, big_r), 5)
    print(f"slice: bit-equal to the plain path (B={SLICE_BATCH}) and to the "
          f"CPU engine ({ch}x{cw} crop); finite fraction {finite:.4f}, "
          f"{good:.4f} of them within 1 of the truth; K2 scan launches "
          f"{scans}; "
          f"B={FPS_BATCH}: {ms:.3f} ms/batch = {FPS_BATCH / ms * 1e3:.2f} frames/s")
    scan_ladder()
    k1_k4_ladder()
    wta_ladder()

    # 5. tile phase
    check_tile_kernels(MIDDLEBURY_HALF, timed=False)
    cone.update(check_tile_kernels(TILE_CONE, timed=True))
    for name in TILE_PATH:
        rec = cone[name]
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms (one cone tile, B=2 125x450 D=64, bit-equal; also at "
              f"1000x1500 D=256 K=4)")
    launches.update(tile_engine_phase())
    if torch.cuda.device_count() >= 2:
        from soc_project_stereo_matching_tpu_torch.parallel.dryrun import (
            dryrun_multichip)

        dryrun_multichip(2, device="cuda")
    else:
        print("tile phase, multi-card: not run: one CUDA device "
              "(dryrun_multichip(2) needs two)")

    # 6. probe phase
    records, probe_launches = probe_phase()
    cone.update(records)
    launches.update(probe_launches)
    for name in PROBE_PATH + ("volume_transpose",):
        rec = cone[name]
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms (cone B={PROBE['batch']} 375x450 D=64, bit-equal; also at "
              f"37x45 D=48)")

    # 7. speckle probe phase
    records, speckle_launches = speckle_phase()
    cone.update(records)
    launches.update(speckle_launches)
    for name in SPECKLE_PATH:
        rec = cone[name]
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms (cone B={SPECKLE['batch']} 375x450, min_area 50, bit-equal; "
              f"also at 37x45 B=4 and on hand-made frames)")

    # 8. results
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name],
         **{key: cone[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for name, (src, replaces) in KERNELS.items()]}))
    jax_pkg = "soc_project_stereo_matching_tpu"
    leaked = sorted(m for m in sys.modules
                    if m.startswith("jax") or m == jax_pkg
                    or m.startswith(jax_pkg + "."))
    if leaked:
        raise AssertionError(f"imported {leaked}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
