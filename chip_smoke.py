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
   scan of the vertical pair is the group kernel (a two-order scan: two
   launches, each with both orders on clusters of their own, meeting at
   the middle row; the epilogue's reduction in warps of its own); the
   horizontal pair's, on the transposed volume, the path scan
   (``horizontal_paths``, csrc/path_scan.cu: both orders in one launch,
   held against the plain two-order scan and the group kernel's):
   ``aggregate_paths`` is also held against the sum of the first design's
   launches (``scan_direction``, one per direction), and the horizontal
   pair against that design's two launches along W.  The fused forms: the
   main path's ``aggregate_paths_wta`` (the two-order scan with the WTA
   epilogue),
   ``directional_scan_group_bidir`` (both forms; the parked sums too) and
   the group launch with the epilogue (``directional_scan_group(wta=...)``,
   the last launch of the two-launch route) against their plain versions
   and against ``wta_reduce`` of ``aggregate_paths``, both views, every mode;
4. slice: ``SGMEngine(SGMOptions(), device="cuda").match_batch`` on a B=8
   synthetic 375x450 pair, with every launch counter reset before and read
   after (the K2 scans must count the two launches of the vertical pair's
   two-order scan with the WTA epilogue, the horizontal pair's path scan
   and 3 transposes, and no ``wta_reduce``: no aggregated volume is
   stored; past D = 512 the pair takes the group kernel's two launches,
   ``past_paths_range``); the result must be
   bit-equal to the plain path on the
   card, a 96x160 crop bit-equal to the same engine on the CPU (the plain
   ops, which the CPU tests hold bit-equal to the JAX package and its numpy
   oracle), and most finite pixels within 1 of the pair's true disparity;
   frames/s at B=32; the two-launch route (the horizontal pair, the forward
   group, the reverse group with the epilogue) as a path of its own at
   cone B=8, counters reset before and read after, its planes equal to the
   main path's; the K2 scan times per group at cone B=2, 8 and 32
   and at 1000x1500 D=256 B=1, beside the first design's; the launches of
   every main-path entry per ``match_batch`` are asserted (K1, the fused
   K2, K3 and K4 once each); K1 and K4 at the same four shapes (K1 at
   1000x1500 also in the halo mode) and the WTA (both views, on the volume
   ``aggregate_paths`` makes), each bit-equal to its plain version, with
   its time beside its bound; beside the WTA, ``amin`` over D of the same
   volume, a PyTorch call that reads it once (a read floor, not the same
   function); the "WTA fused" line per shape: the vertical pair's two-order
   scan with the epilogue beside the parent's form (two group launches
   and ``wta_reduce``), bit-equal, in turns, with its byte bound; the
   "two-order horizontal" line: the horizontal pair's two-order scan on the
   transposed volume beside two one-order group launches, bit-equal, in
   turns;
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
      before, read after: the one-tile branch's vertical pair is one
      two-order scan, then ``wta_reduce`` of the stored volume) bit-equal
      to the untiled kernel engine, and the frame time of both; all three
      tile modes at cone B=8 bit-equal too; the exact schedule's carried
      scans over the cone's K=3 tiles on the one card (counters reset
      before, read after), equal to the untiled two-order scan;
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
8. surfaces phase (the user-facing modules over the engine, each path with
   the launch counters reset just before and read just after; each must
   have made the main path's launches for every engine call it made):
   a. KITTI-2015 batched eval: 8 seeded synthetic frames at 1242x375 written
      as a KITTI-2015 layout (ground truth uint16 x256, 0 in the top 100
      rows), through ``cli eval --batched --batch-size 8 --device cuda``.
      Every measurement must equal what this script computes from
      ``SGMEngine(SGMOptions(max_disparity=192)).match_batch`` of the same
      frames and ``eval.metrics``; on a 96x320 crop of two frames the card
      harness must equal ``EvaluationHarness(device="cpu")``; disp_bad3 at
      most ``BAD3_MAX``; the harness's frames/s and the batch's ms;
   b. the reference wire protocol: ``CompatServer`` on 127.0.0.1 at
      1280x720 over a Middlebury-2014 layout of 3 frames written by
      ``data/convert``, ``run_client`` with an ``SGMEngine(max_disparity=64)``
      on the card; the server's stats must count 3 frames with rmse / bpr /
      n_valid equal to the script's, one frame's disparity bit-equal to the
      plain path; the loopback frames/s and ms a frame;
   c. ``cli match`` on a cone-size PNG pair: its PNG must equal
      ``save_disparity_png`` of the engine's result;
9. benches phase (the measurement tools of ``bench.py`` and ``benches/``,
   each run with the launch counters reset just before it and read just
   after; each must have made the main path's launches, or for the tiled
   cell the tiled path's, for every engine call it reports, plus its
   diagnostics' own):
   a. ``bench.main()`` at its cell (cone B=32, 10 batches a window, 5
      repeats): exactly one stdout line with ``bench.py``'s keys and a
      value, printed here; its median batch (a call at a time) within
      ``AGREE`` of ``stage_breakdown.batch_and_enqueue``'s on the same
      inputs (the same timer, run again), of the device range of the
      program's ``sgm.match`` span (``stage_breakdown.stage_times``) and of
      the bench's own window; a
      forced failure (``bench.report`` at D = 16,385, past the JAX
      package's bound; a row wider than one K1 block now runs) prints one
      line with ``value: null`` and an ``error`` and returns 1;
   b. the four cells of ``benches.big_configs`` (``BIG_ITERS`` batches a
      window), each with at least 0.95 of its finite pixels within 1 of the
      truth, the tiled Middlebury-half cell bit-equal to the untiled one;
   c. ``benches.streaming`` over ``STREAM_BATCHES`` batches, its three
      loops' disparities equal;
   d. ``benches.loopback`` over 3 frames for each client;
   e. ``benches.scaling`` on the cards present (sizes beyond them print a
      "not run" line), each size bit-equal to the single-rank engine, each
      rank's timed steps making the tiled path's launches;
10. wide range phase (disparity ranges above 256 and rows over several
   clusters an image; about 35 s): every mode of ``sgm_scan_group`` (one
   order stored and added, carries, the epilogue, the two-order scan's two
   forms), the WTA kernel, K1 (both modes), K3, K4 and ``match_batch`` (its
   launches counted) bit-equal to their plain versions at D = 257, 384 and
   1024 (``WIDE_KERNELS``), at rows where no cluster holds the state (the
   vertical pair's plan printed: G clusters an image, in waves); the
   engine through ``SGMEngine.match`` on full-size frames (``WIDE_FRAMES``:
   1500x1000 D=380, 2964x1988 D=280 and D=760), each bit-equal to the
   tiled engine on a 1x1 mesh in exact mode, 0.95 of its finite pixels
   within 1 of the truth, its launches counted, its ms and peak device
   memory printed; at 2964x1988 D=760 each K2 form and the WTA timed with
   its calls, plan and bound (kernel table rows 2, 2c, 2w, 3p/3, 3w, 4); one
   ``cli eval --device cuda`` through a Middlebury-2014 folder written at
   2964x1988 with ``ndisp=280``, its measurement equal to the script's;
11. the shapes where the port once refused and the JAX package
   computes (about 30 s): K1 in segments (rows of 9,000, 20,000 and 40,000
   columns at D = 64, dmin 24, untiled and in halo mode; 7,000 columns at
   D = 16,384), the WTA at 32,769 and 70,000 columns (both views, dmin 0
   and 24), every mode of ``sgm_scan_group`` at D = 2,516, 4,096 and
   16,384 (the plan splits D over a cluster's blocks), each bit-equal to
   its plain version, K1's and the WTA's times beside their bounds;
   ``SGMEngine.match_batch`` at 256x512 D=4096 and at 20000x48 D=64, each
   bit-equal to the plain path with its launches counted, the long frame
   also through the tiled engine on a 1x1 mesh, bit-equal; phase 10's
   full-size frames again, untiled bit-equal to tiled; the K2 forms and
   the WTA at the D = 4,096 frame with their calls, plans and bounds.
   Rows wider than the card holds at once, which the group scan takes in
   column parts with halo columns (``kernels.group_route``):
   every mode of ``sgm_scan_group`` bit-equal to its plain version at one
   row past each resident width of ``group_capacity``'s docstring (D = 64
   to 16,384, 3-8 rows; the plan's parts asserted), at a shape whose plan
   takes chunks of rows with carries (D = 16,384, 240 columns, 120 rows),
   and at the two shapes once refused before a launch (D = 2,000 at 30,000
   columns, D = 16,384 at 2,000); the horizontal pair at D = 16,384 on a
   transposed row of 240; the WTA's split window (70,000 columns, D = 64,
   dmin = 60,000); ``SGMEngine.match`` on a satellite strip of 36,000 x
   512 at D = 256 (two parts; its launches counted, 0.95 of the finite
   pixels within 1 of the truth, its time) and the K2 forms and the WTA at
   its shape beside their bounds; full-resolution Middlebury-2014
   (2964x1988, D = 280) with both pairs forced into 2 and 4 parts,
   bit-equal to the resident route;
12. the per-kernel JSON line (each kernel's time beside its plain version's,
   its bound from this run's shapes and, where one PyTorch call computes the
   same function, that call's time; its launches from the path that runs
   it: the main path, the tiled engine, the chained tiles, the two-launch
   route, the probes, or for ``aggregate_paths`` the bench's aggregation
   diagnostic), then the contract line ``{"ok": true, "device": {...}}``
   last.

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
PALLAS = "soc_project_stereo_matching_tpu/ops/pallas_kernels.py"
CSRC = "soc_project_stereo_matching_tpu_torch/csrc"
KERNELS = {  # counter -> (source, Pallas kernel it replaces)
    "census_cost_volume": (f"{CSRC}/census_cost.cu", f"{PALLAS}:1619"),
    # the two-order launch (_bidir_kernel): the vertical pair with the WTA
    # epilogue (the main path), without it (aggregate_paths, the tiled
    # path's local mode), and the horizontal pair
    "aggregate_paths_wta": (f"{CSRC}/aggregate.cu", f"{PALLAS}:500"),
    "aggregate_paths": (f"{CSRC}/aggregate.cu", f"{PALLAS}:500"),
    "horizontal_partial": (f"{CSRC}/aggregate.cu", f"{PALLAS}:500"),
    # the horizontal pair up to D = 512: the path scan (_bidir_kernel for
    # the roll-0 pair), one launch carrying both orders
    "horizontal_paths": (f"{CSRC}/path_scan.cu", f"{PALLAS}:500"),
    "volume_transpose": (f"{CSRC}/transpose.cu",
                         "scripts/aggr_transpose_probe.py:176"),
    "wta_reduce": (f"{CSRC}/wta.cu", f"{PALLAS}:1073"),
    "lr_check": (f"{CSRC}/lr_check.cu", f"{PALLAS}:1754"),
    "remove_speckles": (f"{CSRC}/speckle.cu", f"{PALLAS}:1306"),
    # the tiled path's modes: mask_rows=False, the cin_*/cout_* refs (the
    # carried scans of 2+ tiles), the two-order launch of the one-tile and
    # local modes
    "census_cost_volume_halo": (f"{CSRC}/census_cost.cu", f"{PALLAS}:1619"),
    "directional_scan_group": (f"{CSRC}/aggregate.cu", f"{PALLAS}:178"),
    "directional_scan_group_bidir": (f"{CSRC}/aggregate.cu", f"{PALLAS}:500"),
    # the group kernel's WTA epilogue (_scan_group_kernel with wta), the
    # last launch of the two-launch route
    "directional_scan_group_wta": (f"{CSRC}/aggregate.cu", f"{PALLAS}:178"),
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
MAIN_PATH = ("census_cost_volume", "aggregate_paths_wta", "horizontal_paths",
             "volume_transpose", "lr_check", "remove_speckles")
# launches of the K2 scans per match_batch: the vertical pair's two-order
# scan with the WTA epilogue (two launches meeting at the middle row; no
# volume stored, no WTA launch), the horizontal pair's path scan (one
# launch) and the three transposes around it
SCAN_LAUNCHES = {"aggregate_paths_wta": 2, "horizontal_paths": 1,
                 "volume_transpose": 3}
# ... and per aggregate_paths call (the vertical pair's scan without it)
AGGREGATE_LAUNCHES = {"aggregate_paths": 2, "horizontal_paths": 1,
                      "volume_transpose": 3}
# C entry calls per match_batch of every main-path wrapper: one each for K1,
# K3 and K4 (whose entry makes its four launches); wta_reduce none
MAIN_LAUNCHES = {"census_cost_volume": 1, **SCAN_LAUNCHES, "lr_check": 1,
                 "remove_speckles": 1}
# the tiled engine on a 1x1 mesh: the halo census, the vertical pair's
# two-order scan, the stored volume's WTA
TILE_PATH = ("census_cost_volume_halo", "directional_scan_group_bidir",
             "wta_reduce")
# the two-launch route (the JAX package's aggregate_paths_wta without its
# bidir kernel): the horizontal pair, the forward group, the reverse group
# with the WTA epilogue
TWO_LAUNCH_PATH = ("directional_scan_group", "directional_scan_group_wta")
PROBE_PATH = ("probe_chain", "probe_chainio", "probe_int16")
SPECKLE_PATH = ("probe_speckle_labels", "probe_speckle_hist",
                "probe_speckle_verdict", "probe_speckle_fused")
# the surfaces: the KITTI-2015 batched eval (BASELINE.json:9; the loader's
# range, D = 192), its ground truth unknown in the top rows as KITTI's is
# where the LiDAR has no return; the rows and columns of the crop that the
# CPU harness also scores; the firmware's 720p frame at D = 64 over the
# wire protocol; the cone-size pair of ``cli match``
KITTI = dict(batch=8, h=375, w=1242, dmax=192, levels=(20, 40, 70, 110, 150),
             unknown_rows=100)
KITTI_CROP = (slice(150, 246), slice(400, 720))
# disp_bad3 (KITTI's D1: pixels with ground truth off by more than 3) at
# most 1 - MIN_GOOD: the slice's rule puts 0.95 of the finite pixels within
# 1 of the truth, so at most 0.05 are off by more than 1, let alone 3
BAD3_MAX = 1.0 - MIN_GOOD
WIRE = dict(frames=3, h=720, w=1280, dmax=64, levels=(8, 16, 28, 45))
# the benches: launches per tiled match_batch on a 1x1 mesh or a data-parallel
# mesh (the halo census, the horizontal pair and its transposes, one launch a
# vertical group, the WTA, K3 and K4); the bench's median batch against
# stage_breakdown's, at most this far apart; the benches' shortened runs
TILED_LAUNCHES = {"census_cost_volume_halo": 1, "horizontal_paths": 1,
                  "volume_transpose": 3, "directional_scan_group_bidir": 2,
                  "wta_reduce": 1, "lr_check": 1, "remove_speckles": 1}
AGREE = 0.10
BIG_ITERS, STREAM_BATCHES, LOOP_FRAMES = 2, 8, 3
# phase 10: disparity ranges above 256 and rows over several clusters.  The
# kernels at shapes the plain versions still run quickly but wide enough that
# no cluster holds a row's state, so an image takes G >= 2 clusters (the
# last one in waves: the card does not hold all the images' clusters at
# once); the engine on full-size frames (Middlebury-2014 at half and at full
# resolution, with the range of the widest published half-size scene and of
# the repo's own full-size calibration, and Vintage's full-size 760); one
# cli eval through a full-size Middlebury-2014 folder
WIDE_KERNELS = (dict(batch=1, h=5, d=257, w=3400), dict(batch=1, h=6, d=384, w=2400),
                dict(batch=2, h=48, d=1024, w=1800))
WIDE_FRAMES = (dict(batch=1, h=1000, w=1500, dmax=380, levels=(40, 130, 250, 350)),
               dict(batch=1, h=1988, w=2964, dmax=280, levels=(30, 100, 190, 260)),
               dict(batch=1, h=1988, w=2964, dmax=760, levels=(80, 300, 520, 720)))
WIDE_EVAL = dict(h=1988, w=2964, dmax=280, levels=(30, 100, 190, 260))
# the repo's full-size Middlebury-2014 calibration (tests/test_eval_platform.py)
MIDDLEBURY_FULL_CALIB = dict(fx=3997.684, baseline=193.001, doffs=131.111)
# phase 11: shapes the port once refused and the JAX package takes.
# K1 past the widest row one block holds (8,924 columns at D = 64), in
# segments (h, w, dmin, D); the WTA past the 32,768 columns it refused; the
# group scan past D = 2,515, where the plan splits D over a cluster's
# blocks; the engine at D = 4,096 and on a row of 20,000 columns
UNREFUSED_K1 = ((8, 9000, 24, 64), (4, 20000, 24, 64), (2, 40000, 24, 64),
                (2, 7000, 0, 16384))
UNREFUSED_WTA = ((4, 64, 32769), (2, 64, 70000))   # (h, D, w)
DEEP_KERNELS = (dict(batch=1, h=5, d=2516, w=96), dict(batch=2, h=4, d=4096, w=128),
                dict(batch=1, h=3, d=16384, w=40))
DEEP_FRAME = dict(batch=1, h=256, w=512, dmax=4096, levels=(30, 120, 260, 400))
LONG_FRAME = dict(batch=1, h=48, w=20000, dmax=64, levels=(10, 20, 35))
# rows wider than the card holds at once: one column past each
# resident width of kernels.group_capacity's docstring on an H100 80GB HBM3
# (D, W, S); a shape whose plan takes chunks of rows (2 S halo columns
# would pass a quarter of the 224 columns held at D = 16,384); the two
# shapes the group scan once refused before a launch; the horizontal pair
# at D = 16,384 on a transposed row of 240 (an image 240 rows tall, 6 wide)
PAST_RESIDENT = ((64, 103681, 3), (128, 50401, 3), (256, 24481, 4),
                 (280, 24553, 3), (760, 8449, 5), (1024, 6337, 3),
                 (2516, 2341, 3), (4096, 1381, 4), (16384, 225, 8))
CHUNKED = (16384, 240, 120)
ONCE_REFUSED = ((2000, 30000, 3), (16384, 2000, 3))
DEEP_PAIR = dict(d=16384, h=240, w=6)
SPLIT_WTA = (2, 64, 70000, 60000)     # (h, D, w, dmin): two staged windows
# a pushbroom satellite strip: 36,000 columns x 512 rows at D = 256, two
# column parts of the vertical pair; full-resolution Middlebury-2014 with
# both pairs forced into parts
SATELLITE = dict(batch=1, h=512, w=36000, dmax=256, levels=(30, 90, 160, 230))
FORCED_PARTS = (2, 4)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` runs, after
    one warm-up run."""
    from soc_project_stereo_matching_tpu_torch.utils.profiling import cuda_time

    return cuda_time(fn, reps)["median"]


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
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

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
    # the path scan alone on the transposed volume, against the plain
    # two-order scan and the group kernel's route; its least bytes: the
    # cost read once, half the uint16 sums stored and half read-added
    pitch = kernels.TRANSPOSED_PITCH
    cost_t = kernels.volume_transpose(cost, pad_to=pitch)
    left_t = kernels.image_transpose(left, pad_to=pitch)
    ps = lambda: kernels.horizontal_paths(cost_t, left_t, opt.p1, opt.p2_init)
    ps_plain = lambda: kernels.directional_scan_group_bidir_plain(
        cost_t, left_t, None, (0,), (0,), opt.p1, opt.p2_init, False)
    err = max(max_abs_err(ps(), ps_plain()), max_abs_err(ps(), kernels._bidir(
        cost_t, left_t, None, (0,), (0,), opt.p1, opt.p2_init, False, None,
        "horizontal_partial")))
    record("horizontal_paths", err, ps, ps_plain,
           4 * cost_t.numel() + left_t.numel(), 2 * 10 * cost_t.numel(),
           plain_reps=1)

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

    # The fused forms (csrc/aggregate.cu): the two-order launch with and
    # without the WTA epilogue, and the group launch with it, each against
    # its plain version (which transcribes the kernel's order of work) and
    # against the stored volume's WTA (the parent's form), in every mode.
    p1, p2 = opt.p1, opt.p2_init
    flat = lambda planes: [x for view in planes if view is not None
                           for x in view]
    err = {"aggregate_paths_wta": 0.0, "directional_scan_group_bidir": 0.0,
           "directional_scan_group_wta": 0.0}
    for o, mode in modes:
        restart = mode == "restart"
        (rf, _), (rb, _) = kernels.scan_groups(o.num_paths)
        for inverse in ((True,) if timed else (True, False)):
            got = kernels.aggregate_paths_wta(cost, left, o, mode, inverse)
            want = kernels.aggregate_paths_wta_plain(cost, left, o, mode,
                                                     inverse)
            err["aggregate_paths_wta"] = max(err["aggregate_paths_wta"],
                                             planes_err(flat(got), flat(want)))
            planes_err(flat(got), flat(kernels.wta_reduce(
                kernels.aggregate_paths(cost, left, o, mode), o, inverse)))
            part = kernels.horizontal_partial(cost, left, p1, p2, restart)
            wta_args = (o.min_disparity, inverse)
            parks = (part.clone(), part.clone())
            got = kernels.directional_scan_group_bidir(
                cost, left, parks[0], rf, rb, p1, p2, restart, wta_args)
            want = kernels.directional_scan_group_bidir_plain(
                cost, left, parks[1], rf, rb, p1, p2, restart, wta_args)
            err["directional_scan_group_bidir"] = max(
                err["directional_scan_group_bidir"],
                planes_err(flat(got), flat(want)), max_abs_err(*parks))
            # the two-launch route: the forward group, then the reverse group
            # with the epilogue
            fwd_part = kernels.directional_scan_group(cost, left, part.clone(),
                                                      rf, False, p1, p2, restart)
            got = kernels.directional_scan_group(cost, left, fwd_part, rb, True,
                                                 p1, p2, restart, wta=wta_args)
            want = kernels.directional_scan_group_plain(
                cost, left, fwd_part, rb, True, p1, p2, restart, wta=wta_args)
            err["directional_scan_group_wta"] = max(
                err["directional_scan_group_wta"],
                planes_err(flat(got), flat(want)))
            planes_err(flat(got), flat(kernels.wta_reduce(
                kernels.aggregate_paths(cost, left, o, mode), o, inverse)))
        # the volume form
        part = kernels.horizontal_partial(cost, left, p1, p2, restart)
        got = kernels.directional_scan_group_bidir(cost, left, part.clone(), rf,
                                                   rb, p1, p2, restart)
        err["directional_scan_group_bidir"] = max(
            err["directional_scan_group_bidir"],
            max_abs_err(got, kernels.directional_scan_group_bidir_plain(
                cost, left, part.clone(), rf, rb, p1, p2, restart)),
            max_abs_err(got, kernels.aggregate_paths(cost, left, o, mode)))
    part = kernels.horizontal_partial(cost, left, p1, p2, False)
    (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
    dmin = opt.min_disparity
    record("aggregate_paths_wta", err["aggregate_paths_wta"],
           lambda: kernels.aggregate_paths_wta(cost, left, opt),
           lambda: kernels.aggregate_paths_wta_plain(cost, left, opt),
           # cost and image in, 10 planes out; the 8 directions' steps and
           # the two views' compare and selects
           vol + px + 40 * px, 8 * 10 * vol + 2 * 3 * vol, plain_reps=1)
    record("directional_scan_group_bidir",
           err["directional_scan_group_bidir"],
           lambda: kernels.directional_scan_group_bidir(
               cost, left, part, rf, rb, p1, p2, False),
           lambda: kernels.directional_scan_group_bidir_plain(
               cost, left, part, rf, rb, p1, p2, False),
           # cost, image and the sums in, the sums out; 6 directions' steps
           vol + px + 2 * vol + 2 * vol, 6 * 10 * vol, plain_reps=1)
    record("directional_scan_group_wta", err["directional_scan_group_wta"],
           lambda: kernels.directional_scan_group(
               cost, left, part, rb, True, p1, p2, False, wta=(dmin, True)),
           lambda: kernels.directional_scan_group_plain(
               cost, left, part, rb, True, p1, p2, False, wta=(dmin, True)),
           # cost, image and the sums in, 10 planes out; 3 directions' steps
           # and the two views' compare and selects
           vol + px + 2 * vol + 40 * px, 3 * 10 * vol + 2 * 3 * vol,
           plain_reps=1)

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
    for name in MAIN_PATH + ("aggregate_paths", "wta_reduce") + \
            TWO_LAUNCH_PATH + ("directional_scan_group_bidir",):
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
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

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
    launch takes in a run of RUN back-to-back launches is printed too.
    Then the "fused" line: the vertical pair's two-order scan with the WTA
    epilogue (the main path's) beside the parent's form, two group launches
    and ``wta_reduce``, on the same horizontal sums, held bit-equal first,
    timed in turns (parent, fused, fused, parent), with the fused scan's
    byte bound; and the "two-order horizontal" line: the horizontal pair's
    path scan on the transposed volume (the main path's) beside the group
    kernel's two-order scan of it and two one-order group launches, held
    bit-equal first, in turns, with the path scan's bound."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

    for cfg in [dict(CONE, batch=b) for b in (2, 8, 32)] + [MIDDLEBURY_HALF]:
        opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
        left, right, _ = pair(cfg, seed=8)
        cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                          opt.max_disparity)
        aggr = kernels.aggregate_paths(cost, left, opt)
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
        del aggr
        torch.cuda.empty_cache()

        p1, p2 = opt.p1, opt.p2_init
        (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
        wta = (opt.min_disparity, True)
        part = kernels.horizontal_partial(cost, left, p1, p2, False)

        def parent(acc):
            for rolls, reverse in ((rf, False), (rb, True)):
                kernels.directional_scan_group(cost, left, acc, rolls, reverse,
                                               p1, p2, False)
            return kernels.wta_reduce(acc, opt, include_inverse=True)

        fused = lambda acc: kernels.directional_scan_group_bidir(
            cost, left, acc, rf, rb, p1, p2, False, wta)
        got, want = fused(part.clone()), parent(part.clone())
        max_abs_err(torch.stack(got[0] + got[1]), torch.stack(want[0] + want[1]))
        del got, want
        torch.cuda.empty_cache()
        # the sums the calls add onto wrap around over the runs: the time of
        # neither kernel depends on the values
        times = in_turns({"parent": lambda: parent(part),
                          "fused": lambda: fused(part)}, 5)
        lim = bound(vol + px + 2 * vol + 40 * px, 6 * 10 * vol + 2 * 3 * vol)
        print(f"WTA fused {h}x{w} D={d} B={b}: the vertical pair's two-order "
              f"scan with the WTA epilogue {times['fused']:.4f} ms, the "
              f"parent's two group launches + wta_reduce "
              f"{times['parent']:.4f} ms (in turns, median of 5 each, the two "
              f"reads averaged; {times['fused'] / times['parent']:.3f}x); "
              f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}); "
              f"bit-equal")
        del part, right
        torch.cuda.empty_cache()

        # the horizontal pair on the transposed volume: its path scan (the
        # main path's) beside the group kernel's two-order scan of it and
        # two one-order group launches (forward stored, reverse added)
        cost_t = kernels.volume_transpose(cost, pad_to=kernels.TRANSPOSED_PITCH)
        img_t = kernels.image_transpose(left, pad_to=kernels.TRANSPOSED_PITCH)
        del cost, left

        def one_order():
            acc = kernels.directional_scan_group(cost_t, img_t, None, (0,),
                                                 False, p1, p2, False)
            return kernels.directional_scan_group(cost_t, img_t, acc, (0,),
                                                  True, p1, p2, False)

        two_order = lambda: kernels._bidir(cost_t, img_t, None, (0,), (0,), p1,
                                           p2, False, None,
                                           "horizontal_partial")
        paths = lambda: kernels.horizontal_paths(cost_t, img_t, p1, p2)
        max_abs_err(two_order(), one_order())
        max_abs_err(paths(), two_order())
        times = in_turns({"one-order": one_order, "two-order": two_order,
                          "paths": paths}, 5)
        # the transposed cost read once, half the uint16 sums stored and
        # half read-added; 2 directions
        vol_t = cost_t.numel()
        lim = bound(4 * vol_t + img_t.numel(), 2 * 10 * vol_t)
        print(f"two-order horizontal {h}x{w} D={d} B={b}: the horizontal "
              f"pair's path scan {times['paths']:.4f} ms, the group kernel's "
              f"two-order scan {times['two-order']:.4f} ms, two one-order "
              f"group launches {times['one-order']:.4f} ms (in turns, median "
              f"of 5 each, the two reads averaged; path scan "
              f"{times['paths'] / times['two-order']:.3f}x the two-order "
              f"scan); bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}); "
              f"bit-equal")
        del cost_t, img_t
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
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

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
    for name in ("census_cost_volume_halo", "directional_scan_group"):
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


def chained_tile_path(cfg) -> dict:
    """The exact schedule's carried scans on one card: each vertical group
    over the K H-tiles of the cone pair, tile after tile, each tile's
    launch taking the upstream tile's carry and boundary row (the tiled
    path's order for 2+ tiles; one card cannot hold a mesh of several
    ranks).  Counters reset before, read after; the tiles' sums must equal
    the untiled two-order scan.  Returns the launches."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
    p1, p2, k = opt.p1, opt.p2_init, cfg["k"]
    left, right, _ = pair(cfg, seed=5)
    cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                      opt.max_disparity)
    ht = cost.shape[1] // k
    kernels.reset_launch_counts()
    total = torch.zeros(cost.shape, dtype=torch.uint16, device=cost.device)
    for rolls, reverse in GROUPS:
        carry = None
        for i in (range(k - 1, -1, -1) if reverse else range(k)):
            rows = slice(i * ht, (i + 1) * ht)
            prev = None
            if carry is not None:
                prev = left[:, (i + 1) * ht if reverse else i * ht - 1]
                prev = prev.contiguous()
            acc = total[:, rows].contiguous()
            acc, carry = kernels.directional_scan_group(
                cost[:, rows].contiguous(), left[:, rows].contiguous(), acc,
                rolls, reverse, p1, p2, False, carry_in=carry, want_carry=True,
                prev_gray=prev)
            total[:, rows] = acc
    torch.cuda.synchronize()
    launches = counted_launches(kernels.LAUNCHES,
                                {"directional_scan_group": 2 * k}, 1,
                                "the chained tiles")
    max_abs_err(total, kernels.directional_scan_group_bidir(
        cost, left, None, GROUPS[0][0], GROUPS[1][0], p1, p2, False))
    print(f"tile phase, chained tiles: both vertical groups over K={k} "
          f"H-tiles of {cfg['h']}x{cfg['w']} B={cfg['batch']} made "
          f"{launches} and equal the untiled two-order scan")
    return launches


def past_paths_range() -> dict:
    """The horizontal pair past the path scan's range (D = 513): the
    group kernel's two-order scan, two launches counted as
    ``horizontal_partial``, bit-equal to the plain version; its
    launches."""
    import numpy as np
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels

    rng = np.random.default_rng(12)
    d = kernels.PATHS_MAX_RANGE + 1
    cost_t = torch.from_numpy(rng.integers(0, 128, (1, 6, d, 32), dtype=np.uint8)).cuda()
    img_t = torch.from_numpy(rng.integers(0, 256, (1, 6, 32), dtype=np.uint8)).cuda()
    kernels.reset_launch_counts()
    err = max_abs_err(kernels.horizontal_pair_transposed(cost_t, img_t, 10, 150),
                      kernels.directional_scan_group_bidir_plain(
                          cost_t, img_t, None, (0,), (0,), 10, 150, False))
    torch.cuda.synchronize()
    launches = counted_launches(kernels.LAUNCHES, {"horizontal_partial": 2}, 1,
                                f"the horizontal pair at D={d}")
    print(f"the horizontal pair at D={d}: the group kernel's two launches "
          f"{launches}, bit-equal to its plain version (max_abs_err {err})")
    return launches


def two_launch_path(cfg) -> dict:
    """The two-launch route of the JAX package's ``aggregate_paths_wta``
    (its form where the two-order kernel does not fit): the horizontal
    pair, the forward group, then the reverse group whose launch carries
    the WTA epilogue.  Counters reset before, read after; the planes must
    equal the main path's.  Returns the launches."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
    p1, p2 = opt.p1, opt.p2_init
    left, right, _ = pair(cfg, seed=9)
    cost = kernels.census_cost_volume(left, right, opt.min_disparity,
                                      opt.max_disparity)
    kernels.reset_launch_counts()
    part = kernels.horizontal_partial(cost, left, p1, p2, False)
    (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
    kernels.directional_scan_group(cost, left, part, rf, False, p1, p2, False)
    fwd, inv = kernels.directional_scan_group(
        cost, left, part, rb, True, p1, p2, False,
        wta=(opt.min_disparity, True))
    torch.cuda.synchronize()
    launches = counted_launches(
        kernels.LAUNCHES, {"horizontal_paths": 1, "volume_transpose": 3,
                           "directional_scan_group": 1,
                           "directional_scan_group_wta": 1}, 1,
        "the two-launch route")
    want = kernels.aggregate_paths_wta(cost, left, opt)
    max_abs_err(torch.stack(fwd + inv), torch.stack(want[0] + want[1]))
    print(f"two-launch route at {cfg['h']}x{cfg['w']} B={cfg['batch']}: "
          f"{launches}, planes equal to the main path's")
    return {name: launches[name] for name in TWO_LAUNCH_PATH}


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
    counted_launches(kernels.LAUNCHES, TILED_LAUNCHES, 1,
                     "the tiled engine on a 1x1 mesh")
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
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

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
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

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
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

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


def same_measurements(got: dict, want: dict, keys) -> None:
    """Raise unless the two measurements agree exactly on ``keys`` (NaN
    equal to NaN)."""
    for key in keys:
        g, w = got[key], want[key]
        if not (g == w or (g != g and w != w)):
            raise AssertionError(f"{got.get('name', got.get('seq'))}: {key} "
                                 f"{g!r} != {w!r}")


def counted_launches(counts: dict, per_call: dict, calls: int, what: str,
                     extra: dict = None) -> dict:
    """The launches a run made, checked counter by counter against ``calls``
    engine calls' worth of ``per_call`` plus ``extra`` (counter -> launches
    of the run's other kernel calls); every other counter must be 0."""
    want = {name: n * calls for name, n in per_call.items()}
    for name, n in (extra or {}).items():
        want[name] = want.get(name, 0) + n
    got = {name: n for name, n in counts.items() if n}
    if got != {name: n for name, n in want.items() if n}:
        raise AssertionError(f"{what} launched {got}, want {want}")
    return got


def stdout_of(fn) -> tuple:
    """(``fn()``'s return value, the lines it printed on stdout)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn()
    return rc, out.getvalue().splitlines()


def benches_phase(tmp, card: str) -> dict:
    """The benches on the card, each with every launch counter reset just
    before it and read just after."""
    from pathlib import Path

    import torch

    from soc_project_stereo_matching_tpu_torch import (SGMEngine, SGMOptions,
                                                       bench, stage_breakdown)
    from soc_project_stereo_matching_tpu_torch.benches import (
        big_configs, device_pair, loopback, scaling, streaming)
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    tmp = Path(tmp)
    keys = {"metric", "value", "unit", "vs_baseline"}

    # a. the headline bench, its timers against stage_breakdown's, a failure
    kernels.reset_launch_counts()
    rc, lines = stdout_of(
        lambda: bench.main(["--out", str(tmp / "bench.json")]))
    torch.cuda.synchronize()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench: exit {rc}, stdout {lines}")
    line = json.loads(lines[0])
    if set(line) != keys or line["value"] is None:
        raise AssertionError(f"bench: line {line}")
    doc = json.loads((tmp / "bench.json").read_text())
    agg = doc["aggregation"]
    bench_launches = counted_launches(
        kernels.LAUNCHES, MAIN_LAUNCHES, doc["engine_calls"], "bench",
        {"census_cost_volume": agg["census_calls"],
         **{name: n * agg["calls"] for name, n in AGGREGATE_LAUNCHES.items()}})
    call, enq, window = doc["call_ms"], doc["enqueue_ms"], doc["window_ms"]
    left, right, _ = device_pair("cuda", doc["batch"], doc["h"], doc["w"], 0,
                                 doc["dmax"])
    opt = SGMOptions(max_disparity=doc["dmax"])
    engine = SGMEngine(opt, device="cuda")
    theirs, _ = stage_breakdown.batch_and_enqueue(engine, left, right, 10)
    # the same per-call timer in a second run, then two other timers: the
    # device range of the program's sgm.match span and the bench's own
    # back-to-back window
    spans = stage_breakdown.stage_times(engine, left, right, 5)["sgm.match"]
    others = {"stage_breakdown.batch_and_enqueue": theirs["median"],
              "stage_breakdown's sgm.match range": spans["median"],
              "the bench's window": window["median"]}
    ratios = {what: call["median"] / ms for what, ms in others.items()}
    if any(abs(r - 1.0) > AGREE for r in ratios.values()):
        raise AssertionError(f"bench: median batch {call['median']} ms, "
                             f"against {others}")
    del left, right
    print(f"benches, bench stdout: {lines[0]} ({card})")
    print(f"benches, bench {doc['w']}x{doc['h']} D={doc['dmax']} "
          f"B={doc['batch']}: window {window['median']:.4f} ms a batch over "
          f"{doc['repeats']} repeats of {doc['iters']} (min {window['min']:.4f}"
          f", max {window['max']:.4f}, max/min {window['max_over_min']:.4f}; "
          f"host enqueue {doc['window_enqueue_ms']['median']:.4f}); "
          f"a batch at a time median {call['median']:.4f} p95 "
          f"{call['p95']:.4f} p99 {call['p99']:.4f} ms ({call['n']} calls), "
          f"host enqueue median {enq['median']:.4f} ms; "
          f"{doc['fps_all_windows']:.2f} frames/s over all windows; "
          + "; ".join(f"{what} {others[what]:.4f} ms ({r:.4f}x)"
                      for what, r in ratios.items())
          + f"; build_s "
          f"{doc['build_s']:.3f}, first batch {doc['first_batch_ms']:.3f} ms; "
          f"finite {doc['valid_frac']:.4f}, {doc['good_frac']:.4f} of them "
          f"within 1 of the truth; aggregate_paths {agg['ms_per_frame']:.4f} "
          f"ms a frame, {agg['share_of_bound']:.1%} of its "
          f"{agg['bound_ms']:.4f} ms bound ({card})")
    # a range past the JAX package's D = 16,384 (every width
    # runs): one line with value null, exit 1
    rc, lines = stdout_of(lambda: bench.report(
        "cuda", batch=1, h=16, w=64, dmax=16385, out=tmp / "bench_fail.json"))
    line = json.loads(lines[0]) if len(lines) == 1 else {}
    if rc != 1 or line.get("value", 0) is not None or "error" not in line:
        raise AssertionError(f"bench forced failure: exit {rc}, stdout {lines}")
    print(f"benches, bench forced failure: exit {rc}, {lines[0]}")

    # b. the big configs; the tiled cell held to the untiled cell's output
    untiled = None
    for name, w, h, d, kw in big_configs.CELLS:
        kw = dict(kw, iters=BIG_ITERS)
        kernels.reset_launch_counts()
        rec, out = big_configs.run_config(
            name, w, h, d, **kw, device="cuda",
            reference=untiled if kw.get("tiled") else None)
        torch.cuda.synchronize()
        counted_launches(kernels.LAUNCHES, TILED_LAUNCHES if rec["tiled"]
                         else MAIN_LAUNCHES, rec["engine_calls"], name)
        if name == "middlebury2014-half":
            untiled = out
        del out
        c, e, win = rec["call_ms"], rec["enqueue_ms"], rec["window_ms"]
        tiled = " tiled (bit-equal to untiled)" if rec["tiled"] else ""
        print(f"benches, big_configs {name} {w}x{h} dmin={rec['min_disparity']}"
              f" dmax={d} B={rec['batch']}{tiled}: "
              f"{rec['ms_per_frame']:.4f} ms a frame, "
              f"{rec['fps_per_chip']:.2f} frames/s (window, median of "
              f"{rec['repeats']}, max/min {win['max_over_min']:.4f}; "
              f"{rec['fps_all_windows']:.2f} over all windows; host "
              f"enqueue {rec['window_enqueue_ms']['median']:.4f} ms); a batch "
              f"at a time median {c['median']:.4f} p95 {c['p95']:.4f} ms, host "
              f"enqueue {e['median']:.4f}; first batch "
              f"{rec['first_batch_ms']:.3f} ms; finite "
              f"{rec['valid_frac']:.4f}, {rec['good_frac']:.4f} within 1 "
              f"({card})")
    del untiled
    torch.cuda.empty_cache()

    # c. the host-fed stream
    kernels.reset_launch_counts()
    doc = streaming.run("cuda", batches=STREAM_BATCHES)
    torch.cuda.synchronize()
    counted_launches(kernels.LAUNCHES, MAIN_LAUNCHES, doc["engine_calls"],
                     "streaming")
    cfg, att = doc["config"], doc["attribution"]
    print(f"benches, streaming {cfg['width']}x{cfg['height']} "
          f"D={cfg['max_disparity']} B={cfg['batch']}, {cfg['batches']} "
          f"batches: host-fed {doc['fps_streaming']:.2f} frames/s, resident "
          f"{doc['fps_device_resident']:.2f}, device only "
          f"{doc['fps_device_only']:.2f} (host enqueue "
          f"{doc['device_only_enqueue_ms']:.3f} of {doc['device_only_ms']:.3f} "
          f"ms a batch); overlap "
          f"{doc['overlap_efficiency']:.4f}; copy "
          f"{doc['h2d_transfer_ms_per_batch']:.3f} ms a batch "
          f"({doc['h2d_transfer_gb_s']:.2f} GB/s); transfer loss "
          f"{att['transfer_loss']:.4f}, dispatch loss "
          f"{att['dispatch_loss']:.4f}; loops equal ({card})")
    torch.cuda.empty_cache()

    # d. the wire protocol's loopbacks
    kernels.reset_launch_counts()
    doc = loopback.run("cuda", frames=LOOP_FRAMES, wire_repeat=1,
                       engine_repeat=1)
    torch.cuda.synchronize()
    counted_launches(kernels.LAUNCHES, MAIN_LAUNCHES, doc["engine_calls"],
                     "loopback")
    print(f"benches, loopback {doc['format']}: wire only "
          f"{doc['wire_only_fps']:.2f} frames/s ({doc['wire_frames']} "
          f"frames), engine {doc['engine_fps']:.2f} frames/s, "
          f"{doc['engine_ms_per_frame']:.2f} ms a frame "
          f"({doc['engine_frames']} frames) ({card})")

    # e. scaling over the cards present, each size in ranks of its own
    doc = scaling.run("cuda")
    for row in doc["rows"]:
        counted_launches(row["launches"], TILED_LAUNCHES, row["steps"],
                         f"scaling, {row['devices']} rank(s)")
        print(f"benches, scaling devices={row['devices']} mesh=({row['mesh']})"
              f" batch={row['batch']}: {row['ms_per_step']:.4f} ms a step, "
              f"{row['fps']:.2f} frames/s, scaling-eff "
              f"{row['scaling_eff']:.4f}, bit-equal to the single-rank engine "
              f"({card})")
    if doc["not_run"]:
        print(f"benches, scaling {doc['not_run']}")
    # aggregate_paths is on no engine path: its launches are the bench's
    # aggregation diagnostic's
    return {"aggregate_paths": bench_launches["aggregate_paths"]}


def surfaces_phase(tmp, card: str) -> None:
    """The user-facing surfaces on the card: the KITTI-2015 batched eval
    through ``cli eval``, the reference wire protocol at the firmware's
    720p frame over loopback, and ``cli match``; each path with every
    launch counter reset just before it and read just after."""
    from pathlib import Path

    import numpy as np
    import torch
    from PIL import Image

    from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions, cli
    from soc_project_stereo_matching_tpu_torch.compat.client import run_client
    from soc_project_stereo_matching_tpu_torch.compat.server import CompatServer
    from soc_project_stereo_matching_tpu_torch.data import (convert, datasets,
                                                            imageio, synthetic)
    from soc_project_stereo_matching_tpu_torch.eval import harness
    from soc_project_stereo_matching_tpu_torch.eval import metrics as M
    from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    tmp = Path(tmp)
    keys = ("rmse_mm", "bpr", "n_valid", "me_mm", "b1m", "b1dm", "disp_bad3",
            "disp_avg_err", "disp_density", "valid_frac")

    # a. the KITTI-2015 batched eval
    cfg = KITTI
    left, right, field = synthetic.synthetic_pair(11, cfg["batch"], cfg["h"],
                                                  cfg["w"], cfg["levels"])
    known = np.ones(field.shape, bool)
    known[:cfg["unknown_rows"]] = False
    root = synthetic.write_kitti2015(tmp / "kitti", left, right, field, known)
    stats_path = tmp / "kitti_stats.json"
    kernels.reset_launch_counts()
    rc = cli.main(["eval", "--data", str(root), "--batched", "--batch-size",
                   str(cfg["batch"]), "--device", "cuda", "--stats",
                   str(stats_path)])
    torch.cuda.synchronize()
    calls = 1 + harness.HarnessConfig().timing_repeats    # warm-up + timed
    counted_launches(kernels.LAUNCHES, MAIN_LAUNCHES, calls, "cli eval")
    stats = json.loads(stats_path.read_text())
    if rc != 0 or stats["total_frames"] != cfg["batch"] \
            or stats["timing_methodology"] != "cuda-events":
        raise AssertionError(f"cli eval: rc {rc}, {stats['total_frames']} "
                             f"frames, {stats['timing_methodology']!r}")
    engine = SGMEngine(SGMOptions(min_disparity=0, max_disparity=cfg["dmax"]),
                       device="cuda")
    lt, rt = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    disps = engine.match_batch(lt, rt).cpu().numpy()
    calib = datasets.synthetic_calib(cfg["w"], cfg["h"], fx=721.5377,
                                     baseline=537.0)    # KITTI's nominal rig
    gt = np.where(known, field, np.nan).astype(np.float32)
    gt_depth = M.ground_truth_depth(gt, gt, calib, cfg["w"], cfg["h"])
    for i, (m, disp) in enumerate(zip(stats["measurements"], disps)):
        valid = np.isfinite(disp)
        depth = np.where(valid, M.disparity_to_depth(disp, calib, 0),
                         np.nan).astype(np.float32)
        dm = M.compare_depth(gt_depth, depth)
        dd = M.compare_disparity(gt, disp)
        want = {"name": f"kitti2015/{i:06d}", "rmse_mm": dm.rmse, "bpr": dm.bpr,
                "n_valid": dm.n_valid, "me_mm": dm.me, "b1m": dm.b1m,
                "b1dm": dm.b1dm, "disp_bad3": dd["bad_tau"],
                "disp_avg_err": dd["avg_err"], "disp_density": dd["density"],
                "valid_frac": float(valid.mean())}
        same_measurements(m, want, ("name",) + keys)
        if not m["disp_bad3"] <= BAD3_MAX:
            raise AssertionError(f"{m['name']}: disp_bad3 {m['disp_bad3']} "
                                 f"above {BAD3_MAX}")
    bad3 = [m["disp_bad3"] for m in stats["measurements"]]
    # two frames cropped: the harness on the card against the CPU's
    rows, cols = KITTI_CROP
    crop = synthetic.write_kitti2015(
        tmp / "kitti_crop", left[:2, rows, cols], right[:2, rows, cols],
        field[rows, cols], known[rows, cols])
    refs = datasets.kitti_frame_refs(crop)
    runs = [harness.EvaluationHarness(
        SGMOptions(), harness.HarnessConfig(batch_size=2, timing_repeats=1),
        device=device).run_batched(refs)["measurements"]
        for device in ("cuda", "cpu")]
    for got, want in zip(*runs, strict=True):
        same_measurements(got, want, ("name",) + keys)
    batch_ms = cuda_ms(lambda: engine.match_batch(lt, rt), 5)
    print(f"surfaces, KITTI-2015 {cfg['w']}x{cfg['h']} D={cfg['dmax']} "
          f"B={cfg['batch']} through cli eval --batched: {stats['fps']:.2f} "
          f"frames/s (CUDA events, median of {calls - 1} batches); "
          f"match_batch {batch_ms:.3f} ms a batch; metrics equal to the "
          f"script's and, on a {rows.stop - rows.start}x"
          f"{cols.stop - cols.start} crop of 2 frames, to the CPU harness's; "
          f"disp_bad3 {min(bad3):.5f}..{max(bad3):.5f} (bound {BAD3_MAX:.2f}); "
          f"{card}")

    # b. the reference wire protocol at the firmware's frame
    cfg = WIRE
    left, right, field = synthetic.synthetic_pair(12, cfg["frames"], cfg["h"],
                                                  cfg["w"], cfg["levels"])
    calib = datasets.synthetic_calib(cfg["w"], cfg["h"], fx=1400.0,
                                     baseline=120.0, doffs=4.0)
    dirs = [convert.pair_to_middlebury2014(
        synthetic.stereo_pair(f"wire{i}", left[i], right[i], field, calib,
                              cfg["dmax"]), tmp / "wire" / f"wire{i}")
        for i in range(cfg["frames"])]
    engine = SGMEngine(SGMOptions(max_disparity=cfg["dmax"]), device="cuda")
    server = CompatServer(dirs, host="127.0.0.1", port=0, width=cfg["w"],
                          height=cfg["h"], stats_dir=tmp / "wire_stats")
    port = server.start()
    kernels.reset_launch_counts()
    try:
        frames = run_client("127.0.0.1", port, engine=engine)
    finally:
        server.stop()
        for t in server._threads[1:]:       # the client's handler
            t.join(timeout=120)
            if t.is_alive():
                raise AssertionError("the server's client handler did not end")
    torch.cuda.synchronize()
    counted_launches(kernels.LAUNCHES, MAIN_LAUNCHES, cfg["frames"],
                     "the wire client")
    (path,) = (tmp / "wire_stats").glob("127.0.0.1_*.txt")
    stats = json.loads(path.read_text())
    if frames != cfg["frames"] or stats["total_frames"] != cfg["frames"]:
        raise AssertionError(f"wire: client {frames} frames, server "
                             f"{stats['total_frames']}, want {cfg['frames']}")
    gt_depth = M.ground_truth_depth(field.astype(np.float32),
                                    field.astype(np.float32), calib,
                                    cfg["w"], cfg["h"])
    for i, m in enumerate(stats["measurements"]):
        # the client's path: firmware luma of the BGR frame, the engine,
        # the float32 depth conversion
        gray = [imageio.rgb_to_gray_device(np.repeat(x[i][..., None], 3, axis=2))
                for x in (left, right)]
        disp = engine.match(*gray).cpu().numpy()
        valid = np.isfinite(disp)
        denom = disp + np.float32(calib.doffs)
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(valid & (denom != 0),
                             np.float32(calib.fx0) * np.float32(calib.baseline)
                             / denom, np.nan).astype(np.float32)
        res = M.compare_depth(gt_depth, depth)
        same_measurements(m, {"seq": i, "rmse_mm": res.rmse, "bpr": res.bpr,
                              "n_valid": res.n_valid},
                          ("seq", "rmse_mm", "bpr", "n_valid"))
    gl, gr = (torch.from_numpy(g).cuda() for g in gray)
    max_abs_err(engine.match(gl, gr),
                sgm_forward(gl, gr, engine.options, use_kernels=False))
    frame_ms = stats["total_time_s"] / cfg["frames"] * 1e3
    match_ms = cuda_ms(lambda: engine.match(gl, gr), 5)
    print(f"surfaces, wire protocol {cfg['w']}x{cfg['h']} D={cfg['dmax']} "
          f"over loopback, {cfg['frames']} frames: {stats['fps']:.2f} "
          f"frames/s, {frame_ms:.1f} ms a frame (the server's clock, frame "
          f"sent to depth received), of it the engine's match {match_ms:.3f} "
          f"ms (CUDA events, images on the card); measurements equal to the "
          f"script's, the last frame bit-equal to the plain path; {card}")

    # c. cli match on a cone-size pair
    left, right, _ = synthetic.synthetic_pair(13, 1, CONE["h"], CONE["w"],
                                              CONE["levels"])
    paths = [tmp / "match_left.png", tmp / "match_right.png"]
    for path, img in zip(paths, (left[0], right[0])):
        Image.fromarray(img).save(path)
    kernels.reset_launch_counts()
    rc = cli.main(["match", *map(str, paths), "-o", str(tmp / "match.png"),
                   "--device", "cuda"])
    torch.cuda.synchronize()
    counted_launches(kernels.LAUNCHES, MAIN_LAUNCHES, 2,
                     "cli match")    # first + steady
    imageio.save_disparity_png(tmp / "want.png", SGMEngine(
        SGMOptions(), device="cuda").match(left[0], right[0]).cpu().numpy())
    got = np.asarray(Image.open(tmp / "match.png"))
    if rc != 0 or not np.array_equal(got, np.asarray(Image.open(tmp / "want.png"))):
        raise AssertionError("cli match: the PNG differs from "
                             "save_disparity_png of the engine's result")
    print(f"surfaces, cli match {CONE['w']}x{CONE['h']}: the PNG equals "
          f"save_disparity_png of SGMEngine(SGMOptions()).match")


def main_path_launches(b: int, h: int, w: int, d: int) -> dict:
    """C entry calls of one untiled match_batch at this shape: the vertical
    pair's two launches a part of its group (``_launch_parts``, with the
    epilogue), or where its row passes the card's resident width its
    launches over column parts and one ``wta_reduce``
    (``kernels.bidir_calls``); the horizontal pair's path scan on the
    transposed volume, one launch, or past D = 512 the group kernel's
    (``kernels.horizontal_calls``)."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels

    def calls(s, rows, rolls, wta):
        probe = torch.empty((b, 1, d, rows), dtype=torch.uint8, device="cuda")
        out = torch.empty(probe.shape, dtype=torch.uint16, device="cuda")
        return kernels.bidir_calls(probe.expand(b, s, d, rows),
                                   out.expand(b, s, d, rows), *rolls, wta)

    h_pad = -(-h // kernels.TRANSPOSED_PITCH) * kernels.TRANSPOSED_PITCH
    vertical, reduce = calls(h, w, ((0, 1, -1), (0, -1, 1)), True)
    pair = kernels.horizontal_calls(torch.empty(
        (b, 1, d, h_pad), dtype=torch.uint8, device="cuda").expand(
            b, w, d, h_pad))
    return {"census_cost_volume": 1, "aggregate_paths_wta": vertical, **pair,
            "volume_transpose": 3, "wta_reduce": reduce, "lr_check": 1,
            "remove_speckles": 1}


def wide_kernel_checks(cfg) -> dict:
    """Every mode of sgm_scan_group, the WTA kernel, K1 (both modes), K3 and
    K4 against their plain versions at D > 256 where an image takes G >= 2
    clusters; the main path through ``match_batch`` against the plain path
    with its launches counted.  Returns the plan of the vertical pair."""
    import numpy as np
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions
    from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    b, h, d, w = cfg["batch"], cfg["h"], cfg["d"], cfg["w"]
    rng = np.random.default_rng(d)

    def rand(high, shape, dtype):
        return torch.from_numpy(rng.integers(0, high, shape).astype(dtype)).cuda()

    cost = rand(128, (b, h, d, w), np.uint8)
    img = rand(256, (b, h, w), np.uint8)
    acc = rand(900, (b, h, d, w), np.uint16)
    plan = kernels.group_plan(cost, acc, 3, True, 2)
    if min(kernels.group_plan(cost, acc, n, False).clusters_an_image
           for n in (1, 3)) < 2:
        raise AssertionError(f"D={d} W={w}: a cluster holds the row: no "
                             f"multi-cluster launch")
    every_group_mode(cost, img, acc)
    for dmin in (0, 24):
        opt = SGMOptions(min_disparity=dmin, max_disparity=dmin + d)
        planes_err(_flat(kernels.wta_reduce(acc, opt)),
                   _flat(kernels.wta_reduce_plain(acc, opt)))
    left, right = rand(256, (b, h, w), np.uint8), rand(256, (b, h, w), np.uint8)
    for dmin in (0, 3):
        max_abs_err(kernels.census_cost_volume(left, right, dmin, dmin + d),
                    kernels.census_cost_volume_plain(left, right, dmin, dmin + d))
    halo = rand(256, (b, h + 4, w), np.uint8)
    max_abs_err(kernels.census_cost_volume(halo, halo.flip(-1).contiguous(), 0, d, True),
                kernels.census_cost_volume_plain(halo, halo.flip(-1).contiguous(), 0, d, True))
    dl = torch.from_numpy(rng.uniform(0, d, (b, h, w)).astype(np.float32)).cuda()
    dr = torch.from_numpy(rng.uniform(0, d, (b, h, w)).astype(np.float32)).cuda()
    max_abs_err(kernels.lr_check(dl, dr, 1.0, d),
                kernels.postprocess.lr_check(dl, dr, 1.0, d))
    opt = SGMOptions(max_disparity=d, min_speckle_area=20)
    engine = SGMEngine(opt, device="cuda")
    kernels.reset_launch_counts()
    disp = engine.match_batch(left, right)
    torch.cuda.synchronize()
    counted_launches(kernels.LAUNCHES, main_path_launches(b, h, w, d), 1,
                     f"match_batch at D={d}")
    max_abs_err(disp, sgm_forward(left, right, opt, use_kernels=False))
    # a speckled map of its own: integer steps, invalid where the engine's is
    raw = torch.where(torch.isfinite(disp), dl.floor(), disp)
    max_abs_err(kernels.remove_speckles(raw, 1.0, 20),
                kernels.postprocess.remove_speckles(raw, 1.0, 20))
    return plan


def _flat(planes) -> list:
    """(forward WTAPlanes, inverse or None) -> their planes in order."""
    return [p for view in planes if view is not None for p in view]


def wide_frame(cfg, card: str) -> dict:
    """One full-size frame through ``SGMEngine.match`` (untiled) and the
    tiled engine on a 1x1 mesh in exact mode (the halo census, the carried
    scans, csrc/wta.cu): bit-equal, 0.95 of the finite pixels within 1 of
    the truth, the main path's launches counted; ms a frame and the peak
    of device memory."""
    import torch

    from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                       SGMOptions)
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

    opt = SGMOptions(max_disparity=cfg["dmax"])
    left, right, field = pair(cfg, seed=cfg["dmax"])
    untiled = SGMEngine(opt, device="cuda")
    tiled = SGMEngine(opt, EngineConfig(tile_mode="exact"), device="cuda",
                      mesh=make_mesh(1, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    got = untiled.match(left, right)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    per_call = main_path_launches(1, cfg["h"], cfg["w"], cfg["dmax"])
    launches = counted_launches(kernels.LAUNCHES, per_call, 1,
                                f"match at {cfg['w']}x{cfg['h']} D={cfg['dmax']}")
    max_abs_err(tiled.match_batch(left, right), got)
    valid = torch.isfinite(got)
    good = ((got - field).abs() <= 1.0)[valid].float().mean().item()
    if good < MIN_GOOD:
        raise AssertionError(f"{cfg['w']}x{cfg['h']} D={cfg['dmax']}: only "
                             f"{good} of the finite pixels lie within 1 of "
                             f"the truth")
    ms = cuda_ms(lambda: untiled.match(left, right), 3)
    tiled_ms = cuda_ms(lambda: tiled.match_batch(left, right), 3)
    vplan = kernels.group_plan(torch.empty((1, 1, cfg["dmax"], cfg["w"]),
                                           dtype=torch.uint8, device="cuda"),
                               torch.empty((1, 1, cfg["dmax"], cfg["w"]),
                                           dtype=torch.uint16, device="cuda"),
                               kernels.group_capacity(
                                   torch.empty((1, 1, cfg["dmax"], cfg["w"]),
                                               dtype=torch.uint8, device="cuda"),
                                   torch.empty((1, 1, cfg["dmax"], cfg["w"]),
                                               dtype=torch.uint16, device="cuda"),
                                   True), True, 2)
    print(f"wide range, frame {cfg['w']}x{cfg['h']} D={cfg['dmax']} B=1 "
          f"through SGMEngine.match: {ms:.3f} ms (CUDA events, median of 3), "
          f"tiled exact on a 1x1 mesh {tiled_ms:.3f} ms and bit-equal; finite "
          f"{valid.float().mean().item():.4f}, {good:.4f} of them within 1 "
          f"of the truth; launches {launches}; the vertical pair's plan "
          f"{vplan._asdict()}; peak device memory "
          f"{peak / 2**30:.3f} GiB above the inputs; {card}")
    return {"ms": ms, "tiled_ms": tiled_ms, "peak_bytes": peak,
            "launches": launches}


def wide_eval(tmp, card: str) -> None:
    """``cli eval`` through a full-size Middlebury-2014 folder (2964x1988,
    ndisp=280 in calib.txt, the repo's calibration): its measurement must
    equal the harness's metrics of this script's own engine result."""
    from pathlib import Path

    import torch

    from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions, cli
    from soc_project_stereo_matching_tpu_torch.data import (convert, datasets,
                                                            synthetic)
    from soc_project_stereo_matching_tpu_torch.eval import harness
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    cfg = WIDE_EVAL
    left, right, field = synthetic.synthetic_pair(13, 1, cfg["h"], cfg["w"],
                                                  cfg["levels"])
    calib = datasets.synthetic_calib(cfg["w"], cfg["h"], **MIDDLEBURY_FULL_CALIB)
    root = Path(tmp) / "middlebury_full"
    folder = convert.pair_to_middlebury2014(
        synthetic.stereo_pair("full", left[0], right[0], field, calib,
                              cfg["dmax"]), root / "full")
    stats_path = Path(tmp) / "middlebury_full_stats.json"
    kernels.reset_launch_counts()
    rc = cli.main(["eval", "--data", str(root), "--device", "cuda", "--stats",
                   str(stats_path)])
    torch.cuda.synchronize()
    calls = 1 + harness.HarnessConfig().timing_repeats
    counted_launches(kernels.LAUNCHES,
                     main_path_launches(1, cfg["h"], cfg["w"], cfg["dmax"]),
                     calls, "cli eval at full size")
    stats = json.loads(stats_path.read_text())
    loaded = datasets.load_pair_2014(folder)
    if rc != 0 or stats["total_frames"] != 1 or loaded.dmax != cfg["dmax"]:
        raise AssertionError(f"cli eval: rc {rc}, {stats['total_frames']} "
                             f"frames, ndisp {loaded.dmax}")
    disp = SGMEngine(SGMOptions(max_disparity=cfg["dmax"]), device="cuda").match(
        torch.from_numpy(loaded.img_left).cuda(),
        torch.from_numpy(loaded.img_right).cuda()).cpu().numpy()
    want = harness.EvaluationHarness(SGMOptions())._metrics_for(loaded, disp, 0.0)
    got = stats["measurements"][0]
    same_measurements(got, want, [k for k in want if k != "duration_s"])
    if not got["disp_bad3"] <= BAD3_MAX:
        raise AssertionError(f"cli eval at full size: disp_bad3 "
                             f"{got['disp_bad3']} above {BAD3_MAX}")
    print(f"wide range, cli eval through a Middlebury-2014 folder "
          f"{cfg['w']}x{cfg['h']} ndisp={cfg['dmax']}: {got['duration_s'] * 1e3:.3f} "
          f"ms a frame (CUDA events, median of {calls - 1}); measurement equal "
          f"to the script's; disp_bad3 {got['disp_bad3']:.5f}, valid "
          f"{got['valid_frac']:.4f}; {card}")


def wide_kernel_times(cfg, card: str, phase: str = "wide range") -> None:
    """Each K2 form and the WTA at a full-size frame's shape with D > 256
    (kernel table rows 2, 2c, 2w, 3p or 3, 3w and 4): CUDA-event ms, the entry
    calls a call makes, the plan (clusters an image) of its largest launch
    and its bound (inputs read once, outputs written once; 10 32-bit
    operations an element and direction for the recurrence, 3 an element and
    view for a WTA)."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

    left, right, _ = pair(cfg, seed=cfg["dmax"])
    b, h, w = left.shape
    d = cfg["dmax"]
    cost = kernels.census_cost_volume(left, right, 0, d)
    px, vol = b * h * w, b * h * w * d
    acc = kernels.horizontal_partial(cost, left, 10, 150, False)
    cost_t = kernels.volume_transpose(cost, pad_to=kernels.TRANSPOSED_PITCH)
    img_t = kernels.image_transpose(left, pad_to=kernels.TRANSPOSED_PITCH)
    carry = (torch.zeros((b, 3, d, w), dtype=torch.int32, device="cuda"),
             torch.zeros((b, 3, 1, w), dtype=torch.int32, device="cuda"))
    gray = left[:, -1].contiguous()
    (rf, _), (rb, _) = GROUPS
    carry_bytes = 2 * 4 * b * 3 * (d + 1) * w
    paths = kernels.horizontal_route(d) == "paths"
    pair_row = "3p horizontal pair" if paths else "3 horizontal pair"
    rows = {
        "2 group": (lambda: kernels.directional_scan_group(
            cost, left, None, rf, False, 10, 150, False),
            vol + px + 2 * vol, 3 * 10 * vol, (cost, 3, False)),
        "2c carries": (lambda: kernels.directional_scan_group(
            cost, left, None, rf, False, 10, 150, False, carry_in=carry,
            want_carry=True, prev_gray=gray),
            vol + px + w * b + 2 * vol + carry_bytes, 3 * 10 * vol,
            (cost, 3, False)),
        "2w epilogue": (lambda: kernels.directional_scan_group(
            cost, left, acc, rb, True, 10, 150, False, wta=(0, True)),
            vol + px + 2 * vol + 40 * px, 3 * 10 * vol + 2 * 3 * vol,
            (cost, 3, True)),
        pair_row: (lambda: kernels.horizontal_pair_transposed(
            cost_t, img_t, 10, 150),
            cost_t.numel() + img_t.numel() + 2 * cost_t.numel(),
            2 * 10 * cost_t.numel(), (cost_t, 1, False)),
        "3w vertical pair": (lambda: kernels.directional_scan_group_bidir(
            cost, left, acc, rf, rb, 10, 150, False, wta=(0, True)),
            vol + px + 2 * vol + 40 * px, 6 * 10 * vol + 2 * 3 * vol,
            (cost, 3, True)),
        "4 wta": (lambda: kernels.wta_reduce(acc, SGMOptions(max_disparity=d)),
                  2 * vol + 40 * px, 2 * 3 * vol, None)}
    for name, (fn, nbytes, ops, planned) in rows.items():
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        calls = {k: v for k, v in kernels.LAUNCHES.items() if v}
        ms = cuda_ms(fn, 3)
        lim = bound(nbytes, ops)
        plan = ""
        route = None if planned is None else kernels.group_route(
            planned[0], planned[0], (1,) if planned[1] > 1 else (0,),
            planned[2])
        if name == pair_row and paths:
            p = kernels.path_plan(cost_t.device, b, d, cost_t.shape[3])
            plan = f", the path scan's plan {p._asdict()}"
        elif route is not None:
            plan = f", column parts {route._asdict()} (no epilogue)"
        elif planned is not None:
            x, n, wta = planned
            probe = x[:, :1]
            per = kernels.group_capacity(probe, probe.to(torch.uint16), wta)
            p = kernels.group_plan(probe, probe.to(torch.uint16), min(n, per),
                                   wta, 2 if name.startswith("3") else 1)
            plan = (f", {min(n, per)} directions a launch over "
                    f"{p.clusters_an_image} clusters of {p.cluster_blocks} "
                    f"blocks ({p.ranges} splitting D), {p.images_a_wave} "
                    f"images a wave")
        print(f"{phase}, kernel row {name} at {w}x{h} D={d} B={b}: "
              f"{ms:.3f} ms, calls {calls}{plan}; bound {lim['bound_ms']:.3f} "
              f"ms ({lim['bound_by']}); {card}")


def every_group_mode(cost, img, acc) -> None:
    """Every mode of ``sgm_scan_group`` against its plain version (raises
    on the first difference): one order stored and added, carries in and
    out, the epilogue; the two-order scan's volume and planes forms; wrap
    and restart; the 8-path group, one diagonal alone, the roll-0
    direction."""
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    for restart in (False, True):
        for rolls, reverse in GROUPS + (((1,), False), ((0,), True)):
            args = (rolls, reverse, 10, 150, restart)
            for start in (None, acc):
                max_abs_err(
                    kernels.directional_scan_group(
                        cost, img, None if start is None else start.clone(), *args),
                    kernels.directional_scan_group_plain(
                        cost, img, None if start is None else start.clone(), *args))
            carry = kernels.directional_scan_group_plain(
                cost, img, None, *args, want_carry=True)[1]
            gray = img[:, -1].contiguous()
            got = kernels.directional_scan_group(cost, img, acc.clone(), *args,
                                                 carry_in=carry, want_carry=True,
                                                 prev_gray=gray)
            want = kernels.directional_scan_group_plain(
                cost, img, acc.clone(), *args, carry_in=carry, want_carry=True,
                prev_gray=gray)
            for g, w_ in zip((got[0], *got[1]), (want[0], *want[1])):
                max_abs_err(g, w_)
            planes_err(*(_flat(f(cost, img, acc.clone(), *args, wta=(24, True)))
                         for f in (kernels.directional_scan_group,
                                   kernels.directional_scan_group_plain)))
        for rf, rb in (((0, 1, -1), (0, -1, 1)), ((0,), (0,))):
            args = (rf, rb, 10, 150, restart)
            max_abs_err(kernels.directional_scan_group_bidir(cost, img, acc.clone(), *args),
                        kernels.directional_scan_group_bidir_plain(cost, img, acc.clone(), *args))
            for wta in ((0, True), (24, False)):
                parks = acc.clone(), acc.clone()
                planes_err(_flat(kernels.directional_scan_group_bidir(
                               cost, img, parks[0], *args, wta=wta)),
                           _flat(kernels.directional_scan_group_bidir_plain(
                               cost, img, parks[1], *args, wta=wta)))


def unrefused_kernels(card: str) -> None:
    """K1 in segments (both modes but at D = 16,384), the WTA past 32,768
    columns and every mode of the group scan with D split, each bit-equal
    to its plain version at a shape the port once refused; K1's and the
    WTA's times beside their byte bounds (kernel table rows 1, 1h, 4)."""
    import numpy as np
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.utils.profiling import bound

    rng = np.random.default_rng(16)

    def rand(high, shape, dtype):
        return torch.from_numpy(rng.integers(0, high, shape).astype(dtype)).cuda()

    for h, w, dmin, d in UNREFUSED_K1:
        left, right = rand(256, (1, h + 4, w), np.uint8), rand(256, (1, h + 4, w), np.uint8)
        plan = kernels.census_segments(left.device, w, dmin, d)
        if not plan.segmented:
            raise AssertionError(f"K1 at {w} columns D={d}: one block holds the row")
        for halo in (False, True) if d <= 256 else (False,):
            il, ir = ((left, right) if halo else
                      (left[:, :h].contiguous(), right[:, :h].contiguous()))
            fn = lambda: kernels.census_cost_volume(il, ir, dmin, dmin + d, halo)
            err = max_abs_err(fn(), kernels.census_cost_volume_plain(
                il, ir, dmin, dmin + d, halo))
            lim = bound(il.numel() + ir.numel() + h * d * w, 0)
            print(f"unrefused, K1 {'halo ' if halo else ''}{w}x{h} dmin={dmin} "
                  f"D={d}: {cuda_ms(fn, 5):.4f} ms, {plan.blocks} segments of "
                  f"{plan.columns} columns a row, bound {lim['bound_ms']:.4f} ms "
                  f"(bytes), max_abs_err {err}; {card}")
        del left, right
    for h, d, w in UNREFUSED_WTA:
        aggr = rand(4000, (1, h, d, w), np.uint16)
        for dmin in (0, 24):
            opt = SGMOptions(min_disparity=dmin, max_disparity=dmin + d)
            fn = lambda: kernels.wta_reduce(aggr, opt)
            err = planes_err(_flat(fn()), _flat(kernels.wta_reduce_plain(aggr, opt)))
        lim = bound(2 * aggr.numel() + 40 * h * w, 2 * 3 * aggr.numel())
        print(f"unrefused, WTA {w}x{h} D={d} both views: {cuda_ms(fn, 5):.4f} ms, "
              f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}), "
              f"max_abs_err {err}; {card}")
        del aggr
    for cfg in DEEP_KERNELS:
        b, h, d, w = cfg["batch"], cfg["h"], cfg["d"], cfg["w"]
        cost, img = rand(128, (b, h, d, w), np.uint8), rand(256, (b, h, w), np.uint8)
        acc = rand(900, (b, h, d, w), np.uint16)
        plans = {(n, wta): kernels.group_plan(cost, acc, n, wta)
                 for n in (1, 3) for wta in (False, True)}
        if any(p.ranges < 2 for p in plans.values()):
            raise AssertionError(f"D={d}: a plan does not split D: {plans}")
        every_group_mode(cost, img, acc)
        print(f"unrefused, sgm_scan_group at D={d} B={b} {w}x{h}: every mode "
              f"bit-equal to its plain version (max_abs_err 0.0); the 3-direction "
              f"plan with the epilogue {plans[3, True]._asdict()}")
        del cost, img, acc


def unrefused_frames(card: str) -> None:
    """The engine where it once refused: ``match_batch`` at D =
    4,096 (256x512) and on a row of 20,000 columns (48 rows, D = 64), each
    bit-equal to the plain path on the card with the main path's launches
    counted; the long frame through the tiled engine on a 1x1 mesh,
    bit-equal to the untiled; phase 10's full-size frames again, untiled
    bit-equal to tiled; the K2 forms and the WTA at the D = 4,096 frame
    beside their bounds (kernel table rows 2-4)."""
    import torch

    from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                       SGMOptions)
    from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

    for cfg in (DEEP_FRAME, LONG_FRAME):
        opt = SGMOptions(max_disparity=cfg["dmax"])
        left, right, field = pair(cfg, seed=cfg["dmax"] + 1)
        engine = SGMEngine(opt, device="cuda")
        kernels.reset_launch_counts()
        disp = engine.match_batch(left, right)
        torch.cuda.synchronize()
        launches = counted_launches(
            kernels.LAUNCHES, main_path_launches(cfg["batch"], cfg["h"], cfg["w"],
                                                 cfg["dmax"]), 1,
            f"match_batch at {cfg['w']}x{cfg['h']} D={cfg['dmax']}")
        max_abs_err(disp, sgm_forward(left, right, opt, use_kernels=False))
        valid = torch.isfinite(disp)
        good = ((disp - field).abs() <= 1.0)[valid].float().mean().item()
        ms = cuda_ms(lambda: engine.match_batch(left, right), 3)
        line = (f"unrefused, match_batch {cfg['w']}x{cfg['h']} D={cfg['dmax']} "
                f"B={cfg['batch']}: bit-equal to the plain path, {ms:.3f} ms "
                f"(CUDA events, median of 3), finite "
                f"{valid.float().mean().item():.4f}, {good:.4f} of them within 1 "
                f"of the truth, launches {launches}")
        if cfg is LONG_FRAME:
            tiled = SGMEngine(opt, EngineConfig(tile_mode="exact"), device="cuda",
                              mesh=make_mesh(1, 1))
            max_abs_err(tiled.match_batch(left, right), disp)
            line += (f"; tiled exact on a 1x1 mesh bit-equal, "
                     f"{cuda_ms(lambda: tiled.match_batch(left, right), 3):.3f} ms")
        print(f"{line}; {card}")
        del left, right, field, disp
        torch.cuda.empty_cache()
    for cfg in WIDE_FRAMES:
        opt = SGMOptions(max_disparity=cfg["dmax"])
        left, right, _ = pair(cfg, seed=cfg["dmax"])
        tiled = SGMEngine(opt, EngineConfig(tile_mode="exact"), device="cuda",
                          mesh=make_mesh(1, 1))
        max_abs_err(SGMEngine(opt, device="cuda").match(left, right),
                    tiled.match_batch(left, right))
        print(f"unrefused, phase 10's frame {cfg['w']}x{cfg['h']} D={cfg['dmax']} "
              f"again: SGMEngine.match bit-equal to the tiled engine")
        del left, right
        torch.cuda.empty_cache()
    wide_kernel_times(DEEP_FRAME, card, "unrefused")


def past_resident_kernels(card: str) -> None:
    """Every mode of the group scan over column parts, each bit-equal to its
    plain version: a row past each resident width, a plan in chunks of
    rows, the two shapes once refused; the horizontal pair at D = 16,384
    past its width; the WTA's split window."""
    import numpy as np
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    rng = np.random.default_rng(17)

    def rand(high, shape, dtype=np.uint8):
        return torch.from_numpy(rng.integers(0, high, shape).astype(dtype)).cuda()

    cases = [(d, w, s, "past the resident width") for d, w, s in PAST_RESIDENT]
    cases += [(*CHUNKED, "in chunks of rows")]
    cases += [(d, w, s, "once refused") for d, w, s in ONCE_REFUSED]
    for d, w, s, what in cases:
        t0 = time.perf_counter()
        cost, img, acc = rand(128, (1, s, d, w)), rand(256, (1, s, w)), \
            rand(900, (1, s, d, w), np.uint16)
        plans = {rolls: kernels.group_route(cost, acc, rolls)
                 for rolls in ((0, 1, -1), (1,), (0,))}
        if any(p is None or p.parts < 2 for p in plans.values()):
            raise AssertionError(f"D={d} W={w}: no column parts: {plans}")
        if (what == "in chunks of rows") != (plans[(1,)].rows < s):
            raise AssertionError(f"D={d} W={w} S={s}: chunks {plans}")
        kernels.reset_launch_counts()
        every_group_mode(cost, img, acc)
        print(f"unrefused, sgm_scan_group {what} at D={d} W={w} S={s}: every "
              f"mode bit-equal to its plain version (max_abs_err 0.0); "
              f"resident width {kernels.resident_width(cost.device, d)}, "
              f"column parts (0, 1, -1) {plans[0, 1, -1]._asdict()}; "
              f"{time.perf_counter() - t0:.1f} s")
        del cost, img, acc
        torch.cuda.empty_cache()
    d, h, w = DEEP_PAIR["d"], DEEP_PAIR["h"], DEEP_PAIR["w"]
    cost_t, img_t = rand(128, (1, w, d, h)), rand(256, (1, w, h))
    route = kernels.group_route(cost_t, cost_t, (0,))
    if route is None or route.halo != 0:
        raise AssertionError(f"the horizontal pair at D={d} H={h}: {route}")
    err = max_abs_err(kernels.horizontal_pair_transposed(cost_t, img_t, 10, 150),
                      kernels.directional_scan_group_bidir_plain(
                          cost_t, img_t, None, (0,), (0,), 10, 150, False))
    print(f"unrefused, the horizontal pair at D={d} on a transposed row of {h}: "
          f"bit-equal to its plain version (max_abs_err {err}), column parts "
          f"{route._asdict()}")
    del cost_t, img_t
    h, d, w, dmin = SPLIT_WTA
    aggr = rand(4000, (1, h, d, w), np.uint16)
    opt = SGMOptions(min_disparity=dmin, max_disparity=dmin + d)
    for inverse in (True, False):
        err = planes_err(_flat(kernels.wta_reduce(aggr, opt, inverse)),
                         _flat(kernels.wta_reduce_plain(aggr, opt, inverse)))
    fn = lambda: kernels.wta_reduce(aggr, opt)
    print(f"unrefused, WTA {w}x{h} D={d} dmin={dmin} (two staged windows a "
          f"plane): both views and the forward view alone bit-equal "
          f"(max_abs_err {err}), {cuda_ms(fn, 5):.4f} ms; {card}")


def satellite_frame(card: str) -> None:
    """``SGMEngine.match`` on a satellite strip past the vertical pair's
    resident width: its launches counted (the vertical pair over column
    parts, one ``wta_reduce``), 0.95 of its finite pixels within 1 of the
    truth, its time; the K2 forms and the WTA at its shape beside their
    bounds (kernel table rows 2-4)."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    cfg = SATELLITE
    opt = SGMOptions(max_disparity=cfg["dmax"])
    left, right, field = pair(cfg, seed=17)
    engine = SGMEngine(opt, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    got = engine.match(left, right)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    per_call = main_path_launches(1, cfg["h"], cfg["w"], cfg["dmax"])
    if not per_call["wta_reduce"]:
        raise AssertionError(f"the satellite strip took no column parts: {per_call}")
    launches = counted_launches(kernels.LAUNCHES, per_call, 1,
                                f"match at {cfg['w']}x{cfg['h']} D={cfg['dmax']}")
    valid = torch.isfinite(got)
    good = ((got - field).abs() <= 1.0)[valid].float().mean().item()
    if good < MIN_GOOD:
        raise AssertionError(f"{cfg['w']}x{cfg['h']} D={cfg['dmax']}: only "
                             f"{good} of the finite pixels lie within 1 of "
                             f"the truth")
    ms = cuda_ms(lambda: engine.match(left, right), 3)
    probe = torch.empty((1, 1, cfg["dmax"], cfg["w"]), dtype=torch.uint8,
                        device="cuda").expand(1, cfg["h"], -1, -1)
    plan = kernels.group_route(probe, probe, (0, 1, -1, 0, -1, 1), True)
    print(f"unrefused, satellite strip {cfg['w']}x{cfg['h']} D={cfg['dmax']} B=1 "
          f"through SGMEngine.match: {ms:.3f} ms (CUDA events, median of 3); "
          f"finite {valid.float().mean().item():.4f}, {good:.4f} of them within "
          f"1 of the truth; launches {launches}; the vertical pair's column "
          f"parts {plan._asdict()}; peak device memory {peak / 2**30:.3f} GiB "
          f"above the inputs; {card}")
    del left, right, field, got
    torch.cuda.empty_cache()
    wide_kernel_times(cfg, card, "unrefused")


def forced_parts_frame(card: str) -> None:
    """Full-resolution Middlebury-2014 (``WIDE_EVAL``'s frame, D = 280)
    through ``SGMEngine.match`` with both pairs' two-order scans forced
    into 2 and 4 column parts (the horizontal pair by the group kernel's
    parts, not the path scan), each bit-equal to the resident route, with
    its launches counted."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions
    from soc_project_stereo_matching_tpu_torch.kernel_ab import forced_parts
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    cfg = WIDE_EVAL
    opt = SGMOptions(max_disparity=cfg["dmax"])
    left, right, _ = pair(dict(cfg, batch=1), seed=cfg["dmax"])
    engine = SGMEngine(opt, device="cuda")
    want = engine.match(left, right)
    for parts in FORCED_PARTS:
        with forced_parts(parts):
            kernels.reset_launch_counts()
            got = engine.match(left, right)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if (launches.get("wta_reduce") != 1
                or launches.get("horizontal_partial") != 2 * parts
                or "horizontal_paths" in launches):
            raise AssertionError(f"{parts} parts forced: not both pairs by "
                                 f"parts ({launches})")
        err = max_abs_err(got, want)
        print(f"unrefused, Middlebury-2014 {cfg['w']}x{cfg['h']} D={cfg['dmax']} "
              f"with both pairs forced into {parts} column parts: bit-equal to "
              f"the resident route (max_abs_err {err}); launches {launches}")
    del left, right, want
    torch.cuda.empty_cache()


def unrefused_phase(card: str) -> None:
    """Phase 11: shapes the port once refused (see the module's docstring)."""
    t0 = time.perf_counter()
    unrefused_kernels(card)
    unrefused_frames(card)
    past_resident_kernels(card)
    satellite_frame(card)
    forced_parts_frame(card)
    print(f"unrefused phase: {time.perf_counter() - t0:.1f} s")


def wide_phase(tmp, card: str) -> None:
    """Phase 10: D > 256 on every main-path kernel and rows over several
    clusters (see the module's docstring)."""
    t0 = time.perf_counter()
    for cfg in WIDE_KERNELS:
        plan = wide_kernel_checks(cfg)
        print(f"wide range, kernels at D={cfg['d']} B={cfg['batch']} "
              f"{cfg['w']}x{cfg['h']}: every mode of sgm_scan_group, the WTA "
              f"kernel, K1 (both modes), K3, K4 and match_batch bit-equal to "
              f"their plain versions (max_abs_err 0.0); the vertical pair's "
              f"plan {plan._asdict()}")
    for cfg in WIDE_FRAMES:
        wide_frame(cfg, card)
    wide_kernel_times(WIDE_FRAMES[-1], card)
    wide_eval(tmp, card)
    print(f"wide range phase: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    import tempfile

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
    # and nothing else: no wta_reduce, no stored aggregated volume
    counted_launches(kernels.LAUNCHES, MAIN_LAUNCHES, 1, "the main path")
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
    launches.update(two_launch_path(dict(CONE, batch=SLICE_BATCH)))
    launches.update(past_paths_range())
    scan_ladder()
    k1_k4_ladder()
    wta_ladder()

    # 5. tile phase
    check_tile_kernels(MIDDLEBURY_HALF, timed=False)
    cone.update(check_tile_kernels(TILE_CONE, timed=True))
    for name in ("census_cost_volume_halo", "directional_scan_group"):
        rec = cone[name]
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms (one cone tile, B=2 125x450 D=64, bit-equal; also at "
              f"1000x1500 D=256 K=4)")
    launches.update(tile_engine_phase())
    launches.update(chained_tile_path(TILE_CONE))
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

    # 8. surfaces, 9. benches, 10. disparity ranges above 256, wide rows,
    # 11. the shapes the port once refused
    with tempfile.TemporaryDirectory() as tmp:
        surfaces_phase(tmp, smi.splitlines()[0])
        launches.update(benches_phase(tmp, smi.splitlines()[0]))
        wide_phase(tmp, smi.splitlines()[0])
        unrefused_phase(smi.splitlines()[0])

    # 12. results
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
