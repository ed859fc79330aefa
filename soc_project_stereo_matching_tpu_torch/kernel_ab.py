"""K1, K4, the WTA and the probe kernels P1/P2, P4 ``scan16``, S1
``speckle_labels``, S2 ``speckle_hist`` and S4 ``speckle_tail_fused`` of
this checkout against another checkout's, on one card.

    python -m soc_project_stereo_matching_tpu_torch.kernel_ab --parent DIR \
        [--reps 20] [--only k4,k1,wta,scan16,s1,chain,s2,s4,fused,hpair,split,parts,sass] \
        [--out chiprun_out/kernel_ab.json]

``DIR`` is an unpacked copy of the other commit, for example
``git archive <commit> | tar -x -C build/parent`` (``build/`` is
git-ignored).  Its sources that define ``sgm_remove_speckles``,
``sgm_census_cost``, ``sgm_wta_reduce``, ``sgm_probe_scan16`` and
``sgm_probe_speckle_labels`` are built into a library of their own; those C
entries have this checkout's names and signatures, except ``scan16``'s,
which took one direction a launch before its capacity entry existed (both
are called).  ``--only`` picks the groups (default: all; K3 rides with the
WTA).  At the cone geometry (375x450, D=64, B=2, 8, 32) and at
Middlebury-half (1000x1500, D=256, B=1), on seeded synthetic pairs:

* K4 (``sgm_remove_speckles``, on the engine's pre-speckle disparity) and K1
  (``sgm_census_cost``; at Middlebury-half also in halo mode) of both
  checkouts are held bit-equal to each other and to their plain versions,
  then timed by CUDA events in turns: other, this, this, other (median of
  ``--reps`` launches each);
* each K4 launch's device time by kernel, from ``torch.profiler``, for both
  checkouts (the parent's union pass against its flatten, the new tile,
  border, flatten and verdict kernels);
* the speckle probes' path, S1 ``pyr`` (a cluster a frame) + S4 ``fused_agg``
  (``probes/kernels.py``), beside this checkout's K4;
* K1's ablations: this checkout's source with the census window replaced
  by its centre pixel, the popcounts by a constant, or the 16-byte stores
  left out (each a text patch; a patch that no longer applies is reported
  as such), and ``Tensor.fill_`` on the same volume, a PyTorch call that
  writes the same bytes and nothing else;
* the WTA (``sgm_wta_reduce``, both views, on the volume this checkout's
  ``aggregate_paths`` makes of the pair) of both checkouts, held bit-equal
  to each other and to the plain version, then timed in turns as above,
  a call at a time and, since a call's events also hold host time while
  the card waits, a launch at a time in runs of ``RUN`` back-to-back
  launches, beside its byte bound; this checkout's forward view alone and its
  ablations: the reduction replaced by one xor a plane (the staging and
  the loads are left), and the copies left out (the reduction on whatever
  the buffers hold: the compute alone; whole-row blocks only);
* K3 (``lr_check``) on the two views' disparities: its device time from
  ``torch.profiler`` beside its byte bound (12 bytes a pixel);
* P4 ``scan16`` (the vertical group (0, 1, -1), forward, on the pair's cost
  volume) of both checkouts, held bit-equal to each other and to the group
  scan, timed in turns with the shipped group scan
  (``ops.kernels.directional_scan_group``) and, as the floor of its
  dependent chain, ``recurrence_floor``'s ``chain3`` (P1, three directions,
  H steps) at the same shape;
* S1 ``speckle_labels`` in its five modes (block4 where B is a multiple of
  four) on the engine's pre-speckle disparity, both checkouts held
  bit-equal to the plain version (labels and rounds) and timed in turns,
  beside K4 (``ops.kernels.remove_speckles``) and K4's label stage
  (``union_find_labels``); and this checkout's S1 ``base`` with the passes
  of its loop taken out ("barriers only": the steps' barriers and the
  fixed-point test, the rounds the real run took) and with the vertical
  run-min taken out ("no vertical pass", the same rounds), each a text
  patch of the call sites; S1 also at 37x45 B=4 (D=48);
* S4 ``speckle_tail_fused`` (group ``s4``; also at 37x45 B=4) on the
  grouped labels of the engine's pre-speckle disparity: both checkouts held
  bit-equal to the plain version (this one in both modes), the parent's
  aggregated call and this one's default timed in turns, a call at a time
  and in runs of ``RUN``, and the host time to enqueue a call of each;
  device time by ``torch.profiler`` of each, of
  this one's per-pixel control, of K4's tail (``count_verdict``) and of S2
  -> ``root_small`` -> S3 on the same frames, beside S4's byte bound; and
  this checkout's ablations "barriers only" (the launch and the grid
  barriers), "zeroing only" (the labels read, counted into the tables and
  the claimed keys zeroed, no barrier) and "warp merge" (S2's merge across
  the warp before the table; exact, held to the plain version);
* the fused K2 forms (group ``fused``; the other checkout's
  ``sgm_scan_group`` and ``sgm_wta_reduce``, called with the signature its
  source has, ``group_form``): on the horizontal sums of the pair, the
  vertical pair's two-order scan with the WTA epilogue (the main path's,
  this checkout: two launches meeting at the middle row) in turns with the
  other checkout's forms, its two group launches adding onto the sums
  then its WTA, and (where it has one, ``GROUP_TWO_ORDER``) its one
  two-order launch with the epilogue, all held bit-equal to
  ``wta_reduce`` of the same totals first; beside them this checkout's
  scan as one launch (``one_launch_bidir``: both orders in turn on one set
  of clusters), the volume forms of both, the scan's byte bound, and its
  ablations "no row reduction" (the rows stored, handed over and freed,
  the reducers computing no planes), "no partial tracks" (no loads and no
  tracks, the shuffles' merge and the stores kept), "loads only" (the
  tracks' arithmetic replaced by one xor a plane) and "no ring wait"
  (neither role waits on the ring's barriers), each with wrong planes,
  timed only; the horizontal pair on the transposed volume, this
  checkout's two-order scan in turns with the other's, and as one launch;
  and the main path by both routes of the two-order scans
  (``routes_shape``: two launches or one, in turns), the device range of
  the program's ``sgm.aggregate`` span and the batch, at the four shapes and
  at 720p B=1;
* the horizontal pair on the transposed volume (group ``hpair``): this
  checkout's route (the path scan, csrc/path_scan.cu, one launch, up to
  D = 512) in turns with the other's (its library's group-kernel
  two-order scan of the roll-0 direction, two launches, through
  ``kernels._bidir``), bit-equal first, median of ``--reps`` each, at the
  cells' shapes (KITTI-2015 375x1242 D=192 B=1 and 8, Middlebury-2014
  1988x2964 D=280 B=1), at cone B=2, 8, 32, and past the cells' ranges
  (KITTI D = 512 and 1,024, Middlebury D = 384, 512, 760 and 1,024), with
  the path scan's plan and its byte bound (the transposed cost read once,
  half the uint16 sums stored, half read-added);
* D split over the blocks of a cluster (group ``split``, this checkout
  alone: no parent library is built for it) at full-resolution
  Middlebury-2014, 2964x1988 B=1, D = 280 and 760: the vertical pair's
  two-order scan with the WTA epilogue (kernel table row 3w) and the
  horizontal pair on the transposed volume (row 3) with the split forced
  through the C entry's plan argument (``ranges`` = 2, 4, 8, 16 blocks,
  where the card holds such a plan's clusters at once), each held
  bit-equal to the plan's own result, then in turns with it (plan, the
  splits, the splits in reverse, plan); and ``SGMEngine.match`` with the
  fastest split of row 3w forced into every two-order scan, in turns with
  the plan's own route;
* column parts (group ``parts``, this checkout alone) at the first of those
  shapes (2964x1988 B=1, D = 280): the resident route against both pairs'
  two-order scans forced into ``PARTS_FORCED`` column parts
  (``forced_parts``: each part a slice with its halo columns, gathered and
  scattered around the launches; by parts the vertical pair stores its
  volume and ``wta_reduce`` reduces it), each held bit-equal to the
  resident route, then in turns with it: the vertical pair, the
  horizontal pair on the transposed volume, and ``SGMEngine.match``; and
  at a row the card does not hold at once (``PARTS_STRIP``, 36000x512 D =
  256) the vertical pair's route in turns with its slices' launches
  alone, its copies alone and ``wta_reduce`` (``parts_breakdown``);
* the SASS of ``aggregate.cu``, ``census_cost.cu`` and ``wta.cu`` (group
  ``sass``; nvcc and cuobjdump, no launch): each source of both checkouts
  compiled to a cubin with the build's flags, and every kernel both
  define compared instruction by instruction (the group kernel's fifth
  template argument, SPLIT = false, the WTA kernel's third, SPLIT =
  false, and the anonymous namespace's hashed name mapped away):
  identical, different (with the count of differing lines), or in one
  checkout only.

Needs one CUDA device; prints one line per figure with the card's name and
power limit and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import hashlib
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

from . import _build
from .config import SGMOptions
from .data.synthetic import synthetic_pair
from .ops import kernels, postprocess
from .ops.wta import WTAPlanes, finalize_disparity
from .probes import kernels as pk
from .probes import prespeckle_disparity
from .utils.profiling import HBM_BYTES_PER_S, card

# the C entry each group compares, in the order they run
GROUP_ENTRIES = {"k4": "sgm_remove_speckles", "k1": "sgm_census_cost",
                 "wta": "sgm_wta_reduce", "scan16": "sgm_probe_scan16",
                 "s1": "sgm_probe_speckle_labels", "chain": "sgm_probe_chain",
                 "s2": "sgm_probe_speckle_hist",
                 "s4": "sgm_probe_speckle_fused", "fused": "sgm_scan_group",
                 "hpair": "sgm_scan_group", "split": None, "parts": None,
                 "sass": None}
GROUPS = tuple(GROUP_ENTRIES)
ENTRIES = tuple(GROUP_ENTRIES[g] for g in ("k4", "k1", "wta"))   # main path
# scan16's entry before it took a group: one direction a launch
SCAN16_ONE_DIRECTION = ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, \
    *(ctypes.c_int,) * 10, ctypes.c_void_p
# P1/P2's entries before they took a path's lanes (a warp per path)
CHAIN_WARP_PER_PATH = {
    "sgm_probe_chain": _build.SIGNATURES["sgm_probe_chain"][:9] + (
        ctypes.c_void_p,),
    "sgm_probe_chainio": _build.SIGNATURES["sgm_probe_chainio"][:13] + (
        ctypes.c_void_p,)}
CHAIN_GROUP = (0, 1, -1)    # the vertical group
CHAIN_RING = 4              # recurrence_floor's ring
SHAPES = (("cone B=2", 2, 375, 450, 64), ("cone B=8", 8, 375, 450, 64),
          ("cone B=32", 32, 375, 450, 64),
          ("Middlebury-half B=1", 1, 1000, 1500, 256))
S1_SHAPES = SHAPES + (("37x45 B=4", 4, 37, 45, 48),)   # S1 also here
# the horizontal pair at the cells' shapes and the cone's batches, then
# at ranges past the cells' (past D = 512 both checkouts run the group
# kernel: the readings that set the path scan's edge there)
HPAIR_SHAPES = (("KITTI-2015 B=1", 1, 375, 1242, 192),
                ("KITTI-2015 B=8", 8, 375, 1242, 192),
                ("Middlebury full D=280", 1, 1988, 2964, 280)) + SHAPES[:3] + (
    ("KITTI-2015 B=1 D=512", 1, 375, 1242, 512),
    ("KITTI-2015 B=1 D=1024", 1, 375, 1242, 1024),
    ("Middlebury full D=384", 1, 1988, 2964, 384),
    ("Middlebury full D=512", 1, 1988, 2964, 512),
    ("Middlebury full D=760", 1, 1988, 2964, 760),
    ("Middlebury full D=1024", 1, 1988, 2964, 1024))
# the main path's routes also at the 720p frame of the wire protocol
ROUTE_SHAPES = (("720p B=1", 1, 720, 1280, 64),)
# full-resolution Middlebury-2014 at two of its ranges (chip_smoke phase 10)
SPLIT_SHAPES = (("Middlebury full D=280", 1, 1988, 2964, 280),
                ("Middlebury full D=760", 1, 1988, 2964, 760))
SPLIT_RANGES = (2, 4, 8, 16)
# a row the card does not hold at once (the vertical pair's resident width
# is 24,480 columns at D = 256): chip_smoke.py's satellite strip
PARTS_STRIP = ("satellite strip 36000x512 D=256", 1, 512, 36000, 256)
# both pairs forced into column parts at the first of SPLIT_SHAPES:
# (parts, rows a chunk of the vertical pair; 0: all rows, one chunk)
PARTS_FORCED = ((2, 0), (4, 0), (4, 248))
# K1 ablations: (text in csrc/census_cost.cu, its replacement)
ABLATIONS = {
    "no census window": [
        ("census_at(slab_l, W, w, border_row)", "(int)slab_l[2 * W + w]"),
        ("census_at(slab_r, W, w, border_row)", "(int)slab_r[2 * W + w]")],
    "no popcounts": [("(uint8_t)__popc(codes_l[w] ^ r[w])", "(uint8_t)w")],
    "no 16-byte stores": [
        ("*reinterpret_cast<uint4*>(base + c) =",
         "if (c < 0) *reinterpret_cast<uint4*>(base + c) =")],
}
# WTA ablations: (text in csrc/wta.cu, its replacement)
WTA_ABLATIONS = {
    "wta loads only": [
        ("__device__ __forceinline__ void pair_step(Pair& p, unsigned vp, int v0,\n"
         "                                          int v1, int k) {\n",
         "__device__ __forceinline__ void pair_step(Pair& p, unsigned vp, int v0,\n"
         "                                          int v1, int k) {\n"
         "  p.m1 ^= vp + v0 + v1;\n  return;\n")],
    "wta no copies": [
        ("        mbar_expect(smem_addr(full + b), bytes);\n"
         "        bulk_copy(smem_addr(smem + base), (const unsigned char*)g - lead,\n"
         "                  bytes, smem_addr(full + b));",
         "        mbar_expect(smem_addr(full + b), 0);")],
}
# S1 ablations: (text in csrc/probe_speckle.cu, its replacement).  Each
# stops after the rounds the real run took, which the caller puts in
# ``rounds`` before the launch.
_S1_STOP = ("    if (!total) break;\n",
            "    if (it >= __ldcg(rounds + program)) break;\n")
_S1_PASS_CALLS = (
    "        changed |= tile_pass<true>(w, g, mask, lab[a], lab[b], input, big);\n",
    "          scatter_pass(w, g, head, lab[a], slot[0], false);\n",
    "          gather_pass(w, g, head, slot[0], lab[b], slot[1], false, big);\n",
    "          scatter_pass(w, g, head, lab[b], slot[1], true);\n",
    "          gather_pass(w, g, head, slot[1], lab[c], slot[0], true, big);\n",
    "          hrun_pass(w, g, mask, lab[a], lab[b], big);\n",
    "          vrun_pass(w, g, mask, lab[b], lab[c], big);\n",
    "        changed |= tile_pass<false>(w, g, mask, lab[c], lab[b], input, big);\n")
# P1/P2 ablations: (text in csrc/probe_recurrence.cu, its replacement).
# Each changes the result (not compared), to show what a step's time is
# made of: the lanes' shuffles for the path minimum, the neighbour lanes'
# end words, the rings' traffic of `chainio`.
CHAIN_ABLATIONS = {
    "no lane minimum": [
        ("  if (L >= 4) {\n    const unsigned a = __shfl_xor_sync",
         "  if (L >= 64) {\n    const unsigned a = __shfl_xor_sync"),
        ("  if (L == 8) m = __vminu2(m, __shfl_xor_sync(kFull, m, 4, L));\n",
         "")],
    "no neighbour lanes": [
        ("      const unsigned up = __shfl_up_sync(kFull, cur[W - 1], 1, L);\n"
         "      const unsigned dn = __shfl_down_sync(kFull, cur[0], 1, L);\n",
         "      const unsigned up = cur[W - 1], dn = cur[0];\n")],
    "no ring traffic": [
        ("      store_slot<W>(oring, slot, T, t, total);\n", ""),
        ("      load_slot<W>(cring, slot, T, t, cb);  // the next step's\n", ""),
        ("      p2 = pring[slot * PB + p];\n", ""),
        ("      if (extra > 0) load_parked<W>(oring, slot, T, t, park0);\n", ""),
        ("      if (extra > 1) load_parked<W>(oring, slot, T, t, park1);\n", "")],
}
S1_ABLATIONS = {
    "barriers only": [_S1_STOP] + [(call, "") for call in _S1_PASS_CALLS],
    "no vertical pass": [_S1_STOP, (_S1_PASS_CALLS[6], "")],
}
# S4 ablations: (text in csrc/probe_speckle.cu, its replacement), the call
# sites of a round's steps in `tail_kernel`.  Each changes the result (not
# compared).
_S4_STEPS = (
    "    tail_load(lab, r, wide, key);\n",
    "    tail_zero<AGG>(counts, r, per_frame, size, bits, key, keys, vals, "
    "order,\n                   &used);\n",
    "    grid.sync();   // every zero before any add\n",
    "    tail_add<AGG>(counts, key, keys, vals, order, &used);\n",
    "    grid.sync();   // every add before any verdict\n",
    "    tail_verdict(counts, out, r, key, min_area, wide);\n")
# A thread's runs, each added into the block's table (as shipped) ...
_S4_INSERTS = """\
  while (heads) {
    const int p = __ffs(heads) - 1;
    heads &= heads - 1;
    int k = -1;
#pragma unroll
    for (int q = 0; q < kTailLabels; ++q)
      if (q == p) k = key[q / 4][q % 4];
    const unsigned after = seg >> p >> 1;   // the next run's start
    table_add<true>(keys, vals, order, used, k,
                    after ? __ffs(after) : kTailLabels - p, bits);
  }
"""
# ... or first merged across the warp as S2 merges, a round per run: in
# round i each lane offers its i-th run, and the lanes that offer one key
# give their summed lengths to the first of them (the same verdict)
_S4_WARP_MERGE = """\
  const int rounds = (int)__reduce_max_sync(kFull, (unsigned)__popc(heads));
  for (int i = 0; i < rounds; ++i) {
    int k = -1, len = 0;
    if (heads) {
      const int p = __ffs(heads) - 1;
      heads &= heads - 1;
#pragma unroll
      for (int q = 0; q < kTailLabels; ++q)
        if (q == p) k = key[q / 4][q % 4];
      const unsigned after = seg >> p >> 1;
      len = after ? __ffs(after) : kTailLabels - p;
    }
    const unsigned peers = __match_any_sync(kFull, k);
    const int total = __reduce_add_sync(peers, len);
    if (k >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
      table_add<true>(keys, vals, order, used, k, total, bits);
  }
"""
S4_ABLATIONS = {
    # the launch and a round's two grid barriers, nothing read or written
    "barriers only": [(_S4_STEPS[k], "") for k in (0, 1, 3, 5)],
    # the labels read, counted into the tables and the claimed keys
    # zeroed: the work before the first barrier, without the barriers
    "zeroing only": [(_S4_STEPS[k], "") for k in (2, 3, 4, 5)],
    # the count with S2's warp merge before the table (exact)
    "warp merge": [(_S4_INSERTS, _S4_WARP_MERGE)],
}
# the fused K2 forms' ablations: (text in csrc/aggregate.cu, its replacement)
FUSED_ABLATIONS = {
    # the rows still stored, handed over and freed; the reducers compute
    # and store no planes
    "no row reduction": [(
        "    for (int p0 = 0; p0 < np; p0 += per) {   // the same rounds for all\n",
        "    for (int p0 = np; p0 < np; p0 += per) {\n")],
    # no loads and no arithmetic over the chunks; the shuffles' merge, the
    # reads beside the best plane and the stores kept
    "no partial tracks": [(
        "      wta_best<EVEN>(row, best, a.views, dmin, W, c0, on, valid1, d_lo, "
        "d_hi);\n",
        "      wta_best<EVEN>(row, best, a.views, dmin, W, c0, false, valid1, "
        "d_lo, d_hi);\n")],
    # the chunks' arithmetic replaced by one xor a plane, the loads kept
    "loads only": [(
        "        if (i == 0 && d0 == d_lo)\n"
        "          best_init(t[v], c[v][i], d);\n"
        "        else\n"
        "          best_step(t[v], c[v][i], d);\n",
        "        t[v].m1 ^= c[v][i];\n")],
    # neither role waits on the ring's barriers (the arrivals are kept)
    "no ring wait": [
        ("      mbar_wait_cluster(smem_addr(ready + slot), (s / kRing) & 1);\n",
         ""),
        ("      const bool reuse = epi && s >= kRing;\n",
         "      const bool reuse = false;\n")],
}
# sgm_scan_group and its capacity entry before the two-order launch and the
# WTA epilogue
GROUP_BEFORE_FUSED = {
    "sgm_scan_group": (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 14 + (
        ctypes.c_void_p,),
    "sgm_scan_group_capacity": (ctypes.c_void_p, ctypes.c_void_p) + (
        ctypes.c_int,) * 3 + (ctypes.c_void_p,)}
# sgm_scan_group in its first fused form (both orders in one launch, a
# second roll set and its flag, the epilogue's views, dmin and 3-row ring):
# 10 pointers, 20 ints and the stream
GROUP_TWO_ORDER = {
    "sgm_scan_group": (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 20 + (
        ctypes.c_void_p,)}
# sgm_scan_group with ScanPass but before it took the work buffer of
# several clusters an image: 6 pointers, 14 ints and the stream
GROUP_PASSES = {
    "sgm_scan_group": (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 14 + (
        ctypes.c_void_p,)}
# sgm_scan_group and its plan entries with the work buffer but before they
# took the plan argument `ranges` (D split over a cluster's blocks)
GROUP_WORK = {
    "sgm_scan_group": (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 14 + (
        ctypes.c_void_p,),
    "sgm_scan_group_capacity": (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4 + (
        ctypes.c_void_p,),
    "sgm_scan_group_plan": (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 6 + (
        ctypes.c_void_p,)}
RUN = 10    # back-to-back WTA launches between two events


def patched(text: str, edits) -> str | None:
    """``text`` with each (old, new) replaced once, or None if an ``old`` is
    not in it exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    return text


def group_form(texts) -> str:
    """The form of ``sgm_scan_group`` these sources define: "ranges" (this
    checkout's: ScanPass by pointer, the work buffer of several clusters an
    image and the plan argument that splits D), "work" (no plan argument),
    "passes" (ScanPass, no work buffer), "two_order" (its first fused form)
    or "before" (before the fused forms)."""
    texts = list(texts)
    if any("struct ScanPass" in text for text in texts):
        if not any("void* planes, void* work" in text for text in texts):
            return "passes"
        return ("ranges" if any("int dmin, int ranges," in text
                                for text in texts) else "work")
    if any("int two_order" in text for text in texts):
        return "two_order"
    return "before"


def build_library(name: str, sources: dict) -> ctypes.CDLL:
    """Compile {file name: source text} into one library under
    ``build/kernel_ab/`` (keyed by the texts) and load it."""
    digest = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for fname, text in sorted(sources.items()):
        digest.update(fname.encode() + text.encode())
    out = (_build.BUILD_DIR.parent / "kernel_ab"
           / f"{name}-{digest.hexdigest()[:12]}")
    lib = out / "lib.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        paths = []
        for fname, text in sources.items():
            (out / fname).write_text(text)
            paths.append(str(out / fname))
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                               "-o", str(lib), *paths], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                               f"{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    for entry, argtypes in _build.SIGNATURES.items():
        if hasattr(handle, entry):
            getattr(handle, entry).argtypes = argtypes
            getattr(handle, entry).restype = ctypes.c_int
    if hasattr(handle, "sgm_scan_group"):
        for entry, argtypes in {"ranges": {}, "work": GROUP_WORK,
                                "passes": GROUP_PASSES,
                                "two_order": GROUP_TWO_ORDER,
                                "before": GROUP_BEFORE_FUSED}[
                                    group_form(sources.values())].items():
            getattr(handle, entry).argtypes = argtypes
    if (hasattr(handle, "sgm_probe_scan16")
            and not hasattr(handle, "sgm_probe_scan16_capacity")):
        handle.sgm_probe_scan16.argtypes = SCAN16_ONE_DIRECTION
    if hasattr(handle, "sgm_probe_chain") and not any(
            "int lanes" in text for text in sources.values()):
        for entry, argtypes in CHAIN_WARP_PER_PATH.items():
            getattr(handle, entry).argtypes = argtypes
    return handle


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def k4(lib, disp, area):
    b, h, w = disp.shape
    out = torch.empty_like(disp)
    label = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    count = torch.empty_like(label)
    if lib.sgm_remove_speckles(disp.data_ptr(), out.data_ptr(),
                               label.data_ptr(), count.data_ptr(), b, h, w,
                               1.0, area, _stream()):
        raise RuntimeError("sgm_remove_speckles failed")
    return out


def k1(lib, left, right, dmax, halo=False):
    b, h, w = left.shape
    h -= 4 * halo
    out = torch.empty((b, h, dmax, w), dtype=torch.uint8, device=left.device)
    if lib.sgm_census_cost(left.data_ptr(), right.data_ptr(), out.data_ptr(),
                           b, h, w, 0, dmax, int(halo), _stream()):
        raise RuntimeError("sgm_census_cost failed")
    return out


def wta(lib, aggr, dmin: int, inverse: bool = True):
    b, h, d, w = aggr.shape
    out = torch.empty((10 if inverse else 5, b, h, w), dtype=torch.int32,
                      device=aggr.device)
    if lib.sgm_wta_reduce(aggr.data_ptr(), out.data_ptr(), b, h, d, w, dmin,
                          int(inverse), _stream()):
        raise RuntimeError("sgm_wta_reduce failed")
    return out


def scan16(lib, cost, img, rolls, p1, p2):
    """The group (rolls), forward, no restart, by ``lib``'s scan16: as many
    directions a launch as its capacity entry says, or one a direction
    where the entry takes one (a checkout without that entry)."""
    b, s, d, w = cost.shape
    out = torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    args = (cost.data_ptr(), img.data_ptr(), out.data_ptr(), b, s, d, w)
    if hasattr(lib, "sgm_probe_scan16_capacity"):
        dirs = ctypes.c_int(0)
        if (lib.sgm_probe_scan16_capacity(b, d, w, ctypes.addressof(dirs))
                or dirs.value < 1):
            raise RuntimeError("sgm_probe_scan16_capacity failed")
        n = dirs.value
        calls = [(len(rolls[k0:k0 + n]), *(rolls[k0:k0 + n] + (0, 0))[:3], 0,
                  0, p1, p2, int(k0 > 0)) for k0 in range(0, len(rolls), n)]
    else:
        calls = [(0, roll, 0, p1, p2, int(k > 0))
                 for k, roll in enumerate(rolls)]
    for extra in calls:
        if lib.sgm_probe_scan16(*args, *extra, _stream()):
            raise RuntimeError("sgm_probe_scan16 failed")
    return out


def speckle_labels(lib, disp, mode: str, rounds=None):
    """(labels, rounds) of ``lib``'s S1; ``rounds``, if given, is the
    rounds buffer (an ablation reads the rounds to run from it)."""
    b, h, w = disp.shape
    programs = b // pk.BLOCK_FRAMES if mode == "block4" else b
    labels = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    if rounds is None:
        rounds = torch.empty(programs, dtype=torch.int32, device=disp.device)
    scratch = torch.empty((7 if mode == "pyr" else 4, b, h, w),
                          dtype=torch.int32, device=disp.device)
    if lib.sgm_probe_speckle_labels(disp.data_ptr(), labels.data_ptr(),
                                    rounds.data_ptr(), scratch.data_ptr(), b,
                                    h, w, pk.label_bits(w), 1.0,
                                    pk.LABEL_MODES[mode], _stream()):
        raise RuntimeError("sgm_probe_speckle_labels failed")
    return labels, rounds


def chain_call(lib, x, steps, rolls, p1, rings=None, extra=0, lanes=None):
    """``lib``'s P1 (``rings`` None) or P2 on (x, rings); ``lanes`` None for
    an entry that takes none (a warp per path), else the lanes a path
    takes."""
    b, d, p = x.shape
    out = torch.empty_like(x)
    arr = (ctypes.c_int * len(rolls))(*rolls)
    tail = (() if lanes is None else (lanes,)) + (_stream(),)
    if rings is None:
        err = lib.sgm_probe_chain(x.data_ptr(), out.data_ptr(), b, d, p, steps,
                                  len(rolls), ctypes.addressof(arr), p1, *tail)
    else:
        cost, p2 = rings
        err = lib.sgm_probe_chainio(
            x.data_ptr(), cost.data_ptr(), p2.data_ptr(), out.data_ptr(), b, d,
            p, steps, len(rolls), ctypes.addressof(arr), cost.shape[1], extra,
            p1, *tail)
    if err:
        raise RuntimeError(f"sgm_probe_chain{'io' if rings else ''} failed")
    return out


def hist(lib, grouped, h_hist, lo_bits, aggregate: bool):
    """``lib``'s S2 (its zeroing of the counts included)."""
    b = grouped.shape[0]
    counts = torch.empty((b, h_hist, 1 << lo_bits), dtype=torch.int32,
                         device=grouped.device)
    if lib.sgm_probe_speckle_hist(grouped.data_ptr(), counts.data_ptr(), b,
                                  grouped[0].numel(), h_hist << lo_bits,
                                  int(aggregate), _stream()):
        raise RuntimeError("sgm_probe_speckle_hist failed")
    return counts


def fused(lib, grouped, area, h_hist, lo_bits, aggregate: bool):
    """``lib``'s S4 (one launch; the counts a scratch plane)."""
    b = grouped.shape[0]
    out = torch.empty(grouped.shape, dtype=torch.float32, device=grouped.device)
    counts = torch.empty((b, h_hist << lo_bits), dtype=torch.int32,
                         device=grouped.device)
    if lib.sgm_probe_speckle_fused(grouped.data_ptr(), counts.data_ptr(),
                                   out.data_ptr(), b, grouped[0].numel(),
                                   h_hist << lo_bits, area, int(aggregate),
                                   _stream()):
        raise RuntimeError("sgm_probe_speckle_fused failed")
    return out


def sources_defining(csrc: Path, entries) -> dict:
    """{file name: text} of the sources in ``csrc`` that define the C
    entries (each must be defined somewhere)."""
    out = {}
    for entry in entries:
        found = [src for src in sorted(csrc.glob("*.cu"))
                 if f'extern "C" int {entry}(' in src.read_text()]
        if not found:
            raise SystemExit(f"kernel_ab: no source in {csrc} defines {entry}")
        out[found[0].name] = found[0].read_text()
    return out


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(fns: dict, reps: int) -> dict:
    """{name: [ms, ms]}: each timed twice, in the order a, b, b, a."""
    order = list(fns) + list(fns)[::-1]
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(event_ms(fns[name], reps))
    return out


def host_us(fn, reps: int) -> float:
    """Median host microseconds to enqueue one call of ``fn`` (``RUN``
    calls between two reads of the host clock, the card drained before)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RUN):
            fn()
        times.append((time.perf_counter() - t0) / RUN * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_name(key: str) -> str:
    """The bare function name of a profiler's kernel key, e.g. ``void
    (anonymous namespace)::tile_kernel(float const*, ...)`` -> tile_kernel."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].split("::")[-1].strip()


def kernel_ms(fn, calls: int = 5, tries: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` by kernel, from the profiler
    (a window in which the profiler saw no device time is profiled again,
    up to ``tries`` windows; {} if none saw any)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if not total:
            continue
        out[kernel_name(evt.key)] = (out.get(kernel_name(evt.key), 0.0)
                                     + total / 1e3 / calls)
    if not out and tries > 1:
        return kernel_ms(fn, calls, tries - 1)
    return out


def same(got, want, what: str) -> None:
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError(f"{what}: results differ")


def k4_shape(rec, label, b, h, w, dmax, other, this, reps):
    """K4 of both checkouts in turns, by kernel, and S1 pyr + S4 fused_agg."""
    dev = torch.device("cuda")
    opt, disp = prespeckle_disparity(dev, b, h, w, dmax)
    area = opt.min_speckle_area
    want = postprocess.remove_speckles(disp, 1.0, area)
    for name, lib in (("parent", other), ("this", this)):
        same(k4(lib, disp, area), want, f"K4 {name} {label}")
    rec["k4_ms"] = in_turns({
        "parent": lambda: k4(other, disp, area),
        "this": lambda: k4(this, disp, area)}, reps)
    rec["k4_kernels_ms"] = {
        name: kernel_ms(lambda lib=lib: k4(lib, disp, area))
        for name, lib in (("parent", other), ("this", this))}
    labels, _ = pk.speckle_labels(disp, 1.0, "pyr")
    same(labels, pk.flat_to_root_labels(kernels.union_find_labels(disp)),
         f"S1 pyr labels {label}")
    grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area)
    verdict = pk.speckle_tail_fused(grouped, area, h_hist, lo_bits, True)
    same(pk.apply_verdict(disp, pk.ungroup_verdict(verdict, h, w)), want,
         f"S1 pyr + S4 fused_agg {label}")
    rec["cluster_design_ms"] = {
        "pyr": event_ms(lambda: pk.speckle_labels(disp, 1.0, "pyr"),
                        reps),
        "fused_agg": event_ms(lambda: pk.speckle_tail_fused(
            grouped, area, h_hist, lo_bits, True), reps)}
    ms = {name: statistics.median(v) for name, v in rec["k4_ms"].items()}
    print(f"{label} K4 ms parent {rec['k4_ms']['parent']} this "
          f"{rec['k4_ms']['this']} ({ms['parent'] / ms['this']:.1f}x); "
          f"by kernel {json.dumps(rec['k4_kernels_ms'])}; S1 pyr + S4 "
          f"fused_agg {json.dumps(rec['cluster_design_ms'])}")
    del disp, want, labels, grouped, verdict


def k1_shape(rec, label, b, h, w, dmax, left, right, other, this, ablated,
             reps):
    """K1 of both checkouts in turns (and in halo mode at 1000 rows), and
    this checkout's ablations."""
    runs = {"untiled": (left, right, False)}
    if h == 1000:       # the tiled engine's halo census on a 1x1 mesh
        runs["halo"] = tuple(torch.nn.functional.pad(x, (0, 0, 2, 2))
                             for x in (left, right)) + (True,)
    bound = (2 * b * h * w + b * h * w * dmax) / HBM_BYTES_PER_S * 1e3
    rec["k1_bound_ms"] = bound
    for mode, (il, ir, halo) in runs.items():
        want = kernels.census_cost_volume_plain(il, ir, 0, dmax, halo)
        for name, lib in (("parent", other), ("this", this)):
            same(k1(lib, il, ir, dmax, halo), want, f"K1 {name} {label}")
        ms = rec[f"k1_{mode}_ms"] = in_turns({
            "parent": lambda: k1(other, il, ir, dmax, halo),
            "this": lambda: k1(this, il, ir, dmax, halo)}, reps)
        print(f"{label} K1 {mode} ms parent {ms['parent']} this "
              f"{ms['this']}, bound {bound:.4f} ms")
    vol = k1(this, left, right, dmax)
    abl = {name: None if lib is None else
           event_ms(lambda lib=lib: k1(lib, left, right, dmax), reps)
           for name, lib in ablated.items()}
    abl["Tensor.fill_ of the volume"] = event_ms(lambda: vol.fill_(7),
                                                 reps)
    rec["k1_ablations_ms"] = abl
    print(f"{label} K1 ablations ms {json.dumps(abl)}")
    del runs, vol


def wta_shape(rec, label, b, h, w, dmax, left, right, other, this,
              wta_ablated, reps):
    """The WTA of both checkouts in turns, a call and a launch at a time,
    its ablations, then K3 on the two views' disparities."""
    # the WTA on the volume the main path's scans make, then K3
    opt = SGMOptions(max_disparity=dmax)
    aggr = kernels.aggregate_paths(
        kernels.census_cost_volume(left, right, 0, dmax), left, opt)
    want = torch.stack(sum(kernels.wta_reduce_plain(aggr, opt, True), ()))
    for name, lib in (("parent", other), ("this", this)):
        same(wta(lib, aggr, 0), want, f"WTA {name} {label}")
    del want
    px, vol = b * h * w, b * h * w * dmax
    rec["wta_bound_ms"] = (2 * vol + 40 * px) / HBM_BYTES_PER_S * 1e3
    ms = rec["wta_ms"] = in_turns({
        "parent": lambda: wta(other, aggr, 0),
        "this": lambda: wta(this, aggr, 0)}, reps)
    rec["wta_run_ms"] = {name: [t / RUN for t in v] for name, v in in_turns({
        "parent": lambda: [wta(other, aggr, 0) for _ in range(RUN)],
        "this": lambda: [wta(this, aggr, 0) for _ in range(RUN)]},
        reps).items()}
    extra = {"forward view alone": event_ms(
        lambda: wta(this, aggr, 0, False), reps)}
    extra.update({name: None if lib is None else
                  event_ms(lambda lib=lib: wta(lib, aggr, 0), reps)
                  for name, lib in wta_ablated.items()})
    extra["aggr.amin(dim=2), a read of the volume"] = event_ms(
        lambda: aggr.view(torch.int16).amin(dim=2), reps)
    rec["wta_ablations_ms"] = extra
    run = rec["wta_run_ms"]
    print(f"{label} WTA ms parent {ms['parent']} this {ms['this']}; a "
          f"launch in runs of {RUN}: parent {run['parent']} this "
          f"{run['this']}; bound {rec['wta_bound_ms']:.4f} ms; "
          f"{json.dumps(extra)}")
    planes = wta(this, aggr, 0)
    dl = finalize_disparity(WTAPlanes(*planes[:5]), opt)
    dr = finalize_disparity(WTAPlanes(*planes[5:]), opt)
    k3 = lambda: kernels.lr_check(dl, dr, opt.lrcheck_thres, dmax)
    rec["k3_bound_ms"] = 12 * px / HBM_BYTES_PER_S * 1e3
    rec["k3_kernels_ms"] = kernel_ms(k3)
    rec["k3_event_ms"] = event_ms(k3, reps)
    print(f"{label} K3 device ms {json.dumps(rec['k3_kernels_ms'])}, "
          f"events {rec['k3_event_ms']}, bound {rec['k3_bound_ms']:.4f} ms")


def scan16_shape(rec, label, left, right, dmax, other, this, reps):
    """P4 scan16 of both checkouts in turns with the shipped group scan and
    the chain floor (P1 chain3), on the vertical forward group."""
    opt = SGMOptions(max_disparity=dmax)
    p1, p2 = opt.p1, opt.p2_init
    cost = kernels.census_cost_volume(left, right, 0, dmax)
    rolls = (0, 1, -1)
    want = kernels.directional_scan_group(cost, left, None, rolls, False, p1,
                                          p2, False)
    for name, lib in (("parent", other), ("this", this)):
        same(scan16(lib, cost, left, rolls, p1, p2), want,
             f"scan16 {name} {label}")
    b, h, d, w = cost.shape
    x = torch.zeros((b, d, w), dtype=torch.uint16, device=cost.device)
    ms = rec["scan16_ms"] = in_turns({
        "parent": lambda: scan16(other, cost, left, rolls, p1, p2),
        "this": lambda: scan16(this, cost, left, rolls, p1, p2),
        "group scan": lambda: kernels.directional_scan_group(
            cost, left, None, rolls, False, p1, p2, False),
        "chain3": lambda: pk.chain(x, h, rolls, p1)}, reps)
    med = {name: statistics.median(v) for name, v in ms.items()}
    rec["scan16_over_group_scan"] = med["this"] / med["group scan"]
    print(f"{label} scan16 ms parent {ms['parent']} this {ms['this']}; group "
          f"scan {ms['group scan']}; chain3 {ms['chain3']}; this over the "
          f"group scan {rec['scan16_over_group_scan']:.3f}, over the parent "
          f"{med['this'] / med['parent']:.3f}")


def chain_shape(rec, label, b, h, w, dmax, other, this, chain_ablated, reps):
    """P1 ``chain1``/``chain3`` and P2 ``chainio1_b``/``chainio3_b`` (the
    recurrence_floor ladder's shapes: B*H paths of W steps, and the vertical
    group, 3*B*W paths of H steps) of both checkouts, bit-equal to the plain
    versions, then in turns; this checkout's P1 also with each lane count
    the kernel takes, against the one its rule picks."""
    dev = torch.device("cuda")
    opt = SGMOptions(max_disparity=dmax)
    p1, d = opt.p1, dmax
    gen = torch.Generator(device="cpu").manual_seed(9)

    def rand(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen).to(dtype).to(dev)

    shapes = {"1": (rand(0, 65536, (b, d, h), torch.uint16), w, (0,), 1),
              "3": (rand(0, 65536, (b, d, w), torch.uint16), h, CHAIN_GROUP,
                    2)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns, lanes_of = {}, {}
    for key, (x, steps, rolls, extra) in shapes.items():
        n, p = len(rolls), x.shape[2]
        rings = (rand(0, 128, (b, CHAIN_RING, d, p), torch.int32),
                 rand(opt.p1, opt.p2_init + 1, (b, n, CHAIN_RING, p),
                      torch.int32))
        lanes = lanes_of[key] = pk.chain_lanes(d, b * p * n, sms)
        want = {"chain": pk.chain_plain(x, steps, rolls, p1),
                "chainio": pk.chainio_plain(x, *rings, steps, rolls, extra,
                                            p1)}
        for name, lib, ln in (("parent", other, None), ("this", this, lanes)):
            same(chain_call(lib, x, steps, rolls, p1, lanes=ln), want["chain"],
                 f"chain{key} {name} {label}")
            same(chain_call(lib, x, steps, rolls, p1, rings, extra, ln),
                 want["chainio"], f"chainio{key}_b {name} {label}")
            fns[f"{name} chain{key}"] = (
                lambda lib=lib, a=(x, steps, rolls, p1), ln=ln:
                chain_call(lib, *a, lanes=ln))
            fns[f"{name} chainio{key}_b"] = (
                lambda lib=lib, a=(x, steps, rolls, p1, rings, extra), ln=ln:
                chain_call(lib, *a, lanes=ln))
    ms = rec["chain_ms"] = in_turns(fns, reps)
    # a launch at a time in runs of RUN: the wrapper's host time hidden
    run = rec["chain_run_ms"] = {
        name: [v / RUN for v in times] for name, times in in_turns(
            {name: lambda fn=fn: [fn() for _ in range(RUN)]
             for name, fn in fns.items()}, reps).items()}
    rec["chain_lanes"] = lanes_of
    by_lanes = {}
    for key, (x, steps, rolls, _) in shapes.items():
        for ln in (1, 2, 4, 8):
            if 32 * ln >= d:
                by_lanes[f"chain{key} lanes={ln}"] = event_ms(
                    lambda a=(x, steps, rolls, p1), ln=ln:
                    chain_call(this, *a, lanes=ln), reps)
    rec["chain_by_lanes_ms"] = by_lanes
    # this checkout's P1 and P2 with parts of the step taken out, in runs
    x, steps, rolls, extra = shapes["1"]
    rings = (rand(0, 128, (b, CHAIN_RING, d, x.shape[2]), torch.int32),
             rand(opt.p1, opt.p2_init + 1, (b, 1, CHAIN_RING, x.shape[2]),
                  torch.int32))
    abl = {}
    for name, lib in {"whole": this, **chain_ablated}.items():
        if lib is None:
            abl[name] = None
            continue
        for v, io in (("chain1", None), ("chainio1_b", rings)):
            abl[f"{v} {name}"] = event_ms(
                lambda lib=lib, io=io: [chain_call(
                    lib, x, steps, rolls, p1, io, extra, lanes_of["1"])
                    for _ in range(RUN)], reps) / RUN
    rec["chain_ablations_run_ms"] = abl
    for v in ("chain1", "chain3", "chainio1_b", "chainio3_b"):
        par = statistics.median(ms[f"parent {v}"])
        new = statistics.median(ms[f"this {v}"])
        rpar = statistics.median(run[f"parent {v}"])
        rnew = statistics.median(run[f"this {v}"])
        print(f"{label} {v} ms parent {ms[f'parent {v}']} this "
              f"{ms[f'this {v}']} ({par / new:.2f}x); a launch in runs of "
              f"{RUN}: parent {run[f'parent {v}']} this {run[f'this {v}']} "
              f"({rpar / rnew:.2f}x)")
    print(f"{label} chain lanes {lanes_of}; by lanes "
          f"{json.dumps(by_lanes)}; ablations, a launch in runs of {RUN}: "
          f"{json.dumps(abl)}")


def s2_shape(rec, label, b, h, w, dmax, other, this, reps):
    """S2 of both checkouts in both modes on the labels of the engine's
    pre-speckle disparity, bit-equal to the plain version, in turns; the
    device time of this checkout's default call (zeroing and count) and of
    the parent's aggregated one by kernel, beside the byte bound."""
    opt, disp = prespeckle_disparity(torch.device("cuda"), b, h, w, dmax)
    area = opt.min_speckle_area
    labels, _ = pk.speckle_labels(disp, 1.0, "base")
    grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area)
    want = pk.speckle_hist_plain(grouped, h_hist, lo_bits)
    fns = {}
    for name, lib in (("parent", other), ("this", this)):
        for agg in (False, True):
            same(hist(lib, grouped, h_hist, lo_bits, agg), want,
                 f"S2 {name} aggregate={agg} {label}")
            fns[f"{name} aggregate={agg}"] = (
                lambda lib=lib, agg=agg: hist(lib, grouped, h_hist, lo_bits,
                                              agg))
    ms = rec["s2_ms"] = in_turns(fns, reps)
    nbytes = 4 * grouped.numel() + 4 * want.numel()
    rec["s2_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    rec["s2_device_ms"] = {
        "this default": kernel_ms(lambda: hist(this, grouped, h_hist, lo_bits,
                                               True)),
        "parent aggregated": kernel_ms(lambda: hist(other, grouped, h_hist,
                                                    lo_bits, True))}
    total = sum(rec["s2_device_ms"]["this default"].values())
    rec["s2_share_of_bound"] = rec["s2_bound_ms"] / total if total else None
    for mode in ("aggregate=True", "aggregate=False"):
        print(f"{label} S2 {mode} ms parent {ms[f'parent {mode}']} this "
              f"{ms[f'this {mode}']}")
    print(f"{label} S2 device ms {json.dumps(rec['s2_device_ms'])}; bound "
          f"{rec['s2_bound_ms']:.4f} ms ({nbytes} bytes); this default's "
          f"device time {total:.4f} ms = {100 * rec['s2_share_of_bound']:.0f}% "
          f"of the bound" if total else f"{label} S2: no device time")
    del disp, labels, grouped, want


def s4_shape(rec, label, b, h, w, dmax, other, this, s4_ablated, reps):
    """S4 of both checkouts (the parent's with aggregated adds, this one's
    default) in turns, a call at a time and in runs of ``RUN``, on the
    grouped labels of the engine's pre-speckle disparity, bit-equal to the
    plain version in both modes first; the device time of each beside the
    byte bound, of K4's tail (``count_verdict``: flatten + count, verdict)
    and of S2 -> ``root_small`` -> S3 on the same frames, and of this
    checkout's ablations."""
    opt, disp = prespeckle_disparity(torch.device("cuda"), b, h, w, dmax)
    area = opt.min_speckle_area
    labels, _ = pk.speckle_labels(disp, 1.0, "base")
    grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area)
    want = pk.speckle_tail_fused_plain(grouped, area, h_hist, lo_bits)
    for name, lib, modes in (("parent", other, (True,)),
                             ("this", this, (True, False))):
        for agg in modes:
            same(fused(lib, grouped, area, h_hist, lo_bits, agg), want,
                 f"S4 {name} aggregate={agg} {label}")
    flat = kernels.union_find_labels(disp, 1.0)
    same(pk.apply_verdict(disp, pk.ungroup_verdict(want, h, w)),
         kernels.count_verdict(disp, flat, area), f"K4's tail {label}")
    fns = {name: (lambda lib=lib: fused(lib, grouped, area, h_hist, lo_bits,
                                        True))
           for name, lib in (("parent", other), ("this", this))}
    ms = rec["s4_ms"] = in_turns(fns, reps)
    run = rec["s4_run_ms"] = {
        name: [t / RUN for t in v] for name, v in in_turns(
            {name: lambda fn=fn: [fn() for _ in range(RUN)]
             for name, fn in fns.items()}, reps).items()}

    rec["s4_host_us"] = {name: host_us(fn, reps) for name, fn in fns.items()}

    def s2_s3():
        counts = pk.speckle_hist(grouped, h_hist, lo_bits)
        return pk.speckle_verdict(grouped, pk.root_small(counts, area))

    device = {name: kernel_ms(fn) for name, fn in fns.items()}
    device["this, one add a pixel"] = kernel_ms(
        lambda: fused(this, grouped, area, h_hist, lo_bits, False))
    device["K4's tail (count_verdict)"] = kernel_ms(
        lambda: kernels.count_verdict(disp, flat, area))
    device["S2 -> root_small -> S3"] = kernel_ms(s2_s3)
    for name, lib in s4_ablated.items():
        if lib is not None and name == "warp merge":   # the same function
            same(fused(lib, grouped, area, h_hist, lo_bits, True), want,
                 f"S4 {name} {label}")
    device.update({f"this, {name}": None if lib is None else kernel_ms(
        lambda lib=lib: fused(lib, grouped, area, h_hist, lo_bits, True))
        for name, lib in s4_ablated.items()})
    rec["s4_device_ms"] = device
    rec["s4_bound_ms"] = 8 * grouped.numel() / HBM_BYTES_PER_S * 1e3
    rec["s4_plan"] = pk.speckle_tail_plan(b, grouped[0].numel())
    total = {name: None if v is None else sum(v.values())
             for name, v in device.items()}
    rec["s4_device_total_ms"] = total
    rec["s4_share_of_bound"] = (rec["s4_bound_ms"] / total["this"]
                                if total["this"] else None)
    p, t = (statistics.median(ms[n]) for n in ("parent", "this"))
    rp, rt = (statistics.median(run[n]) for n in ("parent", "this"))
    print(f"{label} S4 ms parent {ms['parent']} this {ms['this']} "
          f"({p / t:.2f}x); a launch in runs of {RUN}: parent "
          f"{run['parent']} this {run['this']} ({rp / rt:.2f}x); host us "
          f"to enqueue a call {json.dumps(rec['s4_host_us'])}; plan "
          f"{rec['s4_plan']}")
    share = rec["s4_share_of_bound"]
    print(f"{label} S4 device ms {json.dumps(total)}; bound "
          f"{rec['s4_bound_ms']:.5f} ms, this "
          f"{'not measured' if share is None else f'{100 * share:.0f}%'} "
          f"of it; by kernel {json.dumps(device)}")
    del disp, labels, grouped, want, flat


def s1_shape(rec, label, b, h, w, dmax, other, this, s1_ablated, reps):
    """S1 of both checkouts in every mode, in turns; K4 and its label stage
    beside them; this checkout's ablations at the real run's rounds."""
    opt, disp = prespeckle_disparity(torch.device("cuda"), b, h, w, dmax)
    modes = [m for m in pk.LABEL_MODES
             if m != "block4" or b % pk.BLOCK_FRAMES == 0]
    fns = {}
    for mode in modes:
        want, want_rounds = pk.speckle_labels_plain(disp, 1.0, mode)
        for name, lib in (("parent", other), ("this", this)):
            got, rounds = speckle_labels(lib, disp, mode)
            same(got, want, f"S1 {mode} {name} {label}")
            same(rounds, want_rounds, f"S1 {mode} rounds {name} {label}")
            fns[f"{name} {mode}"] = (
                lambda lib=lib, mode=mode: speckle_labels(lib, disp, mode))
    ms = rec["s1_ms"] = in_turns(fns, reps)
    area = opt.min_speckle_area
    rec["k4_label_stage_ms"] = event_ms(
        lambda: kernels.union_find_labels(disp, 1.0), reps)
    rec["k4_whole_ms"] = event_ms(
        lambda: kernels.remove_speckles(disp, 1.0, area), reps)
    _, rounds = speckle_labels(this, disp, "base")
    abl = {}
    for name, lib in s1_ablated.items():
        abl[name] = None if lib is None else event_ms(
            lambda lib=lib: speckle_labels(lib, disp, "base", rounds.clone()),
            reps)
    rec["s1_ablations_ms"] = abl
    rec["s1_rounds"] = rounds.tolist()
    for mode in modes:
        p = statistics.median(ms[f"parent {mode}"])
        t = statistics.median(ms[f"this {mode}"])
        print(f"{label} S1 {mode} ms parent {ms[f'parent {mode}']} this "
              f"{ms[f'this {mode}']} ({p / t:.2f}x)")
    print(f"{label} K4 label stage {rec['k4_label_stage_ms']:.4f} ms, K4 "
          f"{rec['k4_whole_ms']:.4f} ms; S1 base ablations (rounds "
          f"{rec['s1_rounds']}) {json.dumps(abl)}")


def old_group(lib, cost, img, acc, rolls, reverse: bool, p1: int, p2: int,
              accumulate: bool = True):
    """The group (rolls) added onto ``acc`` (stored into it without
    ``accumulate``) by ``lib``'s ``sgm_scan_group`` in the form
    ``group_form`` names (the form before the fused launches or the first
    fused form, one order a launch), as many directions a launch as its
    capacity entry says."""
    b, s, d, w = cost.shape
    dirs = ctypes.c_int(0)
    first_fused = is_first_fused(lib)
    capacity = ((cost.data_ptr(), acc.data_ptr(), b, d, w)
                + ((0,) if first_fused else ()) + (ctypes.addressof(dirs),))
    if lib.sgm_scan_group_capacity(*capacity) or dirs.value < 1:
        raise RuntimeError("sgm_scan_group_capacity failed")
    for k0 in range(0, len(rolls), dirs.value):
        sub = tuple(rolls[k0:k0 + dirs.value])
        if first_fused:
            two_order_call(lib, cost, img, acc, sub, reverse, p1, p2,
                           accumulate or k0 > 0, n=len(rolls))
            continue
        if lib.sgm_scan_group(cost.data_ptr(), img.data_ptr(), acc.data_ptr(),
                              None, None, None, None, None, b, s, d, w,
                              len(sub), *(sub + (0, 0))[:3], len(rolls),
                              int(reverse), 0, p1, p2,
                              int(accumulate or k0 > 0), _stream()):
            raise RuntimeError("sgm_scan_group failed")
    return acc


def is_first_fused(lib) -> bool:
    """Whether ``lib``'s ``sgm_scan_group`` is its first fused form."""
    return (len(lib.sgm_scan_group.argtypes)
            == len(GROUP_TWO_ORDER["sgm_scan_group"]))


def two_order_call(lib, cost, img, acc, rolls, reverse: bool, p1: int,
                   p2: int, accumulate: bool, rolls_b=None, wta=None,
                   n=None):
    """One launch of ``lib``'s ``sgm_scan_group`` in its first fused form
    (``GROUP_TWO_ORDER``): the directions ``rolls`` in one order or, with
    ``rolls_b``, both orders in the one launch; with ``wta`` = (dmin,
    include_inverse) the epilogue's int32 planes (its ring of 3 rows), else
    None."""
    b, s, d, w = cost.shape
    views = 0 if wta is None else 2 if wta[1] else 1
    fin = planes = None
    if views:
        fin = torch.empty((b, 3, d, w), dtype=torch.uint16, device=cost.device)
        planes = torch.empty((5 * views, b, s, w), dtype=torch.int32,
                             device=cost.device)
    pad = lambda r: (tuple(r) + (0, 0, 0))[:3]
    if lib.sgm_scan_group(cost.data_ptr(), img.data_ptr(), acc.data_ptr(),
                          None, None, None, None, None, kernels._ptr(fin),
                          kernels._ptr(planes), b, s, d, w, len(rolls),
                          *pad(rolls), int(rolls_b is not None),
                          *pad(rolls_b or ()), n or len(rolls), int(reverse), 0,
                          p1, p2, int(accumulate), views,
                          0 if wta is None else wta[0], _stream()):
        raise RuntimeError("sgm_scan_group (first fused form) failed")
    return planes


def one_launch_bidir(cost, img, acc, rolls_f, rolls_b, p1: int, p2_init: int,
                     restart: bool, wta, counter: str, ranges: int = 0,
                     parts: int = 0, rows: int = 0):
    """``kernels._bidir`` with each part of the group in one launch of this
    checkout's kernel: one set of clusters runs both orders in turn (the
    first over all rows, parking its sums; the second adding onto them,
    with the epilogue).  The meeting at the middle row (two launches)
    against one launch.  Where ``ranges``, ``parts`` or ``rows`` are forced
    or the row takes column parts, the two-launch route (``_bidir`` as
    the module has it)."""
    if ranges or parts or rows or kernels.group_route(
            cost, cost if acc is None else acc,
            tuple(rolls_f) + tuple(rolls_b), wta is not None):
        return TWO_LAUNCH_BIDIR(cost, img, acc, rolls_f, rolls_b, p1, p2_init,
                                restart, wta, counter, ranges, parts, rows)
    b, s, d, w = cost.shape
    n = len(rolls_f)
    out = kernels._acc_or_new(acc, cost)
    views, finished, planes = kernels._epilogue_buffers(cost, wta, 1)
    for k0, k1 in kernels._launch_parts(cost, out, n, wta is not None):
        epi = views if k1 == n else 0
        kernels._launch_group(
            counter, cost, img, out,
            [kernels.scan_pass(rolls_f[k0:k1], False, 0, s, k0, d, w),
             kernels.scan_pass(rolls_b[k0:k1], True, 0, s, k0, d, w)],
            2, k1 - k0, n, restart, p1, p2_init, acc is not None or k0 > 0,
            epi, 0 if wta is None else wta[0], finished if epi else None,
            planes if epi else None)
    return out if wta is None else kernels._planes_of(planes)


TWO_LAUNCH_BIDIR = kernels._bidir


class one_launch_route:
    """Run the main path with ``one_launch_bidir`` for ``kernels._bidir``."""

    def __enter__(self):
        self.saved, kernels._bidir = kernels._bidir, one_launch_bidir

    def __exit__(self, *exc):
        kernels._bidir = self.saved


class library:
    """Run the wrappers of ``ops/kernels.py`` on another library."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved, _build._lib = _build.load(), self.lib

    def __exit__(self, *exc):
        _build._lib = self.saved


def stacked(planes) -> torch.Tensor:
    """(forward WTAPlanes, inverse WTAPlanes) -> an int32 (10, ...) tensor."""
    return torch.stack(sum(planes, ()))


def fused_shape(rec, label, b, h, w, dmax, left, right, other, this,
                fused_ablated, reps):
    """The vertical pair's two-order scan with the WTA epilogue (this
    checkout's two launches) in turns with the other checkout's first fused
    form (one launch) and its two group launches + WTA; this checkout's
    one-launch form, volume form, ablations and bound; the horizontal pair
    in turns."""
    opt = SGMOptions(max_disparity=dmax)
    p1, p2 = opt.p1, opt.p2_init
    (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
    cost = kernels.census_cost_volume(left, right, 0, dmax)
    part = kernels.horizontal_partial(cost, left, p1, p2, False)
    first_fused = is_first_fused(other)

    def parent_groups(acc):
        for rolls, reverse in ((rf, False), (rb, True)):
            old_group(other, cost, left, acc, rolls, reverse, p1, p2)
        return wta(other, acc, 0)

    def parent_fused(acc):
        return two_order_call(other, cost, left, acc, rf, False, p1, p2, True,
                              rb, (0, True))

    this_scan = lambda acc: stacked(kernels.directional_scan_group_bidir(
        cost, left, acc, rf, rb, p1, p2, False, (0, True)))
    this_one = lambda acc: stacked(one_launch_bidir(
        cost, left, acc, rf, rb, p1, p2, False, (0, True),
        "directional_scan_group_bidir"))
    want = kernels.directional_scan_group_bidir(cost, left, part.clone(), rf,
                                                rb, p1, p2, False)
    want = stacked(kernels.wta_reduce_plain(want, opt, True))
    fns = {"parent": parent_groups, "this": this_scan}
    if first_fused:
        fns = {"parent groups + WTA": parent_groups,
               "parent fused": parent_fused, "this": this_scan}
    for name, fn in {**fns, "this, one launch": this_one}.items():
        same(fn(part.clone()), want, f"fused: {name} {label}")
    del want
    # the sums the calls add onto wrap around over the runs: no kernel's
    # time depends on the values
    ms = rec["fused_ms"] = in_turns(
        {name: (lambda fn=fn: fn(part)) for name, fn in fns.items()}, reps)
    px, vol = b * h * w, b * h * w * dmax
    rec["fused_bound_ms"] = (3 * vol + px + 40 * px) / HBM_BYTES_PER_S * 1e3
    extra = {
        "this, one launch": event_ms(lambda: this_one(part), reps),
        "two-order scan, volume form": event_ms(
            lambda: kernels.directional_scan_group_bidir(
                cost, left, part, rf, rb, p1, p2, False), reps),
        "one launch, volume form": event_ms(
            lambda: one_launch_bidir(cost, left, part, rf, rb, p1, p2, False,
                                     None, "directional_scan_group_bidir"),
            reps)}
    for name, lib in fused_ablated.items():
        if lib is None:
            extra[name] = None
            continue
        with library(lib):
            extra[name] = event_ms(lambda: this_scan(part), reps)
    rec["fused_ablations_ms"] = extra
    del part
    cost_t = kernels.volume_transpose(cost, pad_to=kernels.TRANSPOSED_PITCH)
    img_t = kernels.image_transpose(left, pad_to=kernels.TRANSPOSED_PITCH)
    del cost
    acc_t = torch.empty(cost_t.shape, dtype=torch.uint16, device=cost_t.device)

    def parent_pair():     # as the parent's horizontal_pair_transposed
        if first_fused:
            two_order_call(other, cost_t, img_t, acc_t, (0,), False, p1, p2,
                           False, (0,))
            return
        for reverse in (False, True):
            old_group(other, cost_t, img_t, acc_t, (0,), reverse, p1, p2,
                      accumulate=reverse)

    this_pair = lambda: kernels.horizontal_pair_transposed(cost_t, img_t, p1,
                                                           p2)
    same(this_pair(), (parent_pair(), acc_t)[1], f"horizontal pair {label}")
    pair_ms = rec["horizontal_pair_ms"] = in_turns(
        {"parent": parent_pair, "this": this_pair}, reps)
    rec["horizontal_pair_one_launch_ms"] = event_ms(
        lambda: one_launch_bidir(cost_t, img_t, None, (0,), (0,), p1, p2,
                                 False, None, "horizontal_partial"), reps)
    med = {name: statistics.median(v) for name, v in ms.items()}
    print(f"{label} vertical pair with the WTA epilogue, ms in turns "
          f"{json.dumps(ms)}; this over "
          + ", ".join(f"{name} {med['this'] / med[name]:.3f}"
                      for name in med if name != "this")
          + f"; bound {rec['fused_bound_ms']:.4f} ms (bytes); "
          f"{json.dumps(extra)}; horizontal pair on the transposed volume "
          f"parent {pair_ms['parent']} this {pair_ms['this']}, this as one "
          f"launch {rec['horizontal_pair_one_launch_ms']:.4f}")
    del cost_t, img_t, acc_t


def hpair_shape(rec, label, b, h, w, dmax, left, right, other, reps):
    """The horizontal pair on the transposed volume: this checkout's route
    (``horizontal_pair_transposed``: the path scan up to D = 512) in
    turns with the other checkout's (its library's group kernel, the
    two-order scan of (0,) by ``kernels._bidir``), bit-equal first."""
    opt = SGMOptions(max_disparity=dmax)
    p1, p2 = opt.p1, opt.p2_init
    cost = kernels.census_cost_volume(left, right, 0, dmax)
    cost_t = kernels.volume_transpose(cost, pad_to=kernels.TRANSPOSED_PITCH)
    img_t = kernels.image_transpose(left, pad_to=kernels.TRANSPOSED_PITCH)
    del cost

    def parent_pair():
        with library(other):
            return kernels._bidir(cost_t, img_t, None, (0,), (0,), p1, p2,
                                  False, None, "horizontal_partial")

    this_pair = lambda: kernels.horizontal_pair_transposed(cost_t, img_t, p1,
                                                           p2)
    same(this_pair(), parent_pair(), f"horizontal pair {label}")
    torch.cuda.empty_cache()
    ms = in_turns({"parent": parent_pair, "this": this_pair}, reps)
    med = {name: statistics.median(v) for name, v in ms.items()}
    bound = (4 * cost_t.numel() + img_t.numel()) / HBM_BYTES_PER_S * 1e3
    plan = (kernels.path_plan(cost_t.device, *cost_t.shape[:1],
                              cost_t.shape[2], cost_t.shape[3])._asdict()
            if kernels.horizontal_route(dmax) == "paths" else None)
    rec["hpair"] = {"ms": ms, "bound_ms": bound, "plan": plan,
                    "steps": cost_t.shape[1]}
    print(f"{label} horizontal pair {cost_t.shape[3]}x{cost_t.shape[1]} "
          f"(transposed) D={dmax}: ms in turns {json.dumps(ms)}; this "
          f"{med['this']:.4f} ms, parent {med['parent']:.4f} ms "
          f"({med['parent'] / med['this']:.2f}x faster, "
          f"{med['this'] / cost_t.shape[1] * 1e3:.3f} us a step); bound "
          f"{bound:.4f} ms (bytes), {bound / med['this']:.1%} of it; plan "
          f"{json.dumps(plan)}; bit-equal")
    del cost_t, img_t
    torch.cuda.empty_cache()


def routes_shape(rec, label, b, h, w, dmax, left, right, reps):
    """The main path by the two routes of the two-order scans, in turns
    (two launches, one launch, one launch, two launches): the device range
    of the program's ``sgm.aggregate`` span (``stage_breakdown.stage_times``)
    and the batch a call at a time (``stage_breakdown.batch_and_enqueue``),
    medians of ``reps`` batches."""
    from . import SGMEngine, stage_breakdown

    opt = SGMOptions(max_disparity=dmax)
    engine = SGMEngine(opt, device="cuda")
    want = engine.match_batch(left, right)
    with one_launch_route():
        same(engine.match_batch(left, right), want, f"routes {label}")
    out = {"two launches": {"k2_ms": [], "batch_ms": []},
           "one launch": {"k2_ms": [], "batch_ms": []}}
    for name in ("two launches", "one launch", "one launch", "two launches"):
        route = one_launch_route() if name == "one launch" else \
            contextlib.nullcontext()
        with route:
            stages = stage_breakdown.stage_times(engine, left, right, reps)
            batch, _ = stage_breakdown.batch_and_enqueue(engine, left, right,
                                                         reps)
        out[name]["k2_ms"].append(stages["sgm.aggregate"]["median"])
        out[name]["batch_ms"].append(batch["median"])
    rec["routes"] = out
    print(f"{label} main path, two-order scans as two launches against one, "
          f"in turns: {json.dumps(out)}")


class forced_split:
    """Run every two-order scan of the main path with D split over
    ``ranges`` blocks (``kernels._bidir``'s plan argument)."""

    def __init__(self, ranges: int):
        self.ranges = ranges

    def __enter__(self):
        self.saved = kernels._bidir
        kernels._bidir = functools.partial(self.saved, ranges=self.ranges)

    def __exit__(self, *exc):
        kernels._bidir = self.saved


class forced_parts:
    """Run every two-order scan of the main path over ``parts`` column
    parts, ``rows`` rows a chunk (0: all), whatever the card holds and
    whatever the caller passes (``kernels._bidir``'s ``parts`` and
    ``rows``; the route's slices do not call ``_bidir``).  The horizontal
    pair too: ``kernels.horizontal_route`` sends it to the group kernel's
    ``_bidir`` at every D."""

    def __init__(self, parts: int, rows: int = 0):
        self.parts, self.rows = parts, rows

    def __enter__(self):
        saved = self.saved = kernels._bidir
        self.saved_route = kernels.horizontal_route

        def forced(*args, **kwargs):
            return saved(*args, **{**kwargs, "parts": self.parts,
                                   "rows": self.rows})
        kernels._bidir = forced
        kernels.horizontal_route = lambda d, parts=0: "group"

    def __exit__(self, *exc):
        kernels._bidir = self.saved
        kernels.horizontal_route = self.saved_route


def parts_shape(rec, label, b, h, w, dmax, left, right, reps):
    """The resident route against both pairs forced into ``PARTS_FORCED``
    column parts (the vertical pair in one chunk of rows, or in chunks),
    bit-equal first, then in turns (resident, the parts, the parts in
    reverse, resident): the vertical pair (with the WTA epilogue where
    resident; by parts its volume and ``wta_reduce``), the horizontal pair
    on the transposed volume (no halo: chunks do not apply), and
    ``SGMEngine.match``."""
    from . import SGMEngine

    opt = SGMOptions(max_disparity=dmax)
    p1, p2 = opt.p1, opt.p2_init
    (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
    cost = kernels.census_cost_volume(left, right, 0, dmax)
    part = kernels.horizontal_partial(cost, left, p1, p2, False)

    def vertical(parts, rows=0):
        return lambda acc: stacked(kernels._bidir(
            cost, left, acc, rf, rb, p1, p2, False, (0, True),
            "directional_scan_group_bidir", parts=parts, rows=rows))

    def name(k, rows):
        return f"parts {k}" + (f" rows {rows}" if rows else "")

    fns = {"resident": vertical(0)}
    want = fns["resident"](part.clone())
    for k, rows in PARTS_FORCED:
        fns[name(k, rows)] = vertical(k, rows)
        same(fns[name(k, rows)](part.clone()), want,
             f"{name(k, rows)} {label}")
    del want
    # the sums the calls add onto wrap around over the runs: no kernel's
    # time depends on the values
    ms = rec["parts_vertical_ms"] = in_turns(
        {name: (lambda fn=fn: fn(part)) for name, fn in fns.items()}, reps)
    del part
    cost_t = kernels.volume_transpose(cost, pad_to=kernels.TRANSPOSED_PITCH)
    img_t = kernels.image_transpose(left, pad_to=kernels.TRANSPOSED_PITCH)
    del cost
    hfns = {f"parts {k}" if k else "resident":
            (lambda k=k: kernels.horizontal_pair_transposed(cost_t, img_t, p1,
                                                             p2, parts=k))
            for k in [0] + sorted({k for k, _ in PARTS_FORCED})}
    want = hfns["resident"]()
    for key, fn in hfns.items():
        same(fn(), want, f"horizontal {key} {label}")
    del want
    hms = rec["parts_horizontal_ms"] = in_turns(hfns, reps)
    del cost_t, img_t
    engine = SGMEngine(opt, device="cuda")

    def forced_match(parts, rows):
        def run():
            with forced_parts(parts, rows):
                return engine.match(left, right)
        return run

    match = {"resident": lambda: engine.match(left, right)}
    want = match["resident"]()
    for k, rows in PARTS_FORCED:
        match[name(k, rows)] = forced_match(k, rows)
        same(match[name(k, rows)](), want, f"match, {name(k, rows)} {label}")
    mms = rec["parts_match_ms"] = in_turns(match, max(3, reps // 4))
    print(f"{label} column parts forced, ms in turns: the vertical pair "
          f"{json.dumps(ms)}, the horizontal pair on the transposed volume "
          f"{json.dumps(hms)}, SGMEngine.match {json.dumps(mms)}; "
          f"{rec.get('card', '')}")


def parts_breakdown(rec, label, b, h, w, dmax, left, right, reps):
    """The vertical pair by column parts where the card does not hold its
    row, in turns with its parts: the route (``_bidir`` with the WTA:
    gathers, launches, scatters, ``wta_reduce``), its slices' launches
    alone on slices gathered before, its copies alone (each slice of the
    cost, the image and the volume gathered, the interior scattered back),
    and ``wta_reduce`` of the totals."""
    opt = SGMOptions(max_disparity=dmax)
    p1, p2 = opt.p1, opt.p2_init
    (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
    cost = kernels.census_cost_volume(left, right, 0, dmax)
    part = kernels.horizontal_partial(cost, left, p1, p2, False)
    route = kernels.group_route(cost, part, rf + rb, True)
    slices = kernels.part_columns(w, route, False)
    gathered = [tuple(kernels._columns(x, lo, hi) for x in (cost, left, part))
                for lo, hi, _, _ in slices]

    def launches():
        for c, g, a in gathered:
            kernels._bidir(c, g, a, rf, rb, p1, p2, False, None,
                           "directional_scan_group_bidir")

    def copies():
        for lo, hi, a, e in slices:
            kernels._columns(cost, lo, hi), kernels._columns(left, lo, hi)
            part[..., a:e] = kernels._columns(part, lo, hi)[..., a - lo:e - lo]

    fns = {"route": lambda: kernels._bidir(
               cost, left, part, rf, rb, p1, p2, False, (0, True),
               "aggregate_paths_wta"),
           "slice launches": launches, "copies": copies,
           "wta_reduce": lambda: kernels.wta_reduce(part, opt)}
    # the sums the calls add onto wrap around over the runs: no kernel's
    # time depends on the values
    ms = rec["parts_breakdown_ms"] = in_turns(fns, reps)
    rec["parts_plan"] = route._asdict()
    print(f"{label} the vertical pair by column parts {route._asdict()}, ms "
          f"in turns: {json.dumps(ms)}; {rec.get('card', '')}")


def split_fits(x, n: int, wta: bool, ranges: int) -> bool:
    """Whether a two-order launch of n directions on ``x``'s shape takes D
    split over ``ranges`` blocks, its clusters all on the card at once."""
    out = torch.empty(x.shape, dtype=torch.uint16, device=x.device)
    plan = kernels.group_plan(x, out, n, wta, 2, ranges)
    return plan.clusters_an_image > 0 and plan.images_a_wave > 0


def split_shape(rec, label, b, h, w, dmax, left, right, reps):
    """Rows 3w and 3 with D split (``SPLIT_RANGES``) in turns with the
    plan's own launches, bit-equal first; the main path with the fastest
    split of row 3w in turns with its own route."""
    from . import SGMEngine

    opt = SGMOptions(max_disparity=dmax)
    p1, p2 = opt.p1, opt.p2_init
    (rf, _), (rb, _) = kernels.scan_groups(opt.num_paths)
    cost = kernels.census_cost_volume(left, right, 0, dmax)
    part = kernels.horizontal_partial(cost, left, p1, p2, False)
    plans = {}

    def vertical(ranges):
        return lambda acc: stacked(kernels._bidir(
            cost, left, acc, rf, rb, p1, p2, False, (0, True),
            "directional_scan_group_bidir", ranges))

    fns = {"plan": vertical(0)}
    want = fns["plan"](part.clone())
    for k in SPLIT_RANGES:
        if not split_fits(cost, 1, True, k):
            continue
        fns[f"split {k}"] = vertical(k)
        same(fns[f"split {k}"](part.clone()), want, f"split {k} {label}")
        plans[f"split {k}"] = kernels.group_plan(
            cost, part, kernels.group_capacity(cost, part, True, k), True, 2,
            k)._asdict()
    del want
    # the sums the calls park on wrap around over the runs: no kernel's time
    # depends on the values
    ms = rec["split_vertical_ms"] = in_turns(
        {name: (lambda fn=fn: fn(part)) for name, fn in fns.items()}, reps)
    del part
    cost_t = kernels.volume_transpose(cost, pad_to=kernels.TRANSPOSED_PITCH)
    img_t = kernels.image_transpose(left, pad_to=kernels.TRANSPOSED_PITCH)
    del cost

    def horizontal(ranges):
        return lambda: kernels._bidir(cost_t, img_t, None, (0,), (0,), p1, p2,
                                      False, None, "horizontal_partial",
                                      ranges)

    hfns = {"plan": horizontal(0)}
    want = hfns["plan"]()
    for k in SPLIT_RANGES:
        if not split_fits(cost_t, 1, False, k):
            continue
        hfns[f"split {k}"] = horizontal(k)
        same(hfns[f"split {k}"](), want, f"horizontal split {k} {label}")
    del want
    hms = rec["split_horizontal_ms"] = in_turns(hfns, reps)
    del cost_t, img_t
    med = {name: statistics.median(v) for name, v in ms.items()}
    best = min((n for n in med if n != "plan"), key=med.get, default=None)
    engine = SGMEngine(opt, device="cuda")

    def forced_match(ranges):
        def run():
            with forced_split(ranges):
                return engine.match(left, right)
        return run

    match = {"plan": lambda: engine.match(left, right)}
    if best is not None:
        match[best] = forced_match(int(best.split()[1]))
        same(match[best](), match["plan"](), f"match, {best} {label}")
    mms = rec["split_match_ms"] = in_turns(match, max(3, reps // 4))
    rec["split_plans"] = plans
    print(f"{label} D split over a cluster's blocks, ms in turns: the "
          f"vertical pair with the WTA epilogue {json.dumps(ms)}, the "
          f"horizontal pair on the transposed volume {json.dumps(hms)}, "
          f"SGMEngine.match {json.dumps(mms)}; the splits' plans "
          f"{json.dumps(plans)}; {rec.get('card', '')}")


SASS_SOURCES = ("aggregate.cu", "census_cost.cu", "wta.cu")
# the anonymous namespace's mangled name, which hashes the file it is in
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(?=\d)")


def sass_functions(src: Path, tmp: Path) -> dict:
    """{kernel name: its SASS instructions} of one source compiled to a
    cubin with the build's flags: each instruction without its address and
    encoding, branch targets as ``ADDR`` (an instruction added ahead moves
    every address after it), the anonymous namespace's name mapped
    away."""
    cubin = tmp / (src.parent.parent.parent.name + "_" + src.stem + ".cubin")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-cubin", "-o",
                    str(cubin), str(src)], check=True)
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = _ANON.sub("ANON", m.group(1))
            funcs[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*.*?\*/", "", line).strip().rstrip(" ;")
            if re.search(r"\b(BRA|BRX|BSSY|CALL|JMP|RET|WARPSYNC)\b", ins):
                ins = re.sub(r"0x[0-9a-f]+", "ADDR", ins)
            funcs[cur].append(_ANON.sub("ANON", ins))
    return funcs


def _changed(a: list, b: list) -> int:
    """Instructions inserted, deleted or replaced between two listings."""
    import difflib

    return sum(max(i2 - i1, j2 - j1) for op, i1, i2, j1, j2 in
               difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
               if op != "equal")


def sass_name(name: str) -> str:
    """This checkout's kernel name as an older checkout spells it: the
    group kernel's fifth template argument and the WTA kernel's third,
    SPLIT = false, mapped away (``sass_compare`` maps a name the other
    checkout does not have)."""
    name = re.sub(r"(group_kernelILi\dELb\dELb\dELb\d)ELb0EEEv", r"\1EEEv",
                  name)
    return re.sub(r"(wta_kernelILb\dELb\d)ELb0EEEv", r"\1EEEv", name)


def sass_compare(csrc_other: Path) -> dict:
    """This checkout's kernels against the other's, SASS line by line."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(csrc / name, Path(tmp)) for csrc in (_build.CSRC, csrc_other)
                for name in SASS_SOURCES]
        with ThreadPoolExecutor(len(jobs)) as ex:
            found = list(ex.map(lambda job: sass_functions(*job), jobs))
    other = {k: v for f in found[len(SASS_SOURCES):] for k, v in f.items()}
    this = {k if k in other else sass_name(k): v
            for f in found[:len(SASS_SOURCES)] for k, v in f.items()}
    both = sorted(set(this) & set(other))
    out = {"identical": [k for k in both if this[k] == other[k]],
           "different": {k: {"changed": _changed(other[k], this[k]),
                             "this": len(this[k]), "other": len(other[k])}
                         for k in both if this[k] != other[k]},
           "only_other": sorted(set(other) - set(this)),
           "only_this": sorted(set(this) - set(other))}
    print(f"SASS of {', '.join(SASS_SOURCES)}: {len(out['identical'])} kernels "
          f"identical to the other checkout's, {len(out['different'])} "
          f"different {out['different']}, {len(out['only_other'])} only in "
          f"the other, {len(out['only_this'])} only in this one")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent",
                    help="an unpacked checkout of the commit to compare with "
                         "(every group but split and parts needs one)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups: " + ", ".join(GROUPS))
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        raise SystemExit(f"kernel_ab: --only takes {', '.join(GROUPS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    csrc_other = (Path(args.parent or ".") /
                  "soc_project_stereo_matching_tpu_torch" / "csrc")
    entries = [GROUP_ENTRIES[g] for g in GROUPS if g in only and GROUP_ENTRIES[g]]
    if "fused" in only and "sgm_wta_reduce" not in entries:
        entries.append("sgm_wta_reduce")    # the parent's form ends with it
    if (entries or "sass" in only) and args.parent is None:
        raise SystemExit("kernel_ab: --parent is needed but for --only "
                         "split,parts")
    other = (build_library("parent", sources_defining(csrc_other, entries))
             if entries else None)
    this = _build.load()

    def ablations(prefix, fname, table, group):
        """{name: library or None (the patch no longer applies)}."""
        if group not in only:
            return {}
        text = (_build.CSRC / fname).read_text()
        texts = {name: patched(text, edits) for name, edits in table.items()}
        return {name: None if t is None else
                build_library(prefix + name.replace(" ", "-"), {fname: t})
                for name, t in texts.items()}

    wta_ablated = ablations("", "wta.cu", WTA_ABLATIONS, "wta")
    s1_ablated = ablations("s1-", "probe_speckle.cu", S1_ABLATIONS, "s1")
    s4_ablated = ablations("s4-", "probe_speckle.cu", S4_ABLATIONS, "s4")
    chain_ablated = ablations("chain-", "probe_recurrence.cu", CHAIN_ABLATIONS,
                              "chain")
    ablated = ablations("k1-", "census_cost.cu", ABLATIONS, "k1")
    fused_ablated = ablations("fused-", "aggregate.cu", FUSED_ABLATIONS,
                              "fused")
    dev = torch.device("cuda")
    result = {"card": ", ".join(card()), "shapes": {}}
    print(result["card"])

    if "sass" in only:
        result["sass"] = sass_compare(csrc_other)
    for label, b, h, w, dmax in HPAIR_SHAPES if "hpair" in only else ():
        rec = result["shapes"].setdefault(label, {"card": result["card"]})
        levels = tuple(dmax * f // 64 for f in (10, 20, 35))
        left, right, _ = synthetic_pair(2, b, h, w, levels)
        left, right = (torch.from_numpy(x).to(dev) for x in (left, right))
        hpair_shape(rec, label, b, h, w, dmax, left, right, other, args.reps)
        del left, right
        torch.cuda.empty_cache()
    for label, b, h, w, dmax in SPLIT_SHAPES if "split" in only else ():
        rec = result["shapes"].setdefault(label, {"card": result["card"]})
        levels = tuple(dmax * f // 64 for f in (10, 20, 35))
        left, right, _ = synthetic_pair(2, b, h, w, levels)
        left, right = (torch.from_numpy(x).to(dev) for x in (left, right))
        split_shape(rec, label, b, h, w, dmax, left, right,
                    max(3, args.reps // 4))
        del left, right
        torch.cuda.empty_cache()
    for label, b, h, w, dmax in SPLIT_SHAPES[:1] if "parts" in only else ():
        rec = result["shapes"].setdefault(label, {"card": result["card"]})
        levels = tuple(dmax * f // 64 for f in (10, 20, 35))
        left, right, _ = synthetic_pair(2, b, h, w, levels)
        left, right = (torch.from_numpy(x).to(dev) for x in (left, right))
        parts_shape(rec, label, b, h, w, dmax, left, right,
                    max(3, args.reps // 4))
        del left, right
        torch.cuda.empty_cache()
    for label, b, h, w, dmax in (PARTS_STRIP,) if "parts" in only else ():
        rec = result["shapes"].setdefault(label, {"card": result["card"]})
        levels = tuple(dmax * f // 64 for f in (10, 20, 35))
        left, right, _ = synthetic_pair(2, b, h, w, levels)
        left, right = (torch.from_numpy(x).to(dev) for x in (left, right))
        parts_breakdown(rec, label, b, h, w, dmax, left, right, 3)
        del left, right
        torch.cuda.empty_cache()
    for label, b, h, w, dmax in S1_SHAPES + ROUTE_SHAPES \
            if only - {"split", "parts", "sass", "hpair"} else ():
        rec = result["shapes"].setdefault(label, {})
        if (label, b, h, w, dmax) in ROUTE_SHAPES:
            if "fused" in only:
                levels = tuple(dmax * f // 64 for f in (10, 20, 35))
                left, right, _ = synthetic_pair(2, b, h, w, levels)
                left, right = (torch.from_numpy(x).to(dev) for x in (left, right))
                routes_shape(rec, label, b, h, w, dmax, left, right, 5)
                del left, right
            continue
        if (label, b, h, w, dmax) not in SHAPES:
            if "s1" in only:
                s1_shape(rec, label, b, h, w, dmax, other, this, s1_ablated,
                         args.reps)
            if "s4" in only:
                s4_shape(rec, label, b, h, w, dmax, other, this, s4_ablated,
                         args.reps)
            continue
        levels = tuple(dmax * f // 64 for f in (10, 20, 35))
        left, right, _ = synthetic_pair(2, b, h, w, levels)
        left, right = (torch.from_numpy(x).to(dev) for x in (left, right))
        if "k4" in only:
            k4_shape(rec, label, b, h, w, dmax, other, this, args.reps)
        if "s1" in only:
            s1_shape(rec, label, b, h, w, dmax, other, this, s1_ablated,
                     args.reps)
        if "k1" in only:
            k1_shape(rec, label, b, h, w, dmax, left, right, other, this,
                     ablated, args.reps)
        if "scan16" in only:
            scan16_shape(rec, label, left, right, dmax, other, this, args.reps)
        if "wta" in only:
            wta_shape(rec, label, b, h, w, dmax, left, right, other, this,
                      wta_ablated, args.reps)
        if "chain" in only:
            chain_shape(rec, label, b, h, w, dmax, other, this,
                        chain_ablated, args.reps)
        if "s2" in only:
            s2_shape(rec, label, b, h, w, dmax, other, this, args.reps)
        if "s4" in only:
            s4_shape(rec, label, b, h, w, dmax, other, this, s4_ablated,
                     args.reps)
        if "fused" in only:
            fused_shape(rec, label, b, h, w, dmax, left, right, other, this,
                        fused_ablated, args.reps)
            routes_shape(rec, label, b, h, w, dmax, left, right, 5)
        del left, right
        torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
