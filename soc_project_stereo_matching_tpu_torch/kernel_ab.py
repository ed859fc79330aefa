"""K1, K4, the WTA and the probe kernels P1/P2, P4 ``scan16``, S1
``speckle_labels``, S2 ``speckle_hist`` and S4 ``speckle_tail_fused`` of
this checkout against another checkout's, on one card.

    python -m soc_project_stereo_matching_tpu_torch.kernel_ab --parent DIR \
        [--reps 20] [--only k4,k1,wta,scan16,s1,chain,s2,s4] \
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
  the warp before the table; exact, held to the plain version).

Needs one CUDA device; prints one line per figure with the card's name and
power limit and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
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
from .utils.profiling import card

# the C entry each group compares, in the order they run
GROUP_ENTRIES = {"k4": "sgm_remove_speckles", "k1": "sgm_census_cost",
                 "wta": "sgm_wta_reduce", "scan16": "sgm_probe_scan16",
                 "s1": "sgm_probe_speckle_labels", "chain": "sgm_probe_chain",
                 "s2": "sgm_probe_speckle_hist",
                 "s4": "sgm_probe_speckle_fused"}
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
RUN = 10    # back-to-back WTA launches between two events


def patched(text: str, edits) -> str | None:
    """``text`` with each (old, new) replaced once, or None if an ``old`` is
    not in it exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    return text


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked checkout of the commit to compare with")
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
    csrc_other = (Path(args.parent) / "soc_project_stereo_matching_tpu_torch"
                  / "csrc")
    entries = [GROUP_ENTRIES[g] for g in GROUPS if g in only]
    other = build_library("parent", sources_defining(csrc_other, entries))
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
    dev = torch.device("cuda")
    result = {"card": ", ".join(card()), "shapes": {}}
    print(result["card"])

    for label, b, h, w, dmax in S1_SHAPES:
        rec = result["shapes"].setdefault(label, {})
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
        del left, right
        torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
