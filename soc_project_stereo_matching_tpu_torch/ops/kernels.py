"""Wrappers of the hand-written CUDA kernels — counterpart of the JAX
package's ``ops/pallas_kernels.py``.

One wrapper per kernel entry, each with its plain PyTorch version beside it:

    census_cost_volume      K1 csrc/census_cost.cu  <- census_cost_volume_pallas
                               (img_has_halo=True: the tiled path's mode)
    aggregate_paths         K2 csrc/aggregate.cu    <- aggregate_paths: the
                               horizontal pair, then the vertical group's
                               two-order scan (two launches, the orders
                               meeting at the middle row)
    aggregate_paths_wta     K2 csrc/aggregate.cu    <- aggregate_paths_wta:
                               the same, the two-order scan's second launch
                               carrying the WTA epilogue (no volume stored)
    horizontal_partial      K2 csrc/path_scan.cu    <- horizontal_partial: three
                               transposes around the horizontal pair on the
                               transposed volume (horizontal_pair_transposed:
                               horizontal_paths, one launch, up to D = 512;
                               the group kernel's two-order scan past it)
    horizontal_paths        K2 csrc/path_scan.cu    <- _bidir_kernel for the
                               roll-0 pair: both orders of every column in one
                               launch, a path's state in a warp's registers
    volume_transpose        P3 csrc/transpose.cu    <- aggr_transpose_probe.py
                               (the transposes around the horizontal pair)
    directional_scan_group  K2 csrc/aggregate.cu    <- directional_scan_group /
                               _scan_group_kernel (with the cross-tile
                               carry-in/out, or with ``wta``: the WTA
                               epilogue of the final launch), one launch
    directional_scan_group_bidir K2 csrc/aggregate.cu <-
                               _directional_scan_group_bidir / _bidir_kernel:
                               both scan orders in two launches that each
                               carry both, meeting at the middle row (volume
                               or, with ``wta``, the planes only)
    scan_direction          K2 csrc/aggregate.cu    one direction alone, the
                               first design's kernel (a warp per path);
                               scan_directions sums several such launches
    wta_reduce              K2 csrc/wta.cu          <- wta_reduce_pallas (both
                               views from one read; wta_online_plain
                               transcribes its online reduction); the tiled
                               path and the tools
    lr_check                K3 csrc/lr_check.cu     <- lr_check_pallas
    remove_speckles         K4 csrc/speckle.cu      <- remove_speckles_pallas
    union_find_labels       K4 csrc/speckle.cu      its label stage alone
    count_verdict           K4 csrc/speckle.cu      its count and verdict alone

``wta_epilogue_plain`` transcribes the group kernel's WTA epilogue (strips
of columns, chunks of planes, partial tracks merged in a tree), and
``directional_scan_group_bidir_plain`` its two-order scan (half-scans,
carries at the meeting row).  A row wider than the card holds at once
(``resident_width``) takes the group scan's route over column parts with
halo columns (``group_route``, ``scan_parts``, ``bidir_parts``): the same
launches on slices of the row, which the plain versions also run where
``parts`` forces the route on CPU tensors.  A wrapper
given CPU tensors runs the plain version.  Given CUDA
tensors it checks device, dtype, shape and contiguity, allocates its outputs
with ``torch.empty``, launches on the current stream, raises if the C entry
returns a CUDA error, and adds one to ``LAUNCHES[<counter>]`` per C entry
call that launches (``group_capacity`` and ``census_segments`` only ask).
The counter is the wrapper's name, except that the halo census counts as
``census_cost_volume_halo``, ``scan_direction`` as ``aggregate_paths``,
``directional_scan_group`` with ``wta`` as ``directional_scan_group_wta``
(``aggregate_paths`` and ``aggregate_paths_wta`` themselves count their
vertical two-order scan's two launches; their horizontal pair counts as
``horizontal_paths``, one launch, and ``volume_transpose``, three; past
D = 512 the pair's group-kernel launches count as ``horizontal_partial``,
two a part: ``horizontal_calls``), and ``union_find_labels`` and
``count_verdict`` as ``remove_speckles``, whose stages they are.  The
``probe_*`` counters belong to the wrappers in ``probes/kernels.py``.
There is no fallback: any other device raises.

The C entries that only ask (``sgm_scan_group_capacity`` on every call of
``_directions``, ``sgm_scan_group_plan`` and ``sgm_census_cost_plan`` where
their plans are not cached yet) each add one to ``PLAN_QUERIES[<entry>]``
and run inside the span ``sgm.plan`` (``utils.profiling.span``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import SGMOptions

from .. import _build
from ..utils.profiling import span
from . import aggregation, census, cost_volume, postprocess
from . import wta as wta_ops
from .wta import WTAPlanes

LAUNCHES = {"census_cost_volume": 0, "aggregate_paths": 0, "wta_reduce": 0,
            "lr_check": 0, "remove_speckles": 0,
            "census_cost_volume_halo": 0, "directional_scan_group": 0,
            "volume_transpose": 0, "horizontal_partial": 0,
            "horizontal_paths": 0,
            "aggregate_paths_wta": 0, "directional_scan_group_wta": 0,
            "directional_scan_group_bidir": 0,
            # the probe kernels, launched by probes/kernels.py
            "probe_chain": 0, "probe_chainio": 0,
            "probe_int16": 0, "probe_speckle_labels": 0,
            "probe_speckle_hist": 0, "probe_speckle_verdict": 0,
            "probe_speckle_fused": 0}


PLAN_QUERIES = {"sgm_scan_group_capacity": 0, "sgm_scan_group_plan": 0,
                "sgm_census_cost_plan": 0, "sgm_path_scan_plan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ask(entry: str, *args) -> None:
    """One call of an asking C entry, in the span ``sgm.plan``, counted in
    ``PLAN_QUERIES``; raises if it returns a CUDA error."""
    fn = getattr(_build.load(), entry)
    with span("plan"):
        err = fn(*args)
    PLAN_QUERIES[entry] += 1
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True if all tensors are on the CPU; raises unless they are all CUDA."""
    devices = {t.device for t in tensors}
    if all(dev.type == "cpu" for dev in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA "
                     f"device, got {[str(t.device) for t in tensors]}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# CUDA errors that an entry returns for a reason of its own
ERRORS = {720: "more work than the blocks the card holds at once can take "
               "(cudaErrorCooperativeLaunchTooLarge)"}


def _launch(entry: str, counter: str, *args) -> None:
    err = getattr(_build.load(), entry)(*args)
    if err != 0:
        why = f": {ERRORS[err]}" if err in ERRORS else ""
        raise RuntimeError(f"{entry}: CUDA error {err}{why}")
    LAUNCHES[counter] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t, offset: int = 0):
    """Address of element ``offset`` of ``t``, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr() + offset * t.element_size()


# --- K1: census + cost volume -------------------------------------------------

def census_cost_volume_plain(img_left, img_right, min_disparity: int,
                             max_disparity: int,
                             img_has_halo: bool = False) -> torch.Tensor:
    cl, cr = census.census_5x5(img_left), census.census_5x5(img_right)
    if img_has_halo:        # the census of the padded tile, cropped
        h = img_left.shape[-2] - 4
        cl, cr = cl[..., 2:2 + h, :], cr[..., 2:2 + h, :]
    return cost_volume.hamming_cost_volume(cl, cr, min_disparity,
                                           max_disparity)


CENSUS_WARPS = 8    # kWarps of csrc/census_cost.cu: one staging row each


def census_smem_bytes(w: int, dmin: int, d: int) -> int:
    """Shared memory of one K1 block that holds a whole row of ``w``
    columns: the warps' staging rows (``w + 15`` bytes rounded up to 16,
    each), the left and right census codes (int32; the right row with
    ``dmin + d - 1`` columns of margin on the left and ``-dmin`` on the
    right) and the two images' 5-row slabs.  A transcription of
    ``smem_bytes`` in ``csrc/census_cost.cu``."""
    left = max(dmin + d - 1, 0)
    right = max(-dmin, 0)
    stage = (w + 30) // 16 * 16
    return CENSUS_WARPS * stage + 4 * (w + left + w + right) + 10 * w


def census_segment_smem_bytes(seg: int, d: int) -> int:
    """Shared memory of one K1 block that takes a segment of ``seg``
    columns: the staging rows, the left codes of its columns, the right
    codes of the ``seg + d - 1`` columns its costs read, and both slabs
    with the census window's 2 columns on each side.  A transcription of
    ``segment_smem_bytes`` in ``csrc/census_cost.cu``."""
    reach = seg + d - 1
    stage = (seg + 30) // 16 * 16
    return CENSUS_WARPS * stage + 4 * (seg + reach) + 5 * (seg + 4) + \
        5 * (reach + 4)


def _last_fit(size, limit: int, hi: int) -> int:
    """The largest n in 0..hi with size(n) <= limit (size grows with n)."""
    lo = 0
    while lo < hi:
        mid = lo + (hi - lo + 1) // 2
        if size(mid) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo


def census_max_width(dmin: int, d: int, smem_limit: int) -> int:
    """The widest row one K1 block holds whole within ``smem_limit`` bytes
    of shared memory; wider rows run in segments (``census_plan``)."""
    return _last_fit(lambda w: census_smem_bytes(w, dmin, d), smem_limit,
                     1 << 20)


class CensusPlan(NamedTuple):
    """How K1 runs a row (``sgm_census_cost_plan``)."""
    blocks: int         # blocks a row (0: no plan)
    columns: int        # columns a block takes (the last the rest)
    segmented: bool     # segments (census_segment_kernel), else a whole row


def census_plan(w: int, dmin: int, d: int, smem_limit: int) -> CensusPlan:
    """K1's plan under ``smem_limit`` bytes: one block a row where
    ``census_smem_bytes`` fits, else segments of equal width, as few as
    ``census_segment_smem_bytes`` allows; no plan (0 blocks) where not even
    one column fits (D past about 25,000).  A transcription of ``plan`` in
    ``csrc/census_cost.cu``."""
    if census_smem_bytes(w, dmin, d) <= smem_limit:
        return CensusPlan(1, w, False)
    widest = _last_fit(lambda n: census_segment_smem_bytes(n, d), smem_limit,
                       w)
    if widest == 0:
        return CensusPlan(0, w, True)
    blocks = -(-w // widest)
    return CensusPlan(blocks, -(-w // blocks), True)


_CENSUS_PLANS = {}     # (device index, W, dmin, D) -> CensusPlan


def census_segments(device: torch.device, w: int, dmin: int,
                    d: int) -> CensusPlan:
    """K1's plan for a row of ``w`` columns at (dmin, D) on ``device``,
    asked once per key from the C entry: one block a row up to 8,924
    columns at D = 64 on an H100, segments past it."""
    key = (device.index, w, dmin, d)
    if key not in _CENSUS_PLANS:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            _ask("sgm_census_cost_plan", w, dmin, d, ctypes.addressof(out))
        _CENSUS_PLANS[key] = CensusPlan(out[0], out[1], bool(out[2]))
    return _CENSUS_PLANS[key]


def census_cost_segments_plain(img_left, img_right, min_disparity: int,
                               max_disparity: int, img_has_halo: bool,
                               seg: int) -> torch.Tensor:
    """K1's segments, transcribed: the row cut into segments of ``seg``
    columns (the last the rest), each computed from its own windows as a
    segment's block stages them: the left slab over its columns and the
    census window's 2 columns on each side, the right slab over the
    ``seg + D - 1`` columns from x0 - dmin - D + 1 (zeros outside the
    image), codes zero on the image's 2-px border (and on its border rows
    unless ``img_has_halo``), costs ``popcount(cl[i] ^ cr[i + D - 1 - k])``,
    127 where x0 + i - dmin - k leaves the image.  Same result as
    ``census_cost_volume_plain``."""
    if seg < 1:
        raise ValueError(f"seg must be >= 1, got {seg}")
    left, right = img_left.to(torch.int32), img_right.to(torch.int32)
    h_in, w = left.shape[-2:]
    h = h_in - 4 if img_has_halo else h_in
    d = max_disparity - min_disparity
    dev = left.device
    rows = torch.arange(h, device=dev)
    y0 = rows - 2 + (2 if img_has_halo else 0)          # slab row 0

    def slab(img, x_first, n):
        """(..., H, 5, n + 4): image rows y0 .. y0 + 4, columns x_first - 2
        .. x_first + n + 1, zeros outside the image."""
        ys = y0[:, None] + torch.arange(5, device=dev)
        xs = x_first - 2 + torch.arange(n + 4, device=dev)
        inside = ((ys >= 0) & (ys < h_in))[:, :, None] & \
            ((xs >= 0) & (xs < w))[None, None, :]
        vals = img[..., ys.clamp(0, h_in - 1)[:, :, None],
                   xs.clamp(0, w - 1)[None, None, :]]
        return torch.where(inside, vals, 0)

    def codes(img, x_first, n):
        s = slab(img, x_first, n)
        center = s[..., 2:3, 2:n + 2]
        code = torch.zeros_like(center)
        for r in range(5):
            for c in range(5):
                code = (code << 1) | (s[..., r:r + 1, c:c + n] < center).to(
                    torch.int32)
        code = code[..., 0, :]
        xs = x_first + torch.arange(n, device=dev)
        keep = (xs >= 2) & (xs < w - 2)
        if not img_has_halo:
            keep = keep & ((rows >= 2) & (rows < h - 2))[:, None]
        return torch.where(keep, code, 0)

    out = []
    ks = torch.arange(d, device=dev)
    for x0 in range(0, w, seg):
        n = min(seg, w - x0)
        r0 = x0 - min_disparity - (d - 1)
        cl, cr = codes(left, x0, n), codes(right, r0, n + d - 1)
        at = torch.arange(n, device=dev)[None, :] + (d - 1 - ks)[:, None]
        ham = cost_volume.popcount32(cl[..., None, :] ^ cr[..., at])
        src = x0 + torch.arange(n, device=dev)[None, :] - \
            (min_disparity + ks)[:, None]
        out.append(torch.where((src >= 0) & (src < w), ham,
                               cost_volume.BORDER_COST).to(torch.uint8))
    return torch.cat(out, dim=-1)


def census_cost_volume(img_left: torch.Tensor, img_right: torch.Tensor,
                       min_disparity: int, max_disparity: int,
                       img_has_halo: bool = False) -> torch.Tensor:
    """uint8 (B, H, W) pair -> uint8 (B, H, D, W) cost volume.

    ``img_has_halo``: the images are (B, H+4, W) H-tiles with 2 neighbour
    rows on each side; the output has H rows and no row-border masking (the
    tiled caller fixes the image's global border rows).  On the card a block
    holds one row's image slab, census codes and staging rings in shared
    memory up to 8,924 columns at D = 64; a wider row runs in segments, a
    block each (``census_segments``), at any width.  Only a range too deep
    for a segment of one column (D past about 25,000) raises
    ``ValueError``."""
    if _on_cpu(img_left, img_right):
        return census_cost_volume_plain(img_left, img_right, min_disparity,
                                        max_disparity, img_has_halo)
    _check(img_left, "img_left", torch.uint8, 3)
    _check(img_right, "img_right", torch.uint8, 3)
    if img_left.shape != img_right.shape:
        raise ValueError("left and right images differ in shape")
    b, h, w = img_left.shape
    if img_has_halo:
        h -= 4
        if h < 0:
            raise ValueError(f"a halo image needs >= 4 rows, got {h + 4}")
    d = max_disparity - min_disparity
    if census_segments(img_left.device, w, min_disparity, d).blocks == 0:
        raise ValueError(f"D={d}: K1 (census_cost_volume) holds the right "
                         f"image's D - 1 columns of reach in a block's "
                         f"shared memory; not even a segment of one column "
                         f"fits at this depth")
    out = torch.empty((b, h, d, w), dtype=torch.uint8, device=img_left.device)
    _launch("sgm_census_cost",
            "census_cost_volume_halo" if img_has_halo else "census_cost_volume",
            img_left.data_ptr(), img_right.data_ptr(), out.data_ptr(), b, h, w,
            min_disparity, d, int(img_has_halo), _stream(out))
    return out


# --- K2: path aggregation + WTA -------------------------------------------------

# The WTA's latch is cost << WTA_KEY_SHIFT | k in an int32: a cost is at most
# 65535 (the inverse view's sentinel), so k < 2^14 and D <= 16,384, the
# bound of the JAX package's wta_reduce_pallas.
WTA_KEY_SHIFT = 14
MAX_RANGE = 1 << WTA_KEY_SHIFT


def check_range(d: int) -> None:
    """Refuse a disparity range the kernels and their plain versions do not
    take: D outside 1..16,384."""
    if not 1 <= d <= MAX_RANGE:
        raise ValueError(f"disparity range {d} outside 1..{MAX_RANGE}: "
                         f"cost << {WTA_KEY_SHIFT} | k no longer fits an "
                         f"int32 argmin key")


def _check_scan(cost: torch.Tensor, img: torch.Tensor):
    """Validate a scan's uint8 (B, S, D, W) cost and (B, S, W) image for
    the kernel; return (B, S, D, W)."""
    _check(cost, "cost", torch.uint8, 4)
    _check(img, "img", torch.uint8, 3)
    b, s, d, w = cost.shape
    if img.shape != (b, s, w):
        raise ValueError(f"image {tuple(img.shape)} does not match cost "
                         f"{tuple(cost.shape)}")
    check_range(d)
    return b, s, d, w


MAX_GROUP = 3       # most directions of one sgm_scan_group launch
P_CLAMP = 1024      # the kernel clamps P1 and P2': beyond 255 they never win
# the transposed volumes' rows are padded to this many elements, so that
# every row starts on a 16-byte boundary (the padding: zero cost, zero gray,
# paths of their own that the way back drops)
TRANSPOSED_PITCH = 16


def scan_groups(num_paths: int):
    """The vertical directions of ``DIRECTIONS_8/4`` by scan order:
    ((rolls, reverse), ...), as the JAX package groups them."""
    if num_paths == 8:
        return (((0, 1, -1), False), ((0, -1, 1), True))
    return (((0,), False), ((0,), True))


def p2_table(p1: int, p2_init: int) -> torch.Tensor:
    """The group kernel's table of P2' by |gray difference| (int64, 256):
    ``max(P1, P2_init // (diff + 1))``, clamped like the kernel's."""
    diff = torch.arange(256)
    return torch.clamp(p2_init // (diff + 1), min=p1, max=P_CLAMP)


def _lanes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return lo | (hi << 16)


def packed_step_plain(prev, prev_min, prev_gray, cost_row, gray_row, p1: int,
                      p2_init: int) -> torch.Tensor:
    """``aggregation._dp_step`` the way the group kernel computes it: two
    neighbouring columns in the 16-bit lanes of one word, P2' from
    ``p2_table``, P1 clamped, lane-wise minima, one add-and-min, and
    ``(cost + m - pmin) & 0x00FF00FF``.  int (..., D, P) rows with P even ->
    the (..., D, P) int64 step result; for the tests, which hold it against
    ``_dp_step`` over the uint8 domain."""
    def pack(x):
        x = x.to(torch.int64)
        return _lanes(x[..., 0::2], x[..., 1::2])

    def vmin(a, b):     # per 16-bit lane
        return _lanes(torch.minimum(a & 0xFFFF, b & 0xFFFF),
                      torch.minimum(a >> 16, b >> 16))

    sent = _lanes(torch.tensor(aggregation.SENTINEL),
                  torch.tensor(aggregation.SENTINEL))
    table = p2_table(p1, p2_init)
    p2 = table[(gray_row.to(torch.int64) - prev_gray.to(torch.int64)).abs()]
    pmin = pack(prev_min)
    pp2 = (pmin + pack(p2))[..., None, :]
    wc = pack(prev)
    pad = torch.full_like(wc[..., :1, :], int(sent))
    wm = torch.cat([pad, wc[..., :-1, :]], dim=-2)
    wp = torch.cat([wc[..., 1:, :], pad], dim=-2)
    p1pk = min(p1, P_CLAMP) * 0x00010001
    near = vmin(vmin(wm, wp) + p1pk, wc)            # __viaddmin_u16x2
    m = vmin(near, pp2)
    cur = (pack(cost_row) + m - pmin[..., None, :]) & 0x00FF00FF
    out = torch.empty(prev.shape, dtype=torch.int64)
    out[..., 0::2] = cur & 0xFFFF
    out[..., 1::2] = cur >> 16
    return out


def _check_penalties(p1: int, p2_init: int) -> None:
    if p1 < 0 or p2_init < 0:
        raise ValueError(f"penalties must be >= 0, got P1={p1}, "
                         f"P2_init={p2_init}")


def group_directions(cost: torch.Tensor, out: torch.Tensor,
                     wta: bool = False, ranges: int = 0) -> int:
    """``group_capacity`` as the C entry ``sgm_scan_group_capacity`` gives
    it, 0 where no launch takes even one direction of this row: the
    wrappers then take the row in column parts (``group_route``)."""
    return _directions(cost.data_ptr(), out.data_ptr(), cost.shape[0],
                       cost.shape[2], cost.shape[3], wta, ranges)


def _directions(cost_ptr: int, out_ptr: int, b: int, d: int, w: int,
                wta: bool, ranges: int) -> int:
    dirs = ctypes.c_int(0)
    _ask("sgm_scan_group_capacity", cost_ptr, out_ptr, b, d, w, int(wta),
         ranges, ctypes.addressof(dirs))
    return dirs.value


def group_capacity(cost: torch.Tensor, out: torch.Tensor,
                   wta: bool = False, ranges: int = 0) -> int:
    """The most directions one ``sgm_scan_group`` launch takes for this
    uint8 (B, S, D, W) cost and uint16 sum on the current card, with
    (``wta``) or without the WTA epilogue's tracks in shared memory,
    ``MAX_GROUP`` at most: as many as one cluster an image holds the state
    of, else as many as several clusters an image hold with all of one
    image's clusters resident at once (``group_plan``).  A two-order launch
    holds the same state as a one-order launch.  On an NVIDIA H100 80GB
    HBM3 one cluster (16 blocks) takes a direction of rows up to 13,824
    columns at D = 64, 6,720 at D = 128 and 3,264 at D = 256; with the
    epilogue, whose recurrence takes fewer threads a block, up to 12,288,
    6,912 and 3,328 (``tests/test_torch_cuda.py`` finds the limits on the
    card); wider rows take several clusters, up to the 15 clusters of 8
    blocks the card holds at once: 103,680 columns at D = 64, 50,400 at
    D = 128, 24,480 at D = 256 for one direction.  From D =
    ``GROUP_SPLIT_FROM`` (280) on, a group one cluster does not hold whole
    takes clusters whose blocks split D instead, all its directions in one
    launch where they fit (``group_plan``'s ``ranges``, ``group_split``;
    measured faster at 2964x1988 D = 280 and 760 than launches of fewer
    directions or several clusters, PERF.md section 6), and so does every row
    where not even strips of two columns hold one direction's state (D
    above 2,515, 2,514 with the epilogue): up to 24,552 columns at D =
    280, 8,448 at D = 760, 6,336 at D = 1,024 (66 clusters of 2 blocks),
    2,340 at D = 2,516, 1,380 at D = 4,096 and 224 at D = 16,384 for one
    direction (2,400, 1,410 and 224 with the epilogue at the last three).
    These are the card's resident widths (``resident_width``);
    ``tests/test_torch_cuda.py`` reads them from this docstring and finds
    them again by bisection.  Past the widest row the card holds at once
    this raises ``ValueError``, and so it does at any D and width with
    ``ranges`` >= 2 (the split forced over that many blocks, for
    measurements) where the split does not fit: one launch cannot take the
    row.  The wrappers do not ask it there: they take such a row in column
    parts with halo columns (``group_route``, ``scan_parts``).  A launch
    with the epilogue ends a group whose other launches have none
    (``_launch_parts``), so the wrappers take the narrower of the two."""
    dirs = group_directions(cost, out, wta, ranges)
    if dirs < 1:
        _, _, d, w = cost.shape
        plan = group_plan(cost, out, 1, wta, ranges=ranges)
        if plan.clusters_an_image == 0:
            why = "fits no plan"
        else:
            why = (f"needs {plan.clusters_an_image} clusters of "
                   f"{plan.cluster_blocks} blocks resident at once, and the "
                   f"card holds {plan.clusters_at_once}")
        raise ValueError(f"D={d}, W={w}: a row's scan state {why}")
    return dirs


class GroupPlan(NamedTuple):
    """How one ``sgm_scan_group`` launch runs (``sgm_scan_group_plan``)."""
    clusters_an_image: int    # G: 1, or several (0: no plan)
    cluster_blocks: int       # CS
    images_a_wave: int        # images one kernel launch takes (0: none fit)
    clusters_at_once: int     # of this shape on the card (0 where G = 1)
    work_bytes: int           # zeroed device memory the launch needs
    ranges: int               # blocks a strip's D is split over (1: none)


def group_plan(cost: torch.Tensor, out: torch.Tensor, n: int,
               wta: bool = False, sets: int = 1,
               ranges: int = 0) -> GroupPlan:
    """The C entry's plan for a launch of n directions on ``sets`` sets of
    the B images of this cost and sum: one cluster an image where one holds
    the state; else, from D = ``GROUP_SPLIT_FROM`` on and wherever not even
    strips of two columns hold one direction's state, G clusters of
    ``ranges`` blocks that split D (8 where the card holds them at once,
    else 16, 4, 2; ``group_split`` transcribes G); else G clusters of 16 (or
    8) blocks (``group_clusters``); in waves of as many images as the card
    holds at once.  ``ranges`` >= 2 forces the split over that many
    blocks."""
    b, _, d, w = cost.shape
    key = (cost.device.index, b, d, w, n, bool(wta), sets, ranges,
           cost.data_ptr() % 2, out.data_ptr() % 4)
    if key not in _PLANS:
        res = (ctypes.c_longlong * 6)()
        with torch.cuda.device(cost.device):
            _ask("sgm_scan_group_plan", cost.data_ptr(), out.data_ptr(), b, d,
                 w, n, int(wta), sets, ranges, ctypes.addressof(res))
        _PLANS[key] = GroupPlan(*(int(v) for v in res))
    return _PLANS[key]


_PLANS = {}     # (device, shape, n, wta, sets, ranges, alignments) -> GroupPlan


# constants of csrc/aggregate.cu (a CPU test reads them from the source)
GROUP_SMEM = 232448       # kGroupSmem: the most a block takes
GROUP_THREADS = 768       # kGroupThreads
GROUP_WTA_THREADS = 384   # kWtaThreads: the recurrence's with the epilogue
GROUP_MAX_CHUNKS = 8      # kMaxChunks
GROUP_MAX_STAGES = 4      # kMaxStages
GROUP_MAX_CLUSTER = 16    # kMaxCluster
GROUP_SPLIT_CHUNKS = 32   # kSplitChunks: chunks of a range a pair, split
GROUP_SPLIT_FROM = 280    # kSplitFrom: the D from which the split comes first
GROUP_SLOTS = 3           # kSlots: hand-off buffers


def split_depth(d: int, ranges: int):
    """DK, the disparities of each of ``ranges`` blocks that split D (the
    last the rest): ceil(D / ranges) rounded up to a multiple of 4; None
    where that leaves a block without a disparity."""
    dk = _padded(-(-d // ranges), 4)
    return None if (ranges - 1) * dk >= d else dk


def group_smem_bytes(d: int, w: int, n: int, cs: int, g: int = 1,
                     wta: bool = False, ranges: int = 1):
    """Shared memory of one group-kernel block of n directions, with clusters
    of ``cs`` blocks, ``g`` of them an image: the cost slabs' ring, two
    buffers of every
    direction's state (D + 2 rows), the partial minima, the staged and the
    handed-over columns; ``GROUP_SMEM + 1`` where a strip's column pairs
    outnumber the threads; None where the strips leave a block empty.  One
    cluster's strips are ``ceil(W / cs)`` columns rounded up to even, the
    last the rest; several clusters share the row's column pairs out as
    evenly as they can (``strip_bounds``).  ``ranges`` > 1 (D split): a
    cluster of ``cs = ranges`` blocks is one of ``g`` strips, each block
    ``split_depth`` disparities of it (None where a block gets none), up
    to ``GROUP_SPLIT_CHUNKS`` chunks a pair, and every block's range minima
    (three slots) beside the state.  A transcription of ``group_shape`` in
    csrc/aggregate.cu."""
    split = ranges > 1
    strips = g if split else cs * g
    if g == 1 and not split:
        tw = _padded(-(-w // strips), 2)
        if (strips - 1) * tw >= w:
            return None
    else:       # the row's column pairs shared out (strip_start)
        if strips > (w + 1) // 2:
            return None
        tw = 2 * -(-((w + 1) // 2) // strips)
    dk = split_depth(d, ranges) if split else d
    if dk is None:
        return None
    pairs = tw // 2
    threads = GROUP_WTA_THREADS if wta else GROUP_THREADS
    if pairs > threads:
        return GROUP_SMEM + 1
    nch = max(1, min(threads // pairs,
                     GROUP_SPLIT_CHUNKS if split else GROUP_MAX_CHUNKS, dk))
    dc = _padded(-(-dk // nch), 4)
    nch = -(-dk // dc)
    pitch_c, pitch_s = _padded(tw + 15, 16), _padded(tw + 8, 4)
    pitch_m = tw + 4
    col_bytes = _padded(nch * dc, 16)
    recv_dir = 32 + col_bytes + _padded(4 * max(nch, ranges), 16)
    body = _padded(2 * n * (dk + 2) * pitch_s + 4 * n * nch * pitch_m, 16)
    if split:
        body += _padded(GROUP_SLOTS * n * ranges * pitch_m * 2, 16)
    tail = n * col_bytes + 3 * n * recv_dir + (2 * WTA_RING * 8 if wta else 0)
    for stages in range(GROUP_MAX_STAGES, 1, -1):
        need = 576 + stages * dk * pitch_c + body + tail
        if need <= GROUP_SMEM:
            return need
    return GROUP_SMEM + 1


def strip_bounds(w: int, strips: int) -> list:
    """The first column of each of ``strips`` strips of a row, and W: the
    row's column pairs shared out as evenly as they can be, as the group
    kernel splits a row over several clusters (``strip_start``)."""
    pairs = (w + 1) // 2
    return [min(w, 2 * (r * pairs // strips)) for r in range(strips + 1)]


def group_clusters(d: int, w: int, n: int, wta: bool = False,
                   cs: int = GROUP_MAX_CLUSTER, ranges: int = 1):
    """G, the clusters an image takes for n directions at (D, W): 1 where a
    cluster of up to ``cs`` blocks holds a row's state, else the fewest
    clusters of ``cs`` blocks whose strips hold it; None where not even
    strips of two columns do.  The rule of ``choose_cluster`` and
    ``plan_multi`` in csrc/aggregate.cu on a card that places clusters of
    ``cs`` blocks (the H100 places 16).  ``ranges`` > 1: the fewest strips
    (clusters of ``ranges`` blocks splitting D) that hold it, the rule of
    ``plan_split`` for one number of blocks (``group_split``)."""
    g = 1
    while True:
        need = group_smem_bytes(d, w, n, cs, g, wta, ranges)
        if need is None:
            return None
        if need <= GROUP_SMEM:
            return g
        g += 1


def group_split(d: int, w: int, n: int, wta: bool = False,
                ranges: int = 2):
    """G where a cluster of ``ranges`` blocks splits D: the fewest strips
    whose blocks hold the state; None where none do."""
    return group_clusters(d, w, n, wta, ranges, ranges)


# --- K2: rows wider than the card holds at once -------------------------------

# A part's halo (both sides) takes at most this share of the resident width
HALO_SHARE = 4      # 1 / HALO_SHARE


class PartsPlan(NamedTuple):
    """How a scan takes a row that one launch does not (``parts_plan``)."""
    parts: int      # P: column parts of a row, as even as strip_bounds
    halo: int       # k: halo columns on each side of a part
    rows: int       # R: rows a chunk (S: one chunk, no carries)


def parts_plan(w: int, s: int, reach: int, resident: int) -> PartsPlan:
    """The parts of a scan over S rows of W columns whose directions move
    state by at most ``reach`` (max |roll|) columns a step, on a card that
    holds rows of up to ``resident`` columns at once.

    A part of columns [a, b) runs as the slice [a - k, b + k): a step moves
    state by at most ``reach`` columns, so after R steps its interior is
    exact whatever the slice's own edges do, with k = R * reach.  One part
    (no halo, R = S) where the row fits; else R = S where the halo of 2 S *
    reach columns keeps within 1 / ``HALO_SHARE`` of the resident width,
    otherwise the most rows that keep it there (chunks of R rows, carries
    between them); P, the fewest parts as even as ``strip_bounds`` makes
    strips whose widest part plus 2 k columns fits.  The roll-0 direction
    needs no halo (k = 0, R = S).  Pure arithmetic: ``group_route`` gives
    it the card's resident width (``resident_width``)."""
    if w <= resident:
        return PartsPlan(1, 0, s)
    room = resident // HALO_SHARE       # the halo's share
    if reach == 0 or 2 * reach * s <= room:
        rows = s
    else:
        rows = max(1, room // (2 * reach))
    halo = rows * reach
    pairs = (resident - 2 * halo) // 2      # column pairs of a part
    if pairs < 1:
        raise ValueError(f"a card that holds {resident} columns at once "
                         f"takes no part with {halo} halo columns a side")
    return PartsPlan(-(-((w + 1) // 2) // pairs), halo, rows)


_RESIDENT = {}      # (device index, D, ranges) -> columns


def resident_width(device: torch.device, d: int, ranges: int = 0) -> int:
    """The widest row whose scan state one ``sgm_scan_group`` launch of one
    direction (no epilogue) holds on ``device`` at D, asked of the C entry
    ``sgm_scan_group_capacity`` by bisection (a row of this width and one
    column less both fit, whatever the even and odd instances of the
    kernel); ``ranges`` as ``group_plan``'s.  0 where no row fits."""
    key = (device.index, d, ranges)
    if key not in _RESIDENT:
        with torch.cuda.device(device):
            def fits(w):
                return w < 2 or all(_directions(0, 0, 1, d, x, False, ranges)
                                    for x in (w - 1, w))
            lo, hi = 0, 1 << 12
            while fits(hi):
                lo, hi = hi, 2 * hi
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if fits(mid) else (lo, mid)
            _RESIDENT[key] = lo if lo >= 2 and fits(lo) else 0
    return _RESIDENT[key]


def group_route(cost: torch.Tensor, out, rolls, wta: bool = False,
                ranges: int = 0, parts: int = 0, rows: int = 0):
    """The route of a group scan (``rolls``: all the directions it scans,
    both orders of a two-order scan) over this cost: None where one launch
    per part of the group takes the row (every row the card holds at
    once), else the ``PartsPlan`` of its column parts.  ``parts`` >= 1
    forces that many parts (and ``rows`` >= 1 that many rows a chunk; the
    halo then follows), on CPU tensors too; a CPU tensor otherwise takes
    no parts: its plain version takes any width."""
    b, s, d, w = cost.shape
    reach = max(abs(r) for r in rolls)
    if parts >= 1:
        rows = min(rows, s) if rows >= 1 else s
        return PartsPlan(parts, 0 if parts == 1 else rows * reach, rows)
    if rows:
        raise ValueError("rows a chunk go with a number of parts")
    if _on_cpu(cost) or (
            group_directions(cost, out, False, ranges) and
            (not wta or group_directions(cost, out, True, ranges))):
        return None
    return parts_plan(w, s, reach, resident_width(cost.device, d, ranges))


def part_columns(w: int, plan: PartsPlan, restart: bool):
    """[(lo, hi, a, b)]: each part's interior [a, b) and its slice [lo,
    hi), read mod W: k halo columns a side in wrap mode, where the halo
    wraps past the image's edge; in restart mode a slice stops at the
    image's edge, where the kernel's own restart resets the diagonals."""
    bounds = strip_bounds(w, plan.parts)
    if plan.parts < 1 or any(a >= b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"{plan.parts} parts leave one of {w} columns empty")
    k = plan.halo
    if restart:
        return [(max(0, a - k), min(w, b + k), a, b)
                for a, b in zip(bounds, bounds[1:])]
    return [(a - k, b + k, a, b) for a, b in zip(bounds, bounds[1:])]


def row_chunks(s: int, rows: int, reverse: bool):
    """The [r0, r1) chunks of R rows in the order a scan walks them."""
    chunks = [(r0, min(s, r0 + rows)) for r0 in range(0, s, rows)]
    return [(s - r1, s - r0) for r0, r1 in chunks] if reverse else chunks


class ScanPass(ctypes.Structure):
    """One scan order of a group over the rows [lo, hi), as the C entry
    ``sgm_scan_group`` takes it (``ScanPass`` in csrc/aggregate.cu): the
    carry-in (or NULL: fresh paths), the row before the first (image b's at
    ``b * gray_stride``), the carry-out (or NULL), the rolls, the order."""

    _fields_ = [("cin_cost", ctypes.c_void_p), ("cin_min", ctypes.c_void_p),
                ("prev_gray", ctypes.c_void_p),
                ("cout_cost", ctypes.c_void_p), ("cout_min", ctypes.c_void_p),
                ("rolls", ctypes.c_int * MAX_GROUP), ("reverse", ctypes.c_int),
                ("lo", ctypes.c_int), ("hi", ctypes.c_int),
                ("gray_stride", ctypes.c_int)]


WTA_RING = 4    # finished rows of a cluster in flight (kRing): the scratch ring


def scan_pass(rolls, reverse: bool, lo: int, hi: int, k0: int, d: int,
              w: int, carry_in=(None, None), prev_gray=None,
              gray_stride: int = 0, carry_out=(None, None)) -> ScanPass:
    """A ``ScanPass`` over the rows [lo, hi) for the directions ``rolls``,
    the k0-th to the last of their group: the carries' pointers at
    direction k0 of (B, n, D, W) / (B, n, 1, W) int32 tensors;
    ``prev_gray`` is an address (``_ptr``).  The pass holds the carries
    (``tensors``): a launch made later from it (``bidir_launches``) must not
    find their memory handed to another tensor, such as the work buffer of
    a launch of several clusters an image."""
    sp = ScanPass(_ptr(carry_in[0], k0 * d * w), _ptr(carry_in[1], k0 * w),
                  prev_gray, _ptr(carry_out[0], k0 * d * w),
                  _ptr(carry_out[1], k0 * w),
                  (ctypes.c_int * MAX_GROUP)(*rolls), int(reverse), lo, hi,
                  gray_stride)
    sp.tensors = (*carry_in, *carry_out)
    return sp


def _launch_group(counter: str, cost, img, out, passes, npass: int, n: int,
                  carry_n: int, restart: bool, p1: int, p2_init: int,
                  accumulate: bool, views: int = 0, dmin: int = 0,
                  finished=None, planes=None, ranges: int = 0) -> None:
    """One ``sgm_scan_group`` launch of n directions: ``passes`` (ScanPass)
    for len(passes) // npass sets of clusters, npass passes each;
    ``ranges`` as ``group_plan``'s."""
    _check_penalties(p1, p2_init)
    b, s, d, w = cost.shape
    sets = len(passes) // npass
    plan = group_plan(cost, out, n, views > 0, sets, ranges)
    # several clusters an image, or D split: their counts and hand-off in
    # device memory
    work = (torch.zeros(plan.work_bytes, dtype=torch.uint8, device=cost.device)
            if plan.clusters_an_image > 1 or plan.ranges > 1 else None)
    arr = (ScanPass * len(passes))(*passes)
    _launch("sgm_scan_group", counter, cost.data_ptr(), img.data_ptr(),
            out.data_ptr(), _ptr(finished), _ptr(planes), _ptr(work),
            ctypes.addressof(arr), npass, sets, b, s, d, w, n,
            carry_n, int(restart), p1, p2_init, int(accumulate), views, dmin,
            ranges, _stream(out))


def _epilogue_buffers(cost, wta, sets: int):
    """(views, the scratch ring, the planes) of a launch with the WTA
    epilogue on ``sets`` sets of clusters, or (0, None, None)."""
    if wta is None:
        return 0, None, None
    b, s, d, w = cost.shape
    views = 2 if wta[1] else 1
    finished = torch.empty((sets * b, WTA_RING, d, w), dtype=torch.uint16,
                           device=cost.device)
    planes = torch.empty((5 * views, b, s, w), dtype=torch.int32,
                         device=cost.device)
    return views, finished, planes


def _launch_parts(cost, out, n: int, wta: bool, ranges: int = 0):
    """The [k0, k1) ranges of a group's n directions, one a launch: as many
    as a launch takes; with the WTA epilogue (``wta``) the last range as
    many as a launch with the epilogue and one without it both take (a
    two-order scan's first launch stores without it), the ones before it
    as many as a launch without it takes."""
    per = group_capacity(cost, out, ranges=ranges)
    lead = n - min(n, per, group_capacity(cost, out, True, ranges)) if wta \
        else n
    return [(k0, min(k0 + per, lead)) for k0 in range(0, lead, per)] + \
        ([(lead, n)] if wta else [])


def _planes_of(planes: torch.Tensor):
    """int32 (5 or 10, ...) planes -> (forward WTAPlanes, inverse or None)."""
    p = planes.unbind(0)
    return WTAPlanes(*p[:5]), (WTAPlanes(*p[5:]) if len(p) == 10 else None)


def aggregate_paths(cost: torch.Tensor, img_left: torch.Tensor,
                    options: SGMOptions, diagonal_mode: str = "wrap",
                    parts: int = 0, rows: int = 0) -> torch.Tensor:
    """uint8 (B, H, D, W) cost + uint8 (B, H, W) image -> uint16 (B, H, D, W)
    aggregated volume: the horizontal pair (``horizontal_partial``), then
    the two-order scan of the vertical group of ``DIRECTIONS_8/4`` added
    onto it (``directional_scan_group_bidir``'s two launches, counted
    here).  Either pair takes its rows in column parts where the card does
    not hold them at once; ``parts`` (and ``rows``, the vertical pair's
    rows a chunk) force parts on both pairs, on CPU tensors too."""
    on_cpu = _on_cpu(cost, img_left)
    if on_cpu and not parts:
        return aggregation.aggregate_paths(cost, img_left, options, diagonal_mode)
    restart = _check_aggregate(cost, img_left, diagonal_mode, on_cpu)
    out = horizontal_partial(cost, img_left, options.p1, options.p2_init,
                             restart, parts)
    (rolls_f, _), (rolls_b, _) = scan_groups(options.num_paths)
    return _bidir(cost, img_left, out, rolls_f, rolls_b, options.p1,
                  options.p2_init, restart, None, "aggregate_paths",
                  parts=parts, rows=rows)


def _check_aggregate(cost, img_left, diagonal_mode: str,
                     on_cpu: bool = False) -> bool:
    """Validate an aggregation's inputs (for the kernels unless
    ``on_cpu``); return restart."""
    if not on_cpu:
        _check_scan(cost, img_left)
    if diagonal_mode not in ("wrap", "restart"):
        raise ValueError(f"unknown diagonal_mode {diagonal_mode!r}")
    return diagonal_mode == "restart"


def scan_direction_plain(cost, img, axis: str, reverse: bool, roll: int,
                         p1: int, p2_init: int,
                         restart: bool = False) -> torch.Tensor:
    mode = "restart" if restart else "wrap"
    if axis == "h":
        out = aggregation.directional_scan(
            cost.transpose(-1, -3), img.transpose(-1, -2), p1, p2_init,
            reverse, roll, mode)[0].transpose(-1, -3)
    else:
        out = aggregation.directional_scan(cost, img, p1, p2_init, reverse,
                                           roll, mode)[0]
    return out.to(torch.uint16)


FIRST_DESIGN_MAX_RANGE = 256     # sgm_scan_direction: 8 disparities a lane


def scan_direction(cost: torch.Tensor, img: torch.Tensor, axis: str,
                   reverse: bool, roll: int, p1: int, p2_init: int,
                   restart: bool = False, out=None) -> torch.Tensor:
    """One direction of ``DIRECTIONS_8`` alone, one launch of the first
    design's scan kernel (a warp per path): uint8 (B, H, D, W) cost + uint8
    (B, H, W) image -> its uint16 (B, H, D, W) contribution.  ``axis`` 'h'
    scans over W, 'v' over H (``roll`` +-1: the diagonals).  With ``out``
    (uint16, same shape) the contribution is added onto it in place.  For
    the measurement tools and as a second reference for the group kernel:
    the main path goes through ``aggregate_paths``."""
    if axis not in ("h", "v"):
        raise ValueError(f"unknown axis {axis!r}")
    if _on_cpu(cost, img, *(() if out is None else (out,))):
        res = scan_direction_plain(cost, img, axis, reverse, roll, p1,
                                   p2_init, restart)
        if out is None:
            return res
        return out.copy_((out.to(torch.int32) + res.to(torch.int32))
                         .to(torch.uint16))
    b, h, d, w = _check_scan(cost, img)
    if d > FIRST_DESIGN_MAX_RANGE:
        raise ValueError(f"D={d}: the first design's kernel keeps D / 32 "
                         f"disparities a lane in registers, D <= "
                         f"{FIRST_DESIGN_MAX_RANGE} (the group kernel takes "
                         f"more)")
    accumulate = out is not None
    if accumulate:
        _check(out, "out", torch.uint16, 4)
        if out.shape != cost.shape:
            raise ValueError(f"out {tuple(out.shape)} != cost {tuple(cost.shape)}")
    else:
        out = torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    _launch("sgm_scan_direction", "aggregate_paths", cost.data_ptr(),
            img.data_ptr(), out.data_ptr(), b, h, d, w, int(axis == "v"),
            int(reverse), roll, int(restart), p1, p2_init, int(accumulate),
            _stream(out))
    return out


def scan_directions(cost: torch.Tensor, img: torch.Tensor, directions,
                    p1: int, p2_init: int, restart: bool = False,
                    out=None) -> torch.Tensor:
    """The sum over ``directions`` = ((axis, reverse, roll), ...) of
    ``scan_direction``, one launch of the first design's kernel each, every
    launch after the first a read-modify-write of the volume (added onto
    ``out`` if given): what the group kernel is measured against."""
    for axis, reverse, roll in directions:
        out = scan_direction(cost, img, axis, reverse, roll, p1, p2_init,
                             restart, out=out)
    return out


def horizontal_partial_plain(cost, img, p1: int, p2_init: int,
                             restart: bool) -> torch.Tensor:
    mode = "restart" if restart else "wrap"
    cost_t, img_t = cost.transpose(-1, -3), img.transpose(-1, -2)
    total = sum(aggregation.directional_scan(cost_t, img_t, p1, p2_init,
                                             reverse, 0, mode)[0]
                for reverse in (False, True))
    return total.transpose(-1, -3).to(torch.uint16)


def _padded(n: int, pad_to: int) -> int:
    return -(-n // pad_to) * pad_to


def volume_transpose_plain(x: torch.Tensor, inner=None,
                           pad_to: int = 1) -> torch.Tensor:
    b, a, d, c = x.shape
    inner = c if inner is None else inner
    out = x.new_zeros((b, inner, d, _padded(a, pad_to)))
    out[..., :a] = x[..., :inner].permute(0, 3, 2, 1)
    return out


def volume_transpose(x: torch.Tensor, inner=None,
                     pad_to: int = 1) -> torch.Tensor:
    """P3.  (B, A, D, C) -> (B, C, D, A), elements of 1 or 2 bytes: the
    swap of a volume's outer and inner axis, D kept.  One launch.

    The internal pitch of the transposed volumes: with ``pad_to`` the
    result's inner axis is padded with zeros to a multiple of it,
    (B, C, D, A') with A' >= A; with ``inner`` only the first ``inner``
    columns of ``x`` are read (the way back: ``inner`` = the A of before),
    giving (B, inner, D, A)."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous 4-d volume, got "
                         f"{tuple(x.shape)}")
    b, a, d, c = x.shape
    inner = c if inner is None else inner
    if not 0 <= inner <= c or pad_to < 1:
        raise ValueError(f"inner={inner} of {c} columns, pad_to={pad_to}")
    if _on_cpu(x):
        return volume_transpose_plain(x, inner, pad_to)
    if x.element_size() not in (1, 2):
        raise TypeError(f"x: expected 1- or 2-byte elements, got {x.dtype}")
    pitch = _padded(a, pad_to)
    out = torch.empty((b, inner, d, pitch), dtype=x.dtype, device=x.device)
    _launch("sgm_volume_transpose", "volume_transpose", x.data_ptr(),
            out.data_ptr(), b, a, d, inner, c, pitch, x.element_size(),
            _stream(out))
    return out


def image_transpose(img: torch.Tensor, pad_to: int = 1) -> torch.Tensor:
    """uint8 (B, H, W) -> (B, W, H'), by the volume kernel at D = 1."""
    return volume_transpose(img[:, :, None, :], pad_to=pad_to).squeeze(2)


# --- the horizontal pair's path scan (csrc/path_scan.cu) ------------------------

PATHS_MAX_RANGE = 512       # kMaxRange: past it the group kernel takes the pair
PATHS_WORDS = (1, 3, 5, 9, 13, 17)  # words a lane, as instantiated
PATHS_PITCH = 16            # kPitch: the entry takes H a multiple of it
INT32_MAX = 2 ** 31 - 1


def path_lanes(d: int):
    """(L, W) of csrc/path_scan.cu at this D: L lanes of a warp hold a pair
    of neighbouring paths, 4, 8, 16 or 32 for D up to 64, 128, 256, 512;
    each lane W words (one disparity of both paths each), the least of
    ``PATHS_WORDS`` (odd: the lanes' rows W apart fall into different
    banks) with L W >= D.  The same at every batch."""
    if not 1 <= d <= PATHS_MAX_RANGE:
        raise ValueError(f"the path scan takes D in 1..{PATHS_MAX_RANGE}, "
                         f"got {d}")
    lanes = 4 if d <= 64 else 8 if d <= 128 else 16 if d <= 256 else 32
    return lanes, next(w for w in PATHS_WORDS if w * lanes >= d)


def horizontal_route(d: int, parts: int = 0) -> str:
    """Which kernel takes the horizontal pair at this D: ``"paths"``
    (``horizontal_paths``, one launch) up to ``PATHS_MAX_RANGE``, else
    ``"group"`` (the group kernel's two-order scan, ``_bidir``), which
    forced ``parts`` also take (the tools' and tests' column parts).  The
    edge is measured: on an H100 at a full-size Middlebury frame the path
    scan took 0.51x the group kernel's time at D = 512, 1.03x at 760 and
    1.74x at 1,024 (at KITTI's 375x1242 it still won at 1,024)."""
    return "paths" if not parts and d <= PATHS_MAX_RANGE else "group"


def horizontal_calls(cost_t: torch.Tensor, parts: int = 0) -> dict:
    """The launches of ``horizontal_pair_transposed`` on this transposed
    (B, W, D, H') cost by the card's route, by counter:
    ``{"horizontal_paths": 1}``, or the group kernel's
    ``{"horizontal_partial": n}`` (``bidir_calls``).  Only the shape and
    alignment of ``cost_t`` are read."""
    if horizontal_route(cost_t.shape[2], parts) == "paths":
        return {"horizontal_paths": 1}
    return {"horizontal_partial": bidir_calls(cost_t, cost_t, (0,), (0,),
                                              False, parts=parts)[0]}


class PathPlan(NamedTuple):
    """How one ``sgm_path_scan`` launch runs (``sgm_path_scan_plan``)."""
    lanes: int      # L: lanes a pair of paths
    words: int      # W: words a lane
    width: int      # HB: columns a block, 16 or 32
    warps: int      # warps a block: HB / (64 / L) computing, one producing
    ring: int       # R: steps staged ahead
    blocks: int     # B H / HB
    smem: int       # shared bytes a block


def path_plan(device: torch.device, b: int, d: int, h: int) -> PathPlan:
    """The C entry's plan for a path scan of B images of H' (a multiple of
    ``PATHS_PITCH``) columns at this D: blocks of 16 or 32 columns, the
    fewest computing warps an SM takes (the wider block where two tie); the
    shallowest ring where the blocks fill the card, else the deepest with
    which every block is resident at once."""
    res = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        _ask("sgm_path_scan_plan", b, d, h, ctypes.addressof(res))
    return PathPlan(*(int(v) for v in res))


def _check_path_penalties(p1: int, p2_init: int) -> None:
    """The path scan's penalties: >= 0, and P1 + 255 within int32 (past it
    the plain version's L(d +- 1) + P1 wraps, which the scan does not
    take; a P2' past it the scan takes)."""
    _check_penalties(p1, p2_init)
    if p1 > INT32_MAX - 255:
        raise ValueError(f"P1 = {p1}: P1 + 255 passes INT32_MAX, where the "
                         f"plain version's L(d +- 1) + P1 wraps")


def horizontal_paths(cost_t: torch.Tensor, img_t: torch.Tensor, p1: int,
                     p2_init: int) -> torch.Tensor:
    """Both horizontal directions on a transposed volume by the path scan
    (csrc/path_scan.cu, D up to ``PATHS_MAX_RANGE``): uint8 (B, W, D, H)
    cost + uint8 (B, W, H) image -> their uint16 (B, W, D, H) sum, each
    column a path, both orders in one launch (counted as
    ``horizontal_paths``).  H not a multiple of ``PATHS_PITCH`` (or an
    input not 16-byte aligned) is padded with zero columns, paths of their
    own that the result drops.  The entry plans the launch (``path_plan``).
    On CPU tensors: the plain two-order scan of (0,)."""
    _check_path_penalties(p1, p2_init)
    if _on_cpu(cost_t, img_t):
        return directional_scan_group_bidir_plain(cost_t, img_t, None, (0,),
                                                  (0,), p1, p2_init, False)
    b, s, d, h = _check_scan(cost_t, img_t)
    if d > PATHS_MAX_RANGE:
        raise ValueError(f"the path scan takes D up to {PATHS_MAX_RANGE}, "
                         f"got {d}")
    hp = _padded(h, PATHS_PITCH)
    if hp != h or cost_t.data_ptr() % 16 or img_t.data_ptr() % 16:
        c, g = cost_t.new_zeros((b, s, d, hp)), img_t.new_zeros((b, s, hp))
        c[..., :h], g[..., :h] = cost_t, img_t
        return horizontal_paths(c, g, p1, p2_init)[..., :h].contiguous()
    out = torch.empty(cost_t.shape, dtype=torch.uint16, device=cost_t.device)
    _launch("sgm_path_scan", "horizontal_paths", cost_t.data_ptr(),
            img_t.data_ptr(), out.data_ptr(), b, s, d, h, p1, p2_init,
            _stream(out))
    return out


def horizontal_pair_transposed(cost_t: torch.Tensor, img_t: torch.Tensor,
                               p1: int, p2_init: int,
                               parts: int = 0) -> torch.Tensor:
    """Both horizontal directions on a transposed volume: uint8 (B, W, D, H)
    cost + uint8 (B, W, H) image -> their uint16 (B, W, D, H) sum.  There a
    horizontal path is a column, and the roll-0 direction moves nothing
    across columns.  Up to D = ``PATHS_MAX_RANGE`` the path scan takes it
    (``horizontal_paths``: both orders in one launch, no block barrier a
    step); past it, or where ``parts`` forces column parts (on CPU tensors
    too), the group kernel's two-order scan of the direction (0,), forward
    and reverse meeting at the middle (two launches a part, counted as
    ``horizontal_partial``), in column parts without halo where the card
    does not hold the transposed row at once (``horizontal_route``)."""
    if horizontal_route(cost_t.shape[2], parts) == "paths":
        return horizontal_paths(cost_t, img_t, p1, p2_init)
    if _on_cpu(cost_t, img_t):
        if not parts:
            return directional_scan_group_bidir_plain(cost_t, img_t, None,
                                                      (0,), (0,), p1, p2_init,
                                                      False)
    else:
        _check_scan(cost_t, img_t)
    return _bidir(cost_t, img_t, None, (0,), (0,), p1, p2_init, False, None,
                  "horizontal_partial", parts=parts)


def horizontal_partial(cost: torch.Tensor, img: torch.Tensor, p1: int,
                       p2_init: int, restart: bool,
                       parts: int = 0) -> torch.Tensor:
    """Both horizontal directions: uint8 (B, H, D, W) cost + uint8 (B, H, W)
    image -> their uint16 (B, H, D, W) sum.  Tile-local in the H-tiled
    layout.  Nothing walks the volume along W: the cost and the image are
    transposed, the pair runs as a two-order scan along the (B, W, D, H)
    volume's columns, and the sum is transposed back (3 transposes, 2
    scan launches).  ``restart`` changes nothing here (it resets
    diagonals); the argument mirrors the entry this replaces.  ``parts``
    as ``horizontal_pair_transposed``'s (on CPU tensors the same route
    then runs the plain versions)."""
    if _on_cpu(cost, img):
        if not parts:
            return horizontal_partial_plain(cost, img, p1, p2_init, restart)
        h = cost.shape[1]
    else:
        _, h, _, _ = _check_scan(cost, img)
    part_t = horizontal_pair_transposed(
        volume_transpose(cost, pad_to=TRANSPOSED_PITCH),
        image_transpose(img, pad_to=TRANSPOSED_PITCH), p1, p2_init, parts)
    return volume_transpose(part_t, inner=h)


def _edge_gray(img: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The boundary gray row a group scan uses when none is given: the
    wrapped edge row, as ``_p2_planes(prev_row=None)`` uses it."""
    return img[:, 0 if reverse else -1].contiguous()


WTA_CHUNK = 8   # the plain epilogue's planes a chunk when none is given


def wta_epilogue_plain(total: torch.Tensor, dmin: int,
                       include_inverse: bool = True, strip=None,
                       chunk=None):
    """The group kernel's WTA epilogue, transcribed: int (B, S, D, W)
    finished totals -> (forward WTAPlanes, inverse WTAPlanes or None).

    As the kernel's reducers split a row, a block a ``strip`` of columns
    (default: the whole row) and a reducer a ``chunk`` of planes at a
    column pair: per strip, view and chunk the best of the chunk's planes
    (the min, the min over the other planes, the first plane holding the
    min), then the chunks' bests merged in a tree, neighbours in rounds, as
    the reducers' lanes merge them by shuffles (a tie keeps the earlier
    plane), then the costs beside the best plane read from the row.  The
    inverse view of column x reads plane k at column x + dmin + k of the
    whole row, across strip edges, 65535 past the row's end.  Rows are
    independent, so all rows go at once.  Same result as
    ``wta_reduce_plain``."""
    b, s, d, w = total.shape
    check_range(d)
    strip = w if strip is None else strip
    chunk = WTA_CHUNK if chunk is None else chunk
    if strip < 1 or chunk < 1:
        raise ValueError(f"strip and chunk must be >= 1, got {strip}, {chunk}")
    reach = min(dmin + d - 1, w)
    row = torch.full((b, s, d, w + reach), wta_ops.UINT16_MAX,
                     dtype=torch.int64, device=total.device)
    row[..., :w] = total
    ks = torch.arange(d, device=total.device)
    views = [0, 1] if include_inverse else [0]
    out = [[[] for _ in range(5)] for _ in views]
    for c0 in range(0, w, strip):
        cols = torch.arange(c0, min(w, c0 + strip), device=total.device)
        for v in views:
            # (B, S, D, strip columns): the view's planes at the strip
            at = cols[None, :] + (torch.clamp(dmin + ks, max=w)[:, None]
                                  if v else 0)
            costs = row.gather(-1, at.expand(b, s, d, -1).contiguous())
            bests = [_chunk_best(costs[:, :, k0:k0 + chunk], k0)
                     for k0 in range(0, d, chunk)]
            while len(bests) > 1:    # neighbours in rounds, as the shuffles
                bests = [bests[i] if i + 1 == len(bests) else
                         _merge_bests(bests[i], bests[i + 1])
                         for i in range(0, len(bests), 2)]
            m1, m2, bk = bests[0]
            beside = [costs.gather(-2, (bk + step).clamp(0, d - 1)[..., None, :])
                      .squeeze(-2) for step in (-1, 1)]
            planes = (bk, m1, m2 if d > 1 else torch.full_like(m2, wta_ops.BIG),
                      torch.where(bk == 0, m1, beside[0]),
                      torch.where(bk == d - 1, m1, beside[1]))
            for i, x in enumerate(planes):
                out[v][i].append(x)
    res = [WTAPlanes(*(torch.cat(x, dim=-1).to(torch.int32) for x in o))
           for o in out]
    return res[0], (res[1] if include_inverse else None)


def _chunk_best(c: torch.Tensor, k0: int):
    """A reducer's best of the planes [k0, k0 + K) of (..., K, P) costs:
    (m1, m2, bk), each (..., P); m2 is 0xFFFF for one plane."""
    m1, arg = c.min(dim=-2)          # the first minimal plane
    idx = torch.arange(c.shape[-2], device=c.device)[:, None]
    m2 = torch.where(idx == arg[..., None, :], 0xFFFF, c).amin(dim=-2)
    return m1, m2, arg + k0


def _merge_bests(left, right):
    """``best_merge`` of csrc/aggregate.cu: the best of a range of planes
    followed by the best of the next range; a tie keeps the left's plane."""
    lower = right[0] < left[0]
    return (torch.where(lower, right[0], left[0]),
            torch.minimum(torch.maximum(left[0], right[0]),
                          torch.minimum(left[1], right[1])),
            torch.where(lower, right[2], left[2]))


def _group_sum(cost, img, rolls, reverse: bool, p1: int, p2_init: int,
               mode: str, carry_in=None, prev_gray=None):
    """The int32 sum of a group's contributions and their carries."""
    total, carries = 0, []
    for k, roll in enumerate(rolls):
        cin = None if carry_in is None else aggregation.ScanCarry(
            carry_in[0][:, k], carry_in[1][:, k, 0], prev_gray)
        contrib, carry = aggregation.directional_scan(cost, img, p1, p2_init,
                                                      reverse, roll, mode, cin)
        total = total + contrib
        carries.append(carry)
    return total, carries


def directional_scan_group_plain(cost, img, acc, rolls, reverse: bool, p1: int,
                                 p2_init: int, restart: bool, carry_in=None,
                                 want_carry: bool = False, prev_gray=None,
                                 wta=None, strip=None, chunk=None):
    mode = "restart" if restart else "wrap"
    if wta is not None:
        _refuse_carry_with_wta(carry_in, want_carry)
    if prev_gray is None and carry_in is not None:
        prev_gray = _edge_gray(img, reverse)
    total, carries = _group_sum(cost, img, rolls, reverse, p1, p2_init, mode,
                                carry_in, prev_gray)
    if acc is not None:
        total = total + acc.to(torch.int32)
    if wta is not None:     # the epilogue: planes, no volume stored
        return wta_epilogue_plain(total, wta[0], wta[1], strip, chunk)
    out = total.to(torch.uint16)
    if acc is not None:
        out = acc.copy_(out)
    if carry_in is None and not want_carry:
        return out
    return out, (torch.stack([c.cost for c in carries], 1),
                 torch.stack([c.mincost for c in carries], 1)[:, :, None])


def directional_scan_clusters_plain(cost, img, rolls, reverse: bool, p1: int,
                                    p2_init: int, restart: bool,
                                    clusters: int, blocks: int,
                                    chunk: int = 8) -> torch.Tensor:
    """The group kernel's decomposition of a row over several clusters an
    image, transcribed: uint8 (B, S, D, W) cost + (B, S, W) image -> the
    int32 (B, S, D, W) sum of the group's contributions (``rolls``), as
    ``directional_scan_group_plain`` gives.

    The row's ``clusters * blocks`` strips (``strip_bounds``) each hold
    their columns' state and, per ``chunk`` of planes, its partial minima;
    a step reads the previous state at column c - roll, so a diagonal's one
    column that crosses a strip's edge is handed over with its chunks'
    partial minima: from the block beside it in the cluster, or, at a
    cluster's edge, from the next cluster through a buffer in device
    memory (three slots by receiving strip, written at step t into slot t %
    3 and read at t + 1).  The wrap at the image's edge is the hop from the
    last strip to the first, a cluster's edge where ``clusters`` > 1.  The
    gray values come from the image, as the kernel reads them."""
    mode = "restart" if restart else "wrap"
    b, s, d, w = cost.shape
    strips = clusters * blocks
    bounds = strip_bounds(w, strips)
    if clusters < 1 or blocks < 1 or any(
            lo >= hi for lo, hi in zip(bounds, bounds[1:])):
        raise ValueError(f"{clusters} x {blocks} strips leave one of {w} "
                         f"columns empty")
    c, g = cost.to(torch.int32), img.to(torch.int32)
    if reverse:
        c, g = c.flip(1), g.flip(1)
    total = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
    cols = torch.arange(w, device=c.device)

    def chunk_mins(x):          # (B, D, n) -> (B, chunks, n)
        return torch.stack([x[:, k0:k0 + chunk].amin(dim=1)
                            for k0 in range(0, d, chunk)], 1)

    for roll in rolls:
        state, xchg = [], {}
        for t in range(s):
            new = []
            for r, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
                row = c[:, t, :, lo:hi]
                if t == 0:
                    new.append(row)
                    continue
                prev, pm = state[r]
                if roll:
                    src = (r - roll) % strips
                    edge = -1 if roll > 0 else 0
                    if src // blocks != r // blocks:    # from another cluster
                        col, col_pm = xchg.pop((r, (t - 1) % 3))
                    else:
                        col = state[src][0][..., edge:][..., :1]
                        col_pm = state[src][1][..., edge:][..., :1]
                    if roll > 0:
                        prev = torch.cat([col, prev[..., :-1]], -1)
                        pm = torch.cat([col_pm, pm[..., :-1]], -1)
                    else:
                        prev = torch.cat([prev[..., 1:], col], -1)
                        pm = torch.cat([pm[..., 1:], col_pm], -1)
                prev_gray = g[:, t - 1, (cols[lo:hi] - roll) % w]
                cur = aggregation._dp_step(prev, pm.amin(dim=1), prev_gray,
                                           row, g[:, t, lo:hi], p1, p2_init)
                reset = 0 if roll > 0 else w - 1
                if roll and mode == "restart" and lo <= reset < hi:
                    cur[..., reset - lo] = row[..., reset - lo]
                new.append(cur)
            state = [(x, chunk_mins(x)) for x in new]
            for r, x in enumerate(new):
                total[:, t, :, bounds[r]:bounds[r + 1]] += x
                dst = (r + roll) % strips
                if roll and dst // blocks != r // blocks:   # to another cluster
                    edge = -1 if roll > 0 else 0
                    xchg[(dst, t % 3)] = (x[..., edge:][..., :1],
                                          state[r][1][..., edge:][..., :1])
    return total.flip(1) if reverse else total


def _split_scan(c, g, roll: int, p1: int, p2_init: int, restart: bool,
                ranges: int, bounds, carry=None, prev_gray=None):
    """One direction of ``directional_scan_split_plain`` on int32 (B, S, D,
    W) costs and (B, S, W) gray values in scan order: (the contribution,
    the state after the last row, its minimum over D)."""
    b, s, d, w = c.shape
    dk = split_depth(d, ranges)
    if dk is None or not 1 <= ranges <= GROUP_MAX_CLUSTER:
        raise ValueError(f"D={d} does not split over {ranges} blocks of "
                         f"{dk} disparities")
    spans = [(r * dk, min(d, (r + 1) * dk)) for r in range(ranges)]
    strips = [(lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    out = torch.empty_like(c)
    sent = aggregation.SENTINEL
    state, rmin, start = {}, {}, 0
    if carry is None:       # a path's first pixel contributes its raw cost
        out[:, 0] = c[:, 0]
        gray = g[:, 0]
        for j, (lo, hi) in enumerate(strips):
            for r, (d0, d1) in enumerate(spans):
                state[j, r] = c[:, 0, d0:d1, lo:hi]
        start = 1
    else:                   # the carry split as the blocks hold it
        gray = prev_gray
        for j, (lo, hi) in enumerate(strips):
            for r, (d0, d1) in enumerate(spans):
                state[j, r] = carry[0][:, d0:d1, lo:hi]
                rmin[j, r] = (carry[1][:, lo:hi] if r == 0 else
                              torch.full_like(carry[1][:, lo:hi], 0xFFFF))
    if carry is None:
        rmin = {key: x.amin(dim=1) for key, x in state.items()}
    cols = torch.arange(w, device=c.device)
    for t in range(start, s):
        new = {}
        for j, (lo, hi) in enumerate(strips):
            n = hi - lo
            # every block's range minima of this strip's columns
            mins = torch.stack([rmin[j, r] for r in range(ranges)]).amin(0)
            if roll:    # the neighbour strip's edge column, all D of it
                sj = (j - roll) % len(strips)
                edge = -1 if roll > 0 else 0
                halo = torch.cat([state[sj, r][..., edge]
                                  for r in range(ranges)], dim=1)
                halo_min = torch.stack([rmin[sj, r][..., edge]
                                        for r in range(ranges)]).amin(0)
            gp = gray[:, (cols[lo:hi] - roll) % w]
            p2 = torch.clamp(p2_init // ((g[:, t, lo:hi] - gp).abs() + 1),
                             min=p1)
            for r, (d0, d1) in enumerate(spans):
                # the state this block reads: its range, the rows at d0 - 1
                # and d1 from the blocks below and above, the halo column
                ext = torch.full((b, d1 - d0 + 2, n + 2), sent,
                                 dtype=torch.int32, device=c.device)
                ext[:, 1:-1, 1:-1] = state[j, r]
                if r > 0:
                    ext[:, 0, 1:-1] = state[j, r - 1][:, -1]
                if r < ranges - 1:
                    ext[:, -1, 1:-1] = state[j, r + 1][:, 0]
                mext = torch.full((b, n + 2), 0xFFFF, dtype=torch.int32,
                                  device=c.device)
                mext[:, 1:-1] = mins
                if roll:
                    hc = 0 if roll > 0 else -1
                    lo_d, hi_d = max(d0 - 1, 0), min(d1 + 1, d)
                    ext[:, lo_d - d0 + 1:hi_d - d0 + 1, hc] = halo[:, lo_d:hi_d]
                    mext[:, hc] = halo_min
                prev = ext[..., 1 - roll:1 - roll + n]
                pm = mext[:, 1 - roll:1 - roll + n]
                m = torch.minimum(
                    torch.minimum(prev[:, 1:-1], prev[:, :-2] + p1),
                    torch.minimum(prev[:, 2:] + p1, (pm + p2)[:, None]))
                cur = (c[:, t, d0:d1, lo:hi] + m - pm[:, None]) & 0xFF
                reset = 0 if roll > 0 else w - 1
                if roll and restart and lo <= reset < hi:
                    cur[..., reset - lo] = c[:, t, d0:d1, reset]
                new[j, r] = cur
                out[:, t, d0:d1, lo:hi] = cur
        state = new
        rmin = {key: x.amin(dim=1) for key, x in state.items()}
        gray = g[:, t]
    last = torch.cat([torch.cat([state[j, r] for r in range(ranges)], 1)
                      for j in range(len(strips))], -1)
    return out, last, last.amin(dim=1)


def directional_scan_split_plain(cost, img, acc, rolls, reverse: bool,
                                 p1: int, p2_init: int, restart: bool,
                                 ranges: int, strips: int = 1,
                                 carry_in=None, want_carry: bool = False,
                                 prev_gray=None, wta=None, chunk=None):
    """The group kernel's split of D over the blocks of a cluster,
    transcribed: ``directional_scan_group_plain``'s arguments and result,
    computed as ``strips`` clusters of ``ranges`` blocks hold it.

    The row's columns form ``strips`` strips (``strip_bounds``), D forms
    ``ranges`` ranges of ``split_depth`` disparities (the last the rest),
    and a block holds one range of one strip's state.  A step of a block
    reads its own range's state and, from the other blocks, only: the rows
    at d0 - 1 and d1 of its columns (the blocks below and above), each
    column's minimum over D as every block's minimum over its range, and,
    for a diagonal, the column that crosses the strip's edge, all D of it
    and its blocks' range minima (the neighbour strip's cluster, through
    device memory; the strip itself at the wrap where ``strips`` is 1).
    The state starts from the carry split the same way (its minimum as the
    first block's range minimum).  The epilogue reduces the totals as
    ``wta_epilogue_plain`` with strips of a column pair and ``chunk``
    planes a reducer."""
    mode_restart = bool(restart)
    if wta is not None:
        _refuse_carry_with_wta(carry_in, want_carry)
    if prev_gray is None and carry_in is not None:
        prev_gray = _edge_gray(img, reverse)
    b, s, d, w = cost.shape
    bounds = strip_bounds(w, strips)
    if any(lo >= hi for lo, hi in zip(bounds, bounds[1:])):
        raise ValueError(f"{strips} strips leave one of {w} columns empty")
    c, g = cost.to(torch.int32), img.to(torch.int32)
    if reverse:
        c, g = c.flip(1), g.flip(1)
    total = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
    carries = []
    for k, roll in enumerate(rolls):
        carry = None if carry_in is None else (
            carry_in[0][:, k].to(torch.int32), carry_in[1][:, k, 0].to(torch.int32))
        contrib, last, last_min = _split_scan(
            c, g, roll, p1, p2_init, mode_restart, ranges, bounds, carry,
            None if prev_gray is None else prev_gray.to(torch.int32))
        total += contrib
        carries.append((last, last_min))
    if reverse:
        total = total.flip(1)
    if acc is not None:
        total = total + acc.to(torch.int32)
    if wta is not None:
        return wta_epilogue_plain(total, wta[0], wta[1], 2, chunk)
    out = total.to(torch.uint16)
    if acc is not None:
        out = acc.copy_(out)
    if carry_in is None and not want_carry:
        return out
    return out, (torch.stack([x for x, _ in carries], 1),
                 torch.stack([m for _, m in carries], 1)[:, :, None])


def _refuse_carry_with_wta(carry_in, want_carry: bool) -> None:
    if carry_in is not None or want_carry:
        raise ValueError("the WTA epilogue ends a frame's aggregation: it "
                         "takes no carries")


def directional_scan_group(cost: torch.Tensor, img: torch.Tensor, acc,
                           rolls, reverse: bool, p1: int, p2_init: int,
                           restart: bool, carry_in=None,
                           want_carry: bool = False, prev_gray=None,
                           wta=None, ranges: int = 0, parts: int = 0,
                           rows: int = 0):
    """A group of vertical directions that share a scan order (rolls, e.g.
    (0, 1, -1)) over an H-tile: uint8 (B, S, D, W) cost + uint8 (B, S, W)
    image -> the uint16 (B, S, D, W) sum of their contributions, added in
    place onto ``acc`` (uint16, same shape) and returned when ``acc`` is
    given.

    Carry mode, with the Pallas entry's layout: ``carry_in`` = int32
    (cost (B, n, D, W), min (B, n, 1, W)) continues the upstream tile's
    paths, and with ``carry_in`` or ``want_carry`` the result is
    ``(sum, carry_out)``, the state after the tile's last row (its first
    for ``reverse``).  ``prev_gray``: the upstream tile's uint8 (B, W)
    boundary row, for P2 on the first row (default: the wrapped edge row of
    ``img``, as the Pallas entry's P2 planes without ``prev_row``).

    ``wta`` = (dmin, include_inverse): the final launch of a frame's
    aggregation (no carries).  Its epilogue reduces each finished row of
    totals on chip and stores no volume (``acc`` is left as it was, but
    for the directions of launches before the last where the group is split
    over launches, which add onto it); the
    result is (forward WTAPlanes, inverse WTAPlanes or None), int32
    (B, S, W) planes, as ``wta_reduce`` of the sum would give.  Counted as
    ``directional_scan_group_wta`` (a group split over launches: the
    leading launches too).

    One launch (see ``group_capacity``): the group's sum is formed on chip
    and the uint16 volume is touched once.  ``ranges`` >= 2 forces D split
    over that many blocks of a cluster (``group_plan``; for measurements
    and tests: the plan takes the split by itself only where strips of two
    columns do not hold one direction's state).

    A row wider than the card holds at once (``group_route``) goes in
    column parts with halo columns, one launch per part of the group per
    part of the row, and in chunks of rows with carries where the halo
    would be too wide (``scan_parts``): the same result.  With ``wta`` the
    epilogue does not run over parts (its inverse view reads across them):
    the sums are added onto ``acc`` (or a new volume) and reduced by
    ``wta_reduce``.  ``parts`` >= 1 forces that many parts (``rows`` >= 1
    rows a chunk), on CPU tensors too, where each slice runs the plain
    version (for tests and measurements)."""
    if prev_gray is None and carry_in is not None:
        prev_gray = _edge_gray(img, reverse)
    extra = [t for t in (acc, prev_gray, *(carry_in or ())) if t is not None]
    on_cpu = _on_cpu(cost, img, *extra)
    if on_cpu and not parts:
        return directional_scan_group_plain(cost, img, acc, rolls, reverse, p1,
                                            p2_init, restart, carry_in,
                                            want_carry, prev_gray, wta)
    if not on_cpu:
        _check_carry(cost, img, len(rolls), carry_in, prev_gray)
    if wta is not None:
        _refuse_carry_with_wta(carry_in, want_carry)
        _check_wta(wta[0])
    counter = ("directional_scan_group" if wta is None
               else "directional_scan_group_wta")
    out = _acc_or_new(acc, cost)
    plan = group_route(cost, out, rolls, wta is not None, ranges, parts, rows)
    if plan is None:
        return _group_launches(cost, img, out, acc is not None, rolls,
                               reverse, p1, p2_init, restart, carry_in,
                               want_carry or carry_in is not None, prev_gray,
                               wta, ranges, counter)
    res = scan_parts(cost, img, out, acc is not None, rolls, reverse, p1,
                     p2_init, restart, plan, ranges, counter, carry_in,
                     want_carry, prev_gray)
    if wta is None:
        return res
    d = cost.shape[2]
    return wta_reduce(out, SGMOptions(min_disparity=wta[0],
                                      max_disparity=wta[0] + d), wta[1])


def _group_launches(cost, img, out, accumulate: bool, rolls, reverse: bool,
                    p1: int, p2_init: int, restart: bool, carry_in,
                    want_carry: bool, prev_gray, wta, ranges: int,
                    counter: str):
    """``directional_scan_group``'s launches onto ``out`` for checked CUDA
    inputs whose row one launch takes; the carry-out only where
    ``want_carry`` (else None beside the sum where ``carry_in`` is
    given)."""
    b, s, d, w = cost.shape
    n = len(rolls)
    cin_cost, cin_min = carry_in or (None, None)
    cout_cost = cout_min = None
    if want_carry:
        cout_cost = torch.empty((b, n, d, w), dtype=torch.int32, device=cost.device)
        cout_min = torch.empty((b, n, 1, w), dtype=torch.int32, device=cost.device)
    views, finished, planes = _epilogue_buffers(cost, wta, 1)
    for k0, k1 in _launch_parts(cost, out, n, wta is not None, ranges):
        epi = views if k1 == n else 0
        _launch_group(counter, cost, img, out,
                      [scan_pass(rolls[k0:k1], reverse, 0, s, k0, d, w,
                                 (cin_cost, cin_min), _ptr(prev_gray), w,
                                 (cout_cost, cout_min))],
                      1, k1 - k0, n, restart, p1, p2_init,
                      accumulate or k0 > 0, epi,
                      0 if wta is None else wta[0],
                      finished if epi else None, planes if epi else None,
                      ranges)
    if wta is not None:
        return _planes_of(planes)
    if carry_in is None and not want_carry:
        return out
    return out, ((cout_cost, cout_min) if want_carry else None)


def _check_carry(cost, img, n: int, carry_in, prev_gray) -> None:
    """Validate a group scan's inputs for the kernel: the cost and image,
    and with ``carry_in`` its (B, n, D, W) / (B, n, 1, W) int32 tensors and
    the uint8 (B, W) gray row."""
    b, s, d, w = _check_scan(cost, img)
    if carry_in is None:
        return
    for t, name, shape in ((carry_in[0], "carry cost", (b, n, d, w)),
                           (carry_in[1], "carry min", (b, n, 1, w))):
        _check(t, name, torch.int32, 4)
        if t.shape != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    _check(prev_gray, "prev_gray", torch.uint8, 2)
    if prev_gray.shape != (b, w):
        raise ValueError(f"prev_gray: expected {(b, w)}, got "
                         f"{tuple(prev_gray.shape)}")


def _acc_or_new(acc, cost: torch.Tensor) -> torch.Tensor:
    """``acc`` checked against ``cost``, or a new uint16 volume of its shape."""
    if acc is None:
        return torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    _check(acc, "acc", torch.uint16, 4)
    if acc.shape != cost.shape:
        raise ValueError(f"acc {tuple(acc.shape)} != cost {tuple(cost.shape)}")
    return acc


def _check_wta(dmin: int) -> None:
    if dmin < 0:
        raise ValueError(f"the WTA epilogue takes dmin >= 0, got {dmin}")


def meeting_row(s: int) -> int:
    """The row where a two-order scan's orders meet: the first launch scans
    the first order over rows [0, m) and the second over [m, S), the second
    launch each over the other half."""
    return s // 2


def directional_scan_group_bidir_plain(cost, img, acc, rolls_f, rolls_b,
                                       p1: int, p2_init: int, restart: bool,
                                       wta=None, strip=None, chunk=None):
    """The two-order launches, in the kernel's order of work (m =
    ``meeting_row(S)``): the first launch scans the first order
    (``rolls_f``, rows forward) over [0, m) and the second (``rolls_b``,
    rows in reverse) over [m, S), each adding its sums in place onto
    ``acc`` (or a new volume) and keeping its paths' state at the meeting
    row; the second launch continues each order over the other half from
    that state, adding onto the other order's sums, which are final there.
    Its totals are stored, or with ``wta`` reduced by the epilogue
    (``wta_epilogue_plain``, ``strip`` and ``chunk``)."""
    mode = "restart" if restart else "wrap"
    s = cost.shape[-3]
    m = meeting_row(s)
    first_half, second_half = slice(0, m), slice(m, s)
    orders = ((rolls_f, False), (rolls_b, True))

    def scan(order, rows, carries=None):
        """(the order's int32 sums over ``rows``, its carries)."""
        (rolls, reverse), sums, out = order, 0, []
        for k, roll in enumerate(rolls):
            contrib, carry = aggregation.directional_scan(
                cost[:, rows], img[:, rows], p1, p2_init, reverse, roll, mode,
                None if carries is None else carries[k])
            sums, out = sums + contrib, out + [carry]
        return sums, out

    part = (torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
            if acc is None else acc.to(torch.int32))
    carries = [None, None]
    for i, rows in enumerate((first_half, second_half)):    # launch 1
        if rows.stop > rows.start:
            sums, carries[i] = scan(orders[i], rows)
            part[:, rows] += sums
    park = part.to(torch.uint16)
    if acc is not None:
        park = acc.copy_(park)
    total = park.to(torch.int32)
    for i, rows in enumerate((second_half, first_half)):    # launch 2
        if rows.stop > rows.start:
            total[:, rows] += scan(orders[i], rows, carries[i])[0]
    if wta is not None:
        return wta_epilogue_plain(total, wta[0], wta[1], strip, chunk)
    return park.copy_(total.to(torch.uint16))


def directional_scan_group_bidir(cost: torch.Tensor, img: torch.Tensor, acc,
                                 rolls_f, rolls_b, p1: int, p2_init: int,
                                 restart: bool, wta=None, ranges: int = 0,
                                 parts: int = 0, rows: int = 0):
    """Both scan orders of a direction group (the Pallas
    ``_directional_scan_group_bidir``): uint8 (B, S, D, W) cost + uint8
    (B, S, W) image, ``rolls_f`` walking the rows forward and ``rolls_b`` in
    reverse.  Two launches, each carrying both orders on clusters of their
    own, that meet at the middle row m = ``meeting_row(S)``: the first
    scans the forward order over rows [0, m) and the reverse order over
    [m, S), each adding its sums onto ``acc`` (uint16, same shape; else a
    new volume) and keeping its paths' state at m as a carry; the second
    continues each order over the other half from its carry, adding onto
    the other order's sums, which are final there.  S serial steps in all,
    where one launch of both orders takes 2 S.

    Without ``wta`` the result is the volume (``acc`` itself when given):
    acc + both orders' sums.  With ``wta`` = (dmin, include_inverse) the
    second launch carries the WTA epilogue and stores no volume: the result
    is (forward WTAPlanes, inverse WTAPlanes or None) of the totals, and
    ``acc`` is left holding the first launch's sums (acc + the forward
    order's on rows [0, m), the reverse order's on [m, S), where the group
    takes one pair of launches; a part before the last adds both orders).
    Counted as ``directional_scan_group_bidir``, two a part of a group
    split over launches (``group_capacity``), the last part's second
    launch carrying the epilogue.  ``ranges`` >= 2 forces D split over
    that many blocks of a cluster (``directional_scan_group``'s).

    A row wider than the card holds at once goes in column parts with halo
    columns (``group_route``): each part's slice by the two launches where
    the plan takes one chunk of rows, else as two one-order scans in chunks
    (``bidir_parts``), the same result.  With ``wta`` the epilogue does not
    run over parts: ``acc`` (or a new volume) is left holding the totals,
    and ``wta_reduce`` gives the planes.  ``parts`` and ``rows`` force parts
    as ``directional_scan_group``'s, on CPU tensors too."""
    if len(rolls_f) != len(rolls_b):
        raise ValueError(f"the two orders differ in directions: {rolls_f} "
                         f"and {rolls_b}")
    extra = () if acc is None else (acc,)
    if _on_cpu(cost, img, *extra):
        if not parts:
            return directional_scan_group_bidir_plain(cost, img, acc, rolls_f,
                                                      rolls_b, p1, p2_init,
                                                      restart, wta)
    else:
        _check_scan(cost, img)
    return _bidir(cost, img, acc, tuple(rolls_f), tuple(rolls_b), p1, p2_init,
                  restart, wta, "directional_scan_group_bidir", ranges, parts,
                  rows)


def _bidir(cost, img, acc, rolls_f, rolls_b, p1: int, p2_init: int,
           restart: bool, wta, counter: str, ranges: int = 0, parts: int = 0,
           rows: int = 0):
    """The two-order launches of checked inputs, counted as ``counter``
    (``ranges``, ``parts`` and ``rows`` as ``bidir_launches``')."""
    out = _acc_or_new(acc, cost)
    launches, planes = bidir_launches(cost, img, out, rolls_f, rolls_b, p1,
                                      p2_init, restart, wta, counter,
                                      acc is not None, ranges, parts, rows)
    for launch in launches:
        launch()
    return out if wta is None else _planes_of(planes)


def bidir_launches(cost, img, out, rolls_f, rolls_b, p1: int, p2_init: int,
                   restart: bool, wta, counter: str, accumulate: bool,
                   ranges: int = 0, parts: int = 0, rows: int = 0):
    """(the launches of a two-order scan onto ``out`` as calls, in order;
    the epilogue's int32 planes or None): for each part of the group
    (``_launch_parts``) two launches, each carrying both orders on clusters
    of their own, that meet at ``meeting_row`` (see
    ``directional_scan_group_bidir_plain``); the last part's second launch
    carries the epilogue.  A first launch writes the carries its second
    reads.  ``ranges`` >= 2 forces D split over that many blocks
    (``group_plan``; the measurement tools).  Where the row goes in column
    parts (``group_route``; ``parts`` and ``rows`` force them) one call
    runs them all (``bidir_parts``) and, with ``wta``, ``wta_reduce`` of
    the totals into the planes."""
    if wta is not None:
        _check_wta(wta[0])
    b, s, d, w = cost.shape
    plan = group_route(cost, out, rolls_f + rolls_b, wta is not None, ranges,
                       parts, rows)
    if plan is not None:
        planes = None if wta is None else torch.empty(
            (5 * (2 if wta[1] else 1), b, s, w), dtype=torch.int32,
            device=cost.device)

        def by_parts():
            bidir_parts(cost, img, out, accumulate, rolls_f, rolls_b, p1,
                        p2_init, restart, plan, ranges, counter)
            if wta is not None:
                _wta_into(out, wta[0], wta[1], planes)
        return [by_parts], planes
    n = len(rolls_f)
    m = meeting_row(s)
    views, finished, planes = _epilogue_buffers(cost, wta, 2)
    # each order's paths' state at the meeting row (none where m = 0: the
    # first order then starts at row 0 in the second launch)
    cf = cr = (None, None)
    if m > 0:
        cf, cr = ((torch.empty((b, n, d, w), dtype=torch.int32,
                               device=cost.device),
                   torch.empty((b, n, 1, w), dtype=torch.int32,
                               device=cost.device)) for _ in range(2))
    gray_f = _ptr(img, (m - 1) * w) if m > 0 else None
    launches = []
    for k0, k1 in _launch_parts(cost, out, n, wta is not None, ranges):
        f, r = rolls_f[k0:k1], rolls_b[k0:k1]
        launches.append(functools.partial(
            _launch_group, counter, cost, img, out,
            [scan_pass(f, False, 0, m, k0, d, w, carry_out=cf),
             scan_pass(r, True, m, s, k0, d, w, carry_out=cr)],
            1, k1 - k0, n, restart, p1, p2_init, accumulate or k0 > 0,
            ranges=ranges))
        epi = views if k1 == n else 0
        launches.append(functools.partial(
            _launch_group, counter, cost, img, out,
            [scan_pass(f, False, m, s, k0, d, w, cf, gray_f, s * w),
             scan_pass(r, True, 0, m, k0, d, w, cr, _ptr(img, m * w), s * w)],
            1, k1 - k0, n, restart, p1, p2_init, True, epi,
            0 if wta is None else wta[0], finished if epi else None,
            planes if epi else None, ranges))
    return launches, planes


def bidir_calls(cost: torch.Tensor, out: torch.Tensor, rolls_f, rolls_b,
                wta: bool, restart: bool = False, ranges: int = 0,
                parts: int = 0, rows: int = 0):
    """(``sgm_scan_group`` calls, ``sgm_wta_reduce`` calls) that a two-order
    scan of this (B, S, D, W) cost makes on the card by the wrappers' route
    (``bidir_launches``): two a part of the group (``_launch_parts``) where
    one launch takes the row; else, for each column part, two a part of
    the group at the slice's width where the plan takes one chunk of rows,
    one an order a chunk otherwise, and one ``wta_reduce`` with ``wta``.
    Only the shape and alignment of ``cost`` and ``out`` are read (a
    row's view expanded over S will do)."""
    n = len(rolls_f)
    plan = group_route(cost, out, tuple(rolls_f) + tuple(rolls_b), wta,
                       ranges, parts, rows)
    if plan is None:
        return 2 * len(_launch_parts(cost, out, n, wta, ranges)), 0
    b, s, d, w = cost.shape
    calls = 0
    for lo, hi, _, _ in part_columns(w, plan, restart):
        probe = torch.empty((b, 1, d, hi - lo), dtype=torch.uint8,
                            device=cost.device)
        calls += 2 * len(row_chunks(s, plan.rows, False)) * len(_launch_parts(
            probe, torch.empty(probe.shape, dtype=torch.uint16,
                               device=cost.device), n, False, ranges))
    return calls, int(wta)


def _columns(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of ``x``'s last axis, read mod its width, as a
    contiguous tensor of their own (a copy, also of all of ``x``)."""
    w = x.shape[-1]
    if 0 <= lo and hi <= w:
        return x[..., lo:hi].clone(memory_format=torch.contiguous_format)
    return x.index_select(-1, torch.arange(lo, hi, device=x.device) % w)


def scan_parts(cost, img, out, accumulate: bool, rolls, reverse: bool,
               p1: int, p2_init: int, restart: bool, plan: PartsPlan,
               ranges: int = 0, counter: str = "directional_scan_group",
               carry_in=None, want_carry: bool = False, prev_gray=None):
    """One scan order of a group (``rolls``, ``reverse``) over the column
    parts and row chunks of ``plan``, onto ``out`` (stored, or added where
    ``accumulate``): ``directional_scan_group``'s result, ``out`` or
    (``out``, carry_out).

    For each chunk of rows in scan order (``row_chunks``), for each part
    (``part_columns``): the part's slice of the cost, the chunk's image
    rows, of ``out`` where it accumulates, of the carry and of the gray row
    before the chunk, each a tensor of its own; the group scan on them
    (``_group_slice``: one launch per part of the group on CUDA tensors,
    counted as ``counter``, the plain version on CPU ones, with the same
    slices); then the part's interior columns of the sums and of the
    carry-out scattered back.  The carries between chunks live in two
    full-width int32 buffers used in turn: a part of chunk c writes its
    interior into one while the other parts of chunk c still read their
    halo columns from the other.  The first chunk starts from
    ``carry_in`` (or fresh paths); ``prev_gray`` as
    ``directional_scan_group``'s."""
    b, s, d, w = cost.shape
    chunks = row_chunks(s, plan.rows, reverse)
    has_carry = carry_in is not None or want_carry
    bufs, cin, gray = [], carry_in, prev_gray
    for c, (r0, r1) in enumerate(chunks):
        cout = None
        if has_carry or c + 1 < len(chunks):
            if len(bufs) <= c % 2:
                bufs.append(tuple(torch.empty((b, len(rolls), depth, w),
                                              dtype=torch.int32,
                                              device=cost.device)
                                  for depth in (d, 1)))
            cout = bufs[c % 2]
        for lo, hi, a, e in part_columns(w, plan, restart):
            sums, carry = _group_slice(
                _columns(cost[:, r0:r1], lo, hi),
                _columns(img[:, r0:r1], lo, hi),
                _columns(out[:, r0:r1], lo, hi) if accumulate else None,
                rolls, reverse, p1, p2_init, restart,
                None if cin is None else tuple(_columns(x, lo, hi)
                                               for x in cin),
                cout is not None,
                None if gray is None else _columns(gray, lo, hi),
                ranges, counter)
            out[:, r0:r1, ..., a:e] = sums[..., a - lo:e - lo]
            for dst, src in zip(cout or (), carry or ()):
                dst[..., a:e] = src[..., a - lo:e - lo]
        cin = cout
        gray = img[:, r0 if reverse else r1 - 1].contiguous()
    return (out, cin) if has_carry else out


def _group_slice(cost, img, acc, rolls, reverse: bool, p1: int, p2_init: int,
                 restart: bool, carry_in, want_carry: bool, prev_gray,
                 ranges: int, counter: str):
    """A slice's one-order group scan for ``scan_parts``: (its sums, its
    carry-out or None), by the kernel's launches on CUDA tensors
    (``_group_launches``), by the plain version on CPU ones."""
    if _on_cpu(cost, img):
        res = directional_scan_group_plain(cost, img, acc, rolls, reverse, p1,
                                           p2_init, restart, carry_in,
                                           want_carry, prev_gray)
    else:
        res = _group_launches(cost, img, _acc_or_new(acc, cost),
                              acc is not None, rolls, reverse, p1, p2_init,
                              restart, carry_in, want_carry, prev_gray, None,
                              ranges, counter)
    return res if isinstance(res, tuple) else (res, None)


def bidir_parts(cost, img, out, accumulate: bool, rolls_f, rolls_b, p1: int,
                p2_init: int, restart: bool, plan: PartsPlan, ranges: int = 0,
                counter: str = "directional_scan_group_bidir"):
    """Both scan orders of a group over the column parts of ``plan``, onto
    ``out`` (stored, or added where ``accumulate``): where the plan takes
    one chunk of rows, each part's slice by the two-order scan (its two
    launches meeting at the middle row on CUDA tensors, counted as
    ``counter``, its plain version on CPU ones), its interior scattered
    back; else the forward order and then the reverse order, each by
    ``scan_parts`` in chunks, the second adding onto the first.  The same
    sums either way."""
    s, w = cost.shape[1], cost.shape[-1]
    if plan.rows < s:
        for (rolls, reverse), add in (((rolls_f, False), accumulate),
                                      ((rolls_b, True), True)):
            scan_parts(cost, img, out, add, rolls, reverse, p1, p2_init,
                       restart, plan, ranges, counter)
        return out
    for lo, hi, a, e in part_columns(w, plan, restart):
        c, g = _columns(cost, lo, hi), _columns(img, lo, hi)
        acc = _columns(out, lo, hi) if accumulate else None
        if _on_cpu(c, g):
            sums = directional_scan_group_bidir_plain(c, g, acc, rolls_f,
                                                      rolls_b, p1, p2_init,
                                                      restart)
        else:
            sums = _acc_or_new(acc, c)
            for launch in bidir_launches(c, g, sums, rolls_f, rolls_b, p1,
                                         p2_init, restart, None, counter,
                                         acc is not None, ranges)[0]:
                launch()
        out[..., a:e] = sums[..., a - lo:e - lo]
    return out


def wta_reduce_plain(aggr, options: SGMOptions, include_inverse: bool = True):
    fwd = wta_ops.wta_reduce(aggr, options, inverse=False)
    inv = wta_ops.wta_reduce(aggr, options, inverse=True) if include_inverse \
        else None
    return fwd, inv


class _Track:
    """One view's online reduction, all columns at once, with the kernel's
    arithmetic for a column: the min and the min over the planes that lost
    to it (ties lose, so the first plane keeps the min), the latch
    ``prev << WTA_KEY_SHIFT | k`` (c1 and best) where the min changes hands,
    plane after one that took the min, and the cost at the plane before.
    Plane 0 starts it."""

    def __init__(self, first: torch.Tensor):
        self.m1 = first
        self.m2 = torch.full_like(first, wta_ops.UINT16_MAX)
        self.rk = first << WTA_KEY_SHIFT     # c1 = cost[clip(-1)], best 0
        self.rc2 = torch.zeros_like(first)
        self.prev = first
        self.took = torch.ones_like(first, dtype=torch.bool)

    def step(self, v: torch.Tensor, k: int) -> None:
        keep = self.m1 <= v
        self.m2 = torch.minimum(self.m2, torch.maximum(self.m1, v))
        self.m1 = torch.minimum(self.m1, v)
        self.rk = torch.where(keep, self.rk, (self.prev << WTA_KEY_SHIFT) | k)
        self.rc2 = torch.where(self.took, v, self.rc2)
        self.prev, self.took = v, ~keep

    def planes(self, d: int) -> WTAPlanes:
        best = self.rk & (MAX_RANGE - 1)
        sec = self.m2 if d > 1 else torch.full_like(best, wta_ops.BIG)
        return WTAPlanes(best, self.m1, sec, self.rk >> WTA_KEY_SHIFT,
                         torch.where(best == d - 1, self.prev, self.rc2))


def wta_online_plain(aggr, options: SGMOptions, include_inverse: bool = True,
                     chunk: int = 16):
    """The WTA kernel's reduction, transcribed: the planes of each row are
    staged ``chunk`` at a time, each staged plane followed by 65535 where
    the inverse view's reads leave the row, and both views are reduced in
    one pass over the planes with the kernel's running minima and latches
    (no second read for c1 and c2).  Same result as ``wta_reduce_plain``;
    for the tests, which hold the kernel's algorithm against the JAX op."""
    b, h, d, w = aggr.shape
    check_range(d)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dmin = options.min_disparity
    a = aggr.to(torch.int32)
    reach = min(dmin + d - 1, w)       # how far right the inverse view reads
    tracks = None
    for k0 in range(0, d, chunk):
        staged = torch.full((b, h, min(chunk, d - k0), w + reach),
                            wta_ops.UINT16_MAX, dtype=torch.int32,
                            device=a.device)
        staged[..., :w] = a[:, :, k0:k0 + chunk]
        for kk in range(staged.shape[2]):
            k = k0 + kk
            shift = min(dmin + k, w)
            views = [staged[:, :, kk, :w]]
            if include_inverse:
                views.append(staged[:, :, kk, shift:shift + w])
            if tracks is None:
                tracks = [_Track(v) for v in views]
                continue
            for track, v in zip(tracks, views):
                track.step(v, k)
    fwd = tracks[0].planes(d)
    return fwd, tracks[1].planes(d) if include_inverse else None


def wta_reduce(aggr: torch.Tensor, options: SGMOptions,
               include_inverse: bool = True):
    """uint16 (B, H, D, W) -> (forward WTAPlanes, inverse WTAPlanes or None),
    int32 (B, H, W) planes, like ``wta_reduce_pallas``.  On the card the
    kernel takes D in 1..16,384 and rows of any width, cut into segments of
    up to 2,048 columns (a block each) past that width."""
    if _on_cpu(aggr):
        return wta_reduce_plain(aggr, options, include_inverse)
    _check(aggr, "aggr", torch.uint16, 4)
    b, h, d, w = aggr.shape
    n_out = 10 if include_inverse else 5
    out = torch.empty((n_out, b, h, w), dtype=torch.int32, device=aggr.device)
    return _planes_of(_wta_into(aggr, options.min_disparity, include_inverse,
                                out))


def _wta_into(aggr: torch.Tensor, dmin: int, include_inverse: bool,
              out: torch.Tensor) -> torch.Tensor:
    """The WTA planes of a uint16 (B, H, D, W) volume into ``out``, int32
    (5 or 10, B, H, W): one ``sgm_wta_reduce`` launch on a CUDA volume, the
    plain version on a CPU one.  Returns ``out``."""
    b, h, d, w = aggr.shape
    check_range(d)
    if _on_cpu(aggr, out):
        opt = SGMOptions(min_disparity=dmin, max_disparity=dmin + d)
        fwd, inv = wta_reduce_plain(aggr, opt, include_inverse)
        return out.copy_(torch.stack([*fwd, *(inv or ())]))
    _launch("sgm_wta_reduce", "wta_reduce", aggr.data_ptr(), out.data_ptr(),
            b, h, d, w, dmin, int(include_inverse), _stream(out))
    return out


def aggregate_paths_wta_plain(cost, img_left, options: SGMOptions,
                              diagonal_mode: str = "wrap",
                              include_inverse: bool = True):
    aggr = aggregation.aggregate_paths(cost, img_left, options, diagonal_mode)
    return wta_reduce_plain(aggr, options, include_inverse)


def aggregate_paths_wta(cost: torch.Tensor, img_left: torch.Tensor,
                        options: SGMOptions, diagonal_mode: str = "wrap",
                        include_inverse: bool = True, parts: int = 0,
                        rows: int = 0):
    """Aggregation and WTA without storing the aggregated volume: the
    horizontal pair (``horizontal_partial``), then the vertical group's
    two-order scan whose second launch carries the WTA epilogue
    (``directional_scan_group_bidir`` with ``wta``, two launches counted
    here): (forward WTAPlanes, inverse WTAPlanes or None), as ``wta_reduce``
    of ``aggregate_paths`` gives.  On CPU tensors the same route runs the plain
    versions.  Where the vertical pair takes its rows in column parts (the
    card does not hold them at once; ``parts`` and ``rows`` force them as
    ``aggregate_paths``'s), the epilogue, whose inverse view reads across
    parts, does not run: the pair is added onto the horizontal pair's
    volume, which exists anyway, and ``wta_reduce`` (one launch, counted
    as such) reduces it."""
    on_cpu = _on_cpu(cost, img_left)
    restart = _check_aggregate(cost, img_left, diagonal_mode, on_cpu)
    p1, p2 = options.p1, options.p2_init
    part = horizontal_partial(cost, img_left, p1, p2, restart, parts)
    (rolls_f, _), (rolls_b, _) = scan_groups(options.num_paths)
    wta = (options.min_disparity, include_inverse)
    if on_cpu and not parts:
        return directional_scan_group_bidir_plain(cost, img_left, part,
                                                  rolls_f, rolls_b, p1, p2,
                                                  restart, wta)
    return _bidir(cost, img_left, part, rolls_f, rolls_b, p1, p2, restart, wta,
                  "aggregate_paths_wta", parts=parts, rows=rows)


# --- K3: LR check ----------------------------------------------------------------

def lr_check(disp_left: torch.Tensor, disp_right: torch.Tensor, thres: float,
             max_shift: int) -> torch.Tensor:
    """f32 (B, H, W) left/right disparities -> checked left disparities."""
    if _on_cpu(disp_left, disp_right):
        return postprocess.lr_check(disp_left, disp_right, thres, max_shift)
    if max_shift <= 0:
        raise ValueError(f"max_shift={max_shift}: pass the disparity bound")
    _check(disp_left, "disp_left", torch.float32, 3)
    _check(disp_right, "disp_right", torch.float32, 3)
    if disp_left.shape != disp_right.shape:
        raise ValueError("left and right disparity maps differ in shape")
    b, h, w = disp_left.shape
    out = torch.empty_like(disp_left)
    _launch("sgm_lr_check", "lr_check", disp_left.data_ptr(),
            disp_right.data_ptr(), out.data_ptr(), b, h, w,
            float(np.float32(thres)), max_shift, _stream(out))
    return out


# --- K4: speckle removal -------------------------------------------------------------

def _check_speckle(disp: torch.Tensor) -> tuple:
    _check(disp, "disp", torch.float32, 3)
    if disp.numel() >= 2 ** 31:
        raise ValueError("speckle labels are int32: batch too large")
    return disp.shape


def remove_speckles(disp: torch.Tensor, diff_insame: float = 1.0,
                    min_area: int = 50) -> torch.Tensor:
    """f32 (B, H, W), +inf invalid -> the same with small components +inf."""
    if _on_cpu(disp):
        return postprocess.remove_speckles(disp, diff_insame, min_area)
    b, h, w = _check_speckle(disp)
    out = torch.empty_like(disp)
    label = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    count = torch.empty_like(label)
    _launch("sgm_remove_speckles", "remove_speckles", disp.data_ptr(),
            out.data_ptr(), label.data_ptr(), count.data_ptr(), b, h, w,
            float(np.float32(diff_insame)), min_area, _stream(out))
    return out


def union_find_labels_plain(disp, diff_insame: float = 1.0) -> torch.Tensor:
    return postprocess.component_labels(disp, diff_insame).to(torch.int32)


def union_find_labels(disp: torch.Tensor,
                      diff_insame: float = 1.0) -> torch.Tensor:
    """K4's label stage alone (tiles labelled in shared memory, unions
    across tile borders, flatten): f32 (B, H, W) -> int32
    (B, H, W), every pixel's root, the smallest flat index (over the batch)
    of its component; a non-finite pixel is its own root."""
    if _on_cpu(disp):
        return union_find_labels_plain(disp, diff_insame)
    b, h, w = _check_speckle(disp)
    label = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    _launch("sgm_speckle_union_labels", "remove_speckles", disp.data_ptr(),
            label.data_ptr(), b, h, w, float(np.float32(diff_insame)),
            _stream(label))
    return label


def count_verdict(disp: torch.Tensor, labels: torch.Tensor,
                  min_area: int = 50) -> torch.Tensor:
    """K4's count and verdict alone, on the int32 (B, H, W) roots of
    ``union_find_labels``: f32 (B, H, W) -> the same with the components of
    fewer than ``min_area`` finite pixels +inf."""
    if _on_cpu(disp, labels):
        return postprocess.small_components_to_inf(disp, labels, min_area)
    b, h, w = _check_speckle(disp)
    _check(labels, "labels", torch.int32, 3)
    if labels.shape != disp.shape:
        raise ValueError(f"labels {tuple(labels.shape)} != disp "
                         f"{tuple(disp.shape)}")
    out = torch.empty_like(disp)
    count = torch.empty_like(labels)
    _launch("sgm_speckle_count_verdict", "remove_speckles", disp.data_ptr(),
            labels.data_ptr(), count.data_ptr(), out.data_ptr(), b, h, w,
            min_area, _stream(out))
    return out
