"""The plain SGM pipeline, frozen: what decides whether a run is correct.

A copy of the plain PyTorch stages of the port as they compute today
(census, Hamming cost volume, path aggregation, winner-take-all, the
disparity's uniqueness / border / sub-pixel step, LR check, speckle
removal, out-of-place 3x3 median), written again so that it imports
nothing of the port, nothing of the JAX package and no JAX.  The
arithmetic is the same, operation for operation, so a later change to the
port cannot move it; the tests hold it bit for bit against the port's
``sgm_forward(use_kernels=False)`` at small shapes on the CPU.

What differs from the port's plain stages is only how the work is laid
out, so that a full-size frame fits on one card beside nothing else: the
cost volume and the WTA go in blocks of rows, the directional scans add
into one int32 sum in place (the horizontal pair into a transposed sum of
its own), and frames go through in blocks (``frame_block``).

``options`` is a plain dict of the ``SGMOptions`` fields (a configuration
file's ``options``); ``diagonal_mode`` is the engine's: ``"wrap"``, the
reference C's mod-W diagonals, or ``"restart"``, paths that restart at the
image's edges.  ``float_dtype`` is the precision of the disparity's
float stage: float32 is the configuration's; the control computes it in
bfloat16, the next precision below, and must come out wrong.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BORDER_COST = 127          # UINT8_MAX / 2: out-of-range source columns
SENTINEL = 255             # L(p-r, -1) = L(p-r, D) = UINT8_MAX
BIG = 1 << 30              # sec_min of an empty set (D = 1)
UINT16_MAX = 65535         # the inverse view outside the image
BLOCK_ELEMENTS = 1 << 26   # volume elements of one block of rows
FRAME_ELEMENTS = 1 << 30   # volume elements of one block of frames
DIAGONAL_MODES = ("wrap", "restart")

# the eight reference directions as (axis, reverse, roll): 'h' scans over W
# (on the transposed volume), 'v' over H; a roll is a diagonal
DIRECTIONS_8 = (
    ("h", False, 0), ("h", True, 0), ("v", False, 0), ("v", True, 0),
    ("v", False, +1), ("v", True, -1), ("v", True, +1), ("v", False, -1),
)


class Planes(NamedTuple):
    """Per-pixel reductions of the summed volume, int32 (B, H, W)."""

    best_idx: torch.Tensor   # first argmin over the d index
    min_cost: torch.Tensor
    sec_min: torch.Tensor    # min over d != best_idx
    c1: torch.Tensor         # cost at clip(best - 1)
    c2: torch.Tensor         # cost at clip(best + 1)


def _check_options(options: dict) -> None:
    if options.get("median_inplace", False):
        raise ValueError("the reference runs the out-of-place median only")
    if options["num_paths"] not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")


def _row_block(per_row: int) -> int:
    return max(1, BLOCK_ELEMENTS // max(1, per_row))


# --- census and cost ---------------------------------------------------------

def census_5x5(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> int32 codes: ``gray < centre`` over the 5x5
    window, MSB first in window order, 2-px border 0."""
    img = img.to(torch.int32)
    h, w = img.shape[-2], img.shape[-1]
    out = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    if h <= 4 or w <= 4:
        return out
    center = img[..., 2:h - 2, 2:w - 2]
    val = torch.zeros_like(center)
    for r in range(-2, 3):
        for c in range(-2, 3):
            neigh = img[..., 2 + r:h - 2 + r, 2 + c:w - 2 + c]
            val = (val << 1) | (neigh < center).to(torch.int32)
    out[..., 2:h - 2, 2:w - 2] = val
    return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def cost_volume(census_left: torch.Tensor, census_right: torch.Tensor,
                dmin: int, dmax: int) -> torch.Tensor:
    """int32 codes (B, H, W) twice -> uint8 (B, H, D, W):
    ``popcount(L[i, j] ^ R[i, j - d])``, 127 where ``j - d`` leaves the
    row; in blocks of rows."""
    b, h, w = census_left.shape
    dev = census_left.device
    disp = torch.arange(dmin, dmax, device=dev)[:, None]
    src = torch.arange(w, device=dev)[None, :] - disp             # (D, W)
    valid = (src >= 0) & (src < w)
    src = src.clamp(0, w - 1)
    out = torch.empty((b, h, dmax - dmin, w), dtype=torch.uint8, device=dev)
    rows = _row_block(b * (dmax - dmin) * w)
    for r0 in range(0, h, rows):
        cl, cr = census_left[:, r0:r0 + rows], census_right[:, r0:r0 + rows]
        ham = popcount32(cl[..., None, :] ^ cr[..., src])
        out[:, r0:r0 + rows] = torch.where(valid, ham, BORDER_COST).to(torch.uint8)
    return out


# --- aggregation -----------------------------------------------------------------

def _dp_step(prev, prev_min, prev_gray, cost_row, gray_row, p1: int,
             p2_init: int) -> torch.Tensor:
    """One DP step on int32 (B, D, P) rows; the path cost mod 256."""
    p2 = torch.clamp(p2_init // ((gray_row - prev_gray).abs() + 1), min=p1)
    pad = torch.full_like(prev[..., :1, :], SENTINEL)
    l2 = torch.cat([pad, prev[..., :-1, :]], dim=-2) + p1
    l3 = torch.cat([prev[..., 1:, :], pad], dim=-2) + p1
    l4 = (prev_min + p2)[..., None, :]
    m = torch.minimum(torch.minimum(prev, l2), torch.minimum(l3, l4))
    return (cost_row + m - prev_min[..., None, :]) & 0xFF


def _scan_into(acc: torch.Tensor, cost: torch.Tensor, img: torch.Tensor,
               p1: int, p2_init: int, reverse: bool, roll: int,
               restart: bool) -> None:
    """Add one direction's path costs into ``acc`` (int32 (B, S, D, P)),
    scanning the uint8 cost (B, S, D, P) and image (B, S, P) over S; the
    first pixel of a path is its raw cost, a diagonal's carry rolls by
    ``roll`` lanes a step; with ``restart`` the lane that the roll brings
    round from the far edge takes its raw cost instead."""
    steps = range(cost.shape[1] - 1, -1, -1) if reverse else range(cost.shape[1])
    reset_lane = 0 if roll > 0 else cost.shape[-1] - 1
    prev = prev_min = prev_gray = None
    for s in steps:
        cost_row = cost[:, s].to(torch.int32)
        gray_row = img[:, s].to(torch.int32)
        if prev is None:
            cs = cost_row
        else:
            if roll:
                prev = prev.roll(roll, dims=-1)
                prev_min = prev_min.roll(roll, dims=-1)
                prev_gray = prev_gray.roll(roll, dims=-1)
            cs = _dp_step(prev, prev_min, prev_gray, cost_row, gray_row, p1,
                          p2_init)
            if roll and restart:
                cs[..., reset_lane] = cost_row[..., reset_lane]
        acc[:, s] += cs
        prev, prev_min, prev_gray = cs, cs.amin(dim=-2), gray_row


def aggregate(cost: torch.Tensor, img: torch.Tensor, options: dict,
              diagonal_mode: str = "wrap") -> torch.Tensor:
    """uint8 cost (B, H, D, W) and image (B, H, W) -> int32 (B, H, D, W),
    the sum over the paths (at most 8 x 255, so the port's uint16 sum holds
    the same values)."""
    restart = diagonal_mode == "restart"
    dirs = DIRECTIONS_8 if options["num_paths"] == 8 else DIRECTIONS_8[:4]
    p1, p2 = options["p1"], options["p2_init"]
    acc = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    for axis, reverse, roll in dirs:
        if axis == "v":
            _scan_into(acc, cost, img, p1, p2, reverse, roll, restart)
    horizontal = [d for d in dirs if d[0] == "h"]
    if horizontal:
        cost_t = cost.transpose(-1, -3).contiguous()        # (B, W, D, H)
        img_t = img.transpose(-1, -2).contiguous()          # (B, W, H)
        acc_t = torch.zeros(cost_t.shape, dtype=torch.int32, device=cost.device)
        for _, reverse, roll in horizontal:
            _scan_into(acc_t, cost_t, img_t, p1, p2, reverse, roll, restart)
        del cost_t
        acc += acc_t.transpose(-1, -3)
    return acc


# --- winner-take-all and the disparity -------------------------------------------

def _reduce(cost: torch.Tensor, inverse: bool, dmin: int) -> Planes:
    """int32 (B, h, D, W) -> Planes of these rows; ``inverse`` samples
    plane k at column j + dmin + k (the right view), 65535 outside."""
    d, w = cost.shape[-2], cost.shape[-1]
    dev = cost.device
    if inverse:
        src = (torch.arange(w, device=dev)[None, :]
               + torch.arange(dmin, dmin + d, device=dev)[:, None])
        valid = (src >= 0) & (src < w)
        sampled = torch.gather(cost, -1, src.clamp(0, w - 1).expand(cost.shape))
        cost = torch.where(valid, sampled, UINT16_MAX)
    kidx = torch.arange(d, device=dev)[:, None]
    key = cost.to(torch.int64) * d + kidx        # its min: first argmin and min
    kmin = key.amin(dim=-2)
    best = (kmin % d).to(torch.int32)
    min_cost = (kmin // d).to(torch.int32)
    onbest = kidx == best[..., None, :]
    sec_min = torch.where(onbest, BIG, cost).amin(dim=-2)
    idx1 = (best - 1).clamp(0, d - 1).long()[..., None, :]
    idx2 = (best + 1).clamp(0, d - 1).long()[..., None, :]
    c1 = torch.gather(cost, -2, idx1).squeeze(-2)
    c2 = torch.gather(cost, -2, idx2).squeeze(-2)
    return Planes(best, min_cost, sec_min, c1, c2)


def wta(aggr: torch.Tensor, dmin: int, inverse: bool) -> Planes:
    """int32 (B, H, D, W) -> Planes (B, H, W), in blocks of rows."""
    b, h, d, w = aggr.shape
    rows = _row_block(b * d * w)
    parts = [_reduce(aggr[:, r0:r0 + rows], inverse, dmin)
             for r0 in range(0, h, rows)]
    return Planes(*(torch.cat(p, dim=1) for p in zip(*parts)))


def _to_int16(x: torch.Tensor) -> torch.Tensor:
    """C int16 cast of int32 values."""
    return ((x + 32768) & 0xFFFF) - 32768


def finalize(planes: Planes, options: dict,
             float_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Planes -> float32 disparity: border and uniqueness tests, parabolic
    sub-pixel step (int16 casts, denominator at least 1) computed in
    ``float_dtype``; +inf where invalid."""
    dmin, dmax = options["min_disparity"], options["max_disparity"]
    best_disp = planes.best_idx + dmin
    min_cost = planes.min_cost
    invalid = (best_disp == dmin) | (best_disp == dmax - 1)
    if options["is_check_unique"]:
        factor = float(np.float32(1.0) - np.float32(options["uniqueness_ratio"]))
        thresh = torch.trunc(min_cost.to(torch.float32) * factor).to(torch.int32)
        invalid |= (planes.sec_min - min_cost) <= thresh
    c1 = _to_int16(planes.c1)
    c2 = _to_int16(planes.c2)
    denom = _to_int16(c1 + c2 - 2 * min_cost).clamp(min=1)
    sub = (c1 - c2).to(float_dtype) / (denom * 2).to(float_dtype)
    disp = (best_disp.to(float_dtype) + sub).to(torch.float32)
    return torch.where(invalid, torch.inf, disp)


# --- post-processing ---------------------------------------------------------------

_OFFSETS8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def lr_check(disp_left: torch.Tensor, disp_right: torch.Tensor, thres: float,
             max_shift: int) -> torch.Tensor:
    """Left disparities inconsistent with the right map become +inf; the
    right map is read at ``trunc(j - d + 0.5)`` only inside the band
    ``[-1, min(max_shift, W-1) + 2)`` of shifts, 0.0 outside it."""
    w = disp_left.shape[-1]
    lane = torch.arange(w, dtype=torch.int32, device=disp_left.device)
    valid = torch.isfinite(disp_left)
    dl = torch.where(valid, disp_left, 0.0)
    col_right = torch.trunc(lane.to(torch.float32) - dl + 0.5).to(torch.int32)
    in_range = (col_right >= 0) & (col_right < w)
    shift = lane - col_right
    band = in_range & (shift >= -1) & (shift < min(max_shift, w - 1) + 2)
    sampled = torch.gather(disp_right, -1, col_right.clamp(0, w - 1).long())
    disp_r = torch.where(band, sampled, 0.0)
    r_finite = torch.isfinite(disp_r)
    dr = torch.where(r_finite, disp_r, 0.0)
    mismatch = (dl - dr).abs() > float(np.float32(thres))
    kill = valid & (~in_range | (r_finite & mismatch))
    return torch.where(kill, torch.inf, disp_left)


def _shift2d(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    out[..., max(0, -dr):h - max(0, dr), max(0, -dc):w - max(0, dc)] = \
        x[..., max(0, dr):h + min(0, dr), max(0, dc):w + min(0, dc)]
    return out


def component_labels(disp: torch.Tensor, diff_insame: float) -> torch.Tensor:
    """int64 (B, H, W): each pixel's smallest flat index in its component
    (8-neighbours, both finite, ``|dd| <= diff`` in f32), by neighbour-min
    rounds with pointer jumping until a round changes nothing."""
    finite = torch.isfinite(disp)
    d = torch.where(finite, disp, 0.0)
    diff = float(np.float32(diff_insame))
    edges = []
    for dr, dc in _OFFSETS8:
        nd = _shift2d(d, dr, dc, 0.0)
        nf = _shift2d(finite, dr, dc, False)
        edges.append((dr, dc, finite & nf & ((d - nd).abs() <= diff)))
    big = disp.numel()
    labels = torch.arange(big, device=disp.device).reshape(disp.shape)
    while True:
        new = labels
        for dr, dc, edge in edges:
            new = torch.minimum(new, torch.where(edge, _shift2d(labels, dr, dc, big), big))
        new = new.reshape(-1)[new]
        if torch.equal(new, labels):
            return labels
        labels = new


def remove_speckles(disp: torch.Tensor, diff_insame: float,
                    min_area: int) -> torch.Tensor:
    """Finite pixels of components with fewer than ``min_area`` finite
    pixels become +inf."""
    labels = component_labels(disp, diff_insame)
    finite = torch.isfinite(disp)
    counts = torch.bincount(labels[finite], minlength=disp.numel())
    small = counts[labels] < min_area
    return torch.where(finite & small, torch.inf, disp)


def _median9(planes):
    p = list(planes)
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])
    return p[4]


def median_3x3(disp: torch.Tensor) -> torch.Tensor:
    """Out-of-place 3x3 median; the 1-px border is left as it is."""
    h, w = disp.shape[-2], disp.shape[-1]
    out = disp.clone()
    out[..., 1:h - 1, 1:w - 1] = _median9(
        [disp[..., 1 + r:h - 1 + r, 1 + c:w - 1 + c]
         for r in (-1, 0, 1) for c in (-1, 0, 1)])
    return out


# --- the pipeline --------------------------------------------------------------------

def volume_planes(left: torch.Tensor, right: torch.Tensor, options: dict,
                  diagonal_mode: str = "wrap"):
    """uint8 (B, H, W) pair -> (forward Planes, inverse Planes): the
    integer half of the pipeline, which the control shares."""
    _check_options(options)
    if diagonal_mode not in DIAGONAL_MODES:
        raise ValueError(f"unknown diagonal_mode {diagonal_mode!r}")
    dmin, dmax = options["min_disparity"], options["max_disparity"]
    cost = cost_volume(census_5x5(left), census_5x5(right), dmin, dmax)
    aggr = aggregate(cost, left, options, diagonal_mode)
    del cost
    fwd = wta(aggr, dmin, inverse=False)
    inv = wta(aggr, dmin, inverse=True) if options["is_check_lr"] else None
    return fwd, inv


def disparity(fwd: Planes, inv, options: dict,
              float_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The float half: finalize, LR check, speckles, median."""
    disp = finalize(fwd, options, float_dtype)
    if options["is_check_lr"]:
        disp = lr_check(disp, finalize(inv, options, float_dtype),
                        options["lrcheck_thres"], options["max_disparity"])
    if options["is_remove_speckles"]:
        disp = remove_speckles(disp, 1.0, options["min_speckle_area"])
    return median_3x3(disp)


def frame_block(h: int, w: int, d: int) -> int:
    """Frames that one block of the reference takes at once."""
    return max(1, FRAME_ELEMENTS // (h * w * d))


def sgm_in(left: torch.Tensor, right: torch.Tensor, options: dict,
           float_dtypes, diagonal_mode: str = "wrap") -> list:
    """uint8 (B, H, W) pair -> [float32 (B, H, W) disparity for each float
    dtype], +inf invalid, in blocks of ``frame_block`` frames; the integer
    half runs once for all of them."""
    b, h, w = left.shape
    n = frame_block(h, w, options["max_disparity"] - options["min_disparity"])
    outs = [[] for _ in float_dtypes]
    for f0 in range(0, b, n):
        fwd, inv = volume_planes(left[f0:f0 + n], right[f0:f0 + n], options,
                                 diagonal_mode)
        for out, dtype in zip(outs, float_dtypes):
            out.append(disparity(fwd, inv, options, dtype))
    return [torch.cat(out) for out in outs]


def sgm(left: torch.Tensor, right: torch.Tensor, options: dict,
        float_dtype: torch.dtype = torch.float32,
        diagonal_mode: str = "wrap") -> torch.Tensor:
    """uint8 (B, H, W) pair -> float32 (B, H, W) disparity, +inf invalid."""
    return sgm_in(left, right, options, [float_dtype], diagonal_mode)[0]
