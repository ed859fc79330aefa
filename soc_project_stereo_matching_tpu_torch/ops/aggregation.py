"""SGM path aggregation — plain PyTorch counterpart of ``ops/aggregation.py``.

The recurrence along a path r:

    L(p,d) = C(p,d) + min(L(p-r,d), L(p-r,d-1)+P1, L(p-r,d+1)+P1,
                          min_d L(p-r) + P2') - min_d L(p-r)
    P2'    = max(P1, P2_init // (|I(p) - I(p-r)| + 1))
    result truncated to uint8 (mod 256, a wrap, not a saturation);
    255 sentinels at d=-1 and d=D.

Each direction is a Python loop over the scan axis with a (..., D, P) carry.
Diagonal paths wrap around the image edges: indexing the carry by the
current column turns them into vertical scans whose carry is circularly
rolled by +-1 every step (``diagonal_mode='wrap'``); ``'restart'`` instead
resets the single wrapped lane to its raw cost.  The scan also takes and
returns the boundary ``ScanCarry``, so the H-tiles of a sharded image can
chain their scans (``parallel/tiles.py``).

Everything is int32: torch's uint16 has no add or min.  The summed volume
is returned as uint16 like the JAX op (8 paths x 255 fits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SGMOptions

SENTINEL = 255  # L(p-r, -1) = L(p-r, D) = UINT8_MAX


class ScanCarry(NamedTuple):
    """Per-path DP state carried along a scan (int32), indexed by the
    column of each path's last pixel, like the JAX op's."""

    cost: torch.Tensor      # (..., D, P) previous path costs
    mincost: torch.Tensor   # (..., P)    min over D of ``cost``
    gray: torch.Tensor      # (..., P)    previous pixel intensity

# The eight reference directions as (axis, reverse, roll):
#   axis 'h': scan over W (transposed view); axis 'v': scan over H.
DIRECTIONS_8 = (
    ("h", False, 0),   # ( 1,  0) ->
    ("h", True, 0),    # (-1,  0) <-
    ("v", False, 0),   # ( 0,  1) v
    ("v", True, 0),    # ( 0, -1) ^
    ("v", False, +1),  # ( 1,  1) wrapping diagonal
    ("v", True, -1),   # (-1, -1)
    ("v", True, +1),   # ( 1, -1)
    ("v", False, -1),  # (-1,  1)
)
DIRECTIONS_4 = DIRECTIONS_8[:4]


def _dp_step(prev: torch.Tensor, prev_min: torch.Tensor,
             prev_gray: torch.Tensor, cost_row: torch.Tensor,
             gray_row: torch.Tensor, p1: int, p2_init: int) -> torch.Tensor:
    """One DP step on int32 (..., D, P) rows; returns the mod-256 cost."""
    p2 = torch.clamp(p2_init // ((gray_row - prev_gray).abs() + 1), min=p1)
    pad = torch.full_like(prev[..., :1, :], SENTINEL)
    l2 = torch.cat([pad, prev[..., :-1, :]], dim=-2) + p1
    l3 = torch.cat([prev[..., 1:, :], pad], dim=-2) + p1
    l4 = (prev_min + p2)[..., None, :]
    m = torch.minimum(torch.minimum(prev, l2), torch.minimum(l3, l4))
    return (cost_row + m - prev_min[..., None, :]) & 0xFF


def directional_scan(
    cost: torch.Tensor,
    img: torch.Tensor,
    p1: int,
    p2_init: int,
    reverse: bool = False,
    roll: int = 0,
    diagonal_mode: str = "wrap",
    carry_in: Optional[ScanCarry] = None,
) -> Tuple[torch.Tensor, ScanCarry]:
    """One directional DP pass over a (..., S, D, P) cost view with its
    (..., S, P) image; returns the int32 contribution (..., S, D, P) and the
    outgoing ``ScanCarry``.

    Without ``carry_in`` the first pixel of every path contributes its raw
    cost; with it, the first row continues an upstream tile's paths: the
    carry is rolled by ``roll`` before the step, and in restart mode the
    edge lane still restarts."""
    cost = cost.to(torch.int32)
    img = img.to(torch.int32)
    if reverse:
        cost = cost.flip(-3)
        img = img.flip(-2)
    out = torch.empty_like(cost)
    if carry_in is None:
        prev = cost[..., 0, :, :]
        out[..., 0, :, :] = prev
        prev_min = prev.amin(dim=-2)
        prev_gray = img[..., 0, :]
        start = 1
    else:
        prev, prev_min, prev_gray = (c.to(torch.int32) for c in carry_in)
        start = 0
    reset_lane = 0 if roll > 0 else cost.shape[-1] - 1
    for s in range(start, cost.shape[-3]):
        if roll:
            prev = prev.roll(roll, dims=-1)
            prev_min = prev_min.roll(roll, dims=-1)
            prev_gray = prev_gray.roll(roll, dims=-1)
        cost_row, gray_row = cost[..., s, :, :], img[..., s, :]
        cs = _dp_step(prev, prev_min, prev_gray, cost_row, gray_row, p1, p2_init)
        if roll and diagonal_mode == "restart":
            cs[..., reset_lane] = cost_row[..., reset_lane]
        out[..., s, :, :] = cs
        prev, prev_min, prev_gray = cs, cs.amin(dim=-2), gray_row
    carry = ScanCarry(prev, prev_min, prev_gray)
    return (out.flip(-3) if reverse else out), carry


def aggregate_paths(
    cost: torch.Tensor,
    img_left: torch.Tensor,
    options: SGMOptions,
    diagonal_mode: str = "wrap",
) -> torch.Tensor:
    """Sum of directional passes: cost (..., H, D, W) uint8 and image
    (..., H, W) uint8 -> aggregated (..., H, D, W) uint16."""
    dirs = DIRECTIONS_8 if options.num_paths == 8 else DIRECTIONS_4
    cost_t = cost.transpose(-1, -3)          # (..., W, D, H)
    img_t = img_left.transpose(-1, -2)       # (..., W, H)
    aggr = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    for axis, reverse, roll in dirs:
        if axis == "h":
            aggr += directional_scan(cost_t, img_t, options.p1, options.p2_init,
                                     reverse, roll, diagonal_mode)[0].transpose(-1, -3)
        else:
            aggr += directional_scan(cost, img_left, options.p1, options.p2_init,
                                     reverse, roll, diagonal_mode)[0]
    return aggr.to(torch.uint16)
