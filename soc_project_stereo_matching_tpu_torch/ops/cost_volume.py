"""Hamming cost volume — plain PyTorch counterpart of ``ops/cost_volume.py``.

cost[..., i, d - dmin, j] = popcount(censusL[i, j] ^ censusR[i, j - d]);
out-of-range source columns cost UINT8_MAX/2 = 127.  Layout (..., H, D, W).
Torch has no popcount op, so the bit count is the SWAR ladder.
"""

from __future__ import annotations

import torch

BORDER_COST = 127  # UINT8_MAX / 2


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int32 values (census codes use 25 bits)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_cost_volume(
    census_left: torch.Tensor,
    census_right: torch.Tensor,
    min_disparity: int,
    max_disparity: int,
) -> torch.Tensor:
    """int32 census (..., H, W) pair -> uint8 cost volume (..., H, D, W)."""
    w = census_left.shape[-1]
    dev = census_left.device
    disp = torch.arange(min_disparity, max_disparity, device=dev)[:, None]
    src = torch.arange(w, device=dev)[None, :] - disp           # (D, W): j - d
    valid = (src >= 0) & (src < w)
    shifted = census_right[..., src.clamp(0, w - 1)]             # (..., H, D, W)
    ham = popcount32(census_left[..., None, :] ^ shifted)
    return torch.where(valid, ham, BORDER_COST).to(torch.uint8)
