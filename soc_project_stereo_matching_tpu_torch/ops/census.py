"""Census transform (5x5) — plain PyTorch counterpart of ``ops/census.py``.

Strict ``gray < gray_center``, centre included (always-0 bit), 2-px border
left at 0; the 25 window bits are packed MSB-first in window order
(-2,-2) .. (2,2).  Codes are int32 (25 bits fit; torch has no uint32 ops).
"""

from __future__ import annotations

import torch


def census_5x5(img: torch.Tensor) -> torch.Tensor:
    """img: uint8 (..., H, W) -> int32 census codes (..., H, W)."""
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
