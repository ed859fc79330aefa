"""Winner-take-all, uniqueness test, subpixel refinement — plain PyTorch
counterpart of ``ops/wta.py``.

``wta_reduce`` is the O(H*D*W) volume reduction (the kernel's job on the
card); ``finalize_disparity`` the O(H*W) exact elementwise math shared by the
plain and kernel paths.  Semantics, as in the reference:

* first-minimum tie-breaking over d;
* ``sec_min`` is the min over d != best (not the second distinct value);
  for D=1 it is the empty-set value 1<<30;
* ``inverse=True`` samples the left volume at column j + (dmin + k) for
  plane k (the disparity value, not k), out-of-range columns costing 65535;
* uniqueness ``sec - min <= trunc(f32(min) * (f32(1) - f32(ratio)))``;
* border disparities (dmin, dmax-1) invalid; parabolic subpixel with int16
  casts and the denominator clamped to >= 1; invalid = +inf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SGMOptions

from .exact_math import div_s32_correctly_rounded

BIG = 1 << 30
UINT16_MAX = 65535


class WTAPlanes(NamedTuple):
    """Per-pixel volume reductions, all int32 (..., H, W)."""

    best_idx: torch.Tensor   # first argmin over the d index
    min_cost: torch.Tensor
    sec_min: torch.Tensor    # min over d != best_idx
    c1: torch.Tensor         # cost at clip(best-1)
    c2: torch.Tensor         # cost at clip(best+1)


def _to_int16(x: torch.Tensor) -> torch.Tensor:
    """C int16 cast emulation on int32 values."""
    return ((x + 32768) & 0xFFFF) - 32768


def _inverse_cost_view(aggr: torch.Tensor, min_disparity: int) -> torch.Tensor:
    """int32 (..., H, D, W) -> R[..., h, k, j] = aggr[..., h, k, j + dmin + k]
    (right-view sampling), 65535 where the column leaves the image."""
    d, w = aggr.shape[-2], aggr.shape[-1]
    dev = aggr.device
    src = (torch.arange(w, device=dev)[None, :]
           + torch.arange(min_disparity, min_disparity + d, device=dev)[:, None])
    valid = (src >= 0) & (src < w)
    sampled = torch.gather(aggr, -1, src.clamp(0, w - 1).expand(aggr.shape))
    return torch.where(valid, sampled, UINT16_MAX)


def wta_reduce(aggr: torch.Tensor, options: SGMOptions,
               inverse: bool = False) -> WTAPlanes:
    """aggr (..., H, D, W) uint16 (or int32) -> per-pixel reduction planes."""
    cost = aggr.to(torch.int32)
    if inverse:
        cost = _inverse_cost_view(cost, options.min_disparity)
    d = cost.shape[-2]
    kidx = torch.arange(d, device=cost.device)[:, None]
    # packed (cost, d) key: its min is the first argmin and the min at once
    key = cost.to(torch.int64) * d + kidx
    kmin = key.amin(dim=-2)
    best = (kmin % d).to(torch.int32)
    min_cost = (kmin // d).to(torch.int32)
    onbest = kidx == best[..., None, :]
    sec_min = torch.where(onbest, BIG, cost).amin(dim=-2)
    idx1 = (best - 1).clamp(0, d - 1).long()[..., None, :]
    idx2 = (best + 1).clamp(0, d - 1).long()[..., None, :]
    c1 = torch.gather(cost, -2, idx1).squeeze(-2)
    c2 = torch.gather(cost, -2, idx2).squeeze(-2)
    return WTAPlanes(best, min_cost, sec_min, c1, c2)


def finalize_disparity(planes: WTAPlanes, options: SGMOptions) -> torch.Tensor:
    """Reduction planes -> float32 disparity with uniqueness/border/subpixel
    (O(H*W) elementwise), +inf where invalid."""
    dmin, dmax = options.min_disparity, options.max_disparity
    best_disp = planes.best_idx + dmin
    min_cost = planes.min_cost

    invalid = (best_disp == dmin) | (best_disp == dmax - 1)
    if options.is_check_unique:
        # f32(1) - f32(ratio), not the Python double 1 - ratio.  It is exact
        # in f32, so the f32 product equals the JAX op's; a Python scalar
        # (not a device tensor) avoids a host-to-device copy that would
        # block the host until the queued kernels finish.
        factor = float(np.float32(1.0) - np.float32(options.uniqueness_ratio))
        thresh = torch.trunc(min_cost.to(torch.float32) * factor).to(torch.int32)
        invalid |= (planes.sec_min - min_cost) <= thresh

    c1 = _to_int16(planes.c1)
    c2 = _to_int16(planes.c2)
    denom = _to_int16(c1 + c2 - 2 * min_cost).clamp(min=1)
    sub = div_s32_correctly_rounded(c1 - c2, denom * 2)
    disp = best_disp.to(torch.float32) + sub
    return torch.where(invalid, torch.inf, disp)
