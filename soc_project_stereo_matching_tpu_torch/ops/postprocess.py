"""Disparity post-processing — plain PyTorch counterpart of
``ops/postprocess.py``: LR consistency, speckle removal, and both 3x3
medians (out-of-place, and the reference's in-place raster recurrence).
"""

from __future__ import annotations

import numpy as np
import torch

_OFFSETS8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def lr_check(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    thres: float,
    max_shift: int,
) -> torch.Tensor:
    """Invalidate left disparities inconsistent with the right map (f32
    (..., H, W), +inf invalid); pixels whose right sample is not finite stay.

    Bit-equal to the JAX op on every input, including its bounded select:
    the right map is sampled at ``col_right = trunc((j - d) + 0.5)`` only
    while ``j - col_right`` lies in ``[-1, min(max_shift, W-1) + 2)``;
    outside that band the JAX op sees 0.0, and so does this one."""
    if max_shift <= 0:
        raise ValueError(
            f"max_shift={max_shift}: pass the disparity bound "
            "(e.g. options.max_disparity)")
    w = disp_left.shape[-1]
    dev = disp_left.device
    lane = torch.arange(w, dtype=torch.int32, device=dev)
    valid = torch.isfinite(disp_left)
    dl = torch.where(valid, disp_left, 0.0)
    # (int32)(j - disp + 0.5), evaluated in f32, truncates toward zero
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
    """out[..., r, c] = x[..., r + dr, c + dc], ``fill`` outside the frame."""
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    out[..., max(0, -dr):h - max(0, dr), max(0, -dc):w - max(0, dc)] = \
        x[..., max(0, dr):h + min(0, dr), max(0, dc):w + min(0, dc)]
    return out


def component_labels(disp: torch.Tensor, diff_insame: float = 1.0) -> torch.Tensor:
    """int64 (B, H, W) connected-component labels of f32 (B, H, W): every
    pixel carries the smallest flat index (over the whole batch) of its
    component.  8-neighbours connect when both are finite and ``|dd| <=
    diff`` in f32; a non-finite pixel is a component of its own.  Labels
    start as flat pixel indices and converge by rounds of neighbour-min
    propagation plus pointer jumping, until a round changes nothing."""
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
        new = new.reshape(-1)[new]              # pointer jumping
        if torch.equal(new, labels):
            return labels
        labels = new


def small_components_to_inf(disp: torch.Tensor, labels: torch.Tensor,
                            min_area: int) -> torch.Tensor:
    """f32 (B, H, W) with the finite pixels of every component of fewer than
    ``min_area`` finite pixels set to +inf; ``labels`` as
    ``component_labels`` gives them (any integer type)."""
    finite = torch.isfinite(disp)
    labels = labels.long()
    counts = torch.bincount(labels[finite], minlength=disp.numel())
    small = counts[labels] < min_area
    return torch.where(finite & small, torch.inf, disp)


def remove_speckles(
    disp: torch.Tensor,
    diff_insame: float = 1.0,
    min_area: int = 50,
) -> torch.Tensor:
    """Connected-component speckle filter on f32 (..., H, W), +inf invalid:
    components (``component_labels``) with fewer than ``min_area`` finite
    pixels become +inf."""
    shape = disp.shape
    flat = disp.reshape(-1, shape[-2], shape[-1])
    labels = component_labels(flat, diff_insame)
    return small_components_to_inf(flat, labels, min_area).reshape(shape)


def _median9(planes):
    """Median of 9 equal-shape planes via Paeth's 19-exchange min/max
    network (the JAX op's network; +inf orders last)."""
    p = list(planes)
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])
    return p[4]


def median_filter_3x3(disp: torch.Tensor) -> torch.Tensor:
    """Out-of-place 3x3 median on (..., H, W); the 1-px border is untouched."""
    h, w = disp.shape[-2], disp.shape[-1]
    out = disp.clone()
    out[..., 1:h - 1, 1:w - 1] = _median9(
        [disp[..., 1 + r:h - 1 + r, 1 + c:w - 1 + c]
         for r in (-1, 0, 1) for c in (-1, 0, 1)])
    return out


def median_filter_3x3_inplace(disp: torch.Tensor) -> torch.Tensor:
    """The reference's in-place (raster-recurrence) 3x3 median on
    (..., H, W); the 1-px border is untouched.

    The reference filters with ``in == out``, so the raster scan reads
    already-filtered values at (i-1, j-1), (i-1, j), (i-1, j+1) and
    (i, j-1).  Each of those has a smaller ``t = 2i + j``, so the pixels of
    one t-wavefront are independent: one step per front, 2(H-2)+(W-2)-2
    sequential steps, each gathering only its front's pixels.  The parity
    mode, not a fast path (the JAX op is the same wavefront)."""
    h, w = disp.shape[-2], disp.shape[-1]
    out = disp.clone()
    if h < 3 or w < 3:
        return out
    for t in range(3, 2 * (h - 2) + (w - 2) + 1):
        # interior pixels on the front: 1 <= i <= h-2, 1 <= j = t-2i <= w-2
        i_lo, i_hi = max(1, -(-(t - (w - 2)) // 2)), min(h - 2, (t - 1) // 2)
        i = torch.arange(i_lo, i_hi + 1, device=disp.device)
        j = t - 2 * i
        out[..., i, j] = _median9([out[..., i + r, j + c]
                                   for r in (-1, 0, 1) for c in (-1, 0, 1)])
    return out
