"""Seeded synthetic stereo pairs with a known disparity field.

The right image is a smoothed random texture; the left image is the same
texture shifted by a piecewise-constant disparity field (horizontal bands
plus one raised rectangle), so left column j matches right column j - d.
The field's steps make occlusions, which give the LR check and the speckle
filter real work.  numpy only, so both the JAX reference and the port can be
fed the same arrays.
"""

from __future__ import annotations

import numpy as np


def synthetic_pair(seed: int, batch: int, h: int, w: int, levels):
    """-> (left, right, field): uint8 (batch, H, W) twice and int (H, W).

    ``levels`` are the disparities of the field: bands of ``levels[:-1]``
    top to bottom and a centred rectangle at ``levels[-1]``; each must lie
    strictly inside the matched range."""
    rng = np.random.default_rng(seed)
    pad = max(levels)
    tex = rng.integers(0, 256, (batch, h + 2, w + pad + 2)).astype(np.float32)
    # 3x3 box blur: structure at a few pixels' scale, as in real images
    tex = sum(tex[:, 1 + r:h + 1 + r, 1 + c:w + pad + 1 + c]
              for r in (-1, 0, 1) for c in (-1, 0, 1)) / 9.0
    tex = tex.astype(np.uint8)
    bands = np.array(levels[:-1])
    field = bands[(np.arange(h) * len(bands)) // h][:, None].repeat(w, axis=1)
    field[h // 4:(3 * h) // 4, w // 3:(2 * w) // 3] = levels[-1]
    right = np.ascontiguousarray(tex[:, :, pad:])
    cols = np.arange(w)[None, :] + pad - field           # (H, W)
    left = np.take_along_axis(tex, np.broadcast_to(cols, (batch, h, w)), axis=2)
    return np.ascontiguousarray(left), right, field


SPECKLE_TILE = (16, 32)   # rows, columns of K4's tiles (csrc/speckle.cu)


def speckle_frames(h: int, w: int, min_area: int, seed: int = 0) -> np.ndarray:
    """f32 (8, h, w) hand-made inputs of the speckle filter, one case a
    frame, +inf = invalid (h >= 40, w >= 70, 2 <= min_area <= 40):

    0. noise with a full-height line of one value in an invalid band;
    1. a one-pixel snake that sweeps every third row across the frame and
       so crosses every tile;
    2. a component of exactly ``min_area`` pixels around one tile corner
       (kept) and one of ``min_area - 1`` around another (removed);
    3. a plateau with a NaN block, a -inf row, and one finite pixel in an
       invalid ring (removed);
    4. no finite pixel;
    5. one value everywhere: a single component;
    6. and 7. a strip of ``ceil(min_area / 2)`` pixels on frame 6's last row
       and one on frame 7's first, same value: together they would reach
       ``min_area``, but frames never connect, so both go."""
    if h < 40 or w < 70 or not 2 <= min_area <= 40:
        raise ValueError(f"speckle_frames needs h >= 40, w >= 70 and "
                         f"2 <= min_area <= 40, got {h}x{w}, {min_area}")
    rng = np.random.default_rng(seed)
    inf = np.float32(np.inf)
    d = np.full((8, h, w), inf, np.float32)
    d[0] = rng.integers(0, 6, (h, w))
    d[0][rng.random((h, w)) < 0.55] = inf
    d[0, :, 9:12] = inf
    d[0, :, 10] = 3.0
    for r in range(0, h, 3):
        d[1, r, :] = 2.0
        if r + 1 < h:                     # the connector down to the next sweep
            d[1, r + 1:r + 3, w - 1 if (r // 3) % 2 == 0 else 0] = 2.0
    th, tw = SPECKLE_TILE
    for (r0, c0), area in (((th, tw), min_area), ((2 * th, 2 * tw), min_area - 1)):
        # rows r0-2 .. r0+1, filled column by column outward from the
        # columns c0-1 and c0: the block crosses the tile corner (r0, c0)
        cells = sorted(((r, c) for c in range(c0 - 6, c0 + 6)
                        for r in range(r0 - 2, r0 + 2)),
                       key=lambda rc: (abs(2 * (rc[1] - c0) + 1), rc))
        for r, c in cells[:area]:
            d[2, r, c] = 5.0
    d[3] = 2.0
    d[3, 5:9, 5:9] = np.nan
    d[3, h // 2, :] = -inf
    d[3, h - 6:h - 3, 3:6] = inf
    d[3, h - 5, 4] = 7.0
    d[5] = 1.0
    half = -(-min_area // 2)
    d[6, h - 1, 20:20 + half] = 4.0
    d[7, 0, 20:20 + half] = 4.0
    return d
