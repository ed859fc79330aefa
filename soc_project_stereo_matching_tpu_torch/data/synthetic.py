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
