"""The one generator of inputs: seeded synthetic stereo pairs at a
configuration's frame size, as a pool that the measured loops cycle through.

``synthetic_pair`` and ``levels`` are copies of the port's
``data/synthetic.synthetic_pair`` and ``benches.levels``, so that a change
to the port cannot move the inputs.  A traffic file (``traffic/<name>.json``)
holds:

    feed       the loop that drives the calls, ``feeds/<feed>.py``: "host"
               (numpy pairs into each call, the disparity back to host
               memory) or "resident" (inputs and outputs on the card)
    batch      frames a call
    pool       distinct calls' inputs, cycled through
    keep       outputs of each pool entry sampled from the seed for the
               check of correctness
    why        who sends such traffic

Every frame of a pool has a texture of its own, so no two calls in a row
see the same pair.  Every loop is closed, with one client.
"""

from __future__ import annotations

import numpy as np

SEED_MODULUS = 1 << 64


def levels(dmin: int, dmax: int) -> tuple:
    """Disparities of the synthetic field, strictly inside [dmin, dmax):
    10, 20 and 35 of every 64 levels, offset by ``dmin``."""
    return tuple(dmin + max(1, (dmax - dmin) * f // 64) for f in (10, 20, 35))


def synthetic_pair(seed: int, batch: int, h: int, w: int, levels):
    """-> (left, right, field): uint8 (batch, H, W) twice and int (H, W).

    The right image is a 3x3-blurred random texture, the left the same
    texture shifted by a piecewise-constant field: bands of
    ``levels[:-1]`` top to bottom and a centred rectangle at
    ``levels[-1]``."""
    rng = np.random.default_rng(seed)
    pad = max(levels)
    tex = rng.integers(0, 256, (batch, h + 2, w + pad + 2)).astype(np.float32)
    tex = sum(tex[:, 1 + r:h + 1 + r, 1 + c:w + pad + 1 + c]
              for r in (-1, 0, 1) for c in (-1, 0, 1)) / 9.0
    tex = tex.astype(np.uint8)
    bands = np.array(levels[:-1])
    field = bands[(np.arange(h) * len(bands)) // h][:, None].repeat(w, axis=1)
    field[h // 4:(3 * h) // 4, w // 3:(2 * w) // 3] = levels[-1]
    right = np.ascontiguousarray(tex[:, :, pad:])
    cols = np.arange(w)[None, :] + pad - field
    left = np.take_along_axis(tex, np.broadcast_to(cols, (batch, h, w)), axis=2)
    return np.ascontiguousarray(left), right, field


def pool(seed: int, config: dict, traffic: dict):
    """(lefts, rights, field): uint8 numpy (pool, batch, H, W) twice and
    the true disparity (H, W), all from ``seed`` (any integer)."""
    opt = config["options"]
    n, b = traffic["pool"], traffic["batch"]
    h, w = config["height"], config["width"]
    left, right, field = synthetic_pair(
        seed % SEED_MODULUS, n * b, h, w,
        levels(opt["min_disparity"], opt["max_disparity"]))
    return left.reshape(n, b, h, w), right.reshape(n, b, h, w), field
