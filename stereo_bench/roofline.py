"""The card's published peaks and the least work of a stage, as fixed
functions of a cell's shapes: they read the same whatever implements the
stage.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM, and 67 T/s, the published float32 rate outside the
tensor cores, which stands in for the integer and DPX operations of the
scan (NVIDIA publishes no integer rate for them).  A share of a roofline
is given beside the card's power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

K2_OPS_PER_ELEMENT = 10     # per element and direction, as the scan counts them
K2_WTA_PLANES = 5           # int32 planes of each view's WTA
K2_VIEWS = 2                # the left view and the inverse (right) view


def k2_bytes(h: int, w: int, d: int) -> int:
    """Bytes K2 must move for one frame: the uint8 cost volume read once,
    the uint8 left image read once, and both views' five int32 WTA planes
    written once."""
    return h * w * d + h * w + K2_VIEWS * K2_WTA_PLANES * 4 * h * w


def k2_ops(h: int, w: int, d: int, paths: int = 8) -> int:
    """Operations of K2 for one frame: 10 per volume element and direction."""
    return K2_OPS_PER_ELEMENT * paths * h * w * d


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the bytes at the memory rate and the operations at
    the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def k2_least_seconds(h: int, w: int, d: int, paths: int = 8) -> float:
    return least_seconds(k2_bytes(h, w, d), k2_ops(h, w, d, paths))
