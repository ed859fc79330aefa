"""k2_roofline: K2's least time per frame (``roofline.k2_least_seconds``
of the cell's shapes) over its measured device time per frame of the
traced window, in %."""

from stereo_bench import roofline


def read(record):
    t = record.traced
    s = t and t.layer_s.get("kernels_k2")
    if not s:
        return None
    least = roofline.k2_least_seconds(record.height, record.width,
                                      record.disparities, record.paths)
    return 100.0 * least / (s / t.frames)
