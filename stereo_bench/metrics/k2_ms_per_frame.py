"""k2_ms_per_frame: device time of the kernels of ``layers/kernels_k2``
per frame of the traced window."""


def read(record):
    t = record.traced
    s = t and t.layer_s.get("kernels_k2")
    return s * 1e3 / t.frames if s else None
