"""glue_ms_per_frame: device time of PyTorch's own kernels
(``layers/plain_glue``: finalize_disparity twice, the median) per frame of
the traced window."""


def read(record):
    t = record.traced
    s = t and t.layer_s.get("plain_glue")
    return s * 1e3 / t.frames if s else None
