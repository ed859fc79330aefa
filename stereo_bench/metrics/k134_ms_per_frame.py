"""k134_ms_per_frame: device time of the census, LR-check and speckle
kernels (``layers/kernels_k134``) per frame of the traced window."""


def read(record):
    t = record.traced
    s = t and t.layer_s.get("kernels_k134")
    return s * 1e3 / t.frames if s else None
