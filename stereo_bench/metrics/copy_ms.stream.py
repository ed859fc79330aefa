"""copy_ms.stream: device time of the upload and download copies (the
``engine`` layer's memcpy rows in the traced window) per frame.  Host-fed
cells only."""


def read(record):
    t = record.traced
    if record.traffic["feed"] != "host" or t is None:
        return None
    s = t.layer_s.get("engine")
    return None if not s else s * 1e3 / t.frames
