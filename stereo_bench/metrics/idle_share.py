"""idle_share: 1 - (the union of the device's activity intervals) / (the
traced window's span between its CUDA events)."""

from stereo_bench import trace


def read(record):
    t = record.traced
    if t is None or not t.busy_s:
        return None
    return trace.idle_share(t.busy_s, t.window_s)
