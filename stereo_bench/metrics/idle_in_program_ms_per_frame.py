"""idle_in_program_ms_per_frame: the device's idle time whose innermost
host span is one of the program's (``sgm.*``: its upload, its stages, its
planning queries) per frame of the traced window."""

from stereo_bench import trace


def read(record):
    t = record.traced
    if t is None or not t.span_s:
        return None
    idle = sum(s for name, s in t.idle_s.items()
               if name.startswith(trace.PROGRAM_PREFIX))
    return idle * 1e3 / t.frames
