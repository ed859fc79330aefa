"""fps: every frame completed in the window over the time from the
window's start to the last completion (host clock over the whole window)."""

from stereo_bench import stats


def read(record):
    return stats.rate(record.frames, record.elapsed_s)
