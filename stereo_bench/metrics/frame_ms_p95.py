"""frame_ms_p95: the 95th percentile of every frame's time in the window,
from its CUDA event before ``match_batch`` to its CUDA event after the
disparity is in host memory (the device's clock).  Host-fed cells only."""

from stereo_bench import stats


def read(record):
    if not record.frame_ms:
        return None
    return stats.percentile(record.frame_ms, 95)
