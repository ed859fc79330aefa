"""Arithmetic of the end-to-end numbers."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def rate(frames: int, elapsed_s: float) -> float:
    """Frames completed in the window over the time from its start to the
    last completion."""
    if elapsed_s <= 0:
        raise ValueError(f"elapsed {elapsed_s} s")
    return frames / elapsed_s


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile of every sample, linear between order
    statistics (numpy's default)."""
    if not len(xs):
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))

