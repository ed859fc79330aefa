"""Whether what the timed path produced is correct.

After the window closes, the configuration's reference
(``reference/<name>.py`` of its ``reference``; without the key the frozen
plain pipeline ``reference/sgm.py``) computes the disparity of every pool
entry that the sample holds an output of, from the inputs the benchmark
made, and every sampled output is compared with it bit for bit (+inf is
the invalid value on both sides).
The numbers compared, each beside its limit:

    pixels_differing   pixels whose float32 bits differ        <= 0
    frames_checked     distinct input frames compared          >= the pool's

A configuration states a bit-equal result, so the comparison is exact and
its limit 0.  The sample holds outputs of every pool entry (of as many as
a short window reached), so every distinct input frame is compared: a run
that compares fewer is not correct.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from . import spec

TRUTH_TOLERANCE = 1.0   # the synthetic truth's sanity line: within 1 pixel
TRUTH_SHARE = 0.95      # of the finite pixels


def _bits(x) -> np.ndarray:
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def reference_of(config: dict):
    """The module of the configuration's ``reference`` (``spec.reference``)."""
    return spec.reference(config.get("reference", spec.DEFAULT_REFERENCE))


def checkable(config: dict) -> None:
    """Refuse, before any run, a configuration whose result its reference
    cannot work out: options the reference's own check refuses, a diagonal
    mode it lacks.  Its ``engine`` settings go to ``EngineConfig`` whole; a
    reference computes whole frames, so a tiling that restarts paths at
    tile edges cannot be checked."""
    reference = reference_of(config)
    reference._check_options(config["options"])
    engine = config["engine"]
    mode = engine.get("diagonal_mode", "wrap")
    if mode not in reference.DIAGONAL_MODES:
        raise ValueError(f"the reference has no diagonal_mode {mode!r}")
    if engine.get("tile_mode", "none") == "local":
        raise ValueError("tile_mode 'local' restarts paths at tile edges; the "
                         "reference computes whole frames")


def reference_outputs(lefts, rights, indices, config: dict, device,
                      float_dtypes=(torch.float32,)) -> list:
    """[{pool index: float32 (B, H, W) disparity}] of the configuration's
    reference, one dict for each float dtype, for each pool entry in
    ``indices``; inputs numpy (pool, B, H, W) uint8.  The entries' frames go through
    the reference together, in its blocks."""
    checkable(config)
    keys = sorted(set(indices))
    if not keys:
        return [{} for _ in float_dtypes]
    b = lefts.shape[1]
    stack = lambda x: torch.from_numpy(
        np.ascontiguousarray(x[keys].reshape((-1,) + x.shape[2:]))).to(device)
    disps = reference_of(config).sgm_in(
        stack(lefts), stack(rights), config["options"], float_dtypes,
        config["engine"].get("diagonal_mode", "wrap"))
    return [{k: d[i * b:(i + 1) * b].cpu().numpy() for i, k in enumerate(keys)}
            for d in disps]


def compare(items: List[tuple], expected: Dict[int, np.ndarray],
            want_frames: int) -> dict:
    """{"numbers": {name: (value, limit, rule)}, "failed": output frames
    that differ, "correct": bool} for sampled (pool index, output) pairs
    against the reference's outputs by pool index; ``frames_checked``
    counts each pool entry's frames once, however many of its outputs the
    sample holds."""
    differing, failed = 0, 0
    for k, out in items:
        got, want = _bits(out), _bits(expected[k])
        if got.shape != want.shape:
            differing += want.size
            failed += want.shape[0]
            continue
        per_frame = (got != want).reshape(got.shape[0], -1).sum(axis=1)
        differing += int(per_frame.sum())
        failed += int((per_frame > 0).sum())
    frames = sum(expected[k].shape[0] for k in {k for k, _ in items})
    want_frames = max(1, want_frames)       # a check of nothing fails
    numbers = {"pixels_differing": (differing, 0, "<="),
               "frames_checked": (frames, want_frames, ">=")}
    ok = differing <= 0 and frames >= want_frames
    return {"numbers": numbers, "failed": failed, "correct": ok}


def truth_line(items: List[tuple], field: np.ndarray) -> str:
    """The synthetic truth's sanity line (not part of ``correct``): the
    share of finite pixels within 1 of the true disparity, first sample."""
    if not items:
        return "truth: no sample"
    out = items[0][1]
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    finite = np.isfinite(out)
    good = (np.abs(out - field) <= TRUTH_TOLERANCE)[finite].mean() \
        if finite.any() else 0.0
    flag = "" if good >= TRUTH_SHARE else f" (under {TRUTH_SHARE})"
    return (f"truth: {float(finite.mean()):.4f} of the pixels finite, "
            f"{float(good):.4f} of those within {TRUTH_TOLERANCE} of the true "
            f"disparity{flag}")


def print_numbers(numbers: dict, stream=sys.stderr) -> None:
    for name, (value, limit, rule) in numbers.items():
        print(f"check {name} {value} {rule} {limit}", file=stream, flush=True)


def as_json(numbers: dict) -> dict:
    return {name: {"value": value, "limit": limit, "rule": rule}
            for name, (value, limit, rule) in numbers.items()}
