"""Measurement tools of the port, each with kernels of its own.

    python -m soc_project_stereo_matching_tpu_torch.probes <name> \
        [--batch 8] [--h 375] [--w 450] [--dmax 64] [--reps 10]

    recurrence_floor   the serial floor of the SGM recurrence beside the
                       shipped K2 scans and the memory stream
    aggr_transpose     what the volume transposes around the horizontal
                       pair cost, and the pair on a transposed volume
    int16_recurrence   the recurrence in 16-bit lanes: a ladder of single
                       operations, and the packed group scan beside K2's
    ablation           the engine with post stages switched off
    speckle            the speckle label stage: K4's union-find beside label
                       propagation to a fixed point and its variants
    speckle_tail       the speckle count and verdict: K4's beside a histogram
                       and a gather in two launches or one, with plain or
                       warp-aggregated atomics

Counterparts of the JAX package's ``scripts/recurrence_floor.py``,
``aggr_transpose_probe.py``, ``mosaic_int16_probe.py``,
``ablation_profile.py``, ``speckle_probe.py`` and ``speckle_tail_probe.py``.  Every module has ``run(device=None, ...)``, which
returns the JSON document: on the card (the default; it raises without one)
every variant is checked against its plain version and timed with CUDA
events; with ``device="cpu"`` the plain versions run, everything is checked
and every time is None, since a time is a device number.  A variant that
fails to build, launch or compare raises: nothing is recorded and passed
over.  The helpers below are what the modules share.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..config import SGMOptions
from ..data.synthetic import synthetic_pair
from ..ops import kernels as ops_kernels
from ..utils import profiling

GEOMETRY = dict(batch=8, h=375, w=450, dmax=64)     # the cone pair, B=8
SEED = 0                    # of every probe's synthetic pair and random inputs


def resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes need a CUDA device (pass device='cpu' "
                           "to run their plain versions, untimed)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def pair_and_cost(device, batch: int, h: int, w: int, dmax: int,
                  seed: int = SEED):
    """(options, left, right, cost volume) of a seeded synthetic pair."""
    opt = SGMOptions(max_disparity=dmax)
    levels = tuple(max(1, dmax * f // 64) for f in (10, 20, 35))
    left, right, _ = synthetic_pair(seed, batch, h, w, levels)
    left = torch.from_numpy(left).to(device)
    right = torch.from_numpy(right).to(device)
    cost = ops_kernels.census_cost_volume(left, right, opt.min_disparity,
                                          opt.max_disparity)
    return opt, left, right, cost


def prespeckle_disparity(device, batch: int, h: int, w: int, dmax: int,
                         seed: int = SEED):
    """(options, f32 (B, H, W) disparity) of the engine's kernel path on the
    seeded synthetic pair with speckle removal switched off: the speckle
    stage's input, with the component structure of a real frame."""
    from ..models.sgm import sgm_forward

    opt, left, right, _ = pair_and_cost(device, batch, h, w, dmax, seed)
    no_speckle = dataclasses.replace(opt, is_remove_speckles=False)
    return opt, sgm_forward(left, right, no_speckle, use_kernels=True)


def random_tensor(seed: int, low: int, high: int, shape, dtype, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(low, high, shape, generator=gen,
                         dtype=torch.int32).to(dtype).to(device)


def require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError(f"{name}: the values differ")


def measure(fn: Callable[[], object], device: torch.device, reps: int,
            batch: int) -> dict:
    """One variant's record.  On the card: CUDA-event times of ``fn()``; on
    the CPU ``fn()`` runs once and the times are None."""
    if device.type != "cuda":
        fn()
        return {"ms_per_frame": None, "ms_per_call": None}
    t = profiling.cuda_time(fn, reps)
    return {"ms_per_frame": t["median"] / batch, "ms_per_call": t}


def document(name: str, device: torch.device, reps: int, **geometry) -> dict:
    """The head of a probe's JSON document: where and on what it ran."""
    doc = {"probe": name, "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
           "device": device.type, "card": None, "power_limit": None,
           "reps": reps, **geometry}
    if device.type == "cuda":
        doc["card"], doc["power_limit"] = profiling.card()
    return doc


def ratio(a: Optional[float], b: Optional[float]) -> Optional[float]:
    return None if a is None or b is None or b == 0 else a / b


def fmt(v: Optional[float]) -> str:
    return "not measured" if v is None else f"{v:.4f}"
