"""Wrappers of the hand-written CUDA kernels — counterpart of the JAX
package's ``ops/pallas_kernels.py``.

One wrapper per kernel entry, each with its plain PyTorch version beside it:

    census_cost_volume  K1 csrc/census_cost.cu  <- census_cost_volume_pallas
    aggregate_paths     K2 csrc/aggregate.cu    <- the DP scan kernels
    wta_reduce          K2 csrc/aggregate.cu    <- wta_reduce_pallas
    lr_check            K3 csrc/lr_check.cu     <- lr_check_pallas
    remove_speckles     K4 csrc/speckle.cu      <- remove_speckles_pallas

``aggregate_paths_wta`` chains the two K2 wrappers, like the JAX entry of
that name.  A wrapper given CPU tensors runs the plain version.  Given CUDA
tensors it checks device, dtype, shape and contiguity, allocates its outputs
with ``torch.empty``, launches on the current stream, raises if the C entry
returns a CUDA error, and adds one to ``LAUNCHES[<wrapper>]`` per C entry
call.  There is no fallback: any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from soc_project_stereo_matching_tpu.config import SGMOptions

from .. import _build
from . import aggregation, census, cost_volume, postprocess
from . import wta as wta_ops
from .wta import WTAPlanes

LAUNCHES = {"census_cost_volume": 0, "aggregate_paths": 0, "wta_reduce": 0,
            "lr_check": 0, "remove_speckles": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True if all tensors are on the CPU; raises unless they are all CUDA."""
    devices = {t.device for t in tensors}
    if all(dev.type == "cpu" for dev in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA "
                     f"device, got {[str(t.device) for t in tensors]}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(entry: str, counter: str, *args) -> None:
    err = getattr(_build.load(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    LAUNCHES[counter] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- K1: census + cost volume -------------------------------------------------

def census_cost_volume_plain(img_left, img_right, min_disparity: int,
                             max_disparity: int) -> torch.Tensor:
    return cost_volume.hamming_cost_volume(
        census.census_5x5(img_left), census.census_5x5(img_right),
        min_disparity, max_disparity)


def census_cost_volume(img_left: torch.Tensor, img_right: torch.Tensor,
                       min_disparity: int, max_disparity: int) -> torch.Tensor:
    """uint8 (B, H, W) pair -> uint8 (B, H, D, W) cost volume."""
    if _on_cpu(img_left, img_right):
        return census_cost_volume_plain(img_left, img_right, min_disparity,
                                        max_disparity)
    _check(img_left, "img_left", torch.uint8, 3)
    _check(img_right, "img_right", torch.uint8, 3)
    if img_left.shape != img_right.shape:
        raise ValueError("left and right images differ in shape")
    b, h, w = img_left.shape
    d = max_disparity - min_disparity
    out = torch.empty((b, h, d, w), dtype=torch.uint8, device=img_left.device)
    _launch("sgm_census_cost", "census_cost_volume", img_left.data_ptr(),
            img_right.data_ptr(), out.data_ptr(), b, h, w, min_disparity, d,
            _stream(out))
    return out


# --- K2: path aggregation + WTA -------------------------------------------------

def aggregate_paths(cost: torch.Tensor, img_left: torch.Tensor,
                    options: SGMOptions,
                    diagonal_mode: str = "wrap") -> torch.Tensor:
    """uint8 (B, H, D, W) cost + uint8 (B, H, W) image -> uint16 (B, H, D, W)
    aggregated volume; one launch per direction of ``DIRECTIONS_8/4``."""
    if _on_cpu(cost, img_left):
        return aggregation.aggregate_paths(cost, img_left, options, diagonal_mode)
    _check(cost, "cost", torch.uint8, 4)
    _check(img_left, "img_left", torch.uint8, 3)
    b, h, d, w = cost.shape
    if img_left.shape != (b, h, w):
        raise ValueError(f"image {tuple(img_left.shape)} does not match cost "
                         f"{tuple(cost.shape)}")
    if not 1 <= d <= 256:
        raise ValueError(f"disparity range {d} outside the kernel's 1..256")
    if diagonal_mode not in ("wrap", "restart"):
        raise ValueError(f"unknown diagonal_mode {diagonal_mode!r}")
    out = torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    dirs = (aggregation.DIRECTIONS_8 if options.num_paths == 8
            else aggregation.DIRECTIONS_4)
    stream = _stream(out)
    for i, (axis, reverse, roll) in enumerate(dirs):
        _launch("sgm_scan_direction", "aggregate_paths", cost.data_ptr(),
                img_left.data_ptr(), out.data_ptr(), b, h, d, w,
                int(axis == "v"), int(reverse), roll,
                int(diagonal_mode == "restart"), options.p1, options.p2_init,
                int(i > 0), stream)
    return out


def wta_reduce_plain(aggr, options: SGMOptions, include_inverse: bool = True):
    fwd = wta_ops.wta_reduce(aggr, options, inverse=False)
    inv = wta_ops.wta_reduce(aggr, options, inverse=True) if include_inverse \
        else None
    return fwd, inv


def wta_reduce(aggr: torch.Tensor, options: SGMOptions,
               include_inverse: bool = True):
    """uint16 (B, H, D, W) -> (forward WTAPlanes, inverse WTAPlanes or None),
    int32 (B, H, W) planes, like ``wta_reduce_pallas``."""
    if _on_cpu(aggr):
        return wta_reduce_plain(aggr, options, include_inverse)
    _check(aggr, "aggr", torch.uint16, 4)
    b, h, d, w = aggr.shape
    n_out = 10 if include_inverse else 5
    out = torch.empty((n_out, b, h, w), dtype=torch.int32, device=aggr.device)
    _launch("sgm_wta_reduce", "wta_reduce", aggr.data_ptr(), out.data_ptr(),
            b, h, d, w, options.min_disparity, int(include_inverse),
            _stream(out))
    planes = out.unbind(0)
    return (WTAPlanes(*planes[:5]),
            WTAPlanes(*planes[5:]) if include_inverse else None)


def aggregate_paths_wta_plain(cost, img_left, options: SGMOptions,
                              diagonal_mode: str = "wrap",
                              include_inverse: bool = True):
    aggr = aggregation.aggregate_paths(cost, img_left, options, diagonal_mode)
    return wta_reduce_plain(aggr, options, include_inverse)


def aggregate_paths_wta(cost: torch.Tensor, img_left: torch.Tensor,
                        options: SGMOptions, diagonal_mode: str = "wrap",
                        include_inverse: bool = True):
    """Aggregation then WTA: (forward WTAPlanes, inverse WTAPlanes or None)."""
    return wta_reduce(aggregate_paths(cost, img_left, options, diagonal_mode),
                      options, include_inverse)


# --- K3: LR check ----------------------------------------------------------------

def lr_check(disp_left: torch.Tensor, disp_right: torch.Tensor, thres: float,
             max_shift: int) -> torch.Tensor:
    """f32 (B, H, W) left/right disparities -> checked left disparities."""
    if _on_cpu(disp_left, disp_right):
        return postprocess.lr_check(disp_left, disp_right, thres, max_shift)
    if max_shift <= 0:
        raise ValueError(f"max_shift={max_shift}: pass the disparity bound")
    _check(disp_left, "disp_left", torch.float32, 3)
    _check(disp_right, "disp_right", torch.float32, 3)
    if disp_left.shape != disp_right.shape:
        raise ValueError("left and right disparity maps differ in shape")
    b, h, w = disp_left.shape
    out = torch.empty_like(disp_left)
    _launch("sgm_lr_check", "lr_check", disp_left.data_ptr(),
            disp_right.data_ptr(), out.data_ptr(), b, h, w,
            float(np.float32(thres)), max_shift, _stream(out))
    return out


# --- K4: speckle removal -------------------------------------------------------------

def remove_speckles(disp: torch.Tensor, diff_insame: float = 1.0,
                    min_area: int = 50) -> torch.Tensor:
    """f32 (B, H, W), +inf invalid -> the same with small components +inf."""
    if _on_cpu(disp):
        return postprocess.remove_speckles(disp, diff_insame, min_area)
    _check(disp, "disp", torch.float32, 3)
    b, h, w = disp.shape
    if b * h * w >= 2 ** 31:
        raise ValueError("speckle labels are int32: batch too large")
    out = torch.empty_like(disp)
    label = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    count = torch.empty_like(label)
    _launch("sgm_remove_speckles", "remove_speckles", disp.data_ptr(),
            out.data_ptr(), label.data_ptr(), count.data_ptr(), b, h, w,
            float(np.float32(diff_insame)), min_area, _stream(out))
    return out
