"""What the volume transposes around the horizontal scan pair cost.

Counterpart of the JAX package's ``scripts/aggr_transpose_probe.py``.  The
first design's horizontal launches walk the (B, H, D, W) volume along W: a
warp's 32 lanes read D planes at stride W, and neighbouring warps, one row
apart, share no sector.  On a volume transposed to (B, W, D, H) a horizontal
path is a column, and the pair runs as group scans (two one-direction
launches, or one two-order launch as the shipped
``ops.kernels.horizontal_partial`` makes it).  This probe
times both forms, and the transposes between them, at the production
geometry (default: the cone pair, B=8, 375x450, D=64):

    full           ops.kernels.aggregate_paths_wta, the whole K2 stage as
                   shipped (group kernel: the transposed horizontal pair,
                   the vertical pair with the WTA epilogue)
    xin8           PyTorch's transpose of the uint8 cost volume,
                   permute(0, 3, 2, 1).contiguous()
    xout16         the same of the uint16 partial sums, back
    ktrans8        the hand-written transpose kernel on the uint8 volume
                   (ops.kernels.volume_transpose), into the padded pitch the
                   shipped route gives its transposed volumes
    ktrans16       the same on the padded uint16 volume, back
    hpart          ops.kernels.horizontal_partial as shipped: the transposed
                   route (3 transposes, the path scan's launch)
    hpart_strided  the first design: two launches of the warp-per-path
                   kernel along W (ops.kernels.scan_directions)
    hpart_not      the two group scans on a volume that already is
                   (B, W, D, H'), output left transposed
    hpart_T        ktrans8 in + hpart_not + ktrans16 out, assembled here from
                   the pieces: the shipped route launch by launch

``hpart_T`` and ``hpart`` must equal ``hpart_strided`` and each ``ktrans``
its ``x`` twin, bit for bit; the probe raises otherwise.
"""

from __future__ import annotations

import torch

from ..ops import kernels as ops_kernels
from . import (GEOMETRY, document, fmt, measure, pair_and_cost, require_equal,
               resolve_device)
from . import kernels as pk


image_transpose = ops_kernels.image_transpose
PITCH = ops_kernels.TRANSPOSED_PITCH


def hpart_strided(cost: torch.Tensor, img: torch.Tensor, p1: int,
                  p2_init: int) -> torch.Tensor:
    """The horizontal pair by the first design's kernel, which walks the
    (B, H, D, W) volume along W: two launches."""
    return ops_kernels.scan_directions(
        cost, img, (("h", False, 0), ("h", True, 0)), p1, p2_init)


def hpart_not(cost_t: torch.Tensor, img_t: torch.Tensor, p1: int,
              p2_init: int) -> torch.Tensor:
    """Both horizontal directions on a transposed volume: uint8 (B, W, D, H)
    cost + uint8 (B, W, H) image -> their uint16 (B, W, D, H) sum."""
    part = ops_kernels.directional_scan_group(cost_t, img_t, None, (0,), False,
                                              p1, p2_init, False)
    return ops_kernels.directional_scan_group(cost_t, img_t, part, (0,), True,
                                              p1, p2_init, False)


def hpart_T(cost: torch.Tensor, img: torch.Tensor, p1: int,
            p2_init: int) -> torch.Tensor:
    """``ops.kernels.horizontal_partial`` by way of the transposed volume:
    uint8 (B, H, D, W) cost + uint8 (B, H, W) image -> uint16 (B, H, D, W)."""
    part_t = hpart_not(pk.volume_transpose(cost, pad_to=PITCH),
                       image_transpose(img, pad_to=PITCH), p1, p2_init)
    return pk.volume_transpose(part_t, inner=cost.shape[1])


def run(device=None, batch=GEOMETRY["batch"], h=GEOMETRY["h"],
        w=GEOMETRY["w"], dmax=GEOMETRY["dmax"], reps: int = 10) -> dict:
    device = resolve_device(device)
    opt, left, _, cost = pair_and_cost(device, batch, h, w, dmax)
    p1, p2 = opt.p1, opt.p2_init
    doc = document("aggr_transpose", device, reps, batch=batch, h=h, w=w,
                   d=cost.shape[2])

    cost_t = pk.volume_transpose(cost, pad_to=PITCH)
    left_t = image_transpose(left, pad_to=PITCH)
    part = hpart_strided(cost, left, p1, p2)
    part_t = hpart_not(cost_t, left_t, p1, p2)
    require_equal("ktrans8", cost_t,
                  pk.volume_transpose_plain(cost, None, PITCH))
    require_equal("ktrans16", pk.volume_transpose(part_t, inner=h),
                  pk.volume_transpose_plain(part_t, h))
    require_equal("hpart_not", pk.volume_transpose(part_t, inner=h), part)
    require_equal("hpart_T", hpart_T(cost, left, p1, p2), part)
    require_equal("hpart", ops_kernels.horizontal_partial(cost, left, p1, p2,
                                                          False), part)

    timed = {
        "full": lambda: ops_kernels.aggregate_paths_wta(cost, left, opt),
        "xin8": lambda: cost.permute(0, 3, 2, 1).contiguous(),
        "xout16": lambda: part_t[..., :h].permute(0, 3, 2, 1).contiguous(),
        "ktrans8": lambda: pk.volume_transpose(cost, pad_to=PITCH),
        "ktrans16": lambda: pk.volume_transpose(part_t, inner=h),
        "hpart": lambda: ops_kernels.horizontal_partial(cost, left, p1, p2,
                                                        False),
        "hpart_strided": lambda: hpart_strided(cost, left, p1, p2),
        "hpart_not": lambda: hpart_not(cost_t, left_t, p1, p2),
        "hpart_T": lambda: hpart_T(cost, left, p1, p2),
    }
    variants = {name: measure(fn, device, reps, batch)
                for name, fn in timed.items()}
    doc["variants"] = variants
    doc["checked"] = ["ktrans8 == xin8", "ktrans16 == xout16",
                      "hpart_not transposed == hpart_strided",
                      "hpart_T == hpart_strided", "hpart == hpart_strided"]
    doc["kernels"] = {
        "full, hpart, hpart_not, hpart_T": "group kernel (sgm_scan_group)",
        "hpart_strided": "first design, a warp per path (sgm_scan_direction)"}
    ms = {name: rec["ms_per_frame"] for name, rec in variants.items()}
    measured = ms["hpart"] is not None
    doc["summary"] = {
        "transposes_standalone_ms_per_frame":
            ms["ktrans8"] + ms["ktrans16"] if measured else None,
        "transposes_in_context_ms_per_frame":
            ms["hpart_T"] - ms["hpart_not"] if measured else None,
        "hpart_strided_over_hpart_T":
            ms["hpart_strided"] / ms["hpart_T"] if measured else None,
        "note": ("in context = hpart_T - hpart_not: what the three transpose "
                 "launches (cost, image, sums) add around the two scans"),
    }
    return doc


def report(doc: dict) -> str:
    lines = [f"{name:13s} {fmt(rec['ms_per_frame'])} ms/frame"
             for name, rec in doc["variants"].items()]
    s = doc["summary"]
    lines.append(f"transposes standalone "
                 f"{fmt(s['transposes_standalone_ms_per_frame'])}, in context "
                 f"{fmt(s['transposes_in_context_ms_per_frame'])} ms/frame; "
                 f"hpart_strided / hpart_T "
                 f"{fmt(s['hpart_strided_over_hpart_T'])} (hpart, hpart_not, "
                 f"hpart_T and full run the group kernel; hpart_strided the "
                 f"first design's)")
    return "\n".join(lines)
