"""What the volume transposes around the horizontal scan pair cost.

Counterpart of the JAX package's ``scripts/aggr_transpose_probe.py``.  The
shipped horizontal launches walk the (B, H, D, W) volume along W: a warp's 32
lanes read D planes at stride W, and neighbouring warps, one row apart, share
no sector.  On a volume transposed to (B, W, D, H) a horizontal path is a
column, and the pair runs as two vertical launches.  This probe times both
forms, and the transposes between them, at the production geometry
(default: the cone pair, B=8, 375x450, D=64):

    full         ops.kernels.aggregate_paths_wta, the whole K2 stage
    xin8         PyTorch's transpose of the uint8 cost volume,
                 permute(0, 3, 2, 1).contiguous()
    xout16       the same of the uint16 partial sums, back
    ktrans8      the hand-written transpose kernel on the uint8 volume
                 (probes/kernels.volume_transpose)
    ktrans16     the same on the uint16 volume
    hpart        ops.kernels.horizontal_partial as shipped: two launches
                 along W
    hpart_not    the same two scans on a volume that already is
                 (B, W, D, H): the vertical straight direction forward and
                 reverse on the transposed cost and image, output left
                 transposed
    hpart_T      ktrans8 in + hpart_not + ktrans16 out: the shipped pair's
                 function by way of the transposed volume

``hpart_T`` must equal ``hpart`` and each ``ktrans`` its ``x`` twin, bit for
bit; the probe raises otherwise.
"""

from __future__ import annotations

import torch

from ..ops import kernels as ops_kernels
from . import (GEOMETRY, document, fmt, measure, pair_and_cost, require_equal,
               resolve_device)
from . import kernels as pk


def image_transpose(img: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W) -> (B, W, H), by the volume kernel at D = 1."""
    return pk.volume_transpose(img[:, :, None, :]).squeeze(2)


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
    part_t = hpart_not(pk.volume_transpose(cost), image_transpose(img), p1,
                       p2_init)
    return pk.volume_transpose(part_t)


def run(device=None, batch=GEOMETRY["batch"], h=GEOMETRY["h"],
        w=GEOMETRY["w"], dmax=GEOMETRY["dmax"], reps: int = 10) -> dict:
    device = resolve_device(device)
    opt, left, _, cost = pair_and_cost(device, batch, h, w, dmax)
    p1, p2 = opt.p1, opt.p2_init
    doc = document("aggr_transpose", device, reps, batch=batch, h=h, w=w,
                   d=cost.shape[2])

    cost_t = pk.volume_transpose(cost)
    left_t = image_transpose(left)
    part = ops_kernels.horizontal_partial(cost, left, p1, p2, False)
    part_t = hpart_not(cost_t, left_t, p1, p2)
    require_equal("ktrans8", cost_t, pk.volume_transpose_plain(cost))
    require_equal("ktrans16", pk.volume_transpose(part_t),
                  pk.volume_transpose_plain(part_t))
    require_equal("hpart_not", pk.volume_transpose(part_t), part)
    require_equal("hpart_T", hpart_T(cost, left, p1, p2), part)

    timed = {
        "full": lambda: ops_kernels.aggregate_paths_wta(cost, left, opt),
        "xin8": lambda: pk.volume_transpose_plain(cost),
        "xout16": lambda: pk.volume_transpose_plain(part_t),
        "ktrans8": lambda: pk.volume_transpose(cost),
        "ktrans16": lambda: pk.volume_transpose(part_t),
        "hpart": lambda: ops_kernels.horizontal_partial(cost, left, p1, p2,
                                                        False),
        "hpart_not": lambda: hpart_not(cost_t, left_t, p1, p2),
        "hpart_T": lambda: hpart_T(cost, left, p1, p2),
    }
    variants = {name: measure(fn, device, reps, batch)
                for name, fn in timed.items()}
    doc["variants"] = variants
    doc["checked"] = ["ktrans8 == xin8", "ktrans16 == xout16",
                      "hpart_not transposed == hpart", "hpart_T == hpart"]
    ms = {name: rec["ms_per_frame"] for name, rec in variants.items()}
    measured = ms["hpart"] is not None
    doc["summary"] = {
        "transposes_standalone_ms_per_frame":
            ms["ktrans8"] + ms["ktrans16"] if measured else None,
        "transposes_in_context_ms_per_frame":
            ms["hpart_T"] - ms["hpart_not"] if measured else None,
        "hpart_over_hpart_T": ms["hpart"] / ms["hpart_T"] if measured else None,
        "note": ("in context = hpart_T - hpart_not: what the three transpose "
                 "launches (cost, image, sums) add around the two scans"),
    }
    return doc


def report(doc: dict) -> str:
    lines = [f"{name:10s} {fmt(rec['ms_per_frame'])} ms/frame"
             for name, rec in doc["variants"].items()]
    s = doc["summary"]
    lines.append(f"transposes standalone "
                 f"{fmt(s['transposes_standalone_ms_per_frame'])}, in context "
                 f"{fmt(s['transposes_in_context_ms_per_frame'])} ms/frame; "
                 f"hpart / hpart_T {fmt(s['hpart_over_hpart_T'])}")
    return "\n".join(lines)
