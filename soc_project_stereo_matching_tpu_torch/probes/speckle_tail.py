"""Where the speckle tail's time goes: the pixel count per component and
the verdict, in K4's form and as a histogram and a gather.

Counterpart of the JAX package's ``scripts/speckle_tail_probe.py``.  The
input is the label plane of the engine's pre-speckle disparity of the seeded
synthetic pair (default: the cone geometry, B=8, 375x450, D=64), in the JAX
package's grouped layout (``probes.kernels.group_labels``), ``min_area`` 50.
Variants:

    prod            K4's count and verdict as shipped
                    (``ops.kernels.count_verdict``, on K4's own labels: one
                    add per distinct root of a warp, then the verdict four
                    pixels a thread)
    prod_whole      K4 whole, as the main path calls it (labels included:
                    four launches, the count folded into the flatten)
    base            S2 histogram with one add per pixel -> the plain
                    ``root_small`` op -> S3 gather
    base_agg        the same, S2 aggregated (its default: runs merged in a
                    thread, across the warp and in a block's table, one add
                    per distinct label of a block)
    hist_only       S2 alone, one add per pixel
    hist_only_agg   S2 alone, aggregated
    verdict_only    S3 alone (``root_small`` fixed)
    fused           S4: count, ``root_small`` and verdict in one cooperative
                    launch, one zero store and one add per pixel (the
                    control)
    fused_agg       S4 as it counts by default: a thread's runs merged in
                    registers and in a block's table, a zero store and an
                    add per distinct label of a block

The JAX script's ``base8`` and ``fused8`` ask whether a cheaper operand
speeds the one-hot contraction; without the contraction the question that
takes their place here is what contention on a large component's word
costs, hence the ``_agg`` variants.  Every variant's verdict must equal
``base``'s bit for bit and give K4's output; on the card S2, S3 and S4 are
also held against their plain versions.
"""

from __future__ import annotations

import torch

from ..ops import kernels as ops_kernels
from . import (GEOMETRY, document, fmt, measure, prespeckle_disparity, ratio,
               require_equal, resolve_device)
from . import kernels as pk

DIFF = 1.0
MIN_AREA = 50


def run(device=None, batch=GEOMETRY["batch"], h=GEOMETRY["h"],
        w=GEOMETRY["w"], dmax=GEOMETRY["dmax"], reps: int = 10) -> dict:
    device = resolve_device(device)
    min_area = MIN_AREA
    opt, disp = prespeckle_disparity(device, batch, h, w, dmax)
    flat = ops_kernels.union_find_labels(disp, DIFF)
    labels, _ = pk.speckle_labels(disp, DIFF, "base")
    require_equal("production labels", pk.flat_to_root_labels(flat), labels)
    grouped, h_hist, lo_bits = pk.group_labels(disp, labels, min_area)
    g, _, _ = pk.speckle_band_geometry(h, w, min_area)
    doc = document("speckle_tail", device, reps, batch=batch, h=h, w=w,
                   d=opt.disp_range)
    doc["input"] = "labels of the synthetic pair's pre-speckle disparity"
    doc["min_area"] = min_area
    doc["geometry"] = {"g": g, "pc": pk.SPECKLE_PC, "h_hist": h_hist,
                       "lo": 1 << lo_bits, "ngroups": grouped.shape[1]}

    def two_launch(aggregate: bool) -> torch.Tensor:
        counts = pk.speckle_hist(grouped, h_hist, lo_bits, aggregate)
        return pk.speckle_verdict(grouped, pk.root_small(counts, min_area))

    counts = pk.speckle_hist(grouped, h_hist, lo_bits, False)
    small = pk.root_small(counts, min_area)
    verdict = two_launch(False)
    want = ops_kernels.remove_speckles(disp, DIFF, min_area)
    require_equal("base output", pk.apply_verdict(
        disp, pk.ungroup_verdict(verdict, h, w)), want)
    require_equal("prod output", ops_kernels.count_verdict(disp, flat, min_area),
                  want)
    require_equal("hist_only_agg", pk.speckle_hist(grouped, h_hist, lo_bits,
                                                   True), counts)
    require_equal("verdict_only", pk.speckle_verdict(grouped, small), verdict)
    require_equal("base_agg", two_launch(True), verdict)
    for aggregate in (False, True):
        require_equal(f"fused, aggregate={aggregate}", pk.speckle_tail_fused(
            grouped, min_area, h_hist, lo_bits, aggregate), verdict)
    if device.type == "cuda":       # on the CPU the wrappers are the plain ones
        require_equal("S2", counts,
                      pk.speckle_hist_plain(grouped, h_hist, lo_bits))
        require_equal("S3", verdict, pk.speckle_verdict_plain(grouped, small))
        require_equal("S4", verdict, pk.speckle_tail_fused_plain(
            grouped, min_area, h_hist, lo_bits))

    timed = {
        "prod": lambda: ops_kernels.count_verdict(disp, flat, min_area),
        "prod_whole": lambda: ops_kernels.remove_speckles(disp, DIFF, min_area),
        "base": lambda: two_launch(False),
        "base_agg": lambda: two_launch(True),
        "hist_only": lambda: pk.speckle_hist(grouped, h_hist, lo_bits, False),
        "hist_only_agg": lambda: pk.speckle_hist(grouped, h_hist, lo_bits, True),
        "verdict_only": lambda: pk.speckle_verdict(grouped, small),
        "fused": lambda: pk.speckle_tail_fused(grouped, min_area, h_hist,
                                               lo_bits, aggregate=False),
        "fused_agg": lambda: pk.speckle_tail_fused(grouped, min_area, h_hist,
                                                   lo_bits, aggregate=True),
    }
    variants = {name: measure(fn, device, reps, batch)
                for name, fn in timed.items()}
    doc["variants"] = variants
    doc["largest_component"] = int(counts.max())
    doc["checked"] = ["K4's labels == S1 base after the map",
                      "every variant's verdict == base's",
                      "base and prod output == K4 whole"]
    ms = {name: rec["ms_per_frame"] for name, rec in variants.items()}
    doc["summary"] = {
        "prod_over_base": ratio(ms["prod"], ms["base"]),
        "base_over_fused": ratio(ms["base"], ms["fused"]),
        "base_agg_over_fused_agg": ratio(ms["base_agg"], ms["fused_agg"]),
        "hist_over_hist_agg": ratio(ms["hist_only"], ms["hist_only_agg"]),
        "tail_share_of_k4": ratio(ms["prod"], ms["prod_whole"]),
        "note": ("base - hist_only - verdict_only is the plain root_small "
                 "op between the launches"),
    }
    return doc


def report(doc: dict) -> str:
    lines = [f"{name:14s} {fmt(rec['ms_per_frame'])} ms/frame"
             for name, rec in doc["variants"].items()]
    s = doc["summary"]
    lines.append(f"prod / base {fmt(s['prod_over_base'])}; base / fused "
                 f"{fmt(s['base_over_fused'])}; base_agg / fused_agg "
                 f"{fmt(s['base_agg_over_fused_agg'])}; hist / hist_agg "
                 f"{fmt(s['hist_over_hist_agg'])}; tail share of K4 "
                 f"{fmt(s['tail_share_of_k4'])}; largest component "
                 f"{doc['largest_component']} pixels")
    return "\n".join(lines)
