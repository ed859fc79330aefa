"""The SGM recurrence in 16-bit lanes.

Counterpart of the JAX package's ``scripts/mosaic_int16_probe.py`` and of the
``compute16=True`` branch of its group scan.  There a ladder of tiny kernels,
each adding one 16-bit operation of the recurrence, named the operation the
TPU compiler crashed on.  On this card a rung is a kernel that must give the
right numbers: each runs (``probes/kernels.rung``) on the script's shapes,
uint8 (1, 16, 256) planes and (1, 8, 256) rows for the loop rungs, and is
compared with its plain version; p7 is the whole group scan with packed
16-bit state (``probes/kernels.scan16``: one launch per group on the shipped
group scan's cluster frame, two disparities to a register) on a
(1, 8, 16, 256) volume, directions (0, 1, -1).

Then ``scan16`` is held against the shipped K2 group scan
(``ops.kernels.directional_scan_group``) at the production geometry
(default: the cone pair, B=8, 375x450, D=64), forward and reverse, wrapping
and restarting diagonals: bit-equal, and timed beside it (``scan16`` vs
``prod3``).
"""

from __future__ import annotations

import torch

from ..ops import kernels as ops_kernels
from . import (GEOMETRY, SEED, document, fmt, measure, pair_and_cost,
               random_tensor, ratio, require_equal, resolve_device)
from . import kernels as pk

D, W, ROWS = 16, 256, 8     # the ladder's shapes
GROUP = (0, 1, -1)
RUNG_NAMES = {"p0": "p0_widen_store", "p1": "p1_path_shift",
              "p2": "p2_d_shift_even", "p3": "p3_d_shift_odd",
              "p4": "p4_sentinel_select", "p5": "p5_state_loop_min",
              "p6": "p6_doubling_tree", "p8": "p8_min16",
              "p9": "p9_cmp_select16", "p10": "p10_arith_min16",
              "p5b": "p5b_state_loop_add"}


def run(device=None, batch=GEOMETRY["batch"], h=GEOMETRY["h"],
        w=GEOMETRY["w"], dmax=GEOMETRY["dmax"], reps: int = 10) -> dict:
    device = resolve_device(device)
    seed = SEED
    doc = document("int16_recurrence", device, reps, batch=batch, h=h, w=w,
                   d=dmax, ladder_shape={"D": D, "W": W, "ROWS": ROWS})

    probes = {}
    for i, (name, label) in enumerate(RUNG_NAMES.items()):
        rows = ROWS if name in pk.LOOP_RUNGS else D
        x = random_tensor(seed + i, 0, 256, (1, rows, W), torch.uint8, device)
        require_equal(label, pk.rung(name, x), pk.rung_plain(name, x))
        probes[label] = {"ok": True}
    cost = random_tensor(seed + 20, 0, 128, (1, ROWS, D, W), torch.uint8, device)
    img = random_tensor(seed + 21, 0, 256, (1, ROWS, W), torch.uint8, device)
    for reverse in (False, True):
        for restart in (False, True):
            args = (cost, img, GROUP, reverse, 10, 150, restart)
            require_equal("p7_full_step_tiny", pk.scan16(*args),
                          pk.scan16_plain(*args))
    probes["p7_full_step_tiny"] = {"ok": True}
    doc["probes"] = probes

    # the packed group scan beside the shipped one, at the real geometry
    opt, left, _, cost = pair_and_cost(device, batch, h, w, dmax)
    p1, p2 = opt.p1, opt.p2_init
    for reverse in (False, True):
        for restart in (False, True):
            require_equal(
                f"scan16 reverse={reverse} restart={restart}",
                pk.scan16(cost, left, GROUP, reverse, p1, p2, restart),
                ops_kernels.directional_scan_group(cost, left, None, GROUP,
                                                   reverse, p1, p2, restart))
    variants = {
        "scan16": measure(lambda: pk.scan16(cost, left, GROUP, False, p1, p2,
                                            False), device, reps, batch),
        "prod3": measure(lambda: ops_kernels.directional_scan_group(
            cost, left, None, GROUP, False, p1, p2, False), device, reps, batch),
    }
    doc["variants"] = variants
    doc["summary"] = {"scan16_over_prod3": ratio(
        variants["scan16"]["ms_per_frame"], variants["prod3"]["ms_per_frame"])}
    return doc


def report(doc: dict) -> str:
    lines = [f"{name}: ok" for name in doc["probes"]]
    v = doc["variants"]
    lines.append(f"scan16 {fmt(v['scan16']['ms_per_frame'])} vs prod3 "
                 f"{fmt(v['prod3']['ms_per_frame'])} ms/frame (ratio "
                 f"{fmt(doc['summary']['scan16_over_prod3'])}), bit-equal")
    return "\n".join(lines)
