"""Where the speckle label stage's time goes: union-find beside label
propagation to a fixed point, and what the propagation loop's parts cost.

Counterpart of the JAX package's ``scripts/speckle_probe.py``.  The input is
the engine's own pre-speckle disparity of the seeded synthetic pair (default:
the cone geometry, B=8, 375x450, D=64), ``diff`` 1.0.  Variants, each one
launch over the batch:

    prod      K4's label stage as shipped (``ops.kernels.union_find_labels``:
              three launches: each 32 x 16 tile labelled in shared memory,
              the unions across tile borders in device memory, every pixel
              flattened to its root)
    base      S1 ``probes.kernels.speckle_labels``: seg and cheap rounds in
              turn, the fixed-point test after every round
    pair      a seg+cheap pair per iteration, one test per pair
    fori16    16 rounds, no test: not a fixed point in general; bounds what
              the test costs
    block4    ``pair`` with four frames to a program, which runs until all
              four are still
    pyr       ``base`` with every pixel's run heads found once before the
              loop

Per variant: ms per frame, the rounds each program ran, and whether the
labels equal ``base``'s bit for bit, which is required of all but
``fori16`` (``prod`` after ``flat_to_root_labels``).  On the card every S1
mode is also held against its plain version, labels and rounds.
"""

from __future__ import annotations

from ..ops import kernels as ops_kernels
from . import (GEOMETRY, document, fmt, measure, prespeckle_disparity, ratio,
               require_equal, resolve_device)
from . import kernels as pk

DIFF = 1.0
EXACT = ("base", "pair", "block4", "pyr")      # modes that reach the fixed point


def run(device=None, batch=GEOMETRY["batch"], h=GEOMETRY["h"],
        w=GEOMETRY["w"], dmax=GEOMETRY["dmax"], reps: int = 10) -> dict:
    device = resolve_device(device)
    opt, disp = prespeckle_disparity(device, batch, h, w, dmax)
    doc = document("speckle", device, reps, batch=batch, h=h, w=w,
                   d=opt.disp_range)
    doc["input"] = "pre-speckle disparity of the synthetic pair"
    doc["finite_fraction"] = disp.isfinite().float().mean().item()

    variants = {}
    base, _ = pk.speckle_labels(disp, DIFF, "base")
    prod = pk.flat_to_root_labels(ops_kernels.union_find_labels(disp, DIFF))
    require_equal("prod labels", prod, base)
    variants["prod"] = {
        **measure(lambda: ops_kernels.union_find_labels(disp, DIFF), device,
                  reps, batch),
        "rounds": None, "bit_equal_labels": True}
    for mode in pk.LABEL_MODES:
        labels, rounds = pk.speckle_labels(disp, DIFF, mode)
        if device.type == "cuda":       # on the CPU the wrapper is the plain one
            want, want_rounds = pk.speckle_labels_plain(disp, DIFF, mode)
            require_equal(f"{mode} labels", labels, want)
            require_equal(f"{mode} rounds", rounds, want_rounds)
        if mode in EXACT:
            require_equal(f"{mode} labels vs base", labels, base)
        variants[mode] = {
            **measure(lambda: pk.speckle_labels(disp, DIFF, mode), device,
                      reps, batch),
            "rounds": rounds.tolist(),
            "bit_equal_labels": bool((labels == base).all())}
    doc["variants"] = variants

    ms = {name: rec["ms_per_frame"] for name, rec in variants.items()}
    best = None if ms["base"] is None else min(EXACT, key=lambda m: ms[m])
    # a launch lasts as long as its slowest program
    per_round = {mode: ratio(ms[mode], max(variants[mode]["rounds"]))
                 for mode in ("pair", "fori16")}
    doc["summary"] = {
        "best_exact": best,
        "prod_over_best_exact": None if best is None
        else ms["prod"] / ms[best],
        "ms_per_frame_and_round_checked": per_round["pair"],
        "ms_per_frame_and_round_unchecked": per_round["fori16"],
        "check_ms_per_frame_and_round":
            None if per_round["pair"] is None
            else per_round["pair"] - per_round["fori16"],
        "note": ("a round's time is the launch's over the most rounds any of "
                 "its programs ran; the test's cost is pair's less fori16's"),
    }
    return doc


def report(doc: dict) -> str:
    lines = []
    for name, rec in doc["variants"].items():
        rounds = "" if rec["rounds"] is None else f"  rounds {rec['rounds']}"
        lines.append(f"{name:8s} {fmt(rec['ms_per_frame'])} ms/frame  "
                     f"bit_equal_labels={rec['bit_equal_labels']}{rounds}")
    s = doc["summary"]
    lines.append(f"prod / best exact ({s['best_exact']}) "
                 f"{fmt(s['prod_over_best_exact'])}; per frame and round: "
                 f"checked {fmt(s['ms_per_frame_and_round_checked'])}, "
                 f"unchecked {fmt(s['ms_per_frame_and_round_unchecked'])}, "
                 f"the test {fmt(s['check_ms_per_frame_and_round'])} ms")
    return "\n".join(lines)
