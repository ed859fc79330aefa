"""Stage attribution by ablation: the full engine with post stages off.

Counterpart of the JAX package's ``scripts/ablation_profile.py``.  Times
``SGMEngine.match_batch`` with individual post stages switched off through
``SGMOptions`` and reports the differences: what each stage adds to a batch
on the card, launches and glue included, where ``stage_breakdown`` times the
stages one by one inside a batch.  A difference below ``noise_floor_ms`` (the
largest max - min over the repeats of any variant) is not distinguishable
from noise.
"""

from __future__ import annotations

import dataclasses

from ..models.sgm import SGMEngine
from . import (GEOMETRY, document, fmt, measure, pair_and_cost,
               resolve_device)


def run(device=None, batch=GEOMETRY["batch"], h=GEOMETRY["h"],
        w=GEOMETRY["w"], dmax=GEOMETRY["dmax"], reps: int = 10) -> dict:
    device = resolve_device(device)
    opt, left, right, _ = pair_and_cost(device, batch, h, w, dmax)
    options = {
        "full": opt,
        "no_speckle": dataclasses.replace(opt, is_remove_speckles=False),
        "no_lr": dataclasses.replace(opt, is_check_lr=False),
        "no_lr_no_speckle": dataclasses.replace(
            opt, is_check_lr=False, is_remove_speckles=False),
        "no_unique": dataclasses.replace(opt, is_check_unique=False),
    }
    doc = document("ablation", device, reps, batch=batch, h=h, w=w, d=dmax)
    variants = {}
    for name, o in options.items():
        engine = SGMEngine(o, device=device)
        variants[name] = measure(lambda: engine.match_batch(left, right),
                                 device, reps, batch)
    doc["variants"] = variants
    ms = {name: rec["ms_per_frame"] for name, rec in variants.items()}
    if ms["full"] is None:
        doc["deltas_ms_per_frame"] = {"speckle": None, "lr_plus_inverse_wta": None,
                                      "uniqueness": None}
        doc["noise_floor_ms"] = None
    else:
        doc["deltas_ms_per_frame"] = {
            "speckle": ms["full"] - ms["no_speckle"],
            "lr_plus_inverse_wta": ms["full"] - ms["no_lr"],
            "uniqueness": ms["full"] - ms["no_unique"]}
        doc["noise_floor_ms"] = max(
            (rec["ms_per_call"]["max"] - rec["ms_per_call"]["min"]) / batch
            for rec in variants.values())
    return doc


def report(doc: dict) -> str:
    lines = [f"{name:18s} {fmt(rec['ms_per_frame'])} ms/frame"
             for name, rec in doc["variants"].items()]
    lines += [f"delta {name}: {fmt(v)} ms/frame"
              for name, v in doc["deltas_ms_per_frame"].items()]
    lines.append(f"noise floor {fmt(doc['noise_floor_ms'])} ms/frame")
    return "\n".join(lines)
