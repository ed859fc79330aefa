"""``python -m soc_project_stereo_matching_tpu_torch.probes <name>``: run one
probe on the card and write its JSON to ``chiprun_out/<name>.json``."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from . import (GEOMETRY, ablation, aggr_transpose, int16_recurrence,
               recurrence_floor, speckle, speckle_tail)

PROBES = {"recurrence_floor": recurrence_floor,
          "aggr_transpose": aggr_transpose,
          "int16_recurrence": int16_recurrence,
          "ablation": ablation,
          "speckle": speckle,
          "speckle_tail": speckle_tail}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m soc_project_stereo_matching_tpu_torch.probes",
        description="Run one measurement probe on one CUDA device.")
    ap.add_argument("name", choices=sorted(PROBES))
    ap.add_argument("--batch", type=int, default=GEOMETRY["batch"])
    ap.add_argument("--h", type=int, default=GEOMETRY["h"])
    ap.add_argument("--w", type=int, default=GEOMETRY["w"])
    ap.add_argument("--dmax", type=int, default=GEOMETRY["dmax"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="default: chiprun_out/<name>.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"probes {args.name}: needs a CUDA device")
    probe = PROBES[args.name]
    doc = probe.run(device="cuda", batch=args.batch, h=args.h, w=args.w,
                    dmax=args.dmax, reps=args.reps)
    print(f"{doc['card']}, {doc['power_limit']}")
    print(probe.report(doc))
    out = Path(args.out or f"chiprun_out/{args.name}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1))
    print(f"wrote {out}")
    return doc


if __name__ == "__main__":
    main()
