"""The readings that the limits of ``check.py`` were set from, at a cell's
own size on the card.  The benchmark's runs do not run this.

    python3 stereo_bench/control.py --workload kitti2015.stream \
        --seeds 11 12 13 [--out build/stereo_bench/control.json]

For each seed it makes the cell's pool of inputs, as a run does, and
compares with the configuration's reference (``check.reference_of``;
float32, the configuration's precision), every frame of the pool, by
``check.compare``:

* the program: each pool entry through ``SGMEngine.match_batch`` once, on
  the path and at the batch the window drives;
* the control: that reference itself with the disparity's float stage in
  bfloat16, the next precision below the configuration's float32, put in
  the program's place.  It must come out not correct.

Prints one line a seed and writes the readings as JSON to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))

import torch  # noqa: E402

from stereo_bench import check, spec, traffic as traffic_gen  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def program_outputs(engine, feed, lefts, rights, device) -> dict:
    """{pool index: float32 numpy (B, H, W)} of one call each, as the
    cell's feed makes it."""
    feed_l, feed_r = feed.inputs(lefts, rights, device)
    out = {}
    for k in range(len(lefts)):
        disp = feed.call(engine, feed_l[k], feed_r[k])
        out[k] = disp.cpu().numpy() if isinstance(disp, torch.Tensor) else disp
    return out


def readings(cell_name: str, seeds, device: str = "cuda", config=None,
             traffic=None) -> list:
    """[{"seed", "frames", "program": numbers, "control": numbers,
    "seconds"}] for each seed; ``config`` and ``traffic`` default to the
    cell's files."""
    from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                       SGMOptions)

    bench = spec.load_benchmark()
    cell = spec.workload(bench, cell_name)
    config = config or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    check.checkable(config)
    feed = spec.feed(traffic["feed"])
    engine = SGMEngine(SGMOptions(**config["options"]),
                       EngineConfig(**config["engine"]), device=device)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        lefts, rights, _ = traffic_gen.pool(seed, config, traffic)
        frames = lefts.shape[0] * lefts.shape[1]
        got = program_outputs(engine, feed, lefts, rights, device)
        keys = list(range(len(lefts)))
        ref, ctl = check.reference_outputs(lefts, rights, keys, config, device,
                                           (torch.float32, CONTROL_DTYPE))
        as_items = lambda outs: [(k, outs[k]) for k in keys]
        rows.append({
            "seed": seed, "frames": frames,
            "program": check.compare(as_items(got), ref, frames)["numbers"],
            "control": check.compare(as_items(ctl), ref, frames)["numbers"],
            "seconds": time.perf_counter() - t0})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="build/stereo_bench/control.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    rows = readings(args.workload, args.seeds)
    name = torch.cuda.get_device_name(0)
    for r in rows:
        p, c = r["program"], r["control"]
        print(f"{args.workload} seed {r['seed']} ({name}): {r['frames']} frames; "
              f"program pixels_differing {p['pixels_differing'][0]}, control "
              f"({CONTROL_DTYPE}) pixels_differing {c['pixels_differing'][0]}; "
              f"{r['seconds']:.3f} s", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    prior = json.loads(out.read_text()) if out.exists() else {}
    prior[args.workload] = {"card": name, "readings": rows}
    out.write_text(json.dumps(prior, indent=1, default=str))
    lowest = min(r["control"]["pixels_differing"][0] for r in rows)
    return 0 if lowest > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
