"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 stereo_bench/run.py --workload kitti2015.stream --seed 7 \
        --seconds 20 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` window.  The run needs as
many CUDA devices as the cell asks for, and the port's package beside this
directory; without either it exits non-zero and prints no result, as it
does when JAX or the JAX package has been loaded by the time the window
closes.
"""

import time

T0 = time.perf_counter()    # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))

from stereo_bench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import soc_project_stereo_matching_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"the port is not in this checkout: {err}", file=sys.stderr)
        return 3
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=T0)
    loaded = spec.forbidden_loaded(sys.modules)
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
