"""``python -m soc_project_stereo_matching_tpu_torch.benches <name>``: run one
bench and write its JSON to ``chiprun_out/<name>.json``; the exit code is 0
after a run whose every part passed."""

from __future__ import annotations

import argparse
import sys

from . import big_configs, loopback, scaling, streaming

BENCHES = {"big_configs": big_configs, "streaming": streaming,
           "loopback": loopback, "scaling": scaling}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m soc_project_stereo_matching_tpu_torch.benches",
        description="Run one bench of the port.")
    sub = ap.add_subparsers(dest="name", required=True)
    for name, bench in BENCHES.items():
        p = sub.add_parser(name, description=bench.__doc__.split("\n\n")[0])
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="cuda (the default) needs a card and fails "
                            "without one; cpu runs the plain ops untimed")
        p.add_argument("--out", default=None,
                       help=f"default: chiprun_out/{name}.json")
        if hasattr(bench, "arguments"):     # the bench's own options
            bench.arguments(p)
    args = ap.parse_args(argv)
    return BENCHES[args.name].main(args)


if __name__ == "__main__":
    sys.exit(main())
