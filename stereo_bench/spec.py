"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, and under this directory the configuration files, the traffic files,
the feeds that drive them, the references that decide ``correct``, the
metric readers and the layers' kernel-name patterns.  A later cell, feed,
reference, metric or layer is a file added here; nothing in this module
lists them."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
TRAFFIC_DIR = HERE / "traffic"
FEEDS_DIR = HERE / "feeds"
REFERENCE_DIR = HERE / "reference"
METRICS_DIR = HERE / "metrics"
LAYERS_DIR = HERE / "layers"
# the reference of a configuration file without a "reference" key
DEFAULT_REFERENCE = "sgm"
# top-level module names that no run of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "soc_project_stereo_matching_tpu")


def load_benchmark(root: Path = CHECKOUT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = CHECKOUT) -> dict:
    """The configuration file of the configuration ``name``."""
    entry = _by_name(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` false, its per-layer metrics with it true; a metric with a
    ``workloads`` list belongs to the cells it names only."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _module(directory: Path, name: str) -> ModuleType:
    """``<directory>/<name>.py`` as a module (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"stereo_bench.{directory.name}." + re.sub(r"\W", "_", name),
        directory / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def feed(name: str) -> ModuleType:
    """``feeds/<name>.py``: ``inputs``, ``call`` and ``window`` of a
    traffic file's ``feed``."""
    return _module(FEEDS_DIR, name)


def reference(name: str) -> ModuleType:
    """``reference/<name>.py``, a configuration's ``reference``: its
    ``DIAGONAL_MODES``, ``_check_options(options)``, which raises on
    options it cannot follow, and ``sgm_in(left, right, options,
    float_dtypes, diagonal_mode)``."""
    if "/" in name or not (REFERENCE_DIR / f"{name}.py").is_file():
        raise ValueError(f"no reference {name!r} in {REFERENCE_DIR}")
    return _module(REFERENCE_DIR, name)


def reader(name: str) -> Callable:
    """``read(record)`` of ``metrics/<name>.py``.  A metric split by the
    cells it serves, ``<quantity>.<cells>`` (``k2_ms_per_frame.stream``),
    without a file of its own is read by ``<quantity>``'s."""
    while not (METRICS_DIR / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    return _module(METRICS_DIR, name).read


def layer_patterns() -> Dict[str, List[re.Pattern]]:
    """{layer: compiled patterns} from ``layers/<layer>/*.txt``: one
    regular expression a line, searched in a device operation's name;
    blank lines and lines starting with ``#`` are skipped."""
    out: Dict[str, List[re.Pattern]] = {}
    for layer in sorted(p for p in LAYERS_DIR.iterdir() if p.is_dir()):
        pats = []
        for f in sorted(layer.glob("*.txt")):
            for line in f.read_text().splitlines():
                if line.strip() and not line.startswith("#"):
                    pats.append(re.compile(line.strip()))
        out[layer.name] = pats
    return out


def forbidden_loaded(modules) -> List[str]:
    """The names in ``modules`` (``sys.modules``) whose top-level name is
    one of ``FORBIDDEN``, compared whole: the port's own name begins with
    the JAX package's and is allowed."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
