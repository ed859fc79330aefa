"""The large geometries of ``BASELINE.json`` on the card — the port's
counterpart of ``scripts/big_config_bench.py``.

    python -m soc_project_stereo_matching_tpu_torch.benches big_configs \
        [--cell NAME] [--input synthetic|cone] \
        [--device cuda|cpu] [--out chiprun_out/big_configs.json]

The four cells of the JAX script (``CELLS``, the same table): KITTI-2012 at
full resolution (1242x375, disparities [24, 152), B=4), the KITTI-2015
geometry (1242x375, D=192, B=4) and Middlebury-2014 at half resolution
(1500x1000, D=256, B=1), untiled and through the tiled engine
(``EngineConfig(tile_mode="exact")`` on ``make_mesh(1, 1)``), whose output
must equal the untiled engine's bit for bit.  Each cell is
``benches.engine_cell``: the first batch apart (``first_batch_ms``, in place
of the JAX script's compile and first-dispatch seconds: there is no XLA
compile), the finite share and at least 0.95 of the finite pixels within 1
of the synthetic pair's true disparity, then the window and one call at a
time, 5 times over; ``ms_per_frame`` and ``fps_per_chip`` come from the
windows' median, ``fps_all_windows`` from all their frames over all their
time.  A cell that fails is recorded with its error and the
run goes on, but the run then exits 1 (the JAX script exits 0).

``--device cpu`` runs each cell cut by ``CPU_DIVISOR`` in every dimension
(B at most 2), untimed, for the tests.
"""

from __future__ import annotations

import torch

from .. import EngineConfig, SGMEngine, SGMOptions
from ..parallel.mesh import make_mesh
from . import (SOURCES, device_pair, document, engine_cell, fmt, log,
               out_path, resolve_device, write)

# (name, width, height, max_disparity, keywords),
# scripts/big_config_bench.py:119-123
CELLS = (
    ("kitti2012-fullres", 1242, 375, 152, dict(batch=4, dmin=24)),
    ("kitti2015-geometry", 1242, 375, 192, dict(batch=4)),
    ("middlebury2014-half", 1500, 1000, 256, dict(batch=1, iters=3)),
    ("middlebury2014-half-tiled", 1500, 1000, 256,
     dict(batch=1, iters=3, tiled=True)),
)
CPU_DIVISOR = 12


def cpu_cut(cell: tuple) -> tuple:
    """A cell cut by ``CPU_DIVISOR`` in width, height and disparities, B at
    most 2, one iteration."""
    name, w, h, d, kw = cell
    k = CPU_DIVISOR
    kw = dict(kw, batch=min(kw.get("batch", 1), 2), iters=1,
              dmin=kw.get("dmin", 0) // k)
    return name, w // k, h // k, d // k, kw


def run_config(name, w, h, d, batch, iters=4, tiled=False, dmin=0, *,
               device=None, source="synthetic", reference=None):
    """One cell; returns (record, the first batch's disparity).  A tiled
    cell is held bit-equal to ``reference`` (the untiled engine's output on
    the same inputs), which it computes with one untiled call when none is
    given ("reference_calls")."""
    device = resolve_device(device)
    opts = SGMOptions(min_disparity=dmin, max_disparity=d)
    left, right, field = device_pair(device, batch, h, w, dmin, d, source)
    if tiled:
        engine = SGMEngine(opts, EngineConfig(tile_mode="exact"), device=device,
                           mesh=make_mesh(1, 1))
    else:
        engine = SGMEngine(opts, device=device)
    rec = {"config": name, "width": w, "height": h, "max_disparity": d,
           "min_disparity": dmin, "batch": batch, "tiled": tiled}
    cell, out = engine_cell(engine, left, right, field, iters, name)
    rec.update(cell)
    if tiled:
        rec["reference_calls"] = 0
        if reference is None:
            reference = SGMEngine(opts, device=device).match_batch(left, right)
            rec["reference_calls"] = 1
        if not torch.equal(out, reference):
            raise AssertionError(f"{name}: the tiled engine's output differs "
                                 "from the untiled engine's")
        rec["bit_equal_untiled"] = True
    log(f"{name}: {fmt(rec['ms_per_frame'])} ms/frame "
        f"({fmt(rec['fps_per_chip'])} frames/s, "
        f"{fmt(rec['fps_all_windows'])} over all windows), first batch "
        f"{fmt(rec['first_batch_ms'])} ms, finite {rec['valid_frac']:.4f}, "
        f"within 1 of the truth {fmt(rec['good_frac'])}, tiled={tiled}")
    return rec, out


def run(device=None, cells=None, source="synthetic") -> dict:
    """The cells named in ``cells`` (all by default), each in turn; a
    failing cell's record is {"config", "error"}.  The tiled cell takes the
    untiled cell's output as its reference when that cell ran first."""
    device = resolve_device(device)
    table = CELLS if device.type == "cuda" else tuple(map(cpu_cut, CELLS))
    names = [c[0] for c in CELLS]
    unknown = set(cells or ()) - set(names)
    if unknown:
        raise ValueError(f"unknown cells {sorted(unknown)}: expected {names}")
    results, outputs = [], {}
    for name, w, h, d, kw in table:
        if cells and name not in cells:
            continue
        ref = outputs.get(name.removesuffix("-tiled")) if kw.get("tiled") \
            else None
        try:
            rec, outputs[name] = run_config(name, w, h, d, **kw, device=device,
                                            source=source, reference=ref)
        except Exception as e:
            log(f"{name} FAILED: {type(e).__name__}: {e}")
            rec = {"config": name, "error": f"{type(e).__name__}: {e}"}
        results.append(rec)
    return document("big_configs", device, input=source, results=results)


def arguments(ap) -> None:
    ap.add_argument("--cell", action="append", choices=[c[0] for c in CELLS],
                    help="run this cell (may be repeated); default: all four")
    ap.add_argument("--input", choices=SOURCES, default="synthetic")


def main(args) -> int:
    path = out_path("big_configs", args.out)
    doc = run(args.device, args.cell, args.input)
    write(doc, path)
    log(f"wrote {path}")
    failed = [r["config"] for r in doc["results"] if "error" in r]
    if failed:
        log(f"big_configs: failed cells {failed}")
    return 1 if failed else 0
