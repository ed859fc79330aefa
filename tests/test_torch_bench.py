"""The port's headline bench (``soc_project_stereo_matching_tpu_torch.bench``)
against the JAX package's root ``bench.py`` and engine, on the CPU.

The stdout line is ``bench.py``'s contract: the port's ``emit`` must print
the same line for a value and for a failure.  ``--device cpu`` runs the
bench's path on a small cell with the plain ops and reports no time; its
disparity must equal the JAX ``SGMEngine`` (jnp path) on the same seeded
numpy pair, bit for bit.  A failure prints one line with ``value: null``
and exits 1 (the JAX tool exits 0); without a card the default device
fails.  The bench's timers run only on a card (``chip_smoke.py`` phase 9).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import EngineConfig as JConfig
from soc_project_stereo_matching_tpu import SGMOptions as JOptions
from soc_project_stereo_matching_tpu.models.sgm import SGMEngine as JEngine
from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions
from soc_project_stereo_matching_tpu_torch import bench, benches

REPO = Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline"}
SMALL = ["--device", "cpu"]


@pytest.fixture()
def root_bench():
    """The JAX package's root ``bench.py`` (numpy only at import)."""
    sys.modules.pop("bench", None)
    sys.path.insert(0, str(REPO))
    try:
        import bench as mod
        yield mod
    finally:
        sys.path.remove(str(REPO))
        sys.modules.pop("bench", None)


def lines(capsys) -> list:
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("value, error", [
    (2266.2577, None), (0.004, None), (1.4, None),
    (None, "RuntimeError: no CUDA device")])
def test_emit_prints_the_root_bench_line(root_bench, capsys, value, error):
    root_bench.emit(value, error=error)
    want = lines(capsys)
    bench.emit(value, error=error)
    got = lines(capsys)
    assert got == want and len(got) == 1
    assert set(json.loads(got[0])) == KEYS | ({"error"} if error else set())


def test_cpu_run_prints_one_null_line_and_exits_zero(tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert bench.main(SMALL + ["--out", str(out)]) == 0
    (line,) = lines(capsys)
    rec = json.loads(line)
    assert set(rec) == KEYS | {"error"}
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert "CPU gives no device time" in rec["error"]
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["card"] is None
    for key in ("fps", "build_s", "first_batch_ms", "window_ms",
                "window_enqueue_ms", "call_ms", "enqueue_ms", "ms_per_frame",
                "aggregation"):
        assert doc[key] is None, key
    cell = bench.CPU_CELL
    assert (doc["batch"], doc["h"], doc["w"], doc["dmax"]) == (
        cell["batch"], cell["h"], cell["w"], cell["dmax"])
    assert doc["good_frac"] >= benches.MIN_GOOD
    assert doc["engine_calls"] == 2


def test_cpu_default_cell_is_small():
    doc, out = bench.run("cpu")
    cell = bench.CPU_CELL
    assert tuple(out.shape) == (cell["batch"], cell["h"], cell["w"])
    assert doc["dmax"] == cell["dmax"] and doc["iters"] == cell["iters"]
    assert bench.CELL == dict(batch=32, iters=10, h=375, w=450, dmax=64)


@pytest.mark.parametrize("run", [
    lambda out: bench.main(SMALL + ["--input", "cone", "--out", out]),
    lambda out: bench.report("cpu", dmax=0, out=out),   # an empty range
], ids=["cone-absent", "empty-range"])
def test_a_failure_prints_one_line_and_exits_one(tmp_path, capsys, run,
                                                 monkeypatch):
    monkeypatch.setattr(benches, "reference_data_pairs", lambda: [])
    assert run(str(tmp_path / "b.json")) == 1
    (line,) = lines(capsys)
    rec = json.loads(line)
    assert rec["value"] is None and rec["vs_baseline"] is None and rec["error"]
    assert not (tmp_path / "b.json").exists()


def test_a_forced_failure_in_the_measurement(tmp_path, capsys, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("forced")
    monkeypatch.setattr(bench, "engine_cell", boom)
    assert bench.main(SMALL + ["--out", str(tmp_path / "b.json")]) == 1
    (line,) = lines(capsys)
    assert json.loads(line)["error"] == "RuntimeError: forced"


def test_an_interrupt_still_prints_its_line_and_propagates(tmp_path, capsys,
                                                           monkeypatch):
    def stop(*args, **kwargs):
        raise KeyboardInterrupt
    monkeypatch.setattr(bench, "engine_cell", stop)
    with pytest.raises(KeyboardInterrupt):
        bench.main(SMALL + ["--out", str(tmp_path / "b.json")])
    (line,) = lines(capsys)
    assert json.loads(line)["error"].startswith("KeyboardInterrupt")


def test_the_default_device_fails_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA device"):
        benches.resolve_device(None)
    assert bench.main(["--out", str(tmp_path / "b.json")]) == 1
    (line,) = lines(capsys)
    assert "CUDA device" in json.loads(line)["error"]


@pytest.mark.parametrize("batch, h, w, dmax", [(2, 32, 64, 16),
                                              (1, 40, 96, 64)])
def test_bench_disparity_equals_the_jax_engine(batch, h, w, dmax):
    """The bench's path on the CPU (the plain ops) against the JAX engine's
    jnp path on the same seeded numpy pair, bit for bit."""
    _, got = bench.run("cpu", batch=batch, h=h, w=w, dmax=dmax)
    left, right, _ = benches.host_pair(batch, h, w, 0, dmax)
    want = JEngine(JOptions(max_disparity=dmax), JConfig(use_pallas=False)) \
        .match_batch(left, right)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dmin, dmax", [(0, 16), (0, 64), (24, 152), (0, 192),
                                        (0, 256), (2, 12)])
def test_levels_lie_strictly_inside_the_range(dmin, dmax):
    levels = benches.levels(dmin, dmax)
    assert all(dmin < lv < dmax for lv in levels)
    assert len(set(levels)) == len(levels)


def test_the_output_path_is_never_results(tmp_path):
    assert benches.out_path("bench") == Path("chiprun_out/bench.json")
    assert benches.out_path("bench", tmp_path / "x.json") == tmp_path / "x.json"
    with pytest.raises(ValueError, match="results/"):
        benches.out_path("bench", REPO / "results" / "bench.json")


def test_percentiles_and_spread():
    xs = [float(x) for x in range(1, 101)]
    p = benches.percentiles(xs)
    assert (p["median"], p["n"], p["min"], p["max"]) == (50.5, 100, 1.0, 100.0)
    assert p["p95"] == pytest.approx(95.05) and p["p99"] == pytest.approx(99.01)
    s = benches.spread([14.2, 14.1, 14.3, 14.25, 14.15])
    assert s["median"] == 14.2 and s["max_over_min"] == pytest.approx(14.3 / 14.1)
    assert s["runs"] == [14.2, 14.1, 14.3, 14.25, 14.15]


@pytest.mark.parametrize("flag", ["--batch", "--iters", "--w", "--dmax"])
def test_the_command_line_runs_only_the_cell(flag, capsys):
    """The geometry is ``run``'s and ``report``'s keyword, not a flag."""
    with pytest.raises(SystemExit) as e:
        bench.main(SMALL + [flag, "2"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_report_writes_the_cells_document(tmp_path, capsys):
    out = tmp_path / "b.json"
    assert bench.report("cpu", batch=1, h=24, w=48, dmax=16, out=out) == 0
    (line,) = lines(capsys)
    assert json.loads(line)["value"] is None
    doc = json.loads(out.read_text())
    assert (doc["batch"], doc["h"], doc["w"], doc["dmax"]) == (1, 24, 48, 16)


@pytest.mark.parametrize("runs", [[14.2, 14.1, 14.3, 14.25, 14.15],
                                  [14.2, 14.2, 14.2, 14.2, 42.0]])
def test_engine_cell_rates_from_the_windows(monkeypatch, runs):
    """``fps_per_chip`` is the windows' median rate; ``fps_all_windows``,
    all their frames over all their time, moves with a stall in one."""
    timing = {"window_ms": benches.spread(runs), "window_enqueue_ms": None,
              "call_ms": None, "enqueue_ms": None, "iters": 10,
              "repeats": len(runs), "calls": 2 * 10 * len(runs)}
    monkeypatch.setattr(benches, "measure", lambda *a, **k: dict(timing))
    left, right, field = benches.device_pair("cpu", 4, 24, 48, 0, 16)
    engine = SGMEngine(SGMOptions(max_disparity=16), device="cpu")
    rec, _ = benches.engine_cell(engine, left, right, field, 10, "t")
    assert rec["fps_per_chip"] == pytest.approx(4e3 / np.median(runs))
    assert rec["fps_all_windows"] == pytest.approx(
        4 * 10 * len(runs) * 1e3 / (10 * sum(runs)))
    assert rec["engine_calls"] == 1 + 2 * 10 * len(runs)
