"""The port's benches (``soc_project_stereo_matching_tpu_torch.benches``)
against the JAX package's ``scripts/`` they stand for, on the CPU.

Each bench's ``device="cpu"`` run takes the same path as on the card at a
small size, checks what it checks there and reports every time as None.
Here: the big-config cells are the JAX script's table (read from its source,
since the tuple sits inside ``main()``) and the cut cells' disparities equal
the JAX engine's; the tiled cell equals the untiled one; the streaming
constants are the JAX script's and its three loops give the same
disparities; the loopback's frame counts are the frames served, and the
engine client's per-frame stats equal what the JAX package alone gives on
the frames the bench writes (its server's loading and scoring, its client's
grey conversion and depth, its engine on the jnp path); the scaling
bench on two gloo ranks gives rows for sizes 1 and 2, bit-equal to the
single-rank engine.  A failing part makes the run exit 1.
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import EngineConfig as JConfig
from soc_project_stereo_matching_tpu import SGMOptions as JOptions
from soc_project_stereo_matching_tpu.compat.client import (
    bgr_planes_to_gray as jax_gray)
from soc_project_stereo_matching_tpu.compat.server import (
    CompatServer as JServer)
from soc_project_stereo_matching_tpu.eval import metrics as JM
from soc_project_stereo_matching_tpu.models.sgm import SGMEngine as JEngine
from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions
from soc_project_stereo_matching_tpu_torch import benches
from soc_project_stereo_matching_tpu_torch.benches import (
    __main__ as benches_main, big_configs, loopback, scaling, streaming)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
RECORD_KEYS = {"config", "width", "height", "max_disparity", "min_disparity",
               "batch", "tiled", "ms_per_frame", "fps_per_chip", "valid_frac"}


def script_cells() -> list:
    """The cell tuple of ``scripts/big_config_bench.py``'s ``main()``, with
    each ``dict(...)`` call turned into a dict."""
    tree = ast.parse((SCRIPTS / "big_config_bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))

    def value(node):
        if isinstance(node, ast.Call) and node.func.id == "dict":
            return {k.arg: ast.literal_eval(k.value) for k in node.keywords}
        if isinstance(node, ast.Tuple):
            return tuple(value(e) for e in node.elts)
        return ast.literal_eval(node)

    return list(value(loop.iter))


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_big_config_cells_are_the_jax_scripts():
    assert list(big_configs.CELLS) == script_cells()
    assert [c[0] for c in big_configs.CELLS] == [
        "kitti2012-fullres", "kitti2015-geometry", "middlebury2014-half",
        "middlebury2014-half-tiled"]


@pytest.fixture(scope="module")
def big_doc():
    return big_configs.run("cpu")


def test_big_configs_cpu_run_checks_every_cell(big_doc):
    assert big_doc["device"] == "cpu" and big_doc["card"] is None
    results = big_doc["results"]
    assert [r["config"] for r in results] == [c[0] for c in big_configs.CELLS]
    for rec, cell in zip(results, map(big_configs.cpu_cut, big_configs.CELLS)):
        assert "error" not in rec, rec
        assert RECORD_KEYS <= set(rec)
        name, w, h, d, kw = cell
        assert (rec["width"], rec["height"], rec["max_disparity"]) == (w, h, d)
        assert rec["min_disparity"] == kw.get("dmin", 0)
        assert rec["good_frac"] >= benches.MIN_GOOD
        for key in ("ms_per_frame", "fps_per_chip", "first_batch_ms",
                    "window_ms", "call_ms", "enqueue_ms"):
            assert rec[key] is None, key
    assert results[-1]["tiled"] and results[-1]["bit_equal_untiled"]
    assert results[-1]["reference_calls"] == 0      # the untiled cell's output


@pytest.mark.parametrize("cell", big_configs.CELLS[:3], ids=lambda c: c[0])
def test_big_config_cut_cells_equal_the_jax_engine(cell):
    name, w, h, d, kw = big_configs.cpu_cut(cell)
    _, got = big_configs.run_config(name, w, h, d, **kw, device="cpu")
    dmin = kw.get("dmin", 0)
    left, right, _ = benches.host_pair(kw["batch"], h, w, dmin, d)
    want = JEngine(JOptions(min_disparity=dmin, max_disparity=d),
                   JConfig(use_pallas=False)).match_batch(left, right)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tiled_cell_equals_the_untiled_at_a_small_size():
    untiled, want = big_configs.run_config("m", 96, 40, 32, 2, device="cpu")
    tiled, got = big_configs.run_config("m-tiled", 96, 40, 32, 2, tiled=True,
                                        device="cpu")
    assert torch.equal(got, want) and tiled["bit_equal_untiled"]
    assert tiled["reference_calls"] == 1 and not untiled["tiled"]
    assert tiled["good_frac"] == untiled["good_frac"] >= benches.MIN_GOOD


def test_a_failing_cell_is_recorded_and_fails_the_run(tmp_path, monkeypatch):
    def fail(name, *args, **kwargs):
        if name == "kitti2015-geometry":
            raise RuntimeError("forced")
        return real(name, *args, **kwargs)

    real = big_configs.run_config
    monkeypatch.setattr(big_configs, "run_config", fail)
    out = tmp_path / "big.json"
    rc = benches_main.main(["big_configs", "--device", "cpu", "--cell",
                            "kitti2012-fullres", "--cell",
                            "kitti2015-geometry", "--out", str(out)])
    assert rc == 1
    results = json.loads(out.read_text())["results"]
    assert results[0]["config"] == "kitti2012-fullres" and "error" not in results[0]
    assert results[1] == {"config": "kitti2015-geometry",
                          "error": "RuntimeError: forced"}


def test_streaming_constants_are_the_jax_scripts():
    script = load_script("streaming_bench")
    assert (streaming.W, streaming.H, streaming.D) == (script.W, script.H,
                                                       script.D)
    assert (streaming.BATCH, streaming.N_BATCHES) == (script.BATCH,
                                                      script.N_BATCHES)


def test_streaming_loops_give_the_same_disparities():
    lefts0, rights0, _ = benches.host_pair(2, 24, 64, 0, 16)
    engine = SGMEngine(SGMOptions(max_disparity=16), device="cpu")
    times, outs = streaming.loops(engine, lefts0, rights0, 3)
    assert set(times.values()) == {None}
    assert len(outs["streaming"]) == len(outs["resident"]) == 3
    for i, (s, r) in enumerate(zip(outs["streaming"], outs["resident"])):
        assert torch.equal(s, r)
        want = engine.match_batch(streaming.fresh(lefts0, i), rights0)
        assert torch.equal(s, want)
    assert torch.equal(outs["device_only"], engine.match_batch(lefts0, rights0))
    # the stream's batches differ from each other in their top-left byte
    assert not np.array_equal(streaming.fresh(lefts0, 0), streaming.fresh(lefts0, 1))


def test_streaming_cpu_run(tmp_path):
    out = tmp_path / "s.json"
    rc = benches_main.main(["streaming", "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    n = streaming.CPU_SHAPE["batches"]
    assert rc == 0 and doc["config"]["batches"] == n
    assert doc["engine_calls"] == 1 + 2 * n + 1
    assert doc["fps_streaming"] is None and doc["attribution"] is None
    assert doc["good_frac"] >= benches.MIN_GOOD


def test_loopback_frames_and_stats_equal_the_engine_and_metrics(tmp_path):
    out = tmp_path / "loop.json"
    rc = benches_main.main(["loopback", "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0
    shape = loopback.CPU_SHAPE
    n, h, w, dmax = shape["frames"], shape["h"], shape["w"], shape["dmax"]
    assert doc["wire_frames"] == n * loopback.WIRE_REPEAT
    assert doc["engine_frames"] == n * loopback.ENGINE_REPEAT
    assert doc["wire_only_fps"] is None and doc["engine_fps"] is None
    assert [m["seq"] for m in doc["engine_measurements"]] == \
        list(range(n * loopback.ENGINE_REPEAT))
    # the same frames, written as the bench writes them, read and scored by
    # the JAX server; the JAX client's steps with the JAX engine (jnp path)
    dirs = loopback.write_frames(tmp_path / "frames",
                                 *loopback.frame_data(n, h, w, dmax), dmax)
    server = JServer(dirs, width=w, height=h, stats_dir=tmp_path / "stats")
    engine = JEngine(JOptions(max_disparity=dmax), JConfig(use_pallas=False))
    for m in doc["engine_measurements"]:
        pair = server._load(m["seq"] % n)
        left_bgr, right_bgr, calib = server._frame_for(pair)
        disp = np.asarray(engine.match(jax_gray(left_bgr), jax_gray(right_bgr)))
        denom = disp + np.float32(calib.doffs)
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(np.isfinite(disp) & (denom != 0),
                             np.float32(calib.fx0) * np.float32(calib.baseline)
                             / denom, np.nan).astype(np.float32)
        res = JM.compare_depth(server._ground_truth(pair), depth,
                               server.abs_thresh_mm)
        assert res.n_valid > 0
        assert (m["rmse_mm"], m["bpr"], m["n_valid"]) == (res.rmse, res.bpr,
                                                          res.n_valid)


def test_loopback_stats_wait_has_a_deadline(tmp_path):
    with pytest.raises(TimeoutError, match="no stats file"):
        loopback.collect_new_stats(tmp_path, set(), timeout_s=0.2)


@pytest.mark.parametrize("mode", ["data", "tile"])
def test_scaling_on_two_gloo_ranks(tmp_path, mode):
    out = tmp_path / "scaling.json"
    rc = benches_main.main(["scaling", "--device", "cpu", "--mode", mode,
                            "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["device"] == "cpu"
    rows = doc["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["mesh"] for r in rows] == (["1x1", "2x1"] if mode == "data"
                                         else ["1x1", "1x2"])
    assert all(r["bit_equal"] is True for r in rows)
    assert all(r["ms_per_step"] is None and r["scaling_eff"] is None
               for r in rows)
    assert doc["not_run"] == "sizes [4, 8]: not run: 2 ranks"


def test_scaling_arguments_are_the_jax_scripts():
    src = (SCRIPTS / "scaling_bench.py").read_text()
    for key, v in scaling.SHAPE.items():
        assert f'"--{key.replace("_", "-")}", type=int, default={v})' in src
    assert '"--iters", type=int, default=5)' in src


@pytest.mark.parametrize("name", sorted(benches_main.BENCHES))
def test_every_bench_fails_without_a_card_by_default(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA device"):
        benches_main.main([name, "--out", str(tmp_path / f"{name}.json")])
    assert not (tmp_path / f"{name}.json").exists()
