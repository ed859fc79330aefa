"""On the card: each cell through ``run.py`` for a short window, correct,
with every end-to-end metric of the cell, and with ``--trace 1`` every
per-layer metric.  Marked ``cuda``; they skip without a card (``card``
fixture)."""

import json
import subprocess
import sys

import pytest

from stereo_bench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(cell, trace):
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=spec.CHECKOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    result = run(cell, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    want = {m["name"] for m in spec.metrics_of(BENCH, cell, bool(trace))}
    assert set(result["metrics"]) == want
    if trace:
        dev = result["device"]
        assert 0 < dev["busy_s"] <= dev["window_s"] * 1.01
        assert len(result["breakdown"]["device_ops"]) <= 10
        roof = [v["value"] for n, v in result["metrics"].items()
                if n.split(".")[0] == "k2_roofline"]
        assert len(roof) == 1 and 0 < roof[0] <= 100
