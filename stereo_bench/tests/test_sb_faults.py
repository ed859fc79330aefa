"""A whole run on the CPU, with the look for a card skipped (the harness
runs the port's plain path on ``device="cpu"``) at the cell's own pool:
sound, it is correct; with the timed path broken underneath, ``correct``
comes out false, once for each fault a cell can have (one card: no
exchange between cards to leave out).  The sample keeps outputs of every
pool entry at the calls a window makes on the card, so the check compares
every distinct frame on every seed.  And ``run.py`` without a card exits
non-zero and prints nothing."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu_torch import SGMEngine
from stereo_bench import check, drive, harness, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(cell):
    w = spec.workload(BENCH, cell)
    config = spec.config(BENCH, w["config"])
    config = dict(config, height=24, width=64,
                  options=dict(config["options"], max_disparity=16,
                               min_speckle_area=6))
    traffic = spec.traffic(w["traffic"])
    traffic = dict(traffic, batch=min(traffic["batch"], 2))
    return config, traffic


def run(cell, seconds=1.0):
    config, traffic = small(cell)
    return harness.run_cell(BENCH, cell, 2 ** 33 + 5, seconds, False,
                            device="cpu", config=config, traffic=traffic)


def break_path(monkeypatch, fault):
    """Replace ``SGMEngine.match_batch`` by ``fault(sound, self, l, r)``."""
    sound = SGMEngine.match_batch
    monkeypatch.setattr(SGMEngine, "match_batch",
                        lambda self, l, r: fault(sound, self, l, r))


def altered_answer(sound, self, left, right):
    out = sound(self, left, right).clone()
    out[..., 12, 30] = out[..., 12, 30] + 1.0       # one pixel of each frame
    return out


def half_the_batch(sound, self, left, right):
    n = max(1, left.shape[0] // 2)
    out = sound(self, left[:n], right[:n])
    return torch.cat([out, out[:left.shape[0] - n]])


class Stale:
    """Returns the first answer it ever gave: state left unchanged."""

    def __init__(self):
        self.first = None

    def __call__(self, sound, self_, left, right):
        if self.first is None:
            self.first = sound(self_, left, right)
        return self.first.clone()


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert result["checks"]["pixels_differing"] == \
        {"value": 0, "limit": 0, "rule": "<="}
    # every end-to-end metric of the cell, a rate among them (the stream's
    # is its own, fps.stream)
    assert set(result["metrics"]) == \
        {m["name"] for m in spec.metrics_of(BENCH, cell, False)}
    assert len({"fps", "fps.stream"} & set(result["metrics"])) == 1


# half of the batch can be left out only where a call takes several frames
FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("altered_answer", "half_the_batch", "stale")
          if fault != "half_the_batch" or small(cell)[1]["batch"] > 1]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    planted = {"altered_answer": altered_answer, "half_the_batch": half_the_batch,
               "stale": Stale()}[fault]
    break_path(monkeypatch, planted)
    result = run(cell)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert result["checks"]["pixels_differing"]["value"] > 0


# calls of one run on the card: a short window, Middlebury's 51 s (about
# 650), KITTI batch8's (about 1,800) and the stream's (about 3,600)
@pytest.mark.parametrize("calls", [2, 650, 1800, 3600])
@pytest.mark.parametrize("cell", CELLS)
def test_the_sample_checks_every_pool_entry_on_every_seed(cell, calls):
    traffic = spec.traffic(spec.workload(BENCH, cell)["traffic"])
    pool, keep = traffic["pool"], traffic["keep"]
    reached = min(pool, calls)
    expected = {k: np.full((1, 2, 2), k, np.float32) for k in range(pool)}
    for seed in range(2 ** 33, 2 ** 33 + 60):
        sound, stale = drive.Sample(pool, keep, seed), drive.Sample(pool, keep, seed)
        for n in range(calls):
            sound.offer(n % pool, expected[n % pool])
            stale.offer(n % pool, expected[0])      # the first answer, always
        assert {k for k, _ in sound.items} == set(range(reached))
        assert len(sound.items) == reached * min(keep, calls // pool or 1)
        verdict = check.compare(sound.items, expected, reached)
        assert verdict["correct"]
        assert verdict["numbers"]["frames_checked"][0] == reached
        assert not check.compare(stale.items, expected, reached)["correct"]


def test_run_without_a_card_exits_non_zero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.CHECKOUT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
