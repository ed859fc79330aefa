"""The frozen reference against the port's plain pipeline, bit for bit, at
small shapes on the CPU; the control (the reference with its float stage
in bfloat16) coming out not correct; and a configuration's ``reference``
found by name, with what it cannot follow refused before any run."""

import dataclasses
import textwrap

import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions
from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
from stereo_bench import check, control, harness, spec, traffic
from stereo_bench.reference import sgm as reference

SHAPES = [  # (batch, H, W, options)
    (2, 24, 48, dict(max_disparity=16, min_speckle_area=6)),
    (1, 30, 40, dict(min_disparity=3, max_disparity=19, min_speckle_area=6)),
    (2, 20, 36, dict(max_disparity=12, num_paths=4, min_speckle_area=6)),
    (1, 16, 70, dict(max_disparity=40, min_speckle_area=8, p1=7, p2_init=99)),
    (3, 12, 30, dict(max_disparity=8, is_check_lr=False, min_speckle_area=4)),
    (1, 18, 33, dict(max_disparity=10, is_remove_speckles=False,
                     is_check_unique=False)),
]


def pair(seed, b, h, w, opt):
    left, right, _ = traffic.synthetic_pair(
        seed, b, h, w, traffic.levels(opt.min_disparity, opt.max_disparity))
    return torch.from_numpy(left), torch.from_numpy(right)


def bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("b,h,w,kw", SHAPES)
def test_reference_is_the_ports_plain_pipeline_bit_for_bit(b, h, w, kw, seed):
    opt = SGMOptions(**kw)
    left, right = pair(seed, b, h, w, opt)
    want = sgm_forward(left, right, opt, use_kernels=False)
    got = reference.sgm(left, right, dataclasses.asdict(opt))
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("b,h,w,kw", [SHAPES[0], SHAPES[1], SHAPES[3]])
def test_reference_in_restart_mode_is_the_ports_bit_for_bit(b, h, w, kw):
    opt = SGMOptions(**kw)
    left, right = pair(5, b, h, w, opt)
    want = sgm_forward(left, right, opt, "restart", use_kernels=False)
    got = reference.sgm(left, right, dataclasses.asdict(opt),
                        diagonal_mode="restart")
    assert torch.equal(bits(got), bits(want))
    wrap = reference.sgm(left, right, dataclasses.asdict(opt))
    assert not torch.equal(bits(got), bits(wrap))


def test_a_configuration_the_reference_cannot_follow_is_refused():
    options = dataclasses.asdict(SGMOptions())
    check.checkable({"engine": {"diagonal_mode": "restart"}, "options": options})
    check.checkable({"engine": {"tile_mode": "exact"}, "options": options})
    for engine in ({"tile_mode": "local"}, {"diagonal_mode": "mirror"}):
        with pytest.raises(ValueError):
            check.checkable({"engine": engine, "options": options})


def test_blocks_of_rows_and_frames_change_nothing(monkeypatch):
    opt = SGMOptions(max_disparity=16, min_speckle_area=6)
    left, right = pair(3, 3, 24, 48, opt)
    whole = reference.sgm(left, right, dataclasses.asdict(opt))
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 48 * 16 * 3 * 5)
    monkeypatch.setattr(reference, "FRAME_ELEMENTS", 24 * 48 * 16)
    blocked = reference.sgm(left, right, dataclasses.asdict(opt))
    assert torch.equal(bits(whole), bits(blocked))


def test_the_control_differs_and_is_not_correct():
    opt = SGMOptions(max_disparity=16, min_speckle_area=6)
    left, right = pair(11, 2, 24, 64, opt)
    o = dataclasses.asdict(opt)
    ref, ctl = reference.sgm_in(left, right, o, [torch.float32, torch.bfloat16])
    verdict = check.compare([(0, ctl.numpy())], {0: ref.numpy()}, 2)
    assert not verdict["correct"]
    assert verdict["numbers"]["pixels_differing"][0] > 0
    sound = check.compare([(0, ref.numpy().copy())], {0: ref.numpy()}, 2)
    assert sound["correct"] and sound["failed"] == 0


def test_control_readings_at_a_small_size():
    config = {"height": 24, "width": 64, "engine": {"diagonal_mode": "wrap"},
              "options": dataclasses.asdict(SGMOptions(max_disparity=16,
                                                       min_speckle_area=6))}
    rows = control.readings("kitti2015.batch8", [5, 2 ** 40 + 1], device="cpu",
                            config=config,
                            traffic={"feed": "resident", "batch": 2, "pool": 2})
    for row in rows:
        assert row["program"]["pixels_differing"][0] == 0
        assert row["control"]["pixels_differing"][0] > 0
        assert row["frames"] == 4


def test_inf_compares_equal_and_a_flipped_bit_does_not():
    a = np.array([[[1.5, np.inf]]], dtype=np.float32)
    assert check.compare([(0, a.copy())], {0: a}, 1)["correct"]
    b = a.copy()
    b[0, 0, 0] = np.nextafter(np.float32(1.5), np.float32(2))
    v = check.compare([(0, b)], {0: a}, 1)
    assert not v["correct"] and v["failed"] == 1
    assert not check.compare([], {0: a}, 0)["correct"]   # nothing checked


def test_frames_checked_counts_each_pool_entry_once():
    a = np.zeros((2, 1, 3), dtype=np.float32)
    expected = {0: a, 1: a + 1}
    twice = check.compare([(0, a), (0, a.copy())], expected, 4)
    assert twice["numbers"]["frames_checked"][0] == 2
    assert not twice["correct"]
    both = check.compare([(0, a), (0, a), (1, a + 1)], expected, 4)
    assert both["numbers"]["frames_checked"][0] == 4 and both["correct"]


SMALL = {"height": 24, "width": 64, "engine": {"diagonal_mode": "wrap"},
         "options": dataclasses.asdict(SGMOptions(max_disparity=16,
                                                  min_speckle_area=6))}
SMALL_TRAFFIC = {"feed": "resident", "batch": 2, "pool": 2, "keep": 1}


def small_config(**kw):
    config = dict(SMALL, **kw)
    config["options"] = dict(SMALL["options"], **kw.pop("options", {}))
    return config


@pytest.mark.parametrize("mode", ["wrap", "restart"])
def test_no_reference_key_is_the_frozen_sgm(mode):
    lefts, rights, _ = traffic.pool(17, SMALL, SMALL_TRAFFIC)
    engine = {"diagonal_mode": mode}
    plain = small_config(engine=engine)
    named = small_config(engine=engine, reference="sgm")
    got = check.reference_outputs(lefts, rights, [0, 1], plain, "cpu")[0]
    want = check.reference_outputs(lefts, rights, [0, 1], named, "cpu")[0]
    direct = reference.sgm(torch.from_numpy(lefts[1]),
                           torch.from_numpy(rights[1]), plain["options"],
                           diagonal_mode=mode)
    for k in (0, 1):
        assert np.array_equal(got[k].view(np.int32), want[k].view(np.int32))
    assert np.array_equal(got[1].view(np.int32), direct.numpy().view(np.int32))


# a reference of its own: the frozen one's result plus one, and options
# that the frozen one refuses (the in-place median) followed, p1 = 99 not
SHIFTED = """
from stereo_bench.reference import sgm as frozen

DIAGONAL_MODES = ("wrap",)


def _check_options(options):
    if options["p1"] == 99:
        raise ValueError("p1 99")


def sgm_in(left, right, options, float_dtypes, diagonal_mode="wrap"):
    options = dict(options, median_inplace=False)
    return [d + 1 for d in frozen.sgm_in(left, right, options, float_dtypes,
                                         diagonal_mode)]
"""


@pytest.fixture
def shifted(tmp_path, monkeypatch):
    (tmp_path / "shifted.py").write_text(textwrap.dedent(SHIFTED))
    monkeypatch.setattr(spec, "REFERENCE_DIR", tmp_path)
    return small_config(reference="shifted", options={"median_inplace": True})


def test_a_named_reference_is_the_one_check_run_cell_and_control_call(shifted):
    check.checkable(shifted)            # the frozen sgm refuses it
    with pytest.raises(ValueError, match="p1 99"):
        check.checkable(dict(shifted, options=dict(shifted["options"], p1=99)))
    with pytest.raises(ValueError):
        check.checkable(dict(shifted, engine={"diagonal_mode": "restart"}))
    lefts, rights, _ = traffic.pool(3, shifted, SMALL_TRAFFIC)
    got = check.reference_outputs(lefts, rights, [0], shifted, "cpu")[0][0]
    frozen = reference.sgm(torch.from_numpy(lefts[0]),
                           torch.from_numpy(rights[0]), SMALL["options"])
    assert np.array_equal(got, frozen.numpy() + 1)
    bench = spec.load_benchmark()
    result = harness.run_cell(bench, "kitti2015.batch8", 23, 0.2, False,
                              device="cpu", config=shifted,
                              traffic=SMALL_TRAFFIC)
    assert result["correct"] is False
    assert result["checks"]["pixels_differing"]["value"] > 0
    row, = control.readings("kitti2015.batch8", [23], device="cpu",
                            config=shifted, traffic=SMALL_TRAFFIC)
    assert row["program"]["pixels_differing"][0] > 0


def refused_before_any_call(config, monkeypatch, match):
    calls = []
    monkeypatch.setattr(SGMEngine, "match_batch",
                        lambda *a: calls.append(a))
    with pytest.raises(ValueError, match=match):
        check.checkable(config)
    with pytest.raises(ValueError, match=match):
        harness.run_cell(spec.load_benchmark(), "kitti2015.batch8", 5, 0.2,
                         False, device="cpu", config=config,
                         traffic=SMALL_TRAFFIC)
    with pytest.raises(ValueError, match=match):
        control.readings("kitti2015.batch8", [5], device="cpu", config=config,
                         traffic=SMALL_TRAFFIC)
    assert calls == []


def test_an_unknown_reference_is_refused_before_any_run(monkeypatch):
    for name in ("nope", "../reference/sgm"):
        refused_before_any_call(small_config(reference=name), monkeypatch,
                                "no reference")


def test_the_in_place_median_against_sgm_is_refused_before_the_window(
        monkeypatch):
    for config in (small_config(options={"median_inplace": True}),
                   small_config(options={"median_inplace": True},
                                reference="sgm")):
        refused_before_any_call(config, monkeypatch, "out-of-place median")
