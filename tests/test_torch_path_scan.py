"""The horizontal pair's path scan (csrc/path_scan.cu) on the CPU.

The kernel runs only on a card (its sums are held bit for bit against the
plain two-order scan there, in tests/test_torch_cuda.py); here the lane
rule by D, the route's switch at D = 512 and the constants against the C
source; the wrappers' CPU route (the plain two-order scan); and the card
route, run on CPU tensors with the C entries recorded instead of called:
one launch a horizontal pair, counted as ``horizontal_paths``, the group
kernel's launches past D = 512 and where ``kernel_ab.forced_parts``
forces column parts.
"""

import re

import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu_torch import _build, kernel_ab
from soc_project_stereo_matching_tpu_torch.config import SGMOptions
from soc_project_stereo_matching_tpu_torch.ops import kernels

P1, P2_INIT = 10, 150
SOURCE = (_build.CSRC / "path_scan.cu").read_text()


def inputs(seed, b, s, d, h):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 128, (b, s, d, h), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (b, s, h), dtype=np.uint8)))


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.fixture
def no_launch():
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("d,lanes,words", [
    (1, 4, 1), (3, 4, 1), (4, 4, 1), (5, 4, 3), (12, 4, 3), (13, 4, 5),
    (20, 4, 5), (21, 4, 9), (36, 4, 9), (37, 4, 13), (52, 4, 13),
    (53, 4, 17), (64, 4, 17), (65, 8, 9), (72, 8, 9), (73, 8, 13),
    (128, 8, 17), (129, 16, 9), (192, 16, 13), (208, 16, 13),
    (209, 16, 17), (256, 16, 17), (257, 32, 9), (280, 32, 9), (288, 32, 9),
    (289, 32, 13), (416, 32, 13), (417, 32, 17), (512, 32, 17)])
def test_lanes_and_words_by_range(d, lanes, words):
    """4, 8, 16 or 32 lanes a pair of paths for D up to 64, 128, 256,
    512, and the least instantiated (odd) word count that covers D."""
    assert kernels.path_lanes(d) == (lanes, words)
    assert lanes * words >= d and words in kernels.PATHS_WORDS
    assert all(w * lanes < d for w in kernels.PATHS_WORDS if w < words)


@pytest.mark.parametrize("d", [0, 513, 1025, 16384])
def test_lane_rule_refuses_what_the_path_scan_does_not_take(d):
    with pytest.raises(ValueError):
        kernels.path_lanes(d)


def test_route_switches_at_1024():
    """The path scan up to D = 512 (the last range at which it beat the
    group kernel in turns on the card at both shapes tried), the group
    kernel past it, at 1,024 and past it, and where parts are forced (the
    tools' and tests' column parts)."""
    assert kernels.horizontal_route(1) == "paths"
    assert kernels.horizontal_route(512) == "paths"
    assert kernels.horizontal_route(513) == "group"
    assert kernels.horizontal_route(1024) == "group"
    assert kernels.horizontal_route(1025) == "group"
    assert kernels.horizontal_route(16384) == "group"
    assert kernels.horizontal_route(64, parts=2) == "group"


def test_constants_match_the_c_source():
    """The wrappers' constants and lane rule are csrc/path_scan.cu's."""
    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (0x[0-9A-Fa-f]+|\d+)u?;",
                             SOURCE).group(1), 0)

    assert const("kMaxRange") == kernels.PATHS_MAX_RANGE
    assert const("kPitch") == kernels.PATHS_PITCH == kernels.TRANSPOSED_PITCH
    words = re.search(r"for \(int w : \{([\d, ]+)\}\)", SOURCE).group(1)
    assert tuple(int(w) for w in words.split(",")) == kernels.PATHS_WORDS
    rule = re.search(r"int path_lanes\(int D\) \{ return (.*); \}",
                     SOURCE).group(1)
    assert rule == "D <= 64 ? 4 : D <= 128 ? 8 : D <= 256 ? 16 : 32"
    # every (lanes, words) of the rule has a kernel at a block of 16
    # columns (SGM_WIDTHS: 16 and 32; SGM_PATHS: one width)
    instances = set(re.findall(r"^  SGM_WIDTHS\((\d+), (\d+)\)$", SOURCE, re.M))
    instances |= set(re.findall(r"^  SGM_PATHS\((\d+), (\d+), 16\)$", SOURCE,
                                re.M))
    want = {kernels.path_lanes(d) for d in range(1, kernels.PATHS_MAX_RANGE + 1)}
    assert {(int(lanes), int(w)) for lanes, w in instances} == want


def test_cpu_tensors_take_the_plain_path_scan(no_launch):
    cost, img = inputs(7, 2, 5, 40, 16)
    want = kernels.directional_scan_group_bidir_plain(cost, img, None, (0,),
                                                      (0,), P1, P2_INIT, False)
    same(kernels.horizontal_paths(cost, img, P1, P2_INIT), want)
    same(kernels.horizontal_pair_transposed(cost, img, P1, P2_INIT), want)
    same(kernels.horizontal_pair_transposed(cost, img, P1, P2_INIT, parts=2),
         want)


def test_penalties_the_path_scan_refuses():
    cost, img = inputs(8, 1, 2, 4, 16)
    with pytest.raises(ValueError):
        kernels.horizontal_paths(cost, img, -1, P2_INIT)
    with pytest.raises(ValueError):
        kernels.horizontal_paths(cost, img, 2 ** 31 - 255, P2_INIT)


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card route on CPU tensors, the C entries recorded
    (entry, counter, arguments) instead of called."""
    launches = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "group_directions",
                        lambda cost, out, wta=False, ranges=0: 3)

    def launch(entry, counter, *args):
        launches.append((entry, counter, args))
        kernels.LAUNCHES[counter] += 1

    monkeypatch.setattr(kernels, "_launch", launch)

    def group(counter, cost, *args, **kw):
        launches.append(("sgm_scan_group", counter, cost.shape))
        kernels.LAUNCHES[counter] += 1

    monkeypatch.setattr(kernels, "_launch_group", group)
    kernels.reset_launch_counts()
    yield launches
    kernels.reset_launch_counts()


@pytest.mark.parametrize("h,padded", [(16, 16), (20, 32), (48, 48)])
def test_card_route_is_one_launch_a_pair(card_route, h, padded):
    """One ``sgm_path_scan`` launch a horizontal pair, at H padded to a
    multiple of 16 (the pads dropped from the result), the plan left to
    the entry; ``horizontal_calls`` says the same."""
    cost, img = inputs(9, 2, 7, 192, h)
    out = kernels.horizontal_pair_transposed(cost, img, P1, P2_INIT)
    assert out.shape == cost.shape and out.dtype == torch.uint16
    assert [(e, c) for e, c, _ in card_route] == [("sgm_path_scan",
                                                   "horizontal_paths")]
    assert card_route[0][2][3:] == (2, 7, 192, padded, P1, P2_INIT, 0)
    assert kernels.horizontal_calls(cost) == {"horizontal_paths": 1}


def test_card_route_past_1024_takes_the_group_kernel(card_route):
    """At D = 513, the route's edge, and at 1,025 the pair is the group
    kernel's two-order scan: two launches, counted as
    ``horizontal_partial``, as ``horizontal_calls`` (``bidir_calls``)
    counts them; no path scan."""
    for d in (513, 1025):
        cost, img = inputs(10, 1, 3, d, 16)
        kernels.reset_launch_counts()
        card_route.clear()
        kernels.horizontal_pair_transposed(cost, img, P1, P2_INIT)
        assert [(e, c) for e, c, _ in card_route] == [
            ("sgm_scan_group", "horizontal_partial")] * 2
        assert kernels.horizontal_calls(cost) == {"horizontal_partial": 2}
        assert kernels.LAUNCHES["horizontal_paths"] == 0


@pytest.mark.parametrize("parts", [2, 3])
def test_kernel_ab_forced_parts_take_the_horizontal_pair(card_route, parts):
    """Under ``kernel_ab.forced_parts`` the horizontal pair is the group
    kernel's two launches a part at a D the path scan takes (the tools'
    "both pairs forced"), and the path scan's route is back after."""
    cost, img = inputs(12, 1, 5, 192, 48)
    route = kernels.horizontal_route
    with kernel_ab.forced_parts(parts):
        kernels.horizontal_pair_transposed(cost, img, P1, P2_INIT)
    assert kernels.horizontal_route is route
    assert {c for _, c, _ in card_route} == {"horizontal_partial"}
    assert kernels.LAUNCHES["horizontal_partial"] == 2 * parts
    assert kernels.LAUNCHES["horizontal_paths"] == 0


def test_card_route_counts_a_match_batch_pair(card_route):
    """``aggregate_paths_wta`` a call: the three transposes, one path scan,
    the vertical pair's two group launches; no ``horizontal_partial``."""
    b, s, d, w = 1, 6, 8, 24
    cost = torch.zeros((b, s, d, w), dtype=torch.uint8)
    img = torch.zeros((b, s, w), dtype=torch.uint8)
    kernels.aggregate_paths_wta(cost, img, SGMOptions(max_disparity=d))
    counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert counts == {"volume_transpose": 3, "horizontal_paths": 1,
                      "aggregate_paths_wta": 2}


@pytest.mark.parametrize("parts,rows", [(2, 0), (3, 2)])
def test_kernel_ab_one_launch_route_takes_forced_parts(parts, rows):
    """``kernel_ab.one_launch_bidir`` takes ``_bidir``'s keywords: forced
    parts (and rows) go by the two-launch route, so the main path under
    ``one_launch_route`` runs (``--only fused`` raised a TypeError)."""
    b, s, d, w = 1, 5, 8, 24
    cost, img = inputs(11, b, s, d, w)
    opt = SGMOptions(max_disparity=d)
    want = kernels.aggregate_paths_wta(cost, img, opt)
    with kernel_ab.one_launch_route():
        got = kernels.aggregate_paths_wta(cost, img, opt, parts=parts,
                                          rows=rows)
    for g, w_ in zip(got[0] + got[1], want[0] + want[1]):
        same(g, w_)
    same(kernel_ab.one_launch_bidir(cost, img, None, (0, 1, -1), (0, -1, 1),
                                    P1, P2_INIT, False, None,
                                    "aggregate_paths", parts=parts, rows=rows),
         kernels.directional_scan_group_bidir_plain(
             cost, img, None, (0, 1, -1), (0, -1, 1), P1, P2_INIT, False))
