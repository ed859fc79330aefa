"""D split over the blocks of a cluster, on the CPU.

Where not even strips of two columns hold one direction's state (D above
2,515), the group kernel (csrc/aggregate.cu, SPLIT) gives each strip's D to
the blocks of a cluster.  ``kernels.directional_scan_split_plain`` models
that decomposition: D in ranges that exchange only the rows at their edges
and each column's minimum over their range, the strip's edge column
through device memory.  Here the model is held against the JAX package's
group entry (Pallas, interpret mode) just above D = 2,515, and against the
port's plain scan at small D and every mode; the split's shape is held
against the constants of the source.  The card runs the kernel itself
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 11).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu_torch import _build
from soc_project_stereo_matching_tpu_torch.ops import kernels

P1, P2_INIT = 10, 150
ROWS = 8                    # the Pallas entries' block_rows


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def planes(p):
    return [x for view in p if view is not None for x in view]


def p2_planes(img, rolls, reverse, prev_row=None):
    return pk._p2_planes(jnp.asarray(img.astype(np.int32)), rolls,
                         -1 if reverse else 1, P1, P2_INIT, prev_row=prev_row)


def test_split_matches_pallas_with_carries_above_2515():
    """D = 2,516, the 8-path group's forward order, wrap: two H-tiles of 4
    rows chained through the carry, each scanned as 2 strips of 16 blocks
    splitting D (the last block's range the rest), against the Pallas
    group entry's sums and carries."""
    d, w = 2516, 12
    rolls, reverse = (0, 1, -1), False
    rng = np.random.default_rng(50)
    cost = rng.integers(0, 128, (1, 8, d, w), dtype=np.uint8)
    img = rng.integers(0, 256, (1, 8, w), dtype=np.uint8)
    up, down = slice(0, 4), slice(4, 8)
    gray = img[:, 3]
    want_a, jcarry_a = pk.directional_scan_group(
        jnp.asarray(cost[:, up].astype(np.int8)), p2_planes(img[:, up], rolls,
                                                            reverse),
        None, rolls, reverse, P1, False, block_rows=ROWS, want_carry=True)
    want_b, jcarry_b = pk.directional_scan_group(
        jnp.asarray(cost[:, down].astype(np.int8)),
        p2_planes(img[:, down], rolls, reverse,
                  jnp.asarray(gray.astype(np.int32))),
        None, rolls, reverse, P1, False, block_rows=ROWS, carry_in=jcarry_a,
        want_carry=True)
    out_a, carry_a = kernels.directional_scan_split_plain(
        t(cost[:, up]), t(img[:, up]), None, rolls, reverse, P1, P2_INIT,
        False, 16, 2, want_carry=True)
    out_b, carry_b = kernels.directional_scan_split_plain(
        t(cost[:, down]), t(img[:, down]), None, rolls, reverse, P1, P2_INIT,
        False, 16, 2, carry_in=carry_a, want_carry=True, prev_gray=t(gray))
    same(out_a, want_a)
    same(out_b, want_b)
    for got, want in zip(carry_a + carry_b, jcarry_a + jcarry_b):
        same(got, want)


def test_split_with_epilogue_matches_pallas_above_2515():
    """D = 2,600, the reverse order, restart, onto an accumulator, with the
    WTA epilogue (both views, dmin 3): 3 strips of 4 blocks (ranges of 652
    disparities, the last 644), against the Pallas group entry's planes."""
    d, w, s = 2600, 11, 6
    rolls, reverse = (0, -1, 1), True
    rng = np.random.default_rng(51)
    cost = rng.integers(0, 128, (1, s, d, w), dtype=np.uint8)
    img = rng.integers(0, 256, (1, s, w), dtype=np.uint8)
    acc = rng.integers(0, 900, (1, s, d, w)).astype(np.uint16)
    hp = -(-s // ROWS) * ROWS
    pad = ((0, 0), (0, hp - s), (0, 0), (0, 0))
    _, want = pk._directional_scan_group(
        jnp.pad(jnp.asarray(cost.astype(np.int8)), pad),
        jnp.pad(p2_planes(img, rolls, reverse), pad), jnp.pad(jnp.asarray(acc),
                                                              pad),
        rolls, reverse, P1, True, ROWS, wta=(3, True))
    got = kernels.directional_scan_split_plain(
        t(cost), t(img), t(acc.copy()), rolls, reverse, P1, P2_INIT, True, 4,
        3, wta=(3, True), chunk=32)
    assert len(planes(got)) == 10
    for g, w_ in zip(planes(got), want):
        same(g, np.asarray(w_)[:, :s])


# (blocks, D): every D of 17..300 splits over 2 and 3 blocks; over 16 only
# where 15 ranges of ceil(D / 16) rounded up to 4 leave the last some
SPLITS = [(2, 17), (3, 40), (16, 64), (16, 250)]


@pytest.mark.parametrize("ranges,d", SPLITS)
def test_split_matches_the_plain_scan(ranges, d):
    """Both orders of the 8-path group, one diagonal alone and the roll-0
    direction, wrap and restart, 1 to 3 strips (the wrap a strip's hand-off
    to itself where there is one), with and without an accumulator, carries
    in and out, and the epilogue: equal to ``directional_scan_group_plain``."""
    rng = np.random.default_rng(52 + d)
    b, s, w = 2, 5, 13
    cost = t(rng.integers(0, 128, (b, s, d, w), dtype=np.uint8))
    img = t(rng.integers(0, 256, (b, s, w), dtype=np.uint8))
    acc = t(rng.integers(0, 900, (b, s, d, w)).astype(np.uint16))
    for strips in (1, 3):
        for rolls, reverse, restart in (((0, 1, -1), False, False),
                                        ((0, -1, 1), True, True),
                                        ((-1,), False, True), ((0,), True,
                                                               False)):
            args = (rolls, reverse, P1, P2_INIT, restart)
            same(kernels.directional_scan_split_plain(
                     cost, img, acc.clone(), *args, ranges, strips),
                 kernels.directional_scan_group_plain(cost, img, acc.clone(),
                                                      *args))
            carry = kernels.directional_scan_group_plain(
                cost, img, None, *args, want_carry=True)[1]
            gray = img[:, -1].contiguous()
            got = kernels.directional_scan_split_plain(
                cost, img, None, *args, ranges, strips, carry_in=carry,
                want_carry=True, prev_gray=gray)
            want = kernels.directional_scan_group_plain(
                cost, img, None, *args, carry_in=carry, want_carry=True,
                prev_gray=gray)
            for g, w_ in zip((got[0], *got[1]), (want[0], *want[1])):
                same(g, w_)
            for g, w_ in zip(planes(kernels.directional_scan_split_plain(
                                 cost, img, acc.clone(), *args, ranges,
                                 strips, wta=(2, True), chunk=7)),
                             planes(kernels.directional_scan_group_plain(
                                 cost, img, acc.clone(), *args,
                                 wta=(2, True)))):
                same(g, w_)


def test_split_refuses_a_block_without_disparities():
    """16 blocks of ceil(17 / 16) -> 4 disparities leave the last ones none:
    no such split (``split_depth`` None), as the kernel's plan refuses it."""
    assert kernels.split_depth(17, 16) is None
    assert kernels.split_depth(64, 16) == 4 and kernels.split_depth(70, 16) is None
    assert kernels.split_depth(2516, 16) == 160
    cost = torch.zeros((1, 2, 17, 5), dtype=torch.uint8)
    img = torch.zeros((1, 2, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not split"):
        kernels.directional_scan_split_plain(cost, img, None, (0,), False, P1,
                                             P2_INIT, False, 16)
    with pytest.raises(ValueError, match="empty"):   # 4 strips of 3 pairs
        kernels.directional_scan_split_plain(cost, img, None, (0,), False, P1,
                                             P2_INIT, False, 2, 4)


def test_split_shape_transcribes_the_source():
    """The split's constants and shape lines are csrc/aggregate.cu's, and
    the transcription gives every D in 2,516..16,384 a split for one
    direction where strips of two columns hold none: D = 2,516 on 2 strips
    of 16 blocks at 512 columns, D = 16,384 on 2 strips of 16 at 64 columns
    and none at 2 blocks (8,192 disparities a block)."""
    text = (_build.CSRC / "aggregate.cu").read_text()
    for name, value in (("kSplitChunks", kernels.GROUP_SPLIT_CHUNKS),
                        ("kSplitFrom", kernels.GROUP_SPLIT_FROM),
                        ("kSlots", kernels.GROUP_SLOTS)):
        assert re.search(rf"constexpr int {name} = (\d+);", text).group(1) \
            == str(value), name
    shape = text[text.index("int group_shape(GroupArgs& a"):]
    shape = shape[:shape.index("\n}\n")]
    for line in ("a.DK = kr > 1 ? round_up((a.D + kr - 1) / kr, 4) : a.D;",
                 "if ((long long)(kr - 1) * a.DK >= a.D) return -1;",
                 "const int max_chunks = kr > 1 ? kSplitChunks : kMaxChunks;",
                 "a.red_np = (a.NP + kr - 1) / kr;",
                 "kr > 1 ? round_up(kSlots * n * kr * a.pitchM * 2, 16)",
                 "round_up(4 * (a.NCH > kr ? a.NCH : kr), 16);"):
        assert line in shape, line
    assert "constexpr int kOrder[] = {8, 16, 4, 2};" in text
    assert "if (a.D >= kSplitFrom) {" in text
    for d in (2516, 3000, 4096, 8192, 16384):
        assert kernels.group_clusters(d, 4000, 1) is None
        assert any(kernels.group_split(d, 64, 1, wta, r) is not None
                   for r in (2, 4, 8, 16) for wta in (False,))
    assert kernels.group_split(2516, 512, 1, False, 16) == 2
    assert kernels.group_split(16384, 64, 1, False, 16) == 2
    assert kernels.group_split(16384, 64, 1, False, 2) is None
    # the split's block holds every direction's state of its range: never
    # more shared memory than the card's 227 KB where it returns a plan
    for d, w, n, wta, r in ((2516, 512, 3, True, 16), (4096, 512, 1, False, 8),
                            (760, 2964, 3, True, 8)):
        g = kernels.group_split(d, w, n, wta, r)
        assert kernels.group_smem_bytes(d, w, n, r, g, wta, r) <= \
            kernels.GROUP_SMEM
