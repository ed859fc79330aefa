"""The group scan over column parts with halo columns, on the CPU, bit for bit.

Where the card does not hold a row's scan state at once, the wrappers of
``ops/kernels.py`` take the row in column parts, each with halo columns
on both sides, and, where the halo would be too wide, in chunks of rows with
carries between them (``group_route``, ``scan_parts``, ``bidir_parts``).
The route's slices run the one-launch kernel on a card; on CPU tensors the
same slicing runs each slice through the plain version, forced by
``parts`` and ``rows``.  Here:

* the route with forced parts and rows a chunk (R < S, so the carries are
  used) against the port's full-width plain versions and against the JAX
  package's ``directional_scan_group``, ``_directional_scan_group_bidir``
  and ``aggregate_paths``, run as its own tests run them on the CPU
  (interpret mode): wrap and restart, rolls 0 and +-1, both scan orders,
  carries in and out, the 8- and 4-path groups, the WTA forms;
* the plan (``parts_plan``, pure arithmetic on the card's resident width)
  at shapes with one chunk and with several, the slices (``part_columns``)
  and the chunks (``row_chunks``).

The Pallas entries take a scan axis of whole chunks of 8 rows: their shapes
have S = 8, the port's alone S up to 12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu_torch.config import from_jax
from soc_project_stereo_matching_tpu_torch.ops import kernels

P1, P2_INIT = 10, 150
ROWS = 8            # the Pallas entries' block_rows
GROUPS = [((0, 1, -1), False), ((0, -1, 1), True), ((1,), False),
          ((-1,), True), ((0,), False)]
# (parts, rows a chunk): several chunks, a part a column pair wide, one
# part in chunks, one chunk
FORCED = [(3, 4), (2, 3), (4, 2), (1, 5), (2, 0)]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def same_planes(got, want):
    for g, w in zip((*got[0], *(got[1] or ())), (*want[0], *(want[1] or ()))):
        same(g, w)
    assert (got[1] is None) == (want[1] is None)


def inputs(seed, b, s, d, w):
    rng = np.random.default_rng(seed)
    return (t(rng.integers(0, 128, (b, s, d, w), dtype=np.uint8)),
            t(rng.integers(0, 256, (b, s, w), dtype=np.uint8)),
            t(rng.integers(0, 900, (b, s, d, w)).astype(np.uint16)))


@pytest.fixture
def no_launch():
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("w,s,reach,resident,want", [
    # one part where the row fits: no halo, one chunk
    (24480, 512, 1, 24480, (1, 0, 512)),
    # the satellite strip at D = 256 (24,480 columns at once on an H100):
    # two parts, one chunk (2 S = 1,024 halo columns within a quarter)
    (36000, 512, 1, 24480, (2, 512, 512)),
    # a row at D = 16,384 (224 at once): the halo would take 2 S columns,
    # so chunks of 28 rows (56 halo columns, a quarter), parts of 168
    (2000, 100, 1, 224, (12, 28, 28)),
    (232, 112, 1, 224, (2, 28, 28)),
    # 2 S within the quarter: one chunk
    (232, 28, 1, 224, (2, 28, 28)),
    (232, 27, 1, 224, (2, 27, 27)),
    # the roll-0 direction (the horizontal pair): no halo, one chunk
    (2000, 3000, 0, 224, (9, 0, 3000)),
    (30000, 1988, 0, 6336, (5, 0, 1988)),
    # an odd width: the last part one column short
    (101, 3, 1, 40, (3, 3, 3)),
])
def test_parts_plan_takes_one_chunk_or_several(w, s, reach, resident, want):
    """``parts_plan`` at shapes with one chunk and with several: every
    slice (the widest part and its halo) fits the resident width, the halo
    keeps within ``1 / HALO_SHARE`` of it where the row needs parts, and
    one part fewer would not fit."""
    plan = kernels.parts_plan(w, s, reach, resident)
    assert tuple(plan) == want
    bounds = kernels.strip_bounds(w, plan.parts)
    widest = max(b - a for a, b in zip(bounds, bounds[1:]))
    assert widest + 2 * plan.halo <= resident
    assert plan.halo == (plan.rows * reach if plan.parts > 1 else 0)
    if plan.parts > 1:
        assert 2 * plan.halo <= resident // kernels.HALO_SHARE
        fewer = kernels.strip_bounds(w, plan.parts - 1)
        assert max(b - a for a, b in zip(fewer, fewer[1:])) + 2 * plan.halo > \
            resident


def test_parts_plan_refuses_a_card_too_narrow_for_a_part():
    with pytest.raises(ValueError, match="takes no part"):
        kernels.parts_plan(100, 10, 1, 3)


@pytest.mark.parametrize("restart", [False, True])
def test_part_columns_and_row_chunks(restart):
    """The slices: interiors that tile the row, k halo columns a side read
    mod W in wrap mode (also past the other edge, where k exceeds a part),
    none past the image's edges in restart mode; the chunks in scan order."""
    plan = kernels.PartsPlan(3, 5, 5)
    cols = kernels.part_columns(13, plan, restart)
    assert [(a, b) for _, _, a, b in cols] == [(0, 4), (4, 8), (8, 13)]
    if restart:
        assert [(lo, hi) for lo, hi, _, _ in cols] == [(0, 9), (0, 13), (3, 13)]
    else:
        assert [(lo, hi) for lo, hi, _, _ in cols] == [(-5, 9), (-1, 13),
                                                        (3, 18)]
    with pytest.raises(ValueError, match="empty"):
        kernels.part_columns(5, kernels.PartsPlan(4, 0, 1), restart)
    assert kernels.row_chunks(7, 3, False) == [(0, 3), (3, 6), (6, 7)]
    assert kernels.row_chunks(7, 3, True) == [(4, 7), (1, 4), (0, 1)]


def test_group_route_forces_parts_on_cpu_tensors():
    """On CPU tensors the route takes parts only where forced: the halo of
    the forced rows a chunk (none for one part), S rows by default."""
    cost, _, _ = inputs(0, 1, 9, 4, 20)
    assert kernels.group_route(cost, None, (0, 1, -1)) is None
    assert kernels.group_route(cost, None, (0, 1), parts=3) == (3, 9, 9)
    assert kernels.group_route(cost, None, (0, -1), parts=3, rows=4) == (3, 4, 4)
    assert kernels.group_route(cost, None, (0,), parts=3, rows=4) == (3, 0, 4)
    assert kernels.group_route(cost, None, (1,), parts=1, rows=4) == (1, 0, 4)
    with pytest.raises(ValueError, match="rows a chunk"):
        kernels.group_route(cost, None, (1,), rows=4)


# --- against the port's full-width plain versions --------------------------------

@pytest.mark.parametrize("parts,rows", FORCED)
@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("rolls,reverse", GROUPS)
def test_group_scan_by_parts_matches_the_plain_version(rolls, reverse, restart,
                                                       parts, rows, no_launch):
    """One scan order by parts (stored, added onto ``acc``, carries in and
    out, the WTA form) against ``directional_scan_group_plain`` at full
    width; the carry-out equal at every column."""
    cost, img, acc = inputs(10 + parts, 2, 11, 16, 37)
    args = (rolls, reverse, P1, P2_INIT, restart)
    forced = dict(parts=parts, rows=rows)
    same(kernels.directional_scan_group(cost, img, None, *args, **forced),
         kernels.directional_scan_group_plain(cost, img, None, *args))
    start = acc.clone()
    got = kernels.directional_scan_group(cost, img, start, *args, **forced)
    assert got.data_ptr() == start.data_ptr()
    same(got, kernels.directional_scan_group_plain(cost, img, acc.clone(), *args))
    carry = kernels.directional_scan_group_plain(cost, img, None, *args,
                                                 want_carry=True)[1]
    gray = img[:, 0 if reverse else -1].contiguous()
    got = kernels.directional_scan_group(cost, img, acc.clone(), *args,
                                         carry_in=carry, want_carry=True,
                                         prev_gray=gray, **forced)
    want = kernels.directional_scan_group_plain(cost, img, acc.clone(), *args,
                                                carry_in=carry,
                                                want_carry=True,
                                                prev_gray=gray)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        same(g, w)
    fresh = kernels.directional_scan_group(cost, img, None, *args,
                                           want_carry=True, **forced)
    for g, w in zip(fresh[1], carry):
        same(g, w)
    same_planes(kernels.directional_scan_group(cost, img, acc.clone(), *args,
                                               wta=(5, True), **forced),
                kernels.directional_scan_group_plain(cost, img, acc.clone(),
                                                     *args, wta=(5, True)))


@pytest.mark.parametrize("parts,rows", FORCED)
@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("paths", [8, 4])
def test_two_order_scan_by_parts_matches_the_plain_version(paths, restart,
                                                           parts, rows,
                                                           no_launch):
    """Both orders by parts (per slice where one chunk suffices, else two
    one-order scans in chunks): the volume stored and added, and the WTA
    forms from the totals, against ``directional_scan_group_bidir_plain``."""
    cost, img, acc = inputs(20 + parts, 2, 12, 13, 44)
    (rf, _), (rb, _) = kernels.scan_groups(paths)
    args = (rf, rb, P1, P2_INIT, restart)
    forced = dict(parts=parts, rows=rows)
    for start in (None, acc):
        same(kernels.directional_scan_group_bidir(
                 cost, img, None if start is None else start.clone(), *args,
                 **forced),
             kernels.directional_scan_group_bidir_plain(
                 cost, img, None if start is None else start.clone(), *args))
    for wta in ((0, True), (6, False)):
        park = acc.clone()
        got = kernels.directional_scan_group_bidir(cost, img, park, *args,
                                                   wta=wta, **forced)
        same_planes(got, kernels.directional_scan_group_bidir_plain(
            cost, img, acc.clone(), *args, wta=wta))
        # the epilogue does not run over parts: the totals stay on acc
        same(park, kernels.directional_scan_group_bidir_plain(
            cost, img, acc.clone(), *args))


@pytest.mark.parametrize("parts", [2, 5])
def test_horizontal_pair_by_parts_matches_the_plain_version(parts, no_launch):
    """The horizontal pair on the transposed volume by parts (no halo: the
    roll-0 direction), directly and through ``horizontal_partial``."""
    cost, img, _ = inputs(30, 2, 9, 12, 31)
    cost_t, img_t = (kernels.volume_transpose(cost, pad_to=16),
                     kernels.image_transpose(img, pad_to=16))
    same(kernels.horizontal_pair_transposed(cost_t, img_t, P1, P2_INIT,
                                            parts=parts),
         kernels.horizontal_pair_transposed(cost_t, img_t, P1, P2_INIT))
    same(kernels.horizontal_partial(cost, img, P1, P2_INIT, False,
                                    parts=parts),
         kernels.horizontal_partial_plain(cost, img, P1, P2_INIT, False))


# --- against the JAX package ----------------------------------------------------------

def pallas_group(cost, img, rolls, reverse, restart, carry_in=None,
                 prev_row=None, acc=None):
    p2 = pk._p2_planes(jnp.asarray(img.numpy().astype(np.int32)), rolls,
                       -1 if reverse else 1, P1, P2_INIT, prev_row=prev_row)
    return pk.directional_scan_group(
        jnp.asarray(cost.numpy().astype(np.int8)), p2,
        None if acc is None else jnp.asarray(acc.numpy()), rolls, reverse, P1,
        restart, block_rows=ROWS, carry_in=carry_in,
        want_carry=carry_in is not None)


@pytest.mark.parametrize("rolls,reverse,restart", [((0, 1, -1), False, False),
                                                   ((0, -1, 1), True, True)])
def test_group_scan_by_parts_matches_pallas(rolls, reverse, restart,
                                            no_launch):
    """The Pallas group entry against the route at 3 parts of 3 rows a
    chunk (the carries used twice), with an accumulator; then a carried
    tile: the carry-in and the upstream gray row from the Pallas entry's
    own first tile, the carry-out and the sums against its second."""
    cost, img, acc = inputs(40, 2, 8, 24, 45)
    forced = dict(parts=3, rows=3)
    same(kernels.directional_scan_group(cost, img, acc.clone(), rolls, reverse,
                                        P1, P2_INIT, restart, **forced),
         pallas_group(cost, img, rolls, reverse, restart, acc=acc))
    n = len(rolls)
    zero = (jnp.zeros((2, n, 24, 45), jnp.int32),
            jnp.zeros((2, n, 1, 45), jnp.int32))
    _, up = pallas_group(cost, img, rolls, reverse, restart, zero)
    gray = img[:, 0 if reverse else -1]
    want, carry = pallas_group(cost, img, rolls, reverse, restart, up,
                               jnp.asarray(gray.numpy().astype(np.int32)))
    got, got_carry = kernels.directional_scan_group(
        cost, img, None, rolls, reverse, P1, P2_INIT, restart,
        carry_in=tuple(t(np.array(x)) for x in up), want_carry=True,
        prev_gray=gray.contiguous(), **forced)
    same(got, want)
    for g, w in zip(got_carry, carry):
        same(g, w)


@pytest.mark.parametrize("paths,restart", [(8, False), (8, True), (4, False)])
def test_two_order_scan_by_parts_matches_pallas(paths, restart, no_launch):
    """The Pallas two-order entry against the route in chunks (two one-order
    scans) and in one chunk (per slice), with an accumulator."""
    cost, img, acc = inputs(50, 2, 8, 20, 40)
    (rf, _), (rb, _) = kernels.scan_groups(paths)
    img32 = jnp.asarray(img.numpy().astype(np.int32))
    p2 = pk._stack_p2_fb(pk._p2_planes(img32, rf, +1, P1, P2_INIT),
                         pk._p2_planes(img32, rb, -1, P1, P2_INIT))
    want = pk._directional_scan_group_bidir(
        jnp.asarray(cost.numpy().astype(np.int8)), p2, jnp.asarray(acc.numpy()),
        rf, rb, P1, restart, ROWS)
    for parts, rows in ((3, 3), (2, 0)):
        same(kernels.directional_scan_group_bidir(
                 cost, img, acc.clone(), rf, rb, P1, P2_INIT, restart,
                 parts=parts, rows=rows), want)


@pytest.mark.parametrize("paths,mode", [(8, "wrap"), (4, "restart")])
def test_aggregate_paths_by_parts_matches_pallas(paths, mode, no_launch):
    """``aggregate_paths`` and ``aggregate_paths_wta`` with both pairs forced
    into parts against the JAX ``aggregate_paths`` and the WTA of its
    volume."""
    cost, img, _ = inputs(60, 2, 8, 16, 43)
    opt = SGMOptions(num_paths=paths, min_disparity=4, max_disparity=20)
    want = pk.aggregate_paths(jnp.asarray(cost.numpy()),
                              jnp.asarray(img.numpy()), opt, mode,
                              block_rows=ROWS)
    got = kernels.aggregate_paths(cost, img, from_jax(opt), mode, parts=3,
                                  rows=3)
    same(got, want)
    same_planes(kernels.aggregate_paths_wta(cost, img, from_jax(opt), mode,
                                            parts=2, rows=5),
                kernels.wta_reduce_plain(t(np.array(want)), from_jax(opt)))


# --- the card's route, its launches recorded ------------------------------------------

RESIDENT = 24       # the card's resident width in the recorded route


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card route on CPU tensors with the C entries recorded
    instead of called: one launch takes a row of up to ``RESIDENT``
    columns (three directions), none a wider one."""
    launches = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "group_directions",
                        lambda cost, out, wta=False, ranges=0:
                        3 if cost.shape[-1] <= RESIDENT else 0)
    monkeypatch.setattr(kernels, "resident_width",
                        lambda device, d, ranges=0: RESIDENT)
    monkeypatch.setattr(kernels, "_launch",
                        lambda entry, counter, *args: launches.append(entry))

    def group(counter, cost, img, out, passes, npass, n, carry_n, restart, p1,
              p2_init, accumulate, views=0, dmin=0, finished=None,
              planes=None, ranges=0):
        assert cost.is_contiguous() and img.shape == cost.shape[:2] + \
            cost.shape[3:] and out.shape == cost.shape
        launches.append((counter, cost.shape[1], cost.shape[-1], views,
                         [(p.lo, p.hi, bool(p.reverse), bool(p.cin_cost),
                           bool(p.cout_cost)) for p in passes]))

    monkeypatch.setattr(kernels, "_launch_group", group)
    return launches


def test_card_route_chunks_the_vertical_pair_and_reduces_it(card_route):
    """``aggregate_paths_wta`` past the resident width: the horizontal pair
    (16 rows after padding) by the path scan's one launch; the vertical
    pair, whose halo of 2 S columns would pass a quarter of the width, as
    two one-order scans in chunks of 3 rows over 3 parts (slices of 18, 20,
    20 columns, carries in after the first chunk and out before the last),
    no epilogue; then one ``wta_reduce``.  ``bidir_calls`` counts the same
    launches."""
    b, s, d, w = 1, 4, 8, 40
    cost = torch.zeros((b, s, d, w), dtype=torch.uint8)
    img = torch.zeros((b, s, w), dtype=torch.uint8)
    opt = from_jax(SGMOptions(max_disparity=d))
    kernels.aggregate_paths_wta(cost, img, opt)
    assert kernels.group_route(cost, cost, (0, 1, -1), True) == (3, 3, 3)
    assert card_route.count("sgm_path_scan") == 1
    assert not [x for x in card_route if x[0] == "horizontal_partial"]
    vertical = [x for x in card_route if x[0] == "aggregate_paths_wta"]
    want = []
    for reverse, chunks in ((False, [(0, 3), (3, 4)]), (True, [(1, 4), (0, 1)])):
        for c, (r0, r1) in enumerate(chunks):
            for width in (18, 20, 20):
                want.append(("aggregate_paths_wta", r1 - r0, width, 0,
                             [(0, r1 - r0, reverse, c > 0, c == 0)]))
    assert vertical == want
    assert card_route[-1] == "sgm_wta_reduce"
    assert card_route.count("sgm_wta_reduce") == 1
    assert kernels.bidir_calls(cost, cost, (0, 1, -1), (0, -1, 1), True) == \
        (len(vertical), 1)


def test_card_route_takes_one_chunk_per_slice_where_it_can(card_route):
    """Two rows: the halo (2 columns a side) keeps within a quarter, so each
    of 2 parts (slices of 24 columns) runs the two-order scan's two
    launches meeting at the middle row; a one-order scan with carries in
    and out takes one launch a part, its carry-out at every column."""
    b, s, d, w = 2, 2, 4, 40
    cost = torch.zeros((b, s, d, w), dtype=torch.uint8)
    img = torch.zeros((b, s, w), dtype=torch.uint8)
    kernels.directional_scan_group_bidir(cost, img, None, (0, 1, -1),
                                         (0, -1, 1), P1, P2_INIT, False)
    first = [(0, 1, False, False, True), (1, 2, True, False, True)]
    second = [(1, 2, False, True, False), (0, 1, True, True, False)]
    assert card_route == [("directional_scan_group_bidir", 2, 24, 0, first),
                          ("directional_scan_group_bidir", 2, 24, 0, second)] * 2
    assert kernels.bidir_calls(cost, cost, (0, 1, -1), (0, -1, 1), False) == \
        (4, 0)
    card_route.clear()
    carry = (torch.zeros((b, 1, d, w), dtype=torch.int32),
             torch.zeros((b, 1, 1, w), dtype=torch.int32))
    out, (cc, cm) = kernels.directional_scan_group(
        cost, img, None, (1,), True, P1, P2_INIT, True, carry_in=carry,
        want_carry=True)
    assert card_route == [("directional_scan_group", 2, 22, 0,
                           [(0, 2, True, True, True)])] * 2
    assert cc.shape == (b, 1, d, w) and cm.shape == (b, 1, 1, w)


def test_kernel_ab_forces_parts_on_the_two_order_scans(monkeypatch,
                                                      no_launch):
    """``kernel_ab.forced_parts`` hands its parts and rows to every
    ``_bidir`` call made inside it, over what the caller passes (on CPU
    tensors: the parts route over the plain version, the same sums), and
    puts ``_bidir`` back after; the route's slices do not come back
    through ``_bidir`` (no parts of parts)."""
    from soc_project_stereo_matching_tpu_torch import kernel_ab

    cost, img, acc = inputs(70, 1, 9, 8, 30)
    saved, by_parts, seen = kernels._bidir, kernels.bidir_parts, []
    monkeypatch.setattr(kernels, "bidir_parts",
                        lambda *args: seen.append(args[9]) or by_parts(*args))
    with kernel_ab.forced_parts(3, 4):
        got = kernels._bidir(cost, img, acc.clone(), (0, 1, -1), (0, -1, 1),
                             P1, P2_INIT, False, None, "aggregate_paths",
                             parts=0, rows=0)
    assert kernels._bidir is saved
    assert seen == [(3, 4, 4)]
    same(got, kernels.directional_scan_group_bidir_plain(
        cost, img, acc.clone(), (0, 1, -1), (0, -1, 1), P1, P2_INIT, False))
