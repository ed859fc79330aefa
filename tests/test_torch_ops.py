"""The port's plain PyTorch ops vs the JAX package's jnp ops and the numpy
oracle, bit for bit (inf equal to inf), on seeded CPU inputs.

Each reference-semantics hazard (uint8 wrap, first path pixel, adaptive P2
along wrapped paths, the direction table, WTA ties / D=1 / inverse shear,
the f32 uniqueness threshold, the LR band, speckle connectivity, the
median's border) has a targeted case.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions, oracle
from soc_project_stereo_matching_tpu.ops import aggregation as j_agg
from soc_project_stereo_matching_tpu.ops import census as j_census
from soc_project_stereo_matching_tpu.ops import cost_volume as j_cost
from soc_project_stereo_matching_tpu.ops import exact_math as j_exact
from soc_project_stereo_matching_tpu.ops import postprocess as j_post
from soc_project_stereo_matching_tpu.ops import wta as j_wta
from soc_project_stereo_matching_tpu_torch.config import from_jax
from soc_project_stereo_matching_tpu_torch.data.synthetic import speckle_frames
from soc_project_stereo_matching_tpu_torch.ops import (aggregation, census,
                                                       cost_volume, exact_math,
                                                       postprocess, wta)

H, W = 37, 53
RANGES = [(0, 16), (8, 56)]          # D=16, and D=48 with dmin=8

# jitted JAX references (eager dispatch of their Python loops is slow)
j_divide = jax.jit(j_exact.div_s32_correctly_rounded)
j_wta_reduce = jax.jit(j_wta.wta_reduce, static_argnames=("options", "inverse"))
j_finalize = jax.jit(j_wta.finalize_disparity, static_argnames=("options",))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_divide_matches_jax_ladder_over_its_domain():
    rng = np.random.default_rng(0)
    n = rng.integers(-(2 ** 17) + 1, 2 ** 17, 200_000).astype(np.int32)
    m = rng.integers(1, 2 ** 16, 200_000).astype(np.int32)
    edge_m = np.array([1, 2, 3, 255, 256, 257, 32767, 65534, 65535], np.int32)
    edge_n = np.array([-(2 ** 17) + 1, -65535, -1, 0, 1, 65535, 2 ** 17 - 1],
                      np.int32)
    n = np.concatenate([n, np.repeat(edge_n, edge_m.size),
                        np.arange(1, 20000, dtype=np.int32)])
    m = np.concatenate([m, np.tile(edge_m, edge_n.size),
                        2 * np.arange(1, 20000, dtype=np.int32)])   # exact .5
    got = exact_math.div_s32_correctly_rounded(t(n), t(m)).numpy()
    assert got.dtype == np.float32
    same(got, j_divide(jnp.asarray(n), jnp.asarray(m)),
         n.astype(np.float32) / m.astype(np.float32))


def test_census_matches_jax_and_oracle():
    imgs = np.random.default_rng(1).integers(0, 256, (2, H, W), dtype=np.uint8)
    imgs[:, 10:14, 20:30] = 77                    # ties: strict < gives 0 bits
    got = census.census_5x5(t(imgs)).numpy()
    assert got.dtype == np.int32
    same(got, np.asarray(j_census.census_5x5(jnp.asarray(imgs))).astype(np.int32),
         np.stack([oracle.census_5x5(i) for i in imgs]).astype(np.int32))


@pytest.mark.parametrize("shape", [(5, 17), (17, 5), (4, 17), (17, 4),
                                   (3, 17), (17, 3)])
def test_census_at_five_or_fewer_rows_or_columns(shape):
    """Where the two contracts part.  With 5 rows or columns the port's op
    computes the one interior row or column, as the jnp op does, while
    ``oracle.census_5x5`` returns zeros (it tests ``h <= 5 or w <= 5``).
    With 4 all three give zeros.  With 3 the jnp op raises (its shifted
    views no longer broadcast) and the port gives zeros, as the oracle
    does."""
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    got = census.census_5x5(t(img)).numpy()
    want_oracle = oracle.census_5x5(img).astype(np.int32)
    assert not want_oracle.any()
    if min(shape) == 3:
        with pytest.raises(TypeError):
            j_census.census_5x5(jnp.asarray(img))
        same(got, want_oracle)
        return
    same(got, np.asarray(j_census.census_5x5(jnp.asarray(img))).astype(np.int32))
    if min(shape) == 5:
        assert got.any()                    # the interior line, not zeros
    else:
        same(got, want_oracle)


@pytest.mark.parametrize("dmin,dmax", RANGES)
def test_cost_volume_matches_jax_and_oracle(dmin, dmax):
    imgs = np.random.default_rng(2).integers(0, 256, (2, 2, H, W), dtype=np.uint8)
    cl = np.stack([oracle.census_5x5(i) for i in imgs[0]])
    cr = np.stack([oracle.census_5x5(i) for i in imgs[1]])
    got = cost_volume.hamming_cost_volume(
        t(cl.astype(np.int32)), t(cr.astype(np.int32)), dmin, dmax).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, H, dmax - dmin, W)
    same(got, j_cost.hamming_cost_volume(jnp.asarray(cl), jnp.asarray(cr),
                                         dmin, dmax),
         np.stack([oracle.hamming_cost_volume(a, b, dmin, dmax)
                   for a, b in zip(cl, cr)]))
    assert (got[:, :, :, :dmin] == 127).all()     # j - d < 0 costs 127


def test_direction_table_matches_jax():
    assert aggregation.DIRECTIONS_8 == j_agg.DIRECTIONS_8
    assert aggregation.DIRECTIONS_4 == j_agg.DIRECTIONS_4
    # the reverse diagonals are (v, True, -1) and (v, True, +1)
    assert ("v", True, -1) in aggregation.DIRECTIONS_8[4:]
    assert ("v", True, +1) in aggregation.DIRECTIONS_8[4:]


@pytest.mark.parametrize("mode", ["wrap", "restart"])
@pytest.mark.parametrize("direction", j_agg.DIRECTIONS_8)
def test_each_directional_scan_matches_jax(direction, mode):
    """One pass per direction, full uint8 cost domain: pins the scan order,
    the roll sign, the raw-cost first pixel and P2 along the wrapped path."""
    axis, reverse, roll = direction
    rng = np.random.default_rng(3)
    cost = rng.integers(0, 256, (H, 16, W), dtype=np.uint8)
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    if axis == "h":
        cost, img = cost.transpose(2, 1, 0), img.T
    got = aggregation.directional_scan(t(cost), t(img), 10, 150, reverse,
                                       roll, mode)[0].numpy()
    want, _ = j_agg.directional_scan(jnp.asarray(cost), jnp.asarray(img), 10,
                                     150, reverse, roll, mode)
    same(got, want)
    first = -1 if reverse else 0
    same(got[first], cost[first])                 # first pixel: raw cost


def test_dp_step_wraps_mod_256_with_255_sentinels():
    """C + m - minL above 255 wraps (no saturation); d=-1 and d=D read 255."""
    prev = np.array([[0, 200], [250, 200], [255, 255]], np.int32)   # (D=3, P=2)
    prev_min = prev.min(axis=0)
    cost_row = np.array([[255, 250], [255, 250], [255, 250]], np.int32)
    gray_prev = np.array([0, 100], np.int32)
    gray_row = np.array([255, 100], np.int32)
    got = aggregation._dp_step(t(prev), t(prev_min), t(gray_prev), t(cost_row),
                               t(gray_row), 10, 150).numpy()
    want = j_agg._dp_step(j_agg.ScanCarry(jnp.asarray(prev), jnp.asarray(prev_min),
                                          jnp.asarray(gray_prev)),
                          jnp.asarray(cost_row), jnp.asarray(gray_row), 10, 150)
    same(got, want)
    # column 1: P2' = 150 // 1 = 150, m(d=0) = min(200, 255+10, 210, 350) = 200
    assert got[0, 1] == (250 + 200 - 200) & 0xFF == 250
    # column 0: d=1 gets min(250, 0+10, 265, 0+max(10, 150//256)) = 10
    assert got[1, 0] == (255 + 10 - 0) & 0xFF == 9


def test_adaptive_p2_uses_the_wrapped_previous_pixel():
    """A wrap diagonal's previous pixel at column 0 is column W-1 of the row
    before; a bright edge there changes P2' and so the result."""
    rng = np.random.default_rng(4)
    cost = rng.integers(0, 64, (8, 16, 12), dtype=np.uint8)
    img = np.full((8, 12), 100, np.uint8)
    img[:, -1] = 0           # |dI| = 100 into and out of the last column
    for roll in (+1, -1):
        got, _ = aggregation.directional_scan(t(cost), t(img), 10, 150, False,
                                              roll)
        want, _ = j_agg.directional_scan(jnp.asarray(cost), jnp.asarray(img),
                                         10, 150, False, roll)
        same(got.numpy(), want)
        flat, _ = aggregation.directional_scan(t(cost), t(np.full_like(img, 100)),
                                               10, 150, False, roll)
        assert not torch.equal(got, flat)           # the edge did matter


@pytest.mark.parametrize("mode", ["wrap", "restart"])
@pytest.mark.parametrize("paths", [8, 4])
def test_aggregate_paths_matches_jax_and_oracle(paths, mode):
    rng = np.random.default_rng(5)
    cost = rng.integers(0, 256, (2, H, 16, W), dtype=np.uint8)
    img = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
    opt = SGMOptions(num_paths=paths, max_disparity=16)
    got = aggregation.aggregate_paths(t(cost), t(img), from_jax(opt), mode)
    assert got.dtype == torch.uint16
    got = got.numpy()
    same(got, np.stack([j_agg.aggregate_paths(jnp.asarray(c), jnp.asarray(i),
                                              opt, mode)
                        for c, i in zip(cost, img)]))
    if mode == "wrap":                              # the oracle's geometry
        same(got, np.stack([oracle.aggregate_paths(c, i, opt)
                            for c, i in zip(cost, img)]))


def _aggr(rng, d, hi):
    return rng.integers(0, hi, (2, 9, d, 40)).astype(np.uint16)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dmin,dmax", RANGES + [(3, 4)])
def test_wta_reduce_matches_jax(dmin, dmax, inverse):
    """Small cost range forces ties (first argmin; sec_min over d != best);
    (3, 4) is D=1, whose sec_min is 1<<30; the inverse view shifts plane k
    by the disparity dmin + k."""
    opt = SGMOptions(min_disparity=dmin, max_disparity=dmax)
    for hi in (4, 2041):
        aggr = _aggr(np.random.default_rng(6), dmax - dmin, hi)
        got = wta.wta_reduce(t(aggr), from_jax(opt), inverse)
        want = j_wta_reduce(jnp.asarray(aggr), opt, inverse)
        for g, w_ in zip(got, want):
            assert g.dtype == torch.int32
            same(g.numpy(), w_)
    if dmax - dmin == 1:
        assert (got.sec_min == 1 << 30).all()


@pytest.mark.parametrize("dmin,dmax", RANGES + [(3, 4)])
def test_finalize_disparity_matches_jax_and_oracle(dmin, dmax):
    opt = SGMOptions(min_disparity=dmin, max_disparity=dmax)
    aggr = _aggr(np.random.default_rng(7), dmax - dmin, 2041)
    for inverse in (False, True):
        got = wta.finalize_disparity(
            wta.wta_reduce(t(aggr), from_jax(opt), inverse), from_jax(opt))
        assert got.dtype == torch.float32
        same(got.numpy(),
             j_wta.compute_disparity(jnp.asarray(aggr), opt, inverse),
             np.stack([oracle.compute_disparity(a, opt, inverse) for a in aggr]))


def test_uniqueness_threshold_is_f32():
    """trunc(f32(100) * (f32(1) - f32(0.99))) = 0, but the Python double
    1 - 0.99 would give 1 and wrongly invalidate sec - min = 1."""
    assert int(100 * (1 - 0.99)) == 1
    opt = SGMOptions()
    full = lambda v: torch.full((1, 1), v, dtype=torch.int32)
    planes = wta.WTAPlanes(full(5), full(100), full(101), full(120), full(110))
    got = wta.finalize_disparity(planes, from_jax(opt))
    want = j_finalize(
        j_wta.WTAPlanes(*(jnp.asarray(p.numpy()) for p in planes)), opt)
    same(got.numpy(), want)
    assert torch.isfinite(got).all()


def _maps(rng, h, w, hi, nonfinite):
    maps = []
    for _ in range(2):
        m = rng.uniform(0, hi, (2, h, w)).astype(np.float32)
        m[rng.random(m.shape) < 0.2] = np.inf
        if nonfinite:
            m[rng.random(m.shape) < 0.1] = -np.inf
            m[rng.random(m.shape) < 0.1] = np.nan
        maps.append(m)
    return maps


@pytest.mark.parametrize("w", [83, 12])           # 12: W-1 < max_shift
def test_lr_check_matches_jax_and_oracle(w):
    dl, dr = _maps(np.random.default_rng(8), 45, w, min(16, w), False)
    got = postprocess.lr_check(t(dl), t(dr), 1.0, max_shift=16).numpy()
    same(got, j_post.lr_check(jnp.asarray(dl), jnp.asarray(dr), 1.0, max_shift=16),
         np.stack([oracle.lr_check(a, b, 1.0) for a, b in zip(dl, dr)]))
    assert np.isinf(got).sum() > np.isinf(dl).sum()   # it killed pixels


def test_lr_check_nonfinite_and_out_of_band_match_jax():
    """NaN / -inf on both sides, and left disparities far beyond max_shift:
    outside the band the JAX select samples 0.0, not disp_right[col]."""
    rng = np.random.default_rng(9)
    dl, dr = _maps(rng, 16, 40, 15, True)
    dl[:, 3, 30:] = 25.0                            # shift 25 >= max_shift + 2
    dr[:, 3, :] = 25.0                              # a plain gather would keep
    got = postprocess.lr_check(t(dl), t(dr), 1.0, max_shift=16).numpy()
    same(got, j_post.lr_check(jnp.asarray(dl), jnp.asarray(dr), 1.0, max_shift=16))
    assert np.isinf(got[:, 3, 30:]).all()           # |25 - 0.0| > 1


@pytest.mark.parametrize("min_area", [9, 50])
def test_remove_speckles_matches_jax_and_oracle(min_area):
    rng = np.random.default_rng(10)
    d = rng.integers(0, 8, (2, 47, 61)).astype(np.float32)
    d[rng.random(d.shape) < 0.35] = np.inf
    d[0, 5:9, 5:9] = 3.5                            # |dd| = 0.5 joins
    got = postprocess.remove_speckles(t(d), 1.0, min_area).numpy()
    same(got, np.stack([j_post.remove_speckles(jnp.asarray(x), 1.0, min_area)
                        for x in d]),
         np.stack([oracle.remove_speckles(x, 1.0, min_area) for x in d]))
    assert np.isinf(got).sum() > np.isinf(d).sum()


@pytest.mark.parametrize("h,w,min_area", [(40, 70, 8), (48, 80, 40)])
def test_remove_speckles_on_hand_made_frames_matches_jax_and_oracle(h, w,
                                                                  min_area):
    """The hand-made frames of the card tests (a full-height line, a snake
    across every tile, components of ``min_area`` and ``min_area - 1``
    pixels around tile corners, NaN / -inf / +inf, an empty and a constant
    frame, two strips facing each other across a frame boundary)."""
    d = speckle_frames(h, w, min_area)
    got = postprocess.remove_speckles(t(d), 1.0, min_area).numpy()
    same(got, np.stack([j_post.remove_speckles(jnp.asarray(x), 1.0, min_area)
                        for x in d]),
         np.stack([oracle.remove_speckles(x, 1.0, min_area) for x in d]))
    assert np.isfinite(got[2]).sum() == min_area      # the smaller one went
    assert np.isinf(got[6:]).all()                    # frames never connect
    same(got[5], d[5])


def test_speckle_connectivity_is_f32():
    """2.0 - (1 - 2**-24) is exactly 1 + 2**-24 but rounds to 1.0 in f32:
    the pair connects (as in the JAX op), so the 2-pixel component survives
    min_area=2."""
    d = np.full((1, 3, 4), np.inf, np.float32)
    d[0, 1, 1], d[0, 1, 2] = 2.0, np.float32(1 - 2 ** -24)
    got = postprocess.remove_speckles(t(d), 1.0, 2).numpy()
    same(got[0], j_post.remove_speckles(jnp.asarray(d[0]), 1.0, 2))
    assert np.isfinite(got[0, 1, 1:3]).all()


def test_median_matches_jax_and_oracle():
    rng = np.random.default_rng(11)
    d = rng.uniform(0, 64, (2, H, W)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = np.inf           # +inf orders last
    got = postprocess.median_filter_3x3(t(d)).numpy()
    same(got, j_post.median_filter_3x3(jnp.asarray(d)),
         np.stack([oracle.median_filter_3x3(x) for x in d]))
    same(got[:, 0], d[:, 0])                        # border untouched
    same(got[:, :, -1], d[:, :, -1])
