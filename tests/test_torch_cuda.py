"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX (the oracle module is numpy only), so it also runs where JAX
is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import oracle
from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                   SGMOptions)
from soc_project_stereo_matching_tpu_torch.data.synthetic import synthetic_pair
from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
from soc_project_stereo_matching_tpu_torch.ops import (aggregation, kernels,
                                                       postprocess, wta)

H, W = 37, 53
MAIN_PATH = ("census_cost_volume", "aggregate_paths", "horizontal_partial",
             "volume_transpose", "wta_reduce", "lr_check", "remove_speckles")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def same(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def first_design_aggregate(cost, img, opt, mode="wrap"):
    """``aggregate_paths`` as the sum of ``scan_direction`` launches: the
    first design's kernel (a warp per path), one launch per direction."""
    dirs = (aggregation.DIRECTIONS_8 if opt.num_paths == 8
            else aggregation.DIRECTIONS_4)
    return kernels.scan_directions(cost, img, dirs, opt.p1, opt.p2_init,
                                   mode == "restart")


def first_design_group(cost, img, rolls, reverse, restart):
    """A vertical group as ``scan_direction`` launches, one per roll."""
    return kernels.scan_directions(cost, img,
                                   [("v", reverse, roll) for roll in rolls],
                                   10, 150, restart)


HORIZONTAL_PAIR = (("h", False, 0), ("h", True, 0))


@pytest.mark.parametrize("dmin,dmax", [(0, 16), (8, 56), (3, 4), (0, 256)])
def test_kernels_match_plain_on_card(cuda, dmin, dmax):
    left, right, _ = synthetic_pair(0, 2, H, W, (3, 5, 7))
    il, ir = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    opt = SGMOptions(min_disparity=dmin, max_disparity=dmax)
    before = dict(kernels.LAUNCHES)
    cost = kernels.census_cost_volume(il, ir, dmin, dmax)
    same(cost, kernels.census_cost_volume_plain(il, ir, dmin, dmax))
    for mode in ("wrap", "restart"):
        got = kernels.aggregate_paths(cost, il, opt, mode)
        same(got.to(torch.int32),
             aggregation.aggregate_paths(cost, il, opt, mode).to(torch.int32))
        same(got, first_design_aggregate(cost, il, opt, mode))
    aggr = kernels.aggregate_paths(cost, il, opt)
    part = kernels.horizontal_partial(cost, il, opt.p1, opt.p2_init, False)
    same(part, kernels.horizontal_partial_plain(cost, il, opt.p1, opt.p2_init,
                                                False))
    same(part, kernels.scan_directions(cost, il, HORIZONTAL_PAIR, opt.p1,
                                       opt.p2_init))
    got, want = kernels.wta_reduce(aggr, opt), kernels.wta_reduce_plain(aggr, opt)
    for g, w_ in zip(got[0] + got[1], want[0] + want[1]):
        same(g, w_)
    dl = wta.finalize_disparity(got[0], opt)
    dr = wta.finalize_disparity(got[1], opt)
    checked = kernels.lr_check(dl, dr, 1.0, dmax)
    same(checked, postprocess.lr_check(dl, dr, 1.0, dmax))
    same(kernels.remove_speckles(checked, 1.0, 9),
         postprocess.remove_speckles(checked, 1.0, 9))
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > before[k] for k in MAIN_PATH)


def test_engine_on_card_matches_plain_path_and_oracle(cuda):
    left, right, _ = synthetic_pair(6, 2, H, W, (3, 6, 10))
    opt = SGMOptions(max_disparity=16, min_speckle_area=8)
    got = SGMEngine(opt, device="cuda").match_batch(left, right)
    assert got.is_cuda and got.dtype == torch.float32
    same(got, sgm_forward(torch.from_numpy(left).to(cuda),
                          torch.from_numpy(right).to(cuda), opt,
                          use_kernels=False))
    same(got, torch.from_numpy(np.stack([oracle.sgm_match(a, b, opt)
                                         for a, b in zip(left, right)])))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    img = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        kernels.census_cost_volume(img.float(), img.float(), 0, 4)
    with pytest.raises(ValueError):
        kernels.census_cost_volume(img.transpose(1, 2), img, 0, 4)
    with pytest.raises(ValueError):
        kernels.census_cost_volume(img, img.cpu(), 0, 4)
    cost = torch.zeros((1, 8, 257, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kernels.aggregate_paths(cost, img, SGMOptions(max_disparity=257))


def test_uniqueness_threshold_on_card_is_the_f32_product(cuda):
    """``finalize_disparity`` on the card invalidates exactly where
    sec - min <= trunc(f32(min) * (f32(1) - f32(ratio))), for every min cost
    up to past the uint16 range."""
    opt = SGMOptions()
    m = np.arange(70000, dtype=np.int32)
    factor = np.float32(1.0) - np.float32(opt.uniqueness_ratio)
    thresh = np.trunc(m.astype(np.float32) * factor).astype(np.int32)
    for extra, invalid in ((0, True), (1, False)):
        planes = wta.WTAPlanes(*(torch.from_numpy(x).to(cuda) for x in (
            np.full_like(m, 5), m, m + thresh + extra, m + 1, m + 1)))
        got = wta.finalize_disparity(planes, opt)
        assert bool((torch.isinf(got) == invalid).all())


def test_stage_breakdown_runs_and_matches_the_engine(cuda, tmp_path):
    from soc_project_stereo_matching_tpu_torch import stage_breakdown

    out = tmp_path / "stages.json"
    result = stage_breakdown.main(["--batch", "2", "--h", str(H), "--w", str(W),
                                   "--dmax", "16", "--reps", "2",
                                   "--out", str(out)])
    assert out.exists() and len(result["scan_direction_ms"]) == 8
    assert len(result["scan_group_ms"]) == 4
    assert result["stages_ms"]["total"]["median"] > 0


@pytest.mark.parametrize("dmin,dmax", [(0, 16), (8, 56)])
def test_halo_census_matches_plain_on_card(cuda, dmin, dmax):
    rng = np.random.default_rng(30)
    il, ir = (torch.from_numpy(rng.integers(0, 256, (2, H + 4, W),
                                            dtype=np.uint8)).to(cuda)
              for _ in range(2))
    before = kernels.LAUNCHES["census_cost_volume_halo"]
    got = kernels.census_cost_volume(il, ir, dmin, dmax, img_has_halo=True)
    assert got.shape == (2, H, dmax - dmin, W)
    same(got, kernels.census_cost_volume_plain(il, ir, dmin, dmax,
                                               img_has_halo=True))
    same(got, kernels.census_cost_volume(il, ir, dmin, dmax)[:, 2:H + 2])
    assert kernels.LAUNCHES["census_cost_volume_halo"] == before + 1


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("rolls,reverse", [((0, 1, -1), False),
                                           ((0, -1, 1), True)])
def test_tile_chain_on_card_matches_plain_and_untiled(cuda, rolls, reverse,
                                                      restart):
    """K=3 H-tiles chained through the group scan's carry in the exact
    schedule's order: each tile equals the plain version on the same
    carry-in, the chain equals the untiled kernel, and a zero carry-in
    equals a fresh start."""
    rng = np.random.default_rng(31)
    k, ht, d = 3, 12, 24
    cost = torch.from_numpy(rng.integers(0, 256, (2, k * ht, d, W),
                                         dtype=np.uint8)).to(cuda)
    img = torch.from_numpy(rng.integers(0, 256, (2, k * ht, W),
                                        dtype=np.uint8)).to(cuda)
    parts, carry = [None] * k, None
    for i in (range(k - 1, -1, -1) if reverse else range(k)):
        rows = slice(i * ht, (i + 1) * ht)
        prev = None
        if carry is not None:
            prev = img[:, (i + 1) * ht if reverse else i * ht - 1].contiguous()
        args = (cost[:, rows].contiguous(), img[:, rows].contiguous(), None,
                rolls, reverse, 10, 150, restart)
        kw = dict(carry_in=carry, want_carry=True, prev_gray=prev)
        parts[i], carry = kernels.directional_scan_group(*args, **kw)
        want, want_carry = kernels.directional_scan_group_plain(*args, **kw)
        same(parts[i], want)
        for c, wc in zip(carry, want_carry):
            same(c, wc)
    same(torch.cat(parts, dim=1),
         first_design_group(cost, img, rolls, reverse, restart))
    acc = torch.full(cost.shape, 7, dtype=torch.uint16, device=cuda)
    whole = kernels.directional_scan_group(cost, img, acc, rolls, reverse, 10,
                                           150, restart)
    assert whole.data_ptr() == acc.data_ptr()          # added in place
    same(torch.cat(parts, dim=1).int() + 7, whole.int())
    zeros = tuple(torch.zeros_like(c) for c in carry)
    same(kernels.directional_scan_group(cost, img, None, rolls, reverse, 10,
                                        150, restart, carry_in=zeros)[0],
         kernels.directional_scan_group(cost, img, None, rolls, reverse, 10,
                                        150, restart))


def test_tiled_engine_on_card_matches_untiled(cuda):
    from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

    left, right, _ = synthetic_pair(32, 2, 36, W, (3, 6, 10))
    opt = SGMOptions(max_disparity=16, min_speckle_area=8)
    want = SGMEngine(opt, device="cuda").match_batch(left, right)
    for mode in ("exact", "pipelined", "local"):
        kernels.reset_launch_counts()
        got = SGMEngine(opt, EngineConfig(tile_mode=mode), device="cuda",
                        mesh=make_mesh(1, 1)).match_batch(left, right)
        same(got, want)
        assert kernels.LAUNCHES["census_cost_volume_halo"] == 1
        assert kernels.LAUNCHES["directional_scan_group"] == 2  # one a group
        assert kernels.LAUNCHES["horizontal_partial"] == 2
        assert kernels.LAUNCHES["volume_transpose"] == 3


@pytest.mark.parametrize("b,h,d,w", [(2, 5, 16, 300), (2, 12, 1, 20),
                                     (2, 9, 5, 31), (1, 7, 3, 1),
                                     (1, 6, 9, 2), (0, 8, 16, 24),
                                     (3, 20, 64, 450)])
def test_group_kernel_matches_plain_and_first_design_on_card(cuda, b, h, d, w):
    """The group kernel at shapes that stress its strips (W < 32, odd W, one
    and two columns, D = 1, an empty batch, the cone width): every grouping
    of rolls, forward and reverse, wrap and restart, stored and added onto
    an accumulator, against the plain version and against the first
    design's per-direction launches; ``aggregate_paths`` for 4 and 8 paths
    and the horizontal pair."""
    cost = _rand(70, 0, 256, (b, h, d, w), np.uint8, cuda)
    img = _rand(71, 0, 256, (b, h, w), np.uint8, cuda)
    acc = _rand(72, 0, 1000, (b, h, d, w), np.uint16, cuda)
    for rolls, reverse in (((0, 1, -1), False), ((0, -1, 1), True),
                           ((0,), True), ((1,), False), ((-1, 0), True)):
        for restart in (False, True):
            args = (rolls, reverse, 10, 150, restart)
            got = kernels.directional_scan_group(cost, img, None, *args)
            same(got, kernels.directional_scan_group_plain(cost, img, None,
                                                           *args))
            if b:
                same(got, first_design_group(cost, img, rolls, reverse,
                                             restart))
            added = kernels.directional_scan_group(cost, img, acc.clone(),
                                                   *args)
            same(added.int(), got.int() + acc.int())
    part = kernels.horizontal_partial(cost, img, 10, 150, False)
    same(part, kernels.horizontal_partial_plain(cost, img, 10, 150, False))
    if b:
        same(part, kernels.scan_directions(cost, img, HORIZONTAL_PAIR, 10,
                                           150))
    for paths in (4, 8):
        opt = SGMOptions(max_disparity=d, num_paths=paths)
        got = kernels.aggregate_paths(cost, img, opt, "restart")
        same(got.int(), aggregation.aggregate_paths(cost, img, opt,
                                                    "restart").int())
        if b:
            same(got, first_design_aggregate(cost, img, opt, "restart"))
    with pytest.raises(ValueError, match="penalties"):
        kernels.directional_scan_group(cost, img, None, (0,), False, -1, 150,
                                       False)


def test_group_kernel_on_one_big_tile_on_card(cuda):
    """D = 256 at 1500 columns, the widest cluster: an H-tile of 16 rows with
    the carry of the 8 rows before it in and its own out, against the plain
    version; the two tiles together against the untiled launch and the first
    design's; one launch per group as long as ``group_capacity`` says 3."""
    cost = _rand(73, 0, 256, (1, 24, 256, 1500), np.uint8, cuda)
    img = _rand(74, 0, 256, (1, 24, 1500), np.uint8, cuda)
    for rolls, reverse in (((0, 1, -1), False), ((0, -1, 1), True)):
        first, rows = (slice(16, 24), slice(0, 16)) if reverse else \
            (slice(0, 8), slice(8, 24))
        up, carry = kernels.directional_scan_group(
            cost[:, first].contiguous(), img[:, first].contiguous(), None,
            rolls, reverse, 10, 150, False, want_carry=True)
        prev = img[:, 16 if reverse else 7].contiguous()
        args = (cost[:, rows].contiguous(), img[:, rows].contiguous(), None,
                rolls, reverse, 10, 150, False)
        kw = dict(carry_in=carry, want_carry=True, prev_gray=prev)
        before = kernels.LAUNCHES["directional_scan_group"]
        got, got_carry = kernels.directional_scan_group(*args, **kw)
        per_launch = kernels.group_capacity(args[0], got)
        assert kernels.LAUNCHES["directional_scan_group"] - before == \
            -(-len(rolls) // per_launch)
        want, want_carry = kernels.directional_scan_group_plain(*args, **kw)
        same(got, want)
        for c, wc in zip(got_carry, want_carry):
            same(c, wc)
        whole = kernels.directional_scan_group(cost, img, None, rolls,
                                               reverse, 10, 150, False)
        same(torch.cat([got, up] if reverse else [up, got], dim=1), whole)
        same(whole, first_design_group(cost, img, rolls, reverse, False))


# --- the probe kernels (probes/kernels.py) ------------------------------------

def _rand(seed, low, high, shape, dtype, cuda):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(low, high, shape).astype(dtype)).to(cuda)


@pytest.mark.parametrize("d,p,steps,rolls", [(16, 24, 9, (0,)),
                                             (48, 45, 37, (0, 1, -1)),
                                             (256, 33, 20, (0, -1, 1)),
                                             (64, 40, 100, (1,))])
def test_chain_kernels_match_plain_on_card(cuda, d, p, steps, rolls):
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    x = _rand(50, 0, 65536, (2, d, p), np.uint16, cuda)
    before = dict(kernels.LAUNCHES)
    same(pk.chain(x, steps, rolls, 10), pk.chain_plain(x, steps, rolls, 10))
    n = len(rolls)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lanes = pk.chain_lanes(d, 2 * p * n, sms)
    for ring in (3, steps):
        if pk.chainio_shared_bytes(d, n, ring, lanes) > pk.MAX_SHARED_BYTES:
            with pytest.raises(ValueError, match="shared memory"):
                pk.chainio(x, torch.zeros((2, ring, d, p), dtype=torch.int32,
                                          device=cuda),
                           torch.zeros((2, n, ring, p), dtype=torch.int32,
                                       device=cuda), steps, rolls)
            continue
        cost = _rand(51, 0, 256, (2, ring, d, p), np.int32, cuda)
        p2 = _rand(52, 10, 151, (2, n, ring, p), np.int32, cuda)
        for extra in (0, 1, 2):
            args = (x, cost, p2, steps, rolls, extra, 10)
            same(pk.chainio(*args), pk.chainio_plain(*args))
    assert kernels.LAUNCHES["probe_chain"] == before["probe_chain"] + 1
    assert kernels.LAUNCHES["probe_chainio"] > before["probe_chainio"]


@pytest.mark.parametrize("b,h,w,d", [(2, 375, 450, 64), (8, 375, 450, 64),
                                     (32, 375, 450, 64), (1, 1000, 1500, 256)])
def test_chain_kernels_at_the_ladder_shapes_on_card(cuda, b, h, w, d):
    """P1 and P2 at the recurrence-floor ladder's shapes (B*H paths of W
    steps, one direction; 3*B*W paths of H steps, the vertical group), the
    lanes chosen by the rule: bit-equal to the plain versions, P2 in every
    pass shape with a ring of 4, one launch each."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    for x, steps, rolls in (
            (_rand(53, 0, 65536, (b, d, h), np.uint16, cuda), w, (0,)),
            (_rand(54, 0, 65536, (b, d, w), np.uint16, cuda), h, (0, 1, -1))):
        n, p = len(rolls), x.shape[2]
        before = dict(kernels.LAUNCHES)
        same(pk.chain(x, steps, rolls, 10), pk.chain_plain(x, steps, rolls, 10))
        cost = _rand(55, 0, 128, (b, 4, d, p), np.int32, cuda)
        p2 = _rand(56, 10, 151, (b, n, 4, p), np.int32, cuda)
        for extra in (0, 1, 2):
            args = (x, cost, p2, steps, rolls, extra, 10)
            same(pk.chainio(*args), pk.chainio_plain(*args))
        assert kernels.LAUNCHES["probe_chain"] == before["probe_chain"] + 1
        assert kernels.LAUNCHES["probe_chainio"] == before["probe_chainio"] + 3


@pytest.mark.parametrize("d", [1, 3, 61, 255, 256])
@pytest.mark.parametrize("rolls", [(0,), (0, 1, -1)])
def test_chain_kernels_at_odd_disparity_ranges_on_card(cuda, d, rolls):
    """Dead lanes (D not a multiple of the 2 W L disparities a path holds)
    at every lane count that holds D, steps short of one lap of a ring of 4
    and longer, every pass shape, P2 < 0 in some blocks and not in others:
    bit-equal to the plain versions."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    b, p, n = 2, 37, len(rolls)
    x = _rand(57, 0, 65536, (b, d, p), np.uint16, cuda)
    cost = _rand(58, -5000, 5000, (b, 4, d, p), np.int32, cuda)
    p2 = _rand(59, 0, 400, (b, n, 4, p), np.int32, cuda)
    p2[1] -= 300                                   # the second frame's < 0
    for lanes in (1, 2, 4, 8):
        if 32 * lanes < d:
            continue
        for steps in (1, 3, 40):
            same(pk.chain(x, steps, rolls, 10, lanes=lanes),
                 pk.chain_plain(x, steps, rolls, 10))
            for extra in (0, 1, 2, 3):
                args = (x, cost, p2, steps, rolls, extra, 10)
                same(pk.chainio(*args, lanes=lanes), pk.chainio_plain(*args))
    with pytest.raises(ValueError, match="lanes"):
        pk.chain(x, 3, rolls, 10, lanes=3)
    with pytest.raises(ValueError, match="p1"):
        pk.chain(x, 3, rolls, -1)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
@pytest.mark.parametrize("shape", [(2, 37, 48, 45), (1, 32, 1, 64), (3, 5, 7, 100),
                                   (1, 375, 3, 450), (2, 129, 3, 65), (1, 257, 1, 31)])
def test_volume_transpose_matches_permute_on_card(cuda, dtype, shape):
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    hi = 256 if dtype == np.uint8 else 32768
    x = _rand(53, 0, hi, shape, dtype, cuda)
    got = pk.volume_transpose(x)
    same(got, x.permute(0, 3, 2, 1).contiguous())
    same(pk.volume_transpose(got), x)
    # the internal pitch: zeros in the padding, the first columns back
    b, a, d, c = shape
    for pad_to in (16, 3):
        padded = pk.volume_transpose(x, pad_to=pad_to)
        assert padded.shape == (b, c, d, -(-a // pad_to) * pad_to)
        same(padded, pk.volume_transpose_plain(x, None, pad_to))
        same(pk.volume_transpose(padded, inner=a), x)
    # a volume that starts off every 16-byte boundary, up to the last byte of
    # its storage
    for off in (1, 3, 8):
        flat = _rand(54, 0, hi, (x.numel() + off,), dtype, cuda)
        view = flat[off:].view(shape)
        same(pk.volume_transpose(view), view.permute(0, 3, 2, 1).contiguous())
    with pytest.raises(TypeError):
        pk.volume_transpose(x.float())
    with pytest.raises(ValueError):
        pk.volume_transpose(x[..., ::2])            # not contiguous
    with pytest.raises(ValueError, match="inner"):
        pk.volume_transpose(x, inner=c + 1)


def test_rungs_and_scan16_match_plain_on_card(cuda):
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    for name in pk.RUNGS:
        for rows, w in ((16, 256), (48, 45), (2, 1)):
            if name in pk.LOOP_RUNGS:
                rows = 8
            x = _rand(54, 0, 256, (2, rows, w), np.uint8, cuda)
            same(pk.rung(name, x), pk.rung_plain(name, x))
    with pytest.raises(ValueError):
        pk.rung("p3", torch.zeros((1, 5, 8), dtype=torch.uint8, device=cuda))
    for d, w in ((16, 256), (48, 45), (256, 21), (7, 9)):
        cost = _rand(55, 0, 256, (2, 11, d, w), np.uint8, cuda)
        img = _rand(56, 0, 256, (2, 11, w), np.uint8, cuda)
        for rolls, reverse in (((0, 1, -1), False), ((0, -1, 1), True)):
            for restart in (False, True):
                args = (cost, img, rolls, reverse, 10, 150, restart)
                got = pk.scan16(*args)
                same(got, pk.scan16_plain(*args))
                same(got, kernels.directional_scan_group(
                    cost, img, None, rolls, reverse, 10, 150, restart))


@pytest.mark.parametrize("b,s,d,w", [(2, 11, 1, 45), (2, 11, 7, 33),
                                     (2, 13, 64, 451), (1, 9, 256, 300),
                                     (3, 375, 64, 450)])
def test_scan16_matches_plain_and_the_group_scan_on_card(cuda, b, s, d, w):
    """P4 ``scan16`` (a group launch on the group scan's cluster frame, two
    disparities to a register) at D = 1, 7, 64, 256, odd W and the cone
    geometry, both scan orders, wrap and restart: bit-equal to its plain
    version and to the shipped group scan, one launch per group where the
    state fits (below D = 256 always)."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    cost = _rand(80 + d, 0, 256, (b, s, d, w), np.uint8, cuda)
    img = _rand(81, 0, 256, (b, s, w), np.uint8, cuda)
    launches = -(-3 // pk.scan16_capacity(cost))
    assert launches == 1 or d == 256
    for rolls, reverse in (((0, 1, -1), False), ((0, -1, 1), True)):
        for restart in (False, True):
            args = (cost, img, rolls, reverse, 10, 150, restart)
            before = kernels.LAUNCHES["probe_int16"]
            got = pk.scan16(*args)
            assert kernels.LAUNCHES["probe_int16"] == before + launches
            same(got, pk.scan16_plain(*args))
            same(got, kernels.directional_scan_group(
                cost, img, None, rolls, reverse, 10, 150, restart))


def test_scan16_splits_a_group_its_state_cannot_hold_on_card(cuda):
    """At 1500 columns and D = 256 one direction's 16-bit state fills a
    block of a 16-cluster: ``scan16_capacity`` says 1 and the wrapper makes
    three launches (three counts), the sum still bit-equal."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    cost = _rand(82, 0, 256, (1, 7, 256, 1500), np.uint8, cuda)
    img = _rand(83, 0, 256, (1, 7, 1500), np.uint8, cuda)
    assert pk.scan16_capacity(cost) == 1
    for rolls, reverse in (((0, 1, -1), False), ((0, -1, 1), True)):
        before = kernels.LAUNCHES["probe_int16"]
        got = pk.scan16(cost, img, rolls, reverse, 10, 150, True)
        assert kernels.LAUNCHES["probe_int16"] == before + 3
        same(got, pk.scan16_plain(cost, img, rolls, reverse, 10, 150, True))


def test_hpart_T_matches_the_shipped_horizontal_pair_on_card(cuda):
    """The probe's ``hpart_T`` (transposes and group scans assembled launch
    by launch) against the shipped ``horizontal_partial`` (which takes that
    route itself) and against the first design's strided pair (two launches
    of the warp-per-path kernel along W)."""
    from soc_project_stereo_matching_tpu_torch.probes import aggr_transpose

    cost = _rand(57, 0, 128, (2, 37, 48, 45), np.uint8, cuda)
    img = _rand(58, 0, 256, (2, 37, 45), np.uint8, cuda)
    shipped = kernels.horizontal_partial(cost, img, 10, 150, False)
    same(aggr_transpose.hpart_T(cost, img, 10, 150), shipped)
    same(aggr_transpose.hpart_strided(cost, img, 10, 150), shipped)
    same(kernels.scan_direction(cost, img, "h", True, 0, 10, 150),
         kernels.scan_direction_plain(cost, img, "h", True, 0, 10, 150))


def test_probes_run_on_card_and_write_json(cuda, tmp_path):
    from soc_project_stereo_matching_tpu_torch.probes import __main__ as cli

    for name in ("recurrence_floor", "aggr_transpose", "int16_recurrence",
                 "ablation"):
        out = tmp_path / f"{name}.json"
        doc = cli.main([name, "--batch", "2", "--h", str(H), "--w", str(W),
                        "--dmax", "16", "--reps", "2", "--out", str(out)])
        assert out.exists() and doc["card"]
        assert all(rec["ms_per_frame"] > 0 for rec in doc["variants"].values())


# --- the speckle probe kernels (probes/kernels.py, S1-S4) ----------------------

def _speckle_frames(seed, b, h, w, cuda):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, (b, h, w)).astype(np.float32)
    d[rng.random((b, h, w)) < 0.3] = np.inf
    d[0, :, w // 2] = 2.0                      # a full-height line
    d[1, 3:6, 3:6] = np.nan
    d[1, h // 2] = -np.inf
    d[b - 1] = np.inf                          # no finite pixel
    return torch.from_numpy(d).to(cuda)


@pytest.mark.parametrize("h,w", [(37, 45), (13, 21), (64, 130), (5, 300)])
def test_speckle_labels_match_plain_on_card(cuda, h, w):
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    disp = _speckle_frames(60, 4, h, w, cuda)
    before = kernels.LAUNCHES["probe_speckle_labels"]
    base, base_rounds = pk.speckle_labels(disp, 1.0, "base")
    for mode in pk.LABEL_MODES:
        got, rounds = pk.speckle_labels(disp, 1.0, mode)
        want, want_rounds = pk.speckle_labels_plain(disp, 1.0, mode)
        same(got, want)
        same(rounds, want_rounds)
        if mode != "fori16":
            same(got, base)
    assert kernels.LAUNCHES["probe_speckle_labels"] == before + 6
    roots = kernels.union_find_labels(disp, 1.0)
    same(roots, kernels.union_find_labels_plain(disp, 1.0))
    same(pk.flat_to_root_labels(roots), base)
    with pytest.raises(ValueError):
        pk.speckle_labels(disp[:3], 1.0, "block4")
    with pytest.raises(ValueError):
        pk.speckle_labels(disp.transpose(1, 2), 1.0, "base")   # not contiguous


def _labels_match_plain_in_every_mode(disp):
    """S1 in its five modes (block4 where B is a multiple of four) against
    its plain version, labels and rounds; the exact modes against base."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    base, base_rounds = pk.speckle_labels(disp, 1.0, "base")
    for mode in pk.LABEL_MODES:
        if mode == "block4" and disp.shape[0] % pk.BLOCK_FRAMES:
            continue
        got, rounds = pk.speckle_labels(disp, 1.0, mode)
        want, want_rounds = pk.speckle_labels_plain(disp, 1.0, mode)
        same(got, want)
        same(rounds, want_rounds)
        if mode != "fori16":
            same(got, base)
    return base, base_rounds


@pytest.mark.parametrize("b,h,w,dmax", [(8, 375, 450, 64), (32, 375, 450, 64),
                                        (4, 37, 45, 48), (1, 1000, 1500, 256)])
def test_speckle_labels_on_the_engines_disparity_on_card(cuda, b, h, w, dmax):
    """S1 (cluster size chosen per launch, the vertical run-min by chunks,
    the neighbour steps fused on tiles) on the engine's pre-speckle
    disparity at cone B=8 and B=32, 37x45 and Middlebury-half: every mode
    bit-equal to its plain version with the plain version's rounds, and
    the labels those of K4's union-find."""
    from soc_project_stereo_matching_tpu_torch.probes import (
        kernels as pk, prespeckle_disparity)

    _, disp = prespeckle_disparity(cuda, b, h, w, dmax)
    base, _ = _labels_match_plain_in_every_mode(disp)
    same(pk.flat_to_root_labels(kernels.union_find_labels(disp, 1.0)), base)


@pytest.mark.parametrize("h,w,area", [(40, 70, 8), (48, 80, 40), (45, 71, 2)])
def test_speckle_labels_on_hand_made_frames_on_card(cuda, h, w, area):
    from soc_project_stereo_matching_tpu_torch.data.synthetic import (
        speckle_frames)

    disp = torch.from_numpy(speckle_frames(h, w, area)).to(cuda)
    _labels_match_plain_in_every_mode(disp)


@pytest.mark.parametrize("h,w,area,pc", [(37, 45, 8, 2048), (120, 64, 5, 256)])
def test_speckle_tail_kernels_match_plain_on_card(cuda, h, w, area, pc):
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    disp = _speckle_frames(61, 3, h, w, cuda)
    labels, _ = pk.speckle_labels(disp, 1.0, "pyr")
    grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area, pc)
    grouped[0, 0, 0, :2] = torch.tensor([-5, 2 ** 30], device=cuda)  # outside
    before = dict(kernels.LAUNCHES)
    counts = pk.speckle_hist(grouped, h_hist, lo_bits)
    same(counts, pk.speckle_hist_plain(grouped, h_hist, lo_bits))
    same(pk.speckle_hist(grouped, h_hist, lo_bits, aggregate=False), counts)
    small = pk.root_small(counts, area)
    verdict = pk.speckle_verdict(grouped, small)
    same(verdict, pk.speckle_verdict_plain(grouped, small))
    # an empty batch, and a frame length that is no multiple of 4 (the
    # kernel's masked tail, scalar loads)
    empty = pk.speckle_verdict(grouped[:0], small[:0])
    assert empty.shape == (0,) + grouped.shape[1:]
    ragged = grouped.reshape(grouped.shape[0], 1, 1, -1)[..., :-3].contiguous()
    same(pk.speckle_verdict(ragged, small),
         pk.speckle_verdict_plain(ragged, small))
    for aggregate in (False, True):
        same(pk.speckle_tail_fused(grouped, area, h_hist, lo_bits, aggregate),
             verdict)
    assert kernels.LAUNCHES["probe_speckle_hist"] == before["probe_speckle_hist"] + 2
    assert kernels.LAUNCHES["probe_speckle_verdict"] == \
        before["probe_speckle_verdict"] + 3
    assert kernels.LAUNCHES["probe_speckle_fused"] == \
        before["probe_speckle_fused"] + 2
    grouped, _, _ = pk.group_labels(disp, labels, area, pc)
    got = pk.apply_verdict(disp, pk.ungroup_verdict(
        pk.speckle_tail_fused(grouped, area, h_hist, lo_bits), h, w))
    same(got, kernels.remove_speckles(disp, 1.0, area))
    same(got, postprocess.remove_speckles(disp, 1.0, area))
    same(got, kernels.count_verdict(disp, kernels.union_find_labels(disp), area))
    with pytest.raises(TypeError):
        pk.speckle_verdict(grouped, small.float())


def _hist_matches_plain_in_both_modes(grouped, h_hist, lo_bits):
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    want = pk.speckle_hist_plain(grouped, h_hist, lo_bits)
    before = kernels.LAUNCHES["probe_speckle_hist"]
    same(pk.speckle_hist(grouped, h_hist, lo_bits), want)
    same(pk.speckle_hist(grouped, h_hist, lo_bits, aggregate=False), want)
    assert kernels.LAUNCHES["probe_speckle_hist"] == before + 2
    # a frame length that is no multiple of 4: the masked tail
    ragged = grouped.reshape(grouped.shape[0], 1, 1, -1)[..., :-3].contiguous()
    want = pk.speckle_hist_plain(ragged, h_hist, lo_bits)
    for aggregate in (True, False):
        same(pk.speckle_hist(ragged, h_hist, lo_bits, aggregate), want)


@pytest.mark.parametrize("b,h,w,dmax", [(2, 375, 450, 64), (8, 375, 450, 64),
                                        (32, 375, 450, 64), (4, 37, 45, 48),
                                        (1, 1000, 1500, 256)])
def test_speckle_hist_on_the_engines_labels_on_card(cuda, b, h, w, dmax):
    """S2 (runs merged in a thread, across the warp and in a block's table;
    and the per-pixel control) on the labels of the engine's pre-speckle
    disparity at cone B=2, 8, 32, 37x45 and Middlebury-half: bit-equal to
    the plain version in both modes, one count per call."""
    from soc_project_stereo_matching_tpu_torch.probes import (
        kernels as pk, prespeckle_disparity)

    opt, disp = prespeckle_disparity(cuda, b, h, w, dmax)
    labels, _ = pk.speckle_labels(disp, 1.0, "base")
    _hist_matches_plain_in_both_modes(
        *pk.group_labels(disp, labels, opt.min_speckle_area))


@pytest.mark.parametrize("h,w,area", [(40, 70, 8), (48, 80, 40), (45, 71, 2)])
def test_speckle_hist_on_hand_made_frames_on_card(cuda, h, w, area):
    from soc_project_stereo_matching_tpu_torch.data.synthetic import (
        speckle_frames)
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    disp = torch.from_numpy(speckle_frames(h, w, area)).to(cuda)
    labels, _ = pk.speckle_labels(disp, 1.0, "base")
    grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area)
    _hist_matches_plain_in_both_modes(grouped, h_hist, lo_bits)
    # every label of a block distinct, and one label for a whole frame
    size = h_hist << lo_bits
    many = torch.arange(grouped.numel(), device=cuda) % size
    _hist_matches_plain_in_both_modes(many.int().reshape(grouped.shape),
                                      h_hist, lo_bits)
    _hist_matches_plain_in_both_modes(torch.full_like(grouped, 7), h_hist,
                                      lo_bits)


def _fused_matches_in_both_modes(grouped, area, h_hist, lo_bits):
    """S4 in both modes bit-equal to its plain version and to S2 ->
    ``root_small`` -> S3, one launch a call, on a counts plane that the
    allocator has just held garbage in."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    want = pk.speckle_tail_fused_plain(grouped, area, h_hist, lo_bits)
    counts = pk.speckle_hist(grouped, h_hist, lo_bits)
    same(pk.speckle_verdict(grouped, pk.root_small(counts, area)), want)
    for aggregate in (True, False):
        torch.full_like(counts, 3).view(-1)[::7] = -2        # garbage, freed
        before = kernels.LAUNCHES["probe_speckle_fused"]
        same(pk.speckle_tail_fused(grouped, area, h_hist, lo_bits, aggregate),
             want)
        assert kernels.LAUNCHES["probe_speckle_fused"] == before + 1
    return want


@pytest.mark.parametrize("b,h,w,dmax", [(2, 375, 450, 64), (8, 375, 450, 64),
                                        (32, 375, 450, 64), (4, 37, 45, 48),
                                        (1, 1000, 1500, 256)])
def test_speckle_tail_fused_on_the_engines_labels_on_card(cuda, b, h, w, dmax):
    """S4 (one cooperative launch over every block the card holds, rounds
    of whole frames at cone B=32, a zero and an add per distinct label of a
    block) on the labels of the engine's pre-speckle disparity at the
    ladder's shapes: both modes bit-equal to the plain version and to the
    two-launch tail, also on a ragged frame; the plan is the one the CPU
    tests check; the verdict applied is K4's output."""
    from soc_project_stereo_matching_tpu_torch.probes import (
        kernels as pk, prespeckle_disparity)

    opt, disp = prespeckle_disparity(cuda, b, h, w, dmax)
    area = opt.min_speckle_area
    labels, _ = pk.speckle_labels(disp, 1.0, "base")
    grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area)
    verdict = _fused_matches_in_both_modes(grouped, area, h_hist, lo_bits)
    ragged = grouped.reshape(b, 1, 1, -1)[..., :-3].contiguous()
    _fused_matches_in_both_modes(ragged, area, h_hist, lo_bits)
    plan = pk.speckle_tail_plan(b, grouped[0].numel())
    assert (plan["blocks"], plan["frames"], plan["rounds"],
            plan["bits"]) == pk.tail_plan(b, grouped[0].numel(),
                                          plan["resident"])
    assert plan["rounds"] == (3 if b == 32 else 1)   # an H100's 132 blocks
    same(pk.apply_verdict(disp, pk.ungroup_verdict(verdict, h, w)),
         kernels.remove_speckles(disp, 1.0, area))


def test_speckle_tail_fused_on_hand_made_labels_on_card(cuda):
    """S4 on labels no labelling gives: the sentinel, labels past the plane
    and negative ones, a frame length that is no multiple of 4, one label
    for every frame, every label distinct, components of exactly min_area
    and min_area - 1 pixels; an empty batch launches nothing."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    rng = np.random.default_rng(83)
    size = 16 << 7
    runs = np.repeat(rng.integers(0, 60, 20000), rng.integers(1, 12, 20000))
    cases = [
        np.where(rng.random((3, 2, 1, 5000)) < 0.4,
                 rng.choice([-1, -7, size, size + 9, 2 ** 31 - 1],
                            (3, 2, 1, 5000)),
                 rng.integers(0, 9, (3, 2, 1, 5000))),
        runs[:5 * 3333].reshape(5, 1, 1, 3333),
        runs[:7 * 2 * 4000].reshape(7, 2, 1, 4000),
        np.full((2, 3, 1, 2048), 77),
        np.stack([rng.permutation(size) for _ in range(3)]).reshape(3, 2, 1,
                                                                    1024),
        np.concatenate([np.full(5, 3), np.full(4, 8), np.arange(20, 29),
                        np.full(6, size)])[None, None, None, :].repeat(2, 0),
    ]
    for labels in cases:
        labels = torch.from_numpy(labels.astype(np.int32)).to(cuda)
        _fused_matches_in_both_modes(labels, 5, 16, 7)
    empty = torch.zeros((0, 2, 1, 64), dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["probe_speckle_fused"]
    assert pk.speckle_tail_fused(empty, 5, 16, 7).shape == empty.shape
    assert kernels.LAUNCHES["probe_speckle_fused"] == before


def test_speckle_tail_fused_refuses_on_card(cuda):
    """The entry refuses a frame larger than one round of the blocks the
    card holds (and launches nothing); it takes the largest one that fits.
    The wrapper refuses what the kernel does not take."""
    from soc_project_stereo_matching_tpu_torch.probes import kernels as pk

    plan = pk.speckle_tail_plan(0, 0)
    assert plan["blocks"] == plan["rounds"] == plan["bits"] == 0
    assert plan["resident"] >= 1
    largest = plan["resident"] * 4 * pk.TAIL_QUADS * pk.TAIL_THREADS - 8
    labels = torch.arange(largest + 1, device=cuda, dtype=torch.int32) % 999
    before = kernels.LAUNCHES["probe_speckle_fused"]
    with pytest.raises(RuntimeError, match="holds at once"):
        pk.speckle_tail_fused(labels.reshape(1, 1, 1, -1), 5, 16, 7)
    with pytest.raises(RuntimeError, match="holds at once"):
        pk.speckle_tail_plan(1, largest + 1)
    assert kernels.LAUNCHES["probe_speckle_fused"] == before
    fits = labels[:largest].reshape(1, 1, 1, -1)
    same(pk.speckle_tail_fused(fits, 5, 16, 7),
         pk.speckle_tail_fused_plain(fits, 5, 16, 7))
    assert pk.speckle_tail_plan(1, largest)["rounds"] == 1
    grouped = torch.zeros((2, 3, 1, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pk.speckle_tail_fused(grouped.float(), 5, 16, 7)
    with pytest.raises(ValueError):
        pk.speckle_tail_fused(grouped.transpose(1, 3), 5, 16, 7)
    with pytest.raises(ValueError):
        pk.speckle_tail_fused(grouped.reshape(2, 3, 2, 32), 5, 16, 7)
    with pytest.raises(ValueError):
        pk.speckle_tail_fused(grouped, 5, 0, 7)


def test_speckle_probes_run_on_card_and_write_json(cuda, tmp_path):
    from soc_project_stereo_matching_tpu_torch.probes import __main__ as cli

    for name in ("speckle", "speckle_tail"):
        out = tmp_path / f"{name}.json"
        doc = cli.main([name, "--batch", "4", "--h", str(H), "--w", str(W),
                        "--dmax", "16", "--reps", "2", "--out", str(out)])
        assert out.exists() and doc["card"]
        assert all(rec["ms_per_frame"] > 0 for rec in doc["variants"].values())


# --- K4 (tile-local union-find) and K1 (16-byte stores) on the shapes that
# stress their designs -----------------------------------------------------------

def _random_speckle_input(seed, b, h, w, cuda):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, (b, h, w)).astype(np.float32)
    d[rng.random((b, h, w)) < 0.3] = np.inf
    d[rng.random((b, h, w)) < 0.02] = np.nan
    d[rng.random((b, h, w)) < 0.02] = -np.inf
    return torch.from_numpy(d).to(cuda)


def _speckle_stages_match_plain(disp, area):
    """K4 whole and its two stage entries against the plain versions, each
    entry counted once as remove_speckles."""
    before = kernels.LAUNCHES["remove_speckles"]
    got = kernels.remove_speckles(disp, 1.0, area)
    same(got, postprocess.remove_speckles(disp, 1.0, area))
    roots = kernels.union_find_labels(disp, 1.0)
    same(roots, kernels.union_find_labels_plain(disp, 1.0))
    same(kernels.count_verdict(disp, roots, area), got)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["remove_speckles"] == before + 3
    return got


@pytest.mark.parametrize("h,w,area", [(40, 70, 8), (48, 80, 40), (45, 71, 2)])
def test_speckle_kernel_on_hand_made_frames_on_card(cuda, h, w, area):
    from soc_project_stereo_matching_tpu_torch.data.synthetic import (
        speckle_frames)

    d = speckle_frames(h, w, area)
    got = _speckle_stages_match_plain(torch.from_numpy(d).to(cuda), area).cpu()
    assert int(torch.isfinite(got[2]).sum()) == area   # min_area - 1 went
    assert bool(torch.isinf(got[6:]).all())            # frames never connect
    assert torch.equal(got[5], torch.from_numpy(d[5]))  # one component
    assert torch.equal(torch.isfinite(got[1]), torch.from_numpy(np.isfinite(d[1])))


@pytest.mark.parametrize("b,h,w", [(2, 37, 45), (1, 1, 300), (1, 300, 1),
                                   (3, 17, 33), (2, 16, 32), (2, 33, 65),
                                   (1, 1, 1), (4, 5, 31)])
@pytest.mark.parametrize("area", [1, 4, 9])
def test_speckle_kernel_at_awkward_sizes_on_card(cuda, b, h, w, area):
    _speckle_stages_match_plain(_random_speckle_input(70, b, h, w, cuda), area)


def test_speckle_kernel_at_middlebury_half_on_card(cuda):
    from soc_project_stereo_matching_tpu_torch.probes import (
        prespeckle_disparity)

    opt, disp = prespeckle_disparity(cuda, 1, 1000, 1500, 256)
    _speckle_stages_match_plain(disp, opt.min_speckle_area)
    _speckle_stages_match_plain(_random_speckle_input(71, 1, 1000, 1500, cuda),
                                9)


@pytest.mark.parametrize("h,w,dmin,dmax,halo", [
    (37, 45, 3, 10, 0),       # D*W = 315: no row starts on 16 bytes
    (37, 45, 3, 10, 1),
    (5, 40, 0, 16, 0), (40, 5, 0, 16, 0),    # one interior row / column
    (4, 30, 0, 8, 0), (30, 4, 0, 8, 0),      # none
    (3, 20, 0, 3, 0), (20, 3, 0, 3, 0),
    (4, 30, 0, 8, 1), (5, 30, 0, 8, 1), (30, 5, 0, 8, 1),
    (37, 53, 8, 56, 1), (9, 1, 0, 1, 0), (250, 1500, 0, 256, 1)])
def test_census_cost_kernel_at_odd_shapes_on_card(cuda, h, w, dmin, dmax, halo):
    rng = np.random.default_rng(80)
    il, ir = (torch.from_numpy(rng.integers(0, 256, (2, h + 4 * halo, w),
                                            dtype=np.uint8)).to(cuda)
              for _ in range(2))
    got = kernels.census_cost_volume(il, ir, dmin, dmax, img_has_halo=bool(halo))
    assert got.shape == (2, h, dmax - dmin, w)
    same(got, kernels.census_cost_volume_plain(il, ir, dmin, dmax,
                                               img_has_halo=bool(halo)))


def test_main_path_launches_each_entry_once_per_batch(cuda):
    left, right, _ = synthetic_pair(7, 2, H, W, (3, 6, 10))
    engine = SGMEngine(SGMOptions(max_disparity=16, min_speckle_area=8),
                       device="cuda")
    kernels.reset_launch_counts()
    engine.match_batch(left, right)
    torch.cuda.synchronize()
    for name in ("census_cost_volume", "wta_reduce", "lr_check",
                 "remove_speckles"):
        assert kernels.LAUNCHES[name] == 1, (name, kernels.LAUNCHES[name])


# --- K2 WTA (csrc/wta.cu) -------------------------------------------------------

def _wta_volume_on_card(b, h, d, w, pattern, offset, cuda):
    """A seeded uint16 (B, H, D, W) volume on the card ("random", "ties":
    costs 0..3, "flat": half the columns one cost on every plane, "max":
    real 65535 beside small costs), starting ``offset`` elements into its
    storage (a data pointer off the 16-byte grid)."""
    g = torch.Generator(device=cuda).manual_seed(b * h * d + w)
    n = b * h * d * w
    hi = 4 if pattern == "ties" else 60000
    flat = torch.randint(0, hi, (n + offset,), generator=g, device=cuda,
                         dtype=torch.int32)
    aggr = flat[offset:].view(b, h, d, w)
    if pattern == "flat":
        aggr[..., : w // 2] = 7
    elif pattern == "max":
        aggr = torch.where(torch.rand(aggr.shape, generator=g, device=cuda)
                           < 0.4, 65535, aggr % 8)
        aggr[..., 0] = 65535
    store = torch.empty(n + offset, dtype=torch.uint16, device=cuda)
    out = store[offset:].view(b, h, d, w)
    out.copy_(aggr.to(torch.uint16))
    return out


@pytest.mark.parametrize("b,h,d,w,dmin,pattern,offset", [
    (2, 375, 64, 450, 0, "random", 0),       # cone B=2
    (1, 1000, 256, 1500, 0, "random", 0),    # Middlebury-half
    (2, 37, 48, 45, 8, "random", 1),         # odd W
    (2, 9, 16, 5, 0, "random", 0),           # W < 16
    (2, 9, 1, 53, 0, "random", 3),           # D = 1
    (2, 9, 3, 53, 2, "ties", 0),             # D = 3
    (1, 8, 128, 1242, 24, "random", 0),      # KITTI-2012's range
    (2, 9, 64, 450, 0, "ties", 5),
    (2, 9, 64, 450, 0, "flat", 0),
    (2, 9, 64, 450, 3, "max", 7),
    (1, 3, 128, 4100, 24, "random", 1),      # rows cut into segments
    (1, 3, 16, 2049, 0, "max", 0),
    (2, 5, 16, 45, 100, "random", 0),        # the inverse view all off the row
    (1, 2, 256, kernels.WTA_MAX_WIDTH, 0, "random", 0)])   # the widest row
def test_wta_kernel_matches_plain_on_card(cuda, b, h, d, w, dmin, pattern,
                                          offset):
    opt = SGMOptions(min_disparity=dmin, max_disparity=dmin + d)
    aggr = _wta_volume_on_card(b, h, d, w, pattern, offset, cuda)
    for inverse in (True, False):
        before = kernels.LAUNCHES["wta_reduce"]
        got = kernels.wta_reduce(aggr, opt, inverse)
        assert kernels.LAUNCHES["wta_reduce"] == before + 1
        want = kernels.wta_reduce_plain(aggr, opt, inverse)
        for g, w_ in zip(got[0] + (got[1] or ()), want[0] + (want[1] or ())):
            same(g, w_)
        assert (got[1] is None) == (not inverse)


def test_wta_kernel_refuses_beyond_its_limits(cuda):
    opt = SGMOptions(max_disparity=256)
    wide = torch.zeros((1, 1, 256, kernels.WTA_MAX_WIDTH + 1),
                       dtype=torch.uint16, device=cuda)
    with pytest.raises(ValueError, match=str(kernels.WTA_MAX_WIDTH)):
        kernels.wta_reduce(wide, opt)
    deep = torch.zeros((1, 1, 257, 8), dtype=torch.uint16, device=cuda)
    with pytest.raises(ValueError, match="1..256"):
        kernels.wta_reduce(deep, SGMOptions(max_disparity=257))


# the widest row one sgm_scan_group launch takes (one direction) by D on one
# H100 80GB HBM3: kernels.group_capacity's docstring states the same
GROUP_WIDTH_LIMIT = {64: 13824, 128: 6720, 256: 3264}


@pytest.mark.parametrize("d", sorted(GROUP_WIDTH_LIMIT))
def test_group_capacity_refuses_rows_from_its_limit_on_card(cuda, d):
    """Where ``group_capacity`` starts to refuse a row: the widest W that
    still takes a direction, found by bisection and checked on both sides."""
    def takes(w):
        cost = torch.zeros((1, 1, d, w), dtype=torch.uint8, device=cuda)
        out = torch.zeros((1, 1, d, w), dtype=torch.uint16, device=cuda)
        try:
            return kernels.group_capacity(cost, out) >= 1
        except ValueError:
            return False

    lo, hi = 16, 1 << 16
    assert takes(lo) and not takes(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if takes(mid) else (lo, mid)
    assert (d, lo) == (d, GROUP_WIDTH_LIMIT[d])
    assert str(lo) in kernels.group_capacity.__doc__.replace(",", "")
