"""The grouped K2 wrappers of the port (``ops/kernels.py``) on the CPU.

The CUDA group kernel (``csrc/aggregate.cu``, ``sgm_scan_group``) runs only on
a card, where ``test_torch_cuda.py`` holds it against the plain versions and
the first design's kernel.  What can be held here, bit for bit:

* the wrappers' CPU route against the JAX entries they mirror, run as the
  JAX package's own tests run them on the CPU (interpret mode):
  ``aggregate_paths``, ``directional_scan_group`` with and without carries,
  ``horizontal_partial``;
* the kernel's arithmetic, transcribed into PyTorch (``packed_step_plain``:
  two columns in the 16-bit lanes of a word, the P2' table, the clamped
  penalties), against ``aggregation._dp_step`` over the uint8 domain;
* the layouts around the kernel: the transposed volume of the horizontal
  pair round-trips to (B, H, D, W), and the direction groups partition
  ``DIRECTIONS_8/4``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu_torch.config import from_jax
from soc_project_stereo_matching_tpu_torch.ops import aggregation, kernels

P1, P2_INIT = 10, 150
B = 2
SHAPES = {"plain": (11, 40), "narrow": (9, 20), "odd": (7, 33)}   # (H, W)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def volume(seed, h, w, d, cost_hi=256):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cost_hi, (B, h, d, w), dtype=np.uint8),
            rng.integers(0, 256, (B, h, w), dtype=np.uint8))


@pytest.fixture
def no_launch():
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


# --- the wrappers against the JAX entries ------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dmin,dmax", [(0, 1), (0, 16), (8, 56)])
@pytest.mark.parametrize("paths,mode", [(8, "wrap"), (8, "restart"),
                                        (4, "wrap")])
def test_aggregate_paths_matches_pallas(paths, mode, dmin, dmax, shape,
                                        no_launch):
    h, w = SHAPES[shape]
    cost, img = volume(60, h, w, dmax - dmin)
    opt = SGMOptions(num_paths=paths, min_disparity=dmin, max_disparity=dmax)
    got = kernels.aggregate_paths(t(cost), t(img), from_jax(opt), mode)
    assert got.dtype == torch.uint16 and got.shape == cost.shape
    same(got, pk.aggregate_paths(jnp.asarray(cost), jnp.asarray(img), opt,
                                 mode, block_rows=8))


@pytest.mark.parametrize("d", [1, 16, 48])
@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("rolls,reverse", [((0, 1, -1), False),
                                           ((0, -1, 1), True),
                                           ((0,), False), ((0,), True)])
def test_group_scan_matches_pallas(rolls, reverse, restart, d, no_launch):
    """One group, no carries, with and without an accumulator, W < 32 (the
    Pallas entry takes a scan axis of whole chunks: 16 rows of chunks of 8)."""
    h, w = 16, SHAPES["narrow"][1]
    cost, img = volume(61, h, w, d)
    acc = np.random.default_rng(62).integers(0, 1000, cost.shape).astype(np.uint16)
    p2 = pk._p2_planes(jnp.asarray(img.astype(np.int32)), rolls,
                       -1 if reverse else 1, P1, P2_INIT)
    for start in (None, acc):
        want = pk.directional_scan_group(
            jnp.asarray(cost.astype(np.int8)), p2,
            None if start is None else jnp.asarray(start), rolls, reverse, P1,
            restart, block_rows=8)
        got = kernels.directional_scan_group(
            t(cost), t(img), None if start is None else t(start.copy()), rolls,
            reverse, P1, P2_INIT, restart)
        assert got.dtype == torch.uint16
        same(got, want)


@pytest.mark.parametrize("d", [1, 48])
@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("rolls,reverse", [((0, 1, -1), False),
                                           ((0, -1, 1), True)])
def test_group_scan_with_carries_matches_pallas(rolls, reverse, restart, d,
                                                no_launch):
    """Two H-tiles chained through the carry, at D = 1 and D = 48, W < 32."""
    h, w = SHAPES["narrow"]
    cost, img = volume(63, h, w, d)
    cut = 4
    upstream, downstream = slice(0, cut), slice(cut, None)
    if reverse:
        upstream, downstream = downstream, upstream
    gray = img[:, upstream][:, 0 if reverse else -1]

    def pallas(rows, carry_in, prev_row):
        p2 = pk._p2_planes(jnp.asarray(img[:, rows].astype(np.int32)), rolls,
                           -1 if reverse else 1, P1, P2_INIT, prev_row=prev_row)
        return pk.directional_scan_group(
            jnp.asarray(cost[:, rows].astype(np.int8)), p2, None, rolls,
            reverse, P1, restart, carry_in=carry_in, want_carry=True)

    def port(rows, carry_in, prev_gray):
        return kernels.directional_scan_group(
            t(cost[:, rows]), t(img[:, rows]), None, rolls, reverse, P1,
            P2_INIT, restart, carry_in=carry_in, want_carry=True,
            prev_gray=prev_gray)

    out_a, carry_a = port(upstream, None, None)
    want_a, jcarry_a = pallas(upstream, None, None)
    out_b, carry_b = port(downstream, carry_a, t(gray))
    want_b, jcarry_b = pallas(downstream, jcarry_a,
                              jnp.asarray(gray.astype(np.int32)))
    same(out_a, want_a)
    same(out_b, want_b)
    for got, want in zip(carry_a + carry_b, jcarry_a + jcarry_b):
        assert got.dtype == torch.int32
        same(got, want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [1, 16, 48])
def test_horizontal_partial_matches_pallas(d, shape, no_launch):
    """The horizontal pair, and the sum of the first design's two launches
    (``scan_directions``: what the card tests hold the group kernel against),
    stored and added onto a volume."""
    h, w = SHAPES[shape]
    cost, img = volume(64, h, w, d, cost_hi=128)
    want = pk.horizontal_partial(jnp.asarray(cost.astype(np.int8)),
                                 jnp.asarray(img.astype(np.int32)), P1,
                                 P2_INIT, False, block_rows=8)
    got = kernels.horizontal_partial(t(cost), t(img), P1, P2_INIT, False)
    assert got.dtype == torch.uint16
    same(got, want)
    pair = [d_ for d_ in aggregation.DIRECTIONS_8 if d_[0] == "h"]
    assert len(pair) == 2
    old = kernels.scan_directions(t(cost), t(img), pair, P1, P2_INIT)
    assert old.dtype == torch.uint16
    same(old, want)
    acc = torch.full(cost.shape, 7, dtype=torch.uint16)
    added = kernels.scan_directions(t(cost), t(img), pair, P1, P2_INIT,
                                    out=acc)
    assert added.data_ptr() == acc.data_ptr()
    same(added.int(), old.int() + 7)


# --- the layouts around the kernel ---------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_transposed_horizontal_pair_round_trips(shape, no_launch):
    """The main path's route, step by step: (B, H, D, W) -> (B, W, D, H), the
    pair as two column scans, and back."""
    h, w = SHAPES[shape]
    cost, img = volume(65, h, w, 16)
    cost_t = kernels.volume_transpose(t(cost))
    img_t = kernels.image_transpose(t(img))
    assert cost_t.shape == (B, w, 16, h) and cost_t.is_contiguous()
    assert img_t.shape == (B, w, h)
    same(img_t, img.transpose(0, 2, 1))
    same(kernels.volume_transpose(cost_t), cost)
    part_t = kernels.horizontal_pair_transposed(cost_t, img_t, P1, P2_INIT)
    assert part_t.dtype == torch.uint16 and part_t.shape == cost_t.shape
    same(kernels.volume_transpose(part_t),
         kernels.horizontal_partial_plain(t(cost), t(img), P1, P2_INIT, False))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_padded_transposed_volumes_round_trip(shape, no_launch):
    """The internal pitch of the transposed route: the (B, W, D, H') volumes
    are padded with zeros to ``TRANSPOSED_PITCH`` columns, the pair runs on
    them, and the way back drops the padding: the (B, H, D, W) result is the
    unpadded one."""
    h, w = SHAPES[shape]
    pitch = kernels.TRANSPOSED_PITCH
    hp = -(-h // pitch) * pitch
    cost, img = volume(66, h, w, 16)
    cost_t = kernels.volume_transpose(t(cost), pad_to=pitch)
    img_t = kernels.image_transpose(t(img), pad_to=pitch)
    assert cost_t.shape == (B, w, 16, hp) and cost_t.is_contiguous()
    assert img_t.shape == (B, w, hp)
    same(cost_t[..., :h], cost.transpose(0, 3, 2, 1))
    same(img_t[..., :h], img.transpose(0, 2, 1))
    assert not cost_t[..., h:].any() and not img_t[..., h:].any()
    same(kernels.volume_transpose(cost_t, inner=h), cost)
    part_t = kernels.horizontal_pair_transposed(cost_t, img_t, P1, P2_INIT)
    assert part_t.shape == cost_t.shape
    same(kernels.volume_transpose(part_t, inner=h),
         kernels.horizontal_partial_plain(t(cost), t(img), P1, P2_INIT, False))
    with pytest.raises(ValueError, match="inner"):
        kernels.volume_transpose(cost_t, inner=hp + 1)


@pytest.mark.parametrize("paths", [4, 8])
def test_scan_groups_partition_the_directions(paths):
    dirs = aggregation.DIRECTIONS_8 if paths == 8 else aggregation.DIRECTIONS_4
    grouped = [("v", reverse, roll)
               for rolls, reverse in kernels.scan_groups(paths)
               for roll in rolls]
    assert sorted(grouped) == sorted(d for d in dirs if d[0] == "v")
    assert all(len(rolls) <= kernels.MAX_GROUP
               for rolls, _ in kernels.scan_groups(paths))


@pytest.mark.parametrize("mode", ["wrap", "restart"])
@pytest.mark.parametrize("paths", [4, 8])
def test_groups_and_horizontal_pair_sum_to_aggregate_paths(paths, mode,
                                                           no_launch):
    """What the CUDA route of ``aggregate_paths`` launches, on the CPU."""
    h, w = SHAPES["odd"]
    cost, img = volume(66, h, w, 16)
    restart = mode == "restart"
    out = kernels.horizontal_partial(t(cost), t(img), P1, P2_INIT, restart)
    for rolls, reverse in kernels.scan_groups(paths):
        out = kernels.directional_scan_group(t(cost), t(img), out, rolls,
                                             reverse, P1, P2_INIT, restart)
    opt = from_jax(SGMOptions(num_paths=paths, max_disparity=16))
    same(out, aggregation.aggregate_paths(t(cost), t(img), opt, mode))


# --- the kernel's arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("p1,p2_init", [(10, 150), (0, 0), (7, 10_000),
                                        (300, 2_000), (255, 255)])
def test_p2_table_gives_the_step_its_integers(p1, p2_init):
    """The 256-entry table against the divide of ``_dp_step``, for every pair
    of gray values, up to the clamp (which no minimum can see)."""
    table = kernels.p2_table(p1, p2_init)
    assert table.shape == (256,)
    g = torch.arange(256)
    diff = (g[:, None] - g[None, :]).abs()
    want = torch.clamp(p2_init // (diff + 1), min=p1)
    same(table[diff], torch.clamp(want, max=kernels.P_CLAMP))
    assert int(table.max()) <= kernels.P_CLAMP


@pytest.mark.parametrize("p1,p2_init", [(10, 150), (0, 0), (7, 10_000),
                                        (300, 2_000), (255, 255)])
def test_packed_step_matches_dp_step_over_the_uint8_domain(p1, p2_init):
    """The two-lane step of the group kernel against ``_dp_step``: every
    value of L(d), of its neighbours and of the cost (0..255 each, the
    sentinels at both ends of D), every gray difference, penalties beyond
    255 included.  The subtraction of the minimum and the & 0xFF stay a
    wrap."""
    rng = np.random.default_rng(67)
    d, p = 256, 512
    # column j: L(d) runs over 0..255 along D, shifted by j, so that every
    # (L(d-1), L(d), L(d+1)) triple of a ramp and of noise occurs
    ramp = (np.arange(d)[:, None] + np.arange(p)[None, :]) % 256
    noise = rng.integers(0, 256, (d, p))
    for prev in (ramp, noise, np.full((d, p), 255), np.zeros((d, p), int)):
        prev = t(prev.astype(np.int32))
        prev_min = prev.amin(dim=0)
        cost = t(rng.integers(0, 256, (d, p)).astype(np.int32))
        gray = t(rng.integers(0, 256, p).astype(np.int32))
        prev_gray = t(((np.arange(p) // 2) % 256).astype(np.int32))
        want = aggregation._dp_step(prev, prev_min, prev_gray, cost, gray, p1,
                                    p2_init)
        got = kernels.packed_step_plain(prev, prev_min, prev_gray, cost, gray,
                                        p1, p2_init)
        same(got, want)
        assert int(got.max()) <= 255


def test_group_launch_refuses_negative_penalties():
    with pytest.raises(ValueError, match="penalties"):
        kernels._check_penalties(-1, 150)
    with pytest.raises(ValueError, match="penalties"):
        kernels._check_penalties(10, -5)
    kernels._check_penalties(0, 0)
