"""The port's spatial-tiling path vs the JAX package, bit for bit (inf equal
to inf), in one process: the carried scans, the halo census, the in-place
median, and the tiled engine on a 1-rank mesh, plus the errors of the tiled
matcher.  Inputs are seeded numpy arrays; the Pallas entries run as
``test_pallas_kernels.py`` runs them on the CPU (interpret mode).  The
multi-rank runs are in ``test_torch_tiles_gloo.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions, oracle
from soc_project_stereo_matching_tpu.ops import aggregation as j_agg
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu.ops import postprocess as j_post
from soc_project_stereo_matching_tpu.parallel import mesh as j_mesh
from soc_project_stereo_matching_tpu.parallel import tiles as j_tiles
from soc_project_stereo_matching_tpu_torch import EngineConfig, SGMEngine
from soc_project_stereo_matching_tpu_torch.config import from_jax
from soc_project_stereo_matching_tpu_torch.data.synthetic import synthetic_pair
from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
from soc_project_stereo_matching_tpu_torch.ops import aggregation, kernels, postprocess
from soc_project_stereo_matching_tpu_torch.parallel.mesh import Mesh, make_mesh
from soc_project_stereo_matching_tpu_torch.parallel.tiles import make_tiled_matcher

H, W = 16, 64
OPTS = SGMOptions(max_disparity=16, min_speckle_area=8)     # the JAX package's
T_OPTS = from_jax(OPTS)                                     # the port's


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture
def no_launch():
    """The wrapped calls must stay on the plain path: no counter moves."""
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


# (a) the plain carried scan ---------------------------------------------------

@pytest.mark.parametrize("mode", ["wrap", "restart"])
@pytest.mark.parametrize("direction", j_agg.DIRECTIONS_8)
def test_carried_scan_chains_like_jax_and_the_unsplit_scan(direction, mode):
    """A (S, D, P) view split at a row: the downstream piece continues the
    upstream piece's carry.  Contributions and outgoing carries equal JAX's,
    and the chained pieces equal the unsplit scan."""
    _, reverse, roll = direction
    rng = np.random.default_rng(11)
    cost = rng.integers(0, 256, (13, 8, 11), dtype=np.uint8)
    img = rng.integers(0, 256, (13, 11), dtype=np.uint8)
    cut = 5
    pieces = [slice(0, cut), slice(cut, None)]
    if reverse:
        pieces.reverse()                  # a reverse chain starts at the end
    carry = jcarry = None
    got = {}
    for rows in pieces:
        contrib, carry = aggregation.directional_scan(
            t(cost[rows]), t(img[rows]), 10, 150, reverse, roll, mode, carry)
        want, jcarry = j_agg.directional_scan(
            jnp.asarray(cost[rows]), jnp.asarray(img[rows]), 10, 150, reverse,
            roll, mode, jcarry)
        same(contrib, want)
        for c, jc in zip(carry, jcarry):
            same(c, jc)
        got[rows.start] = contrib
    whole, whole_carry = aggregation.directional_scan(t(cost), t(img), 10, 150,
                                                      reverse, roll, mode)
    same(torch.cat([got[0], got[cut]]), whole)
    for c, wc in zip(carry, whole_carry):
        same(c, wc)


# (b) the group scan's carry mode ---------------------------------------------

@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("rolls,reverse", [((0, 1, -1), False),
                                           ((0, -1, 1), True)])
def test_group_scan_carry_mode_matches_pallas(rolls, reverse, restart,
                                              no_launch):
    """Two tiles of one image chained through the group scan's carry, with
    the upstream tile's boundary gray row for P2: equal to the Pallas entry
    (its P2 planes from ``_p2_planes(prev_row=...)``), carries included, and
    together equal to the unsplit group scan."""
    rng = np.random.default_rng(12)
    b, s, d, w = 2, 11, 16, 24
    cost = rng.integers(0, 256, (b, s, d, w), dtype=np.uint8)
    img = rng.integers(0, 256, (b, s, w), dtype=np.uint8)
    acc = rng.integers(0, 1000, (b, s, d, w)).astype(np.uint16)
    cut = 4
    upstream, downstream = slice(0, cut), slice(cut, None)
    if reverse:
        upstream, downstream = downstream, upstream
    edge = 0 if reverse else -1               # the upstream boundary row

    def pallas(rows, carry_in, prev_row):
        i32 = jnp.asarray(img[:, rows].astype(np.int32))
        p2 = pk._p2_planes(i32, rolls, -1 if reverse else 1, 10, 150,
                           prev_row=prev_row)
        return pk.directional_scan_group(
            jnp.asarray(cost[:, rows].astype(np.int8)), p2,
            jnp.asarray(acc[:, rows]), rolls, reverse, 10, restart,
            carry_in=carry_in, want_carry=True)

    def port(rows, carry_in, prev_gray):
        return kernels.directional_scan_group(
            t(cost[:, rows]), t(img[:, rows]), t(acc[:, rows].copy()), rolls,
            reverse, 10, 150, restart, carry_in=carry_in, want_carry=True,
            prev_gray=prev_gray)

    out_a, carry_a = port(upstream, None, None)
    want_a, jcarry_a = pallas(upstream, None, None)
    gray = img[:, upstream][:, edge]
    out_b, carry_b = port(downstream, carry_a, t(gray))
    want_b, jcarry_b = pallas(downstream, jcarry_a,
                              jnp.asarray(gray.astype(np.int32)))
    for got, want in ((out_a, want_a), (out_b, want_b)):
        assert got.dtype == torch.uint16
        same(got, want)
    for got, want in zip(carry_a + carry_b, jcarry_a + jcarry_b):
        assert got.dtype == torch.int32
        same(got, want)
    whole = kernels.directional_scan_group(t(cost), t(img), t(acc.copy()),
                                           rolls, reverse, 10, 150, restart)
    parts = {upstream.start or 0: out_a, downstream.start or 0: out_b}
    same(torch.cat([parts[k] for k in sorted(parts)], dim=1), whole)


@pytest.mark.parametrize("reverse", [False, True])
def test_zero_carry_is_carry_neutral(reverse, no_launch):
    """A zero carry-in gives the fresh scan, whatever P2 and the gray row:
    what mesh-edge tiles and pipeline bubbles rely on."""
    rng = np.random.default_rng(13)
    b, s, d, w = 2, 7, 8, 16
    cost, img = t(rng.integers(0, 256, (b, s, d, w), dtype=np.uint8)), \
        t(rng.integers(0, 256, (b, s, w), dtype=np.uint8))
    zeros = (torch.zeros((b, 3, d, w), dtype=torch.int32),
             torch.zeros((b, 3, 1, w), dtype=torch.int32))
    gray = t(rng.integers(0, 256, (b, w), dtype=np.uint8))
    for p2_init in (150, 10_000):
        fresh, fresh_carry = kernels.directional_scan_group(
            cost, img, None, (0, 1, -1), reverse, 10, p2_init, False,
            want_carry=True)
        got, carry = kernels.directional_scan_group(
            cost, img, None, (0, 1, -1), reverse, 10, p2_init, False,
            carry_in=zeros, prev_gray=gray)
        same(got, fresh)
        for c, fc in zip(carry, fresh_carry):
            same(c, fc)


# (c) the halo census -------------------------------------------------------------

@pytest.mark.parametrize("dmin,dmax", [(0, 16), (8, 56)])
def test_halo_census_matches_pallas(dmin, dmax, no_launch):
    rng = np.random.default_rng(14)
    il = rng.integers(0, 256, (2, H + 4, 53), dtype=np.uint8)
    ir = rng.integers(0, 256, (2, H + 4, 53), dtype=np.uint8)
    got = kernels.census_cost_volume(t(il), t(ir), dmin, dmax,
                                     img_has_halo=True)
    assert got.shape == (2, H, dmax - dmin, 53)
    same(got, pk.census_cost_volume_pallas(jnp.asarray(il), jnp.asarray(ir),
                                           dmin, dmax, block_rows=8,
                                           img_has_halo=True))
    # rows 2..H+1 of the untiled volume of the padded image are the same
    same(got, kernels.census_cost_volume(t(il), t(ir), dmin, dmax)[:, 2:H + 2])


# (d) the in-place median ---------------------------------------------------------

def test_inplace_median_matches_jax_and_the_oracle_pipeline():
    rng = np.random.default_rng(15)
    d = rng.integers(0, 8, (2, 23, 31)).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = np.inf
    got = postprocess.median_filter_3x3_inplace(t(d))
    same(got, j_post.median_filter_3x3_inplace(jnp.asarray(d)),
         np.stack([oracle.median_filter_3x3(x, inplace=True) for x in d]))
    assert not torch.equal(got, postprocess.median_filter_3x3(t(d)))
    left, right, _ = synthetic_pair(16, 2, 37, 53, (3, 6, 10))
    opt = dataclasses.replace(OPTS, median_inplace=True)
    same(sgm_forward(t(left), t(right), from_jax(opt)),
         np.stack([oracle.sgm_match(a, b, opt) for a, b in zip(left, right)]))


# (e) the tiled engine on a 1-rank mesh ------------------------------------------

@pytest.fixture(scope="module")
def pair():
    left, right, _ = synthetic_pair(17, 4, H, W, (3, 6, 10))
    return left, right


@pytest.mark.parametrize("mode", ["exact", "pipelined", "local"])
def test_one_rank_tiled_engine_matches_jax_and_untiled(pair, mode):
    left, right = pair
    want = j_tiles.make_tiled_matcher(OPTS, j_mesh.make_mesh(1, 1), H, W,
                                      cross_tile=mode)(left, right)
    untiled = SGMEngine(T_OPTS, device="cpu").match_batch(left, right)
    before = dict(kernels.LAUNCHES)
    for use_pallas in (True, False):
        engine = SGMEngine(T_OPTS, EngineConfig(tile_mode=mode,
                                                use_pallas=use_pallas),
                           device="cpu", mesh=make_mesh(1, 1))
        got = engine.match_batch(left, right)
        assert got.dtype == torch.float32 and got.shape == (4, H, W)
        same(got, want, untiled)
    assert kernels.LAUNCHES == before


def test_engine_caches_matchers_by_settings(pair):
    left, right = pair
    engine = SGMEngine(T_OPTS, EngineConfig(tile_mode="exact"), device="cpu",
                       mesh=make_mesh(1, 1))
    first = engine.match_batch(left, right)
    engine.match_batch(left[:2], right[:2])
    assert len(engine._matchers) == 1
    engine.options = dataclasses.replace(T_OPTS, median_inplace=True)
    inplace = engine.match_batch(left, right)
    assert len(engine._matchers) == 2 and not torch.equal(inplace, first)
    same(inplace, sgm_forward(t(left), t(right), engine.options))


# (f) errors ------------------------------------------------------------------

def test_tiled_matcher_errors(pair):
    left, right = t(pair[0]), t(pair[1])
    with pytest.raises(ValueError, match="not divisible by tile"):
        make_tiled_matcher(T_OPTS, Mesh(1, 3), H, W)
    with pytest.raises(ValueError, match="census halo"):
        make_tiled_matcher(T_OPTS, Mesh(1, 16), H, W)
    with pytest.raises(ValueError, match="cross_tile"):
        make_tiled_matcher(T_OPTS, make_mesh(1, 1), H, W, cross_tile="ring")
    matcher = make_tiled_matcher(T_OPTS, make_mesh(1, 1), H, W,
                                 cross_tile="pipelined", num_micro=3)
    with pytest.raises(ValueError, match="num_micro"):
        matcher(left, right)
    with pytest.raises(ValueError, match=r"\(B, 16, 64\)"):
        matcher(left[:, :8], right[:, :8])


def test_engine_and_mesh_errors():
    config = EngineConfig(tile_mode="exact")
    object.__setattr__(config, "tile_mode", "ring")     # past the dataclass
    with pytest.raises(ValueError, match="tile_mode"):
        SGMEngine(T_OPTS, config, device="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh(2, 2)
    with pytest.raises(ValueError):
        make_mesh(0, 1)
    mesh = make_mesh()                  # one process: the trivial mesh
    assert mesh.shape == {"data": 1, "tile": 1} and mesh.size == 1
