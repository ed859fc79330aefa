"""Disparity ranges above 256 and rows split over several clusters, on the
CPU.

The port's CPU engine and the plain versions that transcribe the kernels
against the JAX package, bit for bit: the engine against the JAX engine
(jnp and the Pallas path in interpret mode) at D = 257, 288 and 301; the
WTA kernel's online reduction, the group kernel's epilogue and its
two-order scan against the Pallas entries in interpret mode at D > 256; the
group kernel's decomposition of a row over several clusters
(``directional_scan_clusters_plain``) against the Pallas group entry; the
cluster count's transcription (``group_smem_bytes``, ``group_clusters``)
against the constants of csrc/aggregate.cu and the widest rows one cluster
takes on the card; ``cli eval`` on a Middlebury-2014 folder whose ndisp is
above 256 against the JAX harness.  Inputs are seeded with numpy; the card
runs the kernels themselves (``test_torch_cuda.py``, ``chip_smoke.py``
phase 10).
"""

import functools
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions
from soc_project_stereo_matching_tpu.eval import harness as j_harness
from soc_project_stereo_matching_tpu.models import sgm as j_sgm
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu_torch import SGMEngine, _build, cli
from soc_project_stereo_matching_tpu_torch.config import EngineConfig, from_jax
from soc_project_stereo_matching_tpu_torch.data import (convert, datasets,
                                                        synthetic)
from soc_project_stereo_matching_tpu_torch.ops import kernels

P1, P2_INIT = 10, 150
ROWS = 8                    # the Pallas entries' block_rows


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def same_planes(got, want):
    """(fwd, inv or None) WTAPlanes against a list of 5 or 10 planes."""
    flat = [p for view in got if view is not None for p in view]
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        same(g, w)


def padded(x, rows):
    """``x`` with zero rows after its scan axis (1) up to ``rows``: the
    Pallas entries take whole chunks of rows, and a zero row passes
    through a scan unchanged."""
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, rows - x.shape[1])
    return jnp.pad(jnp.asarray(x), pad)


def hp(h):
    return -(-h // ROWS) * ROWS


@pytest.fixture
def no_launch():
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


def seeded_pair(seed, h, w, shift):
    """A textured pair whose right image is the left shifted by ``shift``
    columns (wrapped), plus noise: most pixels match at ``shift``."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w), dtype=np.uint8)
    right = np.roll(left, -shift, axis=1).astype(np.int32)
    right = np.clip(right + rng.integers(-3, 4, (h, w)), 0, 255)
    return left, right.astype(np.uint8)


# --- the fault: the engine above 256 ---------------------------------------------

# (D, dmin, diagonal mode, paths, speckle area): each D; dmin 0 and 24, both
# modes and both path counts at least once.  The first is the JAX harness's
# engine for ``test_cli_eval_above_256_matches_jax_harness``'s folder (same
# options, same pair), so that its compiled program serves both tests.
ENGINE_CASES = [(257, 0, "wrap", 8, 50), (288, 24, "restart", 4, 8),
                (301, 0, "restart", 8, 8)]
H, W, SHIFT = 8, 300, 40


def engine_pair(d, dmin):
    return seeded_pair(5 if (d, dmin) == (257, 0) else d + dmin, H, W,
                       SHIFT if (d, dmin) == (257, 0) else dmin + 30)


@pytest.mark.parametrize("d,dmin,mode,paths,area", ENGINE_CASES)
def test_cpu_engine_matches_jax_above_256(d, dmin, mode, paths, area,
                                          no_launch):
    """The port's CPU engine equals the JAX engine, jnp and Pallas in
    interpret mode, where the port once refused D > 256."""
    left, right = engine_pair(d, dmin)
    opt = SGMOptions(max_disparity=dmin + d, min_disparity=dmin,
                     num_paths=paths, min_speckle_area=area)
    engine = SGMEngine(from_jax(opt), EngineConfig(diagonal_mode=mode),
                       device="cpu")
    got = engine.match(left, right).numpy()
    j_engine = j_sgm.SGMEngine(opt, j_sgm.EngineConfig(diagonal_mode=mode))
    same(got, j_engine.match(left, right))          # jnp on the CPU
    same(got, j_sgm.sgm_forward(jnp.asarray(left)[None],
                                jnp.asarray(right)[None], opt, mode,
                                use_pallas=True)[0])
    assert np.isfinite(got).mean() > 0.25


# --- the plain versions of the WTA and the epilogue above 256 ---------------------

@functools.lru_cache(maxsize=None)
def pallas_wta(d, dmin, seed):
    """(the volume, the Pallas WTA's 10 planes) of a seeded uint16 volume
    with many ties and real 65535 costs."""
    rng = np.random.default_rng(seed)
    aggr = rng.integers(0, 40, (1, 4, d, 24)).astype(np.uint16)
    aggr[0, 0, :, 3] = 65535
    aggr[0, 1, ::3, 10:] = 65535
    fwd, inv = pk.wta_reduce_pallas(
        jnp.asarray(aggr), SGMOptions(min_disparity=dmin,
                                      max_disparity=dmin + d))
    return aggr, [np.asarray(p) for p in list(fwd) + list(inv)]


@pytest.mark.parametrize("d,dmin", [(257, 24), (300, 0)])
def test_wta_plain_versions_match_pallas_above_256(d, dmin, no_launch):
    """The WTA kernel's online reduction (planes staged in chunks) and the
    group kernel's epilogue (strips of columns, chunks of planes merged in a
    tree) against the Pallas WTA, with strips and chunks narrower than the
    inverse view's reach (dmin + D - 1 columns, past the row's 24)."""
    aggr, want = pallas_wta(d, dmin, d)
    opt = from_jax(SGMOptions(min_disparity=dmin, max_disparity=dmin + d))
    for chunk in (16, 7):
        same_planes(kernels.wta_online_plain(t(aggr).to(torch.int32), opt,
                                             True, chunk), want)
    for strip, chunk in ((5, 9), (8, 64), (None, 8)):
        same_planes(kernels.wta_epilogue_plain(t(aggr).to(torch.int32), dmin,
                                               True, strip, chunk), want)


def test_plain_versions_refuse_only_above_16384():
    """D = 16,384 passes the range check (the JAX package's bound, the
    latch's: cost << 14 | k in an int32); D = 16,385 is refused with the
    JAX package's reason, by every plain version and kernel check."""
    kernels.check_range(kernels.MAX_RANGE)
    assert kernels.MAX_RANGE == 16384 == 1 << kernels.WTA_KEY_SHIFT
    assert 65535 << kernels.WTA_KEY_SHIFT | (kernels.MAX_RANGE - 1) < 2 ** 31
    deep = torch.zeros((1, 1, kernels.MAX_RANGE + 1, 2), dtype=torch.int32)
    opt = from_jax(SGMOptions(max_disparity=kernels.MAX_RANGE + 1))
    for call in (lambda: kernels.wta_online_plain(deep, opt),
                 lambda: kernels.wta_epilogue_plain(deep, 0),
                 lambda: kernels.check_range(0)):
        with pytest.raises(ValueError, match="argmin key"):
            call()
    with pytest.raises(ValueError, match="argmin key"):
        pk.wta_reduce_pallas(jnp.zeros((1, 1, kernels.MAX_RANGE + 1, 2),
                                       jnp.uint16), SGMOptions())


def test_two_order_scan_with_epilogue_matches_pallas_above_256(no_launch):
    """The two-order scan's plain version (two launches meeting at the
    middle row) with the epilogue at narrow strips and chunks, against the
    Pallas two-order entry in interpret mode at D = 261, dmin 5, restart."""
    d, h, w, dmin = 261, 5, 20, 5
    rng = np.random.default_rng(9)
    cost = rng.integers(0, 128, (1, h, d, w), dtype=np.uint8)
    img = rng.integers(0, 256, (1, h, w), dtype=np.uint8)
    acc = rng.integers(0, 900, (1, h, d, w)).astype(np.uint16)
    rolls_f, rolls_b = (0, 1, -1), (0, -1, 1)
    img32 = jnp.asarray(img.astype(np.int32))
    p2 = pk._stack_p2_fb(
        padded(pk._p2_planes(img32, rolls_f, +1, P1, P2_INIT), hp(h)),
        padded(pk._p2_planes(img32, rolls_b, -1, P1, P2_INIT), hp(h)))
    want = pk._directional_scan_group_bidir(
        padded(cost.astype(np.int8), hp(h)), p2, padded(acc, hp(h)), rolls_f,
        rolls_b, P1, True, ROWS, wta=(dmin, True))
    got = kernels.directional_scan_group_bidir_plain(
        t(cost), t(img), t(acc.copy()), rolls_f, rolls_b, P1, P2_INIT, True,
        (dmin, True), strip=6, chunk=40)
    same_planes(got, [np.asarray(p)[:, :h] for p in want])


# --- several clusters an image ------------------------------------------------

@functools.lru_cache(maxsize=None)
def pallas_group(s, rolls, reverse, restart):
    """(cost, image, the Pallas group entry's uint16 sum) at S rows."""
    rng = np.random.default_rng(40 + s)
    cost = rng.integers(0, 128, (2, s, 19, 53), dtype=np.uint8)
    img = rng.integers(0, 256, (2, s, 53), dtype=np.uint8)
    p2 = pk._p2_planes(jnp.asarray(img.astype(np.int32)), rolls,
                       -1 if reverse else 1, P1, P2_INIT)
    out = pk._directional_scan_group(
        padded(cost.astype(np.int8), hp(s)), padded(p2, hp(s)), None, rolls,
        reverse, P1, restart, ROWS)
    return cost, img, np.asarray(out)[:, :s]


@pytest.mark.parametrize("s", [1, 2, 40])
@pytest.mark.parametrize("clusters,blocks", [(2, 3), (3, 2), (2, 1)])
def test_cluster_decomposition_matches_pallas(s, clusters, blocks, no_launch):
    """A row over G clusters of CS blocks (uneven strips): the edge column
    and its chunks' partial minima handed over between blocks and, at a
    cluster's edge and at the wrap, between clusters through device memory;
    both orders of the 8-path group, one diagonal alone, wrap and restart."""
    for rolls, reverse, restart in (((0, 1, -1), False, False),
                                    ((0, -1, 1), True, True),
                                    ((-1,), False, True)):
        cost, img, want = pallas_group(s, rolls, reverse, restart)
        got = kernels.directional_scan_clusters_plain(
            t(cost), t(img), rolls, reverse, P1, P2_INIT, restart, clusters,
            blocks, chunk=5)
        same(got.to(torch.uint16), want)


def test_strip_bounds_share_the_pairs_out():
    """Every strip holds at least one column and starts on an even column;
    widths differ by at most a pair; the last strip ends at W."""
    for w, strips in ((53, 26), (2964, 96), (3400, 48), (1992, 48), (7, 4)):
        bounds = kernels.strip_bounds(w, strips)
        widths = np.diff(bounds)
        assert bounds[0] == 0 and bounds[-1] == w and (widths >= 1).all()
        assert all(b % 2 == 0 for b in bounds[:-1])
        assert widths[:-1].max() - widths[:-1].min() <= 2
    with pytest.raises(ValueError, match="empty"):
        kernels.directional_scan_clusters_plain(
            torch.zeros((1, 1, 2, 5), dtype=torch.uint8),
            torch.zeros((1, 1, 5), dtype=torch.uint8), (1,), False, P1,
            P2_INIT, False, 2, 2)


def test_cluster_count_transcribes_the_source():
    """``group_smem_bytes``' constants are csrc/aggregate.cu's, and its
    rule reproduces the widest rows one cluster takes as measured on an
    H100 (``group_capacity``'s docstring, ``tests/test_torch_cuda.py``):
    13,824 / 6,720 / 3,264 columns at D = 64 / 128 / 256 for one direction,
    12,288 / 6,912 / 3,328 with the epilogue.  Past them the row takes
    G >= 2 clusters; at full-resolution Middlebury (2,964 columns) D = 760
    takes 4 for one direction."""
    text = (_build.CSRC / "aggregate.cu").read_text()
    for name, value in (("kGroupSmem", kernels.GROUP_SMEM),
                        ("kGroupThreads", kernels.GROUP_THREADS),
                        ("kWtaThreads", kernels.GROUP_WTA_THREADS),
                        ("kMaxChunks", kernels.GROUP_MAX_CHUNKS),
                        ("kMaxStages", kernels.GROUP_MAX_STAGES),
                        ("kMaxCluster", kernels.GROUP_MAX_CLUSTER),
                        ("kRing", kernels.WTA_RING),
                        ("kMaxRange", kernels.MAX_RANGE)):
        assert re.search(rf"constexpr int {name} = (\d+);", text).group(1) \
            == str(value), name

    def widest(d, wta):
        lo, hi = 2, 1 << 17
        while hi - lo > 1:
            mid = (lo + hi) // 2
            fits = kernels.group_clusters(d, mid, 1, wta) == 1
            lo, hi = (mid, hi) if fits else (lo, mid)
        return lo

    doc = kernels.group_capacity.__doc__.replace(",", "")
    for d, one, epi in ((64, 13824, 12288), (128, 6720, 6912),
                        (256, 3264, 3328)):
        assert (widest(d, False), widest(d, True)) == (one, epi)
        assert str(one) in doc and str(epi) in doc
        assert kernels.group_clusters(d, one + 1, 1) == 2
    assert kernels.group_clusters(760, 2964, 1) == 4
    assert kernels.group_clusters(280, 1992, 1) == 1
    # the slab ring and two state buffers of strips of two columns: no
    # number of clusters holds D = 2,516 for one direction whole; clusters
    # whose blocks split D do (tests/test_torch_deep_range.py)
    assert kernels.group_clusters(2515, 4000, 1) is not None
    assert kernels.group_clusters(2516, 4000, 1) is None
    assert kernels.group_split(2516, 4000, 1, False, 16) is not None


# --- cli eval above 256 ------------------------------------------------------------

def test_cli_eval_above_256_matches_jax_harness(tmp_path, capsys, no_launch):
    """A Middlebury-2014 folder whose calib.txt says ndisp = 257: the port's
    ``cli eval`` (on the CPU) scores it as the JAX harness does."""
    h, w, ndisp = H, W, 257
    left, right = engine_pair(ndisp, 0)
    field = np.full((h, w), SHIFT)
    cal = datasets.synthetic_calib(w, h, fx=900.0, baseline=150.0, doffs=3.0)
    convert.pair_to_middlebury2014(synthetic.stereo_pair(
        "deep", left, right, field, cal, ndisp), tmp_path / "data" / "deep")
    stats_path = tmp_path / "s.json"
    assert cli.main(["eval", "--data", str(tmp_path / "data"), "--device",
                     "cpu", "--timing-repeats", "1", "--stats",
                     str(stats_path)]) == 0
    assert "FPS=" in capsys.readouterr().out
    got = json.loads(stats_path.read_text())["measurements"]
    want = j_harness.EvaluationHarness(
        SGMOptions(), j_harness.HarnessConfig(timing_iters=1,
                                              timing_repeats=1)).run(
        [tmp_path / "data" / "deep"])["measurements"]
    keys = ("name", "rmse_mm", "bpr", "n_valid", "me_mm", "b1m", "b1dm",
            "disp_bad3", "disp_avg_err", "disp_density", "valid_frac")
    np.testing.assert_equal([{k: m[k] for k in keys} for m in got],
                            [{k: m[k] for k in keys} for m in want])
    assert got[0]["valid_frac"] > 0.25 and got[0]["disp_bad3"] < 0.2
