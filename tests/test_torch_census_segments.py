"""K1's rows in segments on the CPU.

``kernels.census_cost_segments_plain`` computes the cost volume as the
segments of ``census_segment_kernel`` (csrc/census_cost.cu) do, each from
its own windows of the two images; here it is held against the JAX
package's ``census_cost_volume`` (jnp: ``census_5x5`` + ``hamming_cost_volume``,
and the Pallas entry in interpret mode) at segment widths that split the
row, untiled and in the tiled path's halo mode, at dmin < 0, 0 and > 0.
``census_plan``, the transcription of the kernel's plan, is held against
the constants of the source and the H100's shared memory.  The card runs
the kernel itself (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
11).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu.ops import census as j_census
from soc_project_stereo_matching_tpu.ops import cost_volume as j_cost
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu_torch import _build
from soc_project_stereo_matching_tpu_torch.ops import kernels

H, W, D = 9, 45, 12
H100_OPTIN = 227 * 1024     # shared memory a block may opt in to on an H100
SOURCE = _build.CSRC / "census_cost.cu"


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def jnp_volume(il, ir, dmin, dmax, halo):
    """The JAX package's jnp census and Hamming volume; in halo mode the
    census of the padded tile, its 2 halo rows on each side cropped."""
    cl, cr = (np.asarray(j_census.census_5x5(jnp.asarray(x))) for x in (il, ir))
    if halo:
        cl, cr = cl[:, 2:-2], cr[:, 2:-2]
    return np.asarray(j_cost.hamming_cost_volume(jnp.asarray(cl),
                                                 jnp.asarray(cr), dmin, dmax))


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("dmin", [-5, 0, 7])
def test_segments_match_jax(halo, dmin):
    """Segments of 1, 5, 16 and 17 columns (a row of 45: the last segment
    the rest) and the whole row equal the jnp volume and the Pallas entry,
    where w - d leaves the image on either side."""
    rng = np.random.default_rng(30 + dmin + 100 * halo)
    rows = H + 4 if halo else H
    il = rng.integers(0, 256, (2, rows, W), dtype=np.uint8)
    ir = rng.integers(0, 256, (2, rows, W), dtype=np.uint8)
    want = jnp_volume(il, ir, dmin, dmin + D, halo)
    same(want, pk.census_cost_volume_pallas(jnp.asarray(il), jnp.asarray(ir),
                                            dmin, dmin + D, block_rows=8,
                                            img_has_halo=halo))
    for seg in (1, 5, 16, 17, W):
        got = kernels.census_cost_segments_plain(t(il), t(ir), dmin, dmin + D,
                                                 halo, seg)
        assert got.dtype == torch.uint8 and got.shape == (2, H, D, W)
        same(got.numpy(), want)


def test_segments_at_a_range_wider_than_the_row():
    """D past W (every cost of some k-rows is the border's 127) and a
    segment narrower than the census window: still the jnp volume."""
    rng = np.random.default_rng(31)
    il = rng.integers(0, 256, (1, 6, 11), dtype=np.uint8)
    ir = rng.integers(0, 256, (1, 6, 11), dtype=np.uint8)
    for dmin, d in ((0, 20), (-12, 30), (3, 14)):
        want = jnp_volume(il, ir, dmin, dmin + d, False)
        for seg in (1, 3, 4):
            same(kernels.census_cost_segments_plain(
                t(il), t(ir), dmin, dmin + d, False, seg).numpy(), want)


def test_segment_plan_transcribes_the_source():
    """``census_segment_smem_bytes`` and ``census_plan`` copy the kernel's
    layout and rule: the staging rows, the left codes of a segment, the
    right codes of seg + D - 1 columns and both slabs with 2 columns on
    each side; one block a row while ``smem_bytes`` fits, else as few
    segments of equal width as fit."""
    text = SOURCE.read_text()
    body = text[text.index("__host__ inline size_t segment_smem_bytes"):]
    body = body[:body.index("}")]
    assert "const size_t reach = (size_t)seg + D - 1;" in body
    assert "(size_t)kWarps * segment_stage(seg)" in body
    assert ("sizeof(int) * ((size_t)seg + reach) + 5 * ((size_t)seg + 4) +"
            in body)
    assert "5 * (reach + 4)" in body
    assert "return (seg + 15 + 15) / 16 * 16;" in text
    plan = text[text.index("void plan(int W"):]
    plan = plan[:plan.index("\n}\n")]
    for line in ("*segmented = smem_bytes(W, dmin, D) > limit;",
                 "*nseg = (W + lo - 1) / lo;",
                 "*seg = (W + *nseg - 1) / *nseg;"):
        assert line in plan
    for seg in (1, 16, 4500):
        for d in (1, 64, 16384):
            reach = seg + d - 1
            assert kernels.census_segment_smem_bytes(seg, d) == (
                8 * ((seg + 30) // 16 * 16) + 4 * (seg + reach) +
                5 * (seg + 4) + 5 * (reach + 4))


@pytest.mark.parametrize("dmin,d", [(0, 64), (24, 64), (-5, 128), (0, 760),
                                    (0, 16384)])
def test_plan_takes_the_fewest_segments_that_fit(dmin, d):
    for w in (100, 8000, 8925, 9000, 20000, 40000, 70001):
        plan = kernels.census_plan(w, dmin, d, H100_OPTIN)
        whole = kernels.census_smem_bytes(w, dmin, d) <= H100_OPTIN
        assert plan.segmented == (not whole)
        if whole:
            assert plan == (1, w, False)
            continue
        assert plan.blocks * plan.columns >= w > (plan.blocks - 1) * plan.columns
        assert kernels.census_segment_smem_bytes(plan.columns, d) <= H100_OPTIN
        if plan.blocks > 1:      # one segment fewer would not fit
            assert kernels.census_segment_smem_bytes(
                -(-w // (plan.blocks - 1)), d) > H100_OPTIN


def test_h100_plans():
    """The H100's plans (227 KB a block): the widest whole row at D = 64
    is 8,924 columns, as before segments; then 2 segments of 4,500 at
    9,000 columns, 5 of 8,000 at 40,000; at D = 16,384 segments of up to
    3,262 columns; no plan only where not one column fits a block (D past
    25,000 at rows no block holds whole)."""
    assert kernels.census_max_width(0, 64, H100_OPTIN) == 8924
    plans = {w: kernels.census_plan(w, 24, 64, H100_OPTIN)
             for w in (9000, 20000, 40000)}
    assert plans == {9000: (2, 4500, True), 20000: (3, 6667, True),
                     40000: (5, 8000, True)}
    assert kernels.census_plan(7000, 0, 16384, H100_OPTIN) == (3, 2334, True)
    assert kernels._last_fit(lambda n: kernels.census_segment_smem_bytes(
        n, 16384), H100_OPTIN, 1 << 20) == 3262
    assert kernels.census_plan(30000, 0, 30000, H100_OPTIN).blocks == 0
    assert re.search(r"census_segments", kernels.census_cost_volume.__doc__)
