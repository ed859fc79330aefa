"""K1's whole-row width on the CPU: ``kernels.census_smem_bytes`` (the
transcription of ``smem_bytes`` in ``csrc/census_cost.cu``) and
``census_max_width``, the widest row one block holds whole; past it the
plan (``census_plan``, ``tests/test_torch_census_segments.py``) cuts rows
into segments, and no width is refused.  ``tests/test_torch_cuda.py``
finds where the segments start on the card by bisection."""

import re
from pathlib import Path

import pytest
import torch

from soc_project_stereo_matching_tpu_torch.ops import kernels

H100_OPTIN = 227 * 1024     # shared memory a block may opt in to on an H100
SOURCE = Path(kernels.__file__).resolve().parents[1] / "csrc" / "census_cost.cu"


def test_transcription_follows_the_kernel_source():
    """The constants the transcription copies are the kernel's, and the C
    entry that asks the card is the plan's (the old width limit's is
    gone)."""
    text = SOURCE.read_text()
    assert 'extern "C" int sgm_census_cost_plan(' in text
    assert "sgm_census_cost_max_width" not in text
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))
    assert "constexpr int kWarps = kThreads / 32;" in text
    assert kernels.CENSUS_WARPS == threads // 32
    body = text[text.index("__host__ inline size_t smem_bytes"):]
    body = body[:body.index("}")]
    assert "kWarps * lay.stage" in body
    assert "sizeof(int) * ((size_t)W + lay.right_pitch) + 10 * (size_t)W" in body
    assert "(W + 15 + 15) / 16 * 16" in text


@pytest.mark.parametrize("dmin,d", [(0, 64), (0, 192), (24, 128), (8, 40),
                                    (0, 1), (0, 256)])
def test_smem_bytes_is_about_26w_plus_4d(dmin, d):
    for w in (1, 2, 15, 16, 17, 450, 1242, 8900):
        extra = kernels.census_smem_bytes(w, dmin, d) - 26 * w - 4 * (dmin + d - 1)
        # the staging rows round w + 15 up to a multiple of 16, eight times
        assert 8 * 15 <= extra <= 8 * 30, (w, extra)
        assert kernels.census_smem_bytes(w + 1, dmin, d) > \
            kernels.census_smem_bytes(w, dmin, d)


@pytest.mark.parametrize("limit", [48 * 1024, 100_000, H100_OPTIN])
def test_max_width_is_the_last_row_that_fits(limit):
    """``census_max_width`` is the last row one block holds whole; the
    plan keeps it whole up to there and cuts the next one into
    segments."""
    for dmin, d in ((0, 64), (0, 192), (24, 128), (0, 256)):
        cap = kernels.census_max_width(dmin, d, limit)
        assert kernels.census_smem_bytes(cap, dmin, d) <= limit
        assert kernels.census_smem_bytes(cap + 1, dmin, d) > limit
        assert kernels.census_plan(cap, dmin, d, limit) == (1, cap, False)
        assert kernels.census_plan(cap + 1, dmin, d, limit).segmented


def test_h100_limits():
    """8,924 columns at D = 64 in one block (the wrapper's docstring), 8,817
    at D = 760 and 6,414 at D = 16,384; the KITTI-2015 frame (1242 columns,
    D = 192) is far inside; wider rows are segments, not refusals."""
    widths = {d: kernels.census_max_width(0, d, H100_OPTIN)
              for d in (64, 128, 192, 256, 760, 16384)}
    assert widths == {64: 8924, 128: 8913, 192: 8903, 256: 8896, 760: 8817,
                      16384: 6414}
    assert "8,924" in kernels.census_cost_volume.__doc__
    assert "segments" in kernels.census_cost_volume.__doc__


def test_cpu_wrapper_has_no_width_limit():
    """On the CPU the wrapper runs the plain version, which takes any
    width: the refusal belongs to the kernel."""
    img = torch.randint(0, 256, (1, 5, 9000), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    got = kernels.census_cost_volume(img, img, 0, 4)
    assert got.shape == (1, 5, 4, 9000)
    assert torch.equal(got, kernels.census_cost_volume_plain(img, img, 0, 4))
