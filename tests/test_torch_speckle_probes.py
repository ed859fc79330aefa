"""The port's speckle probe path (``probes/speckle.py``, ``speckle_tail.py``)
vs the JAX package, bit for bit.

The plain PyTorch versions of S1-S4 define what the CUDA kernels compute, so
here each is held against the kernel body it stands for: the package's
``_speckle_labels_kernel`` and, loaded from ``scripts/``, the label variants
of ``speckle_probe.py`` and the histogram, verdict and fused kernels of
``speckle_tail_probe.py``, each through a ``pl.pallas_call`` in interpret
mode.  Round counts come from the same kernel bodies run eagerly on array
stand-ins for their refs (one write of the label plane per loop iteration).
All frames are small, every tolerance is zero.  The kernels themselves run
only on a card: ``test_torch_cuda.py``.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu.ops import postprocess as j_post
from soc_project_stereo_matching_tpu_torch.ops import kernels, postprocess
from soc_project_stereo_matching_tpu_torch.probes import speckle, speckle_tail
from soc_project_stereo_matching_tpu_torch.probes import kernels as probe_kernels

REPO = Path(__file__).resolve().parents[1]
MODES = ("base", "pair", "fori16", "block4", "pyr")
B = 4           # a multiple of block4's four frames


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sp = load_script("speckle_probe")
stp = load_script("speckle_tail_probe")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture
def no_launch():
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


def random_frames(seed, h, w, levels=5, holes=0.3):
    """Small-integer disparities with +inf holes: many components that
    touch, so the diagonal links and the round order matter."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, levels, (B, h, w)).astype(np.float32)
    d[rng.random((B, h, w)) < holes] = np.inf
    return d


def hard_frames(h=40, w=24, area=5):
    """Four frames of hard cases: a full-height line, components of exactly
    ``area`` and ``area - 1`` pixels, NaN and -inf pixels inside a region,
    a frame of a single smooth ramp, and a frame with no finite pixel."""
    rng = np.random.default_rng(7)
    d = np.full((B, h, w), np.inf, np.float32)
    d[0] = rng.integers(0, 6, (h, w)).astype(np.float32)
    d[0][rng.random((h, w)) < 0.55] = np.inf
    d[0, :, 9:12] = np.inf
    d[0, :, 10] = 3.0                       # full-height line, kept
    d[0, 19:26, 15:18] = np.inf
    d[0, 20:20 + area, 16] = 3.0            # exactly area: kept
    d[0, 29:36, 19:22] = np.inf
    d[0, 30:30 + area - 1, 20] = 3.0        # area - 1: removed
    d[1] = 2.0
    d[1, 5:9, 5:9] = np.nan                 # not finite: links nothing
    d[1, 20, :] = -np.inf                   # cuts the frame in two
    d[1, 30:33, 3:6] = np.inf
    d[1, 31, 4] = 7.0                       # a lone pixel in a hole
    d[2] = (np.arange(h)[:, None] * 0.5 + np.arange(w)[None, :] * 0.25)
    return d                                # d[3]: no finite pixel


def frames_of(name):
    return {"24x40": lambda: random_frames(60, 24, 40),
            "13x21": lambda: random_frames(61, 13, 21, levels=3, holes=0.2),
            "hard": hard_frames}[name]()


# --- the JAX side -----------------------------------------------------------------------

def j_labels(disp, mode, diff=1.0):
    """The JAX label kernel of ``mode`` through pallas_call, interpreted:
    the launches of scripts/speckle_probe.py ``build_labels_fn``."""
    b, h, w = disp.shape
    lo_bits = max(pk._ceil_log2(w), 7)
    gb = sp.GB if mode == "block4" else 1
    if mode == "base":
        body = functools.partial(pk._speckle_labels_kernel, h=h, w=w,
                                 diff=diff, lo_bits=lo_bits)
    else:
        body = functools.partial(sp._labels_kernel_variant, h=h, w=w,
                                 diff=diff, lo_bits=lo_bits, mode=mode)
    plane = pl.BlockSpec((gb, h, w), lambda bi: (bi, 0, 0))
    scratch = (gb, h, w) if mode == "block4" else (h, w)
    return pl.pallas_call(
        body, grid=(b // gb,), in_specs=[plane], out_specs=plane,
        out_shape=jax.ShapeDtypeStruct((b, h, w), jnp.int32),
        scratch_shapes=[pltpu.VMEM(scratch, jnp.int32)],
        interpret=True)(jnp.asarray(disp))


class ArrayRef:
    """An array standing in for a kernel ref; counts its writes."""

    def __init__(self, value):
        self.value = jnp.asarray(value)
        self.writes = 0

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)
        self.writes += 1


def j_rounds(disp, mode, monkeypatch, diff=1.0):
    """(labels, rounds per program) of the JAX kernel body of ``mode`` run
    eagerly: its loops become Python loops, and every iteration writes the
    label plane once (after the one write that initialises it)."""
    b, h, w = disp.shape
    lo_bits = max(pk._ceil_log2(w), 7)
    gb = sp.GB if mode == "block4" else 1
    monkeypatch.setattr(pk, "_roll", lambda x, s, axis: jnp.roll(x, s, axis))
    labels, rounds = [], []
    with jax.disable_jit():
        for p in range(b // gb):
            block = disp[p * gb:(p + 1) * gb]
            out = ArrayRef(jnp.zeros(block.shape, jnp.int32))
            mask = ArrayRef(jnp.zeros(block.shape if gb > 1 else (h, w),
                                      jnp.int32))
            if mode == "base":
                pk._speckle_labels_kernel(ArrayRef(block), out, mask, h=h, w=w,
                                          diff=diff, lo_bits=lo_bits)
            else:
                sp._labels_kernel_variant(ArrayRef(block), out, mask, h=h, w=w,
                                          diff=diff, lo_bits=lo_bits, mode=mode)
            labels.append(np.asarray(out.value))
            iterations = out.writes - 1
            rounds.append(iterations if mode in ("base", "pyr")
                          else 2 * iterations)      # an iteration is a pair
    return np.concatenate(labels), rounds


def j_group(disp, labels, area, pc):
    """The tail's input as scripts/speckle_tail_probe.py:203-212 builds it."""
    b, h, w = disp.shape
    lo_bits = max(pk._ceil_log2(w), 7)
    g, band, h_hist = pk._speckle_band_geometry(h, w, area, pc)
    n = h * w
    npad = pk._round_up(n, g * pc)
    sentinel = h_hist << lo_bits
    flat = jnp.where(jnp.isfinite(disp), labels, jnp.int32(sentinel))
    flat = jnp.pad(flat.reshape(b, n), ((0, 0), (0, npad - n)),
                   constant_values=sentinel)
    geometry = dict(g=g, pc=pc, band=band, lo_bits=lo_bits, a=area, w=w,
                    h_hist=h_hist)
    return flat.reshape(b, npad // (g * pc), 1, g * pc), geometry


def j_tail(lab_grp, geometry, area, int8):
    """(counts, root_small, two-launch verdict, fused verdict) of the JAX
    tail kernels, interpreted: the launches of speckle_tail_probe.py
    ``build_hist``, ``build_verdict`` and ``tail_fused``."""
    b, ngroups, _, chunk = lab_grp.shape
    h_hist, lo = geometry["h_hist"], 1 << geometry["lo_bits"]
    cdt = jnp.int32 if int8 else jnp.float32
    mdt = jnp.int8 if int8 else jnp.bfloat16
    grp = pl.BlockSpec((1, 1, 1, chunk), lambda bi, gi: (bi, gi, 0, 0))
    root = pl.BlockSpec((1, h_hist, lo), lambda bi, gi: (bi, 0, 0))
    verdict_shape = jax.ShapeDtypeStruct(lab_grp.shape, jnp.float32)
    counts = pl.pallas_call(
        functools.partial(stp._hist_kernel, int8=int8, **geometry),
        grid=(b, ngroups), in_specs=[grp], out_specs=root,
        out_shape=jax.ShapeDtypeStruct((b, h_hist, lo), cdt),
        interpret=True)(lab_grp)
    small = ((counts > 0) & (counts < area)).astype(mdt)
    verdict = pl.pallas_call(
        functools.partial(stp._verdict_kernel, int8=int8, **geometry),
        grid=(b, ngroups), in_specs=[grp, root], out_specs=grp,
        out_shape=verdict_shape, interpret=True)(lab_grp, small)
    grp2 = pl.BlockSpec((1, 1, 1, chunk),
                        lambda bi, gi: (bi, jax.lax.rem(gi, ngroups), 0, 0))
    fused = pl.pallas_call(
        functools.partial(stp._fused_kernel, ngroups=ngroups, min_area=area,
                          int8=int8, **geometry),
        grid=(b, 2 * ngroups), in_specs=[grp2], out_specs=grp2,
        out_shape=verdict_shape,
        scratch_shapes=[pltpu.VMEM((h_hist, lo), cdt),
                        pltpu.VMEM((h_hist, lo), mdt)],
        interpret=True)(lab_grp)
    return counts, small, verdict, fused


# --- (a) S1: the label kernel and its variants -------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("frames", ["24x40", "13x21", "hard"])
def test_labels_plain_matches_the_jax_kernel(frames, mode, no_launch):
    disp = frames_of(frames)
    got, rounds = probe_kernels.speckle_labels(t(disp), 1.0, mode)
    assert got.dtype == torch.int32 and got.shape == disp.shape
    assert rounds.dtype == torch.int32
    same(got.numpy(), j_labels(disp, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("frames", ["13x21", "hard"])
def test_labels_plain_runs_the_jax_kernels_rounds(frames, mode, no_launch,
                                                  monkeypatch):
    disp = frames_of(frames)
    got, rounds = probe_kernels.speckle_labels(t(disp), 1.0, mode)
    want, want_rounds = j_rounds(disp, mode, monkeypatch)
    same(got.numpy(), want)
    assert rounds.tolist() == want_rounds
    if mode == "fori16":
        assert want_rounds == [probe_kernels.FIXED_ROUNDS] * B


@pytest.mark.parametrize("frames", ["24x40", "hard"])
def test_exact_label_modes_agree_and_equal_the_union_find_roots(frames,
                                                                no_launch):
    disp = t(frames_of(frames))
    base, rounds = probe_kernels.speckle_labels(disp, 1.0, "base")
    for mode in speckle.EXACT:
        lab, r = probe_kernels.speckle_labels(disp, 1.0, mode)
        same(lab.numpy(), base.numpy())
        if mode == "pyr":
            assert r.tolist() == rounds.tolist()
    # K4's roots are flat batch indices: the same pixels, after the map
    roots = kernels.union_find_labels(disp, 1.0)
    assert roots.dtype == torch.int32
    same(probe_kernels.flat_to_root_labels(roots).numpy(), base.numpy())


def test_fori16_stops_short_of_the_fixed_point(no_launch):
    """A serpentine of 1-pixel corridors needs more than 16 rounds, so the
    unchecked variant returns labels that are no fixed point, and still
    the JAX kernel's after the same 16 rounds."""
    h, w = 33, 40
    d = np.full((B, h, w), np.inf, np.float32)
    d[:, ::2, :] = 1.0
    for r in range(1, h, 2):
        d[:, r, 0 if (r // 2) % 2 else w - 1] = 1.0
    base, rounds = probe_kernels.speckle_labels(t(d), 1.0, "base")
    got, _ = probe_kernels.speckle_labels(t(d), 1.0, "fori16")
    assert int(rounds.max()) > probe_kernels.FIXED_ROUNDS
    assert not torch.equal(got, base)
    same(got.numpy(), j_labels(d, "fori16"))
    same(base.numpy(), j_labels(d, "base"))


def test_label_wrapper_refuses_bad_arguments():
    disp = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="unknown mode"):
        probe_kernels.speckle_labels(disp, 1.0, "quad")
    with pytest.raises(ValueError, match="multiple"):
        probe_kernels.speckle_labels(disp, 1.0, "block4")
    with pytest.raises(TypeError):
        probe_kernels.speckle_labels(disp.double(), 1.0, "base")
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        probe_kernels.speckle_labels(disp.to("meta"), 1.0, "base")
    assert probe_kernels.label_bits(450) == 9 == max(pk._ceil_log2(450), 7)
    assert probe_kernels.label_bits(21) == 7
    assert probe_kernels.CC_OFFSETS == pk._CC_OFFSETS


# how S1's kernel decomposes a round: transcriptions held against the round

def frame_planes(frames):
    """(labels, link mask, big) of a frame set: labels scattered over
    0..big, so that every run and link is exercised."""
    disp = t(frames_of(frames))
    b, h, w = disp.shape
    big = h << probe_kernels.label_bits(w)
    rng = np.random.default_rng(5)
    lab = t(rng.integers(0, big, (b, h, w)).astype(np.int32))
    return lab, probe_kernels.link_mask(disp, 1.0), big


@pytest.mark.parametrize("length", [1, 2, 3, 8, 12, 64])
@pytest.mark.parametrize("frames", ["24x40", "13x21", "hard"])
def test_chunked_run_min_is_the_run_min(frames, length, no_launch):
    """``run_min_chunked`` (chunks along the axis, their summaries scanned,
    what enters each chunk from either end) equals ``_run_min``, the
    doubling run-min of the plain version, along rows and columns, at
    lengths from one pixel to longer than the axis."""
    lab, mask, big = frame_planes(frames)
    for axis, bit in ((-1, 0), (-2, 1)):
        same(probe_kernels.run_min_chunked(lab, mask, axis, big, length),
             probe_kernels._run_min(lab, probe_kernels._bit(mask, bit), axis,
                                    big))


@pytest.mark.parametrize("tile", [probe_kernels.TILE, (4, 8), (3, 5), (7, 3)])
@pytest.mark.parametrize("frames", ["24x40", "13x21", "hard"])
def test_tiled_fused_steps_are_the_whole_plane_steps(frames, tile, no_launch):
    """The fused steps on tiles with a halo of ``TILE_HALO`` (each step on
    all but the tile's outer ring) equal the whole-plane steps: all of
    ``cheap_round``, and the four diagonal steps of a seg round, at the
    kernel's tile and at tiles small enough to put many tile corners in
    each frame."""
    lab, mask, big = frame_planes(frames)
    same(probe_kernels.fused_steps_tiled(lab, mask, big, True, tile),
         probe_kernels.cheap_round(lab, mask, big))
    same(probe_kernels.fused_steps_tiled(lab, mask, big, False, tile),
         probe_kernels._diag_pass(lab, mask, big))


def test_fused_cheap_round_needs_its_halo_of_four(no_launch):
    """The cheap round's six steps reach three pixels, and a step skips the
    tile's outer ring, so a halo of three leaves wrong pixels at tile edges:
    the reason for ``TILE_HALO`` = 4.  On a flat frame every link is set."""
    mask = probe_kernels.link_mask(torch.zeros((2, 24, 40)), 1.0)
    big = 24 << probe_kernels.label_bits(40)
    rng = np.random.default_rng(6)
    lab = t(rng.integers(0, big, (2, 24, 40)).astype(np.int32))
    want = probe_kernels.cheap_round(lab, mask, big)
    assert not torch.equal(
        probe_kernels.fused_steps_tiled(lab, mask, big, True, (7, 3), 3), want)
    same(probe_kernels.fused_steps_tiled(lab, mask, big, True, (7, 3), 4), want)


@pytest.mark.parametrize("frames", ["24x40", "13x21", "hard"])
def test_kernel_rounds_reach_the_jax_kernels_labels(frames, no_launch):
    """Rounds as S1's kernel decomposes them (``kernel_round_plain``: the
    chunked run-mins along rows and columns, the fused steps on tiles),
    seg and cheap in turn to the fixed point, give the JAX label kernel's
    labels (pallas_call, interpreted) in the plain version's rounds; each
    round equals ``seg_round`` / ``cheap_round`` on the way."""
    disp = frames_of(frames)
    b, h, w = disp.shape
    mask = probe_kernels.link_mask(t(disp), 1.0)
    lo = probe_kernels.label_bits(w)
    big = h << lo
    lab = ((torch.arange(h, dtype=torch.int32)[:, None] << lo)
           | torch.arange(w, dtype=torch.int32)[None, :]).expand(b, h, w)
    lab = lab.contiguous()
    rounds = 0
    while True:
        seg = rounds % 2 == 0
        new = probe_kernels.kernel_round_plain(lab, mask, big, seg,
                                               tile=(8, 16))
        same(new, (probe_kernels.seg_round if seg
                   else probe_kernels.cheap_round)(lab, mask, big))
        rounds += 1
        if torch.equal(new, lab):
            break
        lab = new
    same(lab.numpy(), j_labels(disp, "base"))
    _, want_rounds = probe_kernels.speckle_labels(t(disp), 1.0, "base")
    assert rounds == int(want_rounds.max())


# --- (b) S2-S4: histogram, verdict, fused tail ------------------------------------------------

TAIL_CASES = {"banded": (lambda: hard_frames(120, 64, 5)[:2], 5, 256),
              "24x40": (lambda: random_frames(62, 24, 40)[:2], 8, 256)}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_plain_matches_the_jax_tail_kernels(case, int8, no_launch):
    make, area, pc = TAIL_CASES[case]
    disp = make()
    b, h, w = disp.shape
    labels, _ = probe_kernels.speckle_labels(t(disp), 1.0, "base")
    lab_grp, geometry = j_group(jnp.asarray(disp), jnp.asarray(labels.numpy()),
                                area, pc)
    if case == "banded":            # the band really is narrower than the frame
        assert geometry["band"] < geometry["h_hist"]
    grouped, h_hist, lo_bits = probe_kernels.group_labels(t(disp), labels, area,
                                                          pc)
    same(grouped.numpy(), lab_grp)
    assert (h_hist, lo_bits) == (geometry["h_hist"], geometry["lo_bits"])
    assert probe_kernels.speckle_band_geometry(h, w, area, pc) == \
        pk._speckle_band_geometry(h, w, area, pc)

    j_counts, j_small, j_verdict, j_fused = j_tail(lab_grp, geometry, area, int8)
    counts = probe_kernels.speckle_hist(grouped, h_hist, lo_bits)
    assert counts.dtype == torch.int32 and counts.shape == j_counts.shape
    same(probe_kernels.speckle_hist(grouped, h_hist, lo_bits, aggregate=True)
         .numpy(), counts.numpy())
    # the band keeps a count exact below min_area and >= min_area above
    same(counts.clamp(max=area).numpy(),
         np.minimum(np.asarray(j_counts).astype(np.int32), area))
    assert int(counts.sum()) == int(np.isfinite(disp).sum())
    small = probe_kernels.root_small(counts, area)
    assert small.dtype == torch.int8
    same(small.numpy() != 0, np.asarray(j_small.astype(jnp.float32)) != 0)
    verdict = probe_kernels.speckle_verdict(grouped, small)
    assert verdict.dtype == torch.float32 and verdict.shape == grouped.shape
    same(verdict.numpy(), j_verdict)
    for aggregate in (False, True):
        same(probe_kernels.speckle_tail_fused(grouped, area, h_hist, lo_bits,
                                              aggregate).numpy(), j_fused)
    same(verdict.numpy(), j_fused)


# --- (c) the verdict applied to the disparity ---------------------------------------------------

@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_verdict_gives_the_speckle_filter(case, no_launch, monkeypatch):
    make, area, pc = TAIL_CASES[case]
    disp = make()
    _, h, w = disp.shape
    labels, _ = probe_kernels.speckle_labels(t(disp), 1.0, "pyr")
    grouped, h_hist, lo_bits = probe_kernels.group_labels(t(disp), labels, area,
                                                          pc)
    verdict = probe_kernels.speckle_tail_fused(grouped, area, h_hist, lo_bits)
    got = probe_kernels.apply_verdict(
        t(disp), probe_kernels.ungroup_verdict(verdict, h, w)).numpy()
    monkeypatch.setattr(pk, "_SPECKLE_PC", pc)
    same(got, pk.remove_speckles_pallas(jnp.asarray(disp), 1.0, area))
    same(got, np.stack([np.asarray(j_post.remove_speckles(jnp.asarray(f), 1.0,
                                                          area)) for f in disp]))
    same(got, postprocess.remove_speckles(t(disp), 1.0, area).numpy())
    same(got, kernels.count_verdict(t(disp), kernels.union_find_labels(t(disp)),
                                    area).numpy())
    if case == "banded":
        assert np.isinf(got[0, 31, 20]) and not np.isinf(got[0, 22, 16])
        assert not np.isinf(got[0, -1, 10])


def test_tail_wrappers_refuse_bad_arguments():
    labels = torch.zeros((1, 1, 1, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        probe_kernels.speckle_hist(labels, 1 << 20, 12)
    with pytest.raises(ValueError):
        probe_kernels.speckle_tail_fused(labels, 5, 0, 7)
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        probe_kernels.speckle_hist(labels.to("meta"), 16, 7)
    # a label outside the root plane counts nowhere and is never small
    labels[0, 0, 0, :4] = torch.tensor([-1, 16 << 7, 5, 5])
    counts = probe_kernels.speckle_hist(labels, 16, 7)
    assert int(counts.sum()) == 62 and int(counts[0, 0, 5]) == 2
    verdict = probe_kernels.speckle_tail_fused(labels, 3, 16, 7)
    assert verdict[0, 0, 0, :4].tolist() == [0.0, 0.0, 1.0, 1.0]


def _hist_cases():
    """Hand-made grouped labels (B, ngroups, 1, chunk) for S2, on a root
    plane of 16 rows of 2^7 columns (2048 roots), and what the merged
    count's device-memory adds must be at most."""
    rng = np.random.default_rng(81)
    size, tile = 16 << 7, probe_kernels.HIST_TILE
    blocks = -(-3 * 1000 // tile)
    return {
        # one label fills each frame: one add per block
        "one label a frame": (np.full((2, 3, 1, 1000), 77), 2 * blocks),
        # two labels alternate: two adds per block
        "alternating": (np.tile([5, 9], (2, 3, 1, 500)), 2 * 2 * blocks),
        # sentinels, -1 and labels past the plane count nowhere
        "sentinels": (np.where(rng.random((2, 3, 1, 1000)) < 0.5,
                               rng.choice([-1, size, size + 7, 2 ** 31 - 1],
                                          (2, 3, 1, 1000)), 3), 2 * blocks),
        # runs of random lengths that cross quads, warps and blocks
        "runs": (np.repeat(rng.integers(0, 40, 200), rng.integers(1, 30, 200))
                 [:2 * 3 * 333].reshape(2, 3, 1, 333), None),
        # per_frame = 3 * 333, not a multiple of 4: a ragged tail
        "ragged": (rng.integers(0, 6, (1, 3, 1, 333)), None),
        # every label of a block distinct: the most keys a block's table
        # meets, half its slots
        "a block of distinct labels": (
            np.stack([rng.permutation(size)[:tile] for _ in range(2)])
            .reshape(2, 1, 1, tile), 2 * tile),
        "noise": (rng.integers(-3, size + 3, (2, 3, 1, 1000)), None),
    }


@pytest.mark.parametrize("case", list(_hist_cases()))
def test_hist_merge_matches_bincount(case):
    """S2's aggregated count as its kernel decomposes it (runs in a thread,
    the warp's runs merged at each quad position, a block's table, one add
    per distinct label of a block) against ``torch.bincount`` (the plain
    version), and the adds it makes."""
    labels, most_adds = _hist_cases()[case]
    labels = t(labels.astype(np.int32))
    got, adds, most = probe_kernels.speckle_hist_merge_plain(labels, 16, 7)
    same(got.numpy(), probe_kernels.speckle_hist_plain(labels, 16, 7).numpy())
    flat = labels.reshape(labels.shape[0], -1).numpy()
    valid = (flat >= 0) & (flat < 16 << 7)
    assert int(got.sum()) == int(valid.sum())
    if most_adds is not None:
        assert adds <= most_adds
    assert most <= probe_kernels.HIST_TILE <= probe_kernels.HIST_SLOTS // 2


# S4 as its kernel decomposes it: (resident blocks, threads a block).  The
# card's: 132 blocks of 1024 threads on an NVIDIA H100.  Smaller grids make
# small frames split across blocks and into rounds.
S4_GRIDS = {"card": (132, probe_kernels.TAIL_THREADS), "small": (9, 64),
            "tiny": (4, 32)}


def _check_s4_blocks(labels, area, h_hist, lo_bits, grid, aggregate):
    """S4's decomposition against the plain tail; every label written, and
    the device-memory traffic it promises: one zero and one add per
    distinct label of a block and round (aggregated), a table that holds
    every key of its block.  -> (verdict, stats)."""
    resident, threads = S4_GRIDS[grid]
    got, stats = probe_kernels.speckle_tail_blocks_plain(
        labels, area, h_hist, lo_bits, resident, aggregate, threads)
    assert got.dtype == torch.float32 and got.shape == labels.shape
    assert not torch.isnan(got).any()             # every label written
    same(got.numpy(), probe_kernels.speckle_tail_fused_plain(
        labels, area, h_hist, lo_bits).numpy())
    for rec in stats:
        assert rec["held"] <= probe_kernels.TAIL_QUADS
        assert rec["labels"] <= 4 * probe_kernels.TAIL_QUADS * threads
        if aggregate:
            assert rec["zeros"] == rec["adds"] == rec["distinct"]
            assert rec["distinct"] <= rec["labels"] <= rec["slots"]
        else:
            assert rec["zeros"] == rec["adds"] >= rec["distinct"]
    if labels.numel():
        b, per_frame = labels.shape[0], labels[0].numel()
        assert len(stats) == resident * probe_kernels.tail_plan(
            b, per_frame, resident, threads)[2]
        valid = (labels >= 0) & (labels < h_hist << lo_bits)
        assert sum(r["labels"] for r in stats) == labels.numel()
        assert sum(r["table_adds"] if aggregate else r["adds"]
                   for r in stats) <= int(valid.sum())
    return got, stats


@pytest.mark.parametrize("aggregate", [True, False], ids=["merged", "per_pixel"])
@pytest.mark.parametrize("grid", ["card", "small"])
@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_blocks_plain_matches_the_jax_fused_kernel(case, grid, aggregate,
                                                        no_launch):
    """S4's decomposition (blocks, their tables, the keys zeroed, one add
    per distinct key, the verdict) against the JAX ``_fused_kernel`` in
    interpret mode and the plain tail, on the grouped labels of S1."""
    make, area, pc = TAIL_CASES[case]
    disp = make()
    labels, _ = probe_kernels.speckle_labels(t(disp), 1.0, "base")
    lab_grp, geometry = j_group(jnp.asarray(disp), jnp.asarray(labels.numpy()),
                                area, pc)
    grouped, h_hist, lo_bits = probe_kernels.group_labels(t(disp), labels, area,
                                                          pc)
    got, stats = _check_s4_blocks(grouped, area, h_hist, lo_bits, grid,
                                  aggregate)
    same(got.numpy(), j_tail(lab_grp, geometry, area, True)[3])
    # a frame's labels split across blocks
    assert sum(1 for r in stats if r["round"] == 0 and r["labels"]) > 1
    if case == "banded" and grid == "small":    # a round a frame
        assert max(r["round"] for r in stats) == 1


@pytest.mark.parametrize("grid", ["card", "small"])
def test_tail_blocks_plain_matches_the_jax_fused_kernel_on_outside_labels(
        grid, no_launch):
    """The same on S1's grouped labels of the banded frames with labels
    outside the root plane written in: the sentinel, labels past it and
    negative ones count nowhere and are never small."""
    make, area, pc = TAIL_CASES["banded"]
    disp = make()
    labels, _ = probe_kernels.speckle_labels(t(disp), 1.0, "base")
    _, geometry = j_group(jnp.asarray(disp), jnp.asarray(labels.numpy()),
                          area, pc)
    grouped, h_hist, lo_bits = probe_kernels.group_labels(t(disp), labels, area,
                                                          pc)
    rng = np.random.default_rng(5)
    size = h_hist << lo_bits
    at = torch.from_numpy(rng.choice(grouped.numel(), 300, replace=False))
    grouped.view(-1)[at] = torch.from_numpy(rng.choice(
        [size, size + 9, 2 ** 31 - 1, -1, -7], 300).astype(np.int32))
    got, _ = _check_s4_blocks(grouped, area, h_hist, lo_bits, grid, True)
    same(got.numpy(), j_tail(jnp.asarray(grouped.numpy()), geometry, area,
                             True)[3])
    assert not got.view(-1)[at].any()


def _s4_cases():
    """Hand-made grouped labels (B, ngroups, 1, chunk) on a root plane of 16
    rows of 2^7 columns (2048 roots), ``min_area`` 5."""
    rng = np.random.default_rng(83)
    size = 16 << 7
    runs = np.repeat(rng.integers(0, 60, 1000), rng.integers(1, 12, 1000))
    return {
        # the sentinel, labels past the plane and negative ones count
        # nowhere and are never small
        "sentinels": np.where(rng.random((3, 2, 1, 500)) < 0.4,
                              rng.choice([-1, -7, size, size + 9, 2 ** 31 - 1],
                                         (3, 2, 1, 500)),
                              rng.integers(0, 9, (3, 2, 1, 500))),
        # a frame length that is no multiple of 4: quads cross frames
        "ragged": runs[:3 * 1 * 333].reshape(3, 1, 1, 333),
        # runs across quads, threads and blocks; frames split across blocks
        "runs": runs[:4 * 2 * 400].reshape(4, 2, 1, 400),
        # one label for every frame
        "one label": np.full((2, 3, 1, 256), 77),
        # every label of a frame distinct: the most keys a table meets
        "distinct": np.stack([rng.permutation(size)[:1536] for _ in range(2)])
                    .reshape(2, 3, 1, 512),
        # components of exactly min_area and min_area - 1 pixels
        "areas": np.concatenate([np.full(5, 3), np.full(4, 8), np.arange(20, 29),
                                 np.full(6, size)])[None, None, None, :]
                    .repeat(2, 0),
    }


@pytest.mark.parametrize("aggregate", [True, False], ids=["merged", "per_pixel"])
@pytest.mark.parametrize("grid", ["card", "tiny"])
@pytest.mark.parametrize("case", list(_s4_cases()))
def test_tail_blocks_plain_on_hand_made_labels(case, grid, aggregate,
                                               no_launch):
    labels = t(_s4_cases()[case].astype(np.int32))
    got, stats = _check_s4_blocks(labels, 5, 16, 7, grid, aggregate)
    if case == "areas":
        assert got[0, 0, 0, :5].tolist() == [0.0] * 5         # 5: kept
        assert got[0, 0, 0, 5:9].tolist() == [1.0] * 4        # 4: removed
        assert got[0, 0, 0, -6:].tolist() == [0.0] * 6         # the sentinel
    if case == "sentinels":
        outside = (labels < 0) | (labels >= 16 << 7)
        assert not got[outside].any()


def test_tail_blocks_plain_on_an_empty_batch(no_launch):
    labels = torch.zeros((0, 2, 1, 64), dtype=torch.int32)
    got, stats = probe_kernels.speckle_tail_blocks_plain(labels, 5, 16, 7, 132)
    assert got.shape == labels.shape and stats == []
    assert probe_kernels.speckle_tail_fused(labels, 5, 16, 7).shape == \
        labels.shape


@pytest.mark.parametrize("b,per_frame,want", [
    (2, 186368, (132, 2, 1, 13)),           # cone B=2: one round
    (8, 186368, (132, 8, 1, 14)),           # cone B=8
    (32, 186368, (132, 11, 3, 14)),         # cone B=32: rounds of frames
    (1, 1507328, (132, 1, 1, 14)),          # Middlebury-half
    (4, 2048, (132, 4, 1, 7)),              # 37x45
    (3, 132 * 16384 - 8, (132, 1, 3, 14)),  # the largest frame a round takes
])
def test_tail_plan_rounds_of_whole_frames(b, per_frame, want):
    """Rounds of whole frames, no block given more labels than its threads
    hold, and a table with a slot for each of them."""
    assert probe_kernels.tail_plan(b, per_frame, 132) == want
    blocks, frames, rounds, bits = want
    most = blocks * 4 * probe_kernels.TAIL_QUADS * probe_kernels.TAIL_THREADS
    assert frames * per_frame <= most - 8
    assert (rounds - 1) * frames < b <= rounds * frames
    share = -(-((frames * per_frame + 6) // 4 + 1) // blocks)  # quads
    assert 4 * share <= min(1 << bits, most // blocks)


def test_tail_plan_refuses_a_frame_larger_than_a_round():
    with pytest.raises(ValueError, match="more than one round"):
        probe_kernels.tail_plan(1, 132 * 16384 - 7, 132)
    with pytest.raises(ValueError, match="no S4 block"):
        probe_kernels.tail_plan(1, 64, 0)


# --- (d) the probe modules ------------------------------------------------------------------------

SMALL = dict(device="cpu", batch=4, h=24, w=40, dmax=16, reps=1)
HEAD = {"probe", "timestamp", "device", "card", "power_limit", "reps", "batch",
        "h", "w", "d", "input", "summary", "variants"}


@pytest.mark.parametrize("probe,variants,extra_keys", [
    (speckle, {"prod", "base", "pair", "fori16", "block4", "pyr"},
     {"finite_fraction"}),
    (speckle_tail,
     {"prod", "prod_whole", "base", "base_agg", "hist_only", "hist_only_agg",
      "verdict_only", "fused", "fused_agg"},
     {"min_area", "geometry", "largest_component", "checked"}),
])
def test_speckle_probe_run_on_cpu_returns_its_schema_untimed(
        probe, variants, extra_keys, no_launch):
    doc = probe.run(**SMALL)
    json.dumps(doc)
    assert set(doc) == HEAD | extra_keys
    assert doc["device"] == "cpu" and doc["card"] is None
    assert set(doc["variants"]) == variants
    # a CPU run states no device time
    assert all(rec["ms_per_frame"] is None and rec["ms_per_call"] is None
               for rec in doc["variants"].values())
    assert all(v is None or isinstance(v, str)
               for v in doc["summary"].values())
    assert "not measured" in probe.report(doc)
    if probe is speckle:
        recs = doc["variants"]
        assert all(recs[m]["bit_equal_labels"] for m in speckle.EXACT + ("prod",))
        assert recs["pyr"]["rounds"] == recs["base"]["rounds"]
        assert len(recs["block4"]["rounds"]) == 1
        assert recs["fori16"]["rounds"] == [16] * 4


def test_speckle_probes_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for probe in (speckle, speckle_tail):
        with pytest.raises(RuntimeError, match="need a CUDA device"):
            probe.run()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for name in ("speckle", "speckle_tail"):
        proc = subprocess.run(
            [sys.executable, "-m", "soc_project_stereo_matching_tpu_torch.probes",
             name], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode != 0 and "needs a CUDA device" in proc.stderr
        assert "wrote" not in proc.stdout


# --- the repair: no entry point falls to the CPU unasked ------------------------------------------

def test_multi_rank_entry_points_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from soc_project_stereo_matching_tpu_torch.parallel import dryrun, multihost

    with pytest.raises(RuntimeError, match="2 cards"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize("tcp://127.0.0.1:29999", 2, 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        dryrun.dryrun_multichip(2, device="meta")
    with pytest.raises(SystemExit):
        dryrun.main(["2", "--device", "gloo"])
