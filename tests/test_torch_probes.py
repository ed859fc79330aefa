"""The port's probe path (``probes/``) vs the JAX package, bit for bit.

The probe kernels' plain PyTorch versions define what the CUDA kernels
compute, so here each is held against the body of the JAX script's kernel it
stands for.  Those bodies are closures inside ``main()`` functions that
assert a TPU, so they cannot be imported: they are transcribed below on jnp
arrays, with ``jnp.roll`` for ``pk._roll``, line for line.  Where a Pallas
entry exists in the package (``horizontal_partial``, the group scan) it runs
in interpret mode, as ``test_torch_kernels.py`` runs the others.  All sizes
are small and every tolerance is zero.  The kernels themselves run only on a
card: ``test_torch_cuda.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions
from soc_project_stereo_matching_tpu.ops import aggregation as j_agg
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu_torch import config
from soc_project_stereo_matching_tpu_torch.data.synthetic import synthetic_pair
from soc_project_stereo_matching_tpu_torch.ops import kernels
from soc_project_stereo_matching_tpu_torch.probes import (
    ablation, aggr_transpose, int16_recurrence, recurrence_floor)
from soc_project_stereo_matching_tpu_torch.probes import kernels as probe_kernels

REPO = Path(__file__).resolve().parents[1]
B, D, P = 2, 16, 24
P1, P2_INIT = 10, 150
GROUP = (0, 1, -1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture
def no_launch():
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


def seeds(rng, uniform_along_p: bool):
    """uint16 (B, D, P) chain inputs.  With diagonals the scripts' cost row
    belongs to a column and the port's to a path (``per_path`` in the
    transcriptions below); they are one function where the bit that enters
    it does not vary along P."""
    x = rng.integers(0, 65536, (B, D, P)).astype(np.uint16)
    if uniform_along_p:
        x = (x & 0xFFFE) | rng.integers(0, 2, (B, D, 1)).astype(np.uint16)
    return x


# --- transcriptions of the JAX scripts' kernel bodies --------------------------------

def j_chain_state(x, steps, rolls, p1, per_path=False):
    """scripts/recurrence_floor.py ``chain_kernel``: its cost and P2 rows
    (:128-134) and its step (:136-152), for one image; returns the carried
    (cost, min) of every direction.  ``per_path`` is the port's departure
    for diagonals: the seed bit of the cost row is that of the path's first
    pixel, so its plane is rolled along with the state."""
    d, w = x.shape
    sentinel = jnp.int32(pk.SENTINEL)
    d_iota = jax.lax.broadcasted_iota(jnp.int32, (d, w), 0)
    seed = [(x & 1).astype(jnp.int32) for _ in rolls]
    p2_row = jnp.full((1, w), 150, jnp.int32)
    carry_cost = [jnp.zeros((d, w), jnp.int32) for _ in rolls]
    carry_min = [jnp.zeros((1, w), jnp.int32) for _ in rolls]
    for s in range(steps):
        for k, roll in enumerate(rolls):
            prev = carry_cost[k]
            pmin = carry_min[k]
            if roll:
                prev = jnp.roll(prev, roll, axis=1)
                pmin = jnp.roll(pmin, roll, axis=1)
                if per_path and s > 0:
                    seed[k] = jnp.roll(seed[k], roll, axis=1)
            cost_row = ((d_iota * 7 + 13) & 0x7F) ^ seed[k]
            up = jnp.where(d_iota == 0, sentinel, jnp.roll(prev, 1, axis=0))
            dn = jnp.where(d_iota == d - 1, sentinel, jnp.roll(prev, -1, axis=0))
            m = jnp.minimum(jnp.minimum(prev, jnp.minimum(up, dn) + p1),
                            pmin + p2_row)
            cs = (cost_row + m - pmin) & 0xFF
            carry_cost[k] = cs
            carry_min[k] = jnp.min(cs, axis=0, keepdims=True)
    return carry_cost, carry_min


def j_chainio(x, cost_vol, p2_vol, steps, rolls, extra_u16, p1,
              per_path=False):
    """scripts/recurrence_floor.py ``chainio_kernel`` (:205-245) for one
    image, its scratch volumes given (the output volume starts at zero).
    ``per_path`` is the port's departure for several directions: the seed
    plane is rolled along with a diagonal's state, and every direction
    read-adds and stores an output volume of its own (a direction is a warp
    there), the result row being their sum."""
    d, w = x.shape
    sentinel = jnp.int32(pk.SENTINEL)
    d_iota = jax.lax.broadcasted_iota(jnp.int32, (d, w), 0)
    seed = [(x & 1).astype(jnp.int32) for _ in rolls]
    out_vols = [jnp.zeros((steps, d, w), jnp.uint16)
                for _ in (rolls if per_path else rolls[:1])]
    carry_cost = [jnp.zeros((d, w), jnp.int32) for _ in rolls]
    carry_min = [jnp.zeros((1, w), jnp.int32) for _ in rolls]
    for s in range(steps):
        totals = []
        for k, roll in enumerate(rolls):
            prev = carry_cost[k]
            pmin = carry_min[k]
            if roll:
                prev = jnp.roll(prev, roll, axis=1)
                pmin = jnp.roll(pmin, roll, axis=1)
                if per_path and s > 0:
                    seed[k] = jnp.roll(seed[k], roll, axis=1)
            cost_row = (cost_vol[s] ^ seed[k]) & 0xFF
            p2_row = p2_vol[k, s:s + 1].astype(jnp.int32)
            up = jnp.where(d_iota == 0, sentinel, jnp.roll(prev, 1, axis=0))
            dn = jnp.where(d_iota == d - 1, sentinel, jnp.roll(prev, -1, axis=0))
            m = jnp.minimum(jnp.minimum(prev, jnp.minimum(up, dn) + p1),
                            pmin + p2_row)
            cs = (cost_row + m - pmin) & 0xFF
            carry_cost[k] = cs
            carry_min[k] = jnp.min(cs, axis=0, keepdims=True)
            totals.append(cs)
        if not per_path:
            totals = [sum(totals)]
        for i, total in enumerate(totals):
            for e in range(extra_u16):
                total = total + (out_vols[i][s].astype(jnp.int32) + e)
            out_vols[i] = out_vols[i].at[s].set(total.astype(jnp.uint16))
    return sum(v[steps - 1] for v in out_vols) \
        + carry_cost[0].astype(jnp.uint16)


def j_rung(name, c):
    """scripts/mosaic_int16_probe.py rung bodies (:53-150) on an int8
    (rows, W) plane; int16 arithmetic as there."""
    x = c.astype(jnp.int16) & 0xFF
    d, w = x.shape
    if name == "p0":
        r = x
    elif name == "p1":
        r = x + jnp.roll(x, 1, axis=1)
    elif name == "p2":
        r = x + jnp.roll(x, 2, axis=0)
    elif name == "p3":
        r = x + jnp.roll(x, 1, axis=0)
    elif name == "p4":
        d_iota = jax.lax.broadcasted_iota(jnp.int32, (d, w), 0)
        r = jnp.where(d_iota == 0, jnp.asarray(pk.SENTINEL, jnp.int16),
                      jnp.roll(x, 1, axis=0))
    elif name in ("p5", "p5b"):
        scratch = jnp.zeros((1, w), jnp.int16)
        rows = []
        for s in range(d):
            xs = x[s:s + 1]
            scratch = scratch + xs if name == "p5b" \
                else jnp.minimum(scratch, xs + 1)
            rows.append(xs + scratch)
        r = jnp.concatenate(rows, axis=0)
    elif name == "p6":
        cm, shift = x, 1
        while shift < d:
            cm = jnp.minimum(cm, jnp.roll(cm, shift, axis=0))
            shift *= 2
        r = x + cm
    elif name == "p8":
        r = jnp.minimum(x, jnp.roll(x, 1, axis=1))
    elif name == "p9":
        y = jnp.roll(x, 1, axis=1)
        r = jnp.where(x < y, x, y)
    elif name == "p10":
        y = jnp.roll(x, 1, axis=1)
        diff = x - y
        r = y + (diff & (diff >> 15))
    return r.astype(jnp.uint16)


# --- (a) the recurrence floor --------------------------------------------------------

@pytest.mark.parametrize("rolls,steps", [((0,), 9), ((0,), 12), (GROUP, 8),
                                         (GROUP, 11)])
def test_chain_plain_matches_the_script_step(rolls, steps, no_launch):
    x = seeds(np.random.default_rng(40), uniform_along_p=len(rolls) > 1)
    got = probe_kernels.chain(t(x), steps, rolls, P1)
    assert got.dtype == torch.uint16 and got.shape == (B, D, P)
    for b in range(B):
        cost, cmin = j_chain_state(jnp.asarray(x[b]), steps, rolls, P1)
        # the port's row keeps every direction's chain live: it sums them
        want = sum(c + m for c, m in zip(cost, cmin)).astype(jnp.uint16)
        same(got[b].numpy(), want)
        if len(rolls) == 1:         # the script's own row (direction 0 only)
            same(got[b].numpy(), (cost[0] + cmin[0]).astype(jnp.uint16))


@pytest.mark.parametrize("steps", [8, 11])
def test_chain_plain_diagonals_carry_their_seed(steps, no_launch):
    """Seeds that vary along P: the port's cost row is the path's, the
    script's the column's, and the straight direction knows no difference."""
    x = seeds(np.random.default_rng(48), uniform_along_p=False)
    got = probe_kernels.chain(t(x), steps, GROUP, P1)
    differs = False
    for b in range(B):
        cost, cmin = j_chain_state(jnp.asarray(x[b]), steps, GROUP, P1,
                                   per_path=True)
        same(got[b].numpy(), sum(c + m for c, m in zip(cost, cmin))
             .astype(jnp.uint16))
        by_col = j_chain_state(jnp.asarray(x[b]), steps, GROUP, P1)
        same(cost[0], by_col[0][0])
        differs |= not np.array_equal(cost[1], by_col[0][1])
    assert differs


@pytest.mark.parametrize("extra", [0, 1, 2])
def test_chainio_plain_diagonals_carry_their_seed(extra, no_launch):
    rng = np.random.default_rng(49)
    steps = 10
    x = seeds(rng, uniform_along_p=False)
    cost = rng.integers(0, 256, (B, steps, D, P)).astype(np.int32)
    p2 = rng.integers(P1, P2_INIT + 1, (B, 3, steps, P)).astype(np.int32)
    got = probe_kernels.chainio(t(x), t(cost), t(p2), steps, GROUP, extra, P1)
    for b in range(B):
        same(got[b].numpy(), j_chainio(jnp.asarray(x[b]), jnp.asarray(cost[b]),
                                       jnp.asarray(p2[b]), steps, GROUP, extra,
                                       P1, per_path=True))


@pytest.mark.parametrize("rolls,extra", [((0,), 0), ((0,), 1), ((0,), 2),
                                         (GROUP, 0)])
def test_chainio_plain_matches_the_script_kernel(rolls, extra, no_launch):
    rng = np.random.default_rng(41)
    steps, n = 10, len(rolls)
    x = seeds(rng, uniform_along_p=n > 1)
    cost = rng.integers(0, 256, (B, steps, D, P)).astype(np.int32)
    p2 = rng.integers(P1, P2_INIT + 1, (B, n, steps, P)).astype(np.int32)
    got = probe_kernels.chainio(t(x), t(cost), t(p2), steps, rolls, extra, P1)
    for b in range(B):
        same(got[b].numpy(), j_chainio(jnp.asarray(x[b]), jnp.asarray(cost[b]),
                                       jnp.asarray(p2[b]), steps, rolls, extra,
                                       P1))


def test_chainio_ring_is_the_volume_it_stands_for(no_launch):
    """A ring of R < steps slots equals the full volume in which row s of
    direction k is ring row s mod R, moved along with the path."""
    rng = np.random.default_rng(42)
    steps, ring = 11, 4
    x = seeds(rng, uniform_along_p=False)
    cost_ring = rng.integers(0, 256, (B, ring, D, P)).astype(np.int32)
    p2_ring = rng.integers(P1, P2_INIT + 1, (B, 1, ring, P)).astype(np.int32)
    for roll in GROUP:
        shift = [roll * ring * (s // ring) for s in range(steps)]
        cost = np.stack([np.roll(cost_ring[:, s % ring], shift[s], -1)
                         for s in range(steps)], 1)
        p2 = np.stack([np.roll(p2_ring[:, :, s % ring], shift[s], -1)
                       for s in range(steps)], 2)
        same(probe_kernels.chainio_plain(t(x), t(cost_ring), t(p2_ring), steps,
                                         (roll,), 0, P1),
             probe_kernels.chainio_plain(t(x), t(cost), t(p2), steps, (roll,),
                                         0, P1))


def test_chainio_on_a_real_volume_is_the_directional_scans(no_launch):
    """Fed a real cost volume and the real P2 rows, a zero seed and no
    read-adds, the chain is the SGM scan: its row is the last row of the
    group's summed contributions plus direction 0's."""
    h, w = 10, 28
    left, right, _ = synthetic_pair(43, B, h, w, (3, 6, 10))
    cost = kernels.census_cost_volume(t(left), t(right), 0, D).numpy()
    p2 = pk._p2_planes(jnp.asarray(left.astype(np.int32)), GROUP, +1, P1,
                       P2_INIT)                        # (B, S, n, P)
    got = probe_kernels.chainio(
        torch.zeros((B, D, w), dtype=torch.uint16), t(cost.astype(np.int32)),
        t(np.asarray(p2).transpose(0, 2, 1, 3)), h, GROUP, 0, P1)
    for b in range(B):
        scans = [j_agg.directional_scan(jnp.asarray(cost[b]), jnp.asarray(left[b]),
                                        P1, P2_INIT, False, roll)[0][-1]
                 for roll in GROUP]
        same(got[b].numpy(), (sum(scans) + scans[0]).astype(jnp.uint16))


def test_chain_wrappers_refuse_bad_arguments():
    x = torch.zeros((1, 4, 8), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError):
        probe_kernels.chain(x, 4)                       # neither CPU nor CUDA
    # D=64, three directions, a ring of 4, two lanes a path: 16 words a
    # lane, 10 columns of 6 threads in a block of 64 threads (32 paths); per
    # path a row of 64 ints, per slot 16 cost words and 16 output words a
    # thread and a P2 word a path
    assert probe_kernels.chainio_shared_bytes(64, 3, 4, 2) == \
        32 * 64 * 4 + 4 * (64 * 16 * 4 + 64 * 16 * 4 + 32 * 4)
    assert probe_kernels.chainio_shared_bytes(256, 3, 375, 8) \
        > probe_kernels.MAX_SHARED_BYTES


def j_chain_step(prev, pmin, cost, p1, p2):
    """One step of scripts/recurrence_floor.py ``chain_kernel`` (:136-152)
    on int32 (D, P) rows, the P2 row given: -> (cs, min over D)."""
    d, w = prev.shape
    sentinel = jnp.int32(pk.SENTINEL)
    d_iota = jax.lax.broadcasted_iota(jnp.int32, (d, w), 0)
    up = jnp.where(d_iota == 0, sentinel, jnp.roll(prev, 1, axis=0))
    dn = jnp.where(d_iota == d - 1, sentinel, jnp.roll(prev, -1, axis=0))
    m = jnp.minimum(jnp.minimum(prev, jnp.minimum(up, dn) + p1), pmin + p2)
    cs = (cost + m - pmin) & 0xFF
    return cs, jnp.min(cs, axis=0, keepdims=True)


def chain_step_cases(d, p, rng):
    """(prev, pmin, cost) int32 rows over the uint8 domain: every pair of
    path minimum and cost byte along P (at P = 65536), the rows' values and
    neighbours as ramps, noise, all 255 and all 0."""
    col = np.arange(p)
    pmin = col % 256
    cost = (np.broadcast_to((col // 256) % 256, (d, p))
            ^ rng.integers(0, 2, (d, p)))
    ramp = (np.arange(d)[:, None] * 37 + col[None, :]) % 256
    for prev in (ramp, rng.integers(0, 256, (d, p)), np.full((d, p), 255),
                 np.zeros((d, p), np.int64)):
        yield prev, pmin, cost


@pytest.mark.parametrize("p1,p2", [(10, 150), (0, 0), (255, 255), (300, 2000),
                                   (7, -5), (10, "int32")])
def test_chain_step_matches_the_script_step_over_the_uint8_domain(p1, p2):
    """The step of the redesigned ``chain_kernel`` (two disparities to a
    32-bit word, P1 clamped to 255, pmin + P2 clamped to 0..255 with a
    negative sum folded into the bias, dead lanes at 255) against the jnp
    step of the script's kernel, for every lane count: the clamps change
    nothing because m <= prev <= 255.  P2 values that saturate (2000), that
    do not, that are negative, and every int32 (wrapping as in jnp)."""
    rng = np.random.default_rng(72)
    d, p = 3, 65536
    for prev, pmin, cost in chain_step_cases(d, p, rng):
        row = (rng.integers(-2 ** 31, 2 ** 31, p) if p2 == "int32"
               else np.full(p, p2)).astype(np.int32)
        want = j_chain_step(*(jnp.asarray(v, jnp.int32) for v in
                              (prev, pmin[None], cost)), p1,
                            jnp.asarray(row[None]))
        for lanes in (1, 2, 4, 8):
            got = probe_kernels.chain_step_plain(
                t(prev), t(pmin), t(cost), p1, t(row), lanes)
            same(got[0], np.asarray(want[0]))
            same(got[1], np.asarray(want[1])[0])


@pytest.mark.parametrize("d", [1, 3, 5, 61, 64, 255, 256])
def test_chain_dead_lanes_read_as_sentinels(d):
    """D not a multiple of the 2 W L disparities a path holds: the dead
    lanes are held at 255, so L(D) reads as the sentinel and the path
    minimum never sees them; the step and a carried packed chain against
    the jnp step and the script's chain, at every lane count that holds D."""
    rng = np.random.default_rng(73)
    x = rng.integers(0, 65536, (1, d, 6)).astype(np.uint16)
    cost_b, cmin_b = j_chain_state(jnp.asarray(x[0]), 9, (0,), P1)
    for lanes in (1, 2, 4, 8):
        if 32 * lanes < d:
            continue
        for prev, pmin, cost in chain_step_cases(d, 512, rng):
            got = probe_kernels.chain_step_plain(t(prev), t(pmin), t(cost), P1,
                                                 P2_INIT, lanes)
            want = j_chain_step(*(jnp.asarray(v, jnp.int32) for v in
                                  (prev, pmin[None], cost)), P1, P2_INIT)
            same(got[0], np.asarray(want[0]))
            same(got[1], np.asarray(want[1])[0])
        got = probe_kernels.chain_packed_plain(t(x), 9, P1, lanes)
        same(got[0].numpy(), (cost_b[0] + cmin_b[0]).astype(jnp.uint16))


@pytest.mark.parametrize("d,paths,lanes", [
    (64, 3000, 4),        # cone B=8, one direction
    (64, 750, 8),         # cone B=2, one direction: under 264 warps at four
    (64, 2250, 4),        # cone B=2, the vertical group
    (64, 10800, 4), (64, 43200, 4), (32, 43200, 4), (16, 12000, 4),
    (128, 5000, 4), (129, 100000, 8), (256, 1000, 8), (256, 4500, 8),
    (1, 1, 8)])
def test_chain_lanes_rule(d, paths, lanes):
    """The lanes a path takes on an H100's 132 SMs: four, eight where D >
    128 or where four give fewer warps than half its 528 schedulers; the
    words a lane holds cover D, at most 16."""
    assert probe_kernels.chain_lanes(d, paths, 132) == lanes
    words = probe_kernels.chain_words(d, lanes)
    assert 2 * words * lanes >= d and words <= 16
    assert words == 1 or 2 * (words // 2) * lanes < d


# --- (b) the volume transpose and the transposed horizontal pair ------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_volume_transpose_matches_jnp(dtype, no_launch):
    x = np.random.default_rng(44).integers(0, 256, (B, 7, 5, 9)).astype(dtype)
    got = probe_kernels.volume_transpose(t(x))
    assert got.is_contiguous() and got.shape == (B, 9, 5, 7)
    same(got.numpy(), jnp.transpose(jnp.asarray(x), (0, 3, 2, 1)))
    same(probe_kernels.volume_transpose(got).numpy(), x)


@pytest.mark.parametrize("h,w,d", [(12, 28, 16), (13, 21, 24)])
def test_hpart_T_matches_pallas_horizontal_partial(h, w, d, no_launch):
    rng = np.random.default_rng(45)
    cost = rng.integers(0, 128, (B, h, d, w), dtype=np.uint8)
    img = rng.integers(0, 256, (B, h, w), dtype=np.uint8)
    got = aggr_transpose.hpart_T(t(cost), t(img), P1, P2_INIT)
    assert got.dtype == torch.uint16 and got.shape == (B, h, d, w)
    want = pk.horizontal_partial(jnp.asarray(cost.astype(np.int8)),
                                 jnp.asarray(img.astype(np.int32)), P1,
                                 P2_INIT, False, block_rows=8)
    same(got.numpy(), want)
    same(got.numpy(), kernels.horizontal_partial(t(cost), t(img), P1, P2_INIT,
                                                 False).numpy())
    # hpart_not leaves its output transposed
    part_t = aggr_transpose.hpart_not(t(cost.transpose(0, 3, 2, 1)),
                                      t(img.transpose(0, 2, 1)), P1, P2_INIT)
    same(part_t.numpy(), np.asarray(want).transpose(0, 3, 2, 1))


@pytest.mark.parametrize("axis,reverse,roll", [("h", False, 0), ("h", True, 0),
                                               ("v", False, 1), ("v", True, -1)])
def test_scan_direction_matches_jax_directional_scan(axis, reverse, roll,
                                                     no_launch):
    rng = np.random.default_rng(46)
    cost = rng.integers(0, 256, (B, 9, D, 14), dtype=np.uint8)
    img = rng.integers(0, 256, (B, 9, 14), dtype=np.uint8)
    got = kernels.scan_direction(t(cost), t(img), axis, reverse, roll, P1,
                                 P2_INIT)
    acc = torch.full(cost.shape, 3, dtype=torch.uint16)
    added = kernels.scan_direction(t(cost), t(img), axis, reverse, roll, P1,
                                   P2_INIT, out=acc)
    assert added.data_ptr() == acc.data_ptr()
    for b in range(B):
        c, g = jnp.asarray(cost[b]), jnp.asarray(img[b])
        if axis == "h":
            want = j_agg.directional_scan(c.transpose(2, 1, 0), g.T, P1, P2_INIT,
                                          reverse, roll)[0].transpose(2, 1, 0)
        else:
            want = j_agg.directional_scan(c, g, P1, P2_INIT, reverse, roll)[0]
        same(got[b].numpy(), want.astype(jnp.uint16))
        same(acc[b].numpy(), (want + 3).astype(jnp.uint16))


# --- (c) the 16-bit recurrence ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(probe_kernels.RUNGS))
def test_rung_plain_matches_the_script_rung(name, no_launch):
    rows = 8 if name in probe_kernels.LOOP_RUNGS else 16
    x = np.random.default_rng(47).integers(0, 256, (B, rows, 32), dtype=np.uint8)
    got = probe_kernels.rung(name, t(x))
    assert got.dtype == torch.uint16 and got.shape == x.shape
    for b in range(B):
        same(got[b].numpy(), j_rung(name, jnp.asarray(x[b].view(np.int8))))


@pytest.mark.parametrize("compute16", [False, True])
@pytest.mark.parametrize("reverse,restart", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_scan16_plain_matches_pallas_group_scan_at_the_p7_shape(reverse, restart,
                                                                compute16,
                                                                no_launch):
    """P4 replaces the ``compute16=True`` branch of the Pallas group scan
    (16-bit state); the ``False`` branch is the same function."""
    rng = np.random.default_rng(0)
    rows, d, w = 8, 16, 256
    cost = rng.integers(0, 128, (1, rows, d, w), dtype=np.int8)
    img = rng.integers(0, 256, (1, rows, w)).astype(np.int32)
    rolls = (0, -1, 1) if reverse else GROUP
    p2 = pk._p2_planes(jnp.asarray(img), rolls, -1 if reverse else +1, P1,
                       P2_INIT)
    want = pk._directional_scan_group(jnp.asarray(cost), p2, None, rolls,
                                      reverse, P1, restart, rows,
                                      compute16=compute16)
    got = probe_kernels.scan16(t(cost.view(np.uint8)), t(img.astype(np.uint8)),
                               rolls, reverse, P1, P2_INIT, restart)
    same(got.numpy(), want)
    with pytest.raises(ValueError, match="overflow"):
        probe_kernels.scan16(t(cost.view(np.uint8)), t(img.astype(np.uint8)),
                             rolls, reverse, P1, 40000, restart)


@pytest.mark.parametrize("d", [1, 2, 7, 16, 33, 256])
@pytest.mark.parametrize("p1,p2_init", [(10, 150), (0, 0), (7, 10_000),
                                        (300, 2_000), (255, 255)])
def test_scan16_step_matches_dp_step_over_the_uint8_domain(d, p1, p2_init):
    """The step of ``scan16``'s kernel (two disparities in the 16-bit lanes
    of a word, a dead high lane at 255 for odd D, L(d +- 1) woven from
    neighbouring words, P2' and the path minimum shared by both halves)
    against the jnp ``_dp_step``: every value of L(d), of its neighbours and
    of the cost, every gray difference, penalties beyond 255."""
    rng = np.random.default_rng(71)
    p = 512
    ramp = (np.arange(d)[:, None] + np.arange(p)[None, :]) % 256
    noise = rng.integers(0, 256, (d, p))
    for prev in (ramp, noise, np.full((d, p), 255), np.zeros((d, p), int)):
        prev_min = prev.min(axis=0)
        cost = rng.integers(0, 256, (d, p))
        gray = rng.integers(0, 256, p)
        prev_gray = (np.arange(p) // 2) % 256
        carry = j_agg.ScanCarry(jnp.asarray(prev, jnp.int32),
                                jnp.asarray(prev_min, jnp.int32),
                                jnp.asarray(prev_gray, jnp.int32))
        want = j_agg._dp_step(carry, jnp.asarray(cost, jnp.int32),
                              jnp.asarray(gray, jnp.int32), p1, p2_init)
        got = probe_kernels.scan16_step_plain(
            *(t(x.astype(np.int32)) for x in (prev, prev_min, prev_gray,
                                              cost, gray)), p1, p2_init)
        same(got, np.asarray(want))


@pytest.mark.parametrize("rolls", [(), (2,), (0, 1, -2)])
def test_scan16_wrapper_refuses_rolls_the_kernel_does_not_take(rolls):
    cost = torch.zeros((1, 3, 4, 8), dtype=torch.uint8)
    img = torch.zeros((1, 3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rolls"):
        probe_kernels.scan16(cost, img, rolls, False, P1, P2_INIT, False)


# --- (d) the probe modules ----------------------------------------------------------------

SMALL = dict(device="cpu", batch=2, h=12, w=28, dmax=16, reps=1)
HEAD = {"probe", "timestamp", "device", "card", "power_limit", "reps", "batch",
        "h", "w", "d"}


@pytest.mark.parametrize("probe,variants,extra_keys", [
    (recurrence_floor,
     {"chain1", "chain1v", "chain3", "chainio3_f", "chainio3_m", "chainio3_b",
      "chainio1_f", "chainio1_b", "chainio1v_f", "chainio1v_m", "prod1",
      "prod1v", "prod3_old", "prod3", "hpart", "bw_stream"},
     {"summary", "chain1_steps_scaling", "ring"}),
    (aggr_transpose,
     {"full", "xin8", "xout16", "ktrans8", "ktrans16", "hpart",
      "hpart_strided", "hpart_not", "hpart_T"},
     {"summary", "checked", "kernels"}),
    (int16_recurrence, {"scan16", "prod3"}, {"summary", "probes", "ladder_shape"}),
    (ablation, {"full", "no_speckle", "no_lr", "no_lr_no_speckle", "no_unique"},
     {"deltas_ms_per_frame", "noise_floor_ms"}),
])
def test_probe_run_on_cpu_returns_its_schema_untimed(probe, variants, extra_keys,
                                                     no_launch):
    import json

    doc = probe.run(**SMALL)
    json.dumps(doc)
    assert set(doc) == HEAD | {"variants"} | extra_keys
    assert doc["device"] == "cpu" and doc["card"] is None
    assert set(doc["variants"]) == variants
    # a CPU run states no device time
    assert all(rec["ms_per_frame"] is None and rec["ms_per_call"] is None
               for rec in doc["variants"].values())
    assert "not measured" in probe.report(doc)
    if probe is int16_recurrence:
        assert len(doc["probes"]) == 12
        assert all(rec == {"ok": True} for rec in doc["probes"].values())
    if probe is recurrence_floor:
        assert doc["summary"]["prod_over_floor"] is None


def test_recurrence_floor_summary_counts_the_main_path_launches():
    """floor and achievable over the main path's four scan launches (two
    one-direction horizontal ones, two three-direction vertical groups)
    and its three transposes, on made-up times."""
    ms = {"chain1": 1.0, "chain3": 10.0, "chainio1_f": 2.0, "chainio1_m": 3.0,
          "chainio1_b": 30.0, "chainio3_f": 4.0, "chainio3_m": 5.0,
          "chainio3_b": 6.0, "hpart": 7.0, "prod3": 8.0, "prod1": 9.0,
          "prod3_old": 11.0}
    variants = {name: {"ms_per_frame": v} for name, v in ms.items()}
    gb_s = 1.0                          # 1e6 elements: 1 ms a byte
    s = recurrence_floor._summary(variants, gb_s, 1_000_000)
    assert s["floor_ms_per_frame"] == 2 * 1.0 + 2 * 10.0
    # the horizontal pair's forward launch (chainio1_f, 3 bytes an element)
    # and its reverse one (chainio1_b, 5: it reads the sum), both vertical
    # groups (chainio3_m, 5), then the three transposes: cost there (2),
    # the sum back (4)
    assert s["achievable_ms_per_frame"] == \
        max(2.0, 3.0) + max(30.0, 5.0) + max(5.0, 5.0) + max(5.0, 5.0) + 6.0
    assert s["prod_ms_per_frame"] == 7.0 + 2 * 8.0
    assert s["prod_first_design_ms_per_frame"] == 2 * 9.0 + 2 * 11.0
    assert s["prod_over_floor"] == 23.0 / 22.0
    assert "2 chain1 + 2 chain3" in s["note"]
    assert recurrence_floor._summary(
        {**variants, "chain1": {"ms_per_frame": None}}, gb_s,
        1)["floor_ms_per_frame"] is None


def test_probes_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        recurrence_floor.run()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "soc_project_stereo_matching_tpu_torch.probes",
         "recurrence_floor"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and "needs a CUDA device" in proc.stderr
    assert not (REPO / "chiprun_out" / "recurrence_floor.json").exists() \
        or "wrote" not in proc.stdout


def test_probe_options_come_from_the_port_config():
    """One set of options for both packages: the JAX dataclass by way of
    ``from_jax`` gives the port's own."""
    opt = config.from_jax(SGMOptions(max_disparity=D))
    assert type(opt) is config.SGMOptions and opt.max_disparity == D
