"""The serial floor of the SGM recurrence beside the shipped K2 scans.

Counterpart of the JAX package's ``scripts/recurrence_floor.py``.  The
shipped K2 scan (``csrc/aggregate.cu``'s group kernel) owns columns: one
launch walks the S steps of a scan order for up to three directions that
share it, every path of every image at once.  Along a path each step needs
the step before, so a launch can take no less than its paths' dependent
chain of S steps.  The main path makes four scan launches and three
transposes per ``match_batch``:

    horizontal_partial   the cost and the image transposed, two
                         one-direction group launches along the transposed
                         volume's columns (B*H paths of W steps; the reverse
                         one adds onto the forward one's sum), the sum
                         transposed back
    aggregate_paths      two three-direction vertical groups (straight and
                         both diagonals: 3*B*W paths of H steps), forward
                         and reverse, each adding onto the sum

This probe times a ladder at that geometry (default: the cone pair, B=8,
375x450, D=64) so that "the scans run at x% of the byte roofline" can be
held against what the recurrence itself allows:

    chain1       the carried chain alone at a horizontal launch's shape:
                 B*H paths of W steps (probes/kernels.chain)
    chain1v      one vertical direction alone, B*W paths of H steps: the
                 first design's launch shape (a launch per direction)
    chain3       a vertical group (straight and both diagonals) in one
                 launch: 3 * B*W paths of H steps
    chainio*     chain plus a pass's per-step traffic from shared memory
                 (probes/kernels.chainio): suffix f = forward pass (cost and
                 P2 load, row store), m = + one uint16 row read-add (a pass
                 that adds onto an earlier sum), b = + two (the JAX
                 design's backward pass that also carries a parked sum; for
                 one direction, ``chainio1_b``, the one read-add of the
                 reverse horizontal launch)
    prod1        one horizontal launch of the first design's kernel, a warp
                 per path (ops.kernels.scan_direction)
    prod1v       one vertical launch of the same kernel
    prod3_old    a vertical group by that kernel, three launches
                 (ops.kernels.scan_directions)
    prod3        the shipped vertical group, one launch of the group kernel
                 (ops.kernels.directional_scan_group)
    hpart        the shipped horizontal pair: three transposes and two group
                 launches (ops.kernels.horizontal_partial)
    bw_stream    x + 1 on an int16 (B, H, D, W) volume: the memory stream a
                 launch's loads and stores can draw on, in GB/s

On this card the paths of a launch overlap each other's latency, so what is
serial is a path's chain and nothing else; a launch can end no sooner than
max(its chain with the on-chip traffic, its mandatory bytes at the streaming
rate).  The summary adds that up over the main path's launches, with each
launch's pass shape and bytes per volume element from ``aggregate.cu``'s
header (24 bytes an element over the 8 directions: 2 + 3 + 5 + 4 + 5 + 5):

    launch                        chain    chainio      bytes an element
    horizontal forward            chain1   chainio1_f   3 (cost, sum written)
    horizontal reverse            chain1   chainio1_b   5 (+ the sum read)
    vertical forward group        chain3   chainio3_m   5
    vertical reverse group        chain3   chainio3_m   5
    the three transposes          -        -            2 + 4 (cost there,
                                                        sum back; the image's
                                                        bytes are negligible)

    floor        2 chain1 + 2 chain3
    achievable   the sum over the four scan launches of max(chainio of its
                 pass shape, its bytes / bw_stream), plus the transposes'
                 6 bytes an element / bw_stream
    prod         hpart + 2 prod3: the shipped aggregation
    prod_first_design   2 prod1 + 2 prod3_old: the first design's eight
                 launches (two horizontal, six vertical)

Every chain variant is compared with its plain version at the very step
count that is timed.  The chain kernels must not be optimised away: their
result row depends on every step, and the probe times ``chain1`` at
``steps`` and at 2 * steps, a launch at a time in runs of 10 (a call's
events also hold the wrapper's host time, which the chain no longer
covers at the cone pair), and raises unless twice the steps take at least
1.3 times as long (from 200 steps on: below, a launch's fixed cost hides
the chain).
"""

from __future__ import annotations

import torch

from ..ops import kernels as ops_kernels
from . import (GEOMETRY, SEED, document, fmt, measure, pair_and_cost,
               random_tensor, ratio, require_equal, resolve_device)
from . import kernels as pk

GROUP = (0, 1, -1)          # a vertical group: straight, both diagonals
RING = 4                    # steps a path of `chainio` stages in shared memory
MIN_STEPS_FOR_GROWTH = 200  # from here on twice the steps must show in the time
RUN = 10                    # back-to-back launches a sample of the growth check


def _rings(seed, b, n, ring, d, p, opt, device):
    cost = random_tensor(seed, 0, 128, (b, ring, d, p), torch.int32, device)
    p2 = random_tensor(seed + 1, opt.p1, opt.p2_init + 1, (b, n, ring, p),
                       torch.int32, device)
    return cost, p2


def run(device=None, batch=GEOMETRY["batch"], h=GEOMETRY["h"],
        w=GEOMETRY["w"], dmax=GEOMETRY["dmax"], reps: int = 10) -> dict:
    device = resolve_device(device)
    opt, left, _, cost = pair_and_cost(device, batch, h, w, dmax)
    ring, seed = RING, SEED
    d, p1, p2 = cost.shape[2], opt.p1, opt.p2_init
    doc = document("recurrence_floor", device, reps, batch=batch, h=h, w=w,
                   d=d, ring=ring)

    # shapes: vertical launches step over H with one path per column,
    # horizontal ones over W with one path per row
    x_v = random_tensor(seed + 2, 0, 65536, (batch, d, w), torch.uint16, device)
    x_h = random_tensor(seed + 3, 0, 65536, (batch, d, h), torch.uint16, device)
    rings = {"3": (x_v, h, GROUP, _rings(seed + 4, batch, 3, ring, d, w, opt, device)),
             "1": (x_h, w, (0,), _rings(seed + 6, batch, 1, ring, d, h, opt, device)),
             "1v": (x_v, h, (0,), _rings(seed + 8, batch, 1, ring, d, w, opt, device))}

    ladder = {}
    for shape, (x, steps, rolls, _) in rings.items():
        ladder[f"chain{shape}"] = (
            f"{len(rolls)} direction(s), {batch * x.shape[2] * len(rolls)} "
            f"paths of {steps} steps",
            lambda n, x=x, rolls=rolls: pk.chain(x, n, rolls, p1),
            lambda n, x=x, rolls=rolls: pk.chain_plain(x, n, rolls, p1), steps)
    for shape, suffix, extra in (("3", "f", 0), ("3", "m", 1), ("3", "b", 2),
                                 ("1", "f", 0), ("1", "b", 1),
                                 ("1v", "f", 0), ("1v", "m", 1)):
        x, steps, rolls, (cr, pr) = rings[shape]
        ladder[f"chainio{shape}_{suffix}"] = (
            f"chain{shape} + cost/P2 loads, {extra} uint16 row read-add(s) "
            f"and a row store per step, ring of {ring}",
            lambda n, a=(x, cr, pr), rolls=rolls, extra=extra:
                pk.chainio(*a, n, rolls, extra, p1),
            lambda n, a=(x, cr, pr), rolls=rolls, extra=extra:
                pk.chainio_plain(*a, n, rolls, extra, p1), steps)

    variants = {}
    for name, (note, fn, plain, steps) in ladder.items():
        require_equal(name, fn(steps), plain(steps))
        variants[name] = dict(measure(lambda: fn(steps), device, reps, batch),
                              note=note)

    production = {
        "prod1": ("first design (a warp per path), one horizontal launch",
                  lambda: ops_kernels.scan_direction(cost, left, "h", False,
                                                     0, p1, p2)),
        "prod1v": ("first design, one vertical launch",
                   lambda: ops_kernels.scan_direction(cost, left, "v", False,
                                                      0, p1, p2)),
        "prod3_old": ("first design, the vertical group in three launches",
                      lambda: ops_kernels.scan_directions(
                          cost, left, [("v", False, roll) for roll in GROUP],
                          p1, p2)),
        "prod3": ("group kernel, the shipped vertical group in one launch",
                  lambda: ops_kernels.directional_scan_group(
                      cost, left, None, GROUP, False, p1, p2, False)),
        "hpart": ("group kernel, the shipped horizontal pair: 3 transposes "
                  "and 2 launches",
                  lambda: ops_kernels.horizontal_partial(cost, left, p1, p2,
                                                         False)),
    }
    require_equal("prod3", production["prod3"][1](),
                  production["prod3_old"][1]())
    for name, (note, fn) in production.items():
        variants[name] = dict(measure(fn, device, reps, batch), note=note)

    # the chain's time must grow with its steps: timed a launch at a time in
    # runs of RUN back-to-back launches, so that the wrapper's host time,
    # which a call's events also hold, stays out of the comparison
    x, steps, rolls, _ = rings["1"]

    def per_launch(n):
        rec = measure(lambda: [pk.chain(x, n, rolls, p1) for _ in range(RUN)],
                      device, reps, batch)
        return None if rec["ms_per_frame"] is None else rec["ms_per_frame"] / RUN

    once, twice = per_launch(steps), per_launch(2 * steps)
    growth = ratio(twice, once)
    doc["chain1_steps_scaling"] = {
        "steps": steps, "ms_per_frame": once, "steps_doubled": 2 * steps,
        "ms_per_frame_doubled": twice, "ratio": growth,
        "timed": f"a launch at a time in runs of {RUN}"}
    # (below some hundred steps a launch's fixed cost hides the chain)
    if growth is not None and steps >= MIN_STEPS_FOR_GROWTH and growth < 1.3:
        raise AssertionError(f"chain1 took {growth:.3f}x as long for twice the "
                             f"steps: the chain is not what is being timed")

    # the memory stream at the volume's size: read + write of 2-byte elements
    vol = torch.zeros(cost.shape, dtype=torch.int16, device=device)
    sink = torch.empty_like(vol)
    stream = measure(lambda: torch.add(vol, 1, out=sink), device, reps, batch)
    gb_s = None
    if stream["ms_per_call"] is not None:
        gb_s = 2 * vol.numel() * 2 / (stream["ms_per_call"]["median"] * 1e-3) / 1e9
    variants["bw_stream"] = dict(stream, gb_s=gb_s, note=(
        "x + 1 on an int16 volume of the aggregated volume's size"))

    doc["variants"] = variants
    doc["summary"] = _summary(variants, gb_s, h * d * w)
    return doc


# the main path's scan launches: (chain, chainio of its pass shape, bytes
# per volume element), and the bytes of its three transposes
MAIN_PATH_LAUNCHES = (("chain1", "chainio1_f", 3), ("chain1", "chainio1_b", 5),
                      ("chain3", "chainio3_m", 5), ("chain3", "chainio3_m", 5))
TRANSPOSE_BYTES = 2 + 4


def _summary(variants: dict, gb_s, frame_elements: int) -> dict:
    ms = {name: rec["ms_per_frame"] for name, rec in variants.items()}
    if gb_s is None or any(v is None for v in ms.values()):
        return {"floor_ms_per_frame": None, "achievable_ms_per_frame": None,
                "prod_ms_per_frame": None,
                "prod_first_design_ms_per_frame": None,
                "prod_over_floor": None, "prod_over_achievable": None}

    def stream_ms(bytes_per_element):
        return frame_elements * bytes_per_element / gb_s / 1e6

    floor = sum(ms[chain] for chain, _, _ in MAIN_PATH_LAUNCHES)
    achievable = sum(max(ms[io], stream_ms(nbytes))
                     for _, io, nbytes in MAIN_PATH_LAUNCHES) \
        + stream_ms(TRANSPOSE_BYTES)
    prod = ms["hpart"] + 2 * ms["prod3"]
    prod_first = 2 * ms["prod1"] + 2 * ms["prod3_old"]
    return {
        "floor_ms_per_frame": floor,
        "achievable_ms_per_frame": achievable,
        "prod_ms_per_frame": prod,
        "prod_first_design_ms_per_frame": prod_first,
        "prod_over_floor": prod / floor,
        "prod_over_achievable": prod / achievable,
        "note": ("the main path's scan launches, as shipped: floor = 2 chain1 "
                 "+ 2 chain3 (the horizontal pair's two one-direction "
                 "launches, the two three-direction vertical groups; the "
                 "chain alone); achievable = the sum over those four launches "
                 "of max(chainio of the launch's pass shape, its bytes / "
                 "bw_stream): chainio1_f with 3 bytes an element (cost read, "
                 "sum written), chainio1_b, chainio3_m, chainio3_m with 5 "
                 "(the sum read too), plus the three transposes' 6 bytes an "
                 "element / bw_stream; prod = hpart + 2 prod3 (the shipped "
                 "group kernel); prod_first_design = 2 prod1 + 2 prod3_old "
                 "(the first design's eight launches)"),
    }


def report(doc: dict) -> str:
    lines = []
    for name, rec in doc["variants"].items():
        extra = f"  {rec['gb_s']:.1f} GB/s" if rec.get("gb_s") else ""
        lines.append(f"{name:12s} {fmt(rec['ms_per_frame'])} ms/frame{extra}")
    sc = doc["chain1_steps_scaling"]
    lines.append(f"chain1 at {sc['steps']} / {sc['steps_doubled']} steps: "
                 f"{fmt(sc['ms_per_frame'])} / "
                 f"{fmt(sc['ms_per_frame_doubled'])} ms/frame, {sc['timed']}")
    s = doc["summary"]
    lines.append(f"floor {fmt(s['floor_ms_per_frame'])}, achievable "
                 f"{fmt(s['achievable_ms_per_frame'])}, prod "
                 f"{fmt(s['prod_ms_per_frame'])} (first design "
                 f"{fmt(s['prod_first_design_ms_per_frame'])}) ms/frame; "
                 f"prod/floor "
                 f"{fmt(s['prod_over_floor'])}, prod/achievable "
                 f"{fmt(s['prod_over_achievable'])}")
    return "\n".join(lines)
