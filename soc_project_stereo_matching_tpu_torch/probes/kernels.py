"""Wrappers of the eight probe kernels, in the style of ``ops/kernels.py``.

    chain             P1 csrc/probe_recurrence.cu <- recurrence_floor.py chain_kernel
    chainio           P2 csrc/probe_recurrence.cu <- recurrence_floor.py chainio_kernel
    volume_transpose  P3 csrc/transpose.cu        <- aggr_transpose_probe.py
                         (both bodies of its transpose kernel; a main-path
                         kernel since the horizontal pair runs on the
                         transposed volume: it lives in ``ops/kernels.py``
                         and is imported here)
    rung, scan16      P4 csrc/probe_int16.cu      <- mosaic_int16_probe.py rungs
                         and the ``compute16`` group scan
    speckle_labels    S1 csrc/probe_speckle.cu    <- speckle_probe.py: the label
                         kernel and its variants (pair, fori16, block4, pyr)
    speckle_hist      S2 csrc/probe_speckle.cu    <- speckle_tail_probe.py _hist_kernel
    speckle_verdict   S3 csrc/probe_speckle.cu    <- speckle_tail_probe.py _verdict_kernel
    speckle_tail_fused S4 csrc/probe_speckle.cu   <- speckle_tail_probe.py _fused_kernel

Beside each stands its plain PyTorch version, which defines the function:
the tests compare it with the JAX scripts' bodies, and on the card the
kernel is compared with it bit for bit.  A wrapper given CPU tensors runs
the plain version; given CUDA tensors it checks them, launches on the
current stream, raises on a CUDA error and adds one to its counter in
``ops.kernels.LAUNCHES`` per C entry call (``probe_chain``,
``probe_chainio``; the transpose counts as ``volume_transpose``; ``rung`` and ``scan16`` share
``probe_int16``, and ``scan16`` counts one per launch of up to three
directions; S1-S4 count as
``probe_speckle_labels``, ``probe_speckle_hist``, ``probe_speckle_verdict``
and ``probe_speckle_fused``).  There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

import numpy as np

from .. import _build
from ..ops import kernels as ops_kernels
from ..ops.kernels import (_check, _launch, _on_cpu, _stream,  # noqa: F401
                           volume_transpose, volume_transpose_plain)
from ..ops.postprocess import _shift2d

SENTINEL = 255
CHAIN_P2 = 150                # the constant P2 of `chain`
MAX_SHARED_BYTES = 232448     # 227 KB: the most a block can take
MAX_ROLLS = 8
RUNGS = {"p0": 0, "p1": 1, "p2": 2, "p3": 3, "p4": 4, "p5": 5, "p6": 6,
         "p8": 8, "p9": 9, "p10": 10, "p5b": 11}
LOOP_RUNGS = ("p5", "p5b")    # a state carried over rows; the others: (D, W)


# --- P1 / P2: the recurrence floor ------------------------------------------------

def _recurrence_plain(x, steps: int, rolls: Sequence[int], p1: int,
                      cost_ring=None, p2_ring=None, extra_u16: int = 0):
    """The carried chain of ``chain`` (no rings) and ``chainio`` (rings), in
    the column-indexed form of the JAX script: state planes (B, D, P) that a
    diagonal rolls by one column per step.  What belongs to a path rather
    than to a column travels with the state: the seed bit of its cost row
    and, for ``chainio``, its ring of staged rows."""
    io = cost_ring is not None
    b, d, p = x.shape
    dev = x.device
    seed0 = x.to(torch.int32) & 1
    const_row = ((torch.arange(d, device=dev, dtype=torch.int32) * 7 + 13)
                 & 0x7F)[None, :, None]
    edge = torch.full((b, 1, p), SENTINEL, dtype=torch.int32, device=dev)
    ring = cost_ring.shape[1] if io else 1
    state = []
    for _ in rolls:
        state.append({
            "prev": torch.zeros((b, d, p), dtype=torch.int32, device=dev),
            "pmin": torch.zeros((b, p), dtype=torch.int32, device=dev),
            "seed": seed0,
            "out": torch.zeros((b, ring, d, p), dtype=torch.int32, device=dev)
            if io else None})
    for s in range(steps):
        slot, lap = s % ring, s // ring
        for k, roll in enumerate(rolls):
            st = state[k]
            if roll and s > 0:
                for name in ("prev", "pmin", "seed") + (("out",) if io else ()):
                    st[name] = st[name].roll(roll, -1)
            prev, pmin = st["prev"], st["pmin"]
            if io:      # the ring row of this slot, where the path is now
                shift = roll * ring * lap
                cost_row = (cost_ring[:, slot].roll(shift, -1) ^ st["seed"]) & 0xFF
                p2 = p2_ring[:, k, slot].roll(shift, -1)
            else:
                cost_row = const_row ^ st["seed"]
                p2 = CHAIN_P2
            up = torch.cat([edge, prev[:, :-1]], dim=1)
            dn = torch.cat([prev[:, 1:], edge], dim=1)
            m = torch.minimum(torch.minimum(prev, torch.minimum(up, dn) + p1),
                              (pmin + p2)[:, None, :])
            cs = (cost_row + m - pmin[:, None, :]) & 0xFF
            st["prev"], st["pmin"] = cs, cs.amin(dim=1)
            if io:
                total = cs
                for e in range(extra_u16):
                    total = total + st["out"][:, slot] + e
                st["out"][:, slot] = total & 0xFFFF
    if io:
        last = (steps - 1) % ring
        row = sum(st["out"][:, last] for st in state) + state[0]["prev"]
    else:
        row = sum(st["prev"] + st["pmin"][:, None, :] for st in state)
    return (row & 0xFFFF).to(torch.uint16)


def chain_plain(x, steps: int, rolls: Sequence[int] = (0,),
                p1: int = 10) -> torch.Tensor:
    return _recurrence_plain(x, steps, rolls, p1)


def chain_lanes(d: int, paths: int, sms: int) -> int:
    """The lanes of a warp that walk one path in ``chain``/``chainio``:
    four (eight where D > 128: a lane holds at most 32 disparities), and
    eight also where four would give the launch fewer warps than half the
    schedulers of a card with ``sms`` SMs (four an SM).  More lanes cut a
    step's instructions and add a shuffle to its dependent chain; on an
    H100 four won at every cone shape of the recurrence-floor ladder and
    eight only where the paths are few (PERF.md section 6)."""
    if d > 128 or paths * 4 < sms * 4 * 32 // 2:
        return 8
    return 4


def chain_words(d: int, lanes: int) -> int:
    """32-bit words (two disparities each) a lane holds: the smallest power
    of two with 2 * words * lanes >= D."""
    words = 1
    while 2 * words * lanes < d:
        words *= 2
    return words


def chain_block(n: int, lanes: int) -> tuple:
    """(threads, columns) of a block: the n directions of each column, each
    ``lanes`` threads, in whole warps of 64 threads (128 where n * lanes >
    16)."""
    target = 64 if n * lanes <= 16 else 128
    cols = max(1, target // (n * lanes))
    return -(-cols * n * lanes // 32) * 32, cols


def _u16x2(fn, *words):
    """fn applied to the low and the high 16-bit lanes of int64 words."""
    lo = fn(*(w & 0xFFFF for w in words)) & 0xFFFF
    hi = fn(*(w >> 16 for w in words)) & 0xFFFF
    return lo | (hi << 16)


def chain_pack(rows, lanes: int, fill: int) -> torch.Tensor:
    """int (..., D, P) rows -> int64 (..., lanes, words, P) as the kernel of
    ``chain`` holds them: lane g's word i has disparity 2 g W + i in its low
    16 bits and 2 g W + W + i in its high 16 bits; disparities >= D (the
    dead lanes) hold ``fill``."""
    d = rows.shape[-2]
    words = chain_words(d, lanes)
    pad = 2 * words * lanes - d
    x = rows.to(torch.int64)
    if pad:
        x = torch.cat([x, torch.full_like(x[..., :1, :], fill).expand(
            *x.shape[:-2], pad, x.shape[-1])], -2)
    x = x.reshape(*x.shape[:-2], lanes, 2, words, x.shape[-1])
    return x[..., 0, :, :] | (x[..., 1, :, :] << 16)


def chain_unpack(words: torch.Tensor, d: int) -> torch.Tensor:
    """The inverse of ``chain_pack``: int64 (..., D, P) rows."""
    x = torch.stack([words & 0xFFFF, words >> 16], -3)   # (..., L, 2, W, P)
    return x.flatten(-4, -2)[..., :d, :]


def chain_step_packed(prev, pmin, cost, p1: int, p2, d: int) -> tuple:
    """One step of the kernel of ``chain``/``chainio`` on packed words
    (``chain_pack``; ``prev`` with its dead lanes at 255, ``cost`` at 0) and
    the path minima ``pmin`` (..., P); ``p2`` an int or int (..., P).  The
    kernel's own instructions: L(d -+ 1) of a word are the words before and
    after it, the lane's end words joined by __byte_perm(a, b, 0x5432) with
    the neighbour lane's end word or a 255-sentinel word;
    min(L(d -+ 1) + P1, L(d)) as __viaddmin_u16x2 with P1 clamped to 255;
    the min with q = pmin + min(P2, 255) in both halves, or, for
    t = pmin + P2 < 0 (int32, wrapping), with 0 and t mod 256 added; one
    add of m, cost + 256 and -pmin, the & 0x00FF00FF and the dead lanes set
    to 255; the new pmin as a min over the words, the two halves and the
    lanes.  -> (words, pmin)."""
    lanes, nwords = prev.shape[-3], prev.shape[-2]
    both = 0x00010001
    lead, cols = prev.shape[:-3], prev.shape[-1]
    sentinel = torch.full((*lead, 1, 1, cols), SENTINEL * both,
                          dtype=torch.int64)
    g = torch.arange(lanes)[:, None]
    low = 2 * g * nwords + torch.arange(nwords)[None, :]        # (L, W)
    dead = ((low >= d).long() * 0xFF | (low + nwords >= d).long() * 0xFF0000)
    dead = dead[..., None]
    p1x2 = min(p1, 255) * both
    pmin = pmin.to(torch.int64)
    p2 = (p2.to(torch.int64) if torch.is_tensor(p2)
          else torch.full_like(pmin, p2))
    tm = (pmin + p2 + 2 ** 31) % 2 ** 32 - 2 ** 31            # int32 wrap
    q = torch.where(p2 < 0, tm.clamp(0, 255), pmin + p2.clamp(max=255))
    adj = torch.where(tm < 0, tm & 0xFF, torch.zeros_like(tm))
    q2 = (q * both)[..., None, None, :]
    sub = ((pmin - adj) * both)[..., None, None, :]
    # the words before and after each word; the lane's end words join the
    # halves that meet there, with lane g - 1's last word and g + 1's first
    below = torch.cat([sentinel, prev[..., :-1, -1:, :]], -3)
    above = torch.cat([prev[..., 1:, :1, :], sentinel], -3)

    def perm5432(a, b):
        return (a >> 16) | ((b & 0xFFFF) << 16)

    left = torch.cat([perm5432(below, prev[..., -1:, :]), prev[..., :-1, :]],
                     -2)
    right = torch.cat([prev[..., 1:, :], perm5432(prev[..., :1, :], above)],
                      -2)

    def viaddmin(a, b, c):
        return _u16x2(lambda x, y, z: torch.minimum((x + y) & 0xFFFF, z), a,
                      torch.full_like(a, b), c)

    def vmin(a, b):
        return _u16x2(torch.minimum, a, b.expand_as(a))

    near = viaddmin(right, p1x2, viaddmin(left, p1x2, prev))
    cur = (((vmin(near, q2) + cost + 0x01000100 - sub) & 0xFFFFFFFF)
           & 0x00FF00FF) | dead
    mn = cur[..., 0, :]
    for i in range(1, nwords):
        mn = vmin(mn, cur[..., i, :])
    mn = vmin(mn, (mn >> 16) | ((mn & 0xFFFF) << 16))
    new_min = mn[..., 0, :]
    for lane in range(1, lanes):
        new_min = vmin(new_min, mn[..., lane, :])
    return cur, new_min & 0xFFFF


def chain_step_plain(prev, pmin, cost, p1: int, p2, lanes: int) -> tuple:
    """``chain_step_packed`` on int (..., D, P) rows, for the tests, which
    hold it against the step of the JAX script's ``chain_kernel`` over the
    uint8 domain: -> (int64 (..., D, P) rows, int64 (..., P) minima)."""
    d = prev.shape[-2]
    cur, new_min = chain_step_packed(chain_pack(prev, lanes, SENTINEL),
                                     pmin.to(torch.int64),
                                     chain_pack(cost, lanes, 0), p1, p2, d)
    return chain_unpack(cur, d), new_min


def chain_packed_plain(x, steps: int, p1: int, lanes: int) -> torch.Tensor:
    """``chain`` for one straight direction as its kernel runs it: the
    packed state carried from step to step with its dead lanes, the cost
    row packed once.  -> the same uint16 (B, D, P) row as ``chain_plain``."""
    d = x.shape[-2]
    cost = ((torch.arange(d, dtype=torch.int64) * 7 + 13) & 0x7F)[None, :, None]
    cost = chain_pack(cost ^ (x.to(torch.int64) & 1), lanes, 0)
    prev = chain_pack(torch.zeros(x.shape, dtype=torch.int64), lanes, SENTINEL)
    pmin = torch.zeros((x.shape[0], x.shape[-1]), dtype=torch.int64)
    for _ in range(steps):
        prev, pmin = chain_step_packed(prev, pmin, cost, p1, CHAIN_P2, d)
    row = chain_unpack(prev, d) + pmin[:, None, :]
    return (row & 0xFFFF).to(torch.uint16)


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_chain(x, steps: int, rolls, p1: int, lanes) -> tuple:
    _check(x, "x", torch.uint16, 3)
    b, d, p = x.shape
    if not 1 <= d <= 256:
        raise ValueError(f"disparity range {d} outside the kernel's 1..256")
    if steps < 1:
        raise ValueError(f"steps={steps}: need at least one")
    if not 1 <= len(rolls) <= MAX_ROLLS:
        raise ValueError(f"{len(rolls)} directions: the kernel takes 1..{MAX_ROLLS}")
    if not 0 <= p1 <= 0x7FFFFF00:
        raise ValueError(f"p1={p1}: the kernel takes 0..2**31 - 256, where "
                         f"min(up, dn) + p1 cannot wrap")
    if lanes is None:
        lanes = chain_lanes(d, b * p * len(rolls), _sm_count(x.device.index))
    elif lanes not in (1, 2, 4, 8) or 32 * lanes < d:
        raise ValueError(f"lanes={lanes}: 1, 2, 4 or 8, at least D / 32")
    return b, d, p, lanes


def chain(x: torch.Tensor, steps: int, rolls: Sequence[int] = (0,),
          p1: int = 10, lanes: int | None = None) -> torch.Tensor:
    """P1.  uint16 (B, D, P) -> uint16 (B, D, P): ``steps`` steps of the SGM
    recurrence on every one of the B * P paths and every direction of
    ``rolls`` (0 straight, +-1 the wrapping diagonals), from a zero state,
    with the cost row ((7 d + 13) & 0x7F) ^ (x & 1) of the path's first pixel
    and P2 = 150; the row is the sum over the directions of state + min at
    the paths' last pixels.  One launch; on the card ``p1`` >= 0.
    ``lanes``: the lanes a path takes; None (the rule of ``chain_lanes``)
    except where a measurement compares the choices."""
    if _on_cpu(x):
        return chain_plain(x, steps, rolls, p1)
    b, d, p, lanes = _check_chain(x, steps, rolls, p1, lanes)
    out = torch.empty_like(x)
    arr = (ctypes.c_int * len(rolls))(*rolls)
    _launch("sgm_probe_chain", "probe_chain", x.data_ptr(), out.data_ptr(), b,
            d, p, steps, len(rolls), ctypes.addressof(arr), p1, lanes,
            _stream(out))
    return out


def chainio_plain(x, cost_ring, p2_ring, steps: int,
                  rolls: Sequence[int] = (0,), extra_u16: int = 0,
                  p1: int = 10) -> torch.Tensor:
    return _recurrence_plain(x, steps, rolls, p1, cost_ring, p2_ring, extra_u16)


def chainio_shared_bytes(d: int, n: int, ring: int, lanes: int) -> int:
    """Dynamic shared memory of a ``chainio`` block, as the kernel lays it
    out: per path an int32 row to sum (its 2 * words * lanes disparities),
    and ``ring`` slots of the cost row and of the uint16 output row (a word
    per two disparities, each) and a P2 word."""
    words = chain_words(d, lanes)
    threads, _ = chain_block(n, lanes)
    paths, dpad = threads // lanes, 2 * words * lanes
    return paths * dpad * 4 + ring * (2 * 4 * threads * words + 4 * paths)


def chainio(x: torch.Tensor, cost_ring: torch.Tensor, p2_ring: torch.Tensor,
            steps: int, rolls: Sequence[int] = (0,), extra_u16: int = 0,
            p1: int = 10, lanes: int | None = None) -> torch.Tensor:
    """P2.  ``chain`` plus a production pass's per-step traffic from on-chip
    memory.  ``cost_ring`` int32 (B, R, D, P) and ``p2_ring`` int32
    (B, n, R, P) are R steps of a cost volume and of the directions' P2
    rows; step s uses slot s mod R, the cost row being
    (cost_ring ^ (x & 1)) & 0xFF.  Per step and direction: the cost row and
    the P2 value are read, ``extra_u16`` times the slot's uint16 output row
    is read and added (plus 0, 1, ...), and the row is stored.  A ring
    travels with its path (see ``_recurrence_plain``); with R = steps it is
    the whole volume.  The result row is the sum of the directions' last
    output rows plus direction 0's state.  One launch; on the card ``p1``
    >= 0 (P2 may be any int32); ``lanes`` as for ``chain``."""
    if _on_cpu(x, cost_ring, p2_ring):
        return chainio_plain(x, cost_ring, p2_ring, steps, rolls, extra_u16, p1)
    b, d, p, lanes = _check_chain(x, steps, rolls, p1, lanes)
    n = len(rolls)
    _check(cost_ring, "cost_ring", torch.int32, 4)
    _check(p2_ring, "p2_ring", torch.int32, 4)
    ring = cost_ring.shape[1]
    if ring < 1 or cost_ring.shape != (b, ring, d, p):
        raise ValueError(f"cost_ring: expected {(b, 'R', d, p)}, got "
                         f"{tuple(cost_ring.shape)}")
    if p2_ring.shape != (b, n, ring, p):
        raise ValueError(f"p2_ring: expected {(b, n, ring, p)}, got "
                         f"{tuple(p2_ring.shape)}")
    if not 0 <= extra_u16 <= 0xFFFF:
        raise ValueError(f"extra_u16={extra_u16} outside 0..65535")
    need = chainio_shared_bytes(d, n, ring, lanes)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"a ring of {ring} steps at D={d}, {n} directions "
                         f"needs {need} bytes of shared memory, over the "
                         f"block's {MAX_SHARED_BYTES}")
    out = torch.empty_like(x)
    arr = (ctypes.c_int * n)(*rolls)
    _launch("sgm_probe_chainio", "probe_chainio", x.data_ptr(),
            cost_ring.data_ptr(), p2_ring.data_ptr(), out.data_ptr(), b, d, p,
            steps, n, ctypes.addressof(arr), ring, extra_u16, p1, lanes,
            _stream(out))
    return out


# --- P4: the 16-bit recurrence --------------------------------------------------------

def rung_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    v = x.to(torch.int32)
    if name in LOOP_RUNGS:
        state = torch.zeros_like(v[:, 0])
        rows = []
        for s in range(v.shape[1]):
            xs = v[:, s]
            state = state + xs if name == "p5b" else torch.minimum(state, xs + 1)
            rows.append(xs + state)
        r = torch.stack(rows, dim=1)
    elif name == "p0":
        r = v
    elif name == "p1":
        r = v + v.roll(1, -1)
    elif name == "p2":
        r = v + v.roll(2, -2)
    elif name == "p3":
        r = v + v.roll(1, -2)
    elif name == "p4":
        r = v.roll(1, -2)
        r[:, 0] = SENTINEL
    elif name == "p6":
        cm, shift = v, 1
        while shift < v.shape[1]:
            cm = torch.minimum(cm, cm.roll(shift, -2))
            shift *= 2
        r = v + cm
    elif name == "p8":
        r = torch.minimum(v, v.roll(1, -1))
    elif name == "p9":
        y = v.roll(1, -1)
        r = torch.where(v < y, v, y)
    elif name == "p10":
        y = v.roll(1, -1)
        diff = v - y
        r = y + (diff & (diff >> 15))
    else:
        raise ValueError(f"unknown rung {name!r}; one of {sorted(RUNGS)}")
    return (r & 0xFFFF).to(torch.uint16)


def rung(name: str, x: torch.Tensor) -> torch.Tensor:
    """P4, one rung: uint8 (B, R, W) -> uint16 (B, R, W).  R is D (even, at
    most 256) for the plane rungs, which shift along D and W circularly, and
    the number of rows for the loop rungs ``p5`` and ``p5b``."""
    if name not in RUNGS:
        raise ValueError(f"unknown rung {name!r}; one of {sorted(RUNGS)}")
    if _on_cpu(x):
        return rung_plain(name, x)
    _check(x, "x", torch.uint8, 3)
    b, r, w = x.shape
    if name not in LOOP_RUNGS and (r % 2 or r > 256):
        raise ValueError(f"rung {name}: D={r} must be even and at most 256")
    out = torch.empty(x.shape, dtype=torch.uint16, device=x.device)
    _launch("sgm_probe_rung", "probe_int16", x.data_ptr(), out.data_ptr(),
            RUNGS[name], b, r, w, _stream(out))
    return out


def int16_safe(p1: int, p2_init: int) -> bool:
    """Whether no intermediate of the 16-bit recurrence can overflow: the
    largest are 255 + P1 and 255 + max(P1, P2)."""
    return max(p1, p2_init) + 512 <= 32767


def scan16_plain(cost, img, rolls, reverse: bool, p1: int, p2_init: int,
                 restart: bool) -> torch.Tensor:
    return ops_kernels.directional_scan_group_plain(
        cost, img, None, rolls, reverse, p1, p2_init, restart)


def _weave(a, b):
    """(a's high half, b's low half): the packed pair one disparity on."""
    return (a >> 16) | ((b & 0xFFFF) << 16)


def scan16_step_plain(prev, prev_min, prev_gray, cost_row, gray_row, p1: int,
                      p2_init: int) -> torch.Tensor:
    """``aggregation._dp_step`` the way ``scan16`` computes it: two
    neighbouring disparities in the 16-bit lanes of a word (the even one
    low; for odd D the high half of the last word a dead lane held at 255),
    L(d - 1) and L(d + 1) woven from neighbouring words with 255-sentinel
    words beyond both ends, P2' from ``p2_table`` and the path minimum the
    same in both halves (they belong to the column), lane-wise minima, one
    add-and-min, and ``(cost + m - pmin) & 0x00FF00FF``.  int (..., D, P)
    rows -> the (..., D, P) int64 step result; for the tests, which hold it
    against ``_dp_step`` over the uint8 domain."""
    d = prev.shape[-2]

    def pack(x):
        x = x.to(torch.int64)
        if d % 2:
            x = torch.cat([x, torch.full_like(x[..., :1, :], SENTINEL)], -2)
        return ops_kernels._lanes(x[..., 0::2, :], x[..., 1::2, :])

    def vmin(a, b):     # per 16-bit lane
        return ops_kernels._lanes(torch.minimum(a & 0xFFFF, b & 0xFFFF),
                                  torch.minimum(a >> 16, b >> 16))

    def both(v):
        return (v * 0x00010001)[..., None, :]

    wc = pack(prev)
    pad = torch.full_like(wc[..., :1, :], SENTINEL * 0x00010001)
    wm = torch.cat([pad, wc[..., :-1, :]], dim=-2)
    wp = torch.cat([wc[..., 1:, :], pad], dim=-2)
    table = ops_kernels.p2_table(p1, p2_init)
    p2 = table[(gray_row.to(torch.int64) - prev_gray.to(torch.int64)).abs()]
    pmin = prev_min.to(torch.int64)
    p1pk = min(p1, ops_kernels.P_CLAMP) * 0x00010001
    near = vmin(vmin(_weave(wm, wc), _weave(wc, wp)) + p1pk, wc)
    m = vmin(near, both(pmin + p2))
    cur = (pack(cost_row) + m - both(pmin)) & 0x00FF00FF
    out = torch.stack([cur & 0xFFFF, cur >> 16], dim=-2)   # (..., D2, 2, P)
    return out.flatten(-3, -2)[..., :d, :]


def scan16_capacity(cost: torch.Tensor) -> int:
    """The most directions one ``sgm_probe_scan16`` launch takes for this
    uint8 (B, S, D, W) cost on the current card (``MAX_GROUP`` at most): its
    16-bit state takes twice the shared memory of the group scan's bytes, so
    at 1000x1500, D = 256 a launch takes one."""
    b, _, d, w = cost.shape
    dirs = ctypes.c_int(0)
    err = _build.load().sgm_probe_scan16_capacity(b, d, w,
                                                  ctypes.addressof(dirs))
    if err != 0:
        raise RuntimeError(f"sgm_probe_scan16_capacity: CUDA error {err}")
    if dirs.value < 1:
        raise ValueError(f"D={d}, W={w}: a row's 16-bit scan state does not "
                         f"fit the kernel's on-chip memory")
    return dirs.value


def scan16(cost: torch.Tensor, img: torch.Tensor, rolls: Sequence[int],
           reverse: bool, p1: int, p2_init: int, restart: bool) -> torch.Tensor:
    """P4, rung p7: ``ops.kernels.directional_scan_group`` without carries,
    its state in packed 16-bit lanes.  uint8 (B, S, D, W) cost + uint8
    (B, S, W) image -> the uint16 (B, S, D, W) sum of the directions'
    contributions.  One launch for the group where ``scan16_capacity``
    takes it whole, else one per part (each counted)."""
    if not int16_safe(p1, p2_init):
        raise ValueError(f"p1={p1}, p2_init={p2_init} could overflow 16 bits")
    rolls = tuple(rolls)
    if not rolls or any(r not in (-1, 0, 1) for r in rolls):
        raise ValueError(f"rolls {rolls}: need one or more of -1, 0, 1")
    if _on_cpu(cost, img):
        return scan16_plain(cost, img, rolls, reverse, p1, p2_init, restart)
    b, s, d, w = ops_kernels._check_scan(cost, img)
    ops_kernels._check_penalties(p1, p2_init)
    out = torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    per_launch = scan16_capacity(cost)
    group = ops_kernels.MAX_GROUP
    for k0 in range(0, len(rolls), per_launch):
        sub = rolls[k0:k0 + per_launch]
        _launch("sgm_probe_scan16", "probe_int16", cost.data_ptr(),
                img.data_ptr(), out.data_ptr(), b, s, d, w, len(sub),
                *(sub + (0,) * group)[:group], int(reverse), int(restart), p1,
                p2_init, int(k0 > 0), _stream(out))
    return out


# --- S1: connected-component labels by min-propagation ------------------------------------

# neighbour (dr, dc) of link-mask bit 0..5; bits 2-5 are the diagonal order
CC_OFFSETS = ((0, -1), (-1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))
LABEL_MODES = {"base": 0, "pair": 1, "fori16": 2, "block4": 3, "pyr": 4}
BLOCK_FRAMES = 4        # frames per program of ``block4``
FIXED_ROUNDS = 16       # of ``fori16``: 8 seg+cheap pairs, no check
SPECKLE_PC = 2048       # pixels per chunk of the tail's grouped label layout


def ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def label_bits(w: int) -> int:
    """Low bits of a label that hold its column: label = (row << bits) | col."""
    return max(ceil_log2(w), 7)


def link_mask(disp: torch.Tensor, diff: float) -> torch.Tensor:
    """int32 (B, H, W): bit k set where the pixel links to its neighbour
    ``CC_OFFSETS[k]``: both finite, in the frame, and |dd| <= diff in f32."""
    finite = torch.isfinite(disp)
    d = torch.where(finite, disp, 1e30)
    diff = float(np.float32(diff))
    mask = torch.zeros(disp.shape, dtype=torch.int32, device=disp.device)
    for bit, (dr, dc) in enumerate(CC_OFFSETS):
        nd = _shift2d(d, dr, dc, 0.0)
        nf = _shift2d(finite, dr, dc, False)
        mask |= (finite & nf & ((d - nd).abs() <= diff)).to(torch.int32) << bit
    return mask


def _run_min(lab, conn, axis: int, big: int):
    """Every pixel's minimum over its maximal run of linked pixels along
    ``axis`` (-1 columns, -2 rows); ``conn`` (bool) links k to k - 1.  By
    doubling, as the JAX kernel: min-scans from both ends of the run."""
    def shifted(x, s, fill):        # x[k + s] along axis
        return _shift2d(x, 0, s, fill) if axis == -1 else _shift2d(x, s, 0, fill)

    fwd_c, fwd_v = conn, lab
    bwd_c, bwd_v = shifted(conn, 1, False), lab         # links k to k + 1
    for step in range(ceil_log2(lab.shape[axis])):
        s = 1 << step
        fwd_v = torch.minimum(fwd_v, torch.where(fwd_c, shifted(fwd_v, -s, big), big))
        fwd_c = fwd_c & shifted(fwd_c, -s, False)
        bwd_v = torch.minimum(bwd_v, torch.where(bwd_c, shifted(bwd_v, s, big), big))
        bwd_c = bwd_c & shifted(bwd_c, s, False)
    return torch.minimum(fwd_v, bwd_v)


def _bit(mask, k: int):
    return (mask >> k) & 1 != 0


def _diag_pass(new, mask, big: int):
    """The four diagonal link-mins, each on the plane the last one wrote."""
    for bit, (dr, dc) in zip((2, 3, 4, 5), CC_OFFSETS[2:]):
        new = torch.minimum(new, torch.where(_bit(mask, bit),
                                             _shift2d(new, dr, dc, big), big))
    return new


def seg_round(lab, mask, big: int):
    """Run-min over horizontal runs, then over vertical runs of that, then
    the diagonal pass."""
    new = _run_min(lab, _bit(mask, 0), -1, big)
    new = _run_min(new, _bit(mask, 1), -2, big)
    return _diag_pass(new, mask, big)


def cheap_round(lab, mask, big: int):
    """Link-mins with the left, right and upper neighbour of the old plane,
    with the lower neighbour of the new one, then the diagonal pass."""
    conn_h, conn_v = _bit(mask, 0), _bit(mask, 1)
    new = lab
    for edge, (dr, dc) in ((conn_h, (0, -1)),
                           (_shift2d(conn_h, 0, 1, False), (0, 1)),
                           (conn_v, (-1, 0))):
        new = torch.minimum(new, torch.where(edge, _shift2d(lab, dr, dc, big), big))
    new = torch.minimum(new, torch.where(_shift2d(conn_v, 1, 0, False),
                                         _shift2d(new, 1, 0, big), big))
    return _diag_pass(new, mask, big)


# how S1's kernel decomposes a round (csrc/probe_speckle.cu)
VRUN_CHUNKS = 32                  # chunks of rows of a vertical run-min
HRUN_LANE_COLS = 8                # columns a lane of a horizontal one takes
TILE = (32, 64)                   # rows, columns of a fused step's tile
TILE_HALO = 4


def run_min_chunked(lab, mask, axis: int, big: int,
                    length: int) -> torch.Tensor:
    """``_run_min`` along ``axis`` (-1 columns with link bit 0, -2 rows
    with bit 1) the way S1's kernel takes it: the axis cut into chunks of
    ``length``; along each chunk, the run-min from the start within it;
    the chunks' summaries (the min of the first and of the last run,
    whether the chunk's first pixel links back, whether the chunk is one
    run) scanned over the chunks for what enters each from either end;
    then back along each chunk.  int32 (..., H, W) labels and link mask ->
    (..., H, W)."""
    if axis == -1:
        return run_min_chunked(lab.transpose(-1, -2),
                               (mask.transpose(-1, -2) & 1) << 1, -2, big,
                               length).transpose(-1, -2)
    n = lab.shape[-2]
    up = _bit(mask, 1)
    fwd = torch.empty_like(lab)
    out = torch.empty_like(lab)
    full = torch.full_like(lab[..., 0, :], big)
    spans, summary = [], []
    for r0 in range(0, n, length):
        r1 = min(n, r0 + length)
        run, first = full, full
        head = torch.zeros_like(up[..., 0, :])
        whole = ~head
        brk = torch.full_like(lab[..., 0, :], r1)
        for r in range(r0, r1):
            u, v = up[..., r, :], lab[..., r, :]
            if r == r0:
                head = u
                run = v
            else:
                ends = whole & ~u           # the chunk's first run ends here
                first = torch.where(ends, run, first)
                brk = torch.where(ends, r, brk)
                whole = whole & u
                run = torch.where(u, torch.minimum(run, v), v)
            fwd[..., r, :] = run
        spans.append((r0, r1))
        summary.append((torch.where(whole, run, first), run, head, whole, brk))
    chunks = len(spans)
    above, below = [None] * chunks, [None] * chunks
    carry = full
    for k, (_, bot, head, whole, _) in enumerate(summary):
        above[k] = torch.where(head, carry, big)
        carry = torch.where(whole & head, torch.minimum(bot, carry), bot)
    carry, next_head = full, torch.zeros_like(up[..., 0, :])
    for k in reversed(range(chunks)):
        top, _, head, whole, _ = summary[k]
        below[k] = torch.where(next_head, carry, big)
        carry = torch.where(whole & next_head, torch.minimum(top, carry), top)
        next_head = head
    for k, (r0, r1) in enumerate(spans):
        run = below[k]
        for r in reversed(range(r0, r1)):
            v = lab[..., r, :]
            run = torch.minimum(run, v) if r + 1 == r1 else torch.where(
                up[..., r + 1, :], torch.minimum(run, v), v)
            o = torch.minimum(run, fwd[..., r, :])
            out[..., r, :] = torch.where(r < summary[k][4],
                                         torch.minimum(o, above[k]), o)
    return out


def _tile_step(val, mask, kind: int) -> torch.Tensor:
    """One of a fused step's steps on (..., R, C) tile arrays, every cell
    but the outer ring: kind 0 the left, right and upper link-mins, 1 the
    lower one, 2-5 the diagonal of that mask bit."""
    new = val.clone()
    core = (..., slice(1, -1), slice(1, -1))

    def at(dr, dc):
        return val[..., 1 + dr:val.shape[-2] - 1 + dr,
                   1 + dc:val.shape[-1] - 1 + dc]

    def bits(m, k):
        return (m >> k) & 1 != 0

    def mk(dr, dc):
        return mask[..., 1 + dr:mask.shape[-2] - 1 + dr,
                    1 + dc:mask.shape[-1] - 1 + dc]

    v = val[core]
    if kind == 0:
        for link, (dr, dc) in ((bits(mk(0, 0), 0), (0, -1)),
                               (bits(mk(0, 1), 0), (0, 1)),
                               (bits(mk(0, 0), 1), (-1, 0))):
            v = torch.where(link, torch.minimum(v, at(dr, dc)), v)
    elif kind == 1:
        v = torch.where(bits(mk(1, 0), 1), torch.minimum(v, at(1, 0)), v)
    else:
        dr, dc = CC_OFFSETS[kind]
        v = torch.where(bits(mk(0, 0), kind), torch.minimum(v, at(dr, dc)), v)
    new[core] = v
    return new


def fused_steps_tiled(lab, mask, big: int, cheap: bool, tile=TILE,
                      halo: int = TILE_HALO) -> torch.Tensor:
    """The steps of a round that look at neighbours only, the way S1's
    kernel fuses them: with ``cheap`` all of ``cheap_round``, else the four
    diagonal steps of ``_diag_pass``, run on tiles of ``tile`` pixels with
    ``halo`` pixels around them (``big`` and no links beyond the frame),
    each step on all but the tile's outer ring, the tile's own pixels kept.
    int32 (..., H, W) labels and link mask -> (..., H, W)."""
    h, w = lab.shape[-2:]
    th, tw = tile
    padded_lab = torch.nn.functional.pad(lab, (halo, halo + tw, halo, halo + th),
                                         value=big)
    padded_mask = torch.nn.functional.pad(mask, (halo, halo + tw, halo,
                                                 halo + th), value=0)
    out = torch.empty_like(lab)
    kinds = ((0, 1) if cheap else ()) + (2, 3, 4, 5)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            rows = slice(r0, r0 + th + 2 * halo)
            cols = slice(c0, c0 + tw + 2 * halo)
            val, m = padded_lab[..., rows, cols], padded_mask[..., rows, cols]
            for kind in kinds:
                val = _tile_step(val, m, kind)
            inner = val[..., halo:halo + th, halo:halo + tw]
            rr, cc = min(th, h - r0), min(tw, w - c0)
            out[..., r0:r0 + rr, c0:c0 + cc] = inner[..., :rr, :cc]
    return out


def kernel_round_plain(lab, mask, big: int, seg: bool,
                       chunks: int = VRUN_CHUNKS,
                       lane_cols: int = HRUN_LANE_COLS, tile=TILE,
                       halo: int = TILE_HALO) -> torch.Tensor:
    """``seg_round`` or ``cheap_round`` as S1's kernel decomposes it: a seg
    round is ``run_min_chunked`` along the rows (chunks of ``lane_cols``
    columns, a lane's) and along the columns (``chunks`` chunks of rows, a
    warp's), then the fused diagonal steps; a cheap round one fused
    step."""
    if not seg:
        return fused_steps_tiled(lab, mask, big, True, tile, halo)
    h = lab.shape[-2]
    new = run_min_chunked(lab, mask, -1, big, lane_cols)
    new = run_min_chunked(new, mask, -2, big, -(-h // chunks))
    return fused_steps_tiled(new, mask, big, False, tile, halo)


def _check_labels_args(disp, mode: str) -> tuple:
    if mode not in LABEL_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {sorted(LABEL_MODES)}")
    if disp.dim() != 3 or disp.dtype != torch.float32:
        raise TypeError(f"disp: expected f32 (B, H, W), got {disp.dtype} "
                        f"{tuple(disp.shape)}")
    b, h, w = disp.shape
    if mode == "block4" and b % BLOCK_FRAMES:
        raise ValueError(f"block4 takes batches of a multiple of "
                         f"{BLOCK_FRAMES} frames, got {b}")
    if (h + 1) << label_bits(w) >= 2 ** 31 or max(h, w) >= 2 ** 15:
        raise ValueError(f"a {h}x{w} frame's labels do not fit int32")
    return b, h, w


def speckle_labels_plain(disp, diff: float = 1.0, mode: str = "base"):
    b, h, w = _check_labels_args(disp, mode)
    lo_bits = label_bits(w)
    big = h << lo_bits
    dev = disp.device
    mask = link_mask(disp, diff)
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    lab = ((rows << lo_bits) | cols).expand(b, h, w).contiguous()
    paired = mode in ("pair", "fori16", "block4")
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    still = torch.zeros(b, dtype=torch.bool, device=dev)
    it = 0
    while b:
        if paired:
            new = cheap_round(seg_round(lab, mask, big), mask, big)
            it += 2
        else:
            new = (cheap_round if it % 2 else seg_round)(lab, mask, big)
            it += 1
        # a frame that is still stays so: both rounds hold a fixed point
        rounds = torch.where(still, rounds, it)
        still |= ~(new != lab).flatten(1).any(1)
        lab = new
        if it == FIXED_ROUNDS if mode == "fori16" else bool(still.all()):
            break
    if mode == "fori16":
        rounds = torch.full_like(rounds, it)
    if mode == "block4":    # a program runs until its last frame is still
        rounds = rounds.view(-1, BLOCK_FRAMES).amax(1)
    return lab, rounds


def speckle_labels(disp: torch.Tensor, diff: float = 1.0, mode: str = "base"):
    """S1.  f32 (B, H, W) -> (int32 (B, H, W) labels, int32 rounds per
    program).  Labels start as (row << label_bits(W)) | col and are
    min-propagated over the links of ``link_mask`` by whole-plane rounds,
    ``seg_round`` and ``cheap_round`` in turn, so at the fixed point a
    pixel's label is that of the first pixel (row-major) of its component.
    ``mode``: ``base`` checks for the fixed point after every round;
    ``pair`` after every seg+cheap pair; ``fori16`` runs ``FIXED_ROUNDS``
    rounds unchecked (not a fixed point in general); ``block4`` is ``pair``
    with ``BLOCK_FRAMES`` frames to a program, which runs until all are
    still (one round count per program); ``pyr`` is ``base`` with each
    pixel's run heads found once before the loop.  ``rounds`` counts single
    rounds, the last, unchanged one included.  One launch."""
    if _on_cpu(disp):
        return speckle_labels_plain(disp, diff, mode)
    b, h, w = _check_labels_args(disp, mode)
    _check(disp, "disp", torch.float32, 3)
    programs = b // BLOCK_FRAMES if mode == "block4" else b
    labels = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    rounds = torch.empty(programs, dtype=torch.int32, device=disp.device)
    # three label planes and the link mask; pyr: + run heads, two min planes
    scratch = torch.empty((7 if mode == "pyr" else 4, b, h, w),
                          dtype=torch.int32, device=disp.device)
    _launch("sgm_probe_speckle_labels", "probe_speckle_labels",
            disp.data_ptr(), labels.data_ptr(), rounds.data_ptr(),
            scratch.data_ptr(), b, h, w, label_bits(w),
            float(np.float32(diff)), LABEL_MODES[mode], _stream(labels))
    return labels, rounds


def flat_to_root_labels(flat: torch.Tensor) -> torch.Tensor:
    """Flat batch indices (B, H, W), as ``ops.kernels.union_find_labels``
    gives them, in S1's format: (row << label_bits(W)) | col of the pixel
    the index names."""
    _, h, w = flat.shape
    p = flat.to(torch.int32) % (h * w)
    return ((p // w) << label_bits(w)) | (p % w)


# --- S2-S4: the histogram / verdict tail -----------------------------------------------------

def speckle_band_geometry(h: int, w: int, min_area: int,
                          pc: int = SPECKLE_PC) -> tuple:
    """(chunks per group, row band, padded root rows) of the JAX package's
    banded tail.  The port's kernels neither band nor group; this only
    gives the grouped label layout and the root plane's height their JAX
    shapes, so that either side can be swapped for the other."""
    h_hist = -(-h // 16) * 16
    g = 1
    for cand in range(16, 0, -1):
        rows = -(-cand * pc // w) + 1
        if -(-(rows + (min_area - 1) + 16) // 16) * 16 <= 128:
            g = cand
            break
    rows = -(-g * pc // w) + 1
    band = min(h_hist, -(-(rows + (min_area - 1) + 16) // 16) * 16)
    return g, band, h_hist


def group_labels(disp: torch.Tensor, labels: torch.Tensor, min_area: int,
                 pc: int = SPECKLE_PC) -> tuple:
    """The tail's input: (int32 (B, ngroups, 1, g * pc) labels, h_hist,
    lo_bits).  Non-finite pixels and the padding carry the sentinel
    ``h_hist << lo_bits``, which counts nowhere."""
    b, h, w = disp.shape
    lo_bits = label_bits(w)
    g, _, h_hist = speckle_band_geometry(h, w, min_area, pc)
    n, chunk = h * w, g * pc
    ngroups = -(-n // chunk)
    sentinel = h_hist << lo_bits
    flat = torch.where(torch.isfinite(disp), labels, sentinel).reshape(b, n)
    flat = torch.nn.functional.pad(flat, (0, ngroups * chunk - n), value=sentinel)
    return flat.reshape(b, ngroups, 1, chunk).contiguous(), h_hist, lo_bits


def ungroup_verdict(verdict: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """f32 0/1 (B, ngroups, 1, g * pc) -> bool (B, H, W)."""
    b = verdict.shape[0]
    return verdict.reshape(b, -1)[:, :h * w].reshape(b, h, w) > 0


def apply_verdict(disp: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(disp) & small, torch.inf, disp)


def label_index(labels: torch.Tensor, size: int):
    """(valid, flat index into a (B, size) root plane) of grouped labels."""
    flat = labels.flatten(1).long()
    return (flat >= 0) & (flat < size), flat.clamp(0, size - 1)


def speckle_hist_plain(labels, h_hist: int, lo_bits: int) -> torch.Tensor:
    b, size = labels.shape[0], h_hist << lo_bits
    valid, idx = label_index(labels, size)
    idx = idx + torch.arange(b, device=labels.device)[:, None] * size
    counts = torch.bincount(idx[valid], minlength=b * size)
    return counts.reshape(b, h_hist, 1 << lo_bits).to(torch.int32)


def _check_grouped(labels: torch.Tensor) -> None:
    _check(labels, "labels", torch.int32, 4)
    if labels.shape[2] != 1:
        raise ValueError(f"labels: expected (B, ngroups, 1, g * pc), got "
                         f"{tuple(labels.shape)}")


def _check_root_plane(h_hist: int, lo_bits: int) -> None:
    if h_hist < 1 or not 0 <= lo_bits < 31 or (h_hist + 1) << lo_bits >= 2 ** 31:
        raise ValueError(f"a root plane of {h_hist} rows of 2^{lo_bits} "
                         f"columns does not fit int32 labels")


def speckle_hist(labels: torch.Tensor, h_hist: int, lo_bits: int,
                 aggregate: bool = True) -> torch.Tensor:
    """S2.  int32 (B, ngroups, 1, g * pc) labels -> int32 (B, h_hist,
    1 << lo_bits) pixels per component, stored at the root's (row, col) =
    (label >> lo_bits, label & (lo - 1)); a label outside the plane (the
    sentinel) counts nowhere.  Exact for every component; the JAX kernel's
    banded count is exact below ``min_area`` and at least ``min_area``
    above.  ``aggregate`` (the default): runs of equal labels merge in a
    thread, across its warp and in a table of its block, and the block
    adds once per distinct label (``speckle_hist_merge_plain`` transcribes
    it); False: one add per pixel, the probe's control for what contention
    on a large component's word costs.  The counts are the same.  One
    entry call: the zeroing of the counts, then the count."""
    _check_root_plane(h_hist, lo_bits)
    if _on_cpu(labels):
        return speckle_hist_plain(labels, h_hist, lo_bits)
    _check_grouped(labels)
    b = labels.shape[0]
    counts = torch.empty((b, h_hist, 1 << lo_bits), dtype=torch.int32,
                         device=labels.device)
    _launch("sgm_probe_speckle_hist", "probe_speckle_hist", labels.data_ptr(),
            counts.data_ptr(), b, labels[0].numel(), h_hist << lo_bits,
            int(aggregate), _stream(counts))
    return counts


HIST_THREADS, HIST_LABELS = 256, 4      # an S2 block, the labels a thread takes
HIST_TILE = HIST_THREADS * HIST_LABELS  # labels a block takes
HIST_SLOT_BITS = 11                     # its table: twice the keys it can meet
HIST_SLOTS = 1 << HIST_SLOT_BITS


def _hist_slot(key: int) -> int:
    return ((key * 2654435761) & 0xFFFFFFFF) >> (32 - HIST_SLOT_BITS)


def speckle_hist_merge_plain(labels, h_hist: int, lo_bits: int) -> tuple:
    """S2's aggregated count the way its kernel decomposes it, for the
    tests: per frame, blocks of ``HIST_TILE`` labels, a thread four
    neighbouring labels (the tail -1), warps of 32 threads.  A thread's
    equal neighbours form runs; for each position of the quad at which a
    lane starts a run, the warp's lanes that start runs of one label there
    give their summed lengths to the first of them, which adds it into the
    block's table (open addressing at ``_hist_slot``, linear probing); the
    table's entries are added into the counts in the order they were
    claimed.  -> (int32 (B, h_hist, 1 << lo_bits) counts, the number of
    device-memory adds, the most slots a block's table claimed)."""
    b, size = labels.shape[0], h_hist << lo_bits
    flat = labels.reshape(b, -1).cpu().numpy().astype(np.int64)
    per_frame = flat.shape[1]
    counts = np.zeros((b, size), np.int64)
    adds = most = 0
    for f in range(b):
        for start in range(0, per_frame, HIST_TILE):
            tile = np.full(HIST_TILE, -1, np.int64)
            part = flat[f, start:start + HIST_TILE]
            tile[:part.size] = part
            key = np.where((tile >= 0) & (tile < size), tile, -1)
            key = key.reshape(HIST_THREADS, HIST_LABELS)
            run = np.ones_like(key)
            for j in range(HIST_LABELS - 2, -1, -1):
                run[:, j] = np.where(key[:, j] == key[:, j + 1],
                                     run[:, j + 1] + 1, 1)
            head = key >= 0
            head[:, 1:] &= key[:, 1:] != key[:, :-1]
            keys = np.full(HIST_SLOTS, -1, np.int64)
            vals = np.zeros(HIST_SLOTS, np.int64)
            order = []
            for w0 in range(0, HIST_THREADS, 32):
                for j in range(HIST_LABELS):
                    h, k = head[w0:w0 + 32, j], key[w0:w0 + 32, j]
                    for label in dict.fromkeys(k[h].tolist()):  # leader order
                        total = int(run[w0:w0 + 32, j][h & (k == label)].sum())
                        slot = _hist_slot(label)
                        while keys[slot] not in (-1, label):
                            slot = (slot + 1) & (HIST_SLOTS - 1)
                        if keys[slot] == -1:
                            keys[slot] = label
                            order.append(slot)
                        vals[slot] += total
            for slot in order:
                counts[f, keys[slot]] += vals[slot]
            adds += len(order)
            most = max(most, len(order))
    out = torch.from_numpy(counts.astype(np.int32)).reshape(b, h_hist, -1)
    return out, adds, most


def root_small(counts: torch.Tensor, min_area: int) -> torch.Tensor:
    """int8 (B, h_hist, lo): 1 at the roots of components under ``min_area``
    pixels.  The plain op between S2 and S3, as between the JAX launches."""
    return ((counts > 0) & (counts < min_area)).to(torch.int8)


def speckle_verdict_plain(labels, small) -> torch.Tensor:
    small = small.flatten(1)
    valid, idx = label_index(labels, small.shape[1])
    hit = small.gather(1, idx) != 0
    return (valid & hit).to(torch.float32).reshape(labels.shape)


def speckle_verdict(labels: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """S3.  int32 (B, ngroups, 1, g * pc) labels + int8 (B, h_hist, lo)
    ``root_small`` -> f32 0/1 of the labels' shape: ``small`` at the
    label's root, 0 for a label outside the plane.  One launch."""
    if _on_cpu(labels, small):
        return speckle_verdict_plain(labels, small)
    _check_grouped(labels)
    _check(small, "small", torch.int8, 3)
    b = labels.shape[0]
    if small.shape[0] != b:
        raise ValueError(f"small {tuple(small.shape)} does not match labels "
                         f"{tuple(labels.shape)}")
    out = torch.empty(labels.shape, dtype=torch.float32, device=labels.device)
    _launch("sgm_probe_speckle_verdict", "probe_speckle_verdict",
            labels.data_ptr(), small.data_ptr(), out.data_ptr(), b,
            labels.shape[1] * labels.shape[3], small.shape[1] * small.shape[2],
            _stream(out))
    return out


def speckle_tail_fused_plain(labels, min_area: int, h_hist: int,
                             lo_bits: int) -> torch.Tensor:
    counts = speckle_hist_plain(labels, h_hist, lo_bits)
    return speckle_verdict_plain(labels, root_small(counts, min_area))


TAIL_THREADS, TAIL_QUADS = 1024, 4     # an S4 block, the quads a thread holds
TAIL_LABELS = 4 * TAIL_QUADS            # labels a thread holds, at most
TAIL_SLOT_BITS = 14                     # a block's table: at most 2^14 slots


def tail_plan(b: int, per_frame: int, resident: int,
              threads: int = TAIL_THREADS) -> tuple:
    """S4's (blocks, frames a round, rounds, table slot bits) for ``b``
    frames of ``per_frame`` labels on a card that holds ``resident`` blocks
    at once, as the C entry plans them: every block the card holds; as many
    whole frames a round as leave a block no more than ``4 * TAIL_QUADS *
    threads`` labels, the two quads that may cross a round's ends included;
    twice as many slots as the most labels a block takes where that fits,
    else one a label.  Raises where a frame is more than one round takes
    (the entry refuses it)."""
    if resident < 1:
        raise ValueError("the card holds no S4 block at once")
    blocks = resident
    frames = min(b, (blocks * 4 * TAIL_QUADS * threads - 8) // per_frame)
    if frames < 1:
        raise ValueError(f"a frame of {per_frame} labels is more than one "
                         f"round of {blocks} blocks takes")
    share = -(-((frames * per_frame + 6) // 4 + 1) // blocks)
    bits = 5
    while 1 << bits < 8 * share and bits < TAIL_SLOT_BITS:
        bits += 1
    return blocks, frames, -(-b // frames), bits


def _thread_runs(key):
    """(head, run length) of each label of (threads, TAIL_LABELS) keys: a
    head starts a run of one key (not -1) in its thread, the run's length."""
    seg = np.ones(key.shape, bool)
    seg[:, 1:] = key[:, 1:] != key[:, :-1]
    nxt = np.full(key.shape, key.shape[1])
    for p in range(key.shape[1] - 2, -1, -1):
        nxt[:, p] = np.where(seg[:, p + 1], p + 1, nxt[:, p + 1])
    return seg & (key >= 0), nxt - np.arange(key.shape[1])


def _count_into_table(key, bits: int) -> tuple:
    """S4's count of a block's (threads, TAIL_LABELS) keys in its table:
    each thread adds each of its runs at the key's slot (``_hist_slot``'s
    hash at ``bits``, linear probing).  -> (the claimed keys in claim
    order, their counts, the table adds)."""
    head, run = _thread_runs(key)
    lane, pos = np.nonzero(head)
    rnd = (np.cumsum(head, axis=1) - 1)[lane, pos]
    mask = (1 << bits) - 1
    slots = np.full(1 << bits, -1, np.int64)
    vals = np.zeros(1 << bits, np.int64)
    order = []
    for n in np.lexsort((lane, rnd)):   # each thread's first runs first
        label = int(key[lane[n], pos[n]])
        slot = (label * 2654435761 & 0xFFFFFFFF) >> (32 - bits)
        while slots[slot] not in (-1, label):
            slot = (slot + 1) & mask
        if slots[slot] == -1:
            slots[slot] = label
            order.append(slot)
        vals[slot] += run[lane[n], pos[n]]
    return slots[order], vals[order], int(lane.size)


def speckle_tail_blocks_plain(labels, min_area: int, h_hist: int,
                              lo_bits: int, resident: int,
                              aggregate: bool = True,
                              threads: int = TAIL_THREADS) -> tuple:
    """S4 the way its kernel decomposes it, for the tests.  The batch's
    labels are one flat array, cut into rounds of whole frames by
    ``tail_plan``; a round's quads [start // 4, ceil(end / 4)) go to its
    blocks in equal contiguous shares, thread t of a block taking ``held``
    neighbouring quads from q0 + held * t.  A label's key is f * size +
    label inside its frame's root plane, else none.  Per round, every block
    first adds its threads' runs into its table (``_count_into_table``)
    and stores 0 at each key it claimed; then, after every block's zeros,
    adds each claimed key's count; then, after every add, writes each of
    its labels' verdict from the counts.  The counts start as garbage, so a
    key that were read but not zeroed would show.  ``aggregate`` False: a
    zero and an add per label.  -> (f32 verdict of the labels' shape, a
    dict per round and block: "round", "block", "labels", "distinct" keys,
    "zeros" and "adds" to device memory, "table_adds", "slots", "held"
    quads a thread)."""
    b, size = labels.shape[0], h_hist << lo_bits
    flat = labels.reshape(-1).cpu().numpy().astype(np.int64)
    out = np.full(flat.size, np.nan, np.float32)
    stats = []
    if flat.size == 0:
        return torch.from_numpy(out).reshape(labels.shape), stats
    per_frame = flat.size // b
    blocks, frames, rounds, bits = tail_plan(b, per_frame, resident, threads)
    frame = np.arange(flat.size) // per_frame
    key_of = np.where((flat >= 0) & (flat < size), frame * size + flat, -1)
    counts = np.arange(b * size, dtype=np.int64) % 97 - 40     # garbage
    for r in range(rounds):
        start = r * frames * per_frame
        end = min(b, (r + 1) * frames) * per_frame
        q_lo, q_hi = start // 4, -(-end // 4)
        share = -(-(q_hi - q_lo) // blocks)
        held = -(-share // threads)
        parts = []
        for blk in range(blocks):
            q0 = min(q_hi, q_lo + blk * share)
            q1 = min(q_hi, q0 + share)
            p = np.arange(TAIL_LABELS)
            i = 4 * (q0 + held * np.arange(threads))[:, None] + p
            mine = (p < 4 * held) & (i < 4 * q1) & (i >= start) & (i < end)
            key = np.where(mine, key_of[np.clip(i, 0, flat.size - 1)], -1)
            valid = key[key >= 0]
            rec = {"round": r, "block": blk, "labels": int(mine.sum()),
                   "distinct": int(np.unique(valid).size), "held": held,
                   "slots": 1 << bits}
            if aggregate:
                keys, vals, rec["table_adds"] = _count_into_table(key, bits)
            else:
                keys, vals, rec["table_adds"] = valid, np.ones_like(valid), 0
            counts[keys] = 0
            rec["zeros"] = rec["adds"] = int(keys.size)
            parts.append((i, mine, key, keys, vals))
            stats.append(rec)
        for _, _, _, keys, vals in parts:          # after every block's zeros
            np.add.at(counts, keys, vals)
        for i, mine, key, _, _ in parts:           # after every add
            n = np.where(key >= 0, counts[np.maximum(key, 0)], 0)
            out[i[mine]] = ((n > 0) & (n < min_area))[mine]
    return torch.from_numpy(out).reshape(labels.shape), stats


def speckle_tail_plan(b: int, per_frame: int, aggregate: bool = True) -> dict:
    """S4's plan on the current card, from its C entry: {"blocks",
    "frames" a round, "rounds", "bits" of a block's table, "resident":
    blocks the card holds at once}; the first four 0 for an empty batch.
    Raises where the entry would refuse the batch."""
    plan = (ctypes.c_int * 5)()
    err = _build.load().sgm_probe_speckle_fused_plan(b, per_frame,
                                                     int(aggregate),
                                                     ctypes.addressof(plan))
    if err:
        why = ops_kernels.ERRORS.get(err, "")
        raise RuntimeError(f"sgm_probe_speckle_fused_plan: CUDA error {err} "
                           f"{why}".strip())
    return dict(zip(("blocks", "frames", "rounds", "bits", "resident"), plan))


def speckle_tail_fused(labels: torch.Tensor, min_area: int, h_hist: int,
                       lo_bits: int, aggregate: bool = True) -> torch.Tensor:
    """S4.  S2, ``root_small`` and S3 in one cooperative launch, no
    memset: int32 (B, ngroups, 1, g * pc) labels -> f32 0/1 of the same
    shape.  The card's blocks take the batch's labels in contiguous shares
    (in rounds of whole frames where it has more labels than they hold at
    once: ``tail_plan``), each thread up to 16 neighbouring labels, held in
    registers from the one read to the verdict; two grid barriers a round.
    ``aggregate`` (the default): a thread's equal neighbours merged into
    runs and each run added into its block's table in shared memory, a
    zero stored at each key the table claimed before the first barrier, one
    add per claimed key after it (so only the roots that the labels name
    are zeroed; ``speckle_tail_blocks_plain`` transcribes it); False: a zero
    and an add per pixel, the control.  The verdict is the
    same.  The counts live in a scratch plane that nothing zeroes whole.
    Raises where a frame is more than the card's blocks hold at once; an
    empty batch launches nothing."""
    _check_root_plane(h_hist, lo_bits)
    if _on_cpu(labels):
        return speckle_tail_fused_plain(labels, min_area, h_hist, lo_bits)
    _check_grouped(labels)
    b, per_frame = labels.shape[0], labels.shape[1] * labels.shape[3]
    out = torch.empty(labels.shape, dtype=torch.float32, device=labels.device)
    if b == 0 or per_frame == 0:
        return out
    counts = torch.empty((b, h_hist << lo_bits), dtype=torch.int32,
                         device=labels.device)
    _launch("sgm_probe_speckle_fused", "probe_speckle_fused",
            labels.data_ptr(), counts.data_ptr(), out.data_ptr(), b,
            per_frame, h_hist << lo_bits, min_area, int(aggregate),
            _stream(out))
    return out
