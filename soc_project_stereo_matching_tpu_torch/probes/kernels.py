"""Wrappers of the four probe kernels, in the style of ``ops/kernels.py``.

    chain             P1 csrc/probe_recurrence.cu <- recurrence_floor.py chain_kernel
    chainio           P2 csrc/probe_recurrence.cu <- recurrence_floor.py chainio_kernel
    volume_transpose  P3 csrc/probe_transpose.cu  <- aggr_transpose_probe.py
                         (both bodies of its transpose kernel)
    rung, scan16      P4 csrc/probe_int16.cu      <- mosaic_int16_probe.py rungs
                         and the ``compute16`` group scan

Beside each stands its plain PyTorch version, which defines the function:
the tests compare it with the JAX scripts' bodies, and on the card the
kernel is compared with it bit for bit.  A wrapper given CPU tensors runs
the plain version; given CUDA tensors it checks them, launches on the
current stream, raises on a CUDA error and adds one to its counter in
``ops.kernels.LAUNCHES`` per C entry call (``probe_chain``,
``probe_chainio``, ``probe_transpose``; ``rung`` and ``scan16`` share
``probe_int16``, and ``scan16`` counts one per direction).  There is no
fallback.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ops import kernels as ops_kernels
from ..ops.kernels import _check, _launch, _on_cpu, _stream

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


def _check_chain(x, steps: int, rolls) -> tuple:
    _check(x, "x", torch.uint16, 3)
    b, d, p = x.shape
    if not 1 <= d <= 256:
        raise ValueError(f"disparity range {d} outside the kernel's 1..256")
    if steps < 1:
        raise ValueError(f"steps={steps}: need at least one")
    if not 1 <= len(rolls) <= MAX_ROLLS:
        raise ValueError(f"{len(rolls)} directions: the kernel takes 1..{MAX_ROLLS}")
    return b, d, p


def chain(x: torch.Tensor, steps: int, rolls: Sequence[int] = (0,),
          p1: int = 10) -> torch.Tensor:
    """P1.  uint16 (B, D, P) -> uint16 (B, D, P): ``steps`` steps of the SGM
    recurrence on every one of the B * P paths and every direction of
    ``rolls`` (0 straight, +-1 the wrapping diagonals), from a zero state,
    with the cost row ((7 d + 13) & 0x7F) ^ (x & 1) of the path's first pixel
    and P2 = 150; the row is the sum over the directions of state + min at
    the paths' last pixels.  One launch."""
    if _on_cpu(x):
        return chain_plain(x, steps, rolls, p1)
    b, d, p = _check_chain(x, steps, rolls)
    out = torch.empty_like(x)
    arr = (ctypes.c_int * len(rolls))(*rolls)
    _launch("sgm_probe_chain", "probe_chain", x.data_ptr(), out.data_ptr(), b,
            d, p, steps, len(rolls), ctypes.addressof(arr), p1, _stream(out))
    return out


def chainio_plain(x, cost_ring, p2_ring, steps: int,
                  rolls: Sequence[int] = (0,), extra_u16: int = 0,
                  p1: int = 10) -> torch.Tensor:
    return _recurrence_plain(x, steps, rolls, p1, cost_ring, p2_ring, extra_u16)


def chainio_shared_bytes(d: int, n: int, ring: int) -> int:
    """Dynamic shared memory of a ``chainio`` block, as the kernel lays it
    out: per warp a row to sum, and ``ring`` slots of an int32 cost row, a
    P2 word and a uint16 output row."""
    row = 32 * ((d + 31) // 32)
    warps = max(1, min(8, 32 // n)) * n
    return warps * (row * 4 + ring * (row * 6 + 4))


def chainio(x: torch.Tensor, cost_ring: torch.Tensor, p2_ring: torch.Tensor,
            steps: int, rolls: Sequence[int] = (0,), extra_u16: int = 0,
            p1: int = 10) -> torch.Tensor:
    """P2.  ``chain`` plus a production pass's per-step traffic from on-chip
    memory.  ``cost_ring`` int32 (B, R, D, P) and ``p2_ring`` int32
    (B, n, R, P) are R steps of a cost volume and of the directions' P2
    rows; step s uses slot s mod R, the cost row being
    (cost_ring ^ (x & 1)) & 0xFF.  Per step and direction: the cost row and
    the P2 value are read, ``extra_u16`` times the slot's uint16 output row
    is read and added (plus 0, 1, ...), and the row is stored.  A ring
    travels with its path (see ``_recurrence_plain``); with R = steps it is
    the whole volume.  The result row is the sum of the directions' last
    output rows plus direction 0's state.  One launch."""
    if _on_cpu(x, cost_ring, p2_ring):
        return chainio_plain(x, cost_ring, p2_ring, steps, rolls, extra_u16, p1)
    b, d, p = _check_chain(x, steps, rolls)
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
    if extra_u16 < 0:
        raise ValueError(f"extra_u16={extra_u16} is negative")
    need = chainio_shared_bytes(d, n, ring)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"a ring of {ring} steps at D={d}, {n} directions "
                         f"needs {need} bytes of shared memory, over the "
                         f"block's {MAX_SHARED_BYTES}")
    out = torch.empty_like(x)
    arr = (ctypes.c_int * n)(*rolls)
    _launch("sgm_probe_chainio", "probe_chainio", x.data_ptr(),
            cost_ring.data_ptr(), p2_ring.data_ptr(), out.data_ptr(), b, d, p,
            steps, n, ctypes.addressof(arr), ring, extra_u16, p1, _stream(out))
    return out


# --- P3: the volume transpose -------------------------------------------------------

def volume_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 2, 1).contiguous()


def volume_transpose(x: torch.Tensor) -> torch.Tensor:
    """P3.  (B, A, D, C) -> (B, C, D, A), elements of 1 or 2 bytes: the
    swap of a volume's outer and inner axis, D kept.  One launch."""
    if _on_cpu(x):
        return volume_transpose_plain(x)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous 4-d volume, got "
                         f"{tuple(x.shape)}")
    if x.element_size() not in (1, 2):
        raise TypeError(f"x: expected 1- or 2-byte elements, got {x.dtype}")
    b, a, d, c = x.shape
    out = torch.empty((b, c, d, a), dtype=x.dtype, device=x.device)
    _launch("sgm_probe_transpose", "probe_transpose", x.data_ptr(),
            out.data_ptr(), b, a, d, c, x.element_size(), _stream(out))
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


def scan16(cost: torch.Tensor, img: torch.Tensor, rolls: Sequence[int],
           reverse: bool, p1: int, p2_init: int, restart: bool) -> torch.Tensor:
    """P4, rung p7: ``ops.kernels.directional_scan_group`` without carries,
    its state in packed 16-bit lanes.  uint8 (B, S, D, W) cost + uint8
    (B, S, W) image -> the uint16 (B, S, D, W) sum of the directions'
    contributions.  One launch per direction."""
    if not int16_safe(p1, p2_init):
        raise ValueError(f"p1={p1}, p2_init={p2_init} could overflow 16 bits")
    if _on_cpu(cost, img):
        return scan16_plain(cost, img, rolls, reverse, p1, p2_init, restart)
    b, s, d, w = ops_kernels._check_scan(cost, img)
    out = torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    for k, roll in enumerate(rolls):
        _launch("sgm_probe_scan16", "probe_int16", cost.data_ptr(),
                img.data_ptr(), out.data_ptr(), b, s, d, w, int(reverse), roll,
                int(restart), p1, p2_init, int(k > 0), _stream(out))
    return out
