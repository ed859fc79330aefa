"""Wrappers of the hand-written CUDA kernels — counterpart of the JAX
package's ``ops/pallas_kernels.py``.

One wrapper per kernel entry, each with its plain PyTorch version beside it:

    census_cost_volume      K1 csrc/census_cost.cu  <- census_cost_volume_pallas
                               (img_has_halo=True: the tiled path's mode)
    aggregate_paths         K2 csrc/aggregate.cu    <- the DP scan kernels: the
                               horizontal pair, then one group launch per
                               vertical scan order
    horizontal_partial      K2 csrc/aggregate.cu    <- horizontal_partial: three
                               transposes around two one-direction groups on
                               the transposed volume
    volume_transpose        P3 csrc/transpose.cu    <- aggr_transpose_probe.py
                               (the transposes around the horizontal pair)
    directional_scan_group  K2 csrc/aggregate.cu    <- directional_scan_group
                               (with the cross-tile carry-in/out), one launch
    scan_direction          K2 csrc/aggregate.cu    one direction alone, the
                               first design's kernel (a warp per path);
                               scan_directions sums several such launches
    wta_reduce              K2 csrc/wta.cu          <- wta_reduce_pallas (both
                               views from one read; wta_online_plain
                               transcribes its online reduction)
    lr_check                K3 csrc/lr_check.cu     <- lr_check_pallas
    remove_speckles         K4 csrc/speckle.cu      <- remove_speckles_pallas
    union_find_labels       K4 csrc/speckle.cu      its label stage alone
    count_verdict           K4 csrc/speckle.cu      its count and verdict alone

``aggregate_paths_wta`` chains the two K2 wrappers, like the JAX entry of
that name.  A wrapper given CPU tensors runs the plain version.  Given CUDA
tensors it checks device, dtype, shape and contiguity, allocates its outputs
with ``torch.empty``, launches on the current stream, raises if the C entry
returns a CUDA error, and adds one to ``LAUNCHES[<counter>]`` per C entry
call that launches (``group_capacity`` only asks).  The counter is the wrapper's name, except that the halo census
counts as ``census_cost_volume_halo``, ``scan_direction`` as
``aggregate_paths`` (``aggregate_paths`` itself counts its vertical group
launches; its horizontal pair counts as ``horizontal_partial``, two scans,
and ``volume_transpose``, three), and
``union_find_labels`` and ``count_verdict`` as ``remove_speckles``, whose
stages they are.  The ``probe_*`` counters belong to the wrappers in
``probes/kernels.py``.  There is no fallback: any other device raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import SGMOptions

from .. import _build
from . import aggregation, census, cost_volume, postprocess
from . import wta as wta_ops
from .wta import WTAPlanes

LAUNCHES = {"census_cost_volume": 0, "aggregate_paths": 0, "wta_reduce": 0,
            "lr_check": 0, "remove_speckles": 0,
            "census_cost_volume_halo": 0, "directional_scan_group": 0,
            "volume_transpose": 0, "horizontal_partial": 0,
            # the probe kernels, launched by probes/kernels.py
            "probe_chain": 0, "probe_chainio": 0,
            "probe_int16": 0, "probe_speckle_labels": 0,
            "probe_speckle_hist": 0, "probe_speckle_verdict": 0,
            "probe_speckle_fused": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True if all tensors are on the CPU; raises unless they are all CUDA."""
    devices = {t.device for t in tensors}
    if all(dev.type == "cpu" for dev in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA "
                     f"device, got {[str(t.device) for t in tensors]}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# CUDA errors that an entry returns for a reason of its own
ERRORS = {720: "more work than the blocks the card holds at once can take "
               "(cudaErrorCooperativeLaunchTooLarge)"}


def _launch(entry: str, counter: str, *args) -> None:
    err = getattr(_build.load(), entry)(*args)
    if err != 0:
        why = f": {ERRORS[err]}" if err in ERRORS else ""
        raise RuntimeError(f"{entry}: CUDA error {err}{why}")
    LAUNCHES[counter] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t, offset: int = 0):
    """Address of element ``offset`` of ``t``, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr() + offset * t.element_size()


# --- K1: census + cost volume -------------------------------------------------

def census_cost_volume_plain(img_left, img_right, min_disparity: int,
                             max_disparity: int,
                             img_has_halo: bool = False) -> torch.Tensor:
    cl, cr = census.census_5x5(img_left), census.census_5x5(img_right)
    if img_has_halo:        # the census of the padded tile, cropped
        h = img_left.shape[-2] - 4
        cl, cr = cl[..., 2:2 + h, :], cr[..., 2:2 + h, :]
    return cost_volume.hamming_cost_volume(cl, cr, min_disparity,
                                           max_disparity)


def census_cost_volume(img_left: torch.Tensor, img_right: torch.Tensor,
                       min_disparity: int, max_disparity: int,
                       img_has_halo: bool = False) -> torch.Tensor:
    """uint8 (B, H, W) pair -> uint8 (B, H, D, W) cost volume.

    ``img_has_halo``: the images are (B, H+4, W) H-tiles with 2 neighbour
    rows on each side; the output has H rows and no row-border masking (the
    tiled caller fixes the image's global border rows).  On the card a block
    holds one row's image slab, census codes and staging rings in shared
    memory, which bounds W at about 8,900 columns (D = 64); a wider image raises."""
    if _on_cpu(img_left, img_right):
        return census_cost_volume_plain(img_left, img_right, min_disparity,
                                        max_disparity, img_has_halo)
    _check(img_left, "img_left", torch.uint8, 3)
    _check(img_right, "img_right", torch.uint8, 3)
    if img_left.shape != img_right.shape:
        raise ValueError("left and right images differ in shape")
    b, h, w = img_left.shape
    if img_has_halo:
        h -= 4
        if h < 0:
            raise ValueError(f"a halo image needs >= 4 rows, got {h + 4}")
    d = max_disparity - min_disparity
    out = torch.empty((b, h, d, w), dtype=torch.uint8, device=img_left.device)
    _launch("sgm_census_cost",
            "census_cost_volume_halo" if img_has_halo else "census_cost_volume",
            img_left.data_ptr(), img_right.data_ptr(), out.data_ptr(), b, h, w,
            min_disparity, d, int(img_has_halo), _stream(out))
    return out


# --- K2: path aggregation + WTA -------------------------------------------------

def _check_scan(cost: torch.Tensor, img: torch.Tensor):
    """Validate a scan's uint8 (B, S, D, W) cost and (B, S, W) image for
    the kernel; return (B, S, D, W)."""
    _check(cost, "cost", torch.uint8, 4)
    _check(img, "img", torch.uint8, 3)
    b, s, d, w = cost.shape
    if img.shape != (b, s, w):
        raise ValueError(f"image {tuple(img.shape)} does not match cost "
                         f"{tuple(cost.shape)}")
    if not 1 <= d <= 256:
        raise ValueError(f"disparity range {d} outside the kernel's 1..256")
    return b, s, d, w


MAX_GROUP = 3       # most directions of one sgm_scan_group launch
P_CLAMP = 1024      # the kernel clamps P1 and P2': beyond 255 they never win
# the transposed volumes' rows are padded to this many elements, so that
# every row starts on a 16-byte boundary (the padding: zero cost, zero gray,
# paths of their own that the way back drops)
TRANSPOSED_PITCH = 16


def scan_groups(num_paths: int):
    """The vertical directions of ``DIRECTIONS_8/4`` by scan order:
    ((rolls, reverse), ...), as the JAX package groups them."""
    if num_paths == 8:
        return (((0, 1, -1), False), ((0, -1, 1), True))
    return (((0,), False), ((0,), True))


def p2_table(p1: int, p2_init: int) -> torch.Tensor:
    """The group kernel's table of P2' by |gray difference| (int64, 256):
    ``max(P1, P2_init // (diff + 1))``, clamped like the kernel's."""
    diff = torch.arange(256)
    return torch.clamp(p2_init // (diff + 1), min=p1, max=P_CLAMP)


def _lanes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return lo | (hi << 16)


def packed_step_plain(prev, prev_min, prev_gray, cost_row, gray_row, p1: int,
                      p2_init: int) -> torch.Tensor:
    """``aggregation._dp_step`` the way the group kernel computes it: two
    neighbouring columns in the 16-bit lanes of one word, P2' from
    ``p2_table``, P1 clamped, lane-wise minima, one add-and-min, and
    ``(cost + m - pmin) & 0x00FF00FF``.  int (..., D, P) rows with P even ->
    the (..., D, P) int64 step result; for the tests, which hold it against
    ``_dp_step`` over the uint8 domain."""
    def pack(x):
        x = x.to(torch.int64)
        return _lanes(x[..., 0::2], x[..., 1::2])

    def vmin(a, b):     # per 16-bit lane
        return _lanes(torch.minimum(a & 0xFFFF, b & 0xFFFF),
                      torch.minimum(a >> 16, b >> 16))

    sent = _lanes(torch.tensor(aggregation.SENTINEL),
                  torch.tensor(aggregation.SENTINEL))
    table = p2_table(p1, p2_init)
    p2 = table[(gray_row.to(torch.int64) - prev_gray.to(torch.int64)).abs()]
    pmin = pack(prev_min)
    pp2 = (pmin + pack(p2))[..., None, :]
    wc = pack(prev)
    pad = torch.full_like(wc[..., :1, :], int(sent))
    wm = torch.cat([pad, wc[..., :-1, :]], dim=-2)
    wp = torch.cat([wc[..., 1:, :], pad], dim=-2)
    p1pk = min(p1, P_CLAMP) * 0x00010001
    near = vmin(vmin(wm, wp) + p1pk, wc)            # __viaddmin_u16x2
    m = vmin(near, pp2)
    cur = (pack(cost_row) + m - pmin[..., None, :]) & 0x00FF00FF
    out = torch.empty(prev.shape, dtype=torch.int64)
    out[..., 0::2] = cur & 0xFFFF
    out[..., 1::2] = cur >> 16
    return out


def _check_penalties(p1: int, p2_init: int) -> None:
    if p1 < 0 or p2_init < 0:
        raise ValueError(f"penalties must be >= 0, got P1={p1}, "
                         f"P2_init={p2_init}")


def group_capacity(cost: torch.Tensor, out: torch.Tensor) -> int:
    """The most directions one ``sgm_scan_group`` launch takes for this
    uint8 (B, S, D, W) cost and uint16 sum on the current card: as many as
    the kernel's on-chip state has room for, ``MAX_GROUP`` at most.  On an
    NVIDIA H100 80GB HBM3 a launch takes no direction, and this raises, for
    rows wider than 13,824 columns at D = 64, 6,720 at D = 128 and 3,264 at
    D = 256 (a cluster of 16 blocks; ``tests/test_torch_cuda.py`` finds
    these limits on the card)."""
    b, _, d, w = cost.shape
    dirs = ctypes.c_int(0)
    err = _build.load().sgm_scan_group_capacity(
        cost.data_ptr(), out.data_ptr(), b, d, w, ctypes.addressof(dirs))
    if err != 0:
        raise RuntimeError(f"sgm_scan_group_capacity: CUDA error {err}")
    if dirs.value < 1:
        raise ValueError(f"D={d}, W={w}: a row's scan state does not fit "
                         f"the group kernel's on-chip memory")
    return dirs.value


def _launch_groups(counter: str, cost, img, out, rolls, reverse: bool,
                   p1: int, p2_init: int, restart: bool, accumulate: bool,
                   carry_in=(None, None), prev_gray=None,
                   carry_out=(None, None)) -> None:
    """``sgm_scan_group`` over ``rolls``, ``group_capacity`` directions a
    launch (all of them in one, except for rows too large to keep three
    directions' state on chip): the sum of their contributions stored (or,
    with ``accumulate``, added) into ``out``."""
    b, s, d, w = cost.shape
    n = len(rolls)
    _check_penalties(p1, p2_init)
    stream = _stream(out)
    per_launch = group_capacity(cost, out)
    for k0 in range(0, n, per_launch):
        sub = tuple(rolls[k0:k0 + per_launch])
        _launch("sgm_scan_group", counter, cost.data_ptr(), img.data_ptr(),
                out.data_ptr(), _ptr(carry_in[0], k0 * d * w),
                _ptr(carry_in[1], k0 * w), _ptr(prev_gray),
                _ptr(carry_out[0], k0 * d * w), _ptr(carry_out[1], k0 * w),
                b, s, d, w, len(sub), *(sub + (0,) * MAX_GROUP)[:MAX_GROUP],
                n, int(reverse), int(restart), p1, p2_init,
                int(accumulate or k0 > 0), stream)


def aggregate_paths(cost: torch.Tensor, img_left: torch.Tensor,
                    options: SGMOptions,
                    diagonal_mode: str = "wrap") -> torch.Tensor:
    """uint8 (B, H, D, W) cost + uint8 (B, H, W) image -> uint16 (B, H, D, W)
    aggregated volume: the horizontal pair (``horizontal_partial``), then one
    group launch per vertical scan order of ``DIRECTIONS_8/4`` added onto
    it."""
    if _on_cpu(cost, img_left):
        return aggregation.aggregate_paths(cost, img_left, options, diagonal_mode)
    _check_scan(cost, img_left)
    if diagonal_mode not in ("wrap", "restart"):
        raise ValueError(f"unknown diagonal_mode {diagonal_mode!r}")
    restart = diagonal_mode == "restart"
    out = horizontal_partial(cost, img_left, options.p1, options.p2_init,
                             restart)
    for rolls, reverse in scan_groups(options.num_paths):
        _launch_groups("aggregate_paths", cost, img_left, out, rolls, reverse,
                       options.p1, options.p2_init, restart, True)
    return out


def scan_direction_plain(cost, img, axis: str, reverse: bool, roll: int,
                         p1: int, p2_init: int,
                         restart: bool = False) -> torch.Tensor:
    mode = "restart" if restart else "wrap"
    if axis == "h":
        out = aggregation.directional_scan(
            cost.transpose(-1, -3), img.transpose(-1, -2), p1, p2_init,
            reverse, roll, mode)[0].transpose(-1, -3)
    else:
        out = aggregation.directional_scan(cost, img, p1, p2_init, reverse,
                                           roll, mode)[0]
    return out.to(torch.uint16)


def scan_direction(cost: torch.Tensor, img: torch.Tensor, axis: str,
                   reverse: bool, roll: int, p1: int, p2_init: int,
                   restart: bool = False, out=None) -> torch.Tensor:
    """One direction of ``DIRECTIONS_8`` alone, one launch of the first
    design's scan kernel (a warp per path): uint8 (B, H, D, W) cost + uint8
    (B, H, W) image -> its uint16 (B, H, D, W) contribution.  ``axis`` 'h'
    scans over W, 'v' over H (``roll`` +-1: the diagonals).  With ``out``
    (uint16, same shape) the contribution is added onto it in place.  For
    the measurement tools and as a second reference for the group kernel:
    the main path goes through ``aggregate_paths``."""
    if axis not in ("h", "v"):
        raise ValueError(f"unknown axis {axis!r}")
    if _on_cpu(cost, img, *(() if out is None else (out,))):
        res = scan_direction_plain(cost, img, axis, reverse, roll, p1,
                                   p2_init, restart)
        if out is None:
            return res
        return out.copy_((out.to(torch.int32) + res.to(torch.int32))
                         .to(torch.uint16))
    b, h, d, w = _check_scan(cost, img)
    accumulate = out is not None
    if accumulate:
        _check(out, "out", torch.uint16, 4)
        if out.shape != cost.shape:
            raise ValueError(f"out {tuple(out.shape)} != cost {tuple(cost.shape)}")
    else:
        out = torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    _launch("sgm_scan_direction", "aggregate_paths", cost.data_ptr(),
            img.data_ptr(), out.data_ptr(), b, h, d, w, int(axis == "v"),
            int(reverse), roll, int(restart), p1, p2_init, int(accumulate),
            _stream(out))
    return out


def scan_directions(cost: torch.Tensor, img: torch.Tensor, directions,
                    p1: int, p2_init: int, restart: bool = False,
                    out=None) -> torch.Tensor:
    """The sum over ``directions`` = ((axis, reverse, roll), ...) of
    ``scan_direction``, one launch of the first design's kernel each, every
    launch after the first a read-modify-write of the volume (added onto
    ``out`` if given): what the group kernel is measured against."""
    for axis, reverse, roll in directions:
        out = scan_direction(cost, img, axis, reverse, roll, p1, p2_init,
                             restart, out=out)
    return out


def horizontal_partial_plain(cost, img, p1: int, p2_init: int,
                             restart: bool) -> torch.Tensor:
    mode = "restart" if restart else "wrap"
    cost_t, img_t = cost.transpose(-1, -3), img.transpose(-1, -2)
    total = sum(aggregation.directional_scan(cost_t, img_t, p1, p2_init,
                                             reverse, 0, mode)[0]
                for reverse in (False, True))
    return total.transpose(-1, -3).to(torch.uint16)


def _padded(n: int, pad_to: int) -> int:
    return -(-n // pad_to) * pad_to


def volume_transpose_plain(x: torch.Tensor, inner=None,
                           pad_to: int = 1) -> torch.Tensor:
    b, a, d, c = x.shape
    inner = c if inner is None else inner
    out = x.new_zeros((b, inner, d, _padded(a, pad_to)))
    out[..., :a] = x[..., :inner].permute(0, 3, 2, 1)
    return out


def volume_transpose(x: torch.Tensor, inner=None,
                     pad_to: int = 1) -> torch.Tensor:
    """P3.  (B, A, D, C) -> (B, C, D, A), elements of 1 or 2 bytes: the
    swap of a volume's outer and inner axis, D kept.  One launch.

    The internal pitch of the transposed volumes: with ``pad_to`` the
    result's inner axis is padded with zeros to a multiple of it,
    (B, C, D, A') with A' >= A; with ``inner`` only the first ``inner``
    columns of ``x`` are read (the way back: ``inner`` = the A of before),
    giving (B, inner, D, A)."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous 4-d volume, got "
                         f"{tuple(x.shape)}")
    b, a, d, c = x.shape
    inner = c if inner is None else inner
    if not 0 <= inner <= c or pad_to < 1:
        raise ValueError(f"inner={inner} of {c} columns, pad_to={pad_to}")
    if _on_cpu(x):
        return volume_transpose_plain(x, inner, pad_to)
    if x.element_size() not in (1, 2):
        raise TypeError(f"x: expected 1- or 2-byte elements, got {x.dtype}")
    pitch = _padded(a, pad_to)
    out = torch.empty((b, inner, d, pitch), dtype=x.dtype, device=x.device)
    _launch("sgm_volume_transpose", "volume_transpose", x.data_ptr(),
            out.data_ptr(), b, a, d, inner, c, pitch, x.element_size(),
            _stream(out))
    return out


def image_transpose(img: torch.Tensor, pad_to: int = 1) -> torch.Tensor:
    """uint8 (B, H, W) -> (B, W, H'), by the volume kernel at D = 1."""
    return volume_transpose(img[:, :, None, :], pad_to=pad_to).squeeze(2)


def horizontal_pair_transposed(cost_t: torch.Tensor, img_t: torch.Tensor,
                               p1: int, p2_init: int) -> torch.Tensor:
    """Both horizontal directions on a transposed volume: uint8 (B, W, D, H)
    cost + uint8 (B, W, H) image -> their uint16 (B, W, D, H) sum.  There a
    horizontal path is a column: two one-direction groups, forward and
    reverse, the second adding onto the first."""
    if _on_cpu(cost_t, img_t):
        return sum(aggregation.directional_scan(cost_t, img_t, p1, p2_init,
                                                reverse)[0]
                   for reverse in (False, True)).to(torch.uint16)
    _check_scan(cost_t, img_t)
    part_t = torch.empty(cost_t.shape, dtype=torch.uint16,
                         device=cost_t.device)
    for reverse in (False, True):
        _launch_groups("horizontal_partial", cost_t, img_t, part_t, (0,),
                       reverse, p1, p2_init, False, reverse)
    return part_t


def horizontal_partial(cost: torch.Tensor, img: torch.Tensor, p1: int,
                       p2_init: int, restart: bool) -> torch.Tensor:
    """Both horizontal directions: uint8 (B, H, D, W) cost + uint8 (B, H, W)
    image -> their uint16 (B, H, D, W) sum.  Tile-local in the H-tiled
    layout.  Nothing walks the volume along W: the cost and the image are
    transposed, the pair runs as two one-direction groups along the
    (B, W, D, H) volume's columns, and the sum is transposed back (3
    transposes, 2 scans).  ``restart`` changes nothing here (it resets
    diagonals); the argument mirrors the entry this replaces."""
    if _on_cpu(cost, img):
        return horizontal_partial_plain(cost, img, p1, p2_init, restart)
    _, h, _, _ = _check_scan(cost, img)
    part_t = horizontal_pair_transposed(
        volume_transpose(cost, pad_to=TRANSPOSED_PITCH),
        image_transpose(img, pad_to=TRANSPOSED_PITCH), p1, p2_init)
    return volume_transpose(part_t, inner=h)


def _edge_gray(img: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The boundary gray row a group scan uses when none is given: the
    wrapped edge row, as ``_p2_planes(prev_row=None)`` uses it."""
    return img[:, 0 if reverse else -1].contiguous()


def directional_scan_group_plain(cost, img, acc, rolls, reverse: bool, p1: int,
                                 p2_init: int, restart: bool, carry_in=None,
                                 want_carry: bool = False, prev_gray=None):
    mode = "restart" if restart else "wrap"
    if prev_gray is None and carry_in is not None:
        prev_gray = _edge_gray(img, reverse)
    total = 0 if acc is None else acc.to(torch.int32)
    carries = []
    for k, roll in enumerate(rolls):
        cin = None if carry_in is None else aggregation.ScanCarry(
            carry_in[0][:, k], carry_in[1][:, k, 0], prev_gray)
        contrib, carry = aggregation.directional_scan(cost, img, p1, p2_init,
                                                      reverse, roll, mode, cin)
        total = total + contrib
        carries.append(carry)
    out = total.to(torch.uint16)
    if acc is not None:
        out = acc.copy_(out)
    if carry_in is None and not want_carry:
        return out
    return out, (torch.stack([c.cost for c in carries], 1),
                 torch.stack([c.mincost for c in carries], 1)[:, :, None])


def directional_scan_group(cost: torch.Tensor, img: torch.Tensor, acc,
                           rolls, reverse: bool, p1: int, p2_init: int,
                           restart: bool, carry_in=None,
                           want_carry: bool = False, prev_gray=None):
    """A group of vertical directions that share a scan order (rolls, e.g.
    (0, 1, -1)) over an H-tile: uint8 (B, S, D, W) cost + uint8 (B, S, W)
    image -> the uint16 (B, S, D, W) sum of their contributions, added in
    place onto ``acc`` (uint16, same shape) and returned when ``acc`` is
    given.

    Carry mode, with the Pallas entry's layout: ``carry_in`` = int32
    (cost (B, n, D, W), min (B, n, 1, W)) continues the upstream tile's
    paths, and with ``carry_in`` or ``want_carry`` the result is
    ``(sum, carry_out)``, the state after the tile's last row (its first
    for ``reverse``).  ``prev_gray``: the upstream tile's uint8 (B, W)
    boundary row, for P2 on the first row (default: the wrapped edge row of
    ``img``, as the Pallas entry's P2 planes without ``prev_row``).

    One launch (see ``group_capacity``): the group's sum is formed on chip
    and the uint16 volume is touched once."""
    if prev_gray is None and carry_in is not None:
        prev_gray = _edge_gray(img, reverse)
    extra = [t for t in (acc, prev_gray, *(carry_in or ())) if t is not None]
    if _on_cpu(cost, img, *extra):
        return directional_scan_group_plain(cost, img, acc, rolls, reverse, p1,
                                            p2_init, restart, carry_in,
                                            want_carry, prev_gray)
    b, s, d, w = _check_scan(cost, img)
    n = len(rolls)
    if acc is None:
        out = torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
    else:
        _check(acc, "acc", torch.uint16, 4)
        if acc.shape != cost.shape:
            raise ValueError(f"acc {tuple(acc.shape)} != cost {tuple(cost.shape)}")
        out = acc
    cin_cost = cin_min = None
    if carry_in is not None:
        cin_cost, cin_min = carry_in
        for t, name, shape in ((cin_cost, "carry cost", (b, n, d, w)),
                               (cin_min, "carry min", (b, n, 1, w))):
            _check(t, name, torch.int32, 4)
            if t.shape != shape:
                raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        _check(prev_gray, "prev_gray", torch.uint8, 2)
        if prev_gray.shape != (b, w):
            raise ValueError(f"prev_gray: expected {(b, w)}, got "
                             f"{tuple(prev_gray.shape)}")
    has_carry = carry_in is not None or want_carry
    cout_cost = cout_min = None
    if has_carry:
        cout_cost = torch.empty((b, n, d, w), dtype=torch.int32, device=cost.device)
        cout_min = torch.empty((b, n, 1, w), dtype=torch.int32, device=cost.device)
    _launch_groups("directional_scan_group", cost, img, out, tuple(rolls),
                   reverse, p1, p2_init, restart, acc is not None,
                   (cin_cost, cin_min), prev_gray, (cout_cost, cout_min))
    return (out, (cout_cost, cout_min)) if has_carry else out


def wta_reduce_plain(aggr, options: SGMOptions, include_inverse: bool = True):
    fwd = wta_ops.wta_reduce(aggr, options, inverse=False)
    inv = wta_ops.wta_reduce(aggr, options, inverse=True) if include_inverse \
        else None
    return fwd, inv


WTA_KEY_SHIFT = 8       # the kernel's latch: cost << 8 | k, so D <= 256
WTA_MAX_WIDTH = 32768   # columns of a row the kernel takes (kMaxWidth)


class _Track:
    """One view's online reduction, all columns at once, with the kernel's
    arithmetic for a column: the min and the min over the planes that lost
    to it (ties lose, so the first plane keeps the min), the latch
    ``prev << 8 | k`` (c1 and best) where the min changes hands, c2 of the
    plane after one that took the min, and the cost at the plane before.
    Plane 0 starts it."""

    def __init__(self, first: torch.Tensor):
        self.m1 = first
        self.m2 = torch.full_like(first, wta_ops.UINT16_MAX)
        self.rk = first << WTA_KEY_SHIFT     # c1 = cost[clip(-1)], best 0
        self.rc2 = torch.zeros_like(first)
        self.prev = first
        self.took = torch.ones_like(first, dtype=torch.bool)

    def step(self, v: torch.Tensor, k: int) -> None:
        keep = self.m1 <= v
        self.m2 = torch.minimum(self.m2, torch.maximum(self.m1, v))
        self.m1 = torch.minimum(self.m1, v)
        self.rk = torch.where(keep, self.rk, (self.prev << WTA_KEY_SHIFT) | k)
        self.rc2 = torch.where(self.took, v, self.rc2)
        self.prev, self.took = v, ~keep

    def planes(self, d: int) -> WTAPlanes:
        best = self.rk & 0xFF
        sec = self.m2 if d > 1 else torch.full_like(best, wta_ops.BIG)
        return WTAPlanes(best, self.m1, sec, self.rk >> WTA_KEY_SHIFT,
                         torch.where(best == d - 1, self.prev, self.rc2))


def wta_online_plain(aggr, options: SGMOptions, include_inverse: bool = True,
                     chunk: int = 16):
    """The WTA kernel's reduction, transcribed: the planes of each row are
    staged ``chunk`` at a time, each staged plane followed by 65535 where
    the inverse view's reads leave the row, and both views are reduced in
    one pass over the planes with the kernel's running minima and latches
    (no second read for c1 and c2).  Same result as ``wta_reduce_plain``;
    for the tests, which hold the kernel's algorithm against the JAX op."""
    b, h, d, w = aggr.shape
    if not 1 <= d <= 1 << WTA_KEY_SHIFT:
        raise ValueError(f"disparity range {d} outside the kernel's 1..256")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dmin = options.min_disparity
    a = aggr.to(torch.int32)
    reach = min(dmin + d - 1, w)       # how far right the inverse view reads
    tracks = None
    for k0 in range(0, d, chunk):
        staged = torch.full((b, h, min(chunk, d - k0), w + reach),
                            wta_ops.UINT16_MAX, dtype=torch.int32,
                            device=a.device)
        staged[..., :w] = a[:, :, k0:k0 + chunk]
        for kk in range(staged.shape[2]):
            k = k0 + kk
            shift = min(dmin + k, w)
            views = [staged[:, :, kk, :w]]
            if include_inverse:
                views.append(staged[:, :, kk, shift:shift + w])
            if tracks is None:
                tracks = [_Track(v) for v in views]
                continue
            for track, v in zip(tracks, views):
                track.step(v, k)
    fwd = tracks[0].planes(d)
    return fwd, tracks[1].planes(d) if include_inverse else None


def wta_reduce(aggr: torch.Tensor, options: SGMOptions,
               include_inverse: bool = True):
    """uint16 (B, H, D, W) -> (forward WTAPlanes, inverse WTAPlanes or None),
    int32 (B, H, W) planes, like ``wta_reduce_pallas``.  On the card the
    kernel takes D in 1..256 and rows of up to ``WTA_MAX_WIDTH`` columns,
    wider than the group scan kernel takes at any D; beyond that it raises."""
    if _on_cpu(aggr):
        return wta_reduce_plain(aggr, options, include_inverse)
    _check(aggr, "aggr", torch.uint16, 4)
    b, h, d, w = aggr.shape
    if not 1 <= d <= 1 << WTA_KEY_SHIFT:
        raise ValueError(f"disparity range {d} outside the WTA kernel's 1..256")
    if w > WTA_MAX_WIDTH:
        raise ValueError(f"W={w}: the WTA kernel takes rows of at most "
                         f"{WTA_MAX_WIDTH} columns")
    n_out = 10 if include_inverse else 5
    out = torch.empty((n_out, b, h, w), dtype=torch.int32, device=aggr.device)
    _launch("sgm_wta_reduce", "wta_reduce", aggr.data_ptr(), out.data_ptr(),
            b, h, d, w, options.min_disparity, int(include_inverse),
            _stream(out))
    planes = out.unbind(0)
    return (WTAPlanes(*planes[:5]),
            WTAPlanes(*planes[5:]) if include_inverse else None)


def aggregate_paths_wta_plain(cost, img_left, options: SGMOptions,
                              diagonal_mode: str = "wrap",
                              include_inverse: bool = True):
    aggr = aggregation.aggregate_paths(cost, img_left, options, diagonal_mode)
    return wta_reduce_plain(aggr, options, include_inverse)


def aggregate_paths_wta(cost: torch.Tensor, img_left: torch.Tensor,
                        options: SGMOptions, diagonal_mode: str = "wrap",
                        include_inverse: bool = True):
    """Aggregation then WTA: (forward WTAPlanes, inverse WTAPlanes or None)."""
    return wta_reduce(aggregate_paths(cost, img_left, options, diagonal_mode),
                      options, include_inverse)


# --- K3: LR check ----------------------------------------------------------------

def lr_check(disp_left: torch.Tensor, disp_right: torch.Tensor, thres: float,
             max_shift: int) -> torch.Tensor:
    """f32 (B, H, W) left/right disparities -> checked left disparities."""
    if _on_cpu(disp_left, disp_right):
        return postprocess.lr_check(disp_left, disp_right, thres, max_shift)
    if max_shift <= 0:
        raise ValueError(f"max_shift={max_shift}: pass the disparity bound")
    _check(disp_left, "disp_left", torch.float32, 3)
    _check(disp_right, "disp_right", torch.float32, 3)
    if disp_left.shape != disp_right.shape:
        raise ValueError("left and right disparity maps differ in shape")
    b, h, w = disp_left.shape
    out = torch.empty_like(disp_left)
    _launch("sgm_lr_check", "lr_check", disp_left.data_ptr(),
            disp_right.data_ptr(), out.data_ptr(), b, h, w,
            float(np.float32(thres)), max_shift, _stream(out))
    return out


# --- K4: speckle removal -------------------------------------------------------------

def _check_speckle(disp: torch.Tensor) -> tuple:
    _check(disp, "disp", torch.float32, 3)
    if disp.numel() >= 2 ** 31:
        raise ValueError("speckle labels are int32: batch too large")
    return disp.shape


def remove_speckles(disp: torch.Tensor, diff_insame: float = 1.0,
                    min_area: int = 50) -> torch.Tensor:
    """f32 (B, H, W), +inf invalid -> the same with small components +inf."""
    if _on_cpu(disp):
        return postprocess.remove_speckles(disp, diff_insame, min_area)
    b, h, w = _check_speckle(disp)
    out = torch.empty_like(disp)
    label = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    count = torch.empty_like(label)
    _launch("sgm_remove_speckles", "remove_speckles", disp.data_ptr(),
            out.data_ptr(), label.data_ptr(), count.data_ptr(), b, h, w,
            float(np.float32(diff_insame)), min_area, _stream(out))
    return out


def union_find_labels_plain(disp, diff_insame: float = 1.0) -> torch.Tensor:
    return postprocess.component_labels(disp, diff_insame).to(torch.int32)


def union_find_labels(disp: torch.Tensor,
                      diff_insame: float = 1.0) -> torch.Tensor:
    """K4's label stage alone (tiles labelled in shared memory, unions
    across tile borders, flatten): f32 (B, H, W) -> int32
    (B, H, W), every pixel's root, the smallest flat index (over the batch)
    of its component; a non-finite pixel is its own root."""
    if _on_cpu(disp):
        return union_find_labels_plain(disp, diff_insame)
    b, h, w = _check_speckle(disp)
    label = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    _launch("sgm_speckle_union_labels", "remove_speckles", disp.data_ptr(),
            label.data_ptr(), b, h, w, float(np.float32(diff_insame)),
            _stream(label))
    return label


def count_verdict(disp: torch.Tensor, labels: torch.Tensor,
                  min_area: int = 50) -> torch.Tensor:
    """K4's count and verdict alone, on the int32 (B, H, W) roots of
    ``union_find_labels``: f32 (B, H, W) -> the same with the components of
    fewer than ``min_area`` finite pixels +inf."""
    if _on_cpu(disp, labels):
        return postprocess.small_components_to_inf(disp, labels, min_area)
    b, h, w = _check_speckle(disp)
    _check(labels, "labels", torch.int32, 3)
    if labels.shape != disp.shape:
        raise ValueError(f"labels {tuple(labels.shape)} != disp "
                         f"{tuple(disp.shape)}")
    out = torch.empty_like(disp)
    count = torch.empty_like(labels)
    _launch("sgm_speckle_count_verdict", "remove_speckles", disp.data_ptr(),
            labels.data_ptr(), count.data_ptr(), out.data_ptr(), b, h, w,
            min_area, _stream(out))
    return out
