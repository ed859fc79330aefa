"""Spatial (H-tile) parallelism — PyTorch counterpart of the JAX package's
``parallel/tiles.py``.

The image's rows are split over the mesh's ``tile`` axis, one H-tile per
rank, and its batch over the ``data`` axis:

* **census** needs a 2-row halo from each neighbour tile
  (``dist.batch_isend_irecv``; tiles at the mesh edge receive zeros, and
  the image's global border rows are zeroed afterwards);
* the **cost volume** is tile-local (W stays whole);
* **horizontal passes** are tile-local and exact;
* **vertical and diagonal passes** carry their DP state across tile
  boundaries.  ``cross_tile='exact'`` chains the tiles' scans: each rank
  receives the upstream tile's outgoing carry, scans its tile and sends its
  own carry downstream, so the result is bit-equal to the untiled engine
  after K sequential hops.  ``'pipelined'`` cuts the local batch into
  ``num_micro`` microbatches that follow each other down the chain, so the
  tiles work on different microbatches at once.  ``'local'`` restarts the
  paths at tile boundaries (the overlap-SGM approximation);
* **WTA, uniqueness, subpixel, LR check** are row-local;
* **speckle removal** needs global connectivity: the disparity plane is
  all-gathered over the tile group, filtered whole and sliced back (as is
  the in-place median's raster recurrence);
* the out-of-place **median** uses a 1-row halo, with the global border
  rows put back.

Unlike the SPMD JAX version, no rank computes another tile's rounds: the
chain is point-to-point, so "exact" and "pipelined" differ only in how the
local batch is cut.  The kernel path (``use_kernels=True``) runs the
hand-written CUDA kernels through ``ops/kernels.py``: the halo census, the
grouped carry-in/out DP scans, WTA, LR check and speckle removal.  The
plain path (``use_kernels=False``) is the JAX module's jnp path: census
codes, per-direction ``directional_scan`` with ``ScanCarry``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..config import SGMOptions

from ..ops import aggregation, census, cost_volume, kernels, postprocess
from ..ops.aggregation import DIRECTIONS_4, DIRECTIONS_8, ScanCarry
from ..ops.cost_volume import BORDER_COST
from ..ops.wta import finalize_disparity
from .mesh import Mesh

CROSS_TILE = ("exact", "pipelined", "local")


def _exchange(ops: list) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def halo_exchange_rows(x: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """Pad a (..., Ht, W) tile with ``n`` boundary rows from each neighbour
    tile; tiles at the mesh edge receive zeros."""
    pad_shape = x.shape[:-2] + (n, x.shape[-1])
    top, bot = x.new_zeros(pad_shape), x.new_zeros(pad_shape)
    k, t = mesh.tile, mesh.tile_index
    if n and k > 1:
        ops = []
        if t > 0:
            up = mesh.tile_rank(t - 1)
            ops += [dist.P2POp(dist.isend, x[..., :n, :].contiguous(), up),
                    dist.P2POp(dist.irecv, top, up)]
        if t < k - 1:
            down = mesh.tile_rank(t + 1)
            ops += [dist.P2POp(dist.isend, x[..., -n:, :].contiguous(), down),
                    dist.P2POp(dist.irecv, bot, down)]
        _exchange(ops)
    return torch.cat([top, x, bot], dim=-2)


def _global_rows(mesh: Mesh, ht: int, device) -> torch.Tensor:
    return mesh.tile_index * ht + torch.arange(ht, device=device)


def tiled_census(img_tile: torch.Tensor, mesh: Mesh, h_total: int) -> torch.Tensor:
    """Census codes of a (..., Ht, W) tile with its cross-tile halo; zero
    at the image's global 2-px row border."""
    ht = img_tile.shape[-2]
    padded = halo_exchange_rows(img_tile, 2, mesh)
    codes = census.census_5x5(padded)[..., 2:2 + ht, :]
    gr = _global_rows(mesh, ht, img_tile.device)
    edge = (gr < 2) | (gr >= h_total - 2)
    return torch.where(edge[:, None], 0, codes)


def _carry_chain(scan: Callable, batch: int, num_micro: int, mesh: Mesh,
                 reverse: bool, carry_like: Callable) -> None:
    """Run ``scan(lo, hi, carry_in, want_carry) -> carry_out`` over the
    ``num_micro`` microbatches [lo, hi) of the local batch, in order.  Each
    takes its carry from the upstream tile (the next one for a reverse
    scan) and sends its outgoing carry downstream; the chain's first tile
    starts fresh paths (``carry_in=None``) and its last sends nothing.
    ``carry_like(mb)`` gives zero tensors shaped like a carry, to receive
    into."""
    mb = batch // num_micro
    k, t = mesh.tile, mesh.tile_index
    src, dst = (t + 1, t - 1) if reverse else (t - 1, t + 1)
    has_src, has_dst = 0 <= src < k, 0 <= dst < k
    for m in range(num_micro):
        cin = None
        if has_src:
            cin = carry_like(mb)
            _exchange([dist.P2POp(dist.irecv, c, mesh.tile_rank(src))
                       for c in cin])
        cout = scan(m * mb, (m + 1) * mb, cin, has_dst)
        if has_dst:
            _exchange([dist.P2POp(dist.isend, c.contiguous(),
                                  mesh.tile_rank(dst)) for c in cout])


# --- plain path ---------------------------------------------------------------

def _chained_scan(cost: torch.Tensor, img: torch.Tensor, options: SGMOptions,
                  reverse: bool, roll: int, diagonal_mode: str, mesh: Mesh,
                  num_micro: int) -> torch.Tensor:
    """Exact cross-tile scan of one direction over (B_local, Ht, D, W)
    tiles: the JAX ``_chained_scan`` (``num_micro=1``) and
    ``_pipelined_scan`` (``num_micro`` microbatches) in one.  Returns the
    int32 contribution."""
    out = torch.empty(cost.shape, dtype=torch.int32, device=cost.device)
    b, _, d, w = cost.shape

    def scan(lo, hi, cin, want_carry):
        contrib, carry = aggregation.directional_scan(
            cost[lo:hi], img[lo:hi], options.p1, options.p2_init, reverse,
            roll, diagonal_mode, None if cin is None else ScanCarry(*cin))
        out[lo:hi] = contrib
        return carry

    def carry_like(mb):
        return [torch.zeros(shape, dtype=torch.int32, device=cost.device)
                for shape in ((mb, d, w), (mb, w), (mb, w))]

    _carry_chain(scan, b, num_micro, mesh, reverse, carry_like)
    return out


def tiled_aggregate(cost: torch.Tensor, img: torch.Tensor, options: SGMOptions,
                    mesh: Mesh, cross_tile: str = "exact",
                    diagonal_mode: str = "wrap",
                    num_micro: int = 1) -> torch.Tensor:
    """Aggregate uint8 (B_local, Ht, D, W) cost tiles across the tile axis;
    returns the uint16 volume of the tile (JAX ``tiled_aggregate`` and
    ``tiled_aggregate_pipelined``)."""
    dirs = DIRECTIONS_8 if options.num_paths == 8 else DIRECTIONS_4
    aggr = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    cost_t, img_t = cost.transpose(-1, -3), img.transpose(-1, -2)
    for axis, reverse, roll in dirs:
        if axis == "h":      # horizontal paths never cross H-tiles
            aggr += aggregation.directional_scan(
                cost_t, img_t, options.p1, options.p2_init, reverse, roll,
                diagonal_mode)[0].transpose(-1, -3)
        elif cross_tile == "local" or mesh.tile == 1:
            aggr += aggregation.directional_scan(
                cost, img, options.p1, options.p2_init, reverse, roll,
                diagonal_mode)[0]
        else:
            aggr += _chained_scan(cost, img, options, reverse, roll,
                                  diagonal_mode, mesh, num_micro)
    return aggr.to(torch.uint16)


def _tiled_forward_plain(lefts, rights, options: SGMOptions, mesh: Mesh,
                         h_total: int, cross_tile: str, diagonal_mode: str,
                         num_micro: int) -> torch.Tensor:
    cl = tiled_census(lefts, mesh, h_total)
    cr = tiled_census(rights, mesh, h_total)
    cost = cost_volume.hamming_cost_volume(cl, cr, options.min_disparity,
                                           options.max_disparity)
    aggr = tiled_aggregate(cost, lefts, options, mesh, cross_tile,
                           diagonal_mode, num_micro)
    return _post_aggregation(aggr, options, mesh, h_total, use_kernels=False)


# --- kernel path --------------------------------------------------------------

def _tiled_forward_kernels(lefts, rights, options: SGMOptions, mesh: Mesh,
                           h_total: int, cross_tile: str, diagonal_mode: str,
                           num_micro: int, border=None) -> torch.Tensor:
    """The kernel pipeline on (B_local, Ht, W) tiles: halo census, grouped
    DP scans with cross-tile carries (chained, pipelined or local), WTA,
    LR check, speckle and median tail (JAX ``_tiled_forward_batch_pallas``).
    ``border``: the tile's rows that are global border rows, an index
    tensor on the tiles' device (None: there are none)."""
    b, ht, w = lefts.shape
    restart = diagonal_mode == "restart"
    p1, p2i = options.p1, options.p2_init
    dmin, dmax = options.min_disparity, options.max_disparity

    pad_l = halo_exchange_rows(lefts, 2, mesh)
    pad_r = halo_exchange_rows(rights, 2, mesh)
    cost = kernels.census_cost_volume(pad_l, pad_r, dmin, dmax,
                                      img_has_halo=True)
    # the image's global border rows: census code 0 in both images, so cost
    # 0 where j - d lies in the image and 127 where it does not
    if border is not None:
        lane = torch.arange(w, device=cost.device)
        shift = lane[None, :] - torch.arange(dmin, dmax, device=cost.device)[:, None]
        fix = torch.where((shift < 0) | (shift >= w), BORDER_COST, 0)
        cost[:, border] = fix.to(torch.uint8)

    part = kernels.horizontal_partial(cost, lefts, p1, p2i, restart)
    groups = kernels.scan_groups(options.num_paths)
    if cross_tile == "local" or mesh.tile == 1:
        # both scan orders in one launch, as the JAX matcher's bidir scan
        (rolls_f, _), (rolls_b, _) = groups
        part = kernels.directional_scan_group_bidir(cost, lefts, part, rolls_f,
                                                    rolls_b, p1, p2i, restart)
    else:
        # the neighbours' boundary gray rows, for P2 on a tile's first row,
        # are the census halo's inner rows: no extra hop
        prev_gray = {False: pad_l[:, 1].contiguous(),
                     True: pad_l[:, 2 + ht].contiguous()}
        d = dmax - dmin
        for rolls, reverse in groups:   # each tile has a carry in or out
            def scan(lo, hi, cin, want_carry):
                return kernels.directional_scan_group(
                    cost[lo:hi], lefts[lo:hi], part[lo:hi], rolls, reverse,
                    p1, p2i, restart, carry_in=cin, want_carry=want_carry,
                    prev_gray=prev_gray[reverse][lo:hi])[1]

            def carry_like(mb):
                return [torch.zeros((mb, len(rolls), rows, w), dtype=torch.int32,
                                    device=cost.device) for rows in (d, 1)]

            _carry_chain(scan, b, num_micro, mesh, reverse, carry_like)
    return _post_aggregation(part, options, mesh, h_total, use_kernels=True)


# --- shared tail and the matcher ----------------------------------------------

def _post_aggregation(aggr: torch.Tensor, options: SGMOptions, mesh: Mesh,
                      h_total: int, use_kernels: bool) -> torch.Tensor:
    """Aggregated uint16 (B_local, Ht, D, W) tile -> f32 disparity tile: WTA
    (+ inverse and LR check), speckle removal on the gathered plane, halo
    median with the global border rows put back."""
    if use_kernels:
        wta_reduce, lr_check = kernels.wta_reduce, kernels.lr_check
        remove_speckles = kernels.remove_speckles
    else:
        wta_reduce, lr_check = kernels.wta_reduce_plain, postprocess.lr_check
        remove_speckles = postprocess.remove_speckles
    fwd, inv = wta_reduce(aggr, options, options.is_check_lr)
    disp = finalize_disparity(fwd, options)
    if options.is_check_lr:
        disp = lr_check(disp, finalize_disparity(inv, options),
                        options.lrcheck_thres,
                        max_shift=max(options.max_disparity, 1))

    ht = disp.shape[-2]
    rows = slice(mesh.tile_index * ht, (mesh.tile_index + 1) * ht)
    full = None                 # the gathered plane, once a stage needed it
    if options.is_remove_speckles:
        full = remove_speckles(mesh.gather(disp, "tile", dim=-2), 1.0,
                               options.min_speckle_area)
        disp = full[..., rows, :]
    if options.median_inplace:
        # the raster recurrence crosses every tile boundary: filter the
        # whole plane (reusing the speckle gather) and slice it back
        if full is None:
            full = mesh.gather(disp, "tile", dim=-2)
        return postprocess.median_filter_3x3_inplace(full)[..., rows, :]
    med = postprocess.median_filter_3x3(
        halo_exchange_rows(disp, 1, mesh))[..., 1:1 + ht, :]
    gr = _global_rows(mesh, ht, disp.device)
    border = (gr == 0) | (gr == h_total - 1)
    return torch.where(border[:, None], disp, med)


def make_tiled_matcher(options: SGMOptions, mesh: Mesh, h: int, w: int,
                       cross_tile: str = "exact", diagonal_mode: str = "wrap",
                       num_micro: int = 0, use_kernels: bool = True):
    """Build a uint8 (B, H, W) x2 -> f32 (B, H, W) matcher over the mesh:
    batch across 'data', rows across 'tile'.

    Every rank passes the whole global batch, matches its own (data, tile)
    block and gets the whole global result back.  ``cross_tile``: 'exact',
    'pipelined' (``num_micro`` microbatches of the per-rank batch, 0 = one
    image each) or 'local'.  ``use_kernels``: the CUDA kernel path (on CPU
    tensors the wrappers run their plain versions) or the plain path."""
    if cross_tile not in CROSS_TILE:
        raise ValueError(f"cross_tile={cross_tile!r}: expected "
                         "'exact', 'pipelined' or 'local'")
    if diagonal_mode not in ("wrap", "restart"):
        raise ValueError(f"unknown diagonal_mode {diagonal_mode!r}")
    k = mesh.tile
    if h % k:
        raise ValueError(f"H={h} not divisible by tile axis size {k}")
    if h // k < 2:
        # the census halo ships 2 boundary rows per side
        raise ValueError(f"tile height {h}//{k}={h // k} < 2: the 5x5 "
                         "census halo needs >= 2 rows per tile")
    ht = h // k
    forward = _tiled_forward_kernels if use_kernels else _tiled_forward_plain
    # the tile's global border rows, as an index tensor made once a device
    # (a list index would be copied from pageable memory at every call)
    top = mesh.tile_index * ht
    border_rows = [i for i in range(ht) if not 2 <= top + i < h - 2]
    border_index = {}

    def border(device: torch.device):
        if not border_rows:
            return None
        if device not in border_index:
            border_index[device] = torch.tensor(border_rows, device=device)
        return border_index[device]

    def matcher(lefts: torch.Tensor, rights: torch.Tensor) -> torch.Tensor:
        if lefts.shape != rights.shape or lefts.dim() != 3 \
                or tuple(lefts.shape[1:]) != (h, w):
            raise ValueError(f"expected two (B, {h}, {w}) batches, got "
                             f"{tuple(lefts.shape)} and {tuple(rights.shape)}")
        if lefts.shape[0] % mesh.data:
            raise ValueError(f"batch {lefts.shape[0]} not divisible by the "
                             f"data axis size {mesh.data}")
        bl = lefts.shape[0] // mesh.data
        nm = 1
        if cross_tile == "pipelined":
            nm = num_micro if num_micro > 0 else bl
            if bl % nm:
                raise ValueError(
                    f"per-rank batch {bl} not divisible by num_micro={nm}: "
                    "trailing images would receive no vertical aggregation")
        batch = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
        rows = slice(mesh.tile_index * ht, (mesh.tile_index + 1) * ht)
        extra = (border(lefts.device),) if use_kernels else ()
        out = forward(lefts[batch, rows].contiguous(),
                      rights[batch, rows].contiguous(), options, mesh, h,
                      cross_tile, diagonal_mode, nm, *extra)
        return mesh.gather(mesh.gather(out, "tile", dim=-2), "data", dim=0)

    return matcher
