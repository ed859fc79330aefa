"""The (data, tile) mesh over ``torch.distributed`` ranks — counterpart of
the JAX package's ``parallel/mesh.py``.

One process drives one device.  Rank r of a world of ``data * tile`` ranks
sits at mesh position (r // tile, r % tile), row-major like the device array
of the JAX ``make_mesh``:

* ``data`` — batch data parallelism (frames per device);
* ``tile`` — spatial parallelism (image H-tiles with halo exchange and
  cross-tile scan carries, ``parallel/tiles.py``).

A rank's tile group holds the ranks of its mesh row (the H-tiles of its
images); its data group those of its mesh column.  Point-to-point hops go
over the default group by global rank.  A mesh of size 1 needs no process
group at all, as the JAX tiled matcher bypasses ``shard_map`` there.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """A rank's view of the (data, tile) mesh: its position and groups."""

    def __init__(self, data: int, tile: int, rank: int = 0,
                 tile_group: Optional[dist.ProcessGroup] = None,
                 data_group: Optional[dist.ProcessGroup] = None):
        self.data, self.tile, self.rank = data, tile, rank
        self.tile_group, self.data_group = tile_group, data_group

    @property
    def shape(self) -> dict:
        return {"data": self.data, "tile": self.tile}

    @property
    def size(self) -> int:
        return self.data * self.tile

    @property
    def data_index(self) -> int:
        return self.rank // self.tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.tile

    def tile_rank(self, t: int) -> int:
        """Global rank of tile ``t`` in this rank's mesh row."""
        return self.data_index * self.tile + t

    def gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """All-gather ``x`` over the ``axis`` ('data' or 'tile') group and
        concatenate the pieces in mesh order along ``dim``."""
        n, group = ((self.data, self.data_group) if axis == "data"
                    else (self.tile, self.tile_group))
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, tile={self.tile}, rank={self.rank})"


def make_mesh(data: Optional[int] = None, tile: int = 1,
              timeout: Optional[timedelta] = None) -> Mesh:
    """Build a (data, tile) mesh.  ``data=None`` uses all remaining ranks.

    A mesh of more than one rank needs ``torch.distributed`` initialised
    (``multihost.initialize``) over exactly ``data * tile`` ranks; every
    rank must call this, in the same order, since each creates every group.
    ``timeout`` bounds the groups' collectives (default: torch's)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if world % tile:
            raise ValueError(f"{world} ranks not divisible by tile={tile}")
        data = world // tile
    if data < 1 or tile < 1:
        raise ValueError(f"mesh {data}x{tile}: both axes must be >= 1")
    if data * tile == 1:
        return Mesh(1, 1)
    if not dist.is_initialized():
        raise RuntimeError(f"a {data}x{tile} mesh needs torch.distributed "
                           "initialised (parallel.multihost.initialize)")
    if data * tile != world:
        raise ValueError(f"mesh {data}x{tile} needs {data * tile} ranks; "
                         f"the world has {world}")
    rank = dist.get_rank()
    kw = {} if timeout is None else {"timeout": timeout}
    tile_group = data_group = None
    for d in range(data if tile > 1 else 0):
        group = dist.new_group([d * tile + t for t in range(tile)], **kw)
        if d == rank // tile:
            tile_group = group
    for t in range(tile if data > 1 else 0):
        group = dist.new_group([d * tile + t for d in range(data)], **kw)
        if t == rank % tile:
            data_group = group
    return Mesh(data, tile, rank, tile_group, data_group)
