"""The SGM pipeline — PyTorch counterpart of the JAX package's
``models/sgm.py``.

census -> Hamming cost -> multi-path aggregation -> WTA (+ inverse WTA, LR
check) -> speckle removal -> 3x3 median (out-of-place, or the reference's
in-place recurrence with ``median_inplace``), on a (B, H, W) batch.
With ``use_kernels=True`` (the main path) the volume stages and the LR and
speckle passes run the hand-written CUDA kernels of ``ops/kernels.py``; the
elementwise glue (``finalize_disparity``, the median) is plain PyTorch on
the same device.  ``use_kernels=False`` runs the plain version of every
stage, on whatever device the inputs are on.

Under a recording ``torch.profiler`` each stage is a span of the program
(``utils.profiling.span``): ``sgm.census``, ``sgm.aggregate``,
``sgm.finalize`` (both views), ``sgm.lr_check``, ``sgm.speckle`` and
``sgm.median``, inside ``SGMEngine.match``'s ``sgm.match`` with its
``sgm.upload``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EngineConfig, SGMOptions

from ..ops import kernels, postprocess
from ..ops.postprocess import median_filter_3x3, median_filter_3x3_inplace
from ..ops.wta import finalize_disparity
from ..parallel.mesh import Mesh
from ..parallel.tiles import make_tiled_matcher
from ..utils.profiling import span

TILE_MODES = ("none", "exact", "pipelined", "local")


def sgm_forward(
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    options: SGMOptions,
    diagonal_mode: str = "wrap",
    use_kernels: bool = True,
) -> torch.Tensor:
    """uint8 (..., H, W) stereo pair -> float32 (..., H, W) disparity
    (+inf invalid).  Accepts any number of leading batch dimensions."""
    if diagonal_mode not in ("wrap", "restart"):
        raise ValueError(f"unknown diagonal_mode {diagonal_mode!r}")
    lead = img_left.shape[:-2]
    h, w = img_left.shape[-2:]
    if use_kernels:
        census_cost = kernels.census_cost_volume
        aggregate_wta = kernels.aggregate_paths_wta
        lr_check = kernels.lr_check
        remove_speckles = kernels.remove_speckles
    else:
        census_cost = kernels.census_cost_volume_plain
        aggregate_wta = kernels.aggregate_paths_wta_plain
        lr_check = postprocess.lr_check
        remove_speckles = postprocess.remove_speckles

    with span("census"):    # the pair as (B, H, W), then its cost volume
        left = img_left.reshape(-1, h, w).contiguous()
        right = img_right.reshape(-1, h, w).contiguous()
        cost = census_cost(left, right, options.min_disparity,
                           options.max_disparity)
    with span("aggregate"):
        fwd, inv = aggregate_wta(cost, left, options, diagonal_mode,
                                 include_inverse=options.is_check_lr)
    with span("finalize"):
        disp = finalize_disparity(fwd, options)
        if options.is_check_lr:
            disp_right = finalize_disparity(inv, options)
    if options.is_check_lr:
        with span("lr_check"):
            disp = lr_check(disp, disp_right, options.lrcheck_thres,
                            max_shift=options.max_disparity)
    if options.is_remove_speckles:
        with span("speckle"):
            disp = remove_speckles(disp, 1.0, options.min_speckle_area)
    median = median_filter_3x3_inplace if options.median_inplace \
        else median_filter_3x3
    with span("median"):
        disp = median(disp)
    return disp.reshape(lead + (h, w))


class SGMEngine:
    """Options + execution config + device, with the JAX engine's
    ``.match`` / ``.match_batch`` API.

    Inputs are numpy arrays or torch tensors (cast to uint8); the result is
    a float32 tensor on the engine's device, +inf where invalid.
    ``device="cuda"`` needs a card and raises without one: the CPU runs only
    when ``device="cpu"`` is passed, and then uses the plain ops.
    ``config.use_pallas`` selects the kernels (True) or the plain ops
    (False).  ``config.compute16`` is the TPU's int16 register-width choice
    with bit-identical results, so the port ignores it.

    With a ``mesh`` (``parallel.mesh.make_mesh``), ``match_batch`` runs
    sharded: every rank passes the global batch and gets the global result.
    With ``config.tile_mode`` 'exact', 'pipelined' or 'local' the batch is
    split over the mesh's 'data' axis and the image rows over its 'tile'
    axis (``parallel/tiles.py``); with 'none' the batch is still split over
    'data' (rows replicated over any 'tile' axis).  ``match`` never shards.

    ``upload_bytes`` counts the bytes of the uint8 tensors that ``match``
    and ``match_batch`` brought to the engine's device from another one
    (numpy inputs and CPU tensors on a card); an input already there adds
    nothing.
    """

    def __init__(self, options: SGMOptions = SGMOptions(),
                 config: EngineConfig = EngineConfig(),
                 device="cuda", mesh=None):
        if config.tile_mode not in TILE_MODES:
            raise ValueError(f"unknown tile_mode {config.tile_mode!r}")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), "
                            f"got {type(mesh).__name__}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SGMEngine(device='cuda'): no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.options = options
        self.config = config
        self.device = device
        self.mesh = mesh
        self._matchers = {}
        self.upload_bytes = 0

    def _matcher_key(self, h: int, w: int) -> tuple:
        # everything a tiled matcher bakes in: reassigned options or config
        # miss the cache instead of reusing a stale matcher
        return (h, w, self.options, self.config.tile_mode,
                self.config.diagonal_mode, self.config.use_pallas)

    def _tensor(self, img) -> torch.Tensor:
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8))
        out = img.to(device=self.device, dtype=torch.uint8)
        if out.device != img.device:
            self.upload_bytes += out.nbytes
        return out

    def match(self, img_left, img_right) -> torch.Tensor:
        """(..., H, W) pair -> (..., H, W) disparity: the spans ``sgm.match``
        and, inside it, ``sgm.upload`` and ``sgm_forward``'s stages."""
        with span("match"):
            with span("upload"):
                left, right = self._tensor(img_left), self._tensor(img_right)
            return sgm_forward(left, right, self.options,
                               self.config.diagonal_mode,
                               self.config.use_pallas)

    def match_batch(self, imgs_left, imgs_right) -> torch.Tensor:
        """(B, H, W) pairs -> (B, H, W) disparities."""
        mesh = self.mesh
        if mesh is None or (self.config.tile_mode == "none" and mesh.size == 1):
            return self.match(imgs_left, imgs_right)
        lefts, rights = self._tensor(imgs_left), self._tensor(imgs_right)
        if self.config.tile_mode == "none":     # data-parallel only
            if lefts.shape[0] % mesh.data:
                raise ValueError(f"batch {lefts.shape[0]} not divisible by "
                                 f"the data axis size {mesh.data}")
            bl = lefts.shape[0] // mesh.data
            mine = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
            return mesh.gather(self.match(lefts[mine], rights[mine]), "data",
                               dim=0)
        h, w = lefts.shape[-2:]
        key = self._matcher_key(h, w)
        if key not in self._matchers:
            self._matchers[key] = make_tiled_matcher(
                self.options, mesh, h, w, cross_tile=self.config.tile_mode,
                diagonal_mode=self.config.diagonal_mode,
                use_kernels=self.config.use_pallas)
        return self._matchers[key](lefts, rights)
