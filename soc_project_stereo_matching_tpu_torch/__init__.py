"""PyTorch/CUDA port of the SGM stereo engine.

A second package beside ``soc_project_stereo_matching_tpu`` (the JAX
reference, which it is tested against bit for bit).  It imports ``torch``
and never ``jax``.

SGM has no learned weights: its parameters are the ``SGMOptions`` and
``EngineConfig`` dataclasses of ``soc_project_stereo_matching_tpu.config``,
a module that imports only ``dataclasses`` (the reference package's
``__init__`` imports nothing else).  The port uses those objects as they are,
so no conversion function exists.

Layers, mirroring the JAX package:
  ops/       plain PyTorch ops (census, cost volume, path aggregation, WTA,
             post-processing) and ``ops/kernels.py``, the wrappers of the
             hand-written CUDA kernels in ``csrc/``
  models/    ``sgm_forward`` and ``SGMEngine``
  _build.py  builds ``csrc/*.cu`` with nvcc at first use, loads it via ctypes
"""

from soc_project_stereo_matching_tpu.config import EngineConfig, SGMOptions

from .models.sgm import SGMEngine

__all__ = ["SGMOptions", "EngineConfig", "SGMEngine"]
