"""PyTorch/CUDA port of the SGM stereo engine.

A second package beside ``soc_project_stereo_matching_tpu`` (the JAX
reference, which it is tested against bit for bit).  It imports ``torch``
and never ``jax``.

SGM has no learned weights: its parameters are the ``SGMOptions`` and
``EngineConfig`` dataclasses of ``config.py``, the port's own copy of the JAX
package's module of that name (same fields and defaults, one YAML format).
``config.from_jax`` turns the JAX package's dataclass into the port's, which
is how a test hands one set of options to both.

Layers, mirroring the JAX package:
  ops/       plain PyTorch ops (census, cost volume, path aggregation, WTA,
             post-processing) and ``ops/kernels.py``, the wrappers of the
             hand-written CUDA kernels in ``csrc/``
  models/    ``sgm_forward`` and ``SGMEngine``
  probes/    measurement tools with kernels of their own: the recurrence
             floor, the volume transpose, the 16-bit recurrence, the
             stage ablation (``python -m ...probes <name>``)
  utils/     CUDA-event timing, the profiler trace, the card's name
  _build.py  builds ``csrc/*.cu`` with nvcc at first use, loads it via ctypes
"""

from .config import EngineConfig, SGMOptions

from .models.sgm import SGMEngine

__all__ = ["SGMOptions", "EngineConfig", "SGMEngine"]
