"""Correctly-rounded division — PyTorch counterpart of the JAX package's
``ops/exact_math.py``.

The TPU needed an integer divide ladder because its f32 divide is
approximate.  PyTorch's f32 ``/`` is IEEE round-to-nearest-even on both the
CPU and CUDA (PyTorch is not built with fast-math), and every int32 with
``|n| < 2**24`` converts to f32 exactly, so the quotient of the two
conversions is already the correctly-rounded one.
"""

from __future__ import annotations

import torch


def div_s32_correctly_rounded(n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """IEEE-f32 round-to-nearest-even of n/m for int32 n, m.

    Same domain as the JAX ladder: ``|n| < 2**17`` and ``1 <= m < 2**16``."""
    return n.to(torch.float32) / m.to(torch.float32)
