"""Conventions shared by the port's hand-written kernels (counterpart of
``deepspeed_tpu/ops/pallas/common.py``).

  - ``NEG_INF`` — the masking constant.  Finite: ``-inf`` breaks the online
    softmax's ``exp(m_prev - m_new)`` rescale when a whole tile is masked.
    The CUDA sources use the same value (``flash_attention_fwd.cu``).
  - ``pick_block()`` — largest power-of-two tile that divides the axis.
  - ``mask_to_i32()`` — masks cross the kernel boundary as int32.

The Pallas module's ``interpret_default`` and ``parallel_semantics`` have no
counterpart: a CUDA kernel has no interpret mode (the wrappers run the plain
PyTorch version for CPU tensors) and blocks are always independent.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def pick_block(n: int, want: int, floor: int = 8) -> int:
    """Largest power-of-two block <= ``want`` dividing ``n`` (>= ``floor``).

    Raises NotImplementedError when no such block exists — callers fall back
    to their plain path rather than running a ragged final tile.
    """
    b = min(want, n)
    while b > floor and n % b:
        b //= 2
    # a full-axis tile (b == n) is legal at any size; otherwise the tile must
    # divide n and respect the floor
    if n % b or (b < floor and b != n):
        raise NotImplementedError(
            f"axis length {n} has no power-of-two block divisor >= {floor}; "
            "use the plain path")
    return b


def mask_to_i32(mask) -> torch.Tensor:
    """Boolean mask -> int32 for crossing the kernel boundary."""
    return torch.as_tensor(mask).to(torch.int32)
