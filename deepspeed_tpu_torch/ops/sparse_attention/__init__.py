"""Block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/``; reference
``deepspeed/ops/sparse_attention/``).

The reference implements block-sparse attention with Triton matmul/softmax
kernels driven by a layout tensor (``sparse_self_attention.py``,
``matmul.py``, ``softmax.py``).  Here, as in the JAX package, the flash
kernels that serve dense causal attention take the pattern as a block mask,
forward and backward (``ops/kernels/flash_attention.py`` ``block_mask``):
K1, K2 and K3 each walk only the live tiles of the layout, so a dead block
costs neither its K/V loads nor its math.
"""
from __future__ import annotations

from typing import Optional

from ..kernels.flash_attention import flash_attention
from .sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)


class SparseSelfAttention:
    """Functional analogue of reference ``SparseSelfAttention`` (sparse_self_
    attention.py): holds a sparsity config, applies block-sparse attention.

    Call with q ``[B, S, Hq, hd]`` and k/v ``[B, S, Hkv, hd]`` (the model
    family's layout); one layout serves every head.  CUDA tensors launch
    the kernels, CPU tensors run their plain versions."""

    def __init__(self, sparsity_config: SparsityConfig,
                 max_seq_length: int = 2048):
        self.sparsity_config = sparsity_config
        self.max_seq_length = max_seq_length
        self._layout_cache: dict = {}

    def layout(self, seq_len: int):
        """The bool ``[S/block, S/block]`` block mask at ``seq_len``."""
        if seq_len > self.max_seq_length:
            raise ValueError(
                f"seq_len {seq_len} exceeds max_seq_length "
                f"{self.max_seq_length}")
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = \
                self.sparsity_config.make_layout(seq_len)
        return self._layout_cache[seq_len]

    def __call__(self, q, k, v, sm_scale: Optional[float] = None):
        S = q.shape[1]
        blk = self.sparsity_config.block
        causal = self.sparsity_config.attention == "unidirectional"
        return flash_attention(
            q, k, v, causal=causal, sm_scale=sm_scale,
            block_q=blk, block_k=blk, block_mask=self.layout(S))

    def density(self, seq_len: int) -> float:
        """Fraction of live blocks: the work against dense attention, which
        the kernels pay in loads as well as in math."""
        m = self.layout(seq_len)
        return float(m.sum()) / m.size
