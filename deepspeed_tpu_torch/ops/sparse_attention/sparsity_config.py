"""Block-sparsity pattern builders (a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``: numpy only, kept
here because importing the JAX package loads jax).

Parity target: reference ``ops/sparse_attention/sparsity_config.py``
(SparsityConfig :10, Dense :63, Fixed :95, Variable :239, BigBird :411,
BSLongformer :546, LocalSlidingWindow :674).  The reference emits a
[heads, num_blocks, num_blocks] layout tensor that drives Triton block-sparse
matmuls; here each config emits a boolean block mask that drives the flash
kernels' masked mode (``ops/kernels/flash_attention.py`` ``block_mask``) —
same sparsity semantics, one layout shared by all heads, as in the JAX
package.  Random blocks come from ``np.random.default_rng(0)``, so every
layout is bit-identical to the JAX package's.

All masks are numpy bool [num_blocks, num_blocks] with ``mask[q, k] = True``
when the (q, k) block participates.  'unidirectional' composes the causal
triangle in; the kernels additionally apply elementwise causal masking
inside diagonal blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Base: block size + attention direction (reference :10-15 fields;
    ``different_layout_per_head`` is intentionally unsupported — see module
    docstring)."""
    num_heads: int = 1
    block: int = 128
    attention: str = "unidirectional"   # unidirectional | bidirectional

    def __post_init__(self):
        if self.attention not in ("unidirectional", "bidirectional"):
            raise ValueError(
                f"attention={self.attention!r} must be 'unidirectional' or "
                "'bidirectional'")

    def num_blocks(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(
                f"seq_len {seq_len} must be a multiple of block {self.block}")
        return seq_len // self.block

    def _finalize(self, mask: np.ndarray) -> np.ndarray:
        if self.attention == "unidirectional":
            mask &= np.tril(np.ones_like(mask))
        # a row with no live blocks would make softmax undefined: keep the
        # diagonal always
        np.fill_diagonal(mask, True)
        return mask

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseSparsityConfig(SparsityConfig):
    """Everything attends (reference :63) — the parity/debug config."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        return self._finalize(np.ones((n, n), bool))


@dataclasses.dataclass(frozen=True)
class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern (reference :95): each block attends to its local window
    of ``num_local_blocks`` and to ``num_global_blocks`` summary blocks at
    each local window's tail (the GPT-3 'fixed' pattern)."""
    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        mask = np.zeros((n, n), bool)
        loc = self.num_local_blocks
        for q in range(n):
            start = (q // loc) * loc
            mask[q, start:start + loc] = True          # local window
        # global: the last `num_global_blocks` of EVERY window are visible
        # from all rows; _finalize's tril trims future ones for causal
        for wstart in range(0, n, loc):
            g0 = max(wstart + loc - self.num_global_blocks, wstart)
            mask[:, g0:wstart + loc] = True
        return self._finalize(mask)


@dataclasses.dataclass(frozen=True)
class VariableSparsityConfig(SparsityConfig):
    """Variable pattern (reference :239): arbitrary local window sizes plus
    explicit global block indices."""
    num_random_blocks: int = 0
    local_window_blocks: tuple = (4,)
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        mask = np.zeros((n, n), bool)
        q = 0
        windows = list(self.local_window_blocks)
        while q < n:
            w = windows.pop(0) if windows else self.local_window_blocks[-1]
            end = min(q + w, n)
            mask[q:end, q:end] = True
            q = end
        for g in self.global_block_indices:
            if g < n:
                mask[:, g] = True                      # everyone sees global
                mask[g, :] = True                      # global sees everyone
        if self.num_random_blocks:
            rng = np.random.default_rng(0)             # deterministic layout
            for q in range(n):
                mask[q, rng.integers(0, n, self.num_random_blocks)] = True
        return self._finalize(mask)


@dataclasses.dataclass(frozen=True)
class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (reference :411): sliding window + random + global blocks."""
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        mask = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks // 2
        for q in range(n):
            mask[q, max(0, q - w):q + w + 1] = True
        g = self.num_global_blocks
        mask[:, :g] = True
        mask[:g, :] = True
        rng = np.random.default_rng(0)
        for q in range(n):
            mask[q, rng.integers(0, n, self.num_random_blocks)] = True
        return self._finalize(mask)


@dataclasses.dataclass(frozen=True)
class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer (reference :546): sliding window + explicit global ids."""
    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        mask = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks // 2
        for q in range(n):
            mask[q, max(0, q - w):q + w + 1] = True
        for g in self.global_block_indices:
            if g < n:
                mask[:, g] = True
                mask[g, :] = True
        return self._finalize(mask)


@dataclasses.dataclass(frozen=True)
class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference :674)."""
    num_sliding_window_blocks: int = 3

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        mask = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks // 2
        for q in range(n):
            mask[q, max(0, q - w):q + w + 1] = True
        return self._finalize(mask)
