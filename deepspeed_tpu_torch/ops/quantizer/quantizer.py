"""Blockwise weight quantization (counterpart of
``deepspeed_tpu/ops/quantizer/quantizer.py``: ``_qmax``,
``quantize_blockwise``, ``dequantize_blockwise``), and the
:class:`QuantizedWeight` that holds one quantized parameter leaf.

Symmetric per-block scaling: each block of ``block`` consecutive elements
of the flattened tensor shares one fp32 scale ``amax / qmax``; codes are
``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
``[-qmax, qmax]``; int4 packs two codes a byte, the even element in the
low nibble.  The tail block is zero-padded, and padding quantizes to 0
exactly.  These are plain torch ops, as the JAX package computes them in
XLA outside any kernel; the quantized collectives of ZeRO++ (the rest of
the JAX file) are not ported yet (ROADMAP queue 1, item 10).

:class:`QuantizedWeight` lives here, beside the ops that make and read it,
so that ``models/transformer.py`` can dequantize a layer at use without
importing the inference package.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

DEFAULT_BLOCK = 256

# blocks quantized per step: bounds the fp32 staging copy of a large leaf
# (llama2-7b's stacked w_gate is 1.4e9 elements) at 64 MiB
_CHUNK_ELEMENTS = 1 << 24


def _qmax(bits: int) -> int:
    if bits == 8:
        return 127
    if bits == 4:
        return 7
    raise ValueError(f"bits must be 4 or 8, got {bits}")


def quantize_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK,
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q int8 ``[nblocks, block]`` (``block // 2`` for
    int4), scales fp32 ``[nblocks]``), on x's device.  The blocks are
    quantized a chunk at a time; each block's arithmetic is the JAX
    package's."""
    qmax = _qmax(bits)
    flat = x.reshape(-1)
    n = flat.numel()
    nblocks = -(-n // block)
    width = block if bits == 8 else block // 2
    q = torch.empty((nblocks, width), dtype=torch.int8, device=x.device)
    scale = torch.empty((nblocks,), dtype=torch.float32, device=x.device)
    step = max(1, _CHUNK_ELEMENTS // block)
    for b0 in range(0, nblocks, step):
        b1 = min(nblocks, b0 + step)
        rows = flat[b0 * block:b1 * block].float()
        if rows.numel() < (b1 - b0) * block:
            rows = F.pad(rows, (0, (b1 - b0) * block - rows.numel()))
        rows = rows.reshape(-1, block)
        amax = rows.abs().amax(dim=1)
        s = torch.where(amax == 0, torch.ones_like(amax), amax / qmax)
        codes = torch.clamp(torch.round(rows / s[:, None]), -qmax, qmax).to(torch.int8)
        if bits == 4:
            codes = (codes[:, 0::2] & 0xF) | (codes[:, 1::2] << 4)
        q[b0:b1] = codes
        scale[b0:b1] = s
    return q, scale


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor, bits: int,
                     dtype) -> torch.Tensor:
    """``[nblocks, block]`` in ``dtype`` from codes and scales: one
    elementwise op that multiplies in fp32 (the codes' and scales' common
    type) and rounds to ``dtype`` on the store, the values of JAX's
    ``(q.astype(f32) * scale).astype(dtype)`` without an fp32 copy."""
    if bits == 4:
        # sign-extend each nibble: shift to the top of the byte, shift back
        lo = (q << 4) >> 4
        hi = q >> 4
        q = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, scale[:, None], out=out)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape, dtype,
                         block: int = DEFAULT_BLOCK, bits: int = 8) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`."""
    size = math.prod(shape)
    return _dequantize_rows(q, scale, bits, dtype).reshape(-1)[:size].view(shape)


class QuantizedWeight:
    """One blockwise-quantized leaf (the JAX package's pytree node of
    ``inference/quantization.py``): codes, scales, the leaf's shape, its
    compute dtype, bits and block.  The blocks run over the whole flattened
    leaf, a stacked ``[L, ...]`` layer leaf included, so one block may
    straddle two layers; :meth:`layer` dequantizes the blocks that cover
    one layer and cuts it out, the same values as ``dequantize()[i]``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, shape, dtype,
                 bits: int, block: int):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)
        self.dtype = dtype
        self.bits = int(bits)
        self.block = int(block)

    @classmethod
    def quantize(cls, x: torch.Tensor, dtype, bits: int = 8,
                 block: int = DEFAULT_BLOCK) -> "QuantizedWeight":
        q, scale = quantize_blockwise(x, block=block, bits=bits)
        return cls(q, scale, x.shape, dtype, bits, block)

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def dequantize(self) -> torch.Tensor:
        return dequantize_blockwise(self.q, self.scale, self.shape, self.dtype,
                                    block=self.block, bits=self.bits)

    def layer(self, i: int) -> torch.Tensor:
        """``dequantize()[i]`` of a stacked leaf, dequantizing only the
        blocks that cover row ``i``.  The row is cut from the dequantized
        blocks, so it sits at the offset (modulo a block) it has in the
        whole dequantized leaf: the same alignment, hence the same matmul
        kernels and bit-equal results."""
        per = math.prod(self.shape[1:])
        start, stop = i * per, (i + 1) * per
        b0, b1 = start // self.block, -(-stop // self.block)
        flat = _dequantize_rows(self.q[b0:b1], self.scale[b0:b1], self.bits,
                                self.dtype).reshape(-1)
        off = start - b0 * self.block
        return flat[off:off + per].view(self.shape[1:])

    def __repr__(self) -> str:
        return (f"QuantizedWeight(shape={self.shape}, dtype={self.dtype}, "
                f"bits={self.bits}, block={self.block}, device={self.q.device})")
