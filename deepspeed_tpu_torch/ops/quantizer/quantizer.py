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
XLA outside any kernel.

The quantized collectives of ZeRO++ (the rest of the JAX file) run over
``torch.distributed`` groups by mesh axis (``comm``), so the wire payload
really is int8/int4 codes plus fp32 scales:

- :func:`quantized_all_gather` (qwZ): quantize the shard, all-gather codes
  and scales, dequantize every piece; an autograd function whose backward
  is the reduce-scatter of the output's gradient (quantized under qgZ);
- :func:`quantized_reduce_scatter` (qgZ, one hop): an all-to-all of each
  chunk's codes, each rank summing its chunk's pieces in fp32;
- :func:`hierarchical_quantized_reduce_scatter`: the inner hop, then the
  outer hop over 1/n_inner of the bytes, landing outer-major.

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


# ---------------------------------------------------------------------------
# Quantized collectives over mesh axes
# ---------------------------------------------------------------------------

def _gathered_pieces(x: torch.Tensor, axis, block: int, bits, out_dtype) -> list:
    """Every rank's piece of ``x`` along ``axis``, in axis order, at
    ``out_dtype``: all-gathered plain (``bits=None``) or as codes."""
    from ...comm import all_gather, get_axis_size

    n = get_axis_size(axis)
    if bits is None:
        xs = all_gather(x.to(out_dtype).contiguous(), axis)
        return list(xs.reshape((n,) + tuple(x.shape)).unbind(0))
    q, scale = quantize_blockwise(x, block=block, bits=bits)
    qg = all_gather(q, axis).reshape((n,) + tuple(q.shape))
    sg = all_gather(scale, axis).reshape(n, -1)
    return [dequantize_blockwise(qg[i], sg[i], tuple(x.shape), out_dtype,
                                 block=block, bits=bits) for i in range(n)]


class _QuantizedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, gather_dim, block, bits, out_dtype, grad_bits,
                grad_hierarchy):
        ctx.cfg = (axis, gather_dim, block, grad_bits, grad_hierarchy, x.dtype)
        return torch.cat(_gathered_pieces(x, axis, block, bits, out_dtype),
                         dim=gather_dim)

    @staticmethod
    def backward(ctx, dy):
        axis, dim, block, grad_bits, hier, dtype = ctx.cfg
        if grad_bits is None:
            from ...comm import reduce_scatter

            dx = reduce_scatter(dy.contiguous(), axis, scatter_dim=dim)
        elif hier is not None:
            inner, outer = hier
            dx = hierarchical_quantized_reduce_scatter(dy, inner, outer, scatter_dim=dim,
                                                       block=block, bits=grad_bits)
        else:
            dx = quantized_reduce_scatter(dy, axis, scatter_dim=dim, block=block,
                                          bits=grad_bits)
        return dx.to(dtype), None, None, None, None, None, None, None


def quantized_all_gather(x_shard: torch.Tensor, axis, gather_dim: int = 0,
                         block: int = DEFAULT_BLOCK, bits=8, out_dtype=None,
                         grad_bits=None, grad_hierarchy=None) -> torch.Tensor:
    """qwZ: all-gather a shard over ``axis`` with an int8/int4 wire format
    (``bits=None``: plain, at ``out_dtype``), concatenated along
    ``gather_dim`` in axis order.  Its backward is the adjoint of the
    gather, the reduce-scatter of the output's gradient: plain, or the
    qgZ quantized reduction (``grad_bits``), over two hops when
    ``grad_hierarchy=(inner_axes, outer_axis)``."""
    return _QuantizedGather.apply(x_shard, axis, gather_dim, block, bits,
                                  out_dtype or x_shard.dtype, grad_bits, grad_hierarchy)


def quantized_reduce_scatter(grads: torch.Tensor, axis, scatter_dim: int = 0,
                             block: int = DEFAULT_BLOCK, bits: int = 8) -> torch.Tensor:
    """qgZ, one hop: the sum over ``axis`` of ``grads`` with a quantized
    wire format, each rank landing its chunk along ``scatter_dim``.  Each
    rank's chunk for rank i (padded to whole blocks, so no scale block
    straddles two chunks) is quantized, an all-to-all hands rank i every
    peer's chunk i, and rank i sums their dequantized values in fp32 in
    axis order: one quantization a hop, the JAX function's arithmetic."""
    from ...comm import all_to_all, get_axis_size

    n = get_axis_size(axis)
    moved = grads.movedim(scatter_dim, 0)
    lead = moved.shape[0]
    if lead % n:
        raise ValueError(f"dim {scatter_dim} ({lead}) not divisible by {n}")
    rest = tuple(moved.shape[1:])
    per_chunk = (lead // n) * math.prod(rest)
    pad = (-per_chunk) % block
    flat = moved.reshape(n, per_chunk)
    if pad:
        flat = F.pad(flat, (0, pad))
    q, scale = quantize_blockwise(flat, block=block, bits=bits)
    nblk = q.shape[0] // n
    qx = all_to_all(q.reshape(n, nblk, q.shape[-1]).contiguous(), axis)
    sx = all_to_all(scale.reshape(n, nblk).contiguous(), axis)
    total = None
    for i in range(n):
        c = dequantize_blockwise(qx[i], sx[i], (per_chunk + pad,), torch.float32,
                                 block=block, bits=bits)
        total = c if total is None else total + c
    out = total[:per_chunk].reshape((lead // n,) + rest).movedim(0, scatter_dim)
    return out.to(grads.dtype)


def hierarchical_quantized_reduce_scatter(grads: torch.Tensor, inner_axes, outer_axis,
                                          scatter_dim: int = 0,
                                          block: int = DEFAULT_BLOCK,
                                          bits: int = 8) -> torch.Tensor:
    """qgZ, two hops: the inner group's quantized reduce-scatter, then the
    outer group's over 1/n_inner of the bytes (the reference's
    hierarchical all-to-all reduction, coalesced_collectives.py:31).  The
    landing is outer-major (rank (o, j) owns chunk ``o*n_inner + j``): hop
    1 scatters the inner-chunk axis of an [n_outer, n_inner, L/N] view (a
    strided chunk set), hop 2 the outer axis.  Each hop re-quantizes."""
    from ...comm import get_axis_size

    n_i, n_o = get_axis_size(inner_axes), get_axis_size(outer_axis)
    moved = grads.movedim(scatter_dim, 0)
    lead = moved.shape[0]
    n = n_i * n_o
    if lead % n:
        raise ValueError(f"dim {scatter_dim} ({lead}) not divisible by group "
                         f"{n_o}x{n_i}")
    rest = tuple(moved.shape[1:])
    view = moved.reshape((n_o, n_i, lead // n) + rest)
    r1 = quantized_reduce_scatter(view, inner_axes, scatter_dim=1, block=block, bits=bits)
    r1 = r1.reshape((n_o, lead // n) + rest)
    r2 = quantized_reduce_scatter(r1, outer_axis, scatter_dim=0, block=block, bits=bits)
    out = r2.reshape((lead // n,) + rest)
    return out.movedim(0, scatter_dim).to(grads.dtype)
