"""Quantization-aware training primitives (counterpart of
``deepspeed_tpu/compression/quantize.py``; reference
``compression/basic_layer.py`` weight/activation fake-quant).

Fake-quant is elementwise: the JAX package leaves it to XLA's fusion, the
port to PyTorch's elementwise ops, on the device the tensor lives on (no
kernel: the round trip is a few passes over the weight, next to the matmul
that reads it).  The arithmetic is the JAX package's: statistics in fp32
(the max of |w|, or the min and max), ``scale = max(range, 1e-8) / qmax``,
round half to even, clip, rescale, cast back to the input's dtype.  The
range statistics carry no gradient; the rounding passes the gradient
straight through inside its closed range and gives 0 outside it
(:class:`_SteRoundClip`).

:func:`quant_stats` and :func:`quant_apply` split a fake-quant in two, so
the training engine can take the statistics over a whole leaf and apply
them to the piece of it a rank holds (ZeRO-3, the 'model' axis).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


class _SteRoundClip(torch.autograd.Function):
    """clip(round(x), lo, hi) with the saturating straight-through
    gradient: pass within the closed range, zero outside (a plain clip
    would halve the gradient at exact-boundary ties)."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(torch.round(x), lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x >= ctx.lo) & (x <= ctx.hi)
        return torch.where(inside, g, torch.zeros_like(g)), None, None


def _ste_round_clip(x, lo: float, hi: float):
    return _SteRoundClip.apply(x, lo, hi)


def _reduce_dims(w: torch.Tensor, per_channel: bool, axis: int):
    if not per_channel:
        return tuple(range(w.ndim))
    return tuple(i for i in range(w.ndim) if i != axis % w.ndim)


def quant_stats(w: torch.Tensor, bits: int, symmetric: bool = True,
                per_channel: bool = False, axis: int = -1,
                reduce: Optional[Callable] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(scale, lo) of a fake-quant of ``w`` (lo None when symmetric), in
    fp32, shaped to broadcast against ``w``; no gradient.  ``reduce(x,
    op)`` ("max"/"min") combines a statistic over the ranks that hold
    other pieces of the tensor (dynamic activation quant at dp > 1)."""
    with torch.no_grad():
        w32 = w.detach().to(torch.float32)
        dims = _reduce_dims(w, per_channel, axis)
        if symmetric:
            qmax = 2.0 ** (bits - 1) - 1.0
            amax = torch.amax(torch.abs(w32), dim=dims, keepdim=True)
            if reduce is not None:
                amax = reduce(amax, "max")
            return torch.clamp(amax, min=1e-8) / qmax, None
        qmax = 2.0 ** bits - 1.0
        lo = torch.amin(w32, dim=dims, keepdim=True)
        hi = torch.amax(w32, dim=dims, keepdim=True)
        if reduce is not None:
            lo, hi = reduce(lo, "min"), reduce(hi, "max")
        return torch.clamp(hi - lo, min=1e-8) / qmax, lo


def quant_apply(w: torch.Tensor, bits: int, symmetric: bool, scale: torch.Tensor,
                lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fake-quant of ``w`` with given statistics (straight-through
    gradient)."""
    w32 = w.to(torch.float32)
    if symmetric:
        qmax = 2.0 ** (bits - 1) - 1.0
        q = _ste_round_clip(w32 / scale, -qmax - 1.0, qmax)
        return (q * scale).to(w.dtype)
    qmax = 2.0 ** bits - 1.0
    q = _ste_round_clip((w32 - lo) / scale, 0.0, qmax)
    return (q * scale + lo).to(w.dtype)


def quantize_ste(w: torch.Tensor, bits: int, symmetric: bool = True,
                 per_channel: bool = False, axis: int = -1) -> torch.Tensor:
    """Fake-quantize ``w`` to ``bits`` with a straight-through gradient.

    symmetric: scale = max|w| / qmax, zero-point 0; asymmetric: the affine
    [min, max] mapping.  per_channel reduces the statistics over every axis
    but ``axis`` (the output channel).  16 bits and more: ``w`` itself."""
    if bits >= 16:
        return w
    return quant_apply(w, bits, symmetric,
                       *quant_stats(w, bits, symmetric, per_channel, axis))


def activation_fake_quant(x: torch.Tensor, bits: int, symmetric: bool = False,
                          static_range: Optional[float] = None,
                          reduce: Optional[Callable] = None) -> torch.Tensor:
    """Activation fake-quant: dynamic per-tensor min/max each call (the
    statistics stay on the tensor's device), or a fixed symmetric
    ``static_range``.  ``reduce``: see :func:`quant_stats`."""
    if bits >= 16:
        return x
    if static_range is not None:
        qmax = 2.0 ** (bits - 1) - 1.0
        scale = static_range / qmax
        q = _ste_round_clip(x.to(torch.float32) / scale, -qmax - 1.0, qmax)
        return (q * scale).to(x.dtype)
    return quant_apply(x, bits, symmetric,
                       *quant_stats(x, bits, symmetric, False, -1, reduce=reduce))


def bit_schedule(step: int, start_bits: int, target_bits: int,
                 offset: int, period: int) -> int:
    """MoQ-style bit annealing: ``start_bits`` dropping by one every
    ``period`` steps after ``offset``, down to ``target_bits``."""
    step = int(step)
    if start_bits <= target_bits or period <= 0:
        return int(target_bits)
    drops = max(step - offset, 0) // period
    return max(int(start_bits) - drops, int(target_bits))


def quantize_ste_scheduled(w, step: int, start_bits: int, target_bits: int,
                           offset: int, period: int, symmetric: bool = True,
                           per_channel: bool = False):
    """Fake-quant at the annealed bit-width of ``step``."""
    return quantize_ste(w, bit_schedule(step, start_bits, target_bits, offset, period),
                        symmetric, per_channel)
