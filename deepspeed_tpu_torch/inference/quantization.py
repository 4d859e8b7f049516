"""Weight-only quantized inference (counterpart of
``deepspeed_tpu/inference/quantization.py``; reference ZeRO-Inference:
``init_inference(dtype=torch.int8)``): weights live int8/int4 at rest and
are dequantized at use.

The leaf rule is the JAX package's: every floating leaf of two or more
dims and at least :data:`MIN_QUANT_SIZE` elements becomes a
:class:`QuantizedWeight` whose blocks run over the whole flattened leaf
(the stacked ``[L, d]`` norm scales of a 7B model included); the rest are
cast to the compute dtype.  Where the JAX engine dequantizes the whole tree
at the entry of each jitted program and lets XLA fuse it, the port's
``models/transformer.py`` dequantizes one layer at a time
(``QuantizedWeight.layer``), so at most one layer's compute-dtype copy is
live; dequantization is elementwise, so the logits are bit-equal to
``forward(dequantize_params(q))``.
"""
from __future__ import annotations

from typing import Any

import torch

from ..ops.quantizer import DEFAULT_BLOCK, QuantizedWeight
from ..utils.tree import tree_leaves

__all__ = ["MIN_QUANT_SIZE", "QuantizedWeight", "quantize_params",
           "dequantize_params", "tree_nbytes"]

# leaves smaller than this stay in compute dtype (norm scales, biases:
# quantizing them saves nothing and costs accuracy)
MIN_QUANT_SIZE = 4096


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def quantize_params(params: Any, bits: int = 8, block: int = DEFAULT_BLOCK,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    min_size: int = MIN_QUANT_SIZE, device=None) -> Any:
    """Quantize every big floating leaf of two or more dims; cast the other
    floating leaves to ``compute_dtype``.  Leaf by leaf, each moved to
    ``device`` (when given) first, so peak memory is the input tree, the
    quantized tree and one leaf's staging copy."""
    def q(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if device is not None:
            leaf = leaf.to(device)
        if not leaf.is_floating_point():
            return leaf
        if leaf.ndim >= 2 and leaf.numel() >= min_size:
            return QuantizedWeight.quantize(leaf, compute_dtype, bits=bits, block=block)
        return leaf.to(compute_dtype)

    return _map(q, params)


def dequantize_params(params: Any) -> Any:
    """The compute-dtype tree (every :class:`QuantizedWeight` dequantized
    whole)."""
    return _map(lambda x: x.dequantize() if isinstance(x, QuantizedWeight) else x,
                params)


def tree_nbytes(params: Any) -> int:
    """Bytes at rest: codes and scales of quantized leaves, the others'
    storage."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QuantizedWeight):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
