"""Pruning mask builders: sparse, row, channel and head (counterpart of
``deepspeed_tpu/compression/prune.py``; reference ``compression/
basic_layer.py``'s pruning paths).

Masks are functions of the weights, recomputed each step rather than
stored, in the JAX package's arithmetic: scores in fp32, the keep count
``max(1, round(size * dense_ratio))`` (Python's round, half to even), the
threshold the k-th largest score, and every score ``>=`` it kept — so ties
at the threshold keep more than k, as in the JAX package.

``batch_dims`` (default 0) treats that many leading dims as independent
slices, each with its own threshold: what the JAX package's ``vmap`` over
the stacked ``[L, ...]`` layers gives, in one segmented sort per leaf.
"""
from __future__ import annotations

from typing import Optional

import torch


def _keep_threshold(scores: torch.Tensor, dense_ratio: float,
                    batch_dims: int = 0) -> torch.Tensor:
    """Score cutoff keeping the top ``dense_ratio`` fraction of each slice:
    the k-th largest score (shape: the batch dims)."""
    flat = scores.reshape(tuple(scores.shape[:batch_dims]) + (-1,))
    n = flat.shape[-1]
    k = max(1, int(round(n * dense_ratio)))
    return torch.sort(flat, dim=-1).values[..., n - k]


def _expand(thr: torch.Tensor, ndim: int) -> torch.Tensor:
    return thr.reshape(tuple(thr.shape) + (1,) * (ndim - thr.dim()))


def sparse_mask(w: torch.Tensor, dense_ratio: float, method: str = "l1",
                batch_dims: int = 0) -> torch.Tensor:
    """Unstructured mask keeping the largest-|w| ``dense_ratio`` fraction
    ('l1' and 'topk' share the magnitude criterion)."""
    scores = torch.abs(w.detach().to(torch.float32))
    thr = _keep_threshold(scores, dense_ratio, batch_dims)
    return (scores >= _expand(thr, scores.dim())).to(w.dtype)


def row_mask(w: torch.Tensor, dense_ratio: float, axis: int = 0,
             batch_dims: int = 0) -> torch.Tensor:
    """Structured mask keeping whole rows (channels along ``axis`` of each
    slice) with the largest L1 norms."""
    ax = batch_dims + axis % (w.ndim - batch_dims)
    scores = torch.sum(torch.abs(w.detach().to(torch.float32)),
                       dim=tuple(i for i in range(batch_dims, w.ndim) if i != ax))
    thr = _keep_threshold(scores, dense_ratio, batch_dims)
    shape = list(w.shape[:batch_dims]) + [1] * (w.ndim - batch_dims)
    shape[ax] = w.shape[ax]
    return (scores >= _expand(thr, scores.dim())).reshape(shape).to(w.dtype)


def channel_mask(w: torch.Tensor, dense_ratio: float, axis: int = -1,
                 batch_dims: int = 0) -> torch.Tensor:
    """Structured mask over input channels."""
    return row_mask(w, dense_ratio, axis=axis, batch_dims=batch_dims)


def head_mask(wo: torch.Tensor, num_heads: int, dense_ratio: float,
              batch_dims: int = 0) -> torch.Tensor:
    """Mask whole attention heads of the output projection ``wo``
    ``[num_heads*head_dim, hidden]`` by per-head L1 norm."""
    head_dim = wo.shape[-2] // num_heads
    blocks = torch.abs(wo.detach().to(torch.float32)).reshape(
        tuple(wo.shape[:-2]) + (num_heads, head_dim, wo.shape[-1]))
    per_head = torch.sum(blocks, dim=(-2, -1))
    thr = _keep_threshold(per_head, dense_ratio, batch_dims)
    keep = (per_head >= _expand(thr, per_head.dim()))[..., :, None, None].expand(blocks.shape)
    return keep.reshape(wo.shape).to(wo.dtype)


def apply_mask(w: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return w if mask is None else w * mask
