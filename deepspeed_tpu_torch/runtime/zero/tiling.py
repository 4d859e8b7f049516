"""Tiled linear for memory-bounded big matmuls (counterpart of
``deepspeed_tpu/runtime/zero/tiling.py``; reference ``runtime/zero/
tiling.py`` ``TiledLinear``).

``x @ w`` walked tile by tile over an ``in_splits x out_splits`` grid, so
that at ZeRO-3 only one tile's weights are gathered at a time: with
``shard_dim`` set, ``w`` is this rank's shard of the weight along that dim
(``ShardedParams.raw(key)``) and each tile is all-gathered on its own
(its gradient reduce-scattered back, as ``partition.gather_param``).  A
tile along the sharded dim gathers every rank's matching sub-tile, so its
rows (or columns) are strided over the weight; the output columns are put
back in order (and the input columns picked to match).  With
``in_splits`` the partial products accumulate in fp32, as the JAX
package's ``preferred_element_type``.  The weight stays one logical
tensor: checkpoints and optimizer state are unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import comm
from ...parallel.mesh import ZERO_AXES
from .partition import gather_param


def tiled_linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 out_splits: int = 1, in_splits: int = 1,
                 shard_dim: Optional[int] = None, axes=ZERO_AXES,
                 grad_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x [..., d_in] @ w [d_in, d_out] (+ bias)``, ``w`` the full weight
    or (``shard_dim`` 0 or 1) this rank's ZeRO shard of it over ``axes``."""
    n = 1 if shard_dim is None else comm.get_axis_size(axes)
    rows, cols = w.shape
    d_in, d_out = rows * (n if shard_dim == 0 else 1), cols * (n if shard_dim == 1 else 1)
    if d_out % out_splits or d_in % in_splits or cols % out_splits or rows % in_splits:
        raise ValueError(
            f"weight [{d_in},{d_out}] (local [{rows},{cols}]) not divisible by "
            f"in_splits={in_splits}/out_splits={out_splits}")
    out_dtype = torch.promote_types(x.dtype, w.dtype)

    def full(t):
        return t if shard_dim is None else gather_param(t, shard_dim, axes, grad_dtype)

    if out_splits > 1:
        c = cols // out_splits
        parts = []
        for j in range(out_splits):
            wj = w[:, j * c:(j + 1) * c]
            if in_splits > 1:
                parts.append(tiled_linear(x, wj, None, 1, in_splits, shard_dim, axes,
                                          grad_dtype))
            else:
                parts.append(x.to(out_dtype) @ full(wj).to(out_dtype))
        if shard_dim == 1 and n > 1:
            # tile j holds columns r*cols + j*c + k of every rank r
            y = torch.stack(parts, dim=-2).unflatten(-1, (n, c))
            y = y.transpose(-3, -2).reshape(x.shape[:-1] + (d_out,))
        else:
            y = torch.cat(parts, dim=-1)
    elif in_splits > 1:
        r = rows // in_splits
        if shard_dim == 0 and n > 1:
            # tile i holds rows q*rows + i*r + k of every rank q
            xt = x.unflatten(-1, (n, in_splits, r))
            xs = [xt[..., :, i, :].flatten(-2) for i in range(in_splits)]
        else:
            xs = [x[..., i * r:(i + 1) * r] for i in range(in_splits)]
        y = x.new_zeros(x.shape[:-1] + (d_out,), dtype=torch.float32)
        for i, xi in enumerate(xs):
            # fp32 products and accumulator: per-split rounding at a narrow
            # dtype would lose what one dense matmul keeps
            y = y + xi.float() @ full(w[i * r:(i + 1) * r]).float()
        y = y.to(out_dtype)
    else:
        y = x.to(out_dtype) @ full(w).to(out_dtype)
    if bias is not None:
        y = y + bias
    return y


class TiledLinear:
    """Layer-object form (the JAX package's init/apply contract)."""

    def __init__(self, d_in: int, d_out: int, out_splits: int = 1,
                 in_splits: int = 1, use_bias: bool = True,
                 shard_dim: Optional[int] = None, dtype=torch.float32):
        self.d_in, self.d_out = d_in, d_out
        self.out_splits, self.in_splits = out_splits, in_splits
        self.use_bias = use_bias
        self.shard_dim = shard_dim
        self.dtype = dtype
        self.param_count = d_in * d_out + (d_out if use_bias else 0)

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        w = torch.randn((self.d_in, self.d_out), generator=generator, device=device,
                        dtype=self.dtype) * (self.d_in ** -0.5)
        p = {"w": w}
        if self.use_bias:
            p["b"] = torch.zeros((self.d_out,), dtype=self.dtype, device=device)
        return p

    def apply(self, p, x):
        return tiled_linear(x, p["w"], p.get("b"), out_splits=self.out_splits,
                            in_splits=self.in_splits, shard_dim=self.shard_dim)
