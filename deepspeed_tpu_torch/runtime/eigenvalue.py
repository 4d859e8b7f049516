"""Hessian eigenvalue estimation (counterpart of
``deepspeed_tpu/runtime/eigenvalue.py``; reference ``runtime/eigenvalue.py:12``).

Power iteration on the Hessian of the loss at the current weights, the
Hessian-vector product by double backward: the gradient is taken once
with ``create_graph=True`` and each iteration differentiates ``g . v``
(the JAX package's forward-over-reverse ``jvp`` of ``grad``, the same
product).  The per-leaf Rayleigh quotients ``v_l^T (Hv)_l`` are the
layer-wise values the reference feeds MoQ.  The reductions run in fp32
and each ``v`` leaf keeps its parameter's dtype, as the JAX package's.

The flash-attention kernels have no second derivative (their backward is
a kernel, not a graph): their autograd Functions' backward refuses to
build a graph (``ops/kernels/common.py`` ``first_derivative_only``), so
the gradient taken for the product raises instead of returning one that
silently leaves the attention out.  The JAX package fails at the same
place (``jvp`` of its Pallas kernel), i.e. at S >= 2048 under
``attn_impl="auto"``; the plain branch serves shorter sequences.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..utils.logging import log_dist
from ..utils.tree import tree_flatten_with_path, tree_leaves, tree_unflatten_like


def _dot(a, b) -> torch.Tensor:
    total = None
    for x, y in zip(a, b):
        s = torch.sum(x.to(torch.float32) * y.to(torch.float32))
        total = s if total is None else total + s
    return total


def _scaled(leaves, n: torch.Tensor) -> list:
    """Each leaf / n in fp32, back at its own dtype."""
    return [(x.to(torch.float32) / n).to(x.dtype) for x in leaves]


class _HessianVector:
    """``v -> Hv`` at ``params``: one forward and backward with the graph
    kept, then one more backward a product."""

    def __init__(self, loss_fn: Callable, params: Any, batch: Any, generator):
        self.leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        tree = tree_unflatten_like(params, self.leaves)
        with torch.enable_grad():
            out = loss_fn(tree, batch, generator)
            loss = out[0] if isinstance(out, tuple) else out
            self.grads = torch.autograd.grad(loss, self.leaves, create_graph=True,
                                             allow_unused=True)

    def __call__(self, v: list) -> list:
        live = [(g, x) for g, x in zip(self.grads, v) if g is not None and g.requires_grad]
        hv = torch.autograd.grad([g for g, _ in live], self.leaves,
                                 grad_outputs=[x for _, x in live],
                                 retain_graph=True, allow_unused=True)
        return [torch.zeros_like(p) if h is None else h.detach()
                for h, p in zip(hv, self.leaves)]


def hvp(loss_fn: Callable, params: Any, batch: Any, generator, v: Any) -> Any:
    """The Hessian-vector product at ``params`` along ``v`` (a tree like
    ``params``); ``loss_fn`` returns the loss or ``(loss, aux)``."""
    hv = _HessianVector(loss_fn, params, batch, generator)(tree_leaves(v))
    return tree_unflatten_like(params, hv)


class Eigenvalue:
    """Power-iteration largest-eigenvalue estimator (the ``eigenvalue``
    block's ``max_iter``/``tol``/``stability``/``verbose``)."""

    def __init__(self, verbose: bool = False, max_iter: int = 100,
                 tol: float = 1e-2, stability: float = 1e-6):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.vector = None   # the last call's eigenvector estimate (leaves)

    def compute_eigenvalue(self, loss_fn: Callable, params: Any, batch: Any,
                           generator: Optional[torch.Generator] = None,
                           v0: Any = None) -> Tuple[float, Dict[str, float]]:
        """(lambda_max, per-leaf Rayleigh quotients by '/'-joined path).
        ``v0``: the starting vector (a tree like ``params``; default a
        normal draw from a CPU generator seeded 0, leaf by leaf)."""
        leaves = tree_leaves(params)
        if v0 is None:
            gen = torch.Generator()
            gen.manual_seed(0)
            v0 = [torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
                  for x in leaves]
        else:
            v0 = [torch.as_tensor(x).to(p.device, p.dtype)
                  for x, p in zip(tree_leaves(v0), leaves)]
        v = _scaled(v0, torch.sqrt(_dot(v0, v0)) + 1e-12)
        hvp_fn = _HessianVector(loss_fn, params, batch, generator)
        eig_prev = eig = torch.zeros((), dtype=torch.float32)
        for i in range(self.max_iter):
            hv = hvp_fn(v)
            eig = _dot(v, hv)
            norm = torch.sqrt(_dot(hv, hv))
            if float(norm) < self.stability:
                break
            v = _scaled(hv, norm + 1e-12)
            if i > 0 and abs(float(eig - eig_prev)) <= \
                    self.tol * max(abs(float(eig)), 1e-12):
                break
            eig_prev = eig
        if self.verbose:
            log_dist(f"eigenvalue: lambda_max≈{float(eig):.4e} after {i + 1} iters",
                     ranks=[0])
        hv = hvp_fn(v)
        self.vector = v
        paths = [p for p, _ in tree_flatten_with_path(params)]
        per_leaf = {path: float(_dot([a], [b])) for path, a, b in zip(paths, v, hv)}
        return float(eig), per_leaf
