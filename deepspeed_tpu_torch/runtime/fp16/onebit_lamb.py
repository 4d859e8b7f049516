"""1-bit LAMB: compensated layerwise adaptivity under compression
(counterpart of ``deepspeed_tpu/runtime/fp16/onebit_lamb.py``; reference
``deepspeed/runtime/fp16/onebit/lamb.py``, arXiv 2104.06069).

LAMB's trust ratio ``||w|| / ||update||`` wants a fresh second moment, but
after ``freeze_step`` the variance freezes (compressed gradients are too
noisy to feed it).  The compensated algorithm:

  warmup (count <= freeze_step): plain LAMB; the per-leaf trust ratio
      ``clip(||w||/||u||, min_coeff..max_coeff)`` is EMA'd into
      ``lamb_coeff_freeze`` (``coeff_beta``); the shadow ``nu_fresh``
      follows ``nu``.
  compression (count > freeze_step): ``nu`` is frozen, ``nu_fresh`` keeps
      updating from the (compressed-averaged) gradient, and the applied
      ratio is ``lamb_coeff_freeze * factor`` with
      ``factor = max((sqrt(nu)+eps) / (sqrt(nu_fresh)+eps))``, blended by
      the weight-decay ratio, clipped to ``factor_min..factor_max`` and
      rate-limited to +-``factor_threshold`` a step.

The JAX package's transform, leaf for leaf: the gradient and the
weights taken in fp32, the norms in fp32, the moments at the params'
dtype.  A leaf's norms and its max are over the whole leaf: where the
engine updates ZeRO shards it supplies the reductions over the shards
(:func:`leaf_reductions`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ...utils.tree import tree_leaves, tree_map, tree_unflatten_like

# Per leaf, in tree order, (sum_fn, max_fn) from this rank's piece to the
# whole leaf, or None where the rank holds all of it: the engine sets it
# around an update of sharded leaves
_LEAF_REDUCE: contextvars.ContextVar = contextvars.ContextVar("leaf_reduce", default=None)


@contextlib.contextmanager
def leaf_reductions(fns: Sequence[Optional[Tuple[Callable, Callable]]]):
    token = _LEAF_REDUCE.set(list(fns))
    try:
        yield
    finally:
        _LEAF_REDUCE.reset(token)


def leaf_sum(i: int, x: torch.Tensor) -> torch.Tensor:
    """The sum of leaf ``i`` (of the tree being updated) from this rank's
    piece ``x``."""
    fns = _LEAF_REDUCE.get()
    return fns[i][0](x.sum()) if fns and fns[i] else x.sum()


def leaf_max(i: int, x: torch.Tensor) -> torch.Tensor:
    fns = _LEAF_REDUCE.get()
    return fns[i][1](x.max()) if fns and fns[i] else x.max()


@dataclasses.dataclass
class OnebitLambState:
    count: int            # the step counter
    mu: Any               # first moment, per leaf
    nu: Any               # second moment (frozen after freeze_step)
    nu_fresh: Any         # shadow second moment (keeps updating)
    lamb_coeff_freeze: Any   # per-leaf scalar: the EMA'd warmup trust ratio
    last_factor: Any         # per-leaf scalar: the rate limit's memory


def scale_by_onebit_lamb(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                         freeze_step: int = 100, weight_decay: float = 0.0,
                         max_coeff: float = 10.0, min_coeff: float = 0.01,
                         coeff_beta: float = 0.9, factor_max: float = 4.0,
                         factor_min: float = 0.5, factor_threshold: float = 0.1):
    """The whole 1-bit LAMB update (weight decay folded in, as the
    reference couples it into the trust ratio); chain with ``-lr`` only."""
    from ..optimizer import GradientTransformation

    def init(params):
        def scalar(p, fill):
            return torch.full((), fill, dtype=torch.float32, device=p.device)

        return OnebitLambState(
            count=0, mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
            nu_fresh=tree_map(torch.zeros_like, params),
            lamb_coeff_freeze=tree_map(lambda p: scalar(p, 0.0), params),
            last_factor=tree_map(lambda p: scalar(p, 1.0), params))

    def norm(i, x):   # in fp32, as the JAX transform's _norm
        return torch.sqrt(leaf_sum(i, torch.square(x.to(torch.float32))))

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_onebit_lamb needs params")
        count = state.count + 1
        warm = count <= freeze_step

        def leaf(i, g, p, mu, nu, nu_fresh, coeff_frz, last_factor):
            g32 = g.to(torch.float32)
            mu = b1 * mu + (1 - b1) * g32
            nu_live = b2 * nu + (1 - b2) * torch.square(g32)
            nu = nu_live if warm else nu
            nu_fresh = nu_live if warm else b2 * nu_fresh + (1 - b2) * torch.square(g32)
            denom = torch.sqrt(nu) + eps
            prelim = mu / denom
            p32 = p.to(torch.float32)
            upd = prelim + weight_decay * p32 if weight_decay else prelim
            w_norm, u_norm = norm(i, p32), norm(i, upd)
            one = torch.ones((), dtype=torch.float32, device=p.device)
            raw = torch.where((w_norm > 0) & (u_norm > 0),
                              w_norm / torch.clamp(u_norm, min=1e-30), one)
            coeff = torch.clamp(raw, min_coeff, max_coeff)
            coeff_frz_new = torch.where(coeff != 1.0,
                                        coeff_beta * coeff_frz + (1 - coeff_beta) * coeff,
                                        coeff_frz)
            factor = leaf_max(i, denom / (torch.sqrt(nu_fresh) + eps))
            if weight_decay:
                ratio = torch.clamp(norm(i, prelim) / torch.clamp(u_norm, min=1e-30), max=1.0)
                factor = factor * ratio + (1.0 - ratio)
            factor = torch.clamp(factor, factor_min, factor_max)
            factor = torch.minimum(torch.maximum(factor, last_factor * (1.0 - factor_threshold)),
                                   last_factor * (1.0 + factor_threshold))
            if warm:
                coeff_frz, last_factor, lamb_coeff = coeff_frz_new, one, coeff
            else:
                last_factor, lamb_coeff = factor.to(torch.float32), coeff_frz * factor
            return (lamb_coeff * upd).to(g.dtype), mu, nu, nu_fresh, coeff_frz, last_factor

        from ..optimizer import _map_n

        index = tree_unflatten_like(updates, range(len(tree_leaves(updates))))
        out, mu, nu, nu_fresh, cf, lf = _map_n(
            leaf, 6, index, updates, params, state.mu, state.nu, state.nu_fresh,
            state.lamb_coeff_freeze, state.last_factor)
        return out, OnebitLambState(count=count, mu=mu, nu=nu, nu_fresh=nu_fresh,
                                    lamb_coeff_freeze=cf, last_factor=lf)

    return GradientTransformation(init, update)
