"""Optimizer construction (counterpart of ``deepspeed_tpu/runtime/optimizer.py``;
reference ``engine._configure_basic_optimizer``).

The JAX package builds an optax chain; the port keeps the same functional
shape — a :class:`GradientTransformation` of ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)`` over nested dicts of
tensors — and the same links in the same order:

    clip_by_global_norm -> the optimizer's links -> -lr(step)

with optax's arithmetic (fp32 moment math, its bias correction
``1 - b**count`` in fp32, moments stored at ``mu_dtype``/``nu_dtype``).
Each name has the JAX package's chain (``_base_transform``): Adam/AdamW
(moments, then decoupled or L2 decay); LAMB (Adam's moments, decay, then
optax's ``scale_by_trust_ratio``); SGD (decay, then ``trace``: momentum,
optionally Nesterov); Adagrad (``scale_by_rss``); Lion (``scale_by_lion``,
then decay); RMSprop (``scale_by_rms``); the 1-bit family (OneBitAdam and
ZeroOneAdam: Adam's math, the engine owning their compressed exchange;
OneBitLamb: ``fp16/onebit_lamb.py``).  LAMB's trust ratio is a ratio of
whole-leaf norms: where the engine updates shards of a leaf it supplies
the sums over the shards, leaf by leaf (``fp16/onebit_lamb.py``
``leaf_reductions``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..utils.tree import tree_leaves, tree_map, tree_unflatten_like

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
LION_OPTIMIZER = "lion"
RMSPROP_OPTIMIZER = "rmsprop"

SUPPORTED = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
             ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER, SGD_OPTIMIZER,
             ADAGRAD_OPTIMIZER, LION_OPTIMIZER, RMSPROP_OPTIMIZER]
ONEBIT_OPTIMIZERS = (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                     ZERO_ONE_ADAM_OPTIMIZER)

_DTYPES = {None: None, "float64": torch.float64, "fp64": torch.float64,
           "float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16}


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


@dataclasses.dataclass
class ScaleByAdamState:
    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass
class ScaleByScheduleState:
    count: int


@dataclasses.dataclass
class TraceState:
    trace: Any


@dataclasses.dataclass
class ScaleByRssState:
    sum_of_squares: Any


@dataclasses.dataclass
class ScaleByLionState:
    count: int
    mu: Any


@dataclasses.dataclass
class ScaleByRmsState:
    nu: Any


def _dtype(name):
    if isinstance(name, torch.dtype) or name is None:
        return name
    if name not in _DTYPES:
        raise ValueError(f"unknown optimizer-state dtype {name!r}")
    return _DTYPES[name]


def _at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


# The norm of a tree whose leaves are ZeRO shards: set by the engine around
# the optimizer's update, so clipping (this chain's or a client chain's)
# clips by the norm of the whole gradient, not of this rank's shards.
_TREE_NORM: contextvars.ContextVar = contextvars.ContextVar("tree_norm", default=None)


@contextlib.contextmanager
def sharded_norm(norm_fn: Callable[[Any], torch.Tensor]):
    """Within the block, :func:`global_norm` is ``norm_fn`` (the sharding-
    aware norm of ``runtime/zero/partition.py``)."""
    token = _TREE_NORM.set(norm_fn)
    try:
        yield
    finally:
        _TREE_NORM.reset(token)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (fp64 for fp64
    leaves, as optax.global_norm under x64); under :func:`sharded_norm`,
    the norm of the global tree the local shards belong to."""
    norm_fn = _TREE_NORM.get()
    if norm_fn is not None:
        return norm_fn(tree)
    total = None
    for x in tree_leaves(tree):
        s = _at_least_fp32(x).square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(params, updates):
    """params + updates, kept at each param's dtype (optax.apply_updates)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def chain(*links: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in links)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(links, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by max_norm / norm when the global norm reaches
    max_norm (optax.clip_by_global_norm; a device-side select, no sync)."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return tree_map(lambda t: torch.where(
            trigger, t, (t / g_norm.to(t.dtype)) * max_norm), updates), state

    return GradientTransformation(lambda params: (), update)


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` first, as jnp treats a Python scalar (a
    weak type) against a bf16 array: torch would multiply in fp32."""
    return float(torch.tensor(x, dtype=dtype)) if dtype.itemsize < 4 else x


def _bias_correction(decay: float, count: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    # 1 - decay**count in fp32 (fp64 for fp64 moments, as optax evaluates
    # it under x64): XLA's power is the correctly rounded one (torch's fp32
    # pow can be an ulp off, which 1 - 0.999**3 magnifies to 2e-5)
    if dtype == torch.float64:
        return 1.0 - torch.tensor(decay ** count, dtype=torch.float64)
    power = float(torch.tensor(decay, dtype=torch.float32)) ** count
    return 1.0 - torch.tensor(power, dtype=torch.float32)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  mu_dtype=None) -> GradientTransformation:
    """optax.scale_by_adam: mu stored at ``mu_dtype`` (default the param
    dtype), nu at the param dtype."""
    mu_dtype = _dtype(mu_dtype)

    def init(params):
        return ScaleByAdamState(
            count=0,
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params),
            nu=tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda g, t: _weak(1 - b1, g.dtype) * g + _weak(b1, t.dtype) * t,
                      updates, state.mu)
        nu = tree_map(lambda g, t: (_weak(1 - b2, g.dtype) * g.square()
                                    + _weak(b2, t.dtype) * t), updates, state.nu)
        wide = any(m.dtype == torch.float64 for m in tree_leaves(mu))
        dt = torch.float64 if wide else torch.float32
        bc1, bc2 = _bias_correction(b1, count, dt), _bias_correction(b2, count, dt)
        out = tree_map(lambda m, v: (m / bc1.to(m.dtype))
                       / (torch.sqrt(v / bc2.to(v.dtype)) + eps), mu, nu)
        if mu_dtype is not None:
            mu = tree_map(lambda m: m.to(mu_dtype), mu)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale_by_adam_ds(b1: float, b2: float, eps: float, mu_dtype=None,
                     nu_dtype=None) -> GradientTransformation:
    """``_scale_by_adam_ds``: Adam with independently stored m/nu dtypes;
    the moment math runs in fp32, the dtypes are only the at-rest format.
    (With ``nu_dtype=bfloat16`` and b2=0.999 late-training nu can stall at
    bf16's resolution: a memory-pressure option, as in the JAX package.)"""
    mu_dtype, nu_dtype = _dtype(mu_dtype), _dtype(nu_dtype)

    def init(params):
        return ScaleByAdamState(
            count=0,
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=nu_dtype or p.dtype), params))

    def update(updates, state, params=None):
        count = state.count + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)

        def upd(g, m, n):
            # b1*m + (1-b1)*g and (1-b2)*g^2 + b2*n, then m/bc1 / (sqrt(n/bc2)
            # + eps), each sum and quotient taken in place on a temporary
            # made here: the same roundings in the same order, one fewer
            # leaf-sized temporary live at the update's peak
            g32 = g.float()
            m32 = m.float() * b1
            m32.add_(g32 * (1.0 - b1))
            n32 = g32.square().mul_(1.0 - b2)
            n32.add_(n.float() * b2)
            den = (n32 / bc2).sqrt_().add_(eps)
            out = (m32 / bc1).div_(den)
            del den
            return out, m32.to(m.dtype), n32.to(n.dtype)

        out, mu, nu = _map3(upd, updates, state.mu, state.nu)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def _map_n(fn, n: int, *trees):
    """tree_map for a ``fn`` returning ``n`` leaves: ``n`` trees back."""
    if isinstance(trees[0], dict):
        parts = {k: _map_n(fn, n, *(t[k] for t in trees)) for k in sorted(trees[0])}
        return tuple({k: parts[k][i] for k in parts} for i in range(n))
    if isinstance(trees[0], (list, tuple)):   # a PR-MoE pyramid's layer list
        parts = [_map_n(fn, n, *(t[j] for t in trees)) for j in range(len(trees[0]))]
        return tuple(type(trees[0])(p[i] for p in parts) for i in range(n))
    return fn(*trees)


def _map3(fn, *trees):
    """tree_map for a ``fn`` returning three leaves: three trees back."""
    return _map_n(fn, 3, *trees)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return tree_map(lambda g, p: g + weight_decay * p, updates, params), state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(learning_rate: Union[float, Callable[[int], float]]
                           ) -> GradientTransformation:
    """updates * -lr(count), the count being this link's own (optax's
    scale_by_schedule: the schedule sees 0 on the first update)."""
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def update(updates, state, params=None):
        step = -float(schedule(state.count))
        return (tree_map(lambda g: torch.tensor(step, dtype=g.dtype) * g, updates),
                ScaleByScheduleState(count=state.count + 1))

    return GradientTransformation(lambda params: ScaleByScheduleState(count=0), update)


def _base_transform(name: str, params: Dict[str, Any]) -> GradientTransformation:
    name = name.lower().replace("_", "")
    if name not in SUPPORTED:
        raise ValueError(f"unsupported optimizer {name!r}; supported: {SUPPORTED}")
    betas = params.get("betas", (0.9, 0.999))
    b1, b2 = betas[0], betas[1]
    eps = params.get("eps", 1e-8)
    weight_decay = params.get("weight_decay", 0.0)
    if name in (ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER):
        # Adam on the compressed-averaged gradient; the exchange itself is
        # the engine's (runtime/comm/compressed.py, zero_one.py)
        return _base_transform(ADAM_OPTIMIZER, {
            k: v for k, v in params.items()
            if k not in ("freeze_step", "cuda_aware", "comm_backend_name")})
    if name == ONEBIT_LAMB_OPTIMIZER:
        from .fp16.onebit_lamb import scale_by_onebit_lamb

        return scale_by_onebit_lamb(
            b1=b1, b2=b2, eps=eps, freeze_step=int(params.get("freeze_step", 100)),
            weight_decay=weight_decay,
            max_coeff=float(params.get("max_coeff", 10.0)),
            min_coeff=float(params.get("min_coeff", 0.01)),
            coeff_beta=float(params.get("coeff_beta", 0.9)),
            factor_max=float(params.get("factor_max", 4.0)),
            factor_min=float(params.get("factor_min", 0.5)),
            factor_threshold=float(params.get("factor_threshold", 0.1)))
    mu_dtype, nu_dtype = params.get("mu_dtype"), params.get("nu_dtype")
    core = (scale_by_adam_ds(b1, b2, eps, mu_dtype=mu_dtype, nu_dtype=nu_dtype)
            if nu_dtype is not None else scale_by_adam(b1, b2, eps, mu_dtype=mu_dtype))
    decay = add_decayed_weights(weight_decay) if weight_decay else identity()
    if name == LAMB_OPTIMIZER:
        return chain(core, decay, scale_by_trust_ratio())
    if name == SGD_OPTIMIZER:
        momentum = params.get("momentum", 0.0)
        links = [add_decayed_weights(weight_decay)] if weight_decay else []
        if momentum:
            links.append(trace(momentum, nesterov=params.get("nesterov", False)))
        return chain(*links) if links else identity()
    if name == ADAGRAD_OPTIMIZER:
        return scale_by_rss(params.get("initial_accumulator_value", 0.1), eps=eps)
    if name == LION_OPTIMIZER:
        lion_betas = params.get("betas", (0.9, 0.99))
        return chain(scale_by_lion(lion_betas[0], lion_betas[1]), decay)
    if name == RMSPROP_OPTIMIZER:
        return scale_by_rms(decay=params.get("alpha", 0.99), eps=eps)
    links = [core]
    if weight_decay:
        if params.get("adam_w_mode", name == ADAMW_OPTIMIZER):
            links.append(add_decayed_weights(weight_decay))
        else:   # L2-regularization mode: decay added to the raw grad
            links.insert(0, add_decayed_weights(weight_decay))
    return chain(*links)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: (), lambda u, s, p=None: (u, s))


def scale_by_trust_ratio(min_norm: float = 0.0, trust_coefficient: float = 1.0,
                         eps: float = 0.0) -> GradientTransformation:
    """optax.scale_by_trust_ratio: each leaf's update times ``||p|| /
    (||u|| + eps)`` (1 where either norm is 0), the norms over the whole
    leaf in its own dtype."""
    from .fp16.onebit_lamb import leaf_sum

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_trust_ratio needs the params")
        out = []
        for i, (u, p) in enumerate(zip(tree_leaves(updates), tree_leaves(params))):
            def norm(x):
                n = torch.sqrt(leaf_sum(i, x * x))
                return torch.clamp(n, min=min_norm) if min_norm else n

            p_norm, u_norm = norm(p), norm(u)
            ratio = trust_coefficient * p_norm / (u_norm + eps)
            safe = torch.where((p_norm == 0.0) | (u_norm == 0.0),
                               torch.ones((), dtype=p.dtype, device=p.device), ratio)
            out.append(u * safe)
        return tree_unflatten_like(updates, out), state

    return GradientTransformation(lambda params: (), update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax.trace: ``t = g + decay * t``; the update is ``t`` (``g + decay
    * t`` with Nesterov)."""
    def init(params):
        return TraceState(trace=tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        new = tree_map(lambda g, t: g + decay * t, updates, state.trace)
        out = tree_map(lambda g, t: g + decay * t, updates, new) if nesterov else new
        return out, TraceState(trace=new)

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """optax.scale_by_rss (Adagrad): ``s += g**2``; ``g * rsqrt(s + eps)``
    where ``s > 0``, else 0."""
    def init(params):
        return ScaleByRssState(sum_of_squares=tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params))

    def update(updates, state, params=None):
        sos = tree_map(lambda g, t: g * g + t, updates, state.sum_of_squares)
        out = tree_map(lambda g, t: torch.where(t > 0, torch.rsqrt(t + eps),
                                                torch.zeros_like(t)) * g, updates, sos)
        return out, ScaleByRssState(sum_of_squares=sos)

    return GradientTransformation(init, update)


def scale_by_lion(b1: float = 0.9, b2: float = 0.99) -> GradientTransformation:
    """optax.scale_by_lion: ``sign((1 - b1) g + b1 m)``, then ``m = (1 - b2)
    g + b2 m``."""
    def init(params):
        return ScaleByLionState(count=0, mu=tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        out = tree_map(lambda g, m: torch.sign((1.0 - b1) * g + b1 * m),
                       updates, state.mu)
        mu = tree_map(lambda g, m: (1.0 - b2) * g + b2 * m, updates, state.mu)
        return out, ScaleByLionState(count=state.count + 1, mu=mu)

    return GradientTransformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> GradientTransformation:
    """optax.scale_by_rms (RMSprop, eps inside the root, no bias
    correction): ``nu = (1 - decay) g**2 + decay nu``; ``g * rsqrt(nu +
    eps)``."""
    def init(params):
        return ScaleByRmsState(nu=tree_map(lambda p: torch.full_like(p, initial_scale),
                                           params))

    def update(updates, state, params=None):
        nu = tree_map(lambda g, n: (1.0 - decay) * (g * g) + decay * n,
                      updates, state.nu)
        out = tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, updates)
        return out, ScaleByRmsState(nu=nu)

    return GradientTransformation(init, update)


def zero_frozen_updates(frozen_mask) -> GradientTransformation:
    """Final-link masking for frozen parameters (the reference's
    ``requires_grad=False`` contract: a frozen parameter receives NO update,
    not even the weight decay an earlier link adds).  ``frozen_mask`` is a
    tree of Python bools shaped like the parameters (True = frozen);
    frozen leaves get a zero update, the others pass through untouched
    (optax.masked(set_to_zero(), mask))."""
    def update(updates, state, params=None):
        return tree_map(lambda u, m: torch.zeros_like(u) if m else u,
                        updates, frozen_mask), state

    return GradientTransformation(lambda params: (), update)


def create_optimizer(opt_type: str, opt_params: Optional[Dict[str, Any]] = None,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     gradient_clipping: float = 0.0,
                     frozen_mask: Any = None) -> GradientTransformation:
    """The full update chain: clip -> optimizer math -> -lr(step) * update
    (-> zero for the leaves ``frozen_mask`` marks; the engine also zeroes
    their incoming gradients, so clipping and the norm leave them out, as
    the reference's frozen parameters produce no ``.grad`` at all)."""
    opt_params = dict(opt_params or {})
    links = []
    if gradient_clipping and gradient_clipping > 0:
        links.append(clip_by_global_norm(gradient_clipping))
    links.append(_base_transform(opt_type, opt_params))
    links.append(scale_by_learning_rate(
        lr_schedule if lr_schedule is not None else opt_params.get("lr", 1e-3)))
    if frozen_mask is not None:
        links.append(zero_frozen_updates(frozen_mask))
    return chain(*links)
