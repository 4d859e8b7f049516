"""Optimizer construction (counterpart of ``deepspeed_tpu/runtime/optimizer.py``;
reference ``engine._configure_basic_optimizer``).

The JAX package builds an optax chain; the port keeps the same functional
shape — a :class:`GradientTransformation` of ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)`` over nested dicts of
tensors — and the same links in the same order:

    clip_by_global_norm -> Adam moments -> add_decayed_weights -> -lr(step)

with optax's arithmetic (fp32 moment math, its bias correction
``1 - b**count`` in fp32, moments stored at ``mu_dtype``/``nu_dtype``).
Only Adam/AdamW are ported; the other names raise naming their ROADMAP
item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..utils.tree import tree_leaves, tree_map

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

SUPPORTED = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER]
_UNPORTED = {
    ONEBIT_ADAM_OPTIMIZER: 10, ONEBIT_LAMB_OPTIMIZER: 10,
    ZERO_ONE_ADAM_OPTIMIZER: 10, LAMB_OPTIMIZER: 11, SGD_OPTIMIZER: 11,
    ADAGRAD_OPTIMIZER: 11, LION_OPTIMIZER: 11, RMSPROP_OPTIMIZER: 11,
}

_DTYPES = {None: None, "float32": torch.float32, "fp32": torch.float32,
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


def _dtype(name):
    if isinstance(name, torch.dtype) or name is None:
        return name
    if name not in _DTYPES:
        raise ValueError(f"unknown optimizer-state dtype {name!r}")
    return _DTYPES[name]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (optax.global_norm)."""
    total = None
    for x in tree_leaves(tree):
        s = x.float().square().sum()
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


def _bias_correction(decay: float, count: int) -> torch.Tensor:
    # 1 - decay**count in fp32, as optax evaluates it: XLA's power is the
    # correctly rounded fp32 one (torch's fp32 pow can be an ulp off, which
    # 1 - 0.999**3 magnifies to 2e-5)
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
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
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
            g32 = g.float()
            m32 = b1 * m.float() + (1.0 - b1) * g32
            n32 = b2 * n.float() + (1.0 - b2) * g32.square()
            out = (m32 / bc1) / (torch.sqrt(n32 / bc2) + eps)
            return out, m32.to(m.dtype), n32.to(n.dtype)

        out, mu, nu = _map3(upd, updates, state.mu, state.nu)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def _map3(fn, *trees):
    """tree_map for a ``fn`` returning three leaves: three trees back."""
    if isinstance(trees[0], dict):
        parts = {k: _map3(fn, *(t[k] for t in trees)) for k in sorted(trees[0])}
        return tuple({k: parts[k][i] for k in parts} for i in range(3))
    return fn(*trees)


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
    if name in _UNPORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP queue 1, item "
            f"{_UNPORTED[name]}); ported: {SUPPORTED}")
    if name not in SUPPORTED:
        raise ValueError(f"unsupported optimizer {name!r}; supported: "
                         f"{SUPPORTED + sorted(_UNPORTED)}")
    betas = params.get("betas", (0.9, 0.999))
    b1, b2 = betas[0], betas[1]
    eps = params.get("eps", 1e-8)
    weight_decay = params.get("weight_decay", 0.0)
    mu_dtype, nu_dtype = params.get("mu_dtype"), params.get("nu_dtype")
    core = (scale_by_adam_ds(b1, b2, eps, mu_dtype=mu_dtype, nu_dtype=nu_dtype)
            if nu_dtype is not None else scale_by_adam(b1, b2, eps, mu_dtype=mu_dtype))
    links = [core]
    if weight_decay:
        if params.get("adam_w_mode", name == ADAMW_OPTIMIZER):
            links.append(add_decayed_weights(weight_decay))
        else:   # L2-regularization mode: decay added to the raw grad
            links.insert(0, add_decayed_weights(weight_decay))
    return chain(*links)


def create_optimizer(opt_type: str, opt_params: Optional[Dict[str, Any]] = None,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     gradient_clipping: float = 0.0) -> GradientTransformation:
    """The full update chain: clip -> optimizer math -> -lr(step) * update."""
    opt_params = dict(opt_params or {})
    links = []
    if gradient_clipping and gradient_clipping > 0:
        links.append(clip_by_global_norm(gradient_clipping))
    links.append(_base_transform(opt_type, opt_params))
    links.append(scale_by_learning_rate(
        lr_schedule if lr_schedule is not None else opt_params.get("lr", 1e-3)))
    return chain(*links)
