"""``OnDevice`` — build model parameters on a chosen device, or on no device
at all (counterpart of ``deepspeed_tpu/utils/init_on_device.py``; reference
``deepspeed/utils/init_on_device.py:81``).

``device="meta"`` builds the tree on ``torch.device("meta")``: shapes and
dtypes only, zero bytes anywhere (what ``jax.eval_shape`` is to the JAX
package); ``"cpu"`` or ``"cuda"`` materialises it there.  ``dtype`` casts the
floating leaves.  Model ``init_fn``s that honour it (``models.CausalLM``,
``runtime.pipe.PipelineModule``) consult :func:`current_on_device`::

    with deepspeed_tpu_torch.OnDevice(dtype=torch.bfloat16, device="meta"):
        shapes = model.init_fn(torch.Generator())    # meta tensors

    with deepspeed_tpu_torch.OnDevice(dtype=torch.bfloat16, device="cpu"):
        params = model.init_fn(torch.Generator())    # host RAM, not the card

A generator on another device than the target is replaced by one on the
target seeded with its initial seed (torch draws differ across devices).
``deepspeed_tpu_torch.initialize`` refuses to run inside an active context,
as the JAX package does: the engine places its own state.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Optional

import torch

_STATE = threading.local()

ENGINE_REFUSAL = (
    "OnDevice context is active while the engine initializes its "
    "parameters. Close the OnDevice context before "
    "deepspeed_tpu_torch.initialize(): the engine places its own state "
    "(OnDevice is for user-side inspection/staging flows).")


def current_on_device() -> Optional["OnDevice"]:
    """The innermost active OnDevice context (None outside any)."""
    return getattr(_STATE, "ctx", None)


class OnDevice(contextlib.AbstractContextManager):
    def __init__(self, dtype: Any = None, device: str = "meta",
                 enabled: bool = True):
        self.dtype = dtype
        self.device = device
        self.enabled = enabled
        self._prev = None

    def __enter__(self):
        self._prev = current_on_device()
        _STATE.ctx = self if self.enabled else self._prev
        return self

    def __exit__(self, *exc):
        _STATE.ctx = self._prev
        return False

    def apply_init(self, init_fn: Callable, generator: Optional[torch.Generator] = None,
                   **kwargs) -> Any:
        """``init_fn(generator, device=..., **kwargs)`` under this context's
        placement, its floating leaves cast to ``dtype``."""
        from .tree import tree_map

        device = torch.device(self.device)
        if generator is not None and device.type != "meta" \
                and generator.device.type != device.type:
            seed = generator.initial_seed()
            generator = torch.Generator(device=device)
            generator.manual_seed(seed)
        kwargs["device"] = device
        tree = init_fn(generator, **kwargs)
        if self.dtype is None:
            return tree
        return tree_map(lambda x: x.to(self.dtype) if x.is_floating_point() else x, tree)


def on_device_init(init_fn: Callable) -> Callable:
    """Wrap an ``init_fn(generator, device=None, ...)`` so it honours an
    active OnDevice context — how the model family opts in."""

    @functools.wraps(init_fn)
    def wrapped(generator=None, *args, **kwargs):
        ctx = current_on_device()
        if ctx is None:
            return init_fn(generator, *args, **kwargs)
        return ctx.apply_init(lambda g, **kw: init_fn(g, *args, **kw), generator, **kwargs)

    return wrapped
