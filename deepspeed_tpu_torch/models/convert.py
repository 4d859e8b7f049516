"""Weights carried across packages: the JAX parameter tree (as numpy
arrays, stacked ``[L, ...]`` leaves under JAX's key names) to the port's
tree and back, and a JAX paged KV pool to the port's.  The layouts are the
same (``x @ W``; pools ``[L, P, page, Hkv, hd]``; MoE experts ``[L, E, d,
f]``; a PR-MoE pyramid's list of per-layer dicts), so leaves map one to
one without transposes; only a pipelined tree's layer stacks are
reshaped (JAX ``[P, L/P, ...]``, the port ``[L, ...]``).  A LoRA adapter
tree ``{target: {"A", "B"}}`` crosses with :func:`lora_from_jax` /
``params_to_numpy``, an optimizer state (optax's tuples of named states,
the port's tuples of dataclasses) leaves to numpy with
:func:`opt_state_to_numpy`."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def params_from_jax(np_tree: Dict[str, Any], device="cuda",
                    dtype: Optional[torch.dtype] = None,
                    pipeline_stages: int = 1) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when given; integer leaves keep
    theirs.  A PR-MoE pyramid's ``layers`` list of per-layer dicts stays a
    list.  ``pipeline_stages > 1``: the JAX tree's ``[P, L/P, ...]`` layer
    stacks become the port's ``[L, ...]``.  Pass the result to
    ``CausalLM.load_params`` or to ``init_inference(params=...)``."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        t = torch.from_numpy(np.array(x))   # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    out = conv(np_tree)
    if pipeline_stages > 1:
        out["layers"] = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                         for k, v in out["layers"].items()}
    return out


LAYER_KEYS = ("attn_norm_scale", "attn_norm_bias", "mlp_norm_scale",
              "mlp_norm_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
              "w_in", "b_in", "w_down", "b_down")


def layer_params_from_jax(np_params: Dict[str, Any], device="cuda",
                          dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """One ``DeepSpeedTransformerLayer``'s parameters: the JAX layer's flat
    dict (``init``, as numpy; no ``[L]`` dim) -> the port's flat dict of
    tensors on ``device``, for ``ops.transformer.DeepSpeedTransformerLayer.
    apply``.  A missing key raises."""
    missing = [key for key in LAYER_KEYS if key not in np_params]
    if missing:
        raise KeyError(f"not a transformer layer's parameters: missing {missing}")
    return params_from_jax(dict(np_params), device=device, dtype=dtype)


def pool_from_jax(np_cache: Dict[str, Any], device="cuda",
                  dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX paged cache (``init_paged_cache``/``forward_paged``: ``k``/``v``
    ``[L, P, page, Hkv, hd]`` as numpy, plus an int8 pool's ``k_scale``/
    ``v_scale`` ``[L, P, page]``) -> the port's cache dict on ``device``;
    ``params_to_numpy`` takes it back.  ``dtype`` casts floating k/v only
    (int8 codes and fp32 scales keep theirs)."""
    out = {}
    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in np_cache:
            continue
        t = torch.from_numpy(np.array(np_cache[key]))
        cast = dtype if key in ("k", "v") and t.is_floating_point() else None
        out[key] = t.to(device=device, dtype=cast or t.dtype)
    return out


def params_to_numpy(tree: Dict[str, Any], pipeline_stages: int = 1) -> Dict[str, Any]:
    """The inverse: nested dict of tensors -> nested dict of numpy arrays
    (bf16/fp16 leaves widen to float32, which numpy can hold exactly; a
    pyramid's list of layers stays a list; ``pipeline_stages > 1`` gives
    the JAX pipeline tree's ``[P, L/P, ...]`` layer stacks)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        t = x.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()

    out = conv(tree)
    if pipeline_stages > 1:
        out["layers"] = {k: v.reshape((pipeline_stages, -1) + v.shape[1:])
                         for k, v in out["layers"].items()}
    return out


def lora_from_jax(np_lora: Dict[str, Any], device="cuda",
                  dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX adapter tree (``init_lora_params``: ``{target: {"A": [L, d_in,
    r], "B": [L, r, d_out]}}`` as numpy) -> the port's, checked leaf by
    leaf (``params_to_numpy`` takes it back)."""
    for target, ab in np_lora.items():
        if set(ab) != {"A", "B"}:
            raise KeyError(f"LoRA target {target!r}: keys {sorted(ab)}, not A and B")
        a, b = np.shape(ab["A"]), np.shape(ab["B"])
        if len(a) != 3 or len(b) != 3 or a[0] != b[0] or a[2] != b[1]:
            raise ValueError(f"LoRA target {target!r}: A {a} and B {b} are not "
                             "[L, d_in, r] and [L, r, d_out]")
    return params_from_jax(np_lora, device=device, dtype=dtype)


def opt_state_to_numpy(state) -> list:
    """The array leaves of an optimizer state in order (every tensor or
    array with a dimension; step counts and empty states left out), as
    numpy: the port's state and optax's compare leaf for leaf when their
    chains have the same links."""
    import dataclasses

    out: list = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            if obj.dim():
                out.append(obj.detach().cpu().float().numpy()
                           if obj.dtype in (torch.bfloat16, torch.float16)
                           else obj.detach().cpu().numpy())
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))
        elif isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k])
        elif isinstance(obj, (list, tuple)):   # optax's states are NamedTuples
            for o in obj:
                walk(o)
        elif hasattr(obj, "shape") and np.ndim(obj):
            out.append(np.asarray(obj))

    walk(state)
    return out
