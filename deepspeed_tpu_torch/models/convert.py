"""Weights carried across packages: the JAX parameter tree (as numpy
arrays, stacked ``[L, ...]`` leaves under JAX's key names) to the port's
tree and back.  The layouts are the same (``x @ W``), so leaves map one to
one without transposes."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def params_from_jax(np_tree: Dict[str, Any], device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when given; integer leaves keep
    theirs.  Pass the result to ``CausalLM.load_params`` or to
    ``init_inference(params=...)``."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            raise NotImplementedError(
                "per-layer parameter lists (PR-MoE pyramid) are not ported yet "
                "(ROADMAP queue 1, item 9)")
        t = torch.from_numpy(np.array(x))   # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return conv(np_tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: nested dict of tensors -> nested dict of numpy arrays
    (bf16/fp16 leaves widen to float32, which numpy can hold exactly)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = x.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()

    return conv(tree)
