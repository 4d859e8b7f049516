"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package runs the same system on
an NVIDIA H100 with PyTorch and hand-written Hopper kernels.  It imports
``torch``, ``numpy`` and the standard library only — never ``jax``,
``pydantic`` or ``deepspeed_tpu``.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Ported so far: the inference path, ``init_inference(model)`` ->
``InferenceEngine.forward`` / ``generate`` over the dense causal LM, with
the flash-attention forward kernel.  ROADMAP.md lists what comes next.
"""
from __future__ import annotations

from typing import Any

from .accelerator import get_accelerator

__version__ = "0.1.0"


def init_inference(model: Any = None, config=None, device=None, **kwargs):
    """Build the inference engine (reference deepspeed/__init__.py:269).

    ``model`` is a native model adapter (``models.CausalLM``); its weights
    come from ``params=`` or from ``model.load_params``.  ``config`` is a
    dict or :class:`~.inference.config.DeepSpeedInferenceConfig`; extra
    keyword arguments are config keys.  ``device`` defaults to CUDA.
    """
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine

    if "mesh" in kwargs:
        raise NotImplementedError(
            "mesh= (multi-device inference) is not ported yet (ROADMAP queue 1, "
            "item 4)")
    engine_kwargs = {k: kwargs.pop(k) for k in ("apply_fn", "params")
                     if k in kwargs}
    if isinstance(model, str) or (model is not None
                                  and hasattr(model, "state_dict")
                                  and not hasattr(model, "apply_fn")):
        raise NotImplementedError(
            "Hugging Face checkpoints and modules load through module_inject, "
            "which is not ported yet (ROADMAP queue 1, item 6)")
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise ValueError("pass config keys either in config= or as keyword "
                             f"arguments, not both: {sorted(kwargs)}")
        cfg = config
    else:
        cfg = DeepSpeedInferenceConfig.from_dict({**dict(config or {}), **kwargs})
    return InferenceEngine(model, config=cfg, device=device, **engine_kwargs)


__all__ = ["init_inference", "get_accelerator", "__version__"]
