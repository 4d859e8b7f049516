"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package runs the same system on
an NVIDIA H100 with PyTorch and hand-written Hopper kernels.  It imports
``torch``, ``numpy`` and the standard library only — never ``jax``,
``pydantic`` or ``deepspeed_tpu``.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Ported so far: the inference path, ``init_inference(model)`` ->
``InferenceEngine.forward`` / ``generate`` over the dense causal LM, and
the training path on one device, ``initialize(model=...)`` ->
``DeepSpeedEngine.train_batch``, with the flash-attention forward and
backward kernels.  ROADMAP.md lists what comes next.
"""
from __future__ import annotations

from typing import Any

from .accelerator import get_accelerator

__version__ = "0.1.0"


def initialize(args=None, model: Any = None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, init_fn=None, params=None,
               param_specs=None, mesh=None, device=None):
    """Build the training engine (reference deepspeed/__init__.py:64).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.  The
    model contract is functional: ``loss_fn(params, batch, generator)`` and
    ``init_fn(generator)``, or a model adapter exposing them
    (``models.CausalLM``); ``params=`` trains a given tree (a JAX tree
    converted with ``models.convert.params_from_jax``, say).  One device:
    ``device`` defaults to CUDA.  ``args``, ``model_parameters``,
    ``dist_init_required`` and ``collate_fn`` are accepted for signature
    parity and unused, as in the JAX package.
    """
    from .runtime.engine import DeepSpeedEngine

    if mpu is not None or param_specs is not None or mesh is not None:
        raise NotImplementedError(
            "mpu=/param_specs=/mesh= (model parallelism over several devices) "
            "is not ported yet (ROADMAP queue 1, item 4)")
    cfg = config if config is not None else config_params
    engine = DeepSpeedEngine(model=model, loss_fn=loss_fn, init_fn=init_fn,
                             params=params, config=cfg, optimizer=optimizer,
                             lr_scheduler=lr_scheduler,
                             training_data=training_data, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_schedule


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


__all__ = ["initialize", "init_inference", "get_accelerator", "__version__"]
