"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package runs the same system on
an NVIDIA H100 with PyTorch and hand-written Hopper kernels.  It imports
``torch``, ``numpy`` and the standard library only — never ``jax``,
``pydantic`` or ``deepspeed_tpu``.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Ported so far: the inference path, ``init_inference(model)`` ->
``InferenceEngine.forward`` / ``generate`` over the dense causal LM; the
training path on one device, ``initialize(model=...)`` ->
``DeepSpeedEngine.train_batch`` (or ``forward``/``backward``/``step``) ->
``save_checkpoint``/``load_checkpoint``, with the flash-attention forward
and backward kernels, also data-parallel over ``torch.distributed`` with
ZeRO stages 0-3 and MiCS (``comm``, ``parallel``, ``runtime/zero``,
``zero``) and tensor-parallel over the mesh's 'model' axis
(``parallel/tensor_parallel.py``, Megatron layout from ``param_specs``);
and the paged serving path, ``engine.serving()`` -> ``ServingEngine.run``,
with the paged decode-attention kernel, on one device or on a
tensor-parallel serving mesh (``parallel.mesh.initialize_serving_mesh`` ->
``init_inference(mesh=)``); Hugging Face checkpoints and modules
(``module_inject``: ``init_inference(<directory or module>)``) and
weight-only int8/int4 inference; MoE and pipelines, offload, ZeRO++ and
the 1-bit optimizers; the other optimizers, progressive layer drop,
random-LTD, the curricula, eigenvalue, LoRA training and the hybrid
engine (``runtime/hybrid_engine.py``); compression training
(``compression``), the flops profiler (``profiling``), the autotuner
(``autotuning``), the monitors (``monitor``) and ``OnDevice``.  ROADMAP.md
lists what comes next.
"""
from __future__ import annotations

from typing import Any

from .accelerator import get_accelerator
from .utils.init_on_device import OnDevice

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

    Data parallelism: with a process group (``comm.init_distributed()``,
    one process per device, e.g. under ``torchrun --nproc-per-node N``)
    the engine is one rank of a ZeRO stage 0-3 / MiCS job; ``mesh`` is a
    ``parallel.mesh.MeshLayout`` or a mesh from ``parallel.mesh.build_mesh``
    (default: the config's ``mesh`` block over the world).

    Tensor parallelism: the mesh's 'model' axis (``mesh=``, the config's
    ``mesh.tp``, or ``mpu.get_model_parallel_world_size()``) shards a
    ``models.CausalLM`` Megatron-style by its ``param_specs`` (passing
    ``param_specs`` names the model's own), composed with the ZeRO stage;
    naming a model axis of 1 runs the same path with copies for
    collectives; a dim the axis does not divide is padded with zeros.  The
    config's seed names the same weights at every model axis (each rank
    draws the default init leaf by leaf and keeps its shard).  Any other
    model runs under DTensor sharding propagation by its ``param_specs``
    (replicated over the model axis without them).

    Sequence parallelism: the mesh's 'seq' axis (``mesh=MeshLayout(sp=N)``
    or the config's ``mesh.sp``) cuts each row's tokens over N ranks; a
    ``models.CausalLM`` attends by ring attention over the axis
    (``attn_impl`` "auto"/"ring") or by Ulysses' all-to-alls
    (``attn_impl="ulysses"``).
    """
    from .parallel.mesh import MeshLayout
    from .runtime.engine import DeepSpeedEngine

    if mesh is not None and not (isinstance(mesh, MeshLayout)
                                 or hasattr(mesh, "mesh_dim_names")):
        raise TypeError(f"mesh={type(mesh).__name__}: pass a MeshLayout or a "
                        "mesh built by deepspeed_tpu_torch.parallel.mesh")
    cfg = config if config is not None else config_params
    engine = DeepSpeedEngine(model=model, loss_fn=loss_fn, init_fn=init_fn,
                             params=params, config=cfg, optimizer=optimizer,
                             lr_scheduler=lr_scheduler,
                             training_data=training_data, device=device,
                             mesh=mesh, param_specs=param_specs, mpu=mpu)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_schedule


def init_inference(model: Any = None, config=None, device=None, **kwargs):
    """Build the inference engine (reference deepspeed/__init__.py:269).

    ``model`` is a native model adapter (``models.CausalLM``), whose weights
    come from ``params=`` or from ``model.load_params``, or a Hugging Face
    source: a ``save_pretrained`` directory (streamed leaf by leaf; its
    ``config.json`` read as a dict, so neither ``transformers`` nor
    ``safetensors`` is needed) or a live ``transformers`` module, converted
    through the ``module_inject`` policies.  ``config`` is a dict or
    :class:`~.inference.config.DeepSpeedInferenceConfig`; extra keyword
    arguments are config keys.  ``device`` defaults to CUDA.  ``mesh=``
    (``parallel.mesh.initialize_serving_mesh``) or
    ``tensor_parallel.tp_size`` shards the model over the mesh's 'model'
    axis, one rank per device (auto-TP, see ``inference/engine.py``); a
    directory then loads each rank's shards only.  ``dtype="int8"`` or
    the ``quant`` block quantizes the weights (``inference/quantization.py``).
    """
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine, install_mesh

    engine_kwargs = {k: kwargs.pop(k) for k in ("apply_fn", "params", "mesh")
                     if k in kwargs}
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise ValueError("pass config keys either in config= or as keyword "
                             f"arguments, not both: {sorted(kwargs)}")
        cfg = config
    else:
        cfg = DeepSpeedInferenceConfig.from_dict({**dict(config or {}), **kwargs})
    if isinstance(model, str) or (model is not None
                                  and hasattr(model, "state_dict")
                                  and not hasattr(model, "apply_fn")):
        from .models import CausalLM

        # weight quantization loads in the compute dtype (the engine
        # quantizes blockwise on the device; a cast to int8 would truncate)
        dtype = cfg.compute_torch_dtype
        # the mesh first, so that a directory streams each rank's shards
        tp = cfg.tensor_parallel.tp_size if cfg.tensor_parallel.enabled else 1
        mesh = engine_kwargs.get("mesh")
        if mesh is not None or tp > 1:
            mesh = engine_kwargs["mesh"] = install_mesh(mesh, tp)
        model, params = CausalLM.from_hf(model, dtype=dtype, mesh=mesh,
                                         checkpoint=cfg.checkpoint, device=device)
        engine_kwargs.setdefault("params", params)
    return InferenceEngine(model, config=cfg, device=device, **engine_kwargs)


__all__ = ["initialize", "init_inference", "get_accelerator", "OnDevice", "__version__"]
