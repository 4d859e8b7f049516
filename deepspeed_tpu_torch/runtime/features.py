"""Engine feature wiring (counterpart of ``deepspeed_tpu/runtime/features.py``):
compression training, progressive layer drop, curriculum learning,
random-LTD and the flops profiler.

Each ``wire_*`` function owns one optional capability's config resolution
and validation.  The engine attribute names are the JAX engine's
(``engine.progressive_layer_drop``, ``engine.curriculum_scheduler``,
``engine.flops_profiler``, ``engine._compression_transform``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.logging import log_dist


def wire_compression(engine, model) -> None:
    """QAT / pruning parameter transform and activation fake-quant
    (reference ``deepspeed/compression/compress.py init_compression``).

    Sets ``engine._compression_transform`` and, when activation
    quantization is configured, writes its knobs into the model config
    (the transformer fake-quantizes its post-norm attention and MLP
    inputs): activation quantization is a forward concern, not a
    parameter transform.  The JAX engine's rules and messages."""
    from ..compression import build_param_transform, parse_compression_config

    model_heads = getattr(getattr(model, "config", None), "num_heads", None)
    engine._compression_transform = build_param_transform(
        engine.config._param_dict, num_heads=model_heads)
    aq = [t for t in parse_compression_config(engine.config._param_dict)
          if t.kind == "activation_quantization"]
    if not aq:
        return
    mcfg = getattr(model, "config", None)
    if mcfg is None or not hasattr(mcfg, "act_quant_bits"):
        raise NotImplementedError(
            "activation_quantization needs a model whose config "
            "supports act_quant_bits (deepspeed_tpu.models.CausalLM)")
    t = aq[0]
    # the wiring is model-wide (one bits value at every block's
    # attention/MLP inputs): config shapes it cannot honour are refused
    all_bits = {int(g.params.get("bits", 8)) for g in t.groups} or {8}
    if len(all_bits) > 1 or any(
            set(g.modules) not in ({"*"}, set()) for g in t.groups):
        raise NotImplementedError(
            "activation_quantization is applied model-wide: use ONE "
            "group with modules=['*'] and a single bits value")
    if int(t.shared.get("schedule_offset", 0)) != 0:
        raise NotImplementedError(
            "activation_quantization.schedule_offset is not "
            "supported (fake-quant engages from step 0)")
    if t.shared.get("range_calibration", "dynamic") != "dynamic":
        raise NotImplementedError(
            "activation_quantization static range calibration is not "
            "wired from the config (dynamic per-tensor only)")
    bits = all_bits.pop()
    sym = t.shared.get("quantization_type", "asymmetric") == "symmetric"
    model.config = dataclasses.replace(mcfg, act_quant_bits=bits, act_quant_symmetric=sym)
    log_dist(f"activation quantization: {bits}-bit "
             f"{'symmetric' if sym else 'asymmetric'} at the "
             "attention/MLP inputs", ranks=[0])


def wire_progressive_layer_drop(engine) -> None:
    """``engine.progressive_layer_drop``: the schedule; the model draws its
    layer mask from ``engine.pld_generator``, a host generator seeded from
    the config's seed (checkpointed with the state)."""
    engine.progressive_layer_drop = None
    engine.pld_generator = None
    pld_cfg = engine.config.progressive_layer_drop
    if pld_cfg.enabled:
        from .progressive_layer_drop import ProgressiveLayerDrop

        engine.progressive_layer_drop = ProgressiveLayerDrop(
            theta=pld_cfg.theta, gamma=pld_cfg.gamma)
        engine.pld_generator = torch.Generator()
        engine.pld_generator.manual_seed(engine.config.seed)


def wire_curriculum(engine) -> None:
    """The legacy curriculum: ``curriculum_type == "seqlen"`` truncates each
    window's sequence to the scheduled difficulty; any other type samples
    through a ``CurriculumBatchSampler`` over ``metric_values_path``."""
    engine.curriculum_scheduler = None
    engine._curriculum_seqlen = False
    engine._curriculum_metric_path = None
    cl = engine.config.curriculum_learning
    if not cl.enabled:
        return
    from .data_pipeline.curriculum_scheduler import CurriculumScheduler

    if cl.curriculum_type == "seqlen":
        engine._curriculum_seqlen = True
    elif not cl.metric_values_path:
        raise ValueError(
            f"curriculum_type {cl.curriculum_type!r} schedules an "
            "arbitrary difficulty metric through the data sampler — "
            "set curriculum_learning.metric_values_path to a "
            "DataAnalyzer metric file (run_map/run_reduce) aligned "
            "to the training dataset")
    else:
        engine._curriculum_metric_path = cl.metric_values_path
    engine.curriculum_scheduler = CurriculumScheduler({
        "curriculum_type": cl.curriculum_type,
        "min_difficulty": cl.min_difficulty,
        "max_difficulty": cl.max_difficulty,
        "schedule_type": cl.schedule_type,
        "schedule_config": cl.schedule_config,
    })


def wire_random_ltd(engine, model) -> None:
    """Random layerwise token dropping: the kept count's scheduler; the
    engine swaps in a model variant at each new count."""
    engine._random_ltd = None
    engine._ltd_keep = None
    rltd = engine.config.data_efficiency.data_routing.random_ltd
    if not rltd.enabled:
        return
    from .data_pipeline.data_routing.random_ltd import RandomLTDScheduler

    if model is None or not hasattr(model, "config") \
            or not hasattr(model.config, "random_ltd"):
        raise ValueError("random_ltd requires a CausalLM-style model "
                         "(TransformerConfig with random_ltd fields)")
    engine._random_ltd = RandomLTDScheduler(
        {"min_value": rltd.min_value, "max_value": rltd.max_value,
         "random_ltd_schedule": rltd.random_ltd_schedule})


def wire_flops_profiler(engine) -> None:
    """``engine.flops_profiler``: profiles the step at ``profile_step``
    (``profiling/flops_profiler``)."""
    engine.flops_profiler = None
    if engine.config.flops_profiler.enabled:
        from ..profiling.flops_profiler import FlopsProfiler

        engine.flops_profiler = FlopsProfiler(
            engine=engine, config=engine.config.flops_profiler)
        if engine.config.flops_profiler.profile_step <= 1:
            log_dist("flops_profiler: profile_step=1 measures the first "
                     "call, which INCLUDES the kernels' build — set "
                     "profile_step>=2 for steady-state latency", ranks=[0])
