"""Engine feature wiring (counterpart of ``deepspeed_tpu/runtime/features.py``):
progressive layer drop, curriculum learning and random-LTD.

Each ``wire_*`` function owns one optional capability's config resolution
and validation.  The engine attribute names are the JAX engine's
(``engine.progressive_layer_drop``, ``engine.curriculum_scheduler``).
Compression training and the flops profiler are not ported yet (ROADMAP
queue 1, item 11, the tooling half): the config refuses them.
"""
from __future__ import annotations

import torch


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
