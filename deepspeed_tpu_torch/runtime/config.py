"""Master JSON config (counterpart of ``deepspeed_tpu/runtime/config.py``'s
``DeepSpeedConfig``), on the dataclasses of ``config_utils``.

Same JSON keys and the same batch triad (train_batch = micro_batch x
gradient_accumulation_steps x dp_world, here with dp_world = 1).  A config
that turns on a feature the port does not have yet fails at once, naming
the ROADMAP item that ports it: a knob that parses but does nothing would
be a silent lie.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from . import constants as C
from .config_utils import check_min, config_from_dict


@dataclasses.dataclass
class FP16Config:
    """fp16 block (reference runtime/fp16/loss_scaler.py semantics)."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0          # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    def __post_init__(self):
        check_min("fp16.loss_scale_window", self.loss_scale_window, 1)
        check_min("fp16.hysteresis", self.hysteresis, 1)
        if self.loss_scale < 0 or self.min_loss_scale < 0:
            raise ValueError("fp16.loss_scale and min_loss_scale must be >= 0")


@dataclasses.dataclass
class BF16Config:
    """bf16 block: bf16 compute over fp32 master weights."""
    enabled: bool = False
    fp32_grad_accum: bool = True


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: str = "WarmupLR"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ZeroConfig:
    """zero_optimization block.  At world size 1 every stage is the same
    computation (nothing to shard), so stages 0-3 are accepted; offload and
    ZeRO++ are not ported."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    round_robin_gradients: bool = False
    elastic_checkpoint: bool = False
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    zero_hierarchical_dp_size: int = -1
    ignore_unused_parameters: bool = True

    def __post_init__(self):
        if not 0 <= self.stage <= 3:
            raise ValueError(f"zero_optimization.stage={self.stage} not in 0..3")


@dataclasses.dataclass
class MeshConfig:
    dp: int = 0     # 0 => infer (one device here)
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclasses.dataclass
class DataTypesConfig:
    """``data_types`` block: gradient accumulation precision (None/fp32 =
    exact fp32 accumulation; bf16 halves the live gradient buffer)."""
    grad_accum_dtype: Optional[str] = None

    def __post_init__(self):
        if self.grad_accum_dtype not in (None, "fp32", "float32", "bf16", "bfloat16"):
            raise ValueError(f"data_types.grad_accum_dtype={self.grad_accum_dtype!r} "
                             "must be fp32 or bf16")

    def torch_dtype(self) -> torch.dtype:
        if self.grad_accum_dtype in ("bf16", "bfloat16"):
            return torch.bfloat16
        return torch.float32


class DeepSpeedConfigError(Exception):
    pass


def _enabled(block: Any, *path: str) -> bool:
    """``block[path...]["enabled"]`` of a raw config dict, False if absent."""
    for key in path:
        if not isinstance(block, dict):
            return False
        block = block.get(key, {})
    return isinstance(block, dict) and bool(block.get("enabled", False))


def _offloads(block: Optional[Dict[str, Any]]) -> bool:
    return block is not None and str(block.get("device", "none")) != "none"


class DeepSpeedConfig:
    """Master config: a dict, a JSON file path, or None; resolves the
    batch-size triad against the data-parallel world size (1 here)."""

    def __init__(self, config: Union[None, str, Path, Dict[str, Any]] = None,
                 dp_world_size: Optional[int] = None):
        if config is None:
            config = {}
        if isinstance(config, (str, Path)):
            with open(config, "r") as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise DeepSpeedConfigError(f"config must be dict or path, got {type(config)}")
        self._param_dict = dict(config)

        self.mesh = config_from_dict(MeshConfig, config.get("mesh", {}))
        self.zero_config = config_from_dict(ZeroConfig, config.get(C.ZERO_OPTIMIZATION, {}))
        self.fp16 = config_from_dict(FP16Config, config.get(C.FP16, {}))
        self.bf16 = config_from_dict(BF16Config, config.get(C.BF16, {}))
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        opt = config.get(C.OPTIMIZER)
        self.optimizer = config_from_dict(OptimizerConfig, opt) if opt is not None else None
        sched = config.get(C.SCHEDULER)
        self.scheduler = (config_from_dict(SchedulerConfig, sched)
                          if sched is not None else None)

        self.gradient_clipping = float(config.get(C.GRADIENT_CLIPPING,
                                                  C.GRADIENT_CLIPPING_DEFAULT))
        self.prescale_gradients = bool(config.get(C.PRESCALE_GRADIENTS, False))
        self.gradient_predivide_factor = float(config.get(C.GRADIENT_PREDIVIDE_FACTOR, 1.0))
        self.steps_per_print = int(config.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT))
        self.seed = int(config.get("seed", 42))
        self.activation_checkpointing = config_from_dict(
            ActivationCheckpointingConfig, config.get("activation_checkpointing", {}))
        self.data_types = config_from_dict(DataTypesConfig, config.get("data_types", {}))

        self.gradient_accumulation_steps: Optional[int] = config.get(
            C.GRADIENT_ACCUMULATION_STEPS)
        self.train_batch_size: Optional[int] = config.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu: Optional[int] = config.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)

        self._reject_unported()
        if dp_world_size is not None:
            self.resolve_batch_triad(dp_world_size)

    def _reject_unported(self) -> None:
        """Fail fast on settings whose feature the port does not have yet
        (and on the JAX package's own accepted-but-unimplemented knobs)."""
        cfg, zc, mesh = self._param_dict, self.zero_config, self.mesh
        todo: List[str] = []

        def need(cond: bool, what: str, item: int) -> None:
            if cond:
                todo.append(f"{what} (ROADMAP queue 1, item {item})")

        need(_offloads(zc.offload_param) or _offloads(zc.offload_optimizer),
             "zero_optimization offload", 10)
        need(zc.zero_quantized_weights or zc.zero_quantized_gradients
             or zc.zero_hpz_partition_size > 1 or zc.zero_hierarchical_dp_size > 1,
             "ZeRO++ (qwZ/qgZ/hpZ)", 10)
        need(zc.mics_shard_size > 0, "MiCS (mics_shard_size)", 4)
        need(mesh.dp > 1 or mesh.tp > 1, "a mesh over more than one device", 4)
        need(mesh.pp > 1, "pipeline parallelism (mesh.pp)", 9)
        need(mesh.ep > 1, "expert parallelism (mesh.ep)", 9)
        need(mesh.sp > 1, "sequence parallelism (mesh.sp)", 8)
        need("compression_training" in cfg, "compression_training", 11)
        need(_enabled(cfg, "curriculum_learning")
             or _enabled(cfg, "data_efficiency", "data_sampling"),
             "curriculum learning", 11)
        need(_enabled(cfg, "data_efficiency", "data_routing", "random_ltd"),
             "random-LTD", 11)
        need(_enabled(cfg, "progressive_layer_drop"), "progressive layer drop", 11)
        need(_enabled(cfg, "eigenvalue"), "eigenvalue", 11)
        need(any(_enabled(cfg, k) for k in ("tensorboard", "wandb", "csv_monitor")),
             "monitor backends", 11)
        need(_enabled(cfg, "flops_profiler"), "flops profiler", 11)
        need(_enabled(cfg, "resilience", "watchdog"), "hang watchdog", 12)
        need(_enabled(cfg, "elasticity"), "elasticity", 13)
        if todo:
            raise NotImplementedError(
                "config enables features the PyTorch port does not have yet: "
                + "; ".join(todo))

        bad: List[str] = [knob for knob in ("sparse_gradients", C.WALL_CLOCK_BREAKDOWN,
                                            C.MEMORY_BREAKDOWN) if cfg.get(knob, False)]
        ac = self.activation_checkpointing
        bad += [f"activation_checkpointing.{knob}" for knob in (
            "cpu_checkpointing", "contiguous_memory_optimization",
            "synchronize_checkpoint_boundary", "profile") if getattr(ac, knob)]
        if ac.number_checkpoints is not None:
            bad.append("activation_checkpointing.number_checkpoints")
        if bad:
            raise NotImplementedError(
                "config enables features this build does not implement: "
                + "; ".join(bad))

    # -- batch triad (reference runtime/config.py `_batch_assertion` et al.) --
    def resolve_batch_triad(self, dp_world_size: int) -> None:
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            pass
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            mb = tb // (gas * dp_world_size)
        elif mb is not None and gas is not None:
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas = 1
            mb = tb // dp_world_size
        elif mb is not None:
            gas = 1
            tb = mb * dp_world_size
        else:
            raise DeepSpeedConfigError(
                "at least one of train_batch_size / train_micro_batch_size_per_gpu "
                "must be set")
        if gas < 1 or mb < 1 or tb != mb * gas * dp_world_size:
            raise DeepSpeedConfigError(
                f"batch triad inconsistent: train_batch_size={tb} != "
                f"micro_batch({mb}) * gas({gas}) * dp_world({dp_world_size})")
        self.train_batch_size, self.train_micro_batch_size_per_gpu = tb, mb
        self.gradient_accumulation_steps = gas

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def precision(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._param_dict)
