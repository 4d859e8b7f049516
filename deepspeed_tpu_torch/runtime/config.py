"""Master JSON config (counterpart of ``deepspeed_tpu/runtime/config.py``'s
``DeepSpeedConfig``), on the dataclasses of ``config_utils``.

Same JSON keys and the same batch triad (train_batch = micro_batch x
gradient_accumulation_steps x dp_world; the engine resolves it over its
data-parallel world).  A config
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


_OFFLOAD_DEVICES = ("none", "cpu", "nvme")


@dataclasses.dataclass
class OffloadParamConfig:
    """zero_optimization.offload_param (reference runtime/zero/offload_config.py):
    ``device="nvme"`` runs ZeRO-Infinity's layer-streamed executor
    (``runtime/zero/infinity.py``)."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def __post_init__(self):
        self.device = str(getattr(self.device, "value", self.device))
        if self.device not in _OFFLOAD_DEVICES:
            raise ValueError(f"offload_param.device={self.device!r} not in "
                             f"{_OFFLOAD_DEVICES}")
        for knob in ("buffer_count", "buffer_size", "max_in_cpu"):
            check_min(f"offload_param.{knob}", getattr(self, knob), 0)


@dataclasses.dataclass
class OffloadOptimizerConfig:
    """zero_optimization.offload_optimizer (reference
    runtime/zero/offload_config.py).  ``host_step``: True runs the host
    SIMD Adam on RAM-resident state, False parks the state in pinned host
    memory and streams it through the device update (``"streamed"``),
    None picks as the JAX package does (``runtime/offload.py``)."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0
    host_step: Optional[bool] = None

    def __post_init__(self):
        self.device = str(getattr(self.device, "value", self.device))
        if self.device not in _OFFLOAD_DEVICES:
            raise ValueError(f"offload_optimizer.device={self.device!r} not in "
                             f"{_OFFLOAD_DEVICES}")
        check_min("offload_optimizer.buffer_count", self.buffer_count, 0)
        if not 0.0 <= self.ratio <= 1.0:
            raise ValueError("offload_optimizer.ratio must be in [0, 1]")


@dataclasses.dataclass
class AIOConfig:
    """``aio`` block: the NVMe engine's threads (the other knobs parse)."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclasses.dataclass
class ZeroConfig:
    """zero_optimization block: stages 0-3 and MiCS (``mics_shard_size``)
    over the data-parallel ranks (``runtime/zero``), ZeRO-Offload and
    ZeRO-Infinity (``offload_optimizer``, ``offload_param``), ZeRO++
    (``zero_quantized_weights``/``_gradients``, ``zero_hpz_partition_size``)
    and the hierarchical DP size.  The JAX package's checks and messages.
    The bucket and prefetch knobs parse and, as in the JAX package, change
    nothing (collectives are per leaf)."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    round_robin_gradients: bool = False
    elastic_checkpoint: bool = False
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
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
        if isinstance(self.offload_param, dict):
            self.offload_param = config_from_dict(OffloadParamConfig, self.offload_param)
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = config_from_dict(OffloadOptimizerConfig,
                                                      self.offload_optimizer)
        check_min("zero_optimization.zero_hpz_partition_size",
                  self.zero_hpz_partition_size, 1)
        if self.zero_quantized_weights or self.zero_quantized_gradients:
            if self.stage != 3:
                raise ValueError("ZeRO++ quantized collectives require stage 3")
        if self.mics_shard_size == 0 or self.mics_shard_size < -1:
            raise ValueError(
                f"mics_shard_size={self.mics_shard_size} invalid: must be -1 "
                "(disabled) or a positive shard-group size")
        if self.mics_shard_size > 0 and self.stage != 3:
            raise ValueError("mics_shard_size (MiCS) requires ZeRO stage 3")
        if self.mics_hierarchical_params_gather and self.mics_shard_size <= 0:
            raise ValueError(
                "mics_hierarchical_params_gather requires mics_shard_size > 0")
        if self.zero_hpz_partition_size > 1 and self.stage != 3:
            raise ValueError(
                "zero_hpz_partition_size (ZeRO++ hpZ) requires stage 3")
        if self.zero_hierarchical_dp_size > 1 and self.stage != 3:
            raise ValueError(
                "zero_hierarchical_dp_size (hierarchical qgZ) requires "
                "stage 3")
        if self.zero_hierarchical_dp_size > 1 and self.mics_shard_size > 0:
            raise ValueError(
                "zero_hierarchical_dp_size and mics_shard_size both "
                "factorize the data axis — enable exactly one")
        if self.zero_hierarchical_dp_size > 1 \
                and self.zero_hpz_partition_size > 1:
            raise ValueError(
                "zero_hierarchical_dp_size and zero_hpz_partition_size both "
                "factorize the data axis — enable exactly one (hpZ makes "
                "the outer hop the only explicit one; hierarchical qgZ needs masters "
                "on both axes)")


@dataclasses.dataclass
class MeshConfig:
    dp: int = 0     # 0 => infer from the world size
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1


@dataclasses.dataclass
class ProgressiveLayerDropConfig:
    """``progressive_layer_drop`` block (``runtime/progressive_layer_drop.py``)."""
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001

    def __post_init__(self):
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"progressive_layer_drop.theta={self.theta} must be "
                             "in (0, 1]")
        if self.gamma < 0.0:
            raise ValueError(f"progressive_layer_drop.gamma={self.gamma} must be >= 0")


@dataclasses.dataclass
class EigenvalueConfig:
    """``eigenvalue`` block (``runtime/eigenvalue.py``): the power
    iteration's knobs (the reference's device and layer-name knobs mean
    nothing on a parameter tree and are not accepted)."""
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6

    def __post_init__(self):
        check_min("eigenvalue.max_iter", self.max_iter, 1)
        if not self.tol > 0.0:
            raise ValueError(f"eigenvalue.tol={self.tol} must be > 0")
        if self.stability < 0.0:
            raise ValueError(f"eigenvalue.stability={self.stability} must be >= 0")


@dataclasses.dataclass
class CurriculumLearningLegacyConfig:
    """Top-level ``curriculum_learning`` block: ``curriculum_type`` "seqlen"
    truncates each window's sequence to the scheduled difficulty; any other
    type steers the sampler by the per-sample values of
    ``metric_values_path`` (a ``DataAnalyzer`` output)."""
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metric_values_path: Optional[str] = None


@dataclasses.dataclass
class RandomLTDConfig:
    enabled: bool = False
    min_value: int = 128
    max_value: int = 2048
    random_ltd_schedule: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DataRoutingConfig:
    enabled: bool = False
    random_ltd: RandomLTDConfig = dataclasses.field(default_factory=RandomLTDConfig)


@dataclasses.dataclass
class CurriculumMetricConfig:
    """One metric of the multi-metric curriculum
    (``data_efficiency.data_sampling.curriculum_learning.curriculum_metrics``)."""
    metric_values_path: str
    difficulty_type: str = "value"            # 'value' | 'percentile'
    clustering_type: str = "schedule_based"   # | 'single_cluster'
    min_difficulty: int = 1
    max_difficulty: int = 100
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.difficulty_type not in ("value", "percentile"):
            raise ValueError(f"difficulty_type={self.difficulty_type!r}: 'value' or "
                             "'percentile'")
        if self.clustering_type not in ("schedule_based", "single_cluster"):
            raise ValueError(f"clustering_type={self.clustering_type!r}: "
                             "'schedule_based' or 'single_cluster'")


@dataclasses.dataclass
class CurriculumLearningConfig:
    """The multi-metric cluster-bucketed curriculum
    (``data_pipeline/data_sampler.py`` ``MultiMetricCurriculumSampler``)."""
    enabled: bool = False
    curriculum_metrics: Dict[str, CurriculumMetricConfig] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        self.curriculum_metrics = {
            name: config_from_dict(CurriculumMetricConfig, m) if isinstance(m, dict) else m
            for name, m in self.curriculum_metrics.items()}
        if self.enabled and not self.curriculum_metrics:
            raise ValueError("data_sampling.curriculum_learning.enabled needs >=1 entry "
                             "in curriculum_metrics")


@dataclasses.dataclass
class DataSamplingConfig:
    enabled: bool = False
    curriculum_learning: CurriculumLearningConfig = dataclasses.field(
        default_factory=CurriculumLearningConfig)

    def __post_init__(self):
        if self.curriculum_learning.enabled and not self.enabled:
            raise ValueError(
                "data_sampling.curriculum_learning.enabled=true requires "
                "data_sampling.enabled=true (the engine gates on both — a "
                "silently-ignored curriculum would train uniformly)")


@dataclasses.dataclass
class DataEfficiencyConfig:
    enabled: bool = False
    data_routing: DataRoutingConfig = dataclasses.field(default_factory=DataRoutingConfig)
    data_sampling: DataSamplingConfig = dataclasses.field(
        default_factory=DataSamplingConfig)


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


@dataclasses.dataclass
class CheckpointConfig:
    """``checkpoint`` block.  ``async_save``: ``save_checkpoint`` returns
    after the device->host snapshot; the write runs on a background thread
    and ``latest`` moves only once it is durable.  The other keys parse in
    the JAX package and do nothing there, so any but their default is
    refused here."""
    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False


@dataclasses.dataclass
class CommsLoggerConfig:
    """``comms_logger`` block: the comm facade's per-op counts and bytes
    (``comm.configure``)."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class WatchdogConfig:
    """Hang watchdog (``resilience/watchdog.py``): armed around
    ``train_batch`` and async-checkpoint finalization; past ``timeout_s`` it
    dumps an all-thread stack report through the monitor layer and exits
    ``exit_code`` so a supervisor can recycle the process."""
    enabled: bool = False
    timeout_s: float = 600.0
    exit_code: int = 85   # resilience.watchdog.RC_HANG

    def __post_init__(self):
        if not float(self.timeout_s) > 0.0:
            raise ValueError(f"resilience.watchdog.timeout_s={self.timeout_s} "
                             "must be > 0")


@dataclasses.dataclass
class ResilienceConfig:
    """``resilience`` block: ``verify_on_load`` checks a tag against its
    manifest before anything is restored; ``watchdog`` arms the hang
    watchdog (fault injection is set by ``DS_TPU_FAULTS`` or the tests,
    never by the config)."""
    verify_on_load: bool = True
    watchdog: WatchdogConfig = dataclasses.field(default_factory=WatchdogConfig)


@dataclasses.dataclass
class TensorBoardConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class WandbConfig:
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@dataclasses.dataclass
class CSVConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class MonitorConfig:
    """The monitor backends (``monitor/monitor.py``)."""
    tensorboard: TensorBoardConfig = dataclasses.field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = dataclasses.field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = dataclasses.field(default_factory=CSVConfig)

    @property
    def enabled(self) -> bool:
        return self.tensorboard.enabled or self.wandb.enabled or self.csv_monitor.enabled


@dataclasses.dataclass
class FlopsProfilerConfig:
    """``flops_profiler`` block (``profiling/flops_profiler``)."""
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


class DeepSpeedConfigError(Exception):
    pass


def _enabled(block: Any, *path: str) -> bool:
    """``block[path...]["enabled"]`` of a raw config dict, False if absent."""
    for key in path:
        if not isinstance(block, dict):
            return False
        block = block.get(key, {})
    return isinstance(block, dict) and bool(block.get("enabled", False))


class DeepSpeedConfig:
    """Master config: a dict, a JSON file path, or None; resolves the
    batch-size triad against the data-parallel world size."""

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
        self.wall_clock_breakdown = bool(config.get(C.WALL_CLOCK_BREAKDOWN, False))
        self.memory_breakdown = bool(config.get(C.MEMORY_BREAKDOWN, False))
        self.checkpoint_config = config_from_dict(CheckpointConfig,
                                                  config.get("checkpoint", {}))
        self.resilience = config_from_dict(ResilienceConfig,
                                           config.get("resilience", {}))
        self.comms_logger = config_from_dict(CommsLoggerConfig,
                                             config.get("comms_logger", {}))
        self.aio = config_from_dict(AIOConfig, config.get("aio", {}))
        self.progressive_layer_drop = config_from_dict(
            ProgressiveLayerDropConfig, config.get("progressive_layer_drop", {}))
        self.eigenvalue = config_from_dict(EigenvalueConfig, config.get("eigenvalue", {}))
        self.curriculum_learning = config_from_dict(
            CurriculumLearningLegacyConfig, config.get("curriculum_learning", {}))
        self.data_efficiency = config_from_dict(DataEfficiencyConfig,
                                                config.get("data_efficiency", {}))
        self.monitor_config = config_from_dict(MonitorConfig, {
            k: v for k, v in config.items() if k in ("tensorboard", "wandb", "csv_monitor")})
        self.flops_profiler = config_from_dict(FlopsProfilerConfig,
                                               config.get("flops_profiler", {}))

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
        cfg, zc = self._param_dict, self.zero_config
        todo: List[str] = []

        def need(cond: bool, what: str, item: int) -> None:
            if cond:
                todo.append(f"{what} (ROADMAP queue 1, item {item})")

        need(_enabled(cfg, "elasticity"), "elasticity", 13)
        if todo:
            raise NotImplementedError(
                "config enables features the PyTorch port does not have yet: "
                + "; ".join(todo))

        bad: List[str] = ["sparse_gradients"] if cfg.get("sparse_gradients") else []
        # the JAX package's offload refusals, word for word
        if zc.offload_param is not None and zc.offload_param.device == "cpu":
            bad.append("zero_optimization.offload_param.device=cpu "
                       "(use device=nvme for the layer-streamed param "
                       "offload, or offload_optimizer for state-only offload)")
        if zc.offload_param is not None and zc.offload_param.device == "nvme":
            if not zc.offload_param.nvme_path:
                bad.append("zero_optimization.offload_param.device=nvme "
                           "requires nvme_path")
            if zc.stage != 3:
                bad.append("zero_optimization.offload_param requires "
                           "stage=3 (reference restriction)")
        if zc.offload_optimizer is not None and \
                zc.offload_optimizer.device == "nvme" and \
                not zc.offload_optimizer.nvme_path:
            bad.append("zero_optimization.offload_optimizer.device=nvme "
                       "requires nvme_path")
        ck = self.checkpoint_config
        bad += [f"checkpoint.{knob}" for knob in (
            "load_universal", "use_node_local_storage", "parallel_write_pipeline")
            if getattr(ck, knob)]
        if ck.tag_validation != "Warn":
            bad.append("checkpoint.tag_validation")
        ac = self.activation_checkpointing
        bad += [f"activation_checkpointing.{knob}" for knob in (
            "cpu_checkpointing", "contiguous_memory_optimization",
            "synchronize_checkpoint_boundary", "profile") if getattr(ac, knob)]
        if ac.number_checkpoints is not None:
            bad.append("activation_checkpointing.number_checkpoints")
        if bad:
            raise NotImplementedError(
                "config enables features this build does not implement yet: "
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
