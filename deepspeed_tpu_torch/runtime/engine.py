"""DeepSpeedEngine — the training engine (counterpart of
``deepspeed_tpu/runtime/engine.py``; reference ``runtime/engine.py:181``).

The JAX engine owns a functional ``TrainState`` and one jitted
``train_step``.  The port keeps the state and the step's semantics and runs
them eagerly on one device:

  - the model contract is functional: ``loss_fn(params, batch, generator)``
    and ``init_fn(generator)`` (or a model adapter exposing them, see
    ``deepspeed_tpu_torch.models.CausalLM``), or ``params=`` given outright;
  - bf16/fp16 compute over fp32 master weights: the gradient is taken with
    respect to the compute-precision tree (its leaves are the bf16 params
    themselves), as the JAX engine differentiates its bf16 tree;
  - ``gradient_accumulation_steps`` micro-batches accumulate at
    ``data_types.grad_accum_dtype``, in one ``train_batch`` call or through
    ``forward``/``backward``/``step`` (the same arithmetic, bit for bit);
  - the update: unscale by ``loss_scale * gas`` -> finiteness check (fp16)
    -> global norm -> the optimizer chain on the fp32 masters -> skip on
    overflow -> recast the compute params;
  - frozen parameters (``model.frozen_spec()``, a tree of bools): not
    differentiated (a zero gradient, so no share of the norm, the
    clipping or the overflow check), no update, no weight decay, no moment
    change; still in the state and in checkpoints;
  - checkpoints (``save_checkpoint``/``load_checkpoint``) hold the whole
    state, the dropout generator's included, so a resumed run continues
    bit for bit (``checkpoint_engine/dcp_engine.py``).

Masters are fp32, or the parameters' own dtype when it is wider (an fp64
model keeps fp64 masters, as the JAX engine does under x64).

Data parallelism: whenever ``torch.distributed`` is initialised (world
size 1 included) the engine runs one rank of a data-parallel job over the
mesh of ``parallel/mesh.py``.  Every rank materialises the same global
batch and takes its rows (``_local_rows``, as the JAX engine's multi-host
``_shard_batch``); ``zero_optimization.stage`` and ``mics_shard_size``
pick the plan (``runtime/zero/planner.py``) that ``runtime/zero/
partition.py`` executes: the masters and the optimizer state live as this
rank's shards, the gradient reductions follow the stage, the overflow
check and the global norm are all-reduced, and checkpoints hold DTensors
(``checkpoint_engine/dcp_engine.py``).  A model with ``loss_terms``
(``models.CausalLM``) reports its loss as (sum, count) and the engine
divides by the count summed over the ranks, JAX's global mean; a bare
``loss_fn`` gives the mean of the ranks' means.  Without a process group
the engine is the one-device trainer of before.

Tensor parallelism: a ``CausalLM`` trains Megatron-style over the mesh's
'model' axis when that axis is above 1, or when the caller names a model
axis (``mesh=``, ``mpu=`` or ``param_specs=``; at size 1 every model-axis
collective is then a copy).  Each rank holds its model-axis shards of
``model.param_specs`` (padded with zeros where the axis does not divide a
dim: ``models/transformer.py`` ``shard_params``), ZeRO shards within
them, the ranks of one data-parallel replica read the same rows, and the
model runs inside ``parallel.tensor_parallel.region()``.  Without
``params=`` every rank draws the default init leaf by leaf and keeps its
shards, so one seed names the same weights at every model axis.  Any other
model with ``param_specs`` (given, or the model's) runs under DTensor
sharding propagation: each leaf a DTensor of its ``Shard`` on the 'model'
sub-mesh, the batch replicated, the loss redistributed to ``Replicate``;
a model without specs is replicated over the model axis, as GSPMD runs it.

Sequence parallelism (the mesh's 'seq' axis, a ``CausalLM``): the ranks
of one replica read the same rows, each its contiguous slice of the
sequence (labels and positions derived on the whole sequence first:
``CausalLM.shard_sequence``); attention runs as ring attention over the
axis (``ops/ring_attention.py``) or, with ``attn_impl="ulysses"``, as the
head/sequence all-to-all; the loss is the masked mean over the data axes
and 'seq', and the gradients are summed over both.
Expert parallelism (the mesh's 'expert' axis, a ``CausalLM`` with MoE
layers): the 'expert' axis is a data axis for the batch rows, and each
rank holds its ``E / ep`` experts of every MoE leaf (``param_specs``),
cut by ZeRO over 'data' only, their gradients summed over the data axes
only; the MoE layers exchange their capacity buffers over 'expert'
(``moe/sharded_moe.py``).

Pipeline parallelism (``config.pipeline_stages > 1``): ``train_batch``
takes the whole gas window in one call and runs it through the model's
stages (``pipeline_backward``, ``runtime/pipe/executor.py``): one stage a
rank of the mesh's 'pipe' axis, each holding its stage's layers (cut by
the specs' 'pipe' dim), or every stage in this process (virtual stages)
at a 'pipe' axis of 1; the embedding, head and norms every pipe rank
holds sum their gradients over 'pipe' (the reference's ReduceTiedGrads).
``forward``/``backward``/``step`` are refused, as in the JAX engine.

Offload (``runtime/offload.py``): ``offload_optimizer`` keeps the fp32
masters and the moments in host RAM stepped by the host SIMD Adam
(``host_step``, the card computing the gradients and getting the bf16
params back), in NVMe files (``nvme``), or parked in pinned host memory
and streamed through the engine's own update a leaf at a time
(``streamed``); ``offload_param.device="nvme"`` hands the whole step to
ZeRO-Infinity's layer-streamed executor (``runtime/zero/infinity.py``).
ZeRO++ (``runtime/zero/zeropp.py``): qwZ/qgZ make the stage-3 gathers
int8 on the wire, hpZ and the hierarchical DP size factorize the data
axis.  The 1-bit optimizers: OneBitAdam/OneBitLamb exchange the
gradients error-feedback sign-compressed after ``freeze_step``
(``runtime/comm/compressed.py``), ZeroOneAdam runs its variance freeze
and local steps (``runtime/comm/zero_one.py``).  Each composition the JAX
engine refuses raises with its message.
The optional training features (``runtime/features.py``, the JAX
engine's wiring and attribute names): progressive layer drop (the theta
schedule a window, the model's layer mask drawn from the host
``pld_generator``), the legacy seqlen curriculum (each window truncated
to the scheduled length), random-LTD (the loss swapped to a model variant
at each new kept count), the metric curricula (the loader's samplers) and
``compute_eigenvalue``; any optimizer of ``runtime/optimizer.py``, LAMB's
norms summed over the pieces of a leaf a rank holds (``_leaf_axes``).
Compression training (``compression/``, ``wire_compression``): each step
transforms the compute tree outside the gradient, which is then taken at
the transformed tree, as the JAX engine's ``compute_tree`` does; a leaf a
rank holds a piece of takes its statistics over the whole leaf
(``_compressed``); activation fake-quant runs in the model.  The
monitors (``monitor/``) receive each step's events, and the flops
profiler (``profiling/``) counts the step at ``profile_step``.
Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: a 'pipe' axis with tensor, sequence or expert axes or with ZeRO
stage 3, MoE on a 'seq' axis (item 9, left); compression with a 'pipe'
or 'expert' axis above 1 (item 11, left).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import comm
from ..accelerator import resolve_device
from ..parallel import tensor_parallel
from ..parallel.mesh import BATCH_AXES
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from ..utils.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                          tree_unflatten_like)
from .config import DeepSpeedConfig
from .features import (wire_compression, wire_curriculum, wire_flops_profiler,
                       wire_progressive_layer_drop, wire_random_ltd)
from .fp16.loss_scaler import (LossScaleState, dynamic_loss_scale_state,
                               grads_finite, no_loss_scale_state, scale_loss,
                               static_loss_scale_state, update_scale)
from .lr_schedules import constant_lr, get_lr_scheduler
from .optimizer import (GradientTransformation, apply_updates, chain,
                        create_optimizer, global_norm, sharded_norm,
                        zero_frozen_updates)

# the axes a micro-batch's loss and labelled-token count are summed over
LOSS_AXES = BATCH_AXES + ("seq",)


def _leaf_at(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


def _set_leaf(tree, path: str, value) -> None:
    *head, last = path.split("/")
    for part in head:
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    tree[int(last) if isinstance(tree, list) else last] = value


class _ParamTrees:
    """Which members of an optimizer state are shaped like the parameter
    tree (``paths``), decided once a member."""

    def __init__(self, paths):
        self.paths, self.seen = paths, {}

    def __call__(self, obj) -> bool:
        if not isinstance(obj, (dict, list)):
            return False
        if id(obj) not in self.seen:
            self.seen[id(obj)] = [p for p, _ in tree_flatten_with_path(obj)] == self.paths
        return self.seen[id(obj)]


def _state_leaf(obj, trees: _ParamTrees, i):
    """The optimizer state of parameter ``i`` alone: every member shaped
    like the parameter tree cut to ``{"x": its leaf i}``; the rest (step
    counts) as it is."""
    if trees(obj):
        return {"x": _leaf_at(obj, trees.paths[i])}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _state_leaf(getattr(obj, f.name), trees, i)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_state_leaf(o, trees, i) for o in obj)
    return obj


def _put_state_leaf(obj, sub, trees: _ParamTrees, i):
    """``obj`` with parameter ``i``'s state from ``sub`` written into its
    tree members in place, and its other members (the step counts, equal
    for every parameter) taken from ``sub``."""
    if trees(obj):
        _set_leaf(obj, trees.paths[i], sub["x"])
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _put_state_leaf(
            getattr(obj, f.name), getattr(sub, f.name), trees, i)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_put_state_leaf(o, n, trees, i) for o, n in zip(obj, sub))
    return sub


def _has_moe(mcfg) -> bool:
    experts = getattr(mcfg, "num_experts", 1)
    return max(experts) > 1 if isinstance(experts, (tuple, list)) else experts > 1


@dataclasses.dataclass
class TrainState:
    """Everything one step reads and writes."""

    step: int                         # global step
    params: Any                       # compute-precision params (fwd/bwd view)
    master_params: Any                # fp32 masters (None when compute is fp32/fp64)
    opt_state: Any
    scaler: LossScaleState


def _cast_tree(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def _whole_shape(shape, spec, sizes: dict) -> tuple:
    """The whole leaf of a shard of ``shape`` cut over the axes of
    ``sizes`` (axis -> size: 'model', 'expert', 'pipe') its spec names."""
    shape = list(shape)
    for axis, n in sizes.items():
        d = tensor_parallel.spec_dim(spec, axis)
        if d is not None:
            shape[d] *= n
    return tuple(shape)


def _master_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or the leaf's own dtype when it is wider."""
    return torch.promote_types(x.dtype, torch.float32) if x.is_floating_point() \
        else x.dtype


class DeepSpeedEngine:
    def __init__(self, model: Any = None, loss_fn: Optional[Callable] = None,
                 init_fn: Optional[Callable] = None, params: Any = None,
                 config: Any = None,
                 optimizer: Optional[GradientTransformation] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 training_data: Any = None, device=None, mesh=None,
                 param_specs: Any = None, mpu=None):
        from ..utils.init_on_device import ENGINE_REFUSAL, current_on_device

        if current_on_device() is not None:
            raise RuntimeError(ENGINE_REFUSAL)
        # -- model contract resolution --
        self.model = model
        self._eval_fn = self._loss_terms = None
        if model is not None and loss_fn is None:
            loss_fn = getattr(model, "loss_fn", None)
            # the (sum, count) loss contract, when the loss is the model's own
            self._loss_terms = getattr(model, "loss_terms", None)
            init_fn = init_fn or getattr(model, "init_fn", None)
            self._eval_fn = getattr(model, "eval_fn", None)
        if loss_fn is None:
            raise ValueError("engine needs loss_fn(params, batch, generator) "
                             "(directly or via model)")
        if init_fn is None and params is None:
            raise ValueError("engine needs init_fn(generator)->params or "
                             "explicit params")
        self.loss_fn = loss_fn
        self._eval_fn = self._eval_fn or loss_fn

        # -- config and the data-parallel world --
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config))
        self.device = resolve_device(device)
        self._mpu_tp = (int(mpu.get_model_parallel_world_size())
                        if mpu is not None else None)
        self._resolve_world(mesh)
        self._resolve_tp(model, mesh is not None or mpu is not None
                         or param_specs is not None, param_specs)
        self.config.resolve_batch_triad(self.dp_world)
        self._check_pipeline(model)
        self.compute_dtype = self.config.precision
        self.use_master_weights = self.compute_dtype != torch.float32
        self.fp16_enabled = self.config.fp16.enabled
        self.zero_stage = self.config.zero_optimization_stage
        self.gas = self.config.gradient_accumulation_steps
        self.micro_batch_size = self.config.train_micro_batch_size_per_gpu
        self.train_batch_size = self.config.train_batch_size
        self.accum_dtype = self.config.data_types.torch_dtype()

        # -- lr schedule --
        if lr_scheduler is not None:
            self.lr_schedule = lr_scheduler
        elif self.config.scheduler is not None:
            self.lr_schedule = get_lr_scheduler(self.config.scheduler.type,
                                                self.config.scheduler.params)
        else:
            lr = (self.config.optimizer.params.get("lr", 1e-3)
                  if self.config.optimizer else 1e-3)
            self.lr_schedule = constant_lr(lr)

        # -- frozen parameters (reference requires_grad=False): the model
        #    exposes frozen_spec() -> a tree of bools (True = frozen) --
        frozen_spec = getattr(model, "frozen_spec", None)
        self._frozen_mask = frozen_spec() if callable(frozen_spec) else frozen_spec
        if self._frozen_mask is not None and not any(tree_leaves(self._frozen_mask)):
            self._frozen_mask = None    # nothing frozen: skip the masking

        # -- optimizer --
        # the engine's own chain on one device updates a leaf at a time
        # (``_apply_update_leafwise``); a client chain sees whole trees
        self._leafwise = False
        if optimizer is not None:
            if self._frozen_mask is not None:
                # whatever the client chain emits (weight decay included),
                # frozen leaves get a zero update
                optimizer = chain(optimizer, zero_frozen_updates(self._frozen_mask))
            self.optimizer = optimizer
        else:
            opt_cfg = self.config.optimizer
            self.optimizer = create_optimizer(
                opt_cfg.type if opt_cfg else "adamw",
                dict(opt_cfg.params) if opt_cfg else {}, self.lr_schedule,
                self.config.gradient_clipping, frozen_mask=self._frozen_mask)

        # -- compression (QAT / pruning transform on the compute tree,
        #    activation fake-quant in the model) --
        wire_compression(self, model)
        if self._compression_transform is not None:
            if self.pipelined and getattr(model.config, "pipeline_schedule",
                                          "gpipe") == "1f1b":
                raise NotImplementedError(
                    "pipeline_schedule='1f1b' + compression_training: the "
                    "manual executor differentiates the raw params")
            if self.pp > 1 or self.ep > 1:
                raise NotImplementedError(
                    "compression_training with a 'pipe' or 'expert' axis above 1: "
                    "a leaf those axes cut would take its statistics over this "
                    "rank's stages or experts only (ROADMAP queue 1, item 11, left)")
        self._check_compression(optimizer)
        # -- optional training features (runtime/features.py) --
        wire_progressive_layer_drop(self)
        wire_curriculum(self)
        wire_random_ltd(self, model)
        self._check_data_efficiency()

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)
        self.plan = self.partition = None
        self._offload = self._param_offload = None
        self._compute_cast = None
        self._comm_error = None
        if self._wants_param_offload():
            self._param_offload = self._build_param_offload(model)
            self.state = None
            self.param_count = self._param_offload.param_count
        else:
            self.state = self._init_state(init_fn, params, param_specs)
            self.param_count = (sum(math.prod(s) for s in self.partition.global_shapes)
                                if self.partition is not None else
                                sum(x.numel() for x in tree_leaves(self.state.params)))
        self._leafwise = optimizer is None and self._frozen_mask is None
        if self._compression_transform is not None and (
                not self.use_master_weights
                or (self.partition is not None and self.partition.zeropp is not None)):
            raise NotImplementedError(
                "compression_training with fp32 compute / ZeRO++ "
                "quantized gather is not supported yet")

        # -- bookkeeping --
        self.global_steps = 0
        self.skipped_steps = 0
        self.micro_steps = 0
        # named timers, held for callers as in the JAX engine (which times
        # nothing with them itself)
        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size,
                                          steps_per_output=self.config.steps_per_print)
        self._last_grad_norm: Optional[float] = None
        # the forward/backward/step window: the differentiated tree, the
        # banked gradients, their count, the pending loss, the losses
        self._work = None
        self._accum_grads = None
        self._accum_count = 0
        self._pending_loss = self._pending_report = None
        self._window_losses: list = []
        # checkpointing: an in-flight async save and its error
        self._async_ckpt_engine = None
        self._pending_ckpt_thread = None
        self._async_ckpt_error = None
        self._data_iterator = None
        wire_flops_profiler(self)
        self.training_dataloader = self._build_dataloader(training_data)
        self.monitor = self._build_monitor()
        log_dist(
            f"engine ready: params={self.param_count:,} zero_stage={self.zero_stage} "
            f"dtype={self.compute_dtype} device={self.device} "
            f"batch={self.train_batch_size} (micro={self.micro_batch_size} "
            f"gas={self.gas} dp={self.dp_world} tp={self.tp or 1})", ranks=[0])

    def _resolve_world(self, mesh) -> None:
        """The data-parallel world: the process group's mesh when
        ``torch.distributed`` is initialised, else one device."""
        import torch.distributed as dist

        from ..parallel.mesh import (BATCH_AXES, MeshLayout, layout_of,
                                     resolve_engine_mesh)

        self.distributed = dist.is_available() and dist.is_initialized()
        zc = self.config.zero_config
        mc = self.config.mesh
        if self._mpu_tp is not None:
            mc = dataclasses.replace(mc, tp=self._mpu_tp)
        self.pp = self.ep = 1
        self.pp_rank = 0
        if not self.distributed:
            layout = (mesh if isinstance(mesh, MeshLayout) or mesh is None
                      else layout_of(mesh))
            if ((layout is not None and layout.world_size > 1)
                    or mc.dp > 1 or mc.tp > 1 or mc.sp > 1 or mc.pp > 1 or mc.ep > 1
                    or zc.mics_shard_size > 1):
                raise RuntimeError(
                    "a data-, tensor-, sequence-, pipeline- or expert-parallel "
                    "mesh needs a process group: call "
                    "deepspeed_tpu_torch.comm.init_distributed() (or run "
                    "under torchrun) before initialize()")
            self.mesh, self.dp_world, self.dp_rank = None, 1, 0
            self.sp, self.sp_rank = 1, 0
            return
        backend = dist.get_backend()
        if (self.device.type == "cuda") != ("nccl" in backend):
            raise RuntimeError(
                f"the engine runs on {self.device} but the process group's "
                f"backend is {backend!r}: NCCL serves the card, gloo the CPU")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = resolve_engine_mesh(mc, zc, mesh)
        layout = layout_of(self.mesh)
        self.pp, self.ep = layout.pp, layout.ep
        self.pp_rank = comm.axis_index("pipe")
        mcfg = getattr(self.model, "config", None)
        if layout.pp > 1:
            stages = getattr(mcfg, "pipeline_stages", 1)
            if stages != layout.pp:
                raise ValueError(
                    f"mesh has pipe={layout.pp} but model.config.pipeline_stages={stages}")
            if layout.tp > 1 or layout.sp > 1 or layout.ep > 1:
                raise NotImplementedError(
                    f"mesh {layout}: a 'pipe' axis composes with the data axes "
                    "only in the port (tensor, sequence and expert axes with "
                    "pipeline stages: ROADMAP queue 1, item 9, left)")
        if layout.sp > 1 and mcfg is not None and _has_moe(mcfg):
            raise NotImplementedError(
                f"mesh {layout}: MoE layers route whole rows (their capacity "
                "groups), which a 'seq' axis cuts (ROADMAP queue 1, item 9, left)")
        self.sp, self.sp_rank = layout.sp, comm.axis_index("seq")
        if self.sp > 1 and not hasattr(self.model, "shard_sequence"):
            raise NotImplementedError(
                f"a 'seq' axis of {self.sp} for a model that cannot cut its "
                "sequence (a bare loss_fn): sequence parallelism runs "
                "models.CausalLM (shard_sequence)")
        if self._mpu_tp is not None and self._mpu_tp != layout.tp:
            raise ValueError(f"mpu's model-parallel world size {self._mpu_tp} "
                             f"!= the mesh's model axis {layout.tp}")
        self.dp_world = layout.dp_world_size
        self.dp_rank = comm.axis_index(BATCH_AXES)
        comm.configure(self.config.comms_logger)

    def _check_data_efficiency(self) -> None:
        """The JAX engine's refusals of what progressive layer drop and
        random-LTD do not compose with."""
        if self.pipelined:
            schedule = getattr(self.model.config, "pipeline_schedule", "gpipe")
            if self.progressive_layer_drop is not None:
                raise NotImplementedError(
                    "pipeline_schedule='1f1b' + progressive_layer_drop: the "
                    "manual executor would silently drop pld_theta"
                    if schedule == "1f1b" else
                    "progressive layer drop requires the scanned-layers path "
                    "(scan_layers=True, pipeline_stages=1, uniform layers)")
            if self._random_ltd is not None:
                raise NotImplementedError(
                    "pipeline_schedule='1f1b' + random_ltd: unsupported"
                    if schedule == "1f1b" else
                    "random-LTD with pipeline stages is not ported: the stage "
                    "executor builds its blocks without the token-drop wrapper")
        if self._wants_param_offload():
            if self._random_ltd is not None:
                raise NotImplementedError(
                    "offload_param + random_ltd: the layer-streamed executor "
                    "builds its programs from the base model config")
            if self.progressive_layer_drop is not None:
                raise NotImplementedError(
                    "offload_param + progressive_layer_drop: unsupported")

    def _check_pipeline(self, model) -> None:
        """``self.pipelined``: the model's config asks for pipeline stages
        (on the mesh's 'pipe' axis, or virtual stages in this process at an
        axis of 1).  The JAX engine's checks: microbatches are decoupled
        from gas, and must divide the step's sample window."""
        mcfg = getattr(model, "config", None)
        stages = getattr(mcfg, "pipeline_stages", 1) or 1
        self.pipelined = stages > 1 and hasattr(model, "pipeline_backward")
        if not self.pipelined:
            return
        micro = getattr(mcfg, "pipeline_microbatches", None) or stages
        window = (self.config.gradient_accumulation_steps
                  * self.config.train_micro_batch_size_per_gpu * self.dp_world)
        if window % micro or (window // self.dp_world) % micro:
            raise ValueError(
                f"pipeline microbatches ({micro}) must divide the "
                f"per-step sample window gas*micro_batch*dp={window}")
        if getattr(mcfg, "pipeline_schedule", "gpipe") == "1f1b" \
                and self.config.prescale_gradients:
            raise NotImplementedError(
                "pipeline_schedule='1f1b' + prescale_gradients: unsupported")
        if self.pp > 1 and self.config.zero_optimization_stage >= 3:
            raise NotImplementedError(
                "ZeRO stage 3 with a 'pipe' axis: each stage would gather its "
                "layers over the data axes (ROADMAP queue 1, item 9, left); "
                "use stages 0-2")

    def _resolve_tp(self, model, explicit: bool, param_specs) -> None:
        """Whether the model runs tensor-parallel (``self.tp``: the model
        axis's size, 0 when it does not), its specs, and how: its own
        Megatron path (a model with ``shard_params``, ``models.CausalLM``)
        or DTensor sharding propagation (``self._generic_tp``)."""
        self.tp, self.tp_rank, self._tp_specs = 0, 0, None
        self._tp_shapes = self._leaf_specs = None
        self._generic_tp = False
        if not self.distributed:
            return
        from ..parallel.mesh import layout_of

        n = layout_of(self.mesh).tp
        own = getattr(model, "param_specs", None)
        if hasattr(model, "shard_params") and own is not None:
            if param_specs is not None and param_specs != own:
                raise ValueError(
                    "param_specs differ from the model's: the CausalLM's "
                    "tensor-parallel forward is laid out for model.param_specs")
            # expert and pipe axes cut the experts and the layers by the same
            # specs, so they take this path at a model axis of 1 too
            if n > 1 or explicit or self.ep > 1 or self.pp > 1:
                self.tp, self.tp_rank, self._tp_specs = n, comm.axis_index("model"), own
                # the whole leaves' true shapes (meta tensors)
                self._tp_shapes = model.init_fn(torch.Generator(), device="meta")
            return
        specs = param_specs if param_specs is not None else own
        if n > 1 and specs is not None:   # replicated over 'model' without specs
            self.tp, self.tp_rank, self._tp_specs = n, comm.axis_index("model"), specs
            self._generic_tp = True

    def _tp_region(self):
        return tensor_parallel.region(bool(self.tp) and not self._generic_tp)

    def _cuts(self) -> dict:
        """axis -> (this rank's index, size) of the axes besides 'model' a
        rank holds a piece of a leaf over ('expert', 'pipe')."""
        out = {}
        if self.ep > 1:
            out["expert"] = (comm.axis_index("expert"), self.ep)
        if self.pp > 1:
            out["pipe"] = (self.pp_rank, self.pp)
        return out

    def _tp_cut(self, params):
        """This rank's model-axis shards of a whole tree (and its experts
        and stage layers on expert and pipe axes)."""
        if not self._generic_tp:
            if self._cuts():
                return self.model.cut_params(
                    params, {"model": (self.tp_rank, self.tp), **self._cuts()})
            return self.model.shard_params(params, self.tp_rank, self.tp)
        return tensor_parallel.slice_tree(
            tensor_parallel.check_even(params, self._tp_specs, self.tp),
            self._tp_specs, self.tp_rank, self.tp)

    def _check_init_fits(self) -> None:
        """The default init draws each whole leaf in fp32 before keeping
        this rank's shard: raise when the largest does not fit the card."""
        if self.device.type != "cuda":
            return
        largest = max(x.numel() for x in tree_leaves(self._tp_shapes)) * 4
        free, _ = torch.cuda.mem_get_info(self.device)
        if largest > free:
            raise ValueError(
                f"the default init draws each whole leaf in fp32 before keeping "
                f"this rank's shard; the largest takes {largest / 1e9:.2f} GB and "
                f"the card has {free / 1e9:.2f} GB free: pass params= (a whole "
                "tree, or init_fn(..., tp=, streamed=True)'s shards)")

    def _init_state(self, init_fn, params, param_specs=None) -> TrainState:
        """fp32 masters from ``params`` or ``init_fn(generator)``, the
        compute-precision view, the optimizer state and the loss scaler.
        Data-parallel: every rank draws the same full tree and keeps its
        shards of it (the plan's placements).  Above a model axis of 1 each
        rank draws the default init's leaves in order and keeps its shard
        of each (``init_fn(tp=)``), so one seed names the same weights at
        every model axis; ``params=`` (a whole tree) is cut the same way."""
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(self.config.seed)
            if (self.tp > 1 or self._cuts()) and not self._generic_tp:
                self._check_init_fits()
                params = self.model.init_fn(init_gen, tp=(self.tp_rank, self.tp),
                                            **({"cuts": self._cuts()} if self._cuts()
                                               else {}))
            else:
                params = init_fn(init_gen)
                if self.tp:
                    params = self._tp_cut(params)
        elif self.tp:
            params = self._tp_cut(params)
        if self._frozen_mask is not None:
            mask_paths = [p for p, _ in tree_flatten_with_path(self._frozen_mask)]
            param_paths = [p for p, _ in tree_flatten_with_path(params)]
            if mask_paths != param_paths:
                raise ValueError(
                    "model.frozen_spec() structure does not match the param "
                    f"tree: mask {mask_paths} vs params {param_paths}")
            n_frozen = sum(x.numel() for x, m in zip(tree_leaves(params),
                                                     tree_leaves(self._frozen_mask))
                           if m)
            log_dist(f"frozen parameters: {n_frozen:,} excluded from "
                     "updates/grad-norm (model.frozen_spec)", ranks=[0])
        # masters are fresh fp32 (or wider) copies: the caller's tree is
        # never aliased; data-parallel, each leaf's copy is cut to this
        # rank's shard before the next is made.  Host-stepped offload on
        # one device: each leaf's master goes straight to host memory and
        # only its compute view stays on the card
        if not self.distributed and self._offload_mode(self.use_master_weights) in (
                "host_step", "nvme"):
            master = tree_map(lambda x: x.detach().to("cpu", _master_dtype(x), copy=True),
                              params)
            params0 = tree_map(lambda x: x.detach().to(self.device, self.compute_dtype)
                               if x.is_floating_point() else x.detach().to(self.device),
                               params)
            del params
            return self._host_offload_state(master, params0)
        if self.distributed:
            master = self._shard_state(params, self._tp_specs if self.tp
                                       else param_specs)
        else:
            master = tree_map(lambda x: x.detach().to(self.device, _master_dtype(x),
                                                      copy=True), params)
        if self.use_master_weights:
            params0 = (_cast_tree(master, self.compute_dtype)
                       if self.partition is None else tree_unflatten_like(
                           master, self.partition.compute_params(
                               tree_leaves(master), self.compute_dtype)))
        else:
            params0, master = master, None
        mode = self._offload_mode(master is not None)
        if mode in ("host_step", "nvme"):
            return self._host_offload_state(master, params0)
        if self._compression is not None and self._compression["algo"] == "zo":
            from .comm.zero_one import init_zero_one_state

            self._comm_error = init_zero_one_state(master if master is not None
                                                   else params0, self.device)
            opt_state = ()
        else:
            opt_state = self.optimizer.init(master if master is not None else params0)
            if self._compression is not None:   # over the whole leaves
                from .comm.compressed import init_error_tree

                shapes = (self.partition.global_shapes if self.partition is not None
                          else [tuple(x.shape) for x in tree_leaves(params0)])
                self._comm_error = init_error_tree(
                    [torch.empty(sh, device="meta") for sh in shapes], self.device)
        from .offload import StreamedState

        self._state_home = StreamedState(self.device, parked=mode == "streamed",
                                         masters=master is not None)
        if mode == "streamed" and not self._state_home.parked:
            # host memory is the CPU device's memory: nothing to park (the
            # JAX engine skips the placement on its CPU backend too)
            log_dist("offload_optimizer.device=cpu: CPU device — host memory IS "
                     "device memory; offload placement skipped", ranks=[0])
        opt_state = self._state_home.park(opt_state)
        if master is not None:
            master = self._state_home.park(master)
        return TrainState(step=0, params=params0, master_params=master,
                          opt_state=opt_state, scaler=self._scaler())

    def _wants_param_offload(self) -> bool:
        zpo = self.config.zero_config.offload_param
        return zpo is not None and zpo.device == "nvme"

    def _build_param_offload(self, model):
        """ZeRO-Infinity's parameter offload (``runtime/zero/infinity.py``),
        with the JAX engine's refusals of what does not compose."""
        from .zero.infinity import InfinityParamEngine

        if self._compression_transform is not None:
            raise NotImplementedError(
                "offload_param + compression_training: unsupported")
        if self._compression is not None:
            raise NotImplementedError("offload_param + 1-bit optimizers: unsupported")
        if self.config.flops_profiler.enabled:
            raise NotImplementedError(
                "offload_param + flops_profiler: the profiler hooks the "
                "fused jitted step, which this path replaces")
        zoo = self.config.zero_config.offload_optimizer
        if zoo is not None and zoo.device != "none":
            raise NotImplementedError(
                "offload_param already places the optimizer state on its "
                "own NVMe path (masters + moments live beside the "
                "params); a simultaneous offload_optimizer config would "
                "be silently ignored — remove it")
        if self._frozen_mask is not None:
            raise NotImplementedError(
                "model.frozen_spec does not compose with offload_param "
                "(the layer-streamed host Adam steps every shard); use "
                "the LoRA path (runtime/lora.py) to train adapters "
                "against NVMe-resident frozen weights")
        if self.tp or self.sp > 1 or self.pp > 1 or self.ep > 1:
            raise NotImplementedError(
                "offload_param runs over the data axes only in the port (its "
                "per-layer files hold ZeRO-3 shards over the data axes)")
        return InfinityParamEngine(self.config, model, self.lr_schedule,
                                   self.device, self.generator)

    def _check_compression(self, client_optimizer) -> None:
        """``self._compression`` for the 1-bit optimizers (the JAX engine's
        rules and messages): ``{"algo": "ef", "freeze_step"}`` for
        OneBitAdam/OneBitLamb (the error-feedback exchange after
        ``freeze_step``), ``{"algo": "zo", "hyper"}`` for ZeroOneAdam."""
        self._compression = None
        opt_cfg = self.config.optimizer
        if client_optimizer is not None or opt_cfg is None:
            return
        norm_type = opt_cfg.type.lower().replace("_", "")
        if norm_type not in ("onebitadam", "onebitlamb", "zerooneadam"):
            return
        opt_params = dict(opt_cfg.params)
        if self.distributed:
            from ..parallel.mesh import MESH_AXES, layout_of

            sizes = dict(zip(MESH_AXES, layout_of(self.mesh).axis_sizes()))
            for ax in ("model", "seq", "pipe", "expert"):
                if sizes.get(ax, 1) > 1:
                    raise ValueError(f"1-bit optimizers need a pure-DP mesh ({ax} "
                                     f"axis has size {sizes[ax]})")
        zoo = self.config.zero_config.offload_optimizer
        if norm_type == "zerooneadam":
            if self._frozen_mask is not None:
                raise NotImplementedError(
                    "model.frozen_spec does not compose with ZeroOneAdam "
                    "(it owns its whole optimizer state outside the "
                    "masked optax chain)")
            if self.zero_stage != 0:
                raise ValueError(
                    "ZeroOneAdam composes with ZeRO stage 0 only (the "
                    "in-region update reads replicated masters; the "
                    "reference tutorial lists the same ZeRO "
                    "incompatibility)")
            if self.fp16_enabled:
                raise NotImplementedError(
                    "ZeroOneAdam + fp16 loss scaling: the local-step "
                    "phase has no per-worker overflow protocol")
            if self.config.gradient_clipping:
                raise NotImplementedError(
                    "ZeroOneAdam supports max_grad_norm=0 only "
                    "(reference zoadam.py has the same default; clipping "
                    "a locally-drifted update is undefined)")
            if zoo is not None:
                raise NotImplementedError("ZeroOneAdam + optimizer offload: unsupported")
            if self._compression_transform is not None:
                raise NotImplementedError(
                    "ZeroOneAdam + compression_training: the in-region "
                    "update differentiates the raw masters and would "
                    "silently skip the QAT/pruning transform")
            self._compression = {"algo": "zo", "hyper": opt_params}
            return
        self._compression = {"algo": "ef",
                             "freeze_step": int(opt_params.get("freeze_step", 100))}
        if self.zero_stage > 1:
            raise ValueError(
                "1-bit optimizers compose with ZeRO stage <= 1 only "
                "(stages 2/3 shard gradients; the reference has the "
                "same restriction)")

    def _scaler(self) -> LossScaleState:
        if not self.fp16_enabled:
            return no_loss_scale_state()
        f16 = self.config.fp16
        return (static_loss_scale_state(f16.loss_scale) if f16.loss_scale > 0
                else dynamic_loss_scale_state(f16.initial_scale_power,
                                              f16.loss_scale_window,
                                              f16.min_loss_scale, f16.hysteresis))

    def _offload_mode(self, has_masters: bool) -> str:
        """Where the optimizer state rests (``runtime/offload.py``), with
        the JAX engine's refusals of what does not compose."""
        from .offload import resolve_offload_mode

        mode = resolve_offload_mode(self.config, self.dp_world,
                                    use_master_weights=has_masters,
                                    fp16_enabled=self.fp16_enabled,
                                    has_compression=self._compression_transform is not None)
        if mode in ("host_step", "nvme"):
            if not has_masters:
                raise ValueError("optimizer offload requires bf16/fp16 "
                                 "compute (fp32 params have no separate masters "
                                 "to offload)")
            if self._compression_transform is not None:
                raise NotImplementedError(
                    "compression_training with host-stepped optimizer offload is "
                    "not supported: the grad-only step differentiates the raw "
                    "params and would silently skip the QAT/pruning transform")
            if self._frozen_mask is not None:
                raise NotImplementedError(
                    "model.frozen_spec does not compose with optimizer "
                    "offload yet (the host-stepped executor updates every "
                    "shard); drop the offload config or use the LoRA path "
                    "(runtime/lora.py) which keeps frozen weights out of "
                    "the optimizer entirely")
        return mode

    def _host_offload_state(self, master, params0) -> TrainState:
        """The masters (a tree on the host or the card: this rank's
        shards) handed to the host-stepped optimizer; the card keeps the
        compute params alone."""
        from .offload import HostSteppedOffload

        mode = self._offload_mode(True)
        paths = [p for p, _ in tree_flatten_with_path(master)]
        host = {}
        for path, x in zip(paths, tree_leaves(master)):
            host[path] = x.detach().to("cpu", torch.float32).numpy()
        del master
        self._offload = HostSteppedOffload(
            self.config, host, storage="cpu" if mode == "host_step" else "nvme",
            device=self.device, fp16_enabled=self.fp16_enabled)
        return TrainState(step=0, params=params0, master_params=None, opt_state=(),
                          scaler=self._scaler())

    def _shard_state(self, params, param_specs):
        """Plan the ZeRO placements of the full tree and keep this rank's
        fp32 master shards of ``params``, one leaf at a time (peak: the
        shards and one whole fp32 leaf)."""
        from .zero.partition import ZeroPartition
        from .zero.planner import plan_sharding

        zc = self.config.zero_config
        template = tree_map(lambda x: torch.empty(x.shape, dtype=_master_dtype(x),
                                                  device="meta"), params)
        # plan over the whole leaves; under tensor parallelism ``master``
        # holds this rank's model-axis shards of them
        shapes = template
        if self.tp:
            sizes = {"model": self.tp, "expert": self.ep, "pipe": self.pp}
            shapes = tree_map(lambda x, spec: torch.empty(
                _whole_shape(x.shape, spec, sizes), device="meta"),
                template, self._tp_specs)
        from ..parallel.mesh import ZERO_AXES

        hpz = zc.zero_hpz_partition_size > 1
        hier = zc.zero_hierarchical_dp_size > 1
        # hpZ: masters, optimizer state and gradients over the whole group,
        # the compute view over the inner one; hierarchical: all over both
        zero_axes = (ZERO_AXES + ("data_outer",) if hpz else
                     BATCH_AXES if hier else ZERO_AXES)
        self.plan = plan_sharding(shapes, self.zero_stage, self.mesh,
                                  tp_specs=param_specs,
                                  persistence_threshold=zc.stage3_param_persistence_threshold,
                                  zero_axes=zero_axes,
                                  param_zero_axes=ZERO_AXES if hpz else None)
        from .zero.zeropp import zeropp_settings

        zeropp = zeropp_settings(zc, self.use_master_weights, self.compute_dtype)
        frozen = (None if self._frozen_mask is None
                  else [bool(m) for m in tree_leaves(self._frozen_mask)])
        true_shapes = None
        if self._tp_shapes is not None:
            true_shapes = [tuple(x.shape) for x in tree_leaves(self._tp_shapes)]
        self.partition = ZeroPartition(
            self.plan, template, self.use_master_weights, self.accum_dtype,
            frozen=frozen, global_shapes=[tuple(x.shape) for x in tree_leaves(shapes)],
            true_shapes=true_shapes, zero_axes=ZERO_AXES if hpz else zero_axes,
            hpz=hpz, zeropp=zeropp)
        if zeropp is not None and self.partition.num_quantized_leaves == 0:
            log_dist("ZeRO++ enabled but no parameter is ZeRO-sharded (all "
                     "below stage3_param_persistence_threshold or indivisible) "
                     "— quantized collectives will not engage", ranks=[0])
        part, shards = self.partition, []
        for i, (x, d) in enumerate(zip(tree_leaves(params), part.mdims)):
            full = x.detach().to(self.device, _master_dtype(x), copy=True)
            shards.append(full if d is None else part.local_slice(full, d, i).clone())
            del full
        return tree_unflatten_like(template, shards)

    def _build_dataloader(self, training_data):
        """The loader, sampling through a curriculum sampler where the
        config asks for one (the JAX engine's rules and messages)."""
        if training_data is None:
            if self._curriculum_metric_path is not None:
                raise ValueError(
                    "a metric-driven curriculum samples THROUGH the engine "
                    "dataloader — pass training_data to initialize()")
            return None
        from .dataloader import DeepSpeedDataLoader

        rows = self.micro_batch_size * self.dp_world
        sampler = None
        ds_cfg = self.config.data_efficiency.data_sampling
        if ds_cfg.enabled and ds_cfg.curriculum_learning.enabled:
            if self._curriculum_metric_path is not None:
                raise ValueError(
                    "both the legacy curriculum_learning.metric_values_path "
                    "sampler and data_efficiency.data_sampling."
                    "curriculum_learning are configured — they would fight "
                    "over the batch stream; enable exactly one")
            from .data_pipeline.curriculum_scheduler import CurriculumScheduler
            from .data_pipeline.data_sampler import MultiMetricCurriculumSampler

            metrics = {}
            for name, mc in ds_cfg.curriculum_learning.curriculum_metrics.items():
                values = np.load(mc.metric_values_path)
                if len(values) != len(training_data):
                    raise ValueError(
                        f"curriculum metric {name!r} has {len(values)} "
                        f"values for a dataset of {len(training_data)} samples")
                metrics[name] = {
                    "values": values, "difficulty_type": mc.difficulty_type,
                    "clustering_type": mc.clustering_type,
                    "scheduler": CurriculumScheduler({
                        "curriculum_type": name, "min_difficulty": mc.min_difficulty,
                        "max_difficulty": mc.max_difficulty,
                        "schedule_type": mc.schedule_type,
                        "schedule_config": mc.schedule_config})}
            sampler = MultiMetricCurriculumSampler(metrics, batch_size=rows,
                                                   seed=self.config.seed)
        elif self._curriculum_metric_path is not None:
            from .data_pipeline.data_sampler import CurriculumBatchSampler

            values = np.load(self._curriculum_metric_path)
            if len(values) != len(training_data):
                raise ValueError(
                    f"curriculum metric file has {len(values)} values for a "
                    f"dataset of {len(training_data)} samples")
            sampler = CurriculumBatchSampler(values, batch_size=rows,
                                             curriculum=self.curriculum_scheduler,
                                             seed=self.config.seed)
        return DeepSpeedDataLoader(training_data, batch_size=rows, data_sampler=sampler)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------
    def _work_tree(self):
        """The tree a step differentiates: detached views of the compute
        params (so every backward matmul reads the bf16 weights), the
        frozen leaves not requiring a gradient."""
        leaves = tree_leaves(self.state.params)
        if self.partition is not None:
            leaves = self.partition.work_leaves(leaves, self._master_leaves())
        if self._compression_transform is not None:
            leaves = self._compressed(leaves)
        mask = (tree_leaves(self._frozen_mask) if self._frozen_mask is not None
                else [False] * len(leaves))
        return tree_unflatten_like(self.state.params, [
            p.detach() if m else p.detach().requires_grad_()
            for p, m in zip(leaves, mask)])

    def _compressed(self, leaves: list) -> list:
        """The compression transform of the compute leaves at this step
        (the JAX engine's ``compute_tree``: applied outside the gradient,
        which is then taken with respect to the transformed tree).  A leaf
        this rank holds a piece of (ZeRO-3, the 'model' axis) takes the
        operations' operands over the whole leaf, gathered, and applies
        them to its piece, so the statistics and thresholds are the whole
        leaf's."""
        from ..compression.compress import apply_op

        tf, part, step = self._compression_transform, self.partition, self.state.step
        paths = [p for p, _ in tree_flatten_with_path(self.state.params)]
        specs = part.placements("param") if part is not None else None
        out = []
        with torch.no_grad():
            for i, (path, x) in enumerate(zip(paths, leaves)):
                if not tf.touches(path, x.ndim):
                    out.append(x)
                elif part is None:
                    out.append(tf.apply_leaf(path, x, step))
                else:
                    spec = specs[i]
                    whole = part.whole_true(i, spec, x)
                    for op in tf.leaf_ops(path, whole, step):
                        pieces = tuple(self._piece_operand(i, spec, t, whole.shape,
                                                           scale=j == 0 and op[0] == "quant")
                                       for j, t in enumerate(op[-1]))
                        x = apply_op(op[:-1] + (pieces,), x)
                    out.append(x)
        return out

    def _piece_operand(self, i: int, spec, t, shape, scale: bool):
        """This rank's piece of an operand broadcast over the whole leaf
        (a per-tensor statistic broadcasts as it is; a quantization scale's
        padding is 1, so a padded zero weight stays 0)."""
        if t is None or t.numel() == 1:
            return t
        piece = self.partition.piece_of_true(i, spec, t.expand(shape))
        return torch.where(piece == 0, torch.ones_like(piece), piece) if scale else piece

    def _master_leaves(self):
        masters = self.state.master_params
        return tree_leaves(masters) if masters is not None else None

    def _view(self, work):
        """What the model reads: ``work`` itself, or at ZeRO-3 a tree that
        gathers each sharded leaf where it is read."""
        if self.partition is not None and any(p is not None
                                              for p in self.partition.pdims):
            work = self.partition.view(work, "param")
        if self._generic_tp:   # every leaf read now (gathered at stage 3)
            work = tensor_parallel.as_dtensors(
                tree_map(lambda x: x, work), self._tp_specs)
        return work

    def _local_rows(self, batch):
        """This rank's rows of a global (micro-)batch: rows
        ``[r*n, (r+1)*n)`` of each leaf, n = rows / dp_world."""
        if self.dp_world == 1:
            return batch, 0
        lead = tree_leaves(batch)[0].shape[0]
        if lead % self.dp_world:
            raise ValueError(f"a batch of {lead} rows does not split over "
                             f"{self.dp_world} data-parallel ranks")
        n = lead // self.dp_world
        lo = self.dp_rank * n
        return tree_map(lambda x: x[lo:lo + n], batch), lo

    def _micro_loss(self, work, one_batch, deterministic: bool = False):
        """(the objective this rank differentiates, the micro-batch's global
        loss), recording the graph.  One device: both are the loss.  Data-
        parallel: the objective is this rank's share of the global loss
        (its NLL sum over the global count of labelled tokens, or its mean
        over dp_world for a bare ``loss_fn``), so the gradients' sum over
        the ranks is the global gradient; the loss is that sum of shares.
        A rank of a 'seq' axis holds its slice of each row's tokens, and
        its NLL sum counts over the data axes and 'seq' alike."""
        from ..models.transformer import row_offset

        local, lo = self._local_rows(one_batch)
        if self.progressive_layer_drop is not None and not deterministic:
            local = self._with_pld_theta(local)
        if self.sp > 1:
            local = self.model.shard_sequence(local, self.sp_rank, self.sp)
        fn = self._eval_fn if deterministic else self.loss_fn
        with row_offset(lo), self._tp_region():
            if self.distributed and self._loss_terms is not None:
                total, count, *aux = self._loss_terms(self._view(work), local,
                                                      self.generator,
                                                      deterministic=deterministic)
                count = comm.all_reduce(count.detach(), comm.SUM, LOSS_AXES)
                obj = total / count.clamp(min=1)
                if aux:   # MoE: the mean of the data ranks' aux terms
                    obj = obj + aux[0] / self.dp_world
            else:
                if self._generic_tp:
                    local = tensor_parallel.as_dtensors(local)
                out = fn(self._view(work), local, self.generator)
                obj = out[0] if isinstance(out, tuple) else out
                if self._generic_tp:   # the loss, whole on every rank
                    obj = tensor_parallel.replicated(obj)
                if self.distributed:
                    obj = obj / self.dp_world
        if not self.distributed:
            return obj, obj.detach()
        return obj, comm.all_reduce(obj.detach(), comm.SUM, LOSS_AXES)

    def _with_pld_theta(self, batch):
        """The batch with the scheduled theta (``_inject_pld_theta`` of the
        JAX engine: one value a window) and the host generator the model
        draws its layer mask from."""
        if not isinstance(batch, dict):
            raise ValueError(
                "progressive_layer_drop needs dict batches ({'input_ids': ...})"
                " so the theta schedule can ride along as 'pld_theta'")
        theta = self.progressive_layer_drop.update_state(self.global_steps)
        return {**batch, "pld_theta": theta, "pld_generator": self.pld_generator}

    def _data_efficiency(self, global_batch):
        """A window's batch under the legacy seqlen curriculum (each leaf
        whose last dim is the sequence truncated to the difficulty of the
        coming step), and random-LTD's kept count for the step (the model
        variant swapped at a new count)."""
        if self._curriculum_seqlen:
            diff = self.curriculum_scheduler.update_difficulty(self.global_steps + 1)
            ref = (global_batch["input_ids"] if isinstance(global_batch, dict)
                   and "input_ids" in global_batch else tree_leaves(global_batch)[0])
            S = ref.shape[-1]
            global_batch = tree_map(lambda x: x[..., :diff]
                                    if x.ndim >= 3 and x.shape[-1] == S else x,
                                    global_batch)
        if self._random_ltd is not None:
            keep = self._random_ltd.update_seq(self.global_steps)
            if keep != self._ltd_keep:
                self._swap_ltd_variant(keep)
        return global_batch

    def _swap_ltd_variant(self, keep: int) -> None:
        """Point the loss at a model variant whose config keeps ``keep``
        tokens a layer (the whole sequence from ``max_seq_len`` on)."""
        self._ltd_keep = keep
        active = keep < self.model.config.max_seq_len
        variant = type(self.model)(
            self.model.config, attn_impl=getattr(self.model, "attn_impl", "auto"),
            random_ltd=active, random_ltd_keep=int(keep) if active else 0)
        self.loss_fn = variant.loss_fn
        if self._loss_terms is not None:
            self._loss_terms = variant.loss_terms
        log_dist(f"random-LTD: keep={keep} tokens/layer "
                 f"({'active' if active else 'full sequence'})", ranks=[0])

    def _micro_grads(self, work, loss):
        """Scaled gradients of ``loss`` w.r.t. the leaves of ``work``, zeros
        for the frozen ones (the reference's frozen parameters have no
        ``.grad`` at all)."""
        leaves = tree_leaves(work)
        live = [x for x in leaves if x.requires_grad]
        # the backward's remat recomputes run the model again: on its
        # tensor-parallel path, as the forward did
        with self._tp_region():
            grads = iter(torch.autograd.grad(scale_loss(loss, self.state.scaler), live))
        out = []
        for x in leaves:
            g = next(grads) if x.requires_grad else torch.zeros_like(x)
            if self.config.prescale_gradients:
                g = g / self.config.gradient_predivide_factor
            out.append(g)
        return self.partition.reduce_micro(out) if self.partition is not None else out

    def _bank(self, grads) -> None:
        """Add one micro-batch's gradients to the window's sums."""
        if self._accum_grads is None:
            self._accum_grads = [g.to(self.accum_dtype) for g in grads]
        else:
            self._accum_grads = [a + g.to(self.accum_dtype)
                                 for a, g in zip(self._accum_grads, grads)]

    def _leaf_axes(self, i: int) -> tuple:
        """The mesh axes leaf ``i``'s local piece is cut over: its ZeRO axes
        where this rank holds a shard of its master, and the model,
        expert and pipe axes its spec cuts it over."""
        part, axes = self.partition, ()
        if part is not None and part.mdims[i] is not None:
            axes += tuple(part.zaxes[i])
        if self.tp and self._tp_specs is not None:
            if self._leaf_specs is None:   # the specs in leaf order
                specs = []
                tree_map(lambda _, spec: specs.append(spec), self.state.params,
                         self._tp_specs)
                self._leaf_specs = specs
            sizes = {"model": self.tp, "expert": self.ep, "pipe": self.pp}
            axes += tuple(ax for ax, n in sizes.items() if n > 1 and
                          tensor_parallel.spec_dim(self._leaf_specs[i], ax) is not None)
        return axes

    def _leaf_reductions(self, leaves):
        """Around an update of ``leaves`` (indices into the masters, in the
        order of the tree being updated): a per-leaf transform's sums and
        maxes (LAMB's and 1-bit LAMB's norms) over the whole leaf where
        this rank holds a piece of it."""
        axes = [self._leaf_axes(i) for i in leaves]
        if not any(axes):
            return contextlib.nullcontext()
        from .fp16.onebit_lamb import leaf_reductions

        return leaf_reductions([
            (lambda x, a=a: comm.all_reduce(x, comm.SUM, a),
             lambda x, a=a: comm.all_reduce(x, comm.MAX, a)) if a else None
            for a in axes])

    def _reduce_window(self, g_leaves, eff_gas: int):
        """The window's local gradient sums -> the global sums at the
        masters' placement; after ``freeze_step`` of a 1-bit optimizer,
        the error-feedback compressed mean instead (its new errors kept in
        ``_pending_error`` until the step is known to apply)."""
        part, comp = self.partition, self._compression
        if comp is None or self.state.step < comp["freeze_step"]:
            return g_leaves if part is None else part.reduce_window(g_leaves)
        from .comm.compressed import compressed_grads

        inv = 1.0 / (float(self.state.scaler.loss_scale) * eff_gas)
        # this rank's share of the global mean times the ranks is its own
        # mean, the quantity the JAX engine exchanges
        out, self._pending_error = compressed_grads(
            [g * self.dp_world for g in g_leaves], self._comm_error, inv)
        if part is None:
            return out
        return [part.local_slice(g, part.mdims[i], i) for i, g in enumerate(out)]

    def _apply_update(self, grads, eff_gas: int):
        """Unscale, overflow check, optimizer on the masters, skip on
        overflow, scaler update, master -> compute cast."""
        if self._offload is not None:
            return self._apply_update_host(grads, eff_gas)
        if self._compression is not None and self._compression["algo"] == "zo":
            return self._apply_update_zero_one(grads, eff_gas)
        self._pending_error = None
        if self._leafwise:
            metrics = self._apply_update_leafwise(grads, eff_gas)
        else:
            metrics = self._apply_update_tree(grads, eff_gas)
        if self._pending_error is not None:
            # an overflowed step must not leave its inf residual behind
            if metrics["step_applied"]:
                self._comm_error = self._pending_error
            self._pending_error = None
        return metrics

    def _apply_update_zero_one(self, grads, eff_gas: int):
        """0/1 Adam's step (``comm/zero_one.py``) on this rank's drifted
        masters from its own unscaled gradients."""
        from .comm.zero_one import zero_one_step

        state = self.state
        inv = 1.0 / (float(state.scaler.loss_scale) * eff_gas)
        local = [g.to(torch.float32) * (self.dp_world * inv) for g in tree_leaves(grads)]
        del grads
        masters = state.master_params if self.use_master_weights else state.params
        new_p, self._comm_error, gnorm = zero_one_step(
            [x.float() for x in tree_leaves(masters)], local, self._comm_error,
            state.step, float(self.lr_schedule(state.step)),
            self._compression["hyper"])
        new_masters = tree_unflatten_like(masters, [
            p.to(x.dtype) for p, x in zip(new_p, tree_leaves(masters))])
        self.state = TrainState(
            step=state.step + 1,
            params=(_cast_tree(new_masters, self.compute_dtype)
                    if self.use_master_weights else new_masters),
            master_params=new_masters if self.use_master_weights else None,
            opt_state=(), scaler=state.scaler)
        return {"grad_norm": gnorm, "loss_scale": state.scaler.loss_scale,
                "step_applied": True}

    def _unscale_factor(self, eff_gas: int) -> float:
        """What unscales the window's summed gradients: 1 / (loss scale x
        gas), times the predivide factor where they were prescaled."""
        inv = 1.0 / (self.state.scaler.loss_scale * eff_gas)
        if self.config.prescale_gradients:
            inv = inv * self.config.gradient_predivide_factor
        return inv

    def _norm_of_squares(self, sq: list) -> torch.Tensor:
        """The global norm from each leaf's sum of squares, added in tree
        order (``global_norm``'s arithmetic), over the axes that shard the
        leaves."""
        if self.partition is not None:
            return self.partition.norm_of_squares(sq)
        total = sq[0]
        for x in sq[1:]:
            total = total + x
        return torch.sqrt(total)

    def _apply_update_tree(self, grads, eff_gas: int):
        state, part = self.state, self.partition
        grads = tree_unflatten_like(grads, self._reduce_window(tree_leaves(grads), eff_gas))
        inv = self._unscale_factor(eff_gas)
        # the unscaled gradient is fp32 (fp64 for fp64 leaves) whatever the
        # accumulation dtype, as bf16 * fp32-scalar promotes in the JAX step
        grads = tree_map(
            lambda g: g.to(torch.promote_types(g.dtype, torch.float32)) * inv, grads)
        if not self.fp16_enabled:
            finite = True
        else:   # every rank skips together
            finite = (grads_finite(grads) if part is None
                      else part.all_finite(tree_leaves(grads)))
        norm = global_norm if part is None else part.global_norm
        grad_norm = norm(grads)
        home = self._state_home   # the parked state comes onto the card ...
        host = (state.master_params if self.use_master_weights else state.params,
                state.opt_state)
        masters, opt_in = home.fetch(*host)
        home.ready()
        if finite:
            with (contextlib.nullcontext() if part is None
                  else sharded_norm(part.global_norm)), \
                    self._leaf_reductions(range(len(tree_leaves(masters)))):
                updates, new_opt = self.optimizer.update(grads, opt_in, masters)
            del grads
            new_masters = apply_updates(masters, updates)
            del updates
        else:   # overflow: skip (reference DynamicLossScaler semantics)
            new_masters, new_opt = masters, opt_in
        del masters, opt_in
        # ... and goes back to its home
        master_out, new_opt = home.put(host, (new_masters, new_opt))
        if self.use_master_weights:
            new_params = (_cast_tree(new_masters, self.compute_dtype) if part is None
                          else tree_unflatten_like(new_masters, part.compute_params(
                              tree_leaves(new_masters), self.compute_dtype)))
        else:
            new_params, master_out = master_out, None
        home.finish()
        self.state = TrainState(step=state.step + 1, params=new_params,
                                master_params=master_out, opt_state=new_opt,
                                scaler=update_scale(state.scaler, finite))
        return {"grad_norm": grad_norm, "loss_scale": state.scaler.loss_scale,
                "step_applied": finite}

    def _apply_update_leafwise(self, grads, eff_gas: int):
        """``_apply_update`` with the engine's own optimizer, a leaf at a
        time: every link of its chain is elementwise save clipping, which
        reads the global norm (taken first, in the same order, and handed
        to it through ``sharded_norm``), so the arithmetic is the tree-wide
        update's, bit for bit.  Each new master, moment and compute leaf
        replaces the old one as it is made, so the step holds one leaf's
        temporaries instead of whole trees of them (a model of 3.2B
        parameters otherwise outgrows an 80 GB card in its update)."""
        state, part = self.state, self.partition
        inv = self._unscale_factor(eff_gas)
        g_leaves = self._reduce_window(tree_leaves(grads), eff_gas)
        del grads

        def unscaled(g):
            return g.to(torch.promote_types(g.dtype, torch.float32)) * inv

        finite = True
        if self.fp16_enabled:   # every rank skips together
            bad = [(~torch.isfinite(unscaled(g))).any() for g in g_leaves]
            finite = (not bool(torch.stack(bad).any()) if part is None
                      else part.none_bad(bad))
        grad_norm = self._norm_of_squares([unscaled(g).square().sum() for g in g_leaves])
        masters = state.master_params if self.use_master_weights else state.params
        if finite:
            paths = [p for p, _ in tree_flatten_with_path(masters)]
            trees = _ParamTrees(paths)
            opt_state = state.opt_state
            new_state = opt_state
            home = self._state_home

            def fetch(i):   # leaf i's master and state, onto the card where parked
                host = (_leaf_at(masters, paths[i]), _state_leaf(opt_state, trees, i))
                return host, home.fetch(*host)

            nxt = fetch(0) if paths else None
            with sharded_norm(lambda _: grad_norm):
                for i, path in enumerate(paths):
                    host, (m, sub_in) = nxt
                    home.ready()
                    # the next leaf's copy runs under this leaf's update
                    nxt = fetch(i + 1) if i + 1 < len(paths) else None
                    with self._leaf_reductions([i]):
                        upd, sub = self.optimizer.update(
                            {"x": unscaled(g_leaves[i])}, sub_in, {"x": m})
                    g_leaves[i] = None
                    new = (m + upd["x"]).to(m.dtype)
                    # each old leaf goes as its new one is placed: one
                    # leaf's state and temporaries are live at a time
                    del sub_in, upd, m
                    placed = home.put(host, (new, sub))
                    del host, sub
                    new_state = _put_state_leaf(new_state, placed[1], trees, i)
                    _set_leaf(masters, path, placed[0])
                    del placed
                    if self.use_master_weights:
                        _set_leaf(state.params, path,
                                  _cast_tree(new, self.compute_dtype) if part is None
                                  else part.compute_param(i, new, self.compute_dtype))
                    del new
            home.finish()
            new_opt = new_state
        else:   # overflow: skip (reference DynamicLossScaler semantics)
            new_opt = state.opt_state
        self.state = TrainState(step=state.step + 1, params=state.params,
                                master_params=masters if self.use_master_weights else None,
                                opt_state=new_opt, scaler=update_scale(state.scaler, finite))
        return {"grad_norm": grad_norm, "loss_scale": state.scaler.loss_scale,
                "step_applied": finite}

    def _apply_update_host(self, grads, eff_gas: int):
        """The host-stepped offload's update (JAX's grad-only step and
        ``HostSteppedOffload.host_step``): the gradients unscaled by
        ``loss_scale * gas`` (and the predivide factor), clipped by their
        global norm on the card, then stepped by the host Adam a chunk at
        a time; the new bf16 params come back into the compute tree."""
        state, part = self.state, self.partition
        g_leaves = self._reduce_window(tree_leaves(grads), eff_gas)
        del grads
        inv = self._unscale_factor(eff_gas)

        def unscaled(g):
            return g.to(torch.float32) * inv

        grad_norm = self._norm_of_squares([unscaled(g).square().sum() for g in g_leaves])
        # JAX's host step clips by min(1, clip / (norm + 1e-6)), not the
        # device chain's select at the norm
        clip = self.config.gradient_clipping
        factor = (torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
                  if clip and clip > 0 else None)
        lr = float(self.lr_schedule(state.step))
        leaves = tree_leaves(state.params)
        outs, gathers = [], []
        for i, p in enumerate(leaves):
            if part is None or part.mdims[i] == part.rdims[i]:
                outs.append(p)
            else:   # the master's shard comes up, then is gathered
                outs.append(torch.empty(part.local_shape(i, part.mdims[i]),
                                        dtype=p.dtype, device=p.device))
                gathers.append(i)

        class _Grads:   # each leaf's fp32 gradient made when it goes down
            def __len__(self):
                return len(g_leaves)

            def __getitem__(self, i):
                g = unscaled(g_leaves[i])
                g_leaves[i] = None
                return g if factor is None else g * factor

        self._offload.host_step(_Grads(), outs, lr)
        if gathers:
            for i in gathers:
                leaves[i] = part.compute_param(i, outs[i], self.compute_dtype)
            state.params = tree_unflatten_like(state.params, leaves)
        self.state = TrainState(step=state.step + 1, params=state.params,
                                master_params=None, opt_state=(), scaler=state.scaler)
        return {"grad_norm": grad_norm, "loss_scale": state.scaler.loss_scale,
                "step_applied": True}

    def _finish_step(self, grads, losses, eff_gas: Optional[int] = None) -> dict:
        """Apply the window's gradients and do the step's bookkeeping (one
        path for ``train_batch`` and ``step``)."""
        metrics = self._apply_update(tree_unflatten_like(self.state.params, grads),
                                     eff_gas or self.gas)
        metrics["loss"] = torch.stack(losses).mean()
        self.global_steps += 1
        self._last_grad_norm = float(metrics["grad_norm"])
        if self.fp16_enabled and not metrics["step_applied"]:
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps}: grad overflow, step skipped; "
                     f"loss scale -> {self.state.scaler.loss_scale}", ranks=[0])
        self.tput_timer.stop()
        self._emit_monitor_events(metrics)
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                     f"lr={self.get_current_lr():.3e}, "
                     f"loss={float(metrics['loss']):.4f}, "
                     f"grad_norm={self._last_grad_norm:.3f}", ranks=[0])
        return metrics

    def _build_monitor(self):
        if not self.config.monitor_config.enabled:
            return None
        from ..monitor.monitor import MonitorMaster

        return MonitorMaster(self.config.monitor_config)

    def _emit_monitor_events(self, metrics) -> None:
        """The JAX engine's training events (the live ``train/tflops_est``
        and ``train/mfu_est`` gauges read per-program accounting, ROADMAP
        queue 1, item 12)."""
        if self.monitor is None:
            return
        events = [("Train/Samples/train_loss", float(metrics["loss"]), self.global_steps),
                  ("Train/Samples/lr", self.get_current_lr(), self.global_steps)]
        if self.fp16_enabled and "loss_scale" in metrics:
            events.append(("Train/Samples/loss_scale",
                           float(metrics["loss_scale"]), self.global_steps))
        if self.progressive_layer_drop is not None:
            events.append(("Train/Samples/pld_theta",
                           self.progressive_layer_drop.get_theta(), self.global_steps))
        self.monitor.write_events(events)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.asarray(x)).to(self.device)

    def _collect_global_batch(self, batch_or_iter):
        """Accept: a full global batch [train_batch, ...]; a [gas, mb, ...]
        pre-stacked batch; or an iterator yielding gas micro-batches."""
        if hasattr(batch_or_iter, "__next__"):
            micro = [tree_map(self._to_device, next(batch_or_iter))
                     for _ in range(self.gas)]
            return tree_map(lambda *xs: torch.stack(xs), micro[0], *micro[1:])
        batch = tree_map(self._to_device, batch_or_iter)
        lead = tree_leaves(batch)[0].shape[0]
        if lead == self.gas * self.micro_batch_size * self.dp_world:
            return tree_map(lambda x: x.reshape((self.gas, -1) + tuple(x.shape[1:])),
                            batch)
        if lead != self.gas:
            raise ValueError(
                f"batch leading dim {lead} is neither train_batch_size "
                f"({self.train_batch_size}) nor gas ({self.gas})")
        return batch

    def train_batch(self, data_iter=None, batch=None) -> torch.Tensor:
        """One full optimizer step over gas micro-batches; returns the mean
        loss (a device scalar)."""
        if batch is None:
            if data_iter is None:
                if self.training_dataloader is None:
                    raise ValueError("train_batch needs a batch, an iterator, or "
                                     "training_data at initialize()")
                if self._data_iterator is None:
                    from .dataloader import RepeatingLoader

                    self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
                data_iter = self._data_iterator
            batch = data_iter
        global_batch = self._collect_global_batch(batch)
        if self._accum_count or self._pending_loss is not None:
            raise RuntimeError("train_batch() inside an open forward/backward "
                               "window: call step() first")
        global_batch = self._data_efficiency(global_batch)
        self.tput_timer.start()
        if self._param_offload is not None:
            return self._train_batch_param_offload(global_batch)
        fp = self.config.flops_profiler
        if self.flops_profiler is not None and self.global_steps + 1 == fp.profile_step:
            self.flops_profiler.start_profile()
            try:
                loss = self._train_window(global_batch)
            finally:
                self.flops_profiler.stop_profile()
            self.flops_profiler.print_model_profile(
                profile_step=fp.profile_step, module_depth=fp.module_depth,
                top_modules=fp.top_modules, detailed=fp.detailed,
                output_file=fp.output_file)
            return loss
        return self._train_window(global_batch)

    def _train_window(self, global_batch) -> torch.Tensor:
        """The step's forward/backward over the window and its update."""
        if self.pipelined:
            return self._train_batch_pipelined(global_batch)
        work = self._work_tree()
        losses = []
        for i in range(self.gas):
            loss, report = self._micro_loss(work, tree_map(lambda x: x[i], global_batch))
            self._bank(self._micro_grads(work, loss))
            losses.append(report)
            del loss
        del work
        grads, self._accum_grads = self._accum_grads, None
        self.micro_steps += self.gas
        return self._finish_step(grads, losses)["loss"]

    def _train_batch_param_offload(self, global_batch) -> torch.Tensor:
        """ZeRO-Infinity's parameter offload: the layer-streamed executor
        owns the whole step (forward and backward a layer at a time, the
        host Adam over the NVMe state)."""
        local = tree_map(lambda x: torch.stack([self._local_rows(x[i])[0]
                                                for i in range(self.gas)]), global_batch)
        loss, metrics = self._param_offload.train_batch(local)
        if self.distributed:
            loss = comm.all_reduce(loss, comm.AVG, BATCH_AXES)
        self.global_steps += 1
        self.micro_steps += self.gas
        self._last_grad_norm = float(metrics["grad_norm"])
        self.tput_timer.stop()
        metrics["loss"] = loss
        self._emit_monitor_events(metrics)
        return loss

    def _train_batch_pipelined(self, global_batch) -> torch.Tensor:
        """A pipeline engine's step: the whole gas window in one call (the
        reference's ``PipelineEngine.train_batch``, pipe/engine.py:286),
        split into the model's microbatches and run through its stages
        (``runtime/pipe/executor.py``): every stage in this process at a
        'pipe' axis of 1, this rank's stage above it.  The objective
        already averages over the window, so the update divides by 1."""
        from .pipe.executor import AxisTransport, VirtualTransport

        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), global_batch)
        local, lo = self._local_rows(flat)
        work = self._work_tree()
        transport = (AxisTransport(self.device) if self.pp > 1 else VirtualTransport())
        stages = [self.pp_rank] if self.pp > 1 else None

        def reduce_count(count):
            return comm.all_reduce(count, comm.SUM, BATCH_AXES) if self.distributed \
                else count

        # each backward's gradient of a leaf summed at the accumulation
        # dtype, as the un-pipelined window banks each micro-batch's
        leaves = tree_leaves(work)
        acc: list = [None] * len(leaves)

        def bank(i):
            def hook(x):
                g = x.grad.to(self.accum_dtype)
                acc[i] = g if acc[i] is None else acc[i] + g
                x.grad = None
            return hook

        handles = [x.register_post_accumulate_grad_hook(bank(i))
                   for i, x in enumerate(leaves) if x.requires_grad]
        try:
            with self._tp_region():
                losses, aux = self.model.pipeline_backward(
                    self._view(work), local, self.generator,
                    loss_scale=float(self.state.scaler.loss_scale), transport=transport,
                    stages=stages, reduce_count=reduce_count, aux_ranks=self.dp_world,
                    row0=lo)
        finally:
            for h in handles:
                h.remove()
        grads = []
        for x, g in zip(leaves, acc):
            g = g if g is not None else torch.zeros_like(x, dtype=self.accum_dtype)
            if self.config.prescale_gradients:
                g = g / self.config.gradient_predivide_factor
            grads.append(g)
        del work, leaves, acc
        if self.partition is not None:
            grads = self.partition.reduce_micro(grads)
        self._bank(grads)
        grads, self._accum_grads = self._accum_grads, None
        report = sum(losses.values(), torch.zeros((), device=self.device, dtype=torch.float32))
        if aux is not None:
            report = report + aux
        if self.distributed:
            report = comm.all_reduce(report, comm.SUM, LOSS_AXES + ("pipe",))
        self.micro_steps += self.gas
        return self._finish_step(grads, [report], eff_gas=1)["loss"]

    def eval_batch(self, batch) -> torch.Tensor:
        """Loss of one (global) micro-batch with dropout off, no gradient."""
        if self._param_offload is not None:   # the same layer stream, forward only
            return self._param_offload.eval_batch(
                self._local_rows(tree_map(self._to_device, batch))[0])
        with torch.no_grad():
            params = tree_leaves(self.state.params)
            if self.partition is not None:
                params = self.partition.work_leaves(params, self._master_leaves())
            if self._compression_transform is not None:
                # the same quantized/pruned view training optimizes, or
                # validation metrics overstate the compressed model
                params = self._compressed(params)
            return self._micro_loss(tree_unflatten_like(self.state.params, params),
                                    tree_map(self._to_device, batch),
                                    deterministic=True)[1]

    def compute_eigenvalue(self, batch, generator: Optional[torch.Generator] = None,
                           v0=None):
        """The Hessian's largest eigenvalue and the per-leaf Rayleigh
        quotients at the current compute weights (``runtime/eigenvalue.py``,
        the ``eigenvalue`` block's knobs), on the training loss of one
        micro-batch with the dropout stream ``generator`` (seed 0 when
        None).  ``v0``: the power iteration's starting vector."""
        from .eigenvalue import Eigenvalue

        if self.state is None or self.distributed or self.pipelined:
            raise NotImplementedError(
                "compute_eigenvalue runs on a one-device engine in the port (a "
                "sharded, pipelined or param-offloaded tree is not ported)")
        ec = self.config.eigenvalue
        est = getattr(self, "_eigenvalue_estimator", None)
        if est is None:
            est = self._eigenvalue_estimator = Eigenvalue(
                verbose=ec.verbose, max_iter=ec.max_iter, tol=ec.tol,
                stability=ec.stability)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        return est.compute_eigenvalue(self.loss_fn, self.state.params,
                                      tree_map(self._to_device, batch), generator, v0=v0)

    def _refuse_pipeline(self):
        if self.pipelined:
            raise RuntimeError("pipeline engines train with train_batch(); "
                               "per-microbatch forward/backward is not exposed "
                               "(reference PipelineEngine restriction)")
        if self._param_offload is not None:
            raise RuntimeError(
                "offload_param engines train with train_batch() (the layer-"
                "streamed executor owns the fwd/bwd schedule)")
        if self._compression is not None:
            raise NotImplementedError(
                "1-bit optimizers run through train_batch() (the compressed "
                "exchange spans the whole accumulation window)")

    def forward(self, batch):
        """The micro-batch's loss (one micro-batch: ``[micro_batch, ...]``),
        recording the graph its ``backward()`` differentiates."""
        self._refuse_pipeline()
        if self._pending_loss is not None:
            raise RuntimeError("forward() twice without a backward() between")
        if self._accum_count >= self.gas:
            raise RuntimeError(
                f"forward() beyond the accumulation window: {self._accum_count} "
                f"micro-batches already banked with gas={self.gas}; call step()")
        if self._accum_count == 0:
            self.tput_timer.start()
            self._work = self._work_tree()
        loss, report = self._micro_loss(self._work, tree_map(self._to_device, batch))
        self._pending_loss, self._pending_report = loss, report
        # data-parallel: the micro-batch's global loss (backward()
        # differentiates this rank's share of it)
        return report if self.distributed else loss

    def backward(self, loss=None):
        """Bank the gradients of the matching ``forward()``'s loss (``loss``
        is accepted for the reference's signature; the engine scales and
        differentiates the loss its forward returned)."""
        self._refuse_pipeline()
        if self._pending_loss is None:
            raise RuntimeError("backward() without a preceding forward()")
        pending, self._pending_loss = self._pending_loss, None
        self._bank(self._micro_grads(self._work, pending))
        self._window_losses.append(self._pending_report)
        self._accum_count += 1
        self.micro_steps += 1
        return loss

    def step(self):
        """Apply the update at the gradient-accumulation boundary; a
        mid-window ``step()`` is a no-op returning None (the reference skips
        until the boundary).  Returns the step's metrics."""
        self._refuse_pipeline()
        if self._pending_loss is not None:
            raise RuntimeError("step() with a forward() missing its backward()")
        if self._accum_count == 0:
            raise RuntimeError("step() with no accumulated gradients")
        if self._accum_count < self.gas:
            return None
        grads, losses = self._accum_grads, self._window_losses
        self._accum_grads, self._window_losses, self._work = None, [], None
        self._accum_count = 0
        return self._finish_step(grads, losses)

    def is_gradient_accumulation_boundary(self) -> bool:
        """True while the banked micro-batches fill the window, i.e. the
        next ``step()`` applies the update."""
        return self._accum_count > 0 and self._accum_count % self.gas == 0

    def get_lr(self) -> list:
        """Current learning rate(s), one per param group (one group here)."""
        return [self.get_current_lr()]

    def get_current_lr(self) -> float:
        step = (self._param_offload.step_count if self._param_offload is not None
                else self.state.step)
        return float(self.lr_schedule(step))

    @property
    def loss_scale(self) -> float:
        return float(self.state.scaler.loss_scale)

    def get_global_grad_norm(self) -> Optional[float]:
        """Global gradient norm of the most recent optimizer step (None until
        the first step completes)."""
        return self._last_grad_norm

    @property
    def module(self):
        return self.get_params()

    def get_params(self, fp32: bool = False):
        """The compute params (``fp32``: the masters, when kept).  Data-
        parallel: a ``ShardedParams`` over this rank's shards, whose leaves
        are the full tensors, gathered when read (collective: every rank
        reads them in the same order); ``zero.GatheredParameters`` takes
        it as is.  Under tensor parallelism the leaves are this rank's
        model-axis shards (padded where uneven): :meth:`full_params` gives
        the whole tree."""
        if self.state is None:
            raise NotImplementedError(
                "offload_param engines hold no device param tree; use "
                "engine._param_offload.read_masters() for the fp32 leaves")
        if fp32 and self.state.master_params is not None:
            tree, which = self.state.master_params, "master"
        else:
            tree, which = self.state.params, "rest"
        return tree if self.partition is None else self.partition.view(tree, which)

    def full_params(self, fp32: bool = False):
        """The whole parameter tree at its true shapes on every rank: the
        ZeRO shards and the model-axis shards gathered, padding cut
        (collective: every rank calls it)."""
        from ..zero import GatheredParameters

        tree = self.get_params(fp32)
        if self.partition is not None:
            with GatheredParameters(tree, to_device=True) as g:
                tree = g.values
        if self.tp:
            tree = tensor_parallel.gather_tree(tree, self._tp_specs, self._tp_shapes)
            for axis in self._cuts():
                tree = tensor_parallel.gather_tree(tree, self._tp_specs, axis=axis)
        return tree

    # ------------------------------------------------------------------
    # Checkpointing (reference engine.py:2593-3365): checkpoint_engine/
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Save the whole training state under ``save_dir/<tag>`` (default
        tag ``global_step{N}``) and point ``save_dir/latest`` at it.  With
        ``checkpoint.async_save`` the call returns after the device->host
        snapshot and ``latest`` moves once the write is durable
        (``wait_for_checkpoint``).  Returns the tag's directory."""
        from .checkpoint_engine.dcp_engine import save_engine_checkpoint

        return save_engine_checkpoint(self, save_dir, tag=tag,
                                      client_state=client_state,
                                      save_latest=save_latest)

    def wait_for_checkpoint(self):
        """Block until an in-flight async save is durable and ``latest`` is
        published; re-raises a failed save.  No-op otherwise."""
        from .checkpoint_engine.async_engine import wait_for_pending_checkpoint

        return wait_for_pending_checkpoint(self)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False):
        """Restore a tag (default: the one ``latest`` names) into this
        engine's state, in place.  ``load_module_only`` restores the weights
        only; ``load_optimizer_states=False`` keeps this engine's optimizer
        state.  Returns ``(tag_dir, client_state)``, or ``(None, {})`` when
        there is no ``latest``.  (The schedule is a function of the step,
        so ``load_lr_scheduler_states`` has nothing of its own to load.)"""
        from .checkpoint_engine.dcp_engine import load_engine_checkpoint

        return load_engine_checkpoint(
            self, load_dir, tag=tag, load_optimizer_states=load_optimizer_states,
            load_module_only=load_module_only)
