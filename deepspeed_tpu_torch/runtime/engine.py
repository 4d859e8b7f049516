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
    ``data_types.grad_accum_dtype``;
  - the update: unscale by ``loss_scale * gas`` -> finiteness check (fp16)
    -> global norm -> the optimizer chain on the fp32 masters -> skip on
    overflow -> recast the compute params.

World size is 1: ZeRO stages 0-3 are one computation here.  Not ported yet,
each raising ``NotImplementedError`` with its ROADMAP item: a mesh over
more than one device and ZeRO sharding (queue 1 item 4), the
``forward``/``backward``/``step`` loop (item 3), checkpointing (item 5),
offload, 1-bit and ZeRO++ (item 10), frozen parameters (item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..utils.logging import log_dist
from ..utils.timer import ThroughputTimer
from ..utils.tree import tree_leaves, tree_map, tree_unflatten_like
from .config import DeepSpeedConfig
from .fp16.loss_scaler import (LossScaleState, dynamic_loss_scale_state,
                               grads_finite, no_loss_scale_state, scale_loss,
                               static_loss_scale_state, update_scale)
from .lr_schedules import constant_lr, get_lr_scheduler
from .optimizer import (GradientTransformation, apply_updates, create_optimizer,
                        global_norm)


@dataclasses.dataclass
class TrainState:
    """Everything one step reads and writes."""

    step: int                         # global step
    params: Any                       # compute-precision params (fwd/bwd view)
    master_params: Any                # fp32 masters (None when compute is fp32)
    opt_state: Any
    scaler: LossScaleState


def _cast_tree(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


class DeepSpeedEngine:
    def __init__(self, model: Any = None, loss_fn: Optional[Callable] = None,
                 init_fn: Optional[Callable] = None, params: Any = None,
                 config: Any = None,
                 optimizer: Optional[GradientTransformation] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 training_data: Any = None, device=None):
        # -- model contract resolution --
        self.model = model
        self._eval_fn = None
        if model is not None and loss_fn is None:
            loss_fn = getattr(model, "loss_fn", None)
            init_fn = init_fn or getattr(model, "init_fn", None)
            self._eval_fn = getattr(model, "eval_fn", None)
        if loss_fn is None:
            raise ValueError("engine needs loss_fn(params, batch, generator) "
                             "(directly or via model)")
        if init_fn is None and params is None:
            raise ValueError("engine needs init_fn(generator)->params or "
                             "explicit params")
        if getattr(getattr(model, "config", None), "frozen_keywords", ()):
            raise _unported("frozen parameters (config.frozen_keywords)", 3)
        self.loss_fn = loss_fn
        self._eval_fn = self._eval_fn or loss_fn

        # -- config: one device, so dp_world = 1 --
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config))
        self.dp_world = 1
        self.config.resolve_batch_triad(self.dp_world)
        self.device = resolve_device(device)
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

        # -- optimizer --
        if optimizer is not None:
            self.optimizer = optimizer
        else:
            opt_cfg = self.config.optimizer
            self.optimizer = create_optimizer(
                opt_cfg.type if opt_cfg else "adamw",
                dict(opt_cfg.params) if opt_cfg else {}, self.lr_schedule,
                self.config.gradient_clipping)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)
        self.state = self._init_state(init_fn, params)
        self.param_count = sum(x.numel() for x in tree_leaves(self.state.params))

        # -- bookkeeping --
        self.global_steps = 0
        self.skipped_steps = 0
        self.micro_steps = 0
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size,
                                          steps_per_output=self.config.steps_per_print)
        self._last_grad_norm: Optional[float] = None
        self._data_iterator = None
        self.training_dataloader = self._build_dataloader(training_data)
        log_dist(
            f"engine ready: params={self.param_count:,} zero_stage={self.zero_stage} "
            f"dtype={self.compute_dtype} device={self.device} "
            f"batch={self.train_batch_size} (micro={self.micro_batch_size} "
            f"gas={self.gas} dp={self.dp_world})", ranks=[0])

    def _init_state(self, init_fn, params) -> TrainState:
        """fp32 masters from ``params`` or ``init_fn(generator)``, the
        compute-precision view, the optimizer state and the loss scaler."""
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(self.config.seed)
            params = init_fn(init_gen)
        # masters are fresh fp32 copies: the caller's tree is never aliased
        master = tree_map(lambda x: x.detach().to(self.device, torch.float32,
                                                  copy=True), params)
        if self.use_master_weights:
            params0 = _cast_tree(master, self.compute_dtype)
        else:
            params0, master = master, None
        opt_state = self.optimizer.init(master if master is not None else params0)
        if self.fp16_enabled:
            f16 = self.config.fp16
            scaler = (static_loss_scale_state(f16.loss_scale) if f16.loss_scale > 0
                      else dynamic_loss_scale_state(
                          f16.initial_scale_power, f16.loss_scale_window,
                          f16.min_loss_scale, f16.hysteresis))
        else:
            scaler = no_loss_scale_state()
        return TrainState(step=0, params=params0, master_params=master,
                          opt_state=opt_state, scaler=scaler)

    def _build_dataloader(self, training_data):
        if training_data is None:
            return None
        from .dataloader import DeepSpeedDataLoader

        return DeepSpeedDataLoader(training_data,
                                   batch_size=self.micro_batch_size * self.dp_world)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------
    def _grad_of_batch(self, work, one_batch):
        """(scaled grads of ``loss * loss_scale`` w.r.t. the leaves of
        ``work``, unscaled loss)."""
        leaves = tree_leaves(work)
        loss = self.loss_fn(work, one_batch, self.generator)
        loss = loss[0] if isinstance(loss, tuple) else loss
        grads = torch.autograd.grad(scale_loss(loss, self.state.scaler), leaves)
        if self.config.prescale_gradients:
            grads = [g / self.config.gradient_predivide_factor for g in grads]
        return grads, loss.detach()

    def _apply_update(self, grads, eff_gas: int):
        """Unscale, overflow check, optimizer on the masters, skip on
        overflow, scaler update, master -> compute cast."""
        state = self.state
        inv = 1.0 / (state.scaler.loss_scale * eff_gas)
        if self.config.prescale_gradients:
            inv = inv * self.config.gradient_predivide_factor
        # the unscaled gradient is fp32 whatever the accumulation dtype, as
        # bf16 * fp32-scalar promotes in the JAX step
        grads = tree_map(lambda g: g.float() * inv, grads)
        finite = grads_finite(grads) if self.fp16_enabled else True
        grad_norm = global_norm(grads)
        masters = state.master_params if self.use_master_weights else state.params
        if finite:
            updates, new_opt = self.optimizer.update(grads, state.opt_state, masters)
            del grads
            new_masters = apply_updates(masters, updates)
            del updates
        else:   # overflow: skip (reference DynamicLossScaler semantics)
            new_masters, new_opt = masters, state.opt_state
        if self.use_master_weights:
            new_params, new_master_out = _cast_tree(new_masters,
                                                    self.compute_dtype), new_masters
        else:
            new_params, new_master_out = new_masters, None
        self.state = TrainState(step=state.step + 1, params=new_params,
                                master_params=new_master_out, opt_state=new_opt,
                                scaler=update_scale(state.scaler, finite))
        return {"grad_norm": grad_norm, "loss_scale": state.scaler.loss_scale,
                "step_applied": finite}

    def _train_step(self, global_batch):
        # differentiate w.r.t. the compute tree itself: detached views of the
        # bf16 params, so every backward matmul reads bf16 weights
        work = tree_map(lambda p: p.detach().requires_grad_(), self.state.params)
        acc, losses = None, []
        for i in range(self.gas):
            grads, loss = self._grad_of_batch(
                work, tree_map(lambda x: x[i], global_batch))
            losses.append(loss)
            if acc is None:
                acc = [g.to(self.accum_dtype) for g in grads]
            else:
                acc = [a + g.to(self.accum_dtype) for a, g in zip(acc, grads)]
            del grads
        del work
        metrics = self._apply_update(tree_unflatten_like(self.state.params, acc),
                                     self.gas)
        metrics["loss"] = torch.stack(losses).mean()
        return metrics

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
        self.tput_timer.start()
        metrics = self._train_step(global_batch)
        self.global_steps += 1
        self.micro_steps += self.gas
        self._last_grad_norm = float(metrics["grad_norm"])
        if self.fp16_enabled and not metrics["step_applied"]:
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps}: grad overflow, step skipped; "
                     f"loss scale -> {self.state.scaler.loss_scale}", ranks=[0])
        self.tput_timer.stop()
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                     f"lr={self.get_current_lr():.3e}, "
                     f"loss={float(metrics['loss']):.4f}, "
                     f"grad_norm={self._last_grad_norm:.3f}", ranks=[0])
        return metrics["loss"]

    def eval_batch(self, batch) -> torch.Tensor:
        """Loss of one micro-batch with dropout off, no gradient."""
        with torch.no_grad():
            out = self._eval_fn(self.state.params, tree_map(self._to_device, batch),
                                self.generator)
        return out[0] if isinstance(out, tuple) else out

    def forward(self, batch):
        raise _unported("the forward/backward/step loop (use train_batch)", 3)

    def backward(self, loss=None):
        raise _unported("the forward/backward/step loop (use train_batch)", 3)

    def step(self):
        raise _unported("the forward/backward/step loop (use train_batch)", 3)

    def get_lr(self) -> list:
        """Current learning rate(s), one per param group (one group here)."""
        return [self.get_current_lr()]

    def get_current_lr(self) -> float:
        return float(self.lr_schedule(self.state.step))

    @property
    def loss_scale(self) -> float:
        return float(self.state.scaler.loss_scale)

    def get_global_grad_norm(self) -> Optional[float]:
        """Global gradient norm of the most recent optimizer step (None until
        the first step completes)."""
        return self._last_grad_norm

    @property
    def module(self):
        return self.state.params

    def get_params(self, fp32: bool = False):
        if fp32 and self.state.master_params is not None:
            return self.state.master_params
        return self.state.params

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        raise _unported("checkpointing", 5)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False):
        raise _unported("checkpointing", 5)
