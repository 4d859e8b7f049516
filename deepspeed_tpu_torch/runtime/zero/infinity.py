"""ZeRO-Infinity parameter offload: the layer-streamed executor
(counterpart of ``deepspeed_tpu/runtime/zero/infinity.py``; reference
``runtime/swap_tensor/partitioned_param_swapper.py:36`` and
``runtime/zero/stage3.py:502-536``).

The reference swaps each submodule's parameters in and out around its
forward and backward with autograd hooks; here, as in the JAX package,
the executor is the schedule:

  - the bf16 parameters live in per-layer NVMe files (the aio engine);
    the stem (embedding) and the head (final norm, LM head) stay resident
    on the card, as the reference keeps small hot parameters;
  - the step is a Python loop over the layers: the forward reads layer
    i+1's file while layer i computes and keeps only the [B, S, d]
    boundary activations;
  - the backward runs the layers in reverse, each recomputed under
    ``torch.autograd`` from its saved input (a per-layer remat; the
    counterpart of ``jax.vjp`` of the layer at the JAX file's :433-447),
    giving the layer's parameter gradients and its input's;
  - the gradients accumulate in host fp32; the host SIMD Adam then
    streams each leaf's master and moments from NVMe, steps them and
    writes them back with the new bf16 parameter file.

The card holds one layer's parameters and gradients and the boundary
activations; host RAM the fp32 gradients (4 B/param); NVMe the masters,
the moments and the bf16 parameters (14 B/param).  The layers run the
model's own block (``models/transformer.py``), with the flash kernels
wherever the model's ``attn_impl`` takes them.  The JAX package's
preconditions: a ``CausalLM`` of uniform layers, bf16, stage 3 and an
``nvme_path`` (the config checks those), no PR-MoE pyramid, no pipeline
stages, no fp16, no random-LTD or progressive layer drop.

Above one data rank each leaf is ZeRO-3 partitioned over the data axes
(the planner's dim rule: the largest dim the ranks divide; a leaf no dim
divides stays whole on every rank): each rank's files
(``nvme_path/rank<r>``) hold its own shard of the master, the moments and
the bf16 parameter, as the JAX package stores each process's own shards
(its ``_leaf_shards``).  The layer loop gathers each layer's shards over
the data axes before it computes (and the stem and head after each
step); each micro-batch's gradients are reduce-scattered to the rank's
shards at once, so the host fp32 gradients and the host Adam cover only
them, and NVMe and host RAM per rank fall as 1/dp.  The gradient norm
counts each distinct shard once (a whole leaf each rank holds weighs
1/dp, JAX's ``weights``).
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import comm
from ...ops.adam.cpu_adam import DeepSpeedCPUAdam
from ...parallel.mesh import BATCH_AXES
from ...utils.logging import log_dist
from .planner import _shard_dim_for
from ..swap_tensor.partitioned_optimizer_swapper import TensorSwapper, aligned_empty

STEM_KEYS = ("embed", "pos_embed", "type_embed", "embed_norm_scale", "embed_norm_bias")
HEAD_KEYS = ("final_norm_scale", "final_norm_bias", "lm_head", "lm_head_bias")


def _bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bits as uint16 numpy (on the host)."""
    return t.detach().to("cpu").contiguous().view(torch.int16).numpy().view(np.uint16)


class InfinityParamEngine:
    """The NVMe-resident parameters and optimizer state, and the
    layer-streamed train step (``engine.train_batch`` delegates here when
    ``zero_optimization.offload_param.device == "nvme"``)."""

    STATES = ("master", "exp_avg", "exp_avg_sq")

    def __init__(self, config, model, lr_schedule, device: torch.device,
                 generator: torch.Generator):
        cfg = getattr(model, "config", None)
        if cfg is None or not hasattr(cfg, "num_layers") or not hasattr(model, "init_fn"):
            raise NotImplementedError(
                "offload_param needs the native transformer family "
                "(deepspeed_tpu_torch.models.CausalLM): the layer-streamed "
                "executor must know the model's layer structure")
        from ...models.transformer import has_moe

        if isinstance(cfg.num_experts, (tuple, list)):
            raise NotImplementedError(
                "offload_param with a PR-MoE pyramid (per-layer expert "
                "counts) is not supported: the layer stream needs uniform "
                "layer files")
        self._moe = has_moe(cfg)
        if getattr(cfg, "pipeline_stages", 1) > 1:
            raise NotImplementedError(
                "offload_param composes with pipeline_stages=1 (a pipelined "
                "stage already holds only its own layers)")
        if getattr(cfg, "random_ltd", False):
            raise NotImplementedError("offload_param + random_ltd: unsupported")
        if config.fp16.enabled:
            raise NotImplementedError(
                "offload_param pairs with bf16 (fp16 overflow handling would "
                "need host-side loss-scale bookkeeping)")
        if config.precision != torch.bfloat16:
            raise ValueError("offload_param requires bf16 compute (fp32 "
                             "params have no compact streaming format)")
        if not getattr(cfg, "causal", True) or getattr(cfg, "type_vocab_size", 0):
            raise NotImplementedError(
                "offload_param trains causal LMs (encoder models have no "
                "next-token loss for the layer-streamed executor)")
        from ...utils.numa import bind_for_offload

        bind_for_offload()
        opt_cfg = config.optimizer
        opt_type = (opt_cfg.type if opt_cfg else "adamw").lower()
        if opt_type not in ("adam", "adamw"):
            raise NotImplementedError(
                f"offload_param runs the native CPU Adam on the host; "
                f"optimizer {opt_type!r} is not supported")
        from ..offload import adam_kwargs

        self.cfg, self.model, self.config = cfg, model, config
        self.device, self.generator = device, generator
        self.lr_schedule = lr_schedule
        self.gas = config.gradient_accumulation_steps
        self.clip = config.gradient_clipping
        self.attn_impl = getattr(model, "attn_impl", "auto")
        self.step_count = 0
        self.adam = DeepSpeedCPUAdam(**adam_kwargs(config))
        p = dict(opt_cfg.params) if opt_cfg else {}
        # moment store dtypes (the at-rest format; the host Adam steps fp32)
        self._mu16 = str(p.get("mu_dtype", "")).lower() in ("bfloat16", "bf16")
        self._nu16 = str(p.get("nu_dtype", "")).lower() in ("bfloat16", "bf16")
        self._dp = comm.get_axis_size(BATCH_AXES) if comm.is_initialized() else 1
        self._dp_rank = comm.axis_index(BATCH_AXES) if self._dp > 1 else 0
        nvme = config.zero_config.offload_param.nvme_path
        if self._dp > 1:   # each rank's files in its own directory
            nvme = os.path.join(nvme, f"rank{comm.get_rank()}")
        self.swapper = TensorSwapper(nvme, aio_threads=max(config.aio.thread_count, 1))
        self.stats: Dict[str, float] = {}
        self._init_param_store(config.seed)
        total = self.param_count
        opt_bytes = 4 + (2 if self._mu16 else 4) + (2 if self._nu16 else 4)
        log_dist(f"ZeRO-Infinity param offload: {total:,} params "
                 f"({total * 2 / 1e9:.2f} GB bf16) + optimizer state "
                 f"({total * opt_bytes / 1e9:.2f} GB) on NVMe at {nvme}; the "
                 f"card holds 1/{cfg.num_layers} of the layer stack at a time",
                 ranks=[0])

    # ------------------------------------------------------------------
    # The store: the seed's weights, a file per leaf (and per layer)
    # ------------------------------------------------------------------
    def _init_param_store(self, seed: int) -> None:
        # the device engine's draw (the same generator on the same device),
        # so one seed names the same weights with and without offload
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self.model.init_fn(gen)
        L = self.cfg.num_layers
        self.num_layers = L
        self.layer_keys: List[str] = sorted(params["layers"].keys())
        self.stem_keys = [k for k in STEM_KEYS if k in params]
        self.head_keys = [k for k in HEAD_KEYS if k in params]
        unclaimed = set(params) - set(self.stem_keys) - set(self.head_keys) - {"layers"}
        if unclaimed:
            raise NotImplementedError(
                f"offload_param: unhandled top-level param leaves "
                f"{sorted(unclaimed)} — the layer-streamed executor does not "
                "know where they belong")
        self._layer_shapes = {k: tuple(params["layers"][k].shape[1:])
                              for k in self.layer_keys}
        # the ZeRO-3 dim of each leaf (None: whole on every rank), by the
        # leaf's shape (a layer's leaves by their per-layer shape)
        self.shard_dims: Dict[str, Optional[int]] = {}
        for k in self.stem_keys + self.head_keys:
            self.shard_dims[k] = self._dim_of(tuple(params[k].shape))
        for k in self.layer_keys:
            self.shard_dims[k] = self._dim_of(self._layer_shapes[k])
        self.param_count = sum(x.numel() for k, x in params.items() if k != "layers") \
            + sum(x.numel() for x in params["layers"].values())
        self._leaf_names: List[str] = []
        self._stem_dev: Dict[str, torch.Tensor] = {}
        self._head_dev: Dict[str, torch.Tensor] = {}
        for k in self.stem_keys + self.head_keys:
            dev16 = self._put(k, params.pop(k))
            (self._stem_dev if k in self.stem_keys else self._head_dev)[k] = dev16
        layers = params.pop("layers")
        for i in range(L):
            for k in self.layer_keys:
                self._put(f"layers.{i}.{k}", layers[k][i])
        del layers
        # double-buffered host buffers of the layer stream (this rank's shards)
        self._layer_bufs = [{k: aligned_empty(self._local_shape(k, self._layer_shapes[k]),
                                              np.uint16)
                             for k in self.layer_keys} for _ in range(2)]
        self._host_grads: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    # ZeRO-3 over the data axes
    # ------------------------------------------------------------------
    def _dim_of(self, shape) -> Optional[int]:
        if self._dp == 1:
            return None
        return _shard_dim_for(shape, (), {}, self._dp, frozenset())

    @staticmethod
    def _key(name: str) -> str:
        """The leaf key of a store name ('layers.3.wq' -> 'wq')."""
        return name.split(".", 2)[2] if name.startswith("layers.") else name

    def _local_shape(self, key: str, shape) -> tuple:
        d = self.shard_dims[key]
        if d is None:
            return tuple(shape)
        return tuple(n // self._dp if i == d else n for i, n in enumerate(shape))

    def _local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole leaf."""
        d = self.shard_dims[self._key(name)]
        return x if d is None else x.chunk(self._dp, dim=d)[self._dp_rank]

    def _gather(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """A whole bf16 leaf from the ranks' shards (gloo carries no bf16:
        there the shards travel as fp32, which holds them exactly)."""
        d = self.shard_dims[key]
        if d is None:
            return x
        wire = x if x.is_cuda else x.float()
        return comm.all_gather(wire, BATCH_AXES, gather_dim=d).to(torch.bfloat16)

    def _reduce_grad(self, key: str, g: torch.Tensor) -> torch.Tensor:
        """A micro-batch's whole fp32 gradient -> the data ranks' mean,
        this rank's shard of it."""
        g = g.to(torch.float32)
        if self._dp == 1:
            return g
        d = self.shard_dims[key]
        if d is None:
            return comm.all_reduce(g, comm.AVG, BATCH_AXES)
        return comm.reduce_scatter(g, BATCH_AXES, scatter_dim=d) / self._dp

    def _put(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Write this rank's shard of leaf ``name``: the fp32 master, zero
        moments (at their store dtype) and the bf16 parameter; returns the
        whole bf16 parameter on the card."""
        whole16 = x.detach().to(torch.bfloat16)
        x = self._local(name, x)
        master = x.detach().to("cpu", torch.float32).contiguous().numpy()
        self.swapper.write(f"{name}.master", master)
        zeros = np.zeros_like(master)
        self.swapper.write(f"{name}.exp_avg", self._store(zeros, self._mu16))
        self.swapper.write(f"{name}.exp_avg_sq", self._store(zeros, self._nu16))
        self.swapper.write(f"{name}.param", _bits(x.detach().to(torch.bfloat16)))
        self._leaf_names.append(name)
        return whole16.to(self.device)

    @staticmethod
    def _store(x32: np.ndarray, half: bool) -> np.ndarray:
        return _bits(torch.from_numpy(x32).to(torch.bfloat16)) if half else x32

    @staticmethod
    def _widen(x: np.ndarray, half: bool) -> np.ndarray:
        if not half:
            return x
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).float().numpy()

    # ------------------------------------------------------------------
    # The layer stream
    # ------------------------------------------------------------------
    def _submit_layer(self, i: int, slot: int):
        bufs = self._layer_bufs[slot]
        return [self.swapper.submit_read(f"layers.{i}.{k}.param", out=bufs[k])
                for k in self.layer_keys], slot

    def _collect_layer(self, pending) -> Dict[str, torch.Tensor]:
        handles, slot = pending
        for h, _ in handles:
            self.swapper.wait(h)
        bufs = self._layer_bufs[slot]
        # a copy on every device: the buffer is refilled by the next read
        return {k: self._gather(k, torch.from_numpy(bufs[k]).view(torch.bfloat16)
                                .to(self.device, copy=True))
                for k in self.layer_keys}

    def _block(self):
        from ...models.transformer import _block_aux, layer_windows

        cfg, impl = self.cfg, self.attn_impl
        windows = layer_windows(cfg) or [None] * cfg.num_layers

        def block(i, lp, x, positions, seed):
            return _block_aux(cfg, lp, x, positions, impl, window=windows[i], seed=seed)

        return block

    def _stem(self, stem, tokens, positions):
        from ...models.transformer import _embed

        return _embed(self.cfg, stem, tokens, positions)

    def _head_loss(self, head, stem, x, labels):
        from ...models.transformer import _logits, cross_entropy_terms

        total, count = cross_entropy_terms(_logits(self.cfg, {**stem, **head}, x), labels)
        return total / count.clamp(min=1)

    @staticmethod
    def _tokens_labels(batch):
        if isinstance(batch, dict):
            tokens, labels = batch["input_ids"], batch.get("labels")
            if "positions" in batch:
                raise NotImplementedError("offload_param: custom positions not supported")
        else:
            tokens, labels = batch, None
        tokens = tokens.long()
        if labels is None:
            labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)], 1)
        return tokens, labels

    def _positions(self, tokens):
        B, S = tokens.shape
        return torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :].expand(B, S)

    def _stream_forward(self, tokens, seeds, keep: bool):
        """The prefetch-pipelined forward over the layers, no autograd:
        (x after the last layer, the boundary activations when ``keep``,
        the last layer's params, the layers' summed MoE aux)."""
        positions = self._positions(tokens)
        block = self._block()
        with torch.no_grad():
            x = self._stem(self._stem_dev, tokens, positions)
            xs = [x] if keep else None
            pending = self._submit_layer(0, 0)
            lp, aux_sum = None, None
            for i in range(self.num_layers):
                nxt = (self._submit_layer(i + 1, (i + 1) % 2)
                       if i + 1 < self.num_layers else None)
                lp = self._collect_layer(pending)
                x, aux = block(i, lp, x, positions, seeds[i])
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
                if keep:
                    xs.append(x)
                pending = nxt
        return x, xs, lp, aux_sum

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------
    def _accum(self, name: str, g: torch.Tensor) -> None:
        """Bank this rank's shard of a micro-batch's gradient in host fp32."""
        arr = self._reduce_grad(self._key(name), g.detach()).to("cpu").numpy()
        if self._host_grads is None:
            self._host_grads = {}
        buf = self._host_grads.get(name)
        if buf is None:
            self._host_grads[name] = np.array(arr, np.float32, order="C")
        else:
            buf += arr

    def _micro_fwd_bwd(self, tokens, labels):
        from ...models.transformer import layer_seeds

        cfg, L = self.cfg, self.num_layers
        seeds = layer_seeds(cfg, False, self.generator, tokens.device)
        positions = self._positions(tokens)
        x, xs, last_lp, aux_sum = self._stream_forward(tokens, seeds, keep=True)

        # the head: loss and its gradients (the tied embedding's too)
        head = {k: v.detach().requires_grad_() for k, v in self._head_dev.items()}
        tied = cfg.tie_embeddings
        stem_h = {k: (v.detach().requires_grad_() if tied and k == "embed" else v)
                  for k, v in self._stem_dev.items()}
        x_last = xs[L].detach().requires_grad_()
        loss = self._head_loss(head, stem_h, x_last, labels)
        wrt = list(head.values()) + ([stem_h["embed"]] if tied else []) + [x_last]
        grads = torch.autograd.grad(loss, wrt)
        for k, g in zip(head, grads):
            self._accum(k, g)
        if tied:
            self._accum("embed", grads[len(head)])
        dx = grads[-1]
        if aux_sum is not None:   # the reported loss is the fused engine's
            loss = loss.detach() + aux_sum
        block = self._block()
        coef = self.cfg.moe_aux_loss_coef

        bwd_slot = 0

        def submit_rev(i):
            nonlocal bwd_slot
            s, bwd_slot = bwd_slot, bwd_slot ^ 1
            return self._submit_layer(i, s)

        pending = submit_rev(L - 2) if L > 1 else None
        for i in reversed(range(L)):
            if i == L - 1:
                lp = last_lp
            else:
                lp = self._collect_layer(pending)
                pending = None
            if i > 0 and pending is None:
                pending = submit_rev(i - 1)   # prefetched under layer i's backward
            lp = {k: v.requires_grad_() for k, v in lp.items()}
            x_in = xs[i].detach().requires_grad_()
            y, aux = block(i, lp, x_in, positions, seeds[i])
            outs, douts = [y], [dx]
            if aux is not None:   # d(loss)/d(aux) = coef: the router's gradient
                outs.append(aux)
                douts.append(torch.full_like(aux, coef))
            g = torch.autograd.grad(outs, list(lp.values()) + [x_in], douts)
            for k, gk in zip(lp, g):
                self._accum(f"layers.{i}.{k}", gk)
            dx = g[-1]
            xs[i + 1] = None
            del lp, y, g

        stem = {k: v.detach().requires_grad_() for k, v in self._stem_dev.items()}
        x0 = self._stem(stem, tokens, positions)
        for k, gk in zip(stem, torch.autograd.grad(x0, list(stem.values()), dx)):
            self._accum(k, gk)
        return loss.detach()

    def train_batch(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``batch``: leaves with a leading [gas] dim ({'input_ids',
        optional 'labels'}).  Returns (mean loss, metrics)."""
        t0 = time.perf_counter()
        self._host_grads = None
        losses = []
        for gi in range(self.gas):
            tokens, labels = self._tokens_labels(
                {k: v[gi] for k, v in batch.items()} if isinstance(batch, dict)
                else batch[gi])
            losses.append(self._micro_fwd_bwd(tokens, labels))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        lr = float(self.lr_schedule(self.step_count))
        grad_norm = self._apply_adam(lr)
        self.step_count += 1
        self.stats.update(fwd_bwd_s=t1 - t0, host_adam_s=time.perf_counter() - t1)
        loss = torch.stack(losses).mean()
        return loss, {"loss": loss, "grad_norm": grad_norm,
                      "loss_scale": 1.0, "step_applied": True}

    def eval_batch(self, batch) -> torch.Tensor:
        """The forward-only layer stream: dropout off, no activations kept."""
        tokens, labels = self._tokens_labels(batch)
        x, _, _, aux_sum = self._stream_forward(tokens, [None] * self.num_layers,
                                                keep=False)
        with torch.no_grad():
            loss = self._head_loss(self._head_dev, self._stem_dev, x, labels)
        return loss + aux_sum if aux_sum is not None else loss

    # ------------------------------------------------------------------
    # The host Adam over the NVMe state, with the bf16 rewrite
    # ------------------------------------------------------------------
    def _apply_adam(self, lr: float) -> float:
        grads = self._host_grads
        assert grads is not None, "train window produced no gradients"
        inv_gas = 1.0 / self.gas
        for g in grads.values():
            g *= inv_gas
        self.stats["host_grad_bytes"] = sum(g.nbytes for g in grads.values())
        sq = 0.0
        for name in self._leaf_names:   # a whole leaf on every rank counts once
            g = grads[name]
            whole = self._dp > 1 and self.shard_dims[self._key(name)] is None
            sq += float(np.vdot(g, g)) / (self._dp if whole else 1)
        if self._dp > 1:
            sq = float(comm.all_reduce(torch.tensor(sq, dtype=torch.float64),
                                       comm.SUM, BATCH_AXES))
        gnorm = math.sqrt(sq)
        factor = 1.0
        if self.clip and self.clip > 0 and gnorm > self.clip:
            factor = self.clip / (gnorm + 1e-6)
        step = self.step_count + 1
        sw = self.swapper
        r0, w0 = sw.bytes_read, sw.bytes_written
        t0 = time.perf_counter()
        for name in self._leaf_names:
            g = grads[name]
            if factor != 1.0:
                g = g * factor
            master = sw.read(f"{name}.master")
            m = self._widen(sw.read(f"{name}.exp_avg"), self._mu16)
            v = self._widen(sw.read(f"{name}.exp_avg_sq"), self._nu16)
            out16 = aligned_empty((master.size,), np.uint16)
            self.adam.step_flat(master.reshape(-1), np.ascontiguousarray(g.reshape(-1)),
                                m.reshape(-1), v.reshape(-1), step=step,
                                bf16_out=out16, lr=lr)
            sw.write(f"{name}.master", master)
            sw.write(f"{name}.exp_avg", self._store(m, self._mu16))
            sw.write(f"{name}.exp_avg_sq", self._store(v, self._nu16))
            new16 = out16.reshape(master.shape)
            sw.write(f"{name}.param", new16)
            self._refresh_resident(name, new16)
        dt = time.perf_counter() - t0
        self.stats.update(nvme_read_gb=(sw.bytes_read - r0) / 1e9,
                          nvme_write_gb=(sw.bytes_written - w0) / 1e9,
                          nvme_gbps=(sw.bytes_read - r0 + sw.bytes_written - w0)
                          / max(dt, 1e-9) / 1e9)
        self._host_grads = None
        return gnorm

    def _refresh_resident(self, name: str, bits: np.ndarray) -> None:
        """A stem or head leaf's new bf16 shard, gathered whole on the card
        (collective: every rank refreshes the same leaves in turn)."""
        for res in (self._stem_dev, self._head_dev):
            if name in res:
                res[name] = self._gather(name, torch.from_numpy(
                    np.ascontiguousarray(bits)).view(torch.bfloat16).to(
                        self.device, copy=True))

    # ------------------------------------------------------------------
    # Checkpointing: streamed leaf by leaf, so the 12 B/param state is
    # never resident in host RAM at once
    # ------------------------------------------------------------------
    def _read_leaf_state(self, name: str):
        return (self.swapper.read(f"{name}.master"),
                self._widen(self.swapper.read(f"{name}.exp_avg"), self._mu16),
                self._widen(self.swapper.read(f"{name}.exp_avg_sq"), self._nu16))

    def _write_leaf_state(self, name: str, master, m, v) -> None:
        master = np.ascontiguousarray(master, np.float32)
        self.swapper.write(f"{name}.master", master)
        # checkpoint files stay fp32; the store keeps its at-rest dtype
        self.swapper.write(f"{name}.exp_avg",
                           self._store(np.ascontiguousarray(m, np.float32), self._mu16))
        self.swapper.write(f"{name}.exp_avg_sq",
                           self._store(np.ascontiguousarray(v, np.float32), self._nu16))
        new16 = self._store(master, True)   # the bf16 params derive from the masters
        self.swapper.write(f"{name}.param", new16)
        self._refresh_resident(name, new16)

    def save_state_files(self, out_dir: str) -> None:
        from ..offload import save_offload_state_files

        save_offload_state_files(out_dir, self._leaf_names, self._read_leaf_state,
                                 self.step_count)

    def load_state_files(self, in_dir: str) -> None:
        from ..offload import load_offload_state_files

        shapes = {n: self.swapper.shape(f"{n}.master") for n in self._leaf_names}
        self.step_count = load_offload_state_files(
            in_dir, self._leaf_names, self._write_leaf_state, expected_shapes=shapes)

    def read_masters(self) -> Dict[str, np.ndarray]:
        """This rank's fp32 master shards by store name (``shard_dims``
        names each leaf's dim: None where every rank holds it whole)."""
        return {n: self.swapper.read(f"{n}.master") for n in self._leaf_names}
