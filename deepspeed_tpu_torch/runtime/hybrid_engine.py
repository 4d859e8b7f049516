"""Hybrid engine: one weight set for training and generation, the
DeepSpeed-Chat actor (counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py``;
reference ``runtime/hybrid_engine.py:32``).

The training engine keeps a compute-precision view of its weights beside
the fp32 masters, and the inference engine's ``generate`` takes its
weights as an argument, so the hybrid engine hands it the live training
view: no module swap, no copy.  A ZeRO-sharded view is gathered for the
call.  A ``LoRAModel`` actor generates through its base model on
``base + A @ B * scale``, fused once per training step
(``fuse_lora_weight``; refreshed after each ``train_batch``), the base
weights never written.  ``generate`` decodes through the KV-cached path
(``InferenceEngine.generate``), whose prompt prefill takes the flash
kernel where the model's ``attn_impl`` does at that length.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import torch

from ..utils.logging import log_dist


class DeepSpeedHybridEngine:
    """``generate`` over the live weights of training engine ``engine``;
    ``train_batch``, ``eval_batch``, ``save_checkpoint`` and
    ``load_checkpoint`` pass through.  ``model`` (default the engine's)
    must have the KV-cache contract (``apply_cached``)."""

    def __init__(self, engine, model: Any = None, inference_config=None):
        from ..inference.config import DeepSpeedInferenceConfig
        from ..inference.engine import InferenceEngine

        self.engine = engine
        model = model or engine.model
        if model is None or not hasattr(model, "apply_cached"):
            raise ValueError(
                "hybrid engine needs a KV-cache-capable model (apply_cached); "
                "pass the CausalLM adapter the training engine was built with")
        if engine.tp or engine.pipelined or engine.state is None:
            raise NotImplementedError(
                "the hybrid engine generates from a data-parallel or one-device "
                "engine's view (model-axis, pipelined and param-offloaded trees "
                "are not ported)")
        self.model = model
        self._lora = model if hasattr(model, "fused") and hasattr(model, "base_model") \
            else None
        self._gen_model = self._lora.base_model if self._lora else model
        self._fused_params = None
        self._fused_at_step = None
        name = {torch.bfloat16: "bf16", torch.float16: "fp16"}.get(engine.compute_dtype,
                                                                   "fp32")
        cfg = inference_config or DeepSpeedInferenceConfig.from_dict({"dtype": name})
        # params=None: generation always reads the live training view
        self._infer = InferenceEngine(self._gen_model, config=cfg, params=None,
                                      apply_fn=self._gen_model.apply_fn,
                                      device=engine.device)
        self._generate_calls = 0
        self._generate_time = 0.0

    def _live_params(self):
        """The engine's compute view, whole (gathered where ZeRO shards it)."""
        if self.engine.partition is None:
            return self.engine.state.params
        from ..zero import GatheredParameters

        with GatheredParameters(self.engine.get_params(), to_device=True) as g:
            return g.values

    # -- LoRA fuse/unfuse (reference hybrid_engine.py:138-160) --
    def fuse_lora_weight(self) -> None:
        """``base + A @ B * scale`` from the live adapters, for generation
        (the base is not written, so unfusing drops this tree)."""
        if self._lora is None:
            return
        self._fused_params = None   # the old fused tree goes before the new one
        with torch.no_grad():
            self._fused_params = self._lora.fused(self._live_params())
        self._fused_at_step = self.engine.global_steps

    def unfuse_lora_weight(self) -> None:
        self._fused_params = None
        self._fused_at_step = None

    def _generation_params(self):
        if self._lora is None:
            return self._live_params()
        if self._fused_params is None or self._fused_at_step != self.engine.global_steps:
            self.fuse_lora_weight()   # refreshed after each training step
        return self._fused_params

    def generate(self, input_ids, **kwargs):
        """``InferenceEngine.generate`` on the live weights."""
        t0 = time.perf_counter()
        out = self._infer.generate(input_ids, model=self._gen_model,
                                   params=self._generation_params(), **kwargs)
        self._generate_time += time.perf_counter() - t0
        self._generate_calls += 1
        return out

    def rollout_engine(self, **kwargs):
        raise NotImplementedError(
            "batched rollouts through the paged serving engine (RolloutEngine) "
            "are not ported yet (ROADMAP queue 1, item 14)")

    # -- training passthrough --
    def train_batch(self, *args, **kwargs):
        return self.engine.train_batch(*args, **kwargs)

    def eval_batch(self, *args, **kwargs):
        return self.engine.eval_batch(*args, **kwargs)

    def save_checkpoint(self, *args, **kwargs):
        return self.engine.save_checkpoint(*args, **kwargs)

    def load_checkpoint(self, *args, **kwargs):
        out = self.engine.load_checkpoint(*args, **kwargs)
        self.unfuse_lora_weight()   # the loaded adapters fuse anew
        return out

    # the reference's mode flips: nothing to swap here
    def eval(self):
        return self

    def train(self, mode: bool = True):
        return self

    @property
    def module(self):
        return self.engine.module

    def report_generate_latency(self) -> Optional[float]:
        """Mean ``generate`` wall-clock seconds (None before the first)."""
        if not self._generate_calls:
            return None
        mean = self._generate_time / self._generate_calls
        log_dist(f"hybrid engine: {self._generate_calls} generate calls, "
                 f"mean {mean * 1e3:.1f} ms", ranks=[0])
        return mean
