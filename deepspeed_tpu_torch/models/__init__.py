"""Model zoo and the engine's model contract (counterpart of
``deepspeed_tpu/models/__init__.py``).

``CausalLM`` is an ``nn.Module`` that keeps the JAX package's functional
contract: ``init_fn`` makes a parameter tree, ``apply_fn(params, tokens)``
runs the forward, ``loss_fn(params, batch, generator)`` and ``eval_fn`` are
the training engine's model contract, ``init_cache``/``apply_cached`` drive
KV-cached decoding.
``load_params`` attaches a tree so that ``model(tokens)`` works as a module
call and ``init_inference(model)`` finds the weights.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .transformer import (CONFIGS, TransformerConfig, cross_entropy_loss,
                          forward, forward_cached, get_config, init_cache,
                          init_params)

__all__ = ["CausalLM", "TransformerConfig", "CONFIGS", "get_config", "forward",
           "forward_cached", "init_cache", "init_params", "cross_entropy_loss"]


class CausalLM(nn.Module):
    """Causal-LM adapter over the transformer family."""

    def __init__(self, config="tiny", attn_impl: str = "auto", **overrides):
        super().__init__()
        self.config = get_config(config, **overrides)
        self.attn_impl = attn_impl
        self.params: Optional[Dict[str, Any]] = None

    def init_fn(self, generator: Optional[torch.Generator] = None, device=None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Random weights drawn from ``generator`` on ``device``."""
        return init_params(self.config, generator, device=device, dtype=dtype)

    def load_params(self, params: Dict[str, Any]) -> "CausalLM":
        self.params = params
        return self

    def apply_fn(self, params, tokens, positions=None, rng=None,
                 deterministic=True, return_aux=False, pld_theta=None):
        return forward(self.config, params, tokens, positions=positions, rng=rng,
                       attn_impl=self.attn_impl, deterministic=deterministic,
                       return_aux=return_aux, pld_theta=pld_theta)

    def _split(self, batch):
        """(tokens, labels, positions, pld_theta) of a batch: a dict with
        ``input_ids`` (``labels``, ``positions``, ``pld_theta`` optional) or
        the token tensor alone.  Labels default to the tokens shifted by one,
        with -100 (ignored) at the end."""
        pld_theta = None
        if isinstance(batch, dict):
            tokens = batch["input_ids"]
            labels = batch.get("labels")
            positions = batch.get("positions")
            pld_theta = batch.get("pld_theta")
        else:
            tokens, labels, positions = batch, None, None
        if labels is None:
            labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                               dim=1)
        return tokens, labels, positions, pld_theta

    def _loss(self, params, batch, rng, deterministic):
        tokens, labels, positions, pld_theta = self._split(batch)
        logits = self.apply_fn(params, tokens, positions=positions, rng=rng,
                               deterministic=deterministic,
                               pld_theta=None if deterministic else pld_theta)
        return cross_entropy_loss(logits, labels)

    def loss_fn(self, params, batch, rng: Optional[torch.Generator] = None):
        """Training loss (dropout on, drawn from ``rng``)."""
        return self._loss(params, batch, rng, deterministic=False)

    def eval_fn(self, params, batch, rng: Optional[torch.Generator] = None):
        return self._loss(params, batch, rng, deterministic=True)

    @property
    def param_count(self) -> int:
        return self.config.param_count

    def forward(self, tokens, positions=None):
        if self.params is None:
            raise ValueError("no weights: call load_params(init_fn(...)) first")
        return self.apply_fn(self.params, tokens, positions=positions)

    # -- KV-cached decode contract (used by InferenceEngine.generate) --
    def init_cache(self, batch_size, max_len, dtype=None, device=None):
        return init_cache(self.config, batch_size, max_len, dtype, device)

    def apply_cached(self, params, tokens, cache, positions, input_mask):
        return forward_cached(self.config, params, tokens, cache, positions,
                              input_mask)
