"""Model zoo and the engine's model contract (counterpart of
``deepspeed_tpu/models/__init__.py``).

``CausalLM`` is an ``nn.Module`` that keeps the JAX package's functional
contract: ``init_fn`` makes a parameter tree, ``apply_fn(params, tokens)``
runs the forward, ``init_cache``/``apply_cached`` drive KV-cached decoding.
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
