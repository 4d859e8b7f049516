"""BERT-style transformer layer API (counterpart of
``deepspeed_tpu/ops/transformer/__init__.py``; reference
``ops/transformer/transformer.py:296`` ``DeepSpeedTransformerLayer`` +
``DeepSpeedTransformerConfig``).

The reference builds this layer from hand-fused CUDA kernels (softmax,
layernorm, dropout, gemm scheduling — csrc/transformer/*.cu).  Like the JAX
package, this module keeps the reference's *API* over the model's own
encoder block (``models/transformer.py`` ``_block``): a per-layer config, a
layer object with ``init``/``apply``, pre-LN or post-LN selection, and the
reference's knobs.  A knob that only selects a CUDA implementation detail
(``stochastic_mode``, ``normalize_invertible``, ``attn_dropout_checkpoint``,
``gelu_checkpoint``) is accepted and recorded: both schedules compute the
same math.  The layer is bidirectional, so its attention takes the plain
branch of ``_attention``, as in the JAX package; no kernel is involved.
Dropout draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.transformer import TransformerConfig, _block

__all__ = ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer"]


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """Reference-shaped config (transformer.py:34)."""

    batch_size: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    # CUDA-implementation knobs, accepted for API parity (see module doc):
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    def to_native(self) -> TransformerConfig:
        if self.intermediate_size <= 0:
            raise ValueError("intermediate_size must be set")
        if self.attn_dropout_ratio != self.hidden_dropout_ratio:
            raise NotImplementedError(
                "separate attention/hidden dropout ratios are not supported "
                "(one dropout knob drives both sites)")
        return TransformerConfig(
            vocab_size=1,  # layer-only: no embedding/head
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_hidden_layers,
            num_heads=self.heads,
            max_seq_len=1 << 16,
            norm="layernorm", activation="gelu_exact",
            # BERT-style layer: positions live in the embedding, not the
            # block ("learned" => the block applies no rope/alibi), and
            # attention is bidirectional
            position="learned", causal=False,
            post_layernorm=not self.pre_layer_norm,
            attn_bias=True, mlp_bias=True,
            dropout=self.hidden_dropout_ratio,
            norm_eps=self.layer_norm_eps,
            initializer_range=self.initializer_range,
            # "fp16" runs bf16 activations, as in the JAX package
            dtype=torch.bfloat16 if self.fp16 else torch.float32,
            remat=self.gelu_checkpoint or self.attn_dropout_checkpoint,
            scan_layers=False)


class DeepSpeedTransformerLayer:
    """One transformer layer with the reference's object surface:
    ``layer = DeepSpeedTransformerLayer(config)``, ``params =
    layer.init(generator)``, ``out = layer.apply(params, hidden_states[,
    input_mask])``.

    Functional (params are explicit), so the same layer object serves every
    depth — the reference's per-layer ``layer_id`` bookkeeping is not needed.
    A JAX layer's parameters load with
    ``models.convert.layer_params_from_jax``.
    """

    def __init__(self, config: DeepSpeedTransformerConfig,
                 initial_weights: Optional[Dict[str, Any]] = None,
                 initial_biases: Optional[Dict[str, Any]] = None):
        self.config = config
        self.native = config.to_native()
        self._initial = (initial_weights, initial_biases)

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Dict[str, torch.Tensor]:
        """fp32 parameters under the JAX layer's keys and shapes (normal x
        ``initializer_range``, residual projections / sqrt(2L) with
        ``adjust_init_range``, norms 1, biases 0), drawn from ``generator``.
        The values differ from ``jax.random``'s.  The device is ``device``,
        else the generator's, else the accelerator's (CUDA)."""
        d, f = self.native.hidden_size, self.native.intermediate_size
        hd, nh = self.native.dims_per_head, self.native.num_heads
        std = self.config.initializer_range
        if self.config.adjust_init_range:
            # reference output_std = std / sqrt(2*L) on the residual path
            out_std = std / math.sqrt(2.0 * max(self.config.num_hidden_layers, 1))
        else:
            out_std = std
        device = resolve_device(device if device is not None or generator is None
                                else generator.device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(
                max(self.config.seed, 0))

        def dense(*shape, scale=std):
            return torch.randn(shape, generator=generator, device=device) * scale

        def const(value, n):
            return torch.full((n,), value, dtype=torch.float32, device=device)

        lp = {
            "attn_norm_scale": const(1.0, d), "attn_norm_bias": const(0.0, d),
            "mlp_norm_scale": const(1.0, d), "mlp_norm_bias": const(0.0, d),
            "wq": dense(d, nh * hd), "bq": const(0.0, nh * hd),
            "wk": dense(d, nh * hd), "bk": const(0.0, nh * hd),
            "wv": dense(d, nh * hd), "bv": const(0.0, nh * hd),
            "wo": dense(nh * hd, d, scale=out_std), "bo": const(0.0, d),
            "w_in": dense(d, f), "b_in": const(0.0, f),
            "w_down": dense(f, d, scale=out_std), "b_down": const(0.0, d),
        }
        for given in self._initial:
            for key, val in (given or {}).items():
                lp[key] = torch.as_tensor(np.asarray(val), device=device)
        return lp

    def apply(self, params: Dict[str, torch.Tensor], hidden_states: torch.Tensor,
              input_mask: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              deterministic: Optional[bool] = None):
        """hidden_states ``[B, S, hidden]`` -> ``[B, S, hidden]`` (a 1-tuple
        with ``return_tuple``).  Dropout runs unless ``deterministic`` (by
        default: unless the config is not ``training``); its masks come from
        a seed drawn from ``generator``, else from the config's seed."""
        if input_mask is not None and not bool(torch.as_tensor(input_mask).all()):
            raise NotImplementedError(
                "per-token input masks are not wired into the layer-level "
                "API (the BERT injection path handles padding); pass an "
                "all-ones mask or None")
        B, S, _ = hidden_states.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=hidden_states.device).expand(B, S)
        det = (not self.config.training if deterministic is None
               else deterministic)
        seed = None
        if not det:
            seed = ((max(self.config.seed, 0) if generator is None else int(
                torch.randint(2 ** 62, (1,), generator=generator,
                              device=generator.device))), 0, 0, None)
        out = _block(self.native, params, hidden_states.to(self.native.dtype),
                     positions, "auto", seed=seed)
        return (out,) if self.config.return_tuple else out
