"""Standalone MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``;
reference ``deepspeed/moe/layer.py:16`` ``MoE``).

An ``nn.Module`` keeping the JAX package's functional contract:
``init(generator)`` draws the router and expert leaves (and, with
``use_residual``, the dense branch and its mixing coefficient, the R of
PR-MoE), ``param_specs`` lays the experts on the 'expert' axis with
expert-internal tensor parallelism on 'model', and ``apply(params, x)``
runs gate -> dispatch -> experts -> combine and returns ``(out, aux)`` as
the reference's ``MOELayer.forward`` (sharded_moe.py:472).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .sharded_moe import MoEConfig, moe_ffn


class MoE(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: Optional[int] = None,
                 num_experts: int = 8, k: int = 2, capacity_factor: float = 1.25,
                 eval_capacity_factor: float = 2.0, min_capacity: int = 8,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_residual: bool = False, activation: str = "swiglu"):
        super().__init__()
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.activation = activation
        self.use_residual = use_residual
        self.config = MoEConfig(num_experts=num_experts, top_k=k,
                                capacity_factor=capacity_factor,
                                eval_capacity_factor=eval_capacity_factor,
                                min_capacity=min_capacity,
                                noisy_gate_policy=noisy_gate_policy,
                                drop_tokens=drop_tokens)
        self.params: Optional[Dict[str, Any]] = None

    def init(self, generator: Optional[torch.Generator] = None, scale: float = 0.02,
             device=None) -> Dict[str, Any]:
        """Normal * ``scale`` leaves under the JAX layer's names and shapes
        (the values are ``generator``'s, not ``jax.random``'s)."""
        d, f, E = self.hidden_size, self.intermediate_size, self.config.num_experts
        device = device if device is not None else (
            generator.device if generator is not None else "cpu")

        def draw(*shape):
            return torch.randn(shape, generator=generator, device=device) * scale

        params = {"router": draw(d, E)}
        if self.activation == "swiglu":
            params["w_gate"] = draw(E, d, f)
            params["w_up"] = draw(E, d, f)
        else:
            params["w_in"] = draw(E, d, f)
        params["w_down"] = draw(E, f, d)
        if self.use_residual:
            if self.activation == "swiglu":
                params["res_w_gate"] = draw(d, f)
                params["res_w_up"] = draw(d, f)
            else:
                params["res_w_in"] = draw(d, f)
            params["res_w_down"] = draw(f, d)
            params["coefficient"] = draw(d, 2)
        return params

    @property
    def param_specs(self) -> Dict[str, Any]:
        col, row = ("expert", None, "model"), ("expert", "model", None)
        specs: Dict[str, Any] = {"router": (None, None), "w_down": row}
        if self.activation == "swiglu":
            specs.update(w_gate=col, w_up=col)
        else:
            specs["w_in"] = col
        if self.use_residual:
            dcol, drow = (None, "model"), ("model", None)
            if self.activation == "swiglu":
                specs.update(res_w_gate=dcol, res_w_up=dcol)
            else:
                specs["res_w_in"] = dcol
            specs.update(res_w_down=drow, coefficient=(None, None))
        return specs

    def apply(self, params: Dict[str, Any], x: torch.Tensor, deterministic: bool = True,
              rng=None) -> Tuple[torch.Tensor, torch.Tensor]:
        out, aux = moe_ffn(x, params["router"], params, self.config,
                           activation=self.activation, deterministic=deterministic,
                           rng=rng)
        if self.use_residual:
            w = {n: params[n].to(x.dtype) for n in params if n.startswith("res_")}
            if self.activation == "swiglu":
                res = (F.silu(x @ w["res_w_gate"]) * (x @ w["res_w_up"])) @ w["res_w_down"]
            else:
                res = F.gelu(x @ w["res_w_in"], approximate="tanh") @ w["res_w_down"]
            coef = torch.softmax((x @ params["coefficient"].to(x.dtype)).float(),
                                 dim=-1).to(out.dtype)
            out = out * coef[..., 0:1] + res * coef[..., 1:2]
        return out, aux

    def forward(self, x: torch.Tensor):
        if self.params is None:
            raise ValueError("no weights: set layer.params = layer.init(...) first")
        return self.apply(self.params, x, deterministic=not self.training)
