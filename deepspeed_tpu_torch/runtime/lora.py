"""LoRA adapters (counterpart of ``deepspeed_tpu/runtime/lora.py``;
DeepSpeed-Chat's LoRA utilities and the reference hybrid engine's
``fuse_lora_weight``).

LoRA is a functional transform: the trainable tree is the adapter tree
``{target: {"A": [L, d_in, r], "B": [L, r, d_out]}}`` and the base weights
are a frozen constant the model closes over, so ``initialize(model=
LoRAModel(base, base_params, cfg))`` trains only the adapters (under any
ZeRO stage: the engine shards what it trains).  ``fused = base + A @ B *
(alpha / rank)`` is a pure function; the base tree is never written, and
"unfusing" is dropping a fused tree.  Multi-tenant adapter serving
(``inference/adapters.py``) folds a hot tenant in with :func:`apply_lora`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["DEFAULT_TARGETS", "LoRAConfig", "LoRAModel", "apply_lora",
           "init_lora_params", "lora_param_specs"]

# attention projections: DeepSpeed-Chat's default LoRA surface
DEFAULT_TARGETS: Tuple[str, ...] = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    def validate(self) -> "LoRAConfig":
        """Reject impossible configs before any math touches them."""
        if int(self.rank) < 1:
            raise ValueError(f"LoRA rank={self.rank} must be >= 1")
        if not (float(self.alpha) > 0.0):
            raise ValueError(f"LoRA alpha={self.alpha} must be > 0")
        if not self.targets:
            raise ValueError("LoRA targets must name at least one layer "
                             "weight")
        if len(set(self.targets)) != len(self.targets):
            raise ValueError(f"duplicate LoRA targets: {list(self.targets)}")
        return self

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def lora_delta(ab: Dict[str, Any], scaling: float, device=None) -> torch.Tensor:
    """``A @ B * scaling`` of one target's stacked factors (``A`` [L, d_in,
    r], ``B`` [L, r, d_out], tensors or numpy) in fp32 -> [L, d_in, d_out]."""
    A, B = (torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
            .to(device=device, dtype=torch.float32) for x in (ab["A"], ab["B"]))
    return torch.einsum("lir,lro->lio", A, B) * scaling


def apply_lora(base_params: Dict[str, Any], lora: Dict[str, Any], scaling: float,
               shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
               ) -> Dict[str, Any]:
    """``fused = base + A @ B * scaling`` on the targeted layer weights, a
    new tree (the base is not touched; untargeted leaves are shared).  The
    product runs in fp32 and is cast to the weight's dtype before the add,
    as the JAX package's.  ``shard(name, delta)`` cuts a whole delta to the
    rank's model-axis shard when the base tree holds shards."""
    layers = dict(base_params["layers"])
    for k, ab in lora.items():
        w = layers[k]
        delta = lora_delta(ab, scaling, device=w.device)
        if shard is not None:
            delta = shard(k, delta)
        layers[k] = w + delta.to(w.dtype)
    out = dict(base_params)
    out["layers"] = layers
    return out


def init_lora_params(base_layers: Dict[str, Any], cfg: LoRAConfig,
                     generator: torch.Generator) -> Dict[str, Any]:
    """A/B factors for each targeted stacked layer weight [L, d_in, d_out]:
    A = N(0, 1) / rank [L, d_in, r] drawn from ``generator`` (target by
    target, in ``cfg.targets`` order), B = 0 [L, r, d_out], both fp32 on the
    generator's device: B = 0 makes the first fused tree the base itself."""
    cfg.validate()
    out: Dict[str, Any] = {}
    for k in cfg.targets:
        if k not in base_layers:
            raise ValueError(f"LoRA target {k!r} not in model layers "
                             f"({sorted(base_layers)})")
        w = base_layers[k]
        if w.ndim != 3:
            raise NotImplementedError(
                f"LoRA target {k!r} has rank-{w.ndim} weight; only stacked "
                "[L, d_in, d_out] matmul weights are supported")
        L, d_in, d_out = w.shape
        dev = generator.device
        out[k] = {"A": torch.randn((L, d_in, cfg.rank), generator=generator,
                                   device=dev) * (1.0 / cfg.rank),
                  "B": torch.zeros((L, cfg.rank, d_out), device=dev)}
    return out


def lora_param_specs(cfg: LoRAConfig) -> Dict[str, Any]:
    """The adapters are small (r << d): replicated over the model axis."""
    return {k: {"A": (None, None, None), "B": (None, None, None)}
            for k in cfg.targets}


class LoRAModel:
    """The engine's model contract over the adapter tree alone:
    ``init_fn``, ``loss_fn``, ``loss_terms``, ``eval_fn``, ``param_specs``
    and the KV-cache passthroughs, each reading ``fused(lora)``.  The frozen
    base is kept in the model's compute dtype (the fused tree must match
    the activations', and an fp32 base would double the frozen bytes)."""

    def __init__(self, base_model, base_params: Dict[str, Any], lora_config: LoRAConfig):
        from ..utils.logging import log_dist
        from ..utils.tree import tree_leaves, tree_map

        lora_config.validate()
        self.base_model = base_model
        dt = base_model.config.dtype
        self.base_params = tree_map(
            lambda x: x.detach().to(dt) if x.is_floating_point() else x.detach(),
            base_params)
        self.lora_config = lora_config
        self.config = base_model.config
        self.attn_impl = getattr(base_model, "attn_impl", "auto")
        self.param_specs = lora_param_specs(lora_config)
        n = sum(x.numel() for x in tree_leaves(self.base_params))
        log_dist(f"LoRA: rank={lora_config.rank} over {list(lora_config.targets)} "
                 f"— base {n:,} params frozen", ranks=[0])

    def init_fn(self, generator: Optional[torch.Generator] = None, device=None):
        if generator is None:
            generator = torch.Generator(device=device or "cpu")
            generator.manual_seed(0)
        return init_lora_params(self.base_params["layers"], self.lora_config, generator)

    def fused(self, lora: Dict[str, Any]) -> Dict[str, Any]:
        """``base + A @ B * scaling`` (:func:`apply_lora`; differentiable
        in the factors)."""
        return apply_lora(self.base_params, lora, self.lora_config.scaling)

    def loss_fn(self, lora, batch, rng=None):
        return self.base_model.loss_fn(self.fused(lora), batch, rng)

    def loss_terms(self, lora, batch, rng=None, deterministic: bool = False):
        return self.base_model.loss_terms(self.fused(lora), batch, rng,
                                          deterministic=deterministic)

    def eval_fn(self, lora, batch, rng=None):
        return self.base_model.eval_fn(self.fused(lora), batch, rng)

    # the KV-cache decode contract (generation reads the fused weights)
    def init_cache(self, *args, **kwargs):
        return self.base_model.init_cache(*args, **kwargs)

    def apply_cached(self, lora, tokens, cache, positions, input_mask):
        return self.base_model.apply_cached(self.fused(lora), tokens, cache,
                                            positions, input_mask)

    def apply_fn(self, lora, *args, **kwargs):
        return self.base_model.apply_fn(self.fused(lora), *args, **kwargs)
