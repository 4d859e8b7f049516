"""LoRA adapters, the inference half (counterpart of
``deepspeed_tpu/runtime/lora.py``): the config, the default targets and
the fused view ``base + A @ B * (alpha / rank)`` that multi-tenant adapter
serving (``inference/adapters.py``) folds a hot tenant into.  LoRA
training (``init_lora_params``, ``LoRAModel``) is not ported yet (ROADMAP
queue 1, item 11)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["DEFAULT_TARGETS", "LoRAConfig", "apply_lora"]

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
