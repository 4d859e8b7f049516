"""Progressive Layer Drop (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``; reference
``runtime/progressive_layer_drop.py``, arXiv:2010.13369).

The schedule is the reference's: theta(t) = (1 - theta_bar) exp(-gamma t)
+ theta_bar, the keep probability decaying from 1 toward ``theta``.  The
engine owns the schedule and the model applies the drop:
``pld_keep_mask`` turns (a host generator, theta) into the [L] keep
decisions, layer i (1-based) of L keeping with probability 1 - (i/L)(1 -
theta).  The mask is drawn on the host, so the model knows which layers
run without a device sync and skips the dropped ones outright (the
residual identity, no aux loss): a dropped layer launches no kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.logging import log_dist


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = {self.theta})",
                 ranks=[0])

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> float:
        self.current_theta = float(
            (1.0 - self.theta) * np.exp(-self.gamma * global_step) + self.theta)
        return self.current_theta


def pld_keep_mask(generator: torch.Generator, num_layers: int, theta) -> torch.Tensor:
    """Per-layer keep decisions, a [L] bool tensor on the generator's
    device (the host's, for the model's layer loop): layer i keeps with
    probability 1 - (i+1)/L (1 - theta)."""
    depth = (torch.arange(num_layers, dtype=torch.float32) + 1.0) / num_layers
    p_keep = 1.0 - depth * (1.0 - float(theta))
    draw = torch.rand((num_layers,), generator=generator, device=generator.device)
    return draw < p_keep.to(draw.device)
