"""Loss scaling (counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``;
reference ``runtime/fp16/loss_scaler.py``: LossScaler / DynamicLossScaler).

The scaler state is a small host-side record: the engine reads one
all-finite flag per step (a single device sync, fp16 only) and applies the
reference's rule — overflow skips the step and, once the hysteresis is
used up, divides the scale; ``scale_window`` clean steps multiply it.
"""
from __future__ import annotations

import dataclasses

import torch

from ...utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    loss_scale: float
    good_steps: int          # consecutive overflow-free steps
    hysteresis: int          # remaining tolerated overflows
    scale_window: int
    min_scale: float
    scale_factor: float
    init_hysteresis: int
    dynamic: bool


def static_loss_scale_state(loss_scale: float) -> LossScaleState:
    """Fixed scale (reference LossScaler)."""
    return LossScaleState(loss_scale=float(loss_scale), good_steps=0, hysteresis=1,
                          scale_window=1, min_scale=float(loss_scale),
                          scale_factor=1.0, init_hysteresis=1, dynamic=False)


def dynamic_loss_scale_state(initial_scale_power: int = 16,
                             loss_scale_window: int = 1000,
                             min_loss_scale: float = 1.0, hysteresis: int = 2,
                             scale_factor: float = 2.0) -> LossScaleState:
    """Reference DynamicLossScaler defaults (loss_scaler.py)."""
    return LossScaleState(loss_scale=2.0 ** initial_scale_power, good_steps=0,
                          hysteresis=hysteresis, scale_window=loss_scale_window,
                          min_scale=float(min_loss_scale),
                          scale_factor=float(scale_factor),
                          init_hysteresis=hysteresis, dynamic=True)


def no_loss_scale_state() -> LossScaleState:
    return static_loss_scale_state(1.0)


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.loss_scale


def grads_finite(grads) -> bool:
    """Global all-finite check (the reference's has_overflow, inverted)."""
    leaves = tree_leaves(grads)
    if not leaves:
        return True
    return bool(torch.stack([torch.isfinite(g).all() for g in leaves]).all())


def update_scale(state: LossScaleState, is_finite: bool) -> LossScaleState:
    """Post-step scale update (reference DynamicLossScaler.update_scale):

    - overflow: consume hysteresis; once exhausted, scale /= factor (>= min),
      reset the good-step counter
    - no overflow for ``scale_window`` consecutive steps: scale *= factor,
      reset counter and hysteresis
    """
    if not state.dynamic:
        return state
    if is_finite:
        good = state.good_steps + 1
        grow = good % state.scale_window == 0
        return dataclasses.replace(
            state, good_steps=good,
            loss_scale=state.loss_scale * state.scale_factor if grow
            else state.loss_scale,
            hysteresis=state.init_hysteresis if grow else state.hysteresis)
    hys = state.hysteresis - 1
    drop = hys <= 0
    return dataclasses.replace(
        state, good_steps=0,
        loss_scale=max(state.loss_scale / state.scale_factor, state.min_scale)
        if drop else state.loss_scale,
        hysteresis=state.init_hysteresis if drop else hys)
