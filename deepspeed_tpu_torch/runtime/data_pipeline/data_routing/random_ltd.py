"""Random layerwise token dropping (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_routing/random_ltd.py``;
reference ``runtime/data_pipeline/data_routing/random_ltd.py`` and
``scheduler.py``).

During training each layer processes a random subset of ``keep`` tokens
of every row; the dropped tokens bypass the layer through the residual
stream, and the kept count anneals up to the whole sequence.  The subset
is sorted, so causal order within it is the order of the positions: the
kept tokens attend causally among themselves on the flash kernels (RoPE
reads their gathered positions), whenever ``keep`` takes them.  The
indices are drawn on the generator's device (an argsort of uniform
noise, as the JAX package's shuffle), so no host sync is needed.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def select_tokens(generator: torch.Generator, B: int, S: int, keep: int) -> torch.Tensor:
    """[B, keep] sorted random token indices (no replacement), drawn from
    ``generator`` on its device."""
    noise = torch.rand((B, S), generator=generator, device=generator.device)
    idx = torch.argsort(noise, dim=1)[:, :keep]
    return torch.sort(idx, dim=1).values


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, ...] -> [B, keep, ...] along dim 1."""
    expand = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, expand.expand(idx.shape + x.shape[2:]))


def scatter_tokens(x_full: torch.Tensor, x_sub: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """``x_full`` with rows ``idx`` replaced by ``x_sub`` (a new tensor; the
    untouched rows are the residual bypass)."""
    expand = idx.reshape(idx.shape + (1,) * (x_full.ndim - 2))
    return x_full.scatter(1, expand.expand(idx.shape + x_full.shape[2:]),
                          x_sub.to(x_full.dtype))


def random_ltd_block(block_fn, x: torch.Tensor, positions: torch.Tensor,
                     generator: torch.Generator, keep: int,
                     deterministic: bool) -> Tuple[torch.Tensor, Any]:
    """One layer with token dropping: ``block_fn(x_sub, pos_sub) ->
    (out_sub, aux)`` on the kept subset, scattered back.  A passthrough
    (the whole sequence) when deterministic or ``keep`` is not in (0, S)."""
    B, S = x.shape[:2]
    if deterministic or keep >= S or keep <= 0:
        return block_fn(x, positions)
    idx = select_tokens(generator, B, S, keep).to(x.device)
    x_sub = gather_tokens(x, idx)
    pos_sub = torch.gather(positions, 1, idx.to(torch.int64)).to(positions.dtype)
    out_sub, aux = block_fn(x_sub, pos_sub)
    return scatter_tokens(x, out_sub, idx), aux


class RandomLTDScheduler:
    """Anneals the kept-token count (reference scheduler.py API:
    ``update_seq``/``get_current_seq``; fixed_linear schedule), quantised
    to ``seq_per_step`` as the JAX package's."""

    def __init__(self, config: Dict[str, Any]):
        sched = config.get("random_ltd_schedule", {})
        self.min_value = int(config.get("min_value", sched.get("min_value", 128)))
        self.max_value = int(config.get("max_value", sched.get("max_value", 2048)))
        self.schedule_type = sched.get("schedule_type", "fixed_linear")
        if self.schedule_type != "fixed_linear":
            raise ValueError(f"random_ltd schedule {self.schedule_type!r} "
                             "not supported (fixed_linear only)")
        sc = sched.get("schedule_config", {})
        self.seq_per_step = int(sc.get("seq_per_step", 16))
        self.require_steps = int(sc.get("require_steps", 1000))
        self.current_seq = self.min_value

    def get_current_seq(self) -> int:
        return self.current_seq

    def update_seq(self, global_steps: int) -> int:
        frac = min(1.0, global_steps / self.require_steps)
        raw = self.min_value + frac * (self.max_value - self.min_value)
        q = (int(raw) // self.seq_per_step) * self.seq_per_step
        self.current_seq = max(self.min_value, min(q, self.max_value))
        return self.current_seq

    def state_dict(self):
        return {"current_seq": self.current_seq}

    def load_state_dict(self, state):
        self.current_seq = state["current_seq"]
