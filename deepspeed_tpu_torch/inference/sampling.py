"""Sampling: per-row lanes of temperature / top-k / top-p / seed
(counterpart of ``deepspeed_tpu/inference/sampling.py``).

- :class:`SamplingParams` — the per-request knobs; ``temperature <= 0`` is
  greedy, folded per row (never a division by zero).
- :func:`filter_logits` / :func:`sample_tokens` — dynamic per-row top-k and
  top-p from one full descending sort.
- **Counter-based generators** — the token at absolute stream position
  ``p`` of lane ``seed`` is drawn from :func:`position_generator` ``(seed,
  p)``: a fresh ``torch.Generator`` seeded from a hash of the pair (Philox
  on CUDA).  No state carries from token to token, so a stream replayed or
  resumed at any position re-derives the same draws.  The bits differ from
  the JAX package's ``fold_in`` keys: sampled streams are deterministic
  within the port, not equal to JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Union

import torch

__all__ = ["SamplingParams", "filter_logits", "position_generator",
           "sample_tokens"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling lane.  The defaults are greedy decoding."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> "SamplingParams":
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(
                f"top_p={self.top_p} must be in (0, 1] (1.0 disables the "
                "nucleus filter; <= 0 would keep an empty support)")
        if self.top_k < 0:
            raise ValueError(
                f"top_k={self.top_k} must be >= 0 (0 disables the filter)")
        if self.seed < 0:
            raise ValueError(f"seed={self.seed} must be >= 0")
        return self


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def position_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator for the token at absolute ``position`` of lane
    ``seed``: a pure function of the pair (and the device type)."""
    g = torch.Generator(device=device)
    g.manual_seed(_splitmix64(_splitmix64(int(seed)) ^ int(position)) >> 1)
    return g


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temper + filter ``[B, V]`` logits with per-row params (all ``[B]``),
    returning float32 logits with ``-inf`` outside the kept support.
    ``top_k <= 0`` / ``>= V`` and ``top_p >= 1`` disable their filter per
    row; ``temperature <= 0`` rows pass through unscaled."""
    lg = logits.float()
    V = lg.shape[-1]
    temperature = temperature.float()
    greedy = temperature <= 0.0
    lg = lg / torch.where(greedy, torch.ones_like(temperature), temperature)[:, None]
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    k_eff = torch.where((top_k <= 0) | (top_k >= V), torch.full_like(top_k, V),
                        top_k).long()
    kth = torch.gather(sorted_lg, -1, (k_eff - 1)[:, None])
    keep = lg >= kth
    ar = torch.arange(V, device=lg.device)
    sorted_masked = torch.where(ar[None, :] < k_eff[:, None], sorted_lg,
                                torch.full_like(sorted_lg, float("-inf")))
    cum = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    # keep the smallest prefix with mass >= top_p (the cutoff entry is kept)
    top_p = top_p.float()
    cutoff_idx = torch.clamp((cum < top_p[:, None]).sum(-1), max=V - 1)
    cutoff = torch.gather(sorted_masked, -1, cutoff_idx[:, None])
    keep &= (lg >= cutoff) | (top_p >= 1.0)[:, None]
    return torch.where(keep, lg, torch.full_like(lg, float("-inf")))


Generators = Union[Sequence[torch.Generator], Callable[[], Sequence[torch.Generator]]]


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  generators: Generators) -> torch.Tensor:
    """One token per row: ``[B, V]`` logits, ``[B]`` lanes, one generator per
    row (or a zero-argument callable returning them, invoked only when some
    row samples) -> ``[B]`` int64.  Greedy rows take the raw argmax."""
    greedy_tok = torch.argmax(logits, dim=-1)
    if not bool((temperature > 0.0).any()):
        return greedy_tok
    gens = generators() if callable(generators) else generators
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), dim=-1)
    sampled = torch.stack([torch.multinomial(probs[b], 1, generator=gens[b])[0]
                           for b in range(probs.shape[0])])
    return torch.where(temperature <= 0.0, greedy_tok, sampled)
