"""InferenceEngine (reference ``deepspeed/inference/engine.py:89``;
counterpart of ``deepspeed_tpu/inference/engine.py``).

``forward`` runs the model's full-sequence forward (prefill and scoring);
``generate`` runs one prefill plus a decode loop over a contiguous KV cache,
with the JAX engine's shapes: prompts right-padded to a power-of-two bucket
(>= 16) and the cache rounded up to a multiple of 128 slots.  PyTorch runs
eagerly, so where the JAX engine compiles one program per shape the port
runs the same steps as a Python loop under ``torch.inference_mode()``.

Not ported yet (raise ``NotImplementedError`` naming the ROADMAP row): the
paged ``serving()`` engines, tensor-parallel auto-TP, weight quantization
and the full-recompute ``generate`` fallback for models without a KV cache.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..accelerator.real_accelerator import resolve_device
from ..utils.logging import log_dist, logger
from .config import DeepSpeedInferenceConfig
from .sampling import SamplingParams, position_generator, sample_tokens

_SERVING_ROW = ("the paged serving engines are not ported yet (ROADMAP queue 1, "
                "item 7)")


def _cast_tree(tree, dtype: torch.dtype, device: torch.device):
    """Floating leaves -> ``dtype`` on ``device`` (a no-op for leaves already
    there), integer leaves moved only.  One leaf at a time, so peak memory
    stays near one copy of the tree plus one leaf."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)


class InferenceEngine:
    def __init__(self, model: Any = None,
                 config: Optional[DeepSpeedInferenceConfig] = None,
                 apply_fn: Optional[Callable] = None, params: Any = None,
                 device=None):
        self._config = config or DeepSpeedInferenceConfig()
        if self._config.use_flash_decode:
            logger.warning("use_flash_decode is a retired knob, accepted for "
                           "config compatibility and ignored")
        tp = (self._config.tensor_parallel.tp_size
              if self._config.tensor_parallel.enabled else 1)
        if tp != 1:
            raise NotImplementedError(
                "tensor-parallel inference (tp_size > 1, auto-TP) is not ported "
                "yet (ROADMAP queue 1, item 4)")
        dtype = self._config.torch_dtype   # raises for weight quantization
        self.device = resolve_device(device)
        self._model = model if hasattr(model, "apply_cached") else None
        if model is not None:
            apply_fn = apply_fn or getattr(model, "apply_fn", None)
            params = params if params is not None else getattr(model, "params", None)
        if apply_fn is None:
            raise ValueError("InferenceEngine needs apply_fn(params, *args) "
                             "(directly or via a model adapter)")
        self.apply_fn = apply_fn
        self.params = None if params is None else _cast_tree(params, dtype,
                                                             self.device)
        log_dist(f"inference engine ready: device={self.device} "
                 f"dtype={self._config.dtype}", ranks=[0])

    @property
    def model(self):
        """The wrapped model adapter (reference InferenceEngine.module)."""
        return self._model

    def serving(self, **kwargs):
        raise NotImplementedError(_SERVING_ROW)

    def supervised_serving(self, max_restarts: int = 5, **kwargs):
        raise NotImplementedError(_SERVING_ROW)

    def serving_fleet(self, *args, **kwargs):
        raise NotImplementedError(
            "the serving fleet is not ported yet (ROADMAP queue 1, item 14)")

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def forward(self, input_ids, *args, **kwargs):
        with torch.inference_mode():
            tokens = self._tensor(input_ids, torch.long)
            if self.params is not None:
                return self.apply_fn(self.params, tokens, *args, **kwargs)
            return self.apply_fn(tokens, *args, **kwargs)

    __call__ = forward

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """Prompt-length bucket (next power of two >= 16)."""
        b = 16
        while b < n:
            b *= 2
        return b

    @staticmethod
    def _pad_prompt(input_ids, attention_mask):
        """Right-pad the (possibly ragged) prompt to its pow2 bucket and
        derive the cumulative positions (pads repeat the last real index)."""
        ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor)
                         else input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        B, S = ids.shape
        mask = (np.ones_like(ids, dtype=bool) if attention_mask is None
                else np.asarray(attention_mask.cpu()
                                if isinstance(attention_mask, torch.Tensor)
                                else attention_mask, dtype=bool))
        S_pad = InferenceEngine._bucket(S)
        toks = np.zeros((B, S_pad), ids.dtype)
        toks[:, :S] = ids
        mpad = np.zeros((B, S_pad), bool)
        mpad[:, :S] = mask
        pos = np.maximum(np.cumsum(mpad, axis=1) - 1, 0).astype(np.int32)
        return ids, toks, mpad, pos, B, S_pad

    def _decode(self, model, params, input_ids, attention_mask, max_new: int,
                eos_token_id: Optional[int], choose):
        """Prefill + ``max_new`` decode steps; ``choose(logits [B,V],
        positions [B]) -> tokens [B]`` picks each token.  Rows that emitted
        ``eos_token_id`` repeat it verbatim."""
        ids, toks, mpad, pos, B, S_pad = self._pad_prompt(input_ids,
                                                          attention_mask)
        T_cache = -(-(S_pad + max_new) // 128) * 128
        params = self.params if params is None else params
        with torch.inference_mode():
            mask_t = self._tensor(mpad)
            cache = model.init_cache(B, T_cache, dtype=model.config.dtype,
                                     device=self.device)
            logits, cache = model.apply_cached(
                params, self._tensor(toks, torch.long), cache,
                self._tensor(pos), mask_t)
            lengths = mask_t.sum(-1)                                   # [B]
            last = logits[torch.arange(B, device=self.device), lengths - 1]
            eos = -1 if eos_token_id is None else int(eos_token_id)
            done = torch.zeros(B, dtype=torch.bool, device=self.device)
            cur = lengths.clone()
            out = []
            for step in range(max_new):
                tok = choose(last, cur)
                tok = torch.where(done, torch.full_like(tok, eos), tok)
                done = done | (tok == eos)
                out.append(tok)
                if step + 1 < max_new:   # the last token's logits are unused
                    lg, cache = model.apply_cached(
                        params, tok[:, None], cache, cur[:, None], ~done[:, None])
                    last = lg[:, 0]
                cur = cur + 1
            ids_t = self._tensor(ids)
            new = (torch.stack(out, dim=1) if out else
                   torch.zeros((B, 0), dtype=torch.long, device=self.device))
            return torch.cat([ids_t, new.to(ids_t.dtype)], dim=1)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, greedy: bool = True,
                 rng: Optional[torch.Generator] = None, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, attention_mask=None,
                 model=None, params=None, sampling=None):
        """KV-cached autoregressive generation.

        Prompts may be right-padded ragged rows (pass ``attention_mask``).
        Returns the original ids with ``max_new_tokens`` tokens appended, as
        a tensor on the engine's device.  ``sampling`` — one
        :class:`SamplingParams` or one per row — switches to per-row lanes
        with counter-based generators (deterministic per seed and
        position); it excludes the legacy ``greedy``/``rng``/
        ``temperature``/``top_k``/``top_p`` knobs, where ``rng`` is one
        ``torch.Generator`` drawn from in order.
        """
        model = model or self._model
        if model is None or not hasattr(model, "apply_cached"):
            raise NotImplementedError(
                "generate() needs a KV-cache model (apply_cached); the "
                "full-recompute fallback is not ported yet (ROADMAP queue 1, "
                "item 6)")
        if sampling is not None:
            if rng is not None:
                raise ValueError(
                    "generate(sampling=...) derives its generators from "
                    "SamplingParams.seed — rng= would be silently ignored")
            if not greedy or temperature != 1.0 or top_k or top_p < 1.0:
                raise ValueError(
                    "generate(sampling=...) is mutually exclusive with the "
                    "legacy greedy/temperature/top_k/top_p knobs")
            return self._generate_lanes(model, input_ids, max_new_tokens,
                                        eos_token_id, sampling,
                                        attention_mask, params)
        if greedy:
            def choose(lg, pos):
                return torch.argmax(lg, dim=-1)
        else:
            if rng is None:
                rng = torch.Generator(device=self.device)
                rng.manual_seed(0)

            def choose(lg, pos):
                B = lg.shape[0]
                return sample_tokens(
                    lg, torch.full((B,), float(temperature), device=lg.device),
                    torch.full((B,), int(top_k), device=lg.device),
                    torch.full((B,), float(top_p), device=lg.device),
                    [rng] * B)
        return self._decode(model, params, input_ids, attention_mask,
                            max_new_tokens, eos_token_id, choose)

    def _generate_lanes(self, model, input_ids, max_new_tokens, eos_token_id,
                        sampling, attention_mask, params):
        B = 1 if np.ndim(input_ids) == 1 else len(input_ids)
        lanes = ([sampling] * B if isinstance(sampling, SamplingParams)
                 else list(sampling))
        if len(lanes) != B:
            raise ValueError(f"sampling: got {len(lanes)} SamplingParams for a "
                             f"batch of {B} rows (pass one, or one per row)")
        for sp in lanes:
            sp.validate()
        dev = self.device
        temp = torch.tensor([sp.temperature for sp in lanes], device=dev)
        top_k = torch.tensor([sp.top_k for sp in lanes], device=dev)
        top_p = torch.tensor([sp.top_p for sp in lanes], device=dev)

        def choose(lg, pos):
            # `pos` is the stream position each sampled token will occupy
            def gens():
                return [position_generator(sp.seed, int(p), dev)
                        for sp, p in zip(lanes, pos.tolist())]
            return sample_tokens(lg, temp, top_k, top_p, gens)

        return self._decode(model, params, input_ids, attention_mask,
                            max_new_tokens, eos_token_id, choose)
