"""Model zoo and the engine's model contract (counterpart of
``deepspeed_tpu/models/__init__.py``).

``CausalLM`` is an ``nn.Module`` that keeps the JAX package's functional
contract: ``init_fn`` makes a parameter tree, ``apply_fn(params, tokens)``
runs the forward, ``loss_fn(params, batch, generator)`` and ``eval_fn`` are
the training engine's model contract, ``init_cache``/``apply_cached`` drive
KV-cached decoding and ``init_paged_cache``/``apply_paged`` the paged
serving engine.
``load_params`` attaches a tree so that ``model(tokens)`` works as a module
call and ``init_inference(model)`` finds the weights.  ``param_specs`` is
the Megatron layout of the tree over the mesh's 'model' axis; inside
``parallel.tensor_parallel.region()`` (or with a global layout whose model
axis is above 1) every contract above runs on this rank's shards (padded
where uneven), the loss vocab-parallel and the logits gathered.
``shard_sequence`` cuts a batch to a rank's slice of the 'seq' axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..parallel import tensor_parallel
from ..utils.tree import tree_leaves, tree_map_with_path
from .transformer import (CONFIGS, PAGE_SIZE, TransformerConfig, cross_entropy_loss,
                          cross_entropy_terms, cut_params, forward, forward_cached,
                          forward_paged, get_config, has_moe, init_cache,
                          init_paged_cache, init_params, moe_layer_experts,
                          param_specs, pipeline_loss_and_backward, shard_params)

__all__ = ["CausalLM", "TransformerConfig", "CONFIGS", "get_config", "forward",
           "forward_cached", "forward_paged", "init_cache", "init_paged_cache",
           "init_params", "param_specs", "shard_params", "cut_params", "has_moe",
           "moe_layer_experts", "cross_entropy_loss", "cross_entropy_terms"]


class CausalLM(nn.Module):
    """Causal-LM adapter over the transformer family."""

    # the transformer dequantizes QuantizedWeight leaves at use, a layer at
    # a time (a quantized inference engine passes its tree as it is)
    reads_quantized = True

    def __init__(self, config="tiny", attn_impl: str = "auto", **overrides):
        super().__init__()
        self.config = get_config(config, **overrides)
        self.attn_impl = attn_impl
        self.params: Optional[Dict[str, Any]] = None

    @classmethod
    def from_hf(cls, model_or_path, dtype: Optional[torch.dtype] = None,
                attn_impl: str = "auto", checkpoint: Optional[str] = None,
                mesh=None, device=None, **overrides):
        """``(model, params)`` from an HF checkpoint (the JAX package's
        ``CausalLM.from_hf``; module_inject policies): a ``save_pretrained``
        directory, a live ``transformers`` module, or ``(config,
        state_dict)``.

        A directory streams leaf by leaf onto ``device`` (the accelerator's
        when None), each rank taking its model-axis shard on ``mesh``;
        ``checkpoint`` names another weight source (a DeepSpeed checkpoint
        json of per-mp-rank files, say) while ``model_or_path`` supplies the
        config.  A module or a pair converts densely.  ``dtype`` is the
        leaves' and the compute dtype (float32 leaves when None)."""
        from ..module_inject import load_hf_checkpoint, load_hf_checkpoint_sharded
        from ..module_inject.sharded_load import read_hf_config

        if checkpoint is not None:
            hf_config = (read_hf_config(model_or_path) if isinstance(model_or_path, str)
                         else getattr(model_or_path, "config", None))
            cfg, params = load_hf_checkpoint_sharded(
                checkpoint, dtype=dtype, mesh=mesh, hf_config=hf_config, device=device)
        elif isinstance(model_or_path, str):
            cfg, params = load_hf_checkpoint_sharded(model_or_path, dtype=dtype,
                                                     mesh=mesh, device=device)
        else:
            cfg, params = load_hf_checkpoint(model_or_path, dtype=dtype, device=device)
        if dtype is not None:
            # the compute dtype follows the leaves', or the decode loop
            # would mix precisions
            overrides = {"dtype": dtype, **overrides}
        return cls(cfg, attn_impl=attn_impl, **overrides), params

    def init_fn(self, generator: Optional[torch.Generator] = None, device=None,
                dtype: torch.dtype = torch.float32, tp=None,
                streamed: bool = False, cuts=None) -> Dict[str, Any]:
        """Random weights drawn from ``generator`` on ``device``;
        ``tp=(index, n)``: model-axis shard ``index`` of ``n`` of the same
        weights, each leaf drawn whole and cut (``cuts``: the 'expert' and
        'pipe' axes too); ``streamed=True``: the layer-streamed init, whose
        shards are drawn a layer at a time and whose values differ
        (``transformer.init_params``).  Inside an active ``OnDevice``
        the context's device and dtype apply."""
        from ..utils.init_on_device import on_device_init

        return on_device_init(lambda g, **kw: init_params(self.config, g, **kw))(
            generator, device=device, dtype=dtype, tp=tp, streamed=streamed, cuts=cuts)

    @property
    def param_specs(self) -> Dict[str, Any]:
        """The tensor-parallel layout (PartitionSpec-like tuples over the
        'model' axis), the JAX model's ``param_specs``."""
        return param_specs(self.config)

    def shard_params(self, params: Dict[str, Any], index: int, n: int):
        """Model-axis shard ``index`` of ``n`` of a full tree (padded where
        ``n`` does not divide a dim)."""
        return shard_params(self.config, params, index, n)

    def cut_params(self, params: Dict[str, Any], cuts):
        """This rank's pieces of a full tree over the 'model', 'expert' and
        'pipe' axes (``cuts``: axis -> (index, n))."""
        return cut_params(self.config, params, cuts)

    def shard_sequence(self, batch, index: int, n: int) -> Dict[str, Any]:
        """Rank ``index``'s contiguous slice of ``n`` of each row of a
        batch, for a 'seq' axis of ``n``: tokens, the labels (the default
        next-token shift taken on the whole row first, so no boundary
        token is lost) and any given positions, with the slice's offset
        and the whole length (default positions start there)."""
        tokens, labels, positions, pld_theta = self._split(batch)
        S = tokens.shape[1]
        if S % n:
            raise ValueError(f"a sequence of {S} tokens does not split over a "
                             f"'seq' axis of {n}")
        lo, hi = index * (S // n), (index + 1) * (S // n)
        out = {"input_ids": tokens[:, lo:hi], "labels": labels[:, lo:hi],
               "seq_offset": lo, "seq_len": S}
        if positions is not None:
            out["positions"] = positions[:, lo:hi]
        if pld_theta is not None:
            out["pld_theta"] = pld_theta
            out["pld_generator"] = batch.get("pld_generator")
        return out
    def frozen_spec(self) -> Optional[Dict[str, Any]]:
        """The engine's frozen-parameter contract (``requires_grad=False``
        semantics): a tree of bools (True = frozen) shaped like the
        parameter tree, from ``config.frozen_keywords``, or None when
        nothing is frozen.  A keyword freezes the leaves whose path holds it
        as an EXACT '/'-separated segment: 'embed' freezes 'embed' but not
        'pos_embed'; a '/'-qualified keyword matches that run of segments
        ('layers/wq' freezes layers/wq only)."""
        keywords = self.config.frozen_keywords
        if not keywords:
            return None
        if isinstance(keywords, str):   # tuple-vs-string slip: 'embed'
            keywords = (keywords,)      # must not iterate as characters
        shapes = init_params(self.config, torch.Generator(), device="meta")

        def frozen(path, _):
            name = "/" + path + "/"
            return any("/" + k.strip("/") + "/" in name for k in keywords)

        mask = tree_map_with_path(frozen, shapes)
        if not any(tree_leaves(mask)):
            raise ValueError(
                f"frozen_keywords {tuple(keywords)} matched no parameter "
                "path — keywords match exact '/'-separated segments "
                "('embed', 'wq') or qualified runs ('layers/wq'); paths "
                "look like 'layers/wq', 'embed', 'lm_head'")
        return mask

    def load_params(self, params: Dict[str, Any]) -> "CausalLM":
        self.params = params
        return self

    def apply_fn(self, params, tokens, positions=None, rng=None,
                 deterministic=True, return_aux=False, pld_theta=None,
                 gather_logits=True, seq_offset=0, seq_len=None, pld_generator=None):
        return forward(self.config, params, tokens, positions=positions, rng=rng,
                       attn_impl=self.attn_impl, deterministic=deterministic,
                       return_aux=return_aux, pld_theta=pld_theta,
                       gather_logits=gather_logits, seq_offset=seq_offset,
                       seq_len=seq_len, pld_generator=pld_generator)

    def _split(self, batch):
        """(tokens, labels, positions, pld_theta) of a batch: a dict with
        ``input_ids`` (``labels``, ``positions``, ``pld_theta`` optional) or
        the token tensor alone.  Labels default to the tokens shifted by one,
        with -100 (ignored) at the end (of the whole row: a slice from
        :meth:`shard_sequence` carries its labels).  The host generator
        progressive layer drop draws from rides along as
        ``pld_generator`` (the engine's)."""
        pld_theta = None
        if isinstance(batch, dict):
            tokens = batch["input_ids"]
            labels = batch.get("labels")
            positions = batch.get("positions")
            pld_theta = batch.get("pld_theta")
        else:
            tokens, labels, positions = batch, None, None
        if labels is None:
            labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                               dim=1)
        return tokens, labels, positions, pld_theta

    def loss_terms(self, params, batch, rng: Optional[torch.Generator] = None,
                   deterministic: bool = False):
        """(sum of the token NLL, count of labelled tokens) of a batch: the
        data-parallel engine's loss contract, so that the loss and its
        gradient are the global batch's mean whatever each rank's share of
        ignored labels.  An MoE model adds a third term, the scaled aux
        loss of this rank's rows."""
        tokens, labels, positions, pld_theta = self._split(batch)
        seq = {k: batch[k] for k in ("seq_offset", "seq_len", "pld_generator")
               if isinstance(batch, dict) and k in batch}
        sharded = tensor_parallel.active()
        moe = has_moe(self.config)
        out = self.apply_fn(params, tokens, positions=positions, rng=rng,
                            deterministic=deterministic,
                            pld_theta=None if deterministic else pld_theta,
                            gather_logits=not sharded, return_aux=moe, **seq)
        logits = out[0] if moe else out
        if sharded:
            terms = tensor_parallel.vocab_parallel_cross_entropy_terms(
                logits, labels, vocab_size=self.config.vocab_size)
        else:
            terms = cross_entropy_terms(logits, labels)
        if moe:
            # the MoE load-balancing term, JAX's moe_aux_loss_coef * aux
            # (models/__init__.py:147-155): a third term, this rank's mean
            # over its groups (the engine averages it over the data ranks)
            return terms + (self.config.moe_aux_loss_coef * out[1]["moe_aux_loss"],)
        return terms

    def _loss(self, params, batch, rng, deterministic):
        total, count, *aux = self.loss_terms(params, batch, rng, deterministic)
        loss = total / count.clamp(min=1)
        return loss + aux[0] if aux else loss

    def loss_fn(self, params, batch, rng: Optional[torch.Generator] = None):
        """Training loss (dropout on, drawn from ``rng``)."""
        return self._loss(params, batch, rng, deterministic=False)

    def eval_fn(self, params, batch, rng: Optional[torch.Generator] = None):
        return self._loss(params, batch, rng, deterministic=True)

    def pipeline_backward(self, params, batch, rng: Optional[torch.Generator] = None,
                          loss_scale: float = 1.0, transport=None, stages=None,
                          reduce_count=None, aux_ranks: int = 1, row0: int = 0):
        """A pipelined training step's forward and backward over ``batch``
        (the engine's whole window of this rank's rows), through
        ``config.pipeline_stages`` stages on ``config.pipeline_schedule``
        ('gpipe' or '1f1b'): gradients of ``loss_scale`` x the loss
        accumulate into the ``.grad`` of ``params``'s leaves.
        ``reduce_count`` sums the labelled-token count over the data ranks.
        Returns (the last stage's objective per microbatch, the MoE aux
        terms summed or None) (``transformer.pipeline_loss_and_backward``)."""
        tokens, labels, positions, _ = self._split(batch)
        if positions is not None:
            raise NotImplementedError("pipeline path requires default positions")
        count = (labels != -100).sum()
        if reduce_count is not None:
            count = reduce_count(count)
        return pipeline_loss_and_backward(
            self.config, params, tokens, labels, rng=rng, attn_impl=self.attn_impl,
            loss_scale=loss_scale, transport=transport, stages=stages, count=count,
            aux_ranks=aux_ranks, row0=row0)


    @property
    def param_count(self) -> int:
        return self.config.param_count

    def forward(self, tokens, positions=None):
        if self.params is None:
            raise ValueError("no weights: call load_params(init_fn(...)) first")
        return self.apply_fn(self.params, tokens, positions=positions)

    # -- KV-cached decode contract (used by InferenceEngine.generate) --
    def init_cache(self, batch_size, max_len, dtype=None, device=None):
        return init_cache(self.config, batch_size, max_len, dtype, device)

    def apply_cached(self, params, tokens, cache, positions, input_mask):
        return forward_cached(self.config, params, tokens, cache, positions,
                              input_mask, attn_impl=self.attn_impl)

    # -- block-paged decode contract (used by ServingEngine): one physical
    #    page pool multiplexed across decode slots via per-slot page tables --
    def init_paged_cache(self, num_pages, page_size=PAGE_SIZE, dtype=None,
                         kv_dtype=None, device=None):
        return init_paged_cache(self.config, num_pages, page_size, dtype,
                                kv_dtype=kv_dtype, device=device)

    def apply_paged(self, params, tokens, cache, page_table, start, seq_mask,
                    adapters=None, verify=False):
        return forward_paged(self.config, params, tokens, cache, page_table,
                             start, seq_mask, adapters=adapters, verify=verify)
