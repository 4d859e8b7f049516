"""Causal transformer family, dense half (PyTorch counterpart of
``deepspeed_tpu/models/transformer.py``).

Parameters are a nested dict under the JAX package's key names, with layer
weights stacked on a leading ``[L]`` dim and projections in JAX's ``x @ W``
layout (``wq`` is ``[d, nh*hd]``), so a JAX parameter tree loads without
transposes (``models/convert.py``).  The JAX ``lax.scan`` over layers is a
Python loop over ``[L]`` slices.

Ported: the dense causal-LM forward (``forward``) with its training passes
(dropout; remat through ``torch.utils.checkpoint`` under every policy of
the JAX package's ``_build_block``: ``nothing_saveable``, ``save_attn``,
``save_qkv``, ``save_matmuls``, ``dots_saveable``), the KV-cached decode
path (``init_cache``/``forward_cached``), the paged serving path
(``init_paged_cache``/``forward_paged``/``cow_copy_pool``, decode
attention through the K4 kernel) and ``cross_entropy_loss``.  MoE layers
(``num_experts`` > 1, or a PR-MoE pyramid's tuple: ``moe/sharded_moe.py``,
the aux loss summed over the layers and returned by ``forward(...,
return_aux=True)``) run on every path; a pipelined config
(``pipeline_stages`` > 1) trains through ``pipeline_loss_and_backward``.
A training forward runs progressive layer drop (``pld_theta``: the kept
layers only) and random-LTD (``random_ltd_keep`` tokens a layer, the kept
subset on the flash kernels at its length).  Activation fake-quant raises
``NotImplementedError`` until its slice lands (ROADMAP queue 1, item 11).

Matmuls promote mixed operand dtypes the way ``jnp`` does (``_mm``): a
bf16-activation model over fp32 weights computes those products in fp32.

Weight-quantized trees (``inference/quantization.py``): a leaf may be a
``QuantizedWeight``; every path dequantizes it at use, a layer at a time
(``_layer``/``_layers``) and the top-level leaves where they are read, so at
most one layer's compute-dtype copy is live (inside the decode CUDA graph
too).  Dequantization is elementwise, so the outputs are bit-equal to those
of the whole tree dequantized first.

Tensor parallelism (Megatron, the JAX package's ``param_specs``): inside
``parallel.tensor_parallel.region()`` each rank holds its model-axis
shards (``shard_params``, or ``init_params(..., tp=(rank, n))``) and the
same code runs on them: head counts come from the weights' shapes, so
attention (K1-K4 included) sees the rank's local heads; the column-parallel
products read their input through ``copy_to_model``, the row-parallel ones
sum through ``reduce_from_model``, the embedding and the head are
vocab-parallel, and the logits are gathered where a caller reads them
whole (``forward``'s default, the cached and paged paths).  A dim the
model axis does not divide is padded with zero weights (``shard_params``):
padded heads attend to nothing and write nothing, padded vocabulary
columns are cut from the logits and left out of the loss, padded FFN
columns are zero; grouped KV heads a model axis splits from their query
heads are gathered (``kv_gathered``).

Sequence parallelism (a global mesh whose 'seq' axis is above 1): each
rank runs its slice of every row, its positions offset by the slice's
start (``forward(seq_offset=)``), and ``_attention`` routes as the JAX
package does: ring attention over 'seq' (``ops/ring_attention.py``),
Ulysses on ``attn_impl="ulysses"``, and otherwise attention against the
whole sequence's keys gathered over 'seq'.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..accelerator import resolve_device
from ..moe.sharded_moe import MoEConfig, moe_ffn
from ..ops.kernels.common import NEG_INF
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import flash_attention
from ..ops.quantizer import QuantizedWeight
from ..parallel import tensor_parallel as _tp


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None        # None => MHA
    head_dim: Optional[int] = None            # None => hidden // heads
    max_seq_len: int = 2048
    norm: str = "rmsnorm"                     # rmsnorm | layernorm
    activation: str = "swiglu"    # swiglu | gelu | gelu_exact | relu | quick_gelu
    position: str = "rope"                    # rope | learned | alibi
    rope_theta: float = 10000.0
    rotary_dim: Optional[int] = None          # partial rotary (GPT-J/NeoX)
    rope_interleaved: bool = False            # GPT-J pair convention
    parallel_residual: bool = False           # GPT-J/NeoX
    shared_layernorm: bool = False            # GPT-J
    lm_head_bias: bool = False
    causal: bool = True
    post_layernorm: bool = False              # BERT-style blocks
    embed_layernorm: bool = False             # Bloom/BERT
    type_vocab_size: int = 0
    final_norm: bool = True
    norm_eps: float = 1e-5
    attention_layers: Optional[tuple] = None  # GPT-Neo "global"/"local"
    window_size: int = 256
    attn_softmax_scale: Optional[float] = None
    tie_embeddings: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    dropout: float = 0.0
    num_experts: Any = 1
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    moe_min_capacity: int = 8
    moe_aux_loss_coef: float = 0.01
    moe_drop_tokens: bool = True
    moe_use_residual: bool = False
    noisy_gate_policy: Optional[str] = None
    pipeline_stages: int = 1
    pipeline_microbatches: Optional[int] = None
    pipeline_schedule: str = "gpipe"
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    random_ltd: bool = False
    random_ltd_keep: int = 0
    act_quant_bits: int = 0
    act_quant_symmetric: bool = False
    scan_layers: bool = True
    flash_decode: Optional[bool] = None       # retired knob, accepted and ignored
    dtype: torch.dtype = torch.bfloat16       # activation dtype
    initializer_range: float = 0.02
    frozen_keywords: Tuple[str, ...] = ()

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def param_count(self) -> int:
        """Parameters of the tree (experts, routers and residual branches
        of MoE layers counted)."""
        d, f, v, L = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        hd, nh, nkv = self.dims_per_head, self.num_heads, self.kv_heads
        attn = d * hd * nh + 2 * d * hd * nkv + hd * nh * d
        if self.attn_bias:
            attn += nh * hd + 2 * nkv * hd + d
        mlp = 3 * d * f if self.activation == "swiglu" else 2 * d * f
        if self.mlp_bias:
            mlp += (2 * f if self.activation == "swiglu" else f) + d
        experts = (tuple(self.num_experts)
                   if isinstance(self.num_experts, (tuple, list))
                   else (self.num_experts,) * L)
        total_mlp = 0
        for E in experts:
            m = mlp
            if E > 1:
                m = mlp * E + d * E  # experts + router
                if self.moe_use_residual:
                    m += mlp + 2 * d  # dense residual branch + coefficient
            total_mlp += m
        n_norms = 1 if self.shared_layernorm else 2
        norms = n_norms * d * (2 if self.norm == "layernorm" else 1)
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.lm_head_bias and not self.tie_embeddings:
            embed += v
        pos = self.max_seq_len * d if self.position == "learned" else 0
        extra = 0
        if self.embed_layernorm:
            extra += d * (2 if self.norm == "layernorm" else 1)
        if self.type_vocab_size:
            extra += self.type_vocab_size * d
        final_norm = (d * (2 if self.norm == "layernorm" else 1)
                      if self.final_norm else 0)
        return L * (attn + norms) + total_mlp + embed + pos + extra + final_norm


# -- named configs (sizes from the public model cards) --
CONFIGS: Dict[str, TransformerConfig] = {
    "gpt2-125m": TransformerConfig(
        vocab_size=50257, hidden_size=768, intermediate_size=3072, num_layers=12,
        num_heads=12, max_seq_len=1024, norm="layernorm", activation="gelu",
        position="learned", tie_embeddings=True, attn_bias=True, mlp_bias=True,
        norm_eps=1e-5),
    "gpt2-1.3b": TransformerConfig(
        vocab_size=50257, hidden_size=2048, intermediate_size=8192, num_layers=24,
        num_heads=16, max_seq_len=1024, norm="layernorm", activation="gelu",
        position="learned", tie_embeddings=True, attn_bias=True, mlp_bias=True),
    "llama2-7b": TransformerConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_layers=32,
        num_heads=32, max_seq_len=4096),
    "llama2-13b": TransformerConfig(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824, num_layers=40,
        num_heads=40, max_seq_len=4096),
    "llama2-70b": TransformerConfig(
        vocab_size=32000, hidden_size=8192, intermediate_size=28672, num_layers=80,
        num_heads=64, num_kv_heads=8, max_seq_len=4096),
    "bloom-7b": TransformerConfig(
        vocab_size=250880, hidden_size=4096, intermediate_size=16384, num_layers=30,
        num_heads=32, max_seq_len=2048, norm="layernorm", activation="gelu",
        position="alibi", attn_bias=True, mlp_bias=True, tie_embeddings=True),
    "opt-1.3b": TransformerConfig(
        vocab_size=50272, hidden_size=2048, intermediate_size=8192, num_layers=24,
        num_heads=32, max_seq_len=2048, norm="layernorm", activation="gelu",
        position="learned", attn_bias=True, mlp_bias=True, tie_embeddings=True),
    "llama-374m": TransformerConfig(
        vocab_size=32000, hidden_size=1024, intermediate_size=2816, num_layers=24,
        num_heads=16, max_seq_len=2048),
    "llama-1b": TransformerConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=16,
        num_heads=16, max_seq_len=2048),
    "llama-740m": TransformerConfig(
        vocab_size=32000, hidden_size=1792, intermediate_size=4864, num_layers=16,
        num_heads=14, max_seq_len=4096),
    # tiny variants for tests
    "tiny": TransformerConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, max_seq_len=128, remat=False),
    "tiny-gpt2": TransformerConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, max_seq_len=128, norm="layernorm", activation="gelu",
        position="learned", tie_embeddings=True, attn_bias=True, mlp_bias=True,
        remat=False),
    "tiny-gqa": TransformerConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=8, num_kv_heads=2, max_seq_len=128, remat=False),
    "tiny-moe": TransformerConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, max_seq_len=128, num_experts=4, moe_top_k=2, remat=False),
    "tiny-prmoe": TransformerConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, max_seq_len=128, num_experts=(1, 4), moe_top_k=2,
        moe_use_residual=True, scan_layers=False, remat=False),
}

# Mixtral-8x7B's published widths (``mistralai/Mixtral-8x7B-v0.1``
# config.json): every token kept (no capacity drops) and the router aux
# coefficient 0.02; not in the JAX package's table, made of its fields
CONFIGS["mixtral-8x7b"] = TransformerConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=32768, rope_theta=1e6,
    norm_eps=1e-5, num_experts=8, moe_top_k=2, moe_drop_tokens=False,
    moe_aux_loss_coef=0.02)


def get_config(name_or_cfg, **overrides) -> TransformerConfig:
    cfg = CONFIGS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def moe_layer_experts(cfg: TransformerConfig) -> Tuple[int, ...]:
    """Per-layer expert counts; a scalar broadcasts (PR-MoE pyramids give
    one count a layer, 1 = a dense layer)."""
    if isinstance(cfg.num_experts, (tuple, list)):
        if len(cfg.num_experts) != cfg.num_layers:
            raise ValueError(
                f"num_experts tuple has {len(cfg.num_experts)} entries for "
                f"{cfg.num_layers} layers")
        return tuple(int(e) for e in cfg.num_experts)
    return (int(cfg.num_experts),) * cfg.num_layers


def has_moe(cfg: TransformerConfig) -> bool:
    return max(moe_layer_experts(cfg)) > 1


def _het(cfg: TransformerConfig) -> bool:
    """A PR-MoE pyramid: per-layer expert counts, ``params['layers']`` a
    list of per-layer dicts."""
    return isinstance(cfg.num_experts, (tuple, list))


def layer_windows(cfg: TransformerConfig) -> Optional[list]:
    """Per-layer local-attention window sizes (0 = global) from
    cfg.attention_layers, or None when the config has no alternation."""
    if cfg.attention_layers is None:
        return None
    if len(cfg.attention_layers) != cfg.num_layers:
        raise ValueError(
            f"attention_layers has {len(cfg.attention_layers)} entries for "
            f"{cfg.num_layers} layers")
    return [cfg.window_size if t == "local" else 0 for t in cfg.attention_layers]


def _sm_scale(cfg: TransformerConfig, hd: int) -> float:
    return (cfg.attn_softmax_scale if cfg.attn_softmax_scale is not None
            else 1.0 / math.sqrt(hd))


def _check_supported(cfg: TransformerConfig) -> None:
    if _het(cfg):
        moe_layer_experts(cfg)
        if cfg.pipeline_stages > 1:
            raise NotImplementedError(
                "per-layer num_experts (PR-MoE pyramid) + pipeline parallelism "
                "is not supported (stages need uniform layer stacks)")
        if cfg.mlp_bias or cfg.attn_bias:
            raise NotImplementedError(
                "PR-MoE pyramid configs do not support attn/mlp biases")
    if has_moe(cfg) and cfg.mlp_bias and cfg.activation == "swiglu":
        raise ValueError("swiglu MoE experts do not support mlp_bias")
    if cfg.pipeline_stages > 1:
        if cfg.num_layers % cfg.pipeline_stages:
            raise ValueError(
                f"num_layers={cfg.num_layers} not divisible by pipeline "
                f"stages={cfg.pipeline_stages}")
        if cfg.attention_layers is not None:
            raise NotImplementedError(
                "pipeline parallelism with per-layer attention types "
                "(attention_layers) is not supported")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """Megatron-style tensor-parallel specs over the 'model' axis, entry for
    entry the JAX package's (``deepspeed_tpu/models/transformer.py``
    ``param_specs``), as PartitionSpec-like tuples: columns for wq/wk/wv,
    w_gate/w_up/w_in and their biases, rows for wo/w_down, a vocab-parallel
    ``embed`` and ``lm_head``, norms and the other biases replicated.  The
    ZeRO planner composes ('data', 'expert') onto them.

    MoE layers (the JAX package's entries): experts on 'expert' with
    expert-internal tensor parallelism on 'model' (``[L, E, d, f]`` is
    ``(None, 'expert', None, 'model')``), the router and the residual
    coefficient replicated, the residual branch Megatron-cut as a dense
    MLP.  A PR-MoE pyramid gets a list of per-layer dicts.  Under
    ``pipeline_stages > 1`` the layer dim of every stacked leaf rides
    'pipe' (the port keeps ``[L, ...]`` stacks: a pipe rank holds its
    stage's contiguous layers, where JAX reshapes to ``[P, L/P, ...]``)."""
    _check_supported(cfg)
    if _het(cfg):
        return _param_specs_het(cfg)
    layers = _layer_specs(cfg, cfg.num_experts, stacked=True)
    if cfg.pipeline_stages > 1:
        layers = {k: ("pipe",) + tuple(v[1:]) for k, v in layers.items()}
    return _top_specs(cfg, layers)


def _layer_specs(cfg: TransformerConfig, E: int, stacked: bool) -> Dict[str, Any]:
    """One layer's specs (with a leading None for the ``[L]`` dim when
    ``stacked``)."""
    lead = (None,) if stacked else ()
    col, row = lead + (None, "model"), lead + ("model", None)
    rep = lead + (None,)
    layers: Dict[str, Any] = {"attn_norm_scale": rep, "wq": col, "wk": col,
                              "wv": col, "wo": row}
    if not cfg.shared_layernorm:
        layers["mlp_norm_scale"] = rep
    if cfg.norm == "layernorm":
        layers["attn_norm_bias"] = rep
        if not cfg.shared_layernorm:
            layers["mlp_norm_bias"] = rep
    if E > 1:
        # the reference's expert-parallel groups (utils/groups.py:113)
        mcol = lead + ("expert", None, "model")
        mrow = lead + ("expert", "model", None)
        layers["router"] = lead + (None, None)
    else:
        mcol, mrow = col, row
    if cfg.activation == "swiglu":
        layers.update(w_gate=mcol, w_up=mcol, w_down=mrow)
    else:
        layers.update(w_in=mcol, w_down=mrow)
    if E > 1 and cfg.moe_use_residual:
        if cfg.activation == "swiglu":
            layers.update(res_w_gate=col, res_w_up=col, res_w_down=row)
        else:
            layers.update(res_w_in=col, res_w_down=row)
        layers["coefficient"] = lead + (None, None)
    if cfg.attn_bias:
        layers.update(bq=lead + ("model",), bk=lead + ("model",),
                      bv=lead + ("model",), bo=rep)
    if cfg.mlp_bias:
        if cfg.activation == "swiglu":
            layers.update(b_gate=lead + ("model",), b_up=lead + ("model",))
        elif E > 1:      # per-expert biases [L, E, f]
            layers["b_in"] = lead + ("expert", "model")
        else:
            layers["b_in"] = lead + ("model",)
        layers["b_down"] = (lead + ("expert", None) if E > 1
                            and cfg.activation != "swiglu" else rep)
    return layers


def _param_specs_het(cfg: TransformerConfig) -> Dict[str, Any]:
    """Per-layer spec dicts mirroring :func:`_init_params_het`."""
    return _top_specs(cfg, [_layer_specs(cfg, E, stacked=False)
                            for E in moe_layer_experts(cfg)])


def _top_specs(cfg: TransformerConfig, layers) -> Dict[str, Any]:
    specs: Dict[str, Any] = {"embed": ("model", None), "layers": layers}
    if cfg.final_norm:
        specs["final_norm_scale"] = ()
        if cfg.norm == "layernorm":
            specs["final_norm_bias"] = ()
    if cfg.position == "learned":
        specs["pos_embed"] = (None, None)
    if cfg.embed_layernorm:
        specs["embed_norm_scale"] = ()
        if cfg.norm == "layernorm":
            specs["embed_norm_bias"] = ()
    if cfg.type_vocab_size:
        specs["type_embed"] = (None, None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model")
        if cfg.lm_head_bias:
            specs["lm_head_bias"] = ("model",)
    return specs


_HEAD_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv"})


def tp_units(cfg: TransformerConfig) -> Dict[str, Any]:
    """The unit of each leaf's model-axis dim, shaped like
    :func:`param_specs`: a head-sharded leaf pads and cuts whole heads
    (the head dim), every other leaf single rows or columns."""
    specs = param_specs(cfg)
    hd = cfg.dims_per_head
    units: Dict[str, Any] = {k: 1 for k in specs if k != "layers"}

    def layer(ls):
        return {k: hd if k in _HEAD_LEAVES else 1 for k in ls}

    units["layers"] = ([layer(ls) for ls in specs["layers"]] if _het(cfg)
                       else layer(specs["layers"]))
    return units


def kv_gathered(cfg: TransformerConfig, n: int) -> bool:
    """Whether a model axis of ``n`` splits grouped KV heads apart from
    the query heads that read them (GQA with ``kv_heads % n != 0``): each
    rank then gathers the KV heads and keeps, for each of its query heads,
    the one that head reads (``i // G``)."""
    return n > 1 and cfg.kv_heads != cfg.num_heads and cfg.kv_heads % n != 0


def local_heads(cfg: TransformerConfig, n: int) -> Tuple[int, int]:
    """(query heads, KV heads) of one rank at a model axis of ``n``: the
    padded head counts over ``n`` (the rank's gathered KV heads, one per
    query head, under :func:`kv_gathered`)."""
    hq = _tp.padded(cfg.num_heads, n) // n
    if kv_gathered(cfg, n):
        return hq, hq
    return hq, _tp.padded(cfg.kv_heads, n) // n


def shard_params(cfg: TransformerConfig, params: Dict[str, Any], index: int,
                 n: int) -> Dict[str, Any]:
    """Model-axis shard ``index`` of ``n`` of a full parameter tree (the
    contiguous chunk of each leaf's ``param_specs`` dim, padded with zeros
    where ``n`` does not divide it: whole heads, vocabulary rows, FFN
    columns)."""
    return _tp.slice_tree(params, param_specs(cfg), index, n, tp_units(cfg))


def _leaf_seed(base: int, name: str, layer: int) -> int:
    # one stream per (leaf, layer), independent of which other leaves exist
    return (base + zlib.crc32(name.encode()) * 0x9E3779B97F4A7C15
            + layer * 0xBF58476D1CE4E5B9) % 2 ** 63


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype: torch.dtype = torch.float32,
                tp: Optional[Tuple[int, int]] = None,
                streamed: bool = False,
                cuts: Optional[Dict[str, Tuple[int, int]]] = None) -> Dict[str, Any]:
    """Random parameters with the JAX package's keys, shapes and scales
    (normal * initializer_range; residual projections / sqrt(2L); norms 1,
    biases 0).  Each leaf is drawn in fp32 from ``generator`` and cast to
    ``dtype`` at once, so peak memory is the tree in ``dtype`` plus one
    fp32 leaf.

    ``tp=(index, n)`` keeps model-axis shard ``index`` of ``n`` of each
    leaf (:func:`shard_params`: padded where ``n`` does not divide it): the
    same draws, in the same order, as the whole tree, each leaf cut and
    freed before the next is drawn, so one seed names the same weights at
    every model axis and peak memory is the shards plus one fp32 leaf.
    ``cuts`` (``{"expert": (i, n), "pipe": (i, n)}``, ``"model"`` as
    ``tp``) cuts the other axes of ``param_specs`` the same way
    (:func:`cut_params`).

    ``streamed=True`` draws the layer-streamed init instead, for a model
    whose largest leaf does not fit one device: ``generator`` gives one
    base seed, and each layer of each leaf is drawn whole from its own
    stream, seeded from it, the leaf's name and the layer, then cut to the
    shard (llama2-70b's ``w_gate`` is 80 x 8192 x 28672).  Its values
    differ from the default init's; with ``tp=(0, 1)`` it is whole, and
    every shard equals :func:`shard_params` of it.  The values differ from
    ``jax.random``'s: load a JAX tree through ``models/convert.py`` to
    compare the two packages.  The device is ``device``, else the
    generator's, else the accelerator's (CUDA; raises without a card).

    MoE layers add the router ``[L, d, E]`` and ``[L, E, ...]`` expert
    leaves (and the residual branch and ``coefficient`` under
    ``moe_use_residual``); a PR-MoE pyramid (``num_experts`` a tuple)
    gives ``params['layers']`` as a list of per-layer dicts, each layer's
    leaves drawn in turn."""
    _check_supported(cfg)
    d, f = cfg.hidden_size, cfg.intermediate_size
    hd, nh, nkv, L = cfg.dims_per_head, cfg.num_heads, cfg.kv_heads, cfg.num_layers
    std = cfg.initializer_range
    cuts = dict(cuts or {})
    if tp is not None:
        cuts["model"] = tp
    index, n = cuts.get("model", (0, 1))
    specs = param_specs(cfg)
    units = tp_units(cfg)
    het = _het(cfg)
    device = resolve_device(device if device is not None or generator is None
                            else generator.device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    base = (int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                              device=generator.device)) if streamed else 0)

    def cut(x, spec, u):
        x = _tp.shard_leaf(x, spec, index, n, u)   # a copy: frees the whole
        return _cut_other(x, spec, cuts)

    def dense(name, shape, spec, unit, scale=std, stacked=False):
        if not streamed:
            x = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32)
            return cut(x, spec, unit).mul_(scale).to(dtype)
        out = None
        layer_spec = spec[1:] if stacked else spec
        for layer in range(shape[0] if stacked else 1):
            g = torch.Generator(device=device)
            g.manual_seed(_leaf_seed(base, name, layer))
            x = torch.randn(shape[1:] if stacked else shape, generator=g,
                            device=device, dtype=torch.float32)
            x = _tp.shard_leaf(x, layer_spec, index, n, unit).mul_(scale).to(dtype)
            if not stacked:
                return x
            if out is None:   # the stacked leaf, filled a layer at a time
                out = torch.empty((shape[0],) + tuple(x.shape), dtype=dtype, device=device)
            out[layer] = x
        return _cut_other(out, spec, cuts)

    def const(fill, shape, spec, unit=1):
        shape = _tp.local_shape(shape, spec, n, unit)
        return _cut_other(torch.full(shape, fill, device=device, dtype=dtype), spec, cuts)

    resid = std / math.sqrt(2 * L)

    def layer_leaves(lspecs, lunits, E, lead):
        """One layer's leaves (``lead`` = (L,) for stacks, () for a
        pyramid's layer)."""
        stacked = bool(lead)

        def w(name, *shape, scale=std):
            return dense(name, lead + shape, lspecs[name], lunits[name], scale, stacked)

        def c(fill, name, *shape):
            return const(fill, lead + shape, lspecs[name], lunits[name])

        lp: Dict[str, Any] = {
            "attn_norm_scale": c(1.0, "attn_norm_scale", d),
            "wq": w("wq", d, nh * hd),
            "wk": w("wk", d, nkv * hd),
            "wv": w("wv", d, nkv * hd),
            "wo": w("wo", nh * hd, d, scale=resid),
        }
        if not cfg.shared_layernorm:
            lp["mlp_norm_scale"] = c(1.0, "mlp_norm_scale", d)
        if cfg.norm == "layernorm":
            lp["attn_norm_bias"] = c(0.0, "attn_norm_bias", d)
            if not cfg.shared_layernorm:
                lp["mlp_norm_bias"] = c(0.0, "mlp_norm_bias", d)
        ex = (E,) if E > 1 else ()
        if E > 1:
            lp["router"] = w("router", d, E)
        if cfg.activation == "swiglu":
            lp["w_gate"] = w("w_gate", *ex, d, f)
            lp["w_up"] = w("w_up", *ex, d, f)
        else:
            lp["w_in"] = w("w_in", *ex, d, f)
        lp["w_down"] = w("w_down", *ex, f, d, scale=resid)
        if E > 1 and cfg.moe_use_residual:
            if cfg.activation == "swiglu":
                lp["res_w_gate"] = w("res_w_gate", d, f)
                lp["res_w_up"] = w("res_w_up", d, f)
            else:
                lp["res_w_in"] = w("res_w_in", d, f)
            lp["res_w_down"] = w("res_w_down", f, d, scale=resid)
            lp["coefficient"] = w("coefficient", d, 2)
        if cfg.attn_bias:
            lp["bq"] = c(0.0, "bq", nh * hd)
            lp["bk"] = c(0.0, "bk", nkv * hd)
            lp["bv"] = c(0.0, "bv", nkv * hd)
            lp["bo"] = c(0.0, "bo", d)
        if cfg.mlp_bias:
            if cfg.activation == "swiglu":
                lp["b_gate"] = c(0.0, "b_gate", f)
                lp["b_up"] = c(0.0, "b_up", f)
            else:
                lp["b_in"] = c(0.0, "b_in", *ex, f)
            lp["b_down"] = c(0.0, "b_down", *(ex if cfg.activation != "swiglu" else ()), d)
        return lp

    if het:
        layers: Any = [layer_leaves(ls, lu, E, ())
                       for ls, lu, E in zip(specs["layers"], units["layers"],
                                            moe_layer_experts(cfg))]
    else:
        layers = layer_leaves(specs["layers"], units["layers"], cfg.num_experts, (L,))

    params: Dict[str, Any] = {"embed": dense("embed", (cfg.vocab_size, d), specs["embed"],
                                             units["embed"]),
                              "layers": layers}
    if cfg.final_norm:
        params["final_norm_scale"] = const(1.0, (d,), ())
        if cfg.norm == "layernorm":
            params["final_norm_bias"] = const(0.0, (d,), ())
    if cfg.position == "learned":
        params["pos_embed"] = dense("pos_embed", (cfg.max_seq_len, d), (None, None), 1)
    if cfg.embed_layernorm:
        params["embed_norm_scale"] = const(1.0, (d,), ())
        if cfg.norm == "layernorm":
            params["embed_norm_bias"] = const(0.0, (d,), ())
    if cfg.type_vocab_size:
        params["type_embed"] = dense("type_embed", (cfg.type_vocab_size, d), (None, None), 1)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense("lm_head", (d, cfg.vocab_size), specs["lm_head"],
                                  units["lm_head"])
        if cfg.lm_head_bias:
            params["lm_head_bias"] = const(0.0, (cfg.vocab_size,), ("model",))
    return params


CUT_AXES = ("expert", "pipe")   # the axes besides 'model' a rank holds a piece of


def _cut_other(x: torch.Tensor, spec, cuts: Dict[str, Tuple[int, int]]) -> torch.Tensor:
    """``x`` cut over the 'expert' and 'pipe' axes of ``cuts`` along the
    dims ``spec`` names for them (contiguous, even chunks)."""
    for axis in CUT_AXES:
        i, n = cuts.get(axis, (0, 1))
        dim = _tp.spec_dim(spec, axis)
        if dim is None or n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                             f"an {axis!r} axis of {n}")
        x = x.chunk(n, dim)[i].clone(memory_format=torch.contiguous_format)
    return x


def cut_params(cfg: TransformerConfig, params: Dict[str, Any],
               cuts: Dict[str, Tuple[int, int]]) -> Dict[str, Any]:
    """This rank's pieces of a whole tree: ``cuts`` maps 'model', 'expert'
    and 'pipe' to (index, n); the model axis as :func:`shard_params`
    (padded where uneven), the expert and pipe axes in even chunks of the
    dims ``param_specs`` names (the experts of MoE leaves, the layers of a
    pipelined config)."""
    specs = param_specs(cfg)
    i, n = cuts.get("model", (0, 1))
    if n > 1:
        params = shard_params(cfg, params, i, n)
    return _tp._walk(lambda x, spec: _cut_other(x, spec, cuts), params, specs)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's type promotion (bf16 @ fp32 -> fp32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _norm(cfg, x, scale, bias=None):
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + cfg.norm_eps) * scale
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps) * scale + bias
    return out.to(x.dtype)


def _rope(q, k, positions, theta, head_dim, rotary_dim=None, interleaved=False):
    """Rotary embedding: full or partial (``rotary_dim``), half-split
    (llama/neox) or interleaved pairs (GPT-J)."""
    rd = head_dim if rotary_dim is None else rotary_dim
    half = rd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=q.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs            # [B,S,half]
    cos, sin = torch.cos(angles), torch.sin(angles)

    def rot(x):  # x: [B,S,H,hd]
        x_rot, x_pass = x[..., :rd], x[..., rd:]
        c = cos[:, :, None, :].to(x.dtype)
        s = sin[:, :, None, :].to(x.dtype)
        if interleaved:
            x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
            r1, r2 = x1 * c - x2 * s, x2 * c + x1 * s
            out = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
        else:
            x1, x2 = x_rot[..., :half], x_rot[..., half:]
            out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        return out if rd == x.shape[-1] else torch.cat([out, x_pass], dim=-1)

    return rot(q), rot(k)


def _alibi_slopes(num_heads: int) -> np.ndarray:
    # standard ALiBi slope schedule (power-of-2 geometric)
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-8.0 / closest)
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest < num_heads:
        extra_base = 2.0 ** (-4.0 / closest)
        slopes += [extra_base ** (2 * i + 1) for i in range(num_heads - closest)]
    return np.asarray(slopes, dtype=np.float32)


def _head_slopes(cfg, num_heads: int, device) -> torch.Tensor:
    """The ALiBi slopes of this rank's ``num_heads`` heads: all of the
    config's, or under tensor parallelism this rank's contiguous slice."""
    slopes = _alibi_slopes(cfg.num_heads)
    if num_heads != cfg.num_heads:
        i = _tp.rank()
        # padded heads (uneven shards) get slope 0: their weights are zero
        slopes = np.pad(slopes, (0, max(0, (i + 1) * num_heads - len(slopes))))
        slopes = slopes[i * num_heads:(i + 1) * num_heads]
    return torch.from_numpy(np.ascontiguousarray(slopes)).to(device)


def _alibi_bias(cfg, q_pos, k_pos, num_heads, dtype):
    slopes = _head_slopes(cfg, num_heads, q_pos.device)
    rel = (k_pos[:, None, :] - q_pos[:, :, None]).float()          # [B,q,k]
    return (-rel.abs()[:, None, :, :] * slopes[None, :, None, None]).to(dtype)


def _global_layout():
    from ..parallel import mesh as mesh_mod

    return mesh_mod._GLOBAL_LAYOUT


def _seq_layout():
    """The global mesh layout when its 'seq' axis is above 1 (the model's
    tokens are then a rank's slice of each row), else None."""
    layout = _global_layout()
    return layout if layout is not None and layout.sp > 1 else None


def _mesh_desc(layout) -> str:
    if layout is None:
        return "none"
    from ..parallel.mesh import MESH_AXES

    return str(dict(zip(MESH_AXES, layout.axis_sizes())))


def _takes_flash(cfg, S, attn_impl, custom_positions, window) -> bool:
    """Whether ``_attention`` takes the one-device flash kernel at these
    arguments (a sequence-parallel mesh routes elsewhere)."""
    if attn_impl == "auto":
        attn_impl = "pallas" if S >= 2048 else "xla"
    return (attn_impl == "pallas" and cfg.position != "alibi" and cfg.causal
            and not custom_positions and window is None and S % 128 == 0
            and _seq_layout() is None)


def _plain_attention(cfg, q, k, v, q_pos, k_pos, window=None):
    """The plain branch (``"xla"`` in JAX): q [B,Sq,Hq,hd] against k/v
    [B,Sk,Hkv,hd] at positions ``q_pos`` [B,Sq] and ``k_pos`` [B,Sk]."""
    Hq, hd, Hkv = q.shape[2], q.shape[3], k.shape[2]
    if Hkv != Hq:  # GQA: repeat KV groups
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) * _sm_scale(cfg, hd)).float()
    if cfg.position == "alibi":
        scores = scores + _alibi_bias(cfg, q_pos, k_pos, Hq, torch.float32)
    if cfg.causal:
        causal = q_pos[:, None, :, None] >= k_pos[:, None, None, :]
        scores = scores.masked_fill(~causal, NEG_INF)
    if window is not None:
        rel = q_pos[:, None, :, None] - k_pos[:, None, None, :]
        local_ok = (rel < window) | (window <= 0)
        scores = scores.masked_fill(~local_ok, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _seq_attention(cfg, q, k, v, positions, attn_impl, custom_positions, window,
                   layout):
    """Attention of this rank's slice of the sequence on a 'seq' axis above
    1: the JAX package's routing and messages
    (``deepspeed_tpu/models/transformer.py`` ``_attention``), S, B and the
    head counts read as the whole model's (S the whole sequence)."""
    from ..ops import ring_attention as ra

    B, S_l, _, hd = q.shape
    sp, tp = layout.sp, layout.tp
    S, B_g, dp = S_l * sp, B * layout.dp_world_size, layout.dp_world_size
    Hq, Hkv = cfg.num_heads, cfg.kv_heads
    sm = _sm_scale(cfg, hd)
    if attn_impl in ("auto", "ring", "pallas") and cfg.position != "alibi" \
            and cfg.causal and not custom_positions and window is None:
        failed = [c for c, ok in [
            (f"S={S} % sp={sp}", S % sp == 0),
            (f"Hq={Hq} % tp={tp}", Hq % tp == 0),
            (f"Hkv={Hkv} % tp={tp}", Hkv % tp == 0),
            (f"B={B_g} % dp={dp}", B_g % dp == 0)] if not ok]
        if not failed:
            return ra.ring_attention_sharded(q, k, v, causal=True, sm_scale=sm)
        if attn_impl == "ring":
            raise ValueError(f"ring attention requested but unsatisfiable: {failed}")
    elif attn_impl == "ring":
        raise ValueError("ring attention requires a mesh with seq > 1, "
                         "default positions, and non-alibi attention")
    if attn_impl == "ulysses":
        failed = [c for c, ok in [
            (f"Hq={Hq} % sp*tp={sp * tp}", Hq % (sp * tp) == 0),
            (f"Hkv={Hkv} % sp*tp={sp * tp}", Hkv % (sp * tp) == 0),
            (f"S={S} % 128", S % 128 == 0),
            (f"B={B_g} % dp={dp}", B_g % dp == 0),
            ("pipe=1", layout.pp == 1),
            ("causal", bool(cfg.causal)),
            ("non-alibi", cfg.position != "alibi"),
            ("default positions", not custom_positions),
            ("no window", window is None)] if not ok]
        if failed:
            raise ValueError(f"ulysses attention unsatisfiable: {failed}")
        return ra.ulysses_attention(q, k, v, lambda q, k, v: flash_attention(
            q, k, v, causal=True, sm_scale=sm).to(q.dtype))
    # no ring: every rank attends to the whole sequence's keys (the JAX
    # package lets GSPMD gather them into its plain branch)
    from .. import comm

    k_pos = comm.all_gather(positions.contiguous(), ra.SEQ_AXIS, gather_dim=1)
    return _plain_attention(cfg, q, ra.gather_sequence(k), ra.gather_sequence(v),
                            positions, k_pos, window)


def _attention(cfg: TransformerConfig, q, k, v, positions, attn_impl: str = "xla",
               custom_positions: bool = False, window=None):
    """q:[B,S,Hq,hd] k,v:[B,S,Hkv,hd] -> [B,S,Hq,hd].

    Dispatch follows the JAX package exactly: on a mesh whose 'seq' axis
    is above 1, ring attention, Ulysses or the gathered plain branch
    (:func:`_seq_attention`); ``"ring"``/``"ulysses"`` without one raise
    JAX's errors.  Otherwise ``"auto"`` takes the flash kernel once S >=
    2048; ``"pallas"`` (the JAX package's name for it, kept so configs
    read the same) takes it when attention is causal, non-alibi, at
    default positions, without a window and S % 128 == 0; everything else
    takes the plain branch (``"xla"`` in JAX)."""
    B, S, Hq, hd = q.shape
    layout = _seq_layout()
    if layout is not None:
        return _seq_attention(cfg, q, k, v, positions, attn_impl, custom_positions,
                              window, layout)
    if attn_impl == "ring":
        if cfg.position != "alibi" and cfg.causal and not custom_positions \
                and window is None:
            raise ValueError(
                "ring attention requires an initialized mesh with a 'seq' "
                f"axis > 1 (mesh={_mesh_desc(_global_layout())})")
        raise ValueError("ring attention requires a mesh with seq > 1, "
                         "default positions, and non-alibi attention")
    if attn_impl == "ulysses":
        raise ValueError(
            "ulysses attention requires an initialized mesh with a "
            f"'seq' axis > 1 (mesh={_mesh_desc(_global_layout())})")
    if _takes_flash(cfg, S, attn_impl, custom_positions, window):
        # GQA is handled in-kernel (KV-head indexing), no repeat
        return flash_attention(q, k, v, causal=True, sm_scale=_sm_scale(cfg, hd))
    return _plain_attention(cfg, q, k, v, positions, positions, window)


def _mlp_in(cfg: TransformerConfig, lp: Dict[str, Any], h) -> tuple:
    """The MLP's input projections, before their biases: (gate, up) for
    SwiGLU, (up,) otherwise: the tensors JAX names ``mlp_gate`` and
    ``mlp_up``.  An MoE layer names none: its input passes through, and
    :func:`_mlp_out` runs the whole MoE."""
    if "router" in lp:
        return (h,)
    h = _tp.copy_to_model(h)
    if cfg.activation == "swiglu":
        return _mm(h, lp["w_gate"]), _mm(h, lp["w_up"])
    return (_mm(h, lp["w_in"]),)


def _moe_config(cfg: TransformerConfig, E: int) -> MoEConfig:
    return MoEConfig(num_experts=E, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.capacity_factor,
                     eval_capacity_factor=cfg.eval_capacity_factor,
                     min_capacity=cfg.moe_min_capacity,
                     noisy_gate_policy=cfg.noisy_gate_policy,
                     drop_tokens=cfg.moe_drop_tokens)


def _moe_mlp(cfg: TransformerConfig, lp: Dict[str, Any], h, seed):
    """An MoE layer's MLP: (output, aux).  Training when ``seed`` is set
    (the capacity factor, jitter); eval capacity otherwise.  Expert-
    internal tensor parallelism: the experts' input enters the model axis
    and their outputs are summed over it (the router is whole on every
    rank, so every rank routes alike)."""
    router = lp["router"]
    mcfg = _moe_config(cfg, int(router.shape[-1]))
    deterministic = seed is None
    jitter = None
    if cfg.noisy_gate_policy == "jitter" and not deterministic:
        jitter = _draw(cfg, h, seed, _SITE_JITTER, lambda shape, gen: torch.empty(
            shape, device=h.device).uniform_(1.0 - 1e-2, 1.0 + 1e-2, generator=gen))
    experts = {n: lp[n] for n in ("w_gate", "w_up", "w_in", "w_down", "b_in", "b_down")
               if n in lp}
    if _tp.active():
        m, aux = _tp_moe(cfg, h, router, experts, mcfg, deterministic, jitter)
    else:
        m, aux = moe_ffn(h, router, experts, mcfg, activation=cfg.activation,
                         deterministic=deterministic, rng=jitter)
    if "coefficient" in lp:
        # residual MoE (reference moe/layer.py:16 use_residual): the dense
        # branch mixed in by a learned 2-way softmax coefficient
        # JAX's _dense_mlp(prefix="res_"): no biases on the residual branch
        rcfg = dataclasses.replace(cfg, mlp_bias=False) if cfg.mlp_bias else cfg
        rp = {k[4:]: v for k, v in lp.items() if k.startswith("res_")}
        res = _mlp_out(rcfg, rp, _mlp_in(rcfg, rp, h))[0]
        coef = torch.softmax(_mm(h, lp["coefficient"]).float(), dim=-1).to(m.dtype)
        m = m * coef[..., 0:1] + res * coef[..., 1:2]
    return m, aux


def _tp_moe(cfg, h, router, experts, mcfg, deterministic, jitter):
    """``moe_ffn`` on expert leaves cut over the model axis: biases added
    once, after the down projection's sum over the axis."""
    bias = {n: experts.pop(n) for n in ("b_down",) if n in experts}
    m, aux = moe_ffn(_tp.copy_to_model(h), router, experts, mcfg,
                     activation=cfg.activation, deterministic=deterministic,
                     rng=jitter, reduce=_tp.reduce_from_model, bias=bias, router_x=h)
    return m, aux


def _mlp_out(cfg: TransformerConfig, lp: Dict[str, Any], acts: tuple, seed=None):
    """The rest of the MLP from :func:`_mlp_in`'s outputs: biases,
    activation, down projection (summed over the model axis, then its
    bias).  Returns (output, aux): the MoE aux loss of an MoE layer, None
    for a dense one."""
    if "router" in lp:
        return _moe_mlp(cfg, lp, acts[0], seed)
    if cfg.activation == "swiglu":
        g, u = acts
        if cfg.mlp_bias:
            g, u = g + lp["b_gate"], u + lp["b_up"]
        m = _mm(F.silu(g) * u, lp["w_down"])
    else:
        (m,) = acts
        if cfg.mlp_bias:
            m = m + lp["b_in"]
        if cfg.activation == "relu":
            m = F.relu(m)
        elif cfg.activation == "gelu_exact":   # HF 'gelu' (erf)
            m = F.gelu(m)
        elif cfg.activation == "quick_gelu":   # CLIP: x * sigmoid(1.702 x)
            m = m * torch.sigmoid(1.702 * m)
        else:                                  # jax.nn.gelu default: tanh form
            m = F.gelu(m, approximate="tanh")
        m = _mm(m, lp["w_down"])
    m = _tp.reduce_from_model(m)
    if cfg.mlp_bias:
        m = m + lp["b_down"]
    return m, None


def _mlp(cfg: TransformerConfig, lp: Dict[str, Any], h):
    """Post-norm MLP body of the cached and paged decode blocks (eval: no
    aux)."""
    return _mlp_out(cfg, lp, _mlp_in(cfg, lp, h))[0]


def _qkv(cfg, lp, h, B, S):
    """q [B,S,Hq,hd], k and v [B,S,Hkv,hd]: the head counts are the
    weights' (a rank's local heads under tensor parallelism; under
    :func:`kv_gathered`, one gathered KV head per local query head)."""
    hd = cfg.dims_per_head
    h = _tp.copy_to_model(h)
    q, k, v = _mm(h, lp["wq"]), _mm(h, lp["wk"]), _mm(h, lp["wv"])
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q, k, v = (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
               v.reshape(B, S, -1, hd))
    n = _tp.size()
    if kv_gathered(cfg, n):
        # every KV head on every rank (pads cut), then the one each local
        # query head i reads: i // G of the whole model's heads
        G, hq = cfg.num_heads // cfg.kv_heads, q.shape[2]
        first = _tp.rank() * hq
        idx = torch.tensor([min((first + j) // G, cfg.kv_heads - 1) for j in range(hq)],
                           device=k.device)
        k = _tp.gather_shared(k, 2)[:, :, :cfg.kv_heads].index_select(2, idx)
        v = _tp.gather_shared(v, 2)[:, :, :cfg.kv_heads].index_select(2, idx)
    return q, k, v


def _out_proj(cfg, lp, attn, B, S):
    attn = _tp.reduce_from_model(_mm(attn.reshape(B, S, -1), lp["wo"]))
    return attn + lp["bo"] if cfg.attn_bias else attn


# Dropout sites of a layer: each draws from its own generator, seeded from
# the layer's seed and the site, so a layer (or any part of one) recomputed
# under remat draws the same masks again.
_SITE_ATTN, _SITE_MLP, _SITE_JITTER = 0, 1, 2


# The global index of the first batch row this process holds: a
# data-parallel rank holds rows [r*mb, (r+1)*mb) of each global micro-batch
# (``row_offset``, set by the engine around each micro-batch).
_ROW_OFFSET = [0]


@contextlib.contextmanager
def row_offset(offset: int):
    """Run a forward whose first batch row is row ``offset`` of the global
    batch, so dropout draws that row's masks (a rank of a data-parallel run
    draws what the same rows draw in a one-process run)."""
    prev, _ROW_OFFSET[0] = _ROW_OFFSET[0], int(offset)
    try:
        yield
    finally:
        _ROW_OFFSET[0] = prev


def _row_seed(seed: int, site: int, row: int) -> int:
    # seeds are < 2**62; the row is mixed in with an odd 64-bit multiplier
    return (seed + site * 2 ** 62 + row * 0x9E3779B97F4A7C15) % 2 ** 64


def _dropout(cfg: TransformerConfig, x, seed, site: int):
    """Inverted dropout at ``cfg.dropout`` from site ``site`` of the layer
    seeded ``seed`` = (layer seed, global index of x's first row, index of
    its first position, the whole sequence's length or None): each row's
    mask comes from its own generator, keyed by its global row and drawn
    over the whole sequence, of which a rank of a 'seq' axis keeps its
    slice (identity when ``seed`` is None: no training)."""
    if seed is None or not cfg.dropout:
        return x
    keep = 1.0 - cfg.dropout
    mask = _draw(cfg, x, seed, site, lambda shape, gen: torch.rand(
        shape, generator=gen, device=x.device)) < keep
    return x * mask / keep


def _draw(cfg: TransformerConfig, x, seed, site: int, draw):
    """``draw(shape, generator)`` for each row of ``x``, from the row's
    generator keyed by (layer seed, site, global row), over the whole
    sequence, of which this slice is kept (see :func:`_dropout`)."""
    seed, row0, pos0, seq_len = seed
    gen = torch.Generator(device=x.device)
    S = x.shape[1]
    rows = []
    for b in range(x.shape[0]):
        gen.manual_seed(_row_seed(seed, site, row0 + b))
        if seq_len is None:
            rows.append(draw(tuple(x.shape[1:]), gen))
        else:
            rows.append(draw((seq_len,) + tuple(x.shape[2:]), gen)[pos0:pos0 + S])
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# The layer, in the parts the remat policies cut it into.  Pre-norm:
#   q, k, v = _attn_in(x)                      norm, projections, rope
#   attn    = _attention(q, k, v)              the flash kernel (or plain)
#   x1, h   = _attn_residual(x, attn)          out proj, dropout, residual,
#                                              the MLP's norm
#   acts    = _mlp_in(h)                       gate/up projections
#   out     = x1 + dropout(_mlp_out(acts))
# ---------------------------------------------------------------------------

def _act_stats_reduce():
    """Under a process group whose data or 'seq' axes cut the batch, the
    combination of a per-tensor activation statistic over them (the whole
    tensor's, as GSPMD computes it in the JAX package); else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from .. import comm
    from ..parallel.mesh import BATCH_AXES

    axes = tuple(a for a in BATCH_AXES + ("seq",) if comm.get_axis_size(a) > 1)
    if not axes:
        return None
    return lambda x, op: comm.all_reduce(x, comm.MAX if op == "max" else comm.MIN, axes)


def _maybe_act_quant(cfg: TransformerConfig, h):
    """Activation fake-quant at the post-norm matmul inputs (the JAX
    package's one shared site of every block variant): dynamic per-tensor
    statistics, which stay on the device (the paged decode runs inside a
    CUDA graph)."""
    if not cfg.act_quant_bits:
        return h
    from ..compression.quantize import activation_fake_quant

    return activation_fake_quant(h, cfg.act_quant_bits, symmetric=cfg.act_quant_symmetric,
                                 reduce=_act_stats_reduce())


def _attn_in(cfg, lp, x, positions):
    B, S, _ = x.shape
    h = _maybe_act_quant(cfg, _norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias")))
    q, k, v = _qkv(cfg, lp, h, B, S)
    if cfg.position == "rope":
        q, k = _rope(q, k, positions, cfg.rope_theta, cfg.dims_per_head,
                     rotary_dim=cfg.rotary_dim, interleaved=cfg.rope_interleaved)
    return q, k, v


def _attn_residual(cfg, lp, x, attn, seed):
    """(x1, h): the residual stream after attention and the MLP's input
    (parallel residual: the MLP branches off x, not x1)."""
    B, S, _ = x.shape
    a = _dropout(cfg, _out_proj(cfg, lp, attn, B, S), seed, _SITE_ATTN)
    if cfg.parallel_residual:
        h = (_norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias"))
             if cfg.shared_layernorm
             else _norm(cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias")))
        return x + a, _maybe_act_quant(cfg, h)
    x1 = x + a
    return x1, _maybe_act_quant(cfg, _norm(cfg, x1, lp["mlp_norm_scale"],
                                           lp.get("mlp_norm_bias")))


def _mlp_residual(cfg, lp, acts, seed):
    """(dropout of the MLP's output, its aux)."""
    m, aux = _mlp_out(cfg, lp, acts, seed)
    return _dropout(cfg, m, seed, _SITE_MLP), aux


def _postln_attn(cfg, lp, x, positions, attn_impl, custom_positions, window, seed):
    """Post-LN's first half: x1 = LN(x + attn(x))."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, lp, _maybe_act_quant(cfg, x), B, S)
    attn = _attention(cfg, q, k, v, positions, attn_impl, custom_positions,
                      window=window)
    a = _dropout(cfg, _out_proj(cfg, lp, attn, B, S), seed, _SITE_ATTN)
    return _norm(cfg, x + a, lp["attn_norm_scale"], lp.get("attn_norm_bias"))


def _postln_out(cfg, lp, y):
    return _norm(cfg, y, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))


def _block_postln(cfg: TransformerConfig, lp: Dict[str, Any], x, positions,
                  attn_impl: str, custom_positions: bool = False, window=None,
                  seed: Optional[tuple] = None):
    """Post-layernorm encoder block (BERT): x = LN(x + attn(x));
    x = LN(x + mlp(x))."""
    x1 = _postln_attn(cfg, lp, x, positions, attn_impl, custom_positions,
                      window, seed)
    m, aux = _mlp_residual(cfg, lp, _mlp_in(cfg, lp, _maybe_act_quant(cfg, x1)), seed)
    return _postln_out(cfg, lp, x1 + m), aux


def _block(cfg: TransformerConfig, lp: Dict[str, Any], x, positions,
           attn_impl: str, custom_positions: bool = False, window=None,
           seed: Optional[tuple] = None):
    """One layer's output (:func:`_block_aux` without the aux)."""
    return _block_aux(cfg, lp, x, positions, attn_impl, custom_positions, window,
                      seed)[0]


def _block_aux(cfg: TransformerConfig, lp: Dict[str, Any], x, positions,
               attn_impl: str, custom_positions: bool = False, window=None,
               seed: Optional[tuple] = None):
    """One pre-norm layer: (output, MoE aux or None).  ``seed`` (training
    only) seeds its dropout and jitter: (layer seed, global index of the
    first batch row, ...)."""
    if cfg.post_layernorm:
        return _block_postln(cfg, lp, x, positions, attn_impl,
                             custom_positions, window=window, seed=seed)
    q, k, v = _attn_in(cfg, lp, x, positions)
    attn = _attention(cfg, q, k, v, positions, attn_impl, custom_positions,
                      window=window)
    x1, h = _attn_residual(cfg, lp, x, attn, seed)
    m, aux = _mlp_residual(cfg, lp, _mlp_in(cfg, lp, h), seed)
    return x1 + m, aux


# ---------------------------------------------------------------------------
# Remat policies (``jax.checkpoint`` policies of the JAX package's
# ``_build_block``).  ``nothing_saveable`` recomputes the whole layer from its
# input; the named policies keep exactly the tensors JAX's
# ``save_only_these_names`` keeps, by checkpointing the parts between them:
#   save_attn     attn_out
#   save_qkv      q_proj, k_proj, v_proj (post-rope), attn_out, attn_lse
#   save_matmuls  those and mlp_gate, mlp_up
# A non-reentrant checkpoint keeps its inputs and recomputes what the
# backward reads inside it, so a named tensor is kept by being the input of
# the next checkpointed part.  The flash kernel's autograd Function keeps q,
# k, v, out and lse itself, so under save_qkv/save_matmuls it runs outside
# any checkpoint and K1 launches once per layer; under save_attn it is
# inside the first part and runs again in the backward, as under
# nothing_saveable.  ``dots_saveable`` keeps every matmul output and no
# kernel output, through torch's selective checkpoint on the matmul ops:
# K1 runs again.  The autograd graph is the same under
# every policy; only where the backward finds its saved tensors differs, so
# the gradients are bit-equal.
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("nothing_saveable", "save_attn", "save_qkv", "save_matmuls",
                  "dots_saveable")
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _ckpt(fn, *args, **kwargs):
    # the dropout streams are explicit generators, so no global RNG state
    # needs saving for the recompute
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      **kwargs)


def _build_block(cfg: TransformerConfig, attn_impl: str, custom_positions: bool):
    """One layer's apply fn ``block(lp, x, positions, window, seed)`` ->
    (output, MoE aux or None), with ``cfg.remat_policy`` applied while
    autograd records (see above).  An MoE layer's ``_mlp_in`` passes its
    input through, so ``save_matmuls`` keeps that input where a dense
    layer keeps its gate/up products (JAX names none in an MoE layer)."""
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; ported: "
                         f"{', '.join(REMAT_POLICIES)}")

    def block(lp, x, positions, window, seed):
        return _block_aux(cfg, lp, x, positions, attn_impl, custom_positions,
                          window=window, seed=seed)

    if not (cfg.remat and torch.is_grad_enabled()):
        return block
    if policy == "nothing_saveable" or (
            cfg.post_layernorm and policy in ("save_attn", "save_qkv")):
        # post-LN blocks name no attention tensor (JAX's _block_postln)
        return lambda *args: _ckpt(block, *args)
    if policy == "dots_saveable":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return lambda *args: _ckpt(block, *args, context_fn=context)

    def attend(q, k, v, positions, window):
        return _attention(cfg, q, k, v, positions, attn_impl, custom_positions,
                          window=window)

    def mlp_in_part(lp, x, attn, seed):
        x1, h = _attn_residual(cfg, lp, x, attn, seed)
        return (x1, *_mlp_in(cfg, lp, h))

    def mlp_part(lp, acts, seed):
        return _mlp_residual(cfg, lp, acts, seed)

    if cfg.post_layernorm:   # save_matmuls: mlp_gate/mlp_up only
        def postln_block(lp, x, positions, window, seed):
            def first(lp, x, positions, window, seed):
                x1 = _postln_attn(cfg, lp, x, positions, attn_impl,
                                  custom_positions, window, seed)
                return (x1, *_mlp_in(cfg, lp, _maybe_act_quant(cfg, x1)))

            x1, *acts = _ckpt(first, lp, x, positions, window, seed)
            m, aux = _ckpt(mlp_part, lp, tuple(acts), seed)
            # keeps the last norm's input y: one [B,S,d] more than JAX's names
            return _ckpt(functools.partial(_postln_out, cfg), lp, x1 + m), aux

        return postln_block

    def after_attention(lp, x, attn, seed):
        x1, *acts = mlp_in_part(lp, x, attn, seed)
        m, aux = mlp_part(lp, tuple(acts), seed)
        return x1 + m, aux

    def named_block(lp, x, positions, window, seed):
        if policy == "save_attn":
            attn = _ckpt(lambda lp, x, positions, window: attend(
                *_attn_in(cfg, lp, x, positions), positions, window),
                lp, x, positions, window)
            return _ckpt(after_attention, lp, x, attn, seed)
        q, k, v = _ckpt(functools.partial(_attn_in, cfg), lp, x, positions)
        if _takes_flash(cfg, x.shape[1], attn_impl, custom_positions, window):
            attn = attend(q, k, v, positions, window)   # keeps q, k, v, out, lse
        else:
            attn = _ckpt(attend, q, k, v, positions, window)
        if policy == "save_qkv":
            return _ckpt(after_attention, lp, x, attn, seed)
        x1, *acts = _ckpt(mlp_in_part, lp, x, attn, seed)
        m, aux = _ckpt(mlp_part, lp, tuple(acts), seed)
        return x1 + m, aux

    return named_block


def _dq(x):
    """A leaf as the model reads it: a ``QuantizedWeight`` dequantized."""
    return x.dequantize() if isinstance(x, QuantizedWeight) else x


def _layer(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s weights: views into the stacked [L, ...] leaves (a
    quantized leaf's row ``i`` dequantized)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):   # a PR-MoE pyramid's own dicts
        return layers[i]
    return {name: leaf.layer(i) if isinstance(leaf, QuantizedWeight) else leaf[i]
            for name, leaf in layers.items()}


def _layers(params: Dict[str, Any]):
    """Every layer's weights, unbound from the stacked leaves in one op per
    leaf (so the backward stacks each leaf's gradient once)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):   # a PR-MoE pyramid's own dicts
        return list(layers)
    if hasattr(layers, "unstack"):   # ZeRO-3: per-layer shard slices
        return layers.unstack()
    if any(isinstance(leaf, QuantizedWeight) for leaf in layers.values()):
        # inference only: each layer dequantized when the loop reaches it
        L = next(iter(layers.values())).shape[0]
        return (_layer(params, i) for i in range(L))
    names = list(layers)
    return [dict(zip(names, views))
            for views in zip(*(layers[n].unbind(0) for n in names))]


def _embed(cfg, params, tokens, positions, token_type_ids=None):
    x = _tp.vocab_parallel_embed(_dq(params["embed"]), tokens).to(cfg.dtype)
    if cfg.position == "learned":
        x = x + _dq(params["pos_embed"])[positions].to(cfg.dtype)
    if "type_embed" in params:   # BERT segment embeddings
        tt = (token_type_ids if token_type_ids is not None
              else torch.zeros_like(tokens))
        x = x + _dq(params["type_embed"])[tt].to(cfg.dtype)
    if cfg.embed_layernorm:      # Bloom / BERT embedding LayerNorm
        x = _norm(cfg, x, _dq(params["embed_norm_scale"]),
                  _dq(params.get("embed_norm_bias")))
    return x


def _final_norm(cfg, params, x):
    return _norm(cfg, x, _dq(params["final_norm_scale"]),
                 _dq(params.get("final_norm_bias")))


def _head(cfg, params, x):
    """The logits: this rank's vocabulary columns under tensor
    parallelism (:func:`_tp.gather_from_model` makes them whole)."""
    x = _tp.copy_to_model(x)
    if cfg.tie_embeddings:
        return _mm(x, _dq(params["embed"]).to(cfg.dtype).T)
    logits = _mm(x, _dq(params["lm_head"]).to(cfg.dtype))
    if "lm_head_bias" in params:   # GPT-J ties a bias to the LM head
        logits = logits + _dq(params["lm_head_bias"]).to(cfg.dtype)
    return logits


def forward(cfg: TransformerConfig, params: Dict[str, Any], tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            rng: Optional[torch.Generator] = None,
            attn_impl: str = "xla", deterministic: bool = True,
            seq_sharded: bool = True, return_aux: bool = False,
            pld_theta=None, token_type_ids: Optional[torch.Tensor] = None,
            gather_logits: bool = True, seq_offset: int = 0,
            seq_len: Optional[int] = None,
            pld_generator: Optional[torch.Generator] = None):
    """tokens [B, S] -> logits [B, S, V] (+ aux dict if return_aux).
    Under tensor parallelism ``gather_logits=False`` returns this rank's
    vocabulary columns ``[B, S, V/tp]`` (the vocab-parallel loss reads
    them).  On a 'seq' axis, ``tokens`` are positions ``seq_offset ..``
    of rows ``seq_len`` long: the default positions start there, and
    dropout draws the whole row's masks and keeps this slice.

    ``deterministic=False`` turns on dropout (``cfg.dropout``) drawn from
    ``rng``, a ``torch.Generator`` (seed 0 on the tokens' device when None):
    it draws one seed per layer, as the JAX package splits one key per
    layer.  ``cfg.remat`` recomputes each layer in the backward when
    autograd records the call.  ``seq_sharded`` is accepted for signature
    parity and unused.

    ``pld_theta`` (progressive layer drop, training): the layers of a
    [L] keep mask drawn on the host from ``pld_generator`` (a CPU
    generator, seed 0 when None) run, the others are skipped.  A config
    with ``random_ltd`` and ``random_ltd_keep`` runs each layer of a
    training pass on ``random_ltd_keep`` tokens of each row drawn from
    ``rng`` (``runtime/data_pipeline/data_routing/random_ltd.py``)."""
    _check_supported(cfg)
    B, S = tokens.shape
    tokens = tokens.long()
    custom_positions = positions is not None
    if positions is None:
        positions = (torch.arange(S, dtype=torch.int32, device=tokens.device)
                     + seq_offset)[None, :].expand(B, S)
    seeds = layer_seeds(cfg, deterministic, rng, tokens.device, seq_offset, seq_len)
    if cfg.tie_embeddings and hasattr(params, "pin"):
        # a ZeRO-3 tree: one gather serves both uses of the tied embedding
        params = params.pin("embed")
    x = _embed(cfg, params, tokens, positions, token_type_ids)
    block = _build_block(cfg, attn_impl, custom_positions)
    if cfg.random_ltd and cfg.random_ltd_keep > 0:
        block = _ltd_block(cfg, block, rng, tokens.device, deterministic)
    layers, windows = _layers(params), layer_windows(cfg)
    if pld_theta is not None:
        layers, seeds = _pld_layers(cfg, layers, seeds, windows, pld_theta,
                                    pld_generator)
    x, aux_total = run_layers(cfg, layers, x, positions, seeds, block, windows)
    logits = _logits(cfg, params, x, gather_logits)
    if return_aux:
        if aux_total is None:
            aux_total = torch.zeros((), device=logits.device)
        return logits, {"moe_aux_loss": aux_total}
    return logits


def _ltd_block(cfg: TransformerConfig, block, rng, device, deterministic: bool):
    """``block`` on a random subset of ``cfg.random_ltd_keep`` tokens a
    row, wrapped outside the remat checkpoint (JAX's ``_build_block``): the
    backward recomputes the kept subset's layer only.  The inner block is
    built for default positions, so the subset takes the flash kernels
    wherever its length does."""
    from ..runtime.data_pipeline.data_routing import random_ltd

    if cfg.attention_layers is not None:
        raise NotImplementedError(
            "random-LTD with per-layer attention types is not supported "
            "(the token-subset wrapper does not thread the window)")
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "random-LTD with pipeline stages is not ported: the stage "
            "executor builds its blocks without the token-drop wrapper")
    if rng is None:
        rng = torch.Generator(device=device)
        rng.manual_seed(0)

    def ltd(lp, x, positions, window, seed):
        return random_ltd.random_ltd_block(
            lambda xs, ps: block(lp, xs, ps, window, seed), x, positions, rng,
            cfg.random_ltd_keep, deterministic)

    return ltd


def _pld_layers(cfg: TransformerConfig, layers, seeds, windows, theta, generator):
    """The layers progressive layer drop keeps this pass and their seeds:
    the [L] mask drawn on the host, so no device sync."""
    from ..runtime import progressive_layer_drop

    if cfg.pipeline_stages > 1 or not cfg.scan_layers or _het(cfg):
        raise NotImplementedError(
            "progressive layer drop requires the scanned-layers path "
            "(scan_layers=True, pipeline_stages=1, uniform layers)")
    if windows is not None:
        raise NotImplementedError(
            "progressive layer drop with per-layer attention types "
            "is not supported")
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(0)
    keep = progressive_layer_drop.pld_keep_mask(generator, cfg.num_layers,
                                                theta).tolist()
    kept = [i for i, k in enumerate(keep) if k]
    layers = list(layers)
    return [layers[i] for i in kept], [seeds[i] for i in kept]


def layer_seeds(cfg: TransformerConfig, deterministic: bool, rng, device,
                seq_offset: int = 0, seq_len: Optional[int] = None) -> list:
    """Each layer's training seed (None for every layer in eval): one draw
    a layer from ``rng`` when the layers draw masks (dropout, router
    jitter), as the JAX package splits one key a layer; an MoE model
    without them gets seed 0 a layer, which marks training (its capacity
    factor) and draws nothing."""
    if deterministic:
        return [None] * cfg.num_layers
    if cfg.dropout or cfg.noisy_gate_policy == "jitter":
        if rng is None:
            rng = torch.Generator(device=device)
            rng.manual_seed(0)
        return [(s, _ROW_OFFSET[0], seq_offset, seq_len) for s in torch.randint(
            0, 2 ** 62, (cfg.num_layers,), generator=rng, device=rng.device).tolist()]
    if has_moe(cfg):
        return [(0, _ROW_OFFSET[0], seq_offset, seq_len)] * cfg.num_layers
    return [None] * cfg.num_layers


def run_layers(cfg: TransformerConfig, layers, x, positions, seeds, block,
               windows=None):
    """``x`` through ``layers`` (an iterable of per-layer trees, one seed
    each): (output, the layers' summed MoE aux or None)."""
    windows = windows or [None] * len(seeds)
    aux_total = None
    for lp, window, seed in zip(layers, windows, seeds):
        x, aux = block(lp, x, positions, window, seed)
        del lp   # a dequantized layer is freed before the next is made
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


def _logits(cfg: TransformerConfig, params, x, gather_logits: bool = True):
    """The final norm and the head (the logits gathered over the model
    axis when ``gather_logits``)."""
    if cfg.final_norm:
        x = _final_norm(cfg, params, x)
    logits = _head(cfg, params, x)
    if gather_logits:
        logits = _tp.gather_from_model(logits, cfg.vocab_size)
    return logits


# ---------------------------------------------------------------------------
# Pipeline parallelism (JAX forward :1079-1100 and
# pipeline_1f1b_loss_and_grads :1176).  A pipelined config's ``forward`` is
# the un-pipelined one: the stages compute the same function, and the JAX
# package's aux (summed over layers, averaged over the microbatches) is the
# whole batch's mean over its rows either way.  Training runs the stages
# through ``runtime/pipe/executor.py``: stage 0 embeds, every stage runs its
# L/P layers, the last stage takes the final norm, the head and its
# microbatch's share of the loss.
# ---------------------------------------------------------------------------

def pipeline_loss_and_backward(cfg: TransformerConfig, params, tokens, labels,
                               rng=None, attn_impl: str = "xla",
                               loss_scale: float = 1.0, schedule: Optional[str] = None,
                               transport=None, stages=None, count=None,
                               aux_ranks: int = 1, row0: int = 0):
    """Forward and backward of ``tokens``/``labels [B, S]`` through
    ``cfg.pipeline_stages`` stages and ``cfg.pipeline_microbatches``
    microbatches (default: the stage count); the gradients (of
    ``loss_scale`` x the objective) accumulate into the ``.grad`` of the
    leaves ``params`` hands out.

    The objective is the NLL summed over the labelled tokens over
    ``count`` (the labelled tokens of the whole batch: of every data rank,
    when the caller sums it), plus ``moe_aux_loss_coef`` x the layers'
    summed aux averaged over the microbatches and over ``aux_ranks`` data
    ranks.  ``transport``/``stages``: this process's stages and how they
    talk (all stages through a ``VirtualTransport`` by default; one stage
    a rank of 'pipe' with ``AxisTransport``, whose ``params`` hold that
    stage's layers only, and whose embedding/head leaves the caller sums
    over 'pipe' afterwards: ReduceTiedGrads).  Returns (the last stage's
    objective per microbatch, the aux terms summed), both detached."""
    from ..runtime.pipe.executor import VirtualTransport, run_pipeline, stage_layer_count

    P = cfg.pipeline_stages
    M = cfg.pipeline_microbatches or P
    schedule = schedule or cfg.pipeline_schedule
    if schedule == "1f1b":
        _refuse_1f1b(cfg)
    B, S = tokens.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} pipeline microbatches")
    mb = B // M
    Lp = stage_layer_count(cfg.num_layers, P)
    stages = list(range(P)) if stages is None else list(stages)
    transport = transport or VirtualTransport()
    tokens, labels = tokens.long(), labels.long()
    if count is None:
        count = (labels != -100).sum()
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(mb, S)
    block = _build_block(cfg, attn_impl, False)
    layers = list(_layers(params))
    first = stages[0]
    seeds = layer_seeds(cfg, False, rng, tokens.device)
    if cfg.tie_embeddings and hasattr(params, "pin"):
        params = params.pin("embed")
    aux_sum = []

    def forward(s, m, x):
        rows = slice(m * mb, (m + 1) * mb)
        if s == 0:
            x = _embed(cfg, params, tokens[rows], positions)
        lo = (s - first) * Lp
        seed_m = [None if sd is None else (sd[0], row0 + m * mb) + tuple(sd[2:])
                  for sd in seeds[s * Lp:(s + 1) * Lp]]
        x, aux = run_layers(cfg, layers[lo:lo + Lp], x, positions, seed_m, block)
        extra = None
        if aux is not None:
            extra = cfg.moe_aux_loss_coef * aux / (M * aux_ranks)
            aux_sum.append(extra.detach())
        if s < P - 1:
            return x, extra
        nll, _ = cross_entropy_terms(_logits(cfg, params, x), labels[rows])
        return nll / count.clamp(min=1), extra

    losses = run_pipeline(forward, P, M, stages, transport, (mb, S, cfg.hidden_size),
                          cfg.dtype, schedule=schedule, loss_scale=loss_scale)
    aux_total = torch.stack(aux_sum).sum() if aux_sum else None
    return losses, aux_total


def _refuse_1f1b(cfg: TransformerConfig) -> None:
    """The JAX package's 1F1B refusals (transformer.py:1188-1197)."""
    if has_moe(cfg):
        raise NotImplementedError(
            "pipeline_schedule='1f1b' with MoE layers: the manual backward "
            "does not thread the aux loss; use the gpipe schedule")
    if cfg.dropout:
        raise NotImplementedError(
            "pipeline_schedule='1f1b' with dropout: the stage rng chain "
            "differs between the paired fwd/bwd stage calls under remat; "
            "use the gpipe schedule")


def pipeline_1f1b_loss_and_grads(cfg: TransformerConfig, params: Dict[str, Any],
                                 tokens, labels, rng=None, attn_impl: str = "xla",
                                 loss_scale=1.0):
    """The JAX package's ``pipeline_1f1b_loss_and_grads``: (gradients of
    ``loss_scale`` x the mean loss, each microbatch's unscaled mean loss)
    for a whole tree in one process, the stages virtual.  The tied
    embedding's two gradients (stage 0's and the head's) sum in its one
    leaf."""
    from ..utils.tree import tree_leaves, tree_map, tree_unflatten_like

    _refuse_1f1b(cfg)
    work = tree_map(lambda x: x.detach().requires_grad_(), params)
    labels = labels.long()
    count = (labels != -100).sum()
    losses, _ = pipeline_loss_and_backward(cfg, work, tokens, labels, rng=rng,
                                           attn_impl=attn_impl, loss_scale=loss_scale,
                                           schedule="1f1b", count=count)
    M = len(losses)
    per = labels.reshape(M, -1)
    out = torch.stack([losses[m] * count / (per[m] != -100).sum().clamp(min=1)
                       for m in range(M)])
    grads = tree_unflatten_like(work, [x.grad if x.grad is not None else torch.zeros_like(x)
                                       for x in tree_leaves(work)])
    return grads, out


# ---------------------------------------------------------------------------
# KV-cached decode path.  The cache holds [L, B, T, Hkv, hd] k/v buffers, a
# validity bitmap and each slot's position id; ragged (right-padded) prompts
# write their pad slots but never attend them.  Unlike the JAX package's
# immutable pytree, the port writes the cache IN PLACE (one allocation per
# generate call) and keeps ``next_slot`` as a host int.
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch_size: int, max_len: int,
               dtype=None, device=None) -> Dict[str, Any]:
    """A static-shape KV cache for ``batch_size`` rows of up to ``max_len``
    total tokens (prompt + generated), on ``device`` (default: the
    accelerator's); this rank's KV heads under tensor parallelism."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    L, B, T = cfg.num_layers, batch_size, max_len
    kv = (L, B, T, local_heads(cfg, _tp.size())[1], cfg.dims_per_head)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "valid": torch.zeros((B, T), dtype=torch.bool, device=device),
        "pos": torch.zeros((B, T), dtype=torch.int32, device=device),
        "next_slot": 0,
    }


def _attention_cached(cfg, q, ck, cv, q_pos, q_slot, valid, kpos, window=None):
    """q:[B,S,Hq,hd] against the full cache ck/cv:[B,T,Hkv,hd].  GQA
    contracts grouped query heads against the Hkv cache directly.  A key
    slot is attendable iff it holds a real token (``valid``) and was
    written at or before the query's slot."""
    B, S, Hq, hd = q.shape
    T, Hkv = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, ck).float()
    scores = scores * _sm_scale(cfg, hd)
    if cfg.position == "alibi":
        slopes = _head_slopes(cfg, Hq, q.device).reshape(Hkv, G)
        rel = (q_pos[:, :, None] - kpos[:, None, :]).float()            # [B,S,T]
        scores = scores - (rel.abs()[:, None, None, :, :]
                           * slopes[None, :, :, None, None])
    slot_t = torch.arange(T, dtype=torch.int32, device=q.device)
    ok = valid[:, None, :] & (slot_t[None, None, :] <= q_slot[None, :, None])
    if window is not None:
        rel_pos = q_pos[:, :, None] - kpos[:, None, :]                 # [B,S,T]
        ok = ok & ((rel_pos < window) | (window <= 0))
    scores = scores.masked_fill(~ok[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cv)
    return out.reshape(B, S, Hq, hd)


def _block_cached(cfg, lp, x, ck, cv, q_pos, q_slot, valid, kpos, next_slot,
                  window=None, dense=False):
    """One block with cache read/write.  ck/cv are this layer's
    [B,T,Hkv,hd] views into the cache, written in place.  ``dense``: a
    whole unpadded prompt at default positions into an empty cache, whose
    attention over the cache is causal attention over the prompt itself:
    the flash kernel's."""
    B, S, _ = x.shape
    h = _maybe_act_quant(cfg, _norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias")))
    q, k, v = _qkv(cfg, lp, h, B, S)
    if cfg.position == "rope":
        q, k = _rope(q, k, q_pos, cfg.rope_theta, cfg.dims_per_head,
                     rotary_dim=cfg.rotary_dim, interleaved=cfg.rope_interleaved)
    ck[:, next_slot:next_slot + S] = k.to(ck.dtype)
    cv[:, next_slot:next_slot + S] = v.to(cv.dtype)
    if dense:
        attn = flash_attention(q, k.to(ck.dtype), v.to(cv.dtype), causal=True,
                               sm_scale=_sm_scale(cfg, q.shape[-1]))
    else:
        attn = _attention_cached(cfg, q, ck, cv, q_pos, q_slot, valid, kpos,
                                 window=window)
    attn = _out_proj(cfg, lp, attn, B, S)
    if cfg.parallel_residual:
        h2 = h if cfg.shared_layernorm else _maybe_act_quant(cfg, _norm(
            cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias")))
        return x + attn + _mlp(cfg, lp, h2)
    x = x + attn
    h = _maybe_act_quant(cfg, _norm(cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias")))
    return x + _mlp(cfg, lp, h)


def forward_cached(cfg: TransformerConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, cache: Dict[str, Any],
                   positions: torch.Tensor, input_mask: torch.Tensor,
                   attn_impl: str = "xla"):
    """Run ``tokens [B,S]`` (a prefill chunk or one decode token) against
    the cache, writing their K/V at slots ``next_slot..next_slot+S-1``.

    ``positions [B,S]``: absolute position ids.  ``input_mask [B,S]``: True
    for real tokens; False slots are written but never attended.  Returns
    ``(logits [B,S,V], cache)`` — the same cache dict, updated in place.
    A prefill into an empty cache of whole rows at default positions
    attends through the flash kernel wherever ``attn_impl`` takes it at S
    (``_takes_flash``: ``"auto"`` from S = 2048); one host read of the
    mask and positions decides it."""
    _check_supported(cfg)
    if not cfg.causal:
        raise NotImplementedError(
            "cached decode is a causal-LM operation; encoder models "
            "(causal=False) have no autoregressive cache")
    B, S = tokens.shape
    ns = cache["next_slot"]
    T = cache["valid"].shape[1]
    if ns + S > T:
        raise ValueError(f"cache overflow: {ns} + {S} tokens > {T} slots")
    cache["valid"][:, ns:ns + S] = input_mask
    cache["pos"][:, ns:ns + S] = positions.to(torch.int32)
    q_slot = ns + torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens.long(), positions)
    windows = layer_windows(cfg)
    dense = (ns == 0 and windows is None and _tp.size() == 1
             and _takes_flash(cfg, S, attn_impl, False, None)
             and bool(input_mask.all() & (positions == q_slot[None, :]).all()))
    for i in range(cfg.num_layers):
        x = _block_cached(cfg, _layer(params, i), x, cache["k"][i], cache["v"][i],
                          positions, q_slot, cache["valid"], cache["pos"], ns,
                          None if windows is None else windows[i], dense=dense)
    x = _final_norm(cfg, params, x)
    cache["next_slot"] = ns + S
    return _tp.gather_from_model(_head(cfg, params, x), cfg.vocab_size), cache


# ---------------------------------------------------------------------------
# Block-paged KV cache (serving).  One physical pool [L, P, page, Hkv, hd] is
# shared by every decode slot through per-slot page tables; physical page 0
# is the trash page (masked writes and unallocated table entries).
# Slot-local token index == position, so the causal mask is the validity
# mask.  Unlike the JAX package's functional update, the port writes the
# pool IN PLACE (``index_copy_`` on a flat view of each layer), so the pool
# exists once and a CUDA graph of the decode step keeps writing the same
# tensors on every replay.
# ---------------------------------------------------------------------------

PAGE_SIZE = 128   # tokens per KV page (the JAX package's lane-aligned size)

# quantized pool storage dtypes accepted by ``init_paged_cache(kv_dtype=)``:
# int8 codes with one symmetric-absmax fp32 scale per token row per layer
KV_QUANT_DTYPES = ("int8",)

# canonical leaf order of a paged cache dict: k/v always, the scale planes
# of an int8 pool after them
PAGED_POOL_KEYS = ("k", "v", "k_scale", "v_scale")


def paged_pool_tuple(cache: Dict[str, Any]) -> tuple:
    """The cache dict's pool tensors in canonical order (2 of them full
    precision, 4 with an int8 pool's scale planes)."""
    return tuple(cache[k] for k in PAGED_POOL_KEYS if k in cache)


def paged_pool_cache(pools) -> Dict[str, Any]:
    """Inverse of :func:`paged_pool_tuple`."""
    return dict(zip(PAGED_POOL_KEYS, pools))


def normalize_kv_dtype(kv_dtype) -> Optional[str]:
    """None (full precision) or the canonical string "int8"."""
    if kv_dtype is None:
        return None
    name = str(kv_dtype).replace("torch.", "")
    if name not in KV_QUANT_DTYPES:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} is not a quantized KV storage dtype; "
            f"supported: {KV_QUANT_DTYPES} (None = full precision)")
    return name


def init_paged_cache(cfg: TransformerConfig, num_pages: int,
                     page_size: int = PAGE_SIZE, dtype=None, kv_dtype=None,
                     device=None) -> Dict[str, Any]:
    """Allocate the physical page pool: ``k``/``v`` are ``[L, num_pages,
    page_size, Hkv, hd]`` zeros on ``device`` (default: the accelerator's),
    ``Hkv/tp`` heads under tensor parallelism.
    Page 0 is reserved as the trash page; the serving engine hands out
    pages 1..num_pages-1.  Full pages are immutable once written (a slot
    only writes at its own advancing position), which is what lets several
    slots map one page; a partial boundary page is shared by value instead
    (:func:`cow_copy_pool`).

    ``kv_dtype="int8"`` allocates ``k``/``v`` in int8 plus the scale planes
    ``k_scale``/``v_scale`` ``[L, num_pages, page_size]`` (float32): one
    symmetric-absmax scale per token row per layer, written by the same
    store that writes the row (:func:`kv_quantize_rows`).  Sharing, COW and
    tiering are dtype-blind: a page is still a page."""
    kvq = normalize_kv_dtype(kv_dtype)
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    kv = (cfg.num_layers, num_pages, page_size, local_heads(cfg, _tp.size())[1],
          cfg.dims_per_head)
    if kvq is None:
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}
    sc = (cfg.num_layers, num_pages, page_size)
    return {"k": torch.zeros(kv, dtype=torch.int8, device=device),
            "v": torch.zeros(kv, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sc, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sc, dtype=torch.float32, device=device)}


def cow_copy_pool(pools, src: int, dst: int):
    """Copy-on-write: snapshot physical page ``src`` onto ``dst`` across
    every layer of each pool tensor (``[L, P, page, Hkv, hd]`` payloads
    and an int8 pool's ``[L, P, page]`` scale planes), in place: raw bytes,
    so an int8 page never round-trips through float.  ``dst == src`` is a
    harmless self-copy."""
    for a in pools:
        a[:, dst].copy_(a[:, src])
    return tuple(pools)


def kv_quantize_rows(x: torch.Tensor):
    """Symmetric absmax int8 quantization of one write slice: ``x`` ``[N,
    Hkv, hd]`` -> (int8 rows, float32 per-row scales ``[N]``).

    One scale per token row, over the row's whole ``Hkv*hd`` vector (under
    tensor parallelism the row's amax is taken over every rank's KV heads,
    so each rank stores the scale the whole row has).  A row is written once
    and never rescaled, so a full page's bytes are a function of the tokens
    that produced it.  An all-zero row stores scale 1 (dequantizes to exact
    zero)."""
    xf = x.float()
    amax = _tp.max_over_model(xf.abs().amax(dim=(1, 2)))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[:, None, None]), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Invert :func:`kv_quantize_rows` on a gathered ``[B, T, Hkv, hd]``
    block with its ``[B, T]`` scale rows: multiply in float32, then cast to
    the compute dtype."""
    return (q.float() * scale[..., None, None]).to(dtype)


def _attention_paged(cfg, q, ck, cv, q_pos):
    """q:[B,S,Hq,hd] against gathered per-slot pages ck/cv:[B,T,Hkv,hd]
    with the causal mask ``t <= q_pos`` (the JAX package's einsum; prefill
    and alibi take it, decode goes to K4)."""
    B, S, Hq, hd = q.shape
    T, Hkv = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, ck).float()
    scores = scores * _sm_scale(cfg, hd)
    t = torch.arange(T, dtype=torch.int32, device=q.device)
    if cfg.position == "alibi":
        slopes = _head_slopes(cfg, Hq, q.device).reshape(Hkv, G)
        rel = (q_pos[:, :, None] - t[None, None, :]).float()
        scores = scores - (rel.abs()[:, None, None, :, :]
                           * slopes[None, :, :, None, None])
    ok = t[None, None, :] <= q_pos[:, :, None]                  # [B,S,T]
    scores = scores.masked_fill(~ok[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cv)
    return out.reshape(B, S, Hq, hd)


ADAPTER_TARGETS = ("wq", "wk", "wv", "wo")   # projections the paged block adapts


def _adapter_delta(h: torch.Tensor, ab: Dict[str, torch.Tensor],
                   scale: torch.Tensor) -> torch.Tensor:
    """Per-slot batched LoRA delta ``((h @ A_b) @ B_b) * scale_b`` in fp32:
    ``h`` [B, S, d_in], ``ab["A"]`` [B, d_in, R], ``ab["B"]`` [B, R, d_out]
    (rank-padded with zeros, which add exactly zero), ``scale`` [B]."""
    t = torch.einsum("bsd,bdr->bsr", h.float(), ab["A"].float())
    d = torch.einsum("bsr,bro->bso", t, ab["B"].float())
    return d * scale.float()[:, None, None]


def _adapted(y, name, hin, ad, ad_scale):
    if ad is not None and name in ad:
        y = y + _adapter_delta(hin, ad[name], ad_scale).to(y.dtype)
    return y


def _qkv_paged(cfg, lp, h, B, S, ad=None, ad_scale=None):
    """:func:`_qkv` with each slot's LoRA delta added to its q/k/v
    projection before the bias (the JAX package's ``proj``).  Under tensor
    parallelism the factors' output columns are this rank's heads (the
    executor cuts ``B``), like the column-parallel weights."""
    if ad is None:
        return _qkv(cfg, lp, h, B, S)
    hd = cfg.dims_per_head
    h = _tp.copy_to_model(h)
    q = _adapted(_mm(h, lp["wq"]), "wq", h, ad, ad_scale)
    k = _adapted(_mm(h, lp["wk"]), "wk", h, ad, ad_scale)
    v = _adapted(_mm(h, lp["wv"]), "wv", h, ad, ad_scale)
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
            v.reshape(B, S, -1, hd))


def _out_proj_paged(cfg, lp, attn, B, S, ad=None, ad_scale=None):
    """:func:`_out_proj` with each slot's ``wo`` delta added to this rank's
    partial product, before the model-axis sum (the factors' input rows are
    this rank's heads), so the delta is summed once."""
    if ad is None:
        return _out_proj(cfg, lp, attn, B, S)
    a2d = attn.reshape(B, S, -1)
    y = _tp.reduce_from_model(_adapted(_mm(a2d, lp["wo"]), "wo", a2d, ad, ad_scale))
    return y + lp["bo"] if cfg.attn_bias else y


def _block_paged(cfg, lp, x, ck, cv, positions, write_idx, page_table, T,
                 cks=None, cvs=None, ad=None, ad_scale=None, verify=False):
    """One block against layer pools ``ck``/``cv`` [P, page, Hkv, hd]:
    write this step's K/V at ``write_idx`` (flat rows, in place), then
    attend.  ``cks``/``cvs`` (both or neither) are an int8 pool's scale
    planes [P, page]: the store quantizes each row (:func:`kv_quantize_rows`)
    and writes its scale through the same ``write_idx``.

    Decode (S == 1), and a speculative verify block (``verify``: S > 1
    tokens of one slot, each row its own query), go to K4 over the pool
    and the page table, in its int8 mode for an int8 pool: no gathered or
    dequantized copy of the cache.  A verify block runs as B*S rows, the
    page table's rows repeated S times, row r masked ``t <= pos_r`` over T
    (a position past the table attends all T, as the JAX mask does).
    Prefill and alibi gather each slot's pages (dequantized for an int8
    pool) and take the einsum, as the JAX package computes them outside
    any kernel.  ``ad``/``ad_scale`` are this layer's per-slot LoRA
    factors and scales (multi-tenant adapter serving)."""
    B, S, _ = x.shape
    P, ps, nkv, hd = ck.shape
    ckf, cvf = ck.view(P * ps, nkv, hd), cv.view(P * ps, nkv, hd)
    h = _maybe_act_quant(cfg, _norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias")))
    q, k, v = _qkv_paged(cfg, lp, h, B, S, ad, ad_scale)
    if cfg.position == "rope":
        q, k = _rope(q, k, positions, cfg.rope_theta, hd,
                     rotary_dim=cfg.rotary_dim, interleaved=cfg.rope_interleaved)
    k, v = k.reshape(B * S, nkv, hd), v.reshape(B * S, nkv, hd)
    if cks is not None:
        kq, ks = kv_quantize_rows(k)
        vq, vs = kv_quantize_rows(v)
        ckf.index_copy_(0, write_idx, kq)
        cvf.index_copy_(0, write_idx, vq)
        cks.view(P * ps).index_copy_(0, write_idx, ks)
        cvs.view(P * ps).index_copy_(0, write_idx, vs)
    else:
        ckf.index_copy_(0, write_idx, k.to(ckf.dtype))
        cvf.index_copy_(0, write_idx, v.to(cvf.dtype))
    t = torch.arange(T, device=x.device)
    if (S == 1 or verify) and cfg.position != "alibi":
        pos_r = positions.reshape(B * S)
        mask = (t[None, :] <= pos_r[:, None]).to(torch.int32)        # [B*S, T]
        pt = page_table if S == 1 else page_table.repeat_interleave(S, dim=0)
        attn = decode_attention(q.reshape(B * S, -1, hd), ck, cv, mask, pt,
                                _sm_scale(cfg, hd), k_scale=cks, v_scale=cvs)
        attn = attn.reshape(B, S, -1, hd)
    else:
        rows = page_table.long()[:, t // ps] * ps + t % ps          # [B, T]
        gk, gv = ckf[rows], cvf[rows]
        if cks is not None:
            gk = kv_dequantize(gk, cks.reshape(P * ps)[rows], cfg.dtype)
            gv = kv_dequantize(gv, cvs.reshape(P * ps)[rows], cfg.dtype)
        attn = _attention_paged(cfg, q, gk, gv, positions)
    attn = _out_proj_paged(cfg, lp, attn, B, S, ad, ad_scale)
    if cfg.parallel_residual:
        h2 = h if cfg.shared_layernorm else _maybe_act_quant(cfg, _norm(
            cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias")))
        return x + attn + _mlp(cfg, lp, h2)
    x = x + attn
    h = _maybe_act_quant(cfg, _norm(cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias")))
    return x + _mlp(cfg, lp, h)


def forward_paged(cfg: TransformerConfig, params: Dict[str, Any],
                  tokens: torch.Tensor, cache: Dict[str, Any],
                  page_table: torch.Tensor, start: torch.Tensor,
                  seq_mask: torch.Tensor, adapters=None, verify: bool = False):
    """Run ``tokens [B,S]`` against the paged pool, writing each real
    token's K/V at its slot position (in place) and attending each query to
    its own slot's pages only.

    ``page_table [B, maxp]`` int32: the physical page of each logical page
    (0 = the trash page, also the unallocated filler).  ``start [B]``: slot
    position of ``tokens[:, 0]`` (0 for a cold prefill, the shared-prefix
    length for a tail prefill, the current length for decode).
    ``seq_mask [B,S]``: True for real tokens; masked tokens and positions
    past the page table write to the trash page (so a verify block
    straddling the table's end never wraps into a live page), and their
    logits are garbage the caller never reads.  Everything is tensor
    arithmetic with no host synchronisation, so the decode step ``[B_slots,
    1]`` and the verify block ``[B_slots, k+1]`` can be captured in CUDA
    graphs.

    An int8 cache (``init_paged_cache(kv_dtype="int8")``) quantizes on
    store and is read by K4's int8 mode (decode, verify) or dequantized in
    the gather (prefill).  ``verify=True`` marks ``[B, k+1]`` tokens as a
    speculative verify block (each position a decode row of K4) rather than
    a prefill.  ``adapters`` is the per-slot LoRA operand ``{"scale": [B],
    "factors": {target: {"A": [L, B, d_in, R], "B": [L, B, R, d_out]}}}``
    (targets among ``wq``/``wk``/``wv``/``wo``, the JAX paged block's;
    all-zero factors reproduce the adapter-free forward exactly).  Returns
    ``(logits [B,S,V], cache)``, the same cache dict."""
    _check_supported(cfg)
    if not cfg.causal:
        raise NotImplementedError(
            "paged decode is a causal-LM operation; encoder models "
            "(causal=False) have no autoregressive cache")
    if cfg.attention_layers is not None:
        raise NotImplementedError(
            "paged decode does not support per-layer attention windows "
            "(attention_layers); use the contiguous cache path")
    B, S = tokens.shape
    ps = cache["k"].shape[2]
    maxp = page_table.shape[1]
    positions = start.to(torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device)[None, :]
    raw_idx = positions // ps
    page_idx = raw_idx.clamp(max=maxp - 1).long()
    phys = torch.gather(page_table, 1, page_idx).long()             # [B,S]
    flat = phys * ps + (positions % ps).long()
    write_idx = torch.where(seq_mask & (raw_idx < maxp), flat,
                            torch.zeros_like(flat)).reshape(B * S)
    safe_pos = positions.clamp(max=cfg.max_seq_len - 1)
    quantized = "k_scale" in cache
    ad_scale = factors = None
    if adapters is not None:
        ad_scale, factors = adapters["scale"], adapters["factors"]
    x = _embed(cfg, params, tokens.long(), safe_pos)
    for i, lp in enumerate(_layers(params)):
        ad = (None if factors is None else
              {n: {"A": ab["A"][i], "B": ab["B"][i]} for n, ab in factors.items()
               if n in ADAPTER_TARGETS})
        x = _block_paged(cfg, lp, x, cache["k"][i], cache["v"][i], positions,
                         write_idx, page_table, maxp * ps,
                         cks=cache["k_scale"][i] if quantized else None,
                         cvs=cache["v_scale"][i] if quantized else None,
                         ad=ad or None, ad_scale=ad_scale, verify=verify)
        del lp   # a dequantized layer is freed before the next is made
    x = _final_norm(cfg, params, x)
    return _tp.gather_from_model(_head(cfg, params, x), cfg.vocab_size), cache


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = -100) -> tuple:
    """(sum of the next-token NLL over the labelled positions, their
    count): a data-parallel engine divides the sum by the count summed over
    its ranks, the mean over the global batch."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean next-token NLL; positions with ``labels == ignore_index`` masked."""
    total, count = cross_entropy_terms(logits, labels, ignore_index)
    return total / count.clamp(min=1)
