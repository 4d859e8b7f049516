"""Per-architecture weight-mapping policies, HF checkpoint -> the port's
parameter tree (counterpart of ``deepspeed_tpu/module_inject/policies.py``;
reference ``module_inject/replace_policy.py`` + ``containers/``).

A policy is a pure name map: for each native parameter slot, where the
tensor lives in the HF state dict and how it must be transformed
(transpose for ``nn.Linear`` ``[out, in]`` storage, identity for GPT-2's
``Conv1D`` ``[in, out]``, split for fused QKV).  Conversion then builds the
stacked ``[L, ...]`` layout directly; no torch module is constructed.  The
tables are the JAX package's, copied (that module is imported by nothing
here); the transforms act on torch tensors and return views, so a
transposed slice of an mmap-backed shard reads only the bytes it needs
and bf16 tensors never pass through numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchPolicy:
    """Name templates: ``{i}`` is the layer index.  Values are
    (hf_name, transform), the transform applied to the torch tensor.  A
    ``None`` hf key means the native slot has no checkpoint tensor and is
    zero-filled (GPT-Neo's q/k/v have no bias but out_proj does: the native
    attn_bias knob is all-or-nothing, and zero biases are identity)."""
    name: str
    # top-level: native key -> (hf key, transform)
    top: Dict[str, Tuple[str, Optional[Callable]]]
    # per-layer: native layer key -> (hf key template, transform)
    layer: Dict[str, Tuple[Optional[str], Optional[Callable]]]
    # fused qkv: hf key templates of the weight and the bias
    fused_qkv: Optional[str] = None
    fused_qkv_bias: Optional[str] = None
    tie_embeddings: bool = False
    pos_embed_offset: int = 0     # OPT stores positions with a +2 offset
    # MoE (Megatron-DeepSpeed): per-layer router template and per-expert
    # weight templates with BOTH {i} (layer) and {e} (expert) slots
    moe_router: Optional[Tuple[str, Optional[Callable]]] = None
    moe_experts: Optional[Dict[str, Tuple[str, Optional[Callable]]]] = None


def zero_shape(native: str, cfg) -> Tuple[int, ...]:
    """Shape of a zero-filled native slot (hf key None in a policy)."""
    hd = cfg.dims_per_head
    shapes = {"bq": (cfg.num_heads * hd,), "bk": (cfg.kv_heads * hd,),
              "bv": (cfg.kv_heads * hd,), "bo": (cfg.hidden_size,)}
    if native not in shapes:
        raise KeyError(f"no zero-fill shape rule for native slot {native!r}")
    return shapes[native]


def _t(x: torch.Tensor) -> torch.Tensor:
    """``nn.Linear`` ``[out, in]`` -> the native ``[in, out]`` (a view)."""
    return x.T


LLAMA = ArchPolicy(
    name="llama",
    top={
        "embed": ("model.embed_tokens.weight", None),
        "final_norm_scale": ("model.norm.weight", None),
        "lm_head": ("lm_head.weight", _t),
    },
    layer={
        "attn_norm_scale": ("model.layers.{i}.input_layernorm.weight", None),
        "wq": ("model.layers.{i}.self_attn.q_proj.weight", _t),
        "wk": ("model.layers.{i}.self_attn.k_proj.weight", _t),
        "wv": ("model.layers.{i}.self_attn.v_proj.weight", _t),
        "wo": ("model.layers.{i}.self_attn.o_proj.weight", _t),
        "mlp_norm_scale": (
            "model.layers.{i}.post_attention_layernorm.weight", None),
        "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", _t),
        "w_up": ("model.layers.{i}.mlp.up_proj.weight", _t),
        "w_down": ("model.layers.{i}.mlp.down_proj.weight", _t),
    },
)

GPT2 = ArchPolicy(
    name="gpt2",
    top={
        "embed": ("transformer.wte.weight", None),
        "pos_embed": ("transformer.wpe.weight", None),
        "final_norm_scale": ("transformer.ln_f.weight", None),
        "final_norm_bias": ("transformer.ln_f.bias", None),
    },
    layer={
        "attn_norm_scale": ("transformer.h.{i}.ln_1.weight", None),
        "attn_norm_bias": ("transformer.h.{i}.ln_1.bias", None),
        # Conv1D stores [in, out] — native layout already
        "wo": ("transformer.h.{i}.attn.c_proj.weight", None),
        "bo": ("transformer.h.{i}.attn.c_proj.bias", None),
        "mlp_norm_scale": ("transformer.h.{i}.ln_2.weight", None),
        "mlp_norm_bias": ("transformer.h.{i}.ln_2.bias", None),
        "w_in": ("transformer.h.{i}.mlp.c_fc.weight", None),
        "b_in": ("transformer.h.{i}.mlp.c_fc.bias", None),
        "w_down": ("transformer.h.{i}.mlp.c_proj.weight", None),
        "b_down": ("transformer.h.{i}.mlp.c_proj.bias", None),
    },
    fused_qkv="transformer.h.{i}.attn.c_attn.weight",
    fused_qkv_bias="transformer.h.{i}.attn.c_attn.bias",
    tie_embeddings=True,
)

OPT = ArchPolicy(
    name="opt",
    top={
        "embed": ("model.decoder.embed_tokens.weight", None),
        "pos_embed": ("model.decoder.embed_positions.weight", None),
        "final_norm_scale": ("model.decoder.final_layer_norm.weight", None),
        "final_norm_bias": ("model.decoder.final_layer_norm.bias", None),
    },
    layer={
        "attn_norm_scale": (
            "model.decoder.layers.{i}.self_attn_layer_norm.weight", None),
        "attn_norm_bias": (
            "model.decoder.layers.{i}.self_attn_layer_norm.bias", None),
        "wq": ("model.decoder.layers.{i}.self_attn.q_proj.weight", _t),
        "bq": ("model.decoder.layers.{i}.self_attn.q_proj.bias", None),
        "wk": ("model.decoder.layers.{i}.self_attn.k_proj.weight", _t),
        "bk": ("model.decoder.layers.{i}.self_attn.k_proj.bias", None),
        "wv": ("model.decoder.layers.{i}.self_attn.v_proj.weight", _t),
        "bv": ("model.decoder.layers.{i}.self_attn.v_proj.bias", None),
        "wo": ("model.decoder.layers.{i}.self_attn.out_proj.weight", _t),
        "bo": ("model.decoder.layers.{i}.self_attn.out_proj.bias", None),
        "mlp_norm_scale": (
            "model.decoder.layers.{i}.final_layer_norm.weight", None),
        "mlp_norm_bias": (
            "model.decoder.layers.{i}.final_layer_norm.bias", None),
        "w_in": ("model.decoder.layers.{i}.fc1.weight", _t),
        "b_in": ("model.decoder.layers.{i}.fc1.bias", None),
        "w_down": ("model.decoder.layers.{i}.fc2.weight", _t),
        "b_down": ("model.decoder.layers.{i}.fc2.bias", None),
    },
    tie_embeddings=True,
    pos_embed_offset=2,   # OPTLearnedPositionalEmbedding adds 2 to positions
)


GPTJ = ArchPolicy(
    name="gptj",
    top={
        "embed": ("transformer.wte.weight", None),
        "final_norm_scale": ("transformer.ln_f.weight", None),
        "final_norm_bias": ("transformer.ln_f.bias", None),
        "lm_head": ("lm_head.weight", _t),
        "lm_head_bias": ("lm_head.bias", None),
    },
    layer={
        # GPT-J: ONE LayerNorm per block (parallel residual, shared LN)
        "attn_norm_scale": ("transformer.h.{i}.ln_1.weight", None),
        "attn_norm_bias": ("transformer.h.{i}.ln_1.bias", None),
        "wq": ("transformer.h.{i}.attn.q_proj.weight", _t),
        "wk": ("transformer.h.{i}.attn.k_proj.weight", _t),
        "wv": ("transformer.h.{i}.attn.v_proj.weight", _t),
        "wo": ("transformer.h.{i}.attn.out_proj.weight", _t),
        "w_in": ("transformer.h.{i}.mlp.fc_in.weight", _t),
        "b_in": ("transformer.h.{i}.mlp.fc_in.bias", None),
        "w_down": ("transformer.h.{i}.mlp.fc_out.weight", _t),
        "b_down": ("transformer.h.{i}.mlp.fc_out.bias", None),
    },
)

NEOX = ArchPolicy(
    name="gpt_neox",
    top={
        "embed": ("gpt_neox.embed_in.weight", None),
        "final_norm_scale": ("gpt_neox.final_layer_norm.weight", None),
        "final_norm_bias": ("gpt_neox.final_layer_norm.bias", None),
        "lm_head": ("embed_out.weight", _t),
    },
    layer={
        "attn_norm_scale": ("gpt_neox.layers.{i}.input_layernorm.weight", None),
        "attn_norm_bias": ("gpt_neox.layers.{i}.input_layernorm.bias", None),
        "mlp_norm_scale": (
            "gpt_neox.layers.{i}.post_attention_layernorm.weight", None),
        "mlp_norm_bias": (
            "gpt_neox.layers.{i}.post_attention_layernorm.bias", None),
        "wo": ("gpt_neox.layers.{i}.attention.dense.weight", _t),
        "bo": ("gpt_neox.layers.{i}.attention.dense.bias", None),
        "w_in": ("gpt_neox.layers.{i}.mlp.dense_h_to_4h.weight", _t),
        "b_in": ("gpt_neox.layers.{i}.mlp.dense_h_to_4h.bias", None),
        "w_down": ("gpt_neox.layers.{i}.mlp.dense_4h_to_h.weight", _t),
        "b_down": ("gpt_neox.layers.{i}.mlp.dense_4h_to_h.bias", None),
    },
    # NeoX fuses qkv PER HEAD: weight [H*3*hd, d] laid out
    # [h0_q, h0_k, h0_v, h1_q, ...] — split handled arch-specifically
    fused_qkv="gpt_neox.layers.{i}.attention.query_key_value.weight",
    fused_qkv_bias="gpt_neox.layers.{i}.attention.query_key_value.bias",
)


BLOOM = ArchPolicy(
    name="bloom",
    top={
        "embed": ("transformer.word_embeddings.weight", None),
        "embed_norm_scale": (
            "transformer.word_embeddings_layernorm.weight", None),
        "embed_norm_bias": (
            "transformer.word_embeddings_layernorm.bias", None),
        "final_norm_scale": ("transformer.ln_f.weight", None),
        "final_norm_bias": ("transformer.ln_f.bias", None),
    },
    layer={
        "attn_norm_scale": ("transformer.h.{i}.input_layernorm.weight", None),
        "attn_norm_bias": ("transformer.h.{i}.input_layernorm.bias", None),
        "mlp_norm_scale": (
            "transformer.h.{i}.post_attention_layernorm.weight", None),
        "mlp_norm_bias": (
            "transformer.h.{i}.post_attention_layernorm.bias", None),
        "wo": ("transformer.h.{i}.self_attention.dense.weight", _t),
        "bo": ("transformer.h.{i}.self_attention.dense.bias", None),
        "w_in": ("transformer.h.{i}.mlp.dense_h_to_4h.weight", _t),
        "b_in": ("transformer.h.{i}.mlp.dense_h_to_4h.bias", None),
        "w_down": ("transformer.h.{i}.mlp.dense_4h_to_h.weight", _t),
        "b_down": ("transformer.h.{i}.mlp.dense_4h_to_h.bias", None),
    },
    # Bloom fuses qkv PER HEAD like NeoX: [H*3*hd, d] laid out
    # [h0_q, h0_k, h0_v, h1_q, ...] (reference containers/bloom.py
    # qkv_copy transposes the same interleave)
    fused_qkv="transformer.h.{i}.self_attention.query_key_value.weight",
    fused_qkv_bias="transformer.h.{i}.self_attention.query_key_value.bias",
    tie_embeddings=True,
)

BERT = ArchPolicy(
    name="bert",
    top={
        "embed": ("embeddings.word_embeddings.weight", None),
        "pos_embed": ("embeddings.position_embeddings.weight", None),
        "type_embed": ("embeddings.token_type_embeddings.weight", None),
        "embed_norm_scale": ("embeddings.LayerNorm.weight", None),
        "embed_norm_bias": ("embeddings.LayerNorm.bias", None),
    },
    layer={
        "wq": ("encoder.layer.{i}.attention.self.query.weight", _t),
        "bq": ("encoder.layer.{i}.attention.self.query.bias", None),
        "wk": ("encoder.layer.{i}.attention.self.key.weight", _t),
        "bk": ("encoder.layer.{i}.attention.self.key.bias", None),
        "wv": ("encoder.layer.{i}.attention.self.value.weight", _t),
        "bv": ("encoder.layer.{i}.attention.self.value.bias", None),
        "wo": ("encoder.layer.{i}.attention.output.dense.weight", _t),
        "bo": ("encoder.layer.{i}.attention.output.dense.bias", None),
        # post-LN: these are the POST-sublayer LayerNorms
        "attn_norm_scale": (
            "encoder.layer.{i}.attention.output.LayerNorm.weight", None),
        "attn_norm_bias": (
            "encoder.layer.{i}.attention.output.LayerNorm.bias", None),
        "w_in": ("encoder.layer.{i}.intermediate.dense.weight", _t),
        "b_in": ("encoder.layer.{i}.intermediate.dense.bias", None),
        "w_down": ("encoder.layer.{i}.output.dense.weight", _t),
        "b_down": ("encoder.layer.{i}.output.dense.bias", None),
        "mlp_norm_scale": ("encoder.layer.{i}.output.LayerNorm.weight", None),
        "mlp_norm_bias": ("encoder.layer.{i}.output.LayerNorm.bias", None),
    },
    tie_embeddings=True,
)


GPTNEO = ArchPolicy(
    name="gpt_neo",
    top={
        "embed": ("transformer.wte.weight", None),
        "pos_embed": ("transformer.wpe.weight", None),
        "final_norm_scale": ("transformer.ln_f.weight", None),
        "final_norm_bias": ("transformer.ln_f.bias", None),
    },
    layer={
        "attn_norm_scale": ("transformer.h.{i}.ln_1.weight", None),
        "attn_norm_bias": ("transformer.h.{i}.ln_1.bias", None),
        # q/k/v are bias-free nn.Linear; out_proj carries a bias — zero-fill
        # bq/bk/bv (None key) so the all-or-nothing attn_bias knob matches
        "wq": ("transformer.h.{i}.attn.attention.q_proj.weight", _t),
        "bq": (None, None),
        "wk": ("transformer.h.{i}.attn.attention.k_proj.weight", _t),
        "bk": (None, None),
        "wv": ("transformer.h.{i}.attn.attention.v_proj.weight", _t),
        "bv": (None, None),
        "wo": ("transformer.h.{i}.attn.attention.out_proj.weight", _t),
        "bo": ("transformer.h.{i}.attn.attention.out_proj.bias", None),
        "mlp_norm_scale": ("transformer.h.{i}.ln_2.weight", None),
        "mlp_norm_bias": ("transformer.h.{i}.ln_2.bias", None),
        # c_fc/c_proj are nn.Linear here (GPT-2's same-named Conv1D is not)
        "w_in": ("transformer.h.{i}.mlp.c_fc.weight", _t),
        "b_in": ("transformer.h.{i}.mlp.c_fc.bias", None),
        "w_down": ("transformer.h.{i}.mlp.c_proj.weight", _t),
        "b_down": ("transformer.h.{i}.mlp.c_proj.bias", None),
    },
    tie_embeddings=True,
)

DISTILBERT = ArchPolicy(
    name="distilbert",
    top={
        "embed": ("embeddings.word_embeddings.weight", None),
        "pos_embed": ("embeddings.position_embeddings.weight", None),
        "embed_norm_scale": ("embeddings.LayerNorm.weight", None),
        "embed_norm_bias": ("embeddings.LayerNorm.bias", None),
    },
    layer={
        "wq": ("transformer.layer.{i}.attention.q_lin.weight", _t),
        "bq": ("transformer.layer.{i}.attention.q_lin.bias", None),
        "wk": ("transformer.layer.{i}.attention.k_lin.weight", _t),
        "bk": ("transformer.layer.{i}.attention.k_lin.bias", None),
        "wv": ("transformer.layer.{i}.attention.v_lin.weight", _t),
        "bv": ("transformer.layer.{i}.attention.v_lin.bias", None),
        "wo": ("transformer.layer.{i}.attention.out_lin.weight", _t),
        "bo": ("transformer.layer.{i}.attention.out_lin.bias", None),
        # post-LN encoder: sa_layer_norm / output_layer_norm are the
        # POST-sublayer norms (same block shape as BERT)
        "attn_norm_scale": ("transformer.layer.{i}.sa_layer_norm.weight", None),
        "attn_norm_bias": ("transformer.layer.{i}.sa_layer_norm.bias", None),
        "w_in": ("transformer.layer.{i}.ffn.lin1.weight", _t),
        "b_in": ("transformer.layer.{i}.ffn.lin1.bias", None),
        "w_down": ("transformer.layer.{i}.ffn.lin2.weight", _t),
        "b_down": ("transformer.layer.{i}.ffn.lin2.bias", None),
        "mlp_norm_scale": (
            "transformer.layer.{i}.output_layer_norm.weight", None),
        "mlp_norm_bias": ("transformer.layer.{i}.output_layer_norm.bias", None),
    },
    tie_embeddings=True,
)

CLIP = ArchPolicy(
    name="clip",
    top={
        "embed": ("text_model.embeddings.token_embedding.weight", None),
        "pos_embed": ("text_model.embeddings.position_embedding.weight", None),
        "final_norm_scale": ("text_model.final_layer_norm.weight", None),
        "final_norm_bias": ("text_model.final_layer_norm.bias", None),
    },
    layer={
        "attn_norm_scale": (
            "text_model.encoder.layers.{i}.layer_norm1.weight", None),
        "attn_norm_bias": (
            "text_model.encoder.layers.{i}.layer_norm1.bias", None),
        "wq": ("text_model.encoder.layers.{i}.self_attn.q_proj.weight", _t),
        "bq": ("text_model.encoder.layers.{i}.self_attn.q_proj.bias", None),
        "wk": ("text_model.encoder.layers.{i}.self_attn.k_proj.weight", _t),
        "bk": ("text_model.encoder.layers.{i}.self_attn.k_proj.bias", None),
        "wv": ("text_model.encoder.layers.{i}.self_attn.v_proj.weight", _t),
        "bv": ("text_model.encoder.layers.{i}.self_attn.v_proj.bias", None),
        "wo": ("text_model.encoder.layers.{i}.self_attn.out_proj.weight", _t),
        "bo": ("text_model.encoder.layers.{i}.self_attn.out_proj.bias", None),
        "mlp_norm_scale": (
            "text_model.encoder.layers.{i}.layer_norm2.weight", None),
        "mlp_norm_bias": (
            "text_model.encoder.layers.{i}.layer_norm2.bias", None),
        "w_in": ("text_model.encoder.layers.{i}.mlp.fc1.weight", _t),
        "b_in": ("text_model.encoder.layers.{i}.mlp.fc1.bias", None),
        "w_down": ("text_model.encoder.layers.{i}.mlp.fc2.weight", _t),
        "b_down": ("text_model.encoder.layers.{i}.mlp.fc2.bias", None),
    },
    tie_embeddings=True,
)

# Megatron-LM GPT naming (reference module_inject/containers/megatron_gpt.py
# targets ParallelTransformerLayer; runtime/state_dict_factory.py
# MegatronSDLoader reads exactly these templates).  QKV fuses per head
# [H*3*hd, d] like NeoX — same split.
MEGATRON_GPT = ArchPolicy(
    name="megatron_gpt",
    top={
        "embed": ("word_embeddings.weight", None),
        "pos_embed": ("position_embeddings.weight", None),
        "final_norm_scale": ("transformer.final_layernorm.weight", None),
        "final_norm_bias": ("transformer.final_layernorm.bias", None),
    },
    layer={
        "attn_norm_scale": ("transformer.layers.{i}.input_layernorm.weight", None),
        "attn_norm_bias": ("transformer.layers.{i}.input_layernorm.bias", None),
        "wo": ("transformer.layers.{i}.attention.dense.weight", _t),
        "bo": ("transformer.layers.{i}.attention.dense.bias", None),
        "mlp_norm_scale": (
            "transformer.layers.{i}.post_attention_layernorm.weight", None),
        "mlp_norm_bias": (
            "transformer.layers.{i}.post_attention_layernorm.bias", None),
        "w_in": ("transformer.layers.{i}.mlp.dense_h_to_4h.weight", _t),
        "b_in": ("transformer.layers.{i}.mlp.dense_h_to_4h.bias", None),
        "w_down": ("transformer.layers.{i}.mlp.dense_4h_to_h.weight", _t),
        "b_down": ("transformer.layers.{i}.mlp.dense_4h_to_h.bias", None),
    },
    fused_qkv="transformer.layers.{i}.attention.query_key_value.weight",
    fused_qkv_bias="transformer.layers.{i}.attention.query_key_value.bias",
    tie_embeddings=True,
)

# Megatron-DeepSpeed MoE (reference containers/megatron_gpt_moe.py): every
# layer's MLP is an expert bank behind a TopKGate; expert Linears keep their
# biases (the native MoE layer carries [E, ...] bias slots for this).
MEGATRON_GPT_MOE = dataclasses.replace(
    MEGATRON_GPT,
    name="megatron_gpt_moe",
    layer={k: v for k, v in MEGATRON_GPT.layer.items()
           if k not in ("w_in", "b_in", "w_down", "b_down")},
    moe_router=("transformer.layers.{i}.mlp.deepspeed_moe.gate.wg.weight", _t),
    moe_experts={
        "w_in": ("transformer.layers.{i}.mlp.deepspeed_moe.experts."
                 "deepspeed_experts.{e}.dense_h_to_4h.weight", _t),
        "b_in": ("transformer.layers.{i}.mlp.deepspeed_moe.experts."
                 "deepspeed_experts.{e}.dense_h_to_4h.bias", None),
        "w_down": ("transformer.layers.{i}.mlp.deepspeed_moe.experts."
                   "deepspeed_experts.{e}.dense_4h_to_h.weight", _t),
        "b_down": ("transformer.layers.{i}.mlp.deepspeed_moe.experts."
                   "deepspeed_experts.{e}.dense_4h_to_h.bias", None),
    },
)

POLICIES: Dict[str, ArchPolicy] = {"llama": LLAMA, "gpt2": GPT2, "opt": OPT,
                                   "mistral": LLAMA, "gptj": GPTJ,
                                   "gpt_neox": NEOX, "bloom": BLOOM,
                                   "bert": BERT, "gpt_neo": GPTNEO,
                                   "distilbert": DISTILBERT, "clip": CLIP,
                                   "megatron_gpt": MEGATRON_GPT,
                                   "megatron_gpt_moe": MEGATRON_GPT_MOE}


def detect_arch(hf_config) -> str:
    """Map an HF config (object or dict) to a policy name (reference
    ``replace_policy`` auto-selection by module class)."""
    mt = (hf_config.get("model_type") if isinstance(hf_config, dict)
          else getattr(hf_config, "model_type", None))
    if mt in ("clip_text_model", "clip"):    # CLIPTextModel / full CLIPModel
        return "clip"
    if mt in ("megatron-gpt", "megatron_gpt2", "megatron-gpt2"):
        return "megatron_gpt"
    if mt in POLICIES:
        return mt
    raise NotImplementedError(
        f"no injection policy for model_type={mt!r} "
        f"(supported: {sorted(POLICIES)})")
