"""HF checkpoint -> the port's model (counterpart of
``deepspeed_tpu/module_inject/load.py``; reference
``module_inject/replace_module.py:283`` ``replace_transformer_layer`` and
``load_model_with_checkpoint.py``).

The reference mutates a live torch model, swapping layers for fused-kernel
modules.  Here the target is the port's functional transformer
(``models/transformer.py``): conversion reads an HF state dict, applies the
arch policy's name map, stacks per-layer tensors on the leading ``[L]``
axis and returns ``(TransformerConfig, params)``.  A live module and a
``(config, state_dict)`` pair convert densely; a directory streams leaf by
leaf (``sharded_load.py``), reading its ``config.json`` as a dict, so that
path needs neither ``transformers`` nor ``safetensors``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import TransformerConfig
from ..utils.logging import logger
from .policies import detect_arch

# HF class defaults of the keys a bare config.json may omit, where they
# differ from the fallbacks below (``transformers.AutoConfig`` fills them;
# a dict read must give the same TransformerConfig)
_HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": {"rms_norm_eps": 1e-6},
    "mistral": {"rms_norm_eps": 1e-6, "num_key_value_heads": 8,
                "max_position_embeddings": 131072},
    "gpt_neox": {"rotary_pct": 0.25},
    "gptj": {"rotary_dim": 64},
    "gpt_neo": {"attention_types": [[["global", "local"], 12]]},
}


def _getter(hf_config, model_type: Optional[str] = None):
    """``get(key, default)`` over an HF config object or dict (a dict falls
    back to the HF class default of ``model_type`` before ``default``)."""
    if isinstance(hf_config, dict):
        defaults = _HF_DEFAULTS.get(model_type or hf_config.get("model_type"), {})
        return lambda k, d=None: hf_config.get(k, defaults.get(k, d))
    return lambda k, d=None: getattr(hf_config, k, d)


def _hf_activation(name: str) -> str:
    """HF activation names -> native: HF 'gelu' is the EXACT erf GELU;
    'gelu_new'/'gelu_pytorch_tanh' are the tanh approximation."""
    table = {"gelu": "gelu_exact", "gelu_new": "gelu",
             "gelu_pytorch_tanh": "gelu", "relu": "relu",
             "quick_gelu": "quick_gelu"}
    if name not in table:
        raise NotImplementedError(f"HF activation {name!r} is not supported")
    return table[name]


def config_from_hf(hf_config) -> TransformerConfig:
    """Translate an HF config object or dict into a TransformerConfig (the
    JAX package's translation, field for field)."""
    get = _getter(hf_config)
    arch = detect_arch(hf_config)
    if arch in ("llama", "mistral"):
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_key_value_heads",
                             get("num_attention_heads")),
            max_seq_len=get("max_position_embeddings", 2048),
            rope_theta=float(get("rope_theta", 10000.0)),
            norm_eps=float(get("rms_norm_eps", 1e-5)),
            tie_embeddings=bool(get("tie_word_embeddings", False)))
    if arch == "gptj":
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("n_embd"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            max_seq_len=get("n_positions", 2048), norm="layernorm",
            activation="gelu", position="rope",
            rotary_dim=get("rotary_dim") or None, rope_interleaved=True,
            parallel_residual=True, shared_layernorm=True,
            lm_head_bias=True, mlp_bias=True,
            norm_eps=float(get("layer_norm_epsilon", 1e-5)))
    if arch == "gpt_neox":
        hd = get("hidden_size") // get("num_attention_heads")
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=_hf_activation(get("hidden_act", "gelu")),
            position="rope",
            rotary_dim=int(hd * float(get("rotary_pct", 1.0))),
            rope_theta=float(get("rotary_emb_base", 10000.0)),
            parallel_residual=bool(get("use_parallel_residual", True)),
            attn_bias=bool(get("attention_bias", True)), mlp_bias=True,
            norm_eps=float(get("layer_norm_eps", 1e-5)))
    if arch == "gpt2":
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("n_embd"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            max_seq_len=get("n_positions", 1024), norm="layernorm",
            activation="gelu", position="learned", tie_embeddings=True,
            attn_bias=True, mlp_bias=True,
            norm_eps=float(get("layer_norm_epsilon", 1e-5)))
    if arch == "bloom":
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            intermediate_size=4 * get("hidden_size"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            max_seq_len=get("seq_length", 2048) or 2048,
            norm="layernorm",
            activation="gelu",   # BloomGelu is the tanh approximation
            position="alibi", tie_embeddings=True, attn_bias=True,
            mlp_bias=True, embed_layernorm=True,
            norm_eps=float(get("layer_norm_epsilon", 1e-5)))
    if arch == "bert":
        # encoder: bidirectional post-LN blocks, segment embeddings, a
        # LayerNorm after the embedding sum, no final norm; tied embeddings
        # make the "logits" the last hidden state projected on embed^T
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            max_seq_len=get("max_position_embeddings", 512),
            norm="layernorm",
            activation=_hf_activation(get("hidden_act", "gelu")),
            position="learned", tie_embeddings=True, attn_bias=True,
            mlp_bias=True, causal=False, post_layernorm=True,
            embed_layernorm=True,
            type_vocab_size=get("type_vocab_size", 2),
            final_norm=False,
            norm_eps=float(get("layer_norm_eps", 1e-12)))
    if arch == "gpt_neo":
        # local/global attention alternation and no softmax scaling
        # (modeling_gpt_neo applies scale 1.0)
        attn_layers = get("attention_layers")
        if attn_layers is None:
            # expand the attention_types [[["global","local"], N]] form
            attn_layers = []
            for pattern, count in get("attention_types"):
                attn_layers += list(pattern) * count
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size")
            or 4 * get("hidden_size"),
            num_layers=get("num_layers"),
            num_heads=get("num_heads"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=_hf_activation(get("activation_function", "gelu_new")),
            position="learned", tie_embeddings=True,
            attention_layers=tuple(attn_layers),
            window_size=get("window_size", 256),
            attn_softmax_scale=1.0,
            attn_bias=True, mlp_bias=True,
            norm_eps=float(get("layer_norm_epsilon", 1e-5)))
    if arch == "distilbert":
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("dim"),
            intermediate_size=get("hidden_dim"),
            num_layers=get("n_layers"), num_heads=get("n_heads"),
            max_seq_len=get("max_position_embeddings", 512),
            norm="layernorm",
            activation=_hf_activation(get("activation", "gelu")),
            position="learned", tie_embeddings=True, attn_bias=True,
            mlp_bias=True, causal=False, post_layernorm=True,
            embed_layernorm=True, final_norm=False,
            norm_eps=1e-12)
    if arch == "clip":
        text = get("text_config")          # a full CLIPModel wraps text_config
        gett = _getter(text, "clip_text_model") if text is not None else get
        return TransformerConfig(
            vocab_size=gett("vocab_size"), hidden_size=gett("hidden_size"),
            intermediate_size=gett("intermediate_size"),
            num_layers=gett("num_hidden_layers"),
            num_heads=gett("num_attention_heads"),
            max_seq_len=gett("max_position_embeddings", 77),
            norm="layernorm",
            activation=_hf_activation(gett("hidden_act", "quick_gelu")),
            position="learned", tie_embeddings=True,  # encoder surface
            attn_bias=True, mlp_bias=True, causal=True,
            norm_eps=float(gett("layer_norm_eps", 1e-5)))
    if arch in ("megatron_gpt", "megatron_gpt_moe"):
        cfg_kwargs = dict(
            vocab_size=get("vocab_size", get("padded_vocab_size")),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size")
            or get("ffn_hidden_size") or 4 * get("hidden_size"),
            num_layers=get("num_layers"),
            num_heads=get("num_attention_heads"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu", position="learned",
            tie_embeddings=True, attn_bias=True, mlp_bias=True,
            norm_eps=float(get("layernorm_epsilon", 1e-5)))
        if arch == "megatron_gpt_moe":
            E = get("num_experts") or get("moe_num_experts")
            if isinstance(E, (list, tuple)):
                raise NotImplementedError(
                    "megatron_gpt_moe: per-layer expert counts are not "
                    "supported by the checkpoint policy (uniform only)")
            cfg_kwargs.update(num_experts=int(E),
                              moe_top_k=get("moe_top_k", get("topk", 1)) or 1)
        return TransformerConfig(**cfg_kwargs)
    if arch == "opt":
        proj = get("word_embed_proj_dim", get("hidden_size"))
        if proj not in (None, get("hidden_size")):
            raise NotImplementedError(
                f"OPT variants with word_embed_proj_dim={proj} != "
                f"hidden_size={get('hidden_size')} (project_in/out layers) "
                "are not supported")
        if not get("do_layer_norm_before", True):
            raise NotImplementedError(
                "OPT variants with do_layer_norm_before=False (350m-style "
                "post-norm) are not supported")
        return TransformerConfig(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            intermediate_size=get("ffn_dim"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=_hf_activation(get("activation_function", "relu")),
            position="learned",
            tie_embeddings=True, attn_bias=True, mlp_bias=True)
    raise NotImplementedError(arch)


_PER_HEAD_QKV = ("gpt_neox", "bloom", "megatron_gpt", "megatron_gpt_moe")


def _split_fused_qkv(w: torch.Tensor, cfg: TransformerConfig, arch: str):
    """Split a fused qkv tensor into native-layout ``(..., in, out)``
    pieces (views where the layout allows).

    GPT-2 Conv1D c_attn: ``[d, 3d]`` with ``[q | k | v]`` on the last dim.
    NeoX/Bloom/Megatron query_key_value: nn.Linear ``[3d, d]`` (weight) or
    ``[3d]`` (bias) with a per-head interleave ``[h0_q, h0_k, h0_v, h1_q,
    ...]`` on the first dim."""
    hd, nh = cfg.dims_per_head, cfg.num_heads
    if arch in _PER_HEAD_QKV:
        if w.ndim == 2:                       # [H*3*hd, d]
            grouped = w.reshape(nh, 3, hd, w.shape[-1])
            return tuple(grouped[:, i].reshape(nh * hd, -1).T for i in range(3))
        grouped = w.reshape(nh, 3, hd)        # bias [H*3*hd]
        return tuple(grouped[:, i].reshape(nh * hd) for i in range(3))
    d, dkv = nh * hd, cfg.kv_heads * hd
    return tuple(torch.split(w, [d, dkv, dkv], dim=-1))


def as_tensor(x) -> torch.Tensor:
    """A state-dict value as a torch tensor (numpy arrays, bf16 ones from
    ``ml_dtypes`` included, are wrapped without a copy where possible)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def hf_state_dict_to_params(state_dict: Dict[str, Any], cfg: TransformerConfig,
                            arch: str, dtype: Optional[torch.dtype] = None,
                            device=None) -> Dict[str, Any]:
    """HF names -> the port's stacked tree (the JAX package's
    ``hf_state_dict_to_params``), each leaf in ``dtype`` (float32 when
    None) on ``device`` (the accelerator's when None).  Values are torch
    tensors or numpy arrays; the leaves are built by the streaming
    loader's per-leaf fetches over the dict."""
    from .policies import POLICIES
    from .sharded_load import StateDictSource, build_params

    source = StateDictSource(state_dict, POLICIES[arch].name)
    return build_params(source, POLICIES[arch], cfg, arch, dtype, device)


def load_hf_checkpoint(model_or_path: Any, dtype: Optional[torch.dtype] = None,
                       max_seq_len: Optional[int] = None, device=None
                       ) -> Tuple[TransformerConfig, Dict[str, Any]]:
    """``(cfg, params)`` from an HF source: a live ``transformers`` model,
    ``(config, state_dict)``, or a local directory in the ``save_pretrained``
    layout (streamed, see ``sharded_load.load_hf_checkpoint_sharded``)."""
    if isinstance(model_or_path, str):
        from .sharded_load import load_hf_checkpoint_sharded

        return load_hf_checkpoint_sharded(model_or_path, dtype=dtype,
                                          max_seq_len=max_seq_len, device=device)
    if isinstance(model_or_path, tuple):
        hf_config, state_dict = model_or_path
    else:   # a live torch module
        hf_config, state_dict = model_or_path.config, model_or_path.state_dict()
    arch = detect_arch(hf_config)
    cfg = config_from_hf(hf_config)
    if max_seq_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    params = hf_state_dict_to_params(state_dict, cfg, arch, dtype=dtype, device=device)
    logger.info(f"loaded HF {arch} checkpoint: {cfg.param_count:,} params, "
                f"L={cfg.num_layers} d={cfg.hidden_size}")
    return cfg, params
