"""Causal transformer family, dense half (PyTorch counterpart of
``deepspeed_tpu/models/transformer.py``).

Parameters are a nested dict under the JAX package's key names, with layer
weights stacked on a leading ``[L]`` dim and projections in JAX's ``x @ W``
layout (``wq`` is ``[d, nh*hd]``), so a JAX parameter tree loads without
transposes (``models/convert.py``).  The JAX ``lax.scan`` over layers is a
Python loop over ``[L]`` slices.

Ported: the dense causal-LM forward (``forward``) with its training passes
(dropout, full-layer remat through ``torch.utils.checkpoint``), the
KV-cached decode path (``init_cache``/``forward_cached``) and
``cross_entropy_loss``.  Raising ``NotImplementedError`` until their slices
land (ROADMAP queue 1): MoE layers, pipeline stages, the selective remat
policies, random-LTD, progressive layer drop, activation fake-quant,
ring/Ulysses attention and the paged serving cache.

Matmuls promote mixed operand dtypes the way ``jnp`` does (``_mm``): a
bf16-activation model over fp32 weights computes those products in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..accelerator import resolve_device
from ..ops.kernels.common import NEG_INF
from ..ops.kernels.flash_attention import flash_attention


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
        """Parameters of the dense tree (MoE layers are not ported)."""
        d, f, v, L = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        hd, nh, nkv = self.dims_per_head, self.num_heads, self.kv_heads
        attn = d * hd * nh + 2 * d * hd * nkv + hd * nh * d
        if self.attn_bias:
            attn += nh * hd + 2 * nkv * hd + d
        mlp = 3 * d * f if self.activation == "swiglu" else 2 * d * f
        if self.mlp_bias:
            mlp += (2 * f if self.activation == "swiglu" else f) + d
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
        return L * (attn + norms + mlp) + embed + pos + extra + final_norm


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

_MOE_ROW = "MoE layers are not ported yet (ROADMAP queue 1, item 9)"


def get_config(name_or_cfg, **overrides) -> TransformerConfig:
    cfg = CONFIGS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


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
    if isinstance(cfg.num_experts, (tuple, list)) or cfg.num_experts > 1:
        raise NotImplementedError(_MOE_ROW)
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "pipeline parallelism is not ported yet (ROADMAP queue 1, item 9)")
    if cfg.act_quant_bits:
        raise NotImplementedError(
            "activation fake-quant is not ported yet (ROADMAP queue 1, item 11)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's keys, shapes and scales
    (normal * initializer_range; residual projections / sqrt(2L); norms 1,
    biases 0).  Each leaf is drawn in fp32 from ``generator`` and cast to
    ``dtype`` at once, so peak memory is the tree in ``dtype`` plus one fp32
    leaf.  The values differ from ``jax.random``'s: load a JAX tree through
    ``models/convert.py`` to compare the two packages.  The device is
    ``device``, else the generator's, else the accelerator's (CUDA; raises
    without a card)."""
    _check_supported(cfg)
    d, f = cfg.hidden_size, cfg.intermediate_size
    hd, nh, nkv, L = cfg.dims_per_head, cfg.num_heads, cfg.kv_heads, cfg.num_layers
    std = cfg.initializer_range
    device = resolve_device(device if device is not None or generator is None
                            else generator.device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def dense(*shape, scale=std):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    resid = std / math.sqrt(2 * L)
    layers: Dict[str, Any] = {
        "attn_norm_scale": ones(L, d),
        "wq": dense(L, d, nh * hd),
        "wk": dense(L, d, nkv * hd),
        "wv": dense(L, d, nkv * hd),
        "wo": dense(L, nh * hd, d, scale=resid),
    }
    if not cfg.shared_layernorm:
        layers["mlp_norm_scale"] = ones(L, d)
    if cfg.norm == "layernorm":
        layers["attn_norm_bias"] = zeros(L, d)
        if not cfg.shared_layernorm:
            layers["mlp_norm_bias"] = zeros(L, d)
    if cfg.activation == "swiglu":
        layers["w_gate"] = dense(L, d, f)
        layers["w_up"] = dense(L, d, f)
    else:
        layers["w_in"] = dense(L, d, f)
    layers["w_down"] = dense(L, f, d, scale=resid)
    if cfg.attn_bias:
        layers["bq"] = zeros(L, nh * hd)
        layers["bk"] = zeros(L, nkv * hd)
        layers["bv"] = zeros(L, nkv * hd)
        layers["bo"] = zeros(L, d)
    if cfg.mlp_bias:
        if cfg.activation == "swiglu":
            layers["b_gate"] = zeros(L, f)
            layers["b_up"] = zeros(L, f)
        else:
            layers["b_in"] = zeros(L, f)
        layers["b_down"] = zeros(L, d)

    params: Dict[str, Any] = {"embed": dense(cfg.vocab_size, d), "layers": layers}
    if cfg.final_norm:
        params["final_norm_scale"] = ones(d)
        if cfg.norm == "layernorm":
            params["final_norm_bias"] = zeros(d)
    if cfg.position == "learned":
        params["pos_embed"] = dense(cfg.max_seq_len, d)
    if cfg.embed_layernorm:
        params["embed_norm_scale"] = ones(d)
        if cfg.norm == "layernorm":
            params["embed_norm_bias"] = zeros(d)
    if cfg.type_vocab_size:
        params["type_embed"] = dense(cfg.type_vocab_size, d)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_size)
        if cfg.lm_head_bias:
            params["lm_head_bias"] = zeros(cfg.vocab_size)
    return params


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


def _alibi_bias(cfg, positions, num_heads, S, dtype):
    slopes = torch.from_numpy(_alibi_slopes(num_heads)).to(positions.device)
    rel = (positions[:, None, :] - positions[:, :, None]).float()   # [B,q,k]
    return (-rel.abs()[:, None, :, :] * slopes[None, :, None, None]).to(dtype)


def _attention(cfg: TransformerConfig, q, k, v, positions, attn_impl: str = "xla",
               custom_positions: bool = False, window=None):
    """q:[B,S,Hq,hd] k,v:[B,S,Hkv,hd] -> [B,S,Hq,hd].

    Dispatch follows the JAX package exactly: ``"auto"`` takes the flash
    kernel once S >= 2048; ``"pallas"`` (the JAX package's name for it,
    kept so configs read the same) takes it when attention is causal,
    non-alibi, at default positions, without a window and S % 128 == 0;
    everything else takes the plain branch (``"xla"`` in JAX)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"{attn_impl} attention (sequence parallelism) is not ported yet "
            "(ROADMAP queue 1, item 8)")
    if attn_impl == "auto":
        attn_impl = "pallas" if S >= 2048 else "xla"
    if attn_impl == "pallas" and cfg.position != "alibi" and cfg.causal \
            and not custom_positions and window is None and S % 128 == 0:
        # GQA is handled in-kernel (KV-head indexing), no repeat
        return flash_attention(q, k, v, causal=True, sm_scale=_sm_scale(cfg, hd))
    if Hkv != Hq:  # GQA: repeat KV groups
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) * _sm_scale(cfg, hd)).float()
    if cfg.position == "alibi":
        scores = scores + _alibi_bias(cfg, positions, Hq, S, torch.float32)
    if cfg.causal:
        causal = positions[:, None, :, None] >= positions[:, None, None, :]
        scores = scores.masked_fill(~causal, NEG_INF)
    if window is not None:
        rel = positions[:, None, :, None] - positions[:, None, None, :]
        local_ok = (rel < window) | (window <= 0)
        scores = scores.masked_fill(~local_ok, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dense_mlp(cfg: TransformerConfig, lp: Dict[str, Any], h):
    if cfg.activation == "swiglu":
        g = _mm(h, lp["w_gate"])
        u = _mm(h, lp["w_up"])
        if cfg.mlp_bias:
            g, u = g + lp["b_gate"], u + lp["b_up"]
        m = _mm(F.silu(g) * u, lp["w_down"])
    else:
        m = _mm(h, lp["w_in"])
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
    if cfg.mlp_bias:
        m = m + lp["b_down"]
    return m


def _mlp(cfg: TransformerConfig, lp: Dict[str, Any], h):
    """Post-norm MLP body shared by the block and the cached decode block."""
    if "router" in lp:
        raise NotImplementedError(_MOE_ROW)
    return _dense_mlp(cfg, lp, h)


def _qkv(cfg, lp, h, B, S):
    hd, nh, nkv = cfg.dims_per_head, cfg.num_heads, cfg.kv_heads
    q, k, v = _mm(h, lp["wq"]), _mm(h, lp["wk"]), _mm(h, lp["wv"])
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd),
            v.reshape(B, S, nkv, hd))


def _out_proj(cfg, lp, attn, B, S):
    attn = _mm(attn.reshape(B, S, cfg.num_heads * cfg.dims_per_head), lp["wo"])
    return attn + lp["bo"] if cfg.attn_bias else attn


def _dropout(cfg: TransformerConfig, x, gen: Optional[torch.Generator]):
    """Inverted dropout at ``cfg.dropout`` (identity when ``gen`` is None)."""
    if gen is None or not cfg.dropout:
        return x
    keep = 1.0 - cfg.dropout
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return x * mask / keep


def _layer_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """One layer's dropout stream: a fresh generator from the layer's seed,
    so a layer recomputed under remat draws the same masks again."""
    if seed is None:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _block_postln(cfg: TransformerConfig, lp: Dict[str, Any], x, positions,
                  attn_impl: str, custom_positions: bool = False, window=None,
                  seed: Optional[int] = None):
    """Post-layernorm encoder block (BERT): x = LN(x + attn(x));
    x = LN(x + mlp(x))."""
    B, S, _ = x.shape
    gen = _layer_generator(seed, x.device)
    q, k, v = _qkv(cfg, lp, x, B, S)
    attn = _attention(cfg, q, k, v, positions, attn_impl, custom_positions,
                      window=window)
    attn = _dropout(cfg, _out_proj(cfg, lp, attn, B, S), gen)
    x = _norm(cfg, x + attn, lp["attn_norm_scale"], lp.get("attn_norm_bias"))
    m = _dropout(cfg, _mlp(cfg, lp, x), gen)
    return _norm(cfg, x + m, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))


def _block(cfg: TransformerConfig, lp: Dict[str, Any], x, positions,
           attn_impl: str, custom_positions: bool = False, window=None,
           seed: Optional[int] = None):
    """One pre-norm layer.  ``seed`` (training only) seeds its dropout."""
    if cfg.post_layernorm:
        return _block_postln(cfg, lp, x, positions, attn_impl,
                             custom_positions, window=window, seed=seed)
    B, S, _ = x.shape
    gen = _layer_generator(seed, x.device)
    h = _norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias"))
    q, k, v = _qkv(cfg, lp, h, B, S)
    if cfg.position == "rope":
        q, k = _rope(q, k, positions, cfg.rope_theta, cfg.dims_per_head,
                     rotary_dim=cfg.rotary_dim, interleaved=cfg.rope_interleaved)
    attn = _attention(cfg, q, k, v, positions, attn_impl, custom_positions,
                      window=window)
    attn = _dropout(cfg, _out_proj(cfg, lp, attn, B, S), gen)
    if cfg.parallel_residual:
        h2 = h if cfg.shared_layernorm else _norm(
            cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))
        return x + attn + _dropout(cfg, _mlp(cfg, lp, h2), gen)
    x = x + attn
    h = _norm(cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))
    return x + _dropout(cfg, _mlp(cfg, lp, h), gen)


def _build_block(cfg: TransformerConfig, attn_impl: str, custom_positions: bool):
    """One layer's apply fn ``block(lp, x, positions, window, seed)``, with
    remat applied while autograd records: ``nothing_saveable`` keeps only
    the layer's inputs and recomputes the layer (the flash forward
    included) in the backward, as ``jax.checkpoint`` does."""
    def block(lp, x, positions, window, seed):
        return _block(cfg, lp, x, positions, attn_impl, custom_positions,
                      window=window, seed=seed)

    if not (cfg.remat and torch.is_grad_enabled()):
        return block
    if cfg.remat_policy != "nothing_saveable":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet (ROADMAP queue "
            "1, item 2): only 'nothing_saveable' (full-layer recompute) is")
    # the dropout streams are explicit generators, so no global RNG state
    # needs saving for the recompute
    return lambda *args: checkpoint(block, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def _layer(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s weights: views into the stacked [L, ...] leaves."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        raise NotImplementedError(_MOE_ROW)
    return {name: leaf[i] for name, leaf in layers.items()}


def _layers(params: Dict[str, Any]):
    """Every layer's weights, unbound from the stacked leaves in one op per
    leaf (so the backward stacks each leaf's gradient once)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        raise NotImplementedError(_MOE_ROW)
    names = list(layers)
    return [dict(zip(names, views))
            for views in zip(*(layers[n].unbind(0) for n in names))]


def _embed(cfg, params, tokens, positions, token_type_ids=None):
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.position == "learned":
        x = x + params["pos_embed"][positions].to(cfg.dtype)
    if "type_embed" in params:   # BERT segment embeddings
        tt = (token_type_ids if token_type_ids is not None
              else torch.zeros_like(tokens))
        x = x + params["type_embed"][tt].to(cfg.dtype)
    if cfg.embed_layernorm:      # Bloom / BERT embedding LayerNorm
        x = _norm(cfg, x, params["embed_norm_scale"],
                  params.get("embed_norm_bias"))
    return x


def _head(cfg, params, x):
    if cfg.tie_embeddings:
        return _mm(x, params["embed"].to(cfg.dtype).T)
    logits = _mm(x, params["lm_head"].to(cfg.dtype))
    if "lm_head_bias" in params:   # GPT-J ties a bias to the LM head
        logits = logits + params["lm_head_bias"].to(cfg.dtype)
    return logits


def forward(cfg: TransformerConfig, params: Dict[str, Any], tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            rng: Optional[torch.Generator] = None,
            attn_impl: str = "xla", deterministic: bool = True,
            seq_sharded: bool = True, return_aux: bool = False,
            pld_theta=None, token_type_ids: Optional[torch.Tensor] = None):
    """tokens [B, S] -> logits [B, S, V] (+ aux dict if return_aux).

    ``deterministic=False`` turns on dropout (``cfg.dropout``) drawn from
    ``rng``, a ``torch.Generator`` (seed 0 on the tokens' device when None):
    it draws one seed per layer, as the JAX package splits one key per
    layer.  ``cfg.remat`` recomputes each layer in the backward when
    autograd records the call.  ``seq_sharded`` is accepted for signature
    parity and unused."""
    if pld_theta is not None:
        raise NotImplementedError(
            "progressive layer drop is not ported yet (ROADMAP queue 1, item 11)")
    if cfg.random_ltd and cfg.random_ltd_keep > 0:
        raise NotImplementedError(
            "random-LTD is not ported yet (ROADMAP queue 1, item 11)")
    _check_supported(cfg)
    B, S = tokens.shape
    tokens = tokens.long()
    custom_positions = positions is not None
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(B, S)
    seeds = [None] * cfg.num_layers
    if cfg.dropout and not deterministic:
        if rng is None:
            rng = torch.Generator(device=tokens.device)
            rng.manual_seed(0)
        seeds = torch.randint(0, 2 ** 62, (cfg.num_layers,), generator=rng,
                              device=rng.device).tolist()
    x = _embed(cfg, params, tokens, positions, token_type_ids)
    windows = layer_windows(cfg) or [None] * cfg.num_layers
    block = _build_block(cfg, attn_impl, custom_positions)
    for lp, window, seed in zip(_layers(params), windows, seeds):
        x = block(lp, x, positions, window, seed)
    if cfg.final_norm:
        x = _norm(cfg, x, params["final_norm_scale"], params.get("final_norm_bias"))
    logits = _head(cfg, params, x)
    if return_aux:
        return logits, {"moe_aux_loss": torch.zeros((), device=logits.device)}
    return logits


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
    accelerator's)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    L, B, T = cfg.num_layers, batch_size, max_len
    kv = (L, B, T, cfg.kv_heads, cfg.dims_per_head)
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
        slopes = torch.from_numpy(_alibi_slopes(Hq)).to(q.device).reshape(Hkv, G)
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
                  window=None):
    """One block with cache read/write.  ck/cv are this layer's
    [B,T,Hkv,hd] views into the cache, written in place."""
    B, S, _ = x.shape
    h = _norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias"))
    q, k, v = _qkv(cfg, lp, h, B, S)
    if cfg.position == "rope":
        q, k = _rope(q, k, q_pos, cfg.rope_theta, cfg.dims_per_head,
                     rotary_dim=cfg.rotary_dim, interleaved=cfg.rope_interleaved)
    ck[:, next_slot:next_slot + S] = k.to(ck.dtype)
    cv[:, next_slot:next_slot + S] = v.to(cv.dtype)
    attn = _attention_cached(cfg, q, ck, cv, q_pos, q_slot, valid, kpos,
                             window=window)
    attn = _out_proj(cfg, lp, attn, B, S)
    if cfg.parallel_residual:
        h2 = h if cfg.shared_layernorm else _norm(
            cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))
        return x + attn + _mlp(cfg, lp, h2)
    x = x + attn
    h = _norm(cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))
    return x + _mlp(cfg, lp, h)


def forward_cached(cfg: TransformerConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, cache: Dict[str, Any],
                   positions: torch.Tensor, input_mask: torch.Tensor):
    """Run ``tokens [B,S]`` (a prefill chunk or one decode token) against
    the cache, writing their K/V at slots ``next_slot..next_slot+S-1``.

    ``positions [B,S]``: absolute position ids.  ``input_mask [B,S]``: True
    for real tokens; False slots are written but never attended.  Returns
    ``(logits [B,S,V], cache)`` — the same cache dict, updated in place."""
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
    for i in range(cfg.num_layers):
        x = _block_cached(cfg, _layer(params, i), x, cache["k"][i], cache["v"][i],
                          positions, q_slot, cache["valid"], cache["pos"], ns,
                          None if windows is None else windows[i])
    x = _norm(cfg, x, params["final_norm_scale"], params.get("final_norm_bias"))
    cache["next_slot"] = ns + S
    return _head(cfg, params, x), cache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean next-token NLL; positions with ``labels == ignore_index`` masked."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)
