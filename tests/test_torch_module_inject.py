"""The port's HF conversion (``deepspeed_tpu_torch.module_inject``) against
the JAX package's and against ``transformers``.

For every dense family (and NeoX's sequential-residual and bias-free
variants, and GPT-Neo's window) a tiny HF model is built in-process from a
seed (nothing is downloaded): the port's ``config_from_hf`` must equal the
JAX package's field by field, the port's converted tree must equal JAX's
``hf_state_dict_to_params`` bit for bit (through ``models/convert.py``),
the port's fp32 logits must match JAX's at 1e-4 (the port's model
tolerance, ``tests/test_torch_model.py``) and HF's own at 2e-3 (JAX's,
``tests/unit/test_module_inject.py``).  A config read from ``config.json``
as a dict must give what ``transformers.AutoConfig`` gives, with the keys
a bare file may omit left out too.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import forward as jax_forward
from deepspeed_tpu.module_inject import config_from_hf as jax_config_from_hf
from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import forward
from deepspeed_tpu_torch.module_inject import (config_from_hf, detect_arch,
                                               hf_state_dict_to_params,
                                               load_hf_checkpoint)
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path
from tests.unit.test_module_inject import _gpt2_to_megatron_sd

transformers = pytest.importorskip("transformers")

TOL_JAX = 1e-4      # the port's model tolerance against JAX, fp32
TOL_HF = 2e-3       # JAX's tolerance against transformers, fp32


def _build(name):
    """(hf model, source passed to the loaders, encoder?) of one case."""
    torch.manual_seed(0)
    T = transformers
    if name == "llama":
        m = T.LlamaForCausalLM(T.LlamaConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64))
    elif name == "mistral":
        m = T.MistralForCausalLM(T.MistralConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            sliding_window=4096, attention_dropout=0.0))
    elif name == "gptj":
        m = T.GPTJForCausalLM(T.GPTJConfig(
            vocab_size=128, n_embd=32, n_layer=2, n_head=4, n_positions=64,
            rotary_dim=4, attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0))
    elif name.startswith("gpt_neox"):
        m = T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            rotary_pct=1.0 if name == "gpt_neox_seq" else 0.5,
            use_parallel_residual=name != "gpt_neox_seq",
            attention_bias=name != "gpt_neox_nobias",
            attention_dropout=0.0, hidden_dropout=0.0))
    elif name == "gpt2":
        m = T.GPT2LMHeadModel(T.GPT2Config(
            vocab_size=128, n_embd=32, n_layer=2, n_head=4, n_positions=64,
            attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0))
    elif name == "bloom":
        m = T.BloomForCausalLM(T.BloomConfig(
            vocab_size=128, hidden_size=32, n_layer=2, n_head=4,
            hidden_dropout=0.0, attention_dropout=0.0))
    elif name == "bert":
        m = T.BertModel(T.BertConfig(
            vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0))
    elif name.startswith("gpt_neo"):
        m = T.GPTNeoForCausalLM(T.GPTNeoConfig(
            vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64,
            attention_types=([[["global", "local"], 1]] if name == "gpt_neo"
                             else [[["local"], 2]]),
            window_size=4, embed_dropout=0.0, attention_dropout=0.0,
            resid_dropout=0.0))
    elif name == "distilbert":
        m = T.DistilBertModel(T.DistilBertConfig(
            vocab_size=128, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
            max_position_embeddings=64, dropout=0.0, attention_dropout=0.0))
    elif name == "clip":
        m = T.CLIPTextModel(T.CLIPTextConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=32, hidden_act="quick_gelu",
            attention_dropout=0.0))
    elif name == "opt":
        m = T.OPTForCausalLM(T.OPTConfig(
            vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64, dropout=0.0,
            word_embed_proj_dim=32, do_layer_norm_before=True))
    elif name == "megatron_gpt":
        m = T.GPT2LMHeadModel(T.GPT2Config(
            vocab_size=128, n_embd=32, n_layer=2, n_head=4, n_positions=64,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))
        cfg = {"model_type": "megatron_gpt", "vocab_size": 128, "hidden_size": 32,
               "num_layers": 2, "num_attention_heads": 4,
               "max_position_embeddings": 64}
        return m.eval(), (cfg, _gpt2_to_megatron_sd(m, n_heads=4)), False
    else:
        raise KeyError(name)
    m = m.eval()
    encoder = name in ("bert", "distilbert", "clip")
    return m, ((m.config, m.state_dict()) if encoder else m), encoder


CASES = ["llama", "mistral", "gptj", "gpt_neox", "gpt_neox_seq", "gpt_neox_nobias",
         "gpt2", "bloom", "bert", "gpt_neo", "gpt_neo_window", "distilbert", "clip",
         "megatron_gpt", "opt"]


def _config_fields(cfg):
    return {f.name: (str(getattr(cfg, f.name)).replace("torch.", "")
                     .replace("<class 'jax.numpy.", "").replace("'>", "")
                     if f.name == "dtype" else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", CASES)
def test_conversion_matches_jax_and_hf(name):
    hf, source, encoder = _build(name)
    hf_config = source[0] if isinstance(source, tuple) else hf.config
    assert _config_fields(config_from_hf(hf_config)) == _config_fields(
        jax_config_from_hf(hf_config))
    jcfg, jparams = jax_load(source)
    cfg, params = load_hf_checkpoint(source, device="cpu")
    want = dict(tree_flatten_with_path(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")))
    got = dict(tree_flatten_with_path(params))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert x.dtype == want[path].dtype == torch.float32, path
        assert torch.equal(x, want[path]), path

    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    jref = np.asarray(jax_forward(dataclasses.replace(jcfg, dtype=jnp.float32), jparams,
                                  jnp.asarray(tokens, jnp.int32), attn_impl="xla",
                                  deterministic=True))
    with torch.no_grad():
        ours = forward(dataclasses.replace(cfg, dtype=torch.float32), params,
                       torch.from_numpy(tokens), attn_impl="xla").numpy()
        out = hf(input_ids=torch.from_numpy(tokens))
    np.testing.assert_allclose(ours, jref, atol=TOL_JAX, rtol=TOL_JAX)
    if encoder:   # the encoder surface: the last hidden state on embed^T
        ref = out.last_hidden_state.numpy() @ params["embed"].numpy().T
    else:
        ref = out.logits.numpy()
    np.testing.assert_allclose(ours, ref, atol=TOL_HF, rtol=1e-3)


# keys a bare config.json may omit, per case: AutoConfig fills the class
# defaults, and the port's dict read must fill the same
OPTIONAL_KEYS = {
    "llama": ["rms_norm_eps", "rope_theta", "num_key_value_heads",
              "max_position_embeddings", "tie_word_embeddings"],
    "mistral": ["rms_norm_eps", "rope_theta", "num_key_value_heads",
                "max_position_embeddings", "tie_word_embeddings"],
    "gptj": ["rotary_dim", "n_inner", "layer_norm_epsilon", "n_positions"],
    "gpt_neox": ["rotary_pct", "partial_rotary_factor", "rotary_emb_base", "rope_theta",
                 "use_parallel_residual", "attention_bias", "layer_norm_eps",
                 "hidden_act", "max_position_embeddings"],
    "gpt2": ["n_inner", "n_positions", "layer_norm_epsilon"],
    "bloom": ["layer_norm_epsilon"],
    "bert": ["type_vocab_size", "layer_norm_eps", "hidden_act", "max_position_embeddings"],
    "gpt_neo": ["attention_layers", "window_size", "activation_function",
                "layer_norm_epsilon", "max_position_embeddings"],
    "distilbert": ["activation", "max_position_embeddings"],
    "clip": ["hidden_act", "layer_norm_eps", "max_position_embeddings"],
    "opt": ["word_embed_proj_dim", "do_layer_norm_before", "activation_function",
            "max_position_embeddings"],
}


@pytest.mark.parametrize("name", sorted(OPTIONAL_KEYS))
def test_config_dict_equals_autoconfig(name, tmp_path):
    hf, _, _ = _build(name)
    full, bare = tmp_path / "full", tmp_path / "bare"
    hf.config.save_pretrained(full)
    d = json.loads((full / "config.json").read_text())
    assert config_from_hf(d) == config_from_hf(transformers.AutoConfig.from_pretrained(full))
    stripped = {k: v for k, v in d.items() if k not in OPTIONAL_KEYS[name]}
    assert len(stripped) < len(d)
    bare.mkdir()
    (bare / "config.json").write_text(json.dumps(stripped))
    assert config_from_hf(stripped) == config_from_hf(
        transformers.AutoConfig.from_pretrained(bare)), name


def test_detect_arch_and_errors():
    hf, _, _ = _build("llama")
    assert detect_arch(hf.config) == "llama"
    assert detect_arch({"model_type": "clip_text_model"}) == "clip"
    assert detect_arch({"model_type": "megatron-gpt2"}) == "megatron_gpt"
    with pytest.raises(NotImplementedError, match="policy"):
        detect_arch({"model_type": "mamba"})
    cfg = config_from_hf(hf.config)
    with pytest.raises(KeyError, match="missing"):
        hf_state_dict_to_params({}, cfg, "llama", device="cpu")
    with pytest.raises(NotImplementedError, match="word_embed_proj_dim"):
        config_from_hf({"model_type": "opt", "hidden_size": 32, "word_embed_proj_dim": 16})
    with pytest.raises(NotImplementedError, match="do_layer_norm_before"):
        config_from_hf({"model_type": "opt", "hidden_size": 32,
                        "do_layer_norm_before": False})


def test_megatron_gpt_moe_refused_naming_item_9():
    """The MoE policy is detected and its config read, and (ROADMAP queue 1,
    item 9, done) the checkpoint loads: the router transposed to
    ``[L, d, E]``, each expert's Linears stacked to ``[L, E, ...]`` in
    expert order, as the JAX loader builds them
    (``tests/test_torch_moe.py`` holds the whole tree bit-equal to JAX's)."""
    from tests._torch_ranks import megatron_moe_state_dict

    d, L, E, f = 16, 2, 4, 32
    cfg_dict, sd = megatron_moe_state_dict(L, E, d, f)
    assert detect_arch(cfg_dict) == "megatron_gpt_moe"
    assert config_from_hf(cfg_dict).num_experts == E
    cfg, params = load_hf_checkpoint((cfg_dict, sd), device="cpu")
    layers = params["layers"]
    assert tuple(layers["router"].shape) == (L, d, E)
    assert tuple(layers["w_in"].shape) == (L, E, d, f)
    assert tuple(layers["b_in"].shape) == (L, E, f)
    for e in range(E):
        ex = f"transformer.layers.1.mlp.deepspeed_moe.experts.deepspeed_experts.{e}."
        np.testing.assert_array_equal(layers["w_in"][1, e].numpy(),
                                      sd[ex + "dense_h_to_4h.weight"].T)
        np.testing.assert_array_equal(layers["b_down"][1, e].numpy(),
                                      sd[ex + "dense_4h_to_h.bias"])


def test_init_inference_from_live_module_greedy_equals_jax():
    from deepspeed_tpu.parallel import mesh as mesh_mod

    hf, _, _ = _build("llama")
    ids = np.random.default_rng(1).integers(0, 128, (2, 7)).astype(np.int32)
    mesh_mod.reset_mesh()
    try:
        jeng = deepspeed_tpu.init_inference(model=hf, config={"dtype": "float32"})
        want = np.asarray(jeng.generate(ids, max_new_tokens=6))
    finally:
        mesh_mod.reset_mesh()
    eng = deepspeed_tpu_torch.init_inference(hf, config={"dtype": "float32"},
                                             device="cpu")
    assert eng.params["embed"].dtype == torch.float32
    assert eng.model.config.dtype == torch.float32
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=6).numpy(), want)
    # the same from a (config, state_dict) pair, in bf16 leaves
    model, params = deepspeed_tpu_torch.models.CausalLM.from_hf(
        (hf.config, hf.state_dict()), dtype=torch.bfloat16, device="cpu")
    assert model.config.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for _, x in tree_flatten_with_path(params))
