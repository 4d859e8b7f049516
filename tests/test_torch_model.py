"""The port's causal-LM forward against the JAX package's.

JAX initialises the weights; they cross as numpy arrays through
``params_from_jax``.  Both sides run in fp32 on the CPU; JAX's model-level
``forward`` is called directly with no global mesh (a JAX InferenceEngine
would build one over the 8 virtual devices and route attention through its
shard_map branch).  With ``attn_impl="pallas"`` at S=128 JAX runs the flash
kernel in interpret mode and the port runs its flash wrapper's plain version.
Tolerance atol/rtol 1e-4: the two differ only in summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import CausalLM, transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(name, seed=0, **overrides):
    jcfg = jtf.get_config(name, dtype=jnp.float32, **overrides)
    tcfg = ttf.get_config(name, dtype=torch.float32, **overrides)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(np_tree, device="cpu")


def _tokens(vocab, B=2, S=128, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa", "tiny-gpt2"])
@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_forward_matches_jax(name, attn_impl):
    jcfg, tcfg, jparams, tparams = _pair(name)
    tokens = _tokens(tcfg.vocab_size)
    ref = jtf.forward(jcfg, jparams, jnp.asarray(tokens), attn_impl=attn_impl,
                      seq_sharded=False)
    out = ttf.forward(tcfg, tparams, torch.from_numpy(tokens), attn_impl=attn_impl)
    assert out.shape == (2, 128, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("overrides", [
    dict(position="alibi", norm="layernorm", activation="gelu"),
    dict(parallel_residual=True, rotary_dim=8, rope_interleaved=True),
    dict(attention_layers=("global", "local"), window_size=16),
], ids=["alibi", "gptj-style", "local-window"])
def test_forward_variants_match_jax(overrides):
    jcfg, tcfg, jparams, tparams = _pair("tiny", seed=2, **overrides)
    tokens = _tokens(tcfg.vocab_size, S=64, seed=4)
    ref = jtf.forward(jcfg, jparams, jnp.asarray(tokens), attn_impl="auto",
                      seq_sharded=False)
    out = ttf.forward(tcfg, tparams, torch.from_numpy(tokens), attn_impl="auto")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa", "tiny-gpt2"])
def test_forward_cached_prefill_and_decode_match_jax(name):
    jcfg, tcfg, jparams, tparams = _pair(name, seed=3)
    B, S, T = 2, 16, 128
    tokens = _tokens(tcfg.vocab_size, B=B, S=S, seed=5)
    mask = np.ones((B, S), bool)
    mask[0, 11:] = False                       # ragged first row
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)

    jcache = jtf.init_cache(jcfg, B, T, dtype=jnp.float32)
    jl, jcache = jtf.forward_cached(jcfg, jparams, jnp.asarray(tokens), jcache,
                                    jnp.asarray(pos), jnp.asarray(mask))
    tcache = ttf.init_cache(tcfg, B, T, dtype=torch.float32, device="cpu")
    tl, tcache = ttf.forward_cached(tcfg, tparams, torch.from_numpy(tokens),
                                    tcache, torch.from_numpy(pos),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)

    nxt = np.asarray([[7], [9]], np.int32)
    npos = (mask.sum(1, keepdims=True)).astype(np.int32)
    nmask = np.ones((B, 1), bool)
    jl2, _ = jtf.forward_cached(jcfg, jparams, jnp.asarray(nxt), jcache,
                                jnp.asarray(npos), jnp.asarray(nmask))
    tl2, tcache = ttf.forward_cached(tcfg, tparams, torch.from_numpy(nxt), tcache,
                                     torch.from_numpy(npos),
                                     torch.from_numpy(nmask))
    assert tcache["next_slot"] == S + 1
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((2, 8, 32)).astype(np.float32)
    labels = rs.randint(0, 32, (2, 8)).astype(np.int32)
    labels[0, :3] = -100
    ref = jtf.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    out = ttf.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(out.item(), float(ref), atol=1e-6, rtol=1e-6)


def test_attention_dispatch_follows_jax_conditions(monkeypatch):
    """The flash kernel is taken exactly where JAX takes its Pallas kernel:
    auto at S >= 2048 (or pallas), causal, non-alibi, default positions, no
    window, S % 128 == 0; everything else takes the plain branch."""
    calls = []
    real = ttf.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ttf, "flash_attention", counting)
    cfg = ttf.get_config("tiny", dtype=torch.float32)
    rs = np.random.RandomState(0)

    def run(S, impl, cfg=cfg, custom=False, window=None):
        calls.clear()
        q = torch.from_numpy(rs.standard_normal((1, S, 4, 16)).astype(np.float32))
        pos = torch.arange(S)[None]
        ttf._attention(cfg, q, q, q, pos, impl, custom_positions=custom,
                       window=window)
        return len(calls)

    assert run(128, "pallas") == 1
    assert run(2048, "auto") == 1
    assert run(1024, "auto") == 0
    assert run(192, "pallas") == 0            # S % 128 != 0
    assert run(128, "xla") == 0
    assert run(128, "pallas", custom=True) == 0
    assert run(128, "pallas", window=16) == 0
    assert run(128, "pallas", cfg=ttf.get_config("tiny", position="alibi")) == 0
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run(128, impl)


def test_params_round_trip_and_unported_configs_raise():
    jcfg, tcfg, jparams, tparams = _pair("tiny")
    back = params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # same keys and shapes from the port's own initialiser
    own = CausalLM("tiny").init_fn(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(params_to_numpy(own)) == \
        jax.tree_util.tree_structure(back)
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree_util.tree_leaves(params_to_numpy(own)),
        jax.tree_util.tree_leaves(back)))
    with pytest.raises(NotImplementedError, match="MoE"):
        CausalLM("tiny-moe").init_fn()
    with pytest.raises(NotImplementedError, match="progressive layer drop"):
        ttf.forward(tcfg, tparams, torch.zeros((1, 8), dtype=torch.long),
                    deterministic=False, pld_theta=0.5)


def test_module_call_runs_the_forward():
    model = CausalLM("tiny", dtype=torch.float32, attn_impl="xla")
    with pytest.raises(ValueError, match="load_params"):
        model(torch.zeros((1, 4), dtype=torch.long))
    model.load_params(model.init_fn(torch.Generator().manual_seed(1)))
    tokens = torch.randint(0, 256, (2, 8), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(model(tokens),
                               model.apply_fn(model.params, tokens))
