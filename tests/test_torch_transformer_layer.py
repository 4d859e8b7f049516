"""The port's ``DeepSpeedTransformerLayer`` against the JAX package's.

The same numpy parameters (the JAX layer's ``init``, converted with
``models.convert.layer_params_from_jax``) and hidden states go through both
layers' ``apply``: pre-LN and post-LN at fp32, rtol 1e-5.  Then the
behaviours tests/unit/test_transformer_layer.py checks on the JAX layer,
on the port's: shapes, identity with the model's encoder block,
bidirectional attention, initial weights and ``return_tuple``,
``stochastic_mode`` as the same program; and dropout from an explicit
generator, and the refusals."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import transformer as jax_tl
from deepspeed_tpu_torch.models.convert import layer_params_from_jax
from deepspeed_tpu_torch.models.transformer import _block
from deepspeed_tpu_torch.ops import transformer as port_tl
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention


def _kw(**kw):
    return {**dict(batch_size=2, hidden_size=32, intermediate_size=64, heads=4,
                   attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
                   num_hidden_layers=2, initializer_range=0.02, training=False),
            **kw}


def _layers(**kw):
    return (jax_tl.DeepSpeedTransformerLayer(jax_tl.DeepSpeedTransformerConfig(**_kw(**kw))),
            port_tl.DeepSpeedTransformerLayer(port_tl.DeepSpeedTransformerConfig(**_kw(**kw))))


def _jax_params(layer, seed=0):
    """The JAX layer's parameters with non-zero biases and norms (fresh ones
    are 0 and 1, which would hide a bias or norm wired wrongly)."""
    p = {key: np.asarray(x) for key, x in layer.init(jax.random.PRNGKey(seed)).items()}
    rs = np.random.RandomState(seed)
    for key in p:
        if key.startswith("b") or "norm" in key:
            p[key] = (p[key] + 0.1 * rs.standard_normal(p[key].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
def test_layer_matches_jax(pre_ln):
    jl, pl = _layers(pre_layer_norm=pre_ln)
    params = _jax_params(jl)
    x = np.random.RandomState(1).standard_normal((2, 16, 32)).astype(np.float32)
    ref = np.asarray(jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x)))
    out = pl.apply(layer_params_from_jax(params, device="cpu"), torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
def test_layer_forward_shapes(pre_ln):
    _, layer = _layers(pre_layer_norm=pre_ln)
    params = layer.init(torch.Generator().manual_seed(0))
    x = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(1))
    out = layer.apply(params, x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in _jax_params(_layers(pre_layer_norm=pre_ln)[0]).items()}


def test_layer_matches_bert_block():
    """post-LN mode is exactly the model's encoder block (one
    implementation, two surfaces)."""
    _, layer = _layers(pre_layer_norm=False)
    params = layer.init(torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    ref = _block(layer.native, params, x, pos, "auto")
    torch.testing.assert_close(layer.apply(params, x), ref, rtol=0, atol=0)


def test_layer_is_bidirectional_and_launches_no_kernel():
    _, layer = _layers()
    params = layer.init(torch.Generator().manual_seed(0))
    x1 = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(2))
    x2 = x1.clone()
    x2[0, -1] = torch.randn(32, generator=torch.Generator().manual_seed(3))
    before = flash_attention.launches
    o1, o2 = layer.apply(params, x1), layer.apply(params, x2)
    assert not torch.allclose(o1[0, 0], o2[0, 0])
    assert flash_attention.launches == before


def test_layer_initial_weights_and_return_tuple():
    layer = port_tl.DeepSpeedTransformerLayer(
        port_tl.DeepSpeedTransformerConfig(**_kw(return_tuple=True)),
        initial_weights={"wq": np.zeros((32, 32), np.float32)},
        initial_biases={"bq": np.ones(32, np.float32)})
    params = layer.init(torch.Generator().manual_seed(0))
    assert (params["wq"] == 0).all() and (params["bq"] == 1).all()
    out = layer.apply(params, torch.randn((1, 4, 32)))
    assert isinstance(out, tuple) and out[0].shape == (1, 4, 32)


def test_layer_stochastic_mode_is_same_program():
    """stochastic_mode selects a CUDA schedule in the reference; here both
    modes compute the same math — accepted, not a behaviour fork."""
    _, base = _layers()
    _, sto = _layers(stochastic_mode=True)
    params = base.init(torch.Generator().manual_seed(0))
    x = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(base.apply(params, x), sto.apply(params, x),
                               rtol=0, atol=0)


def test_layer_dropout_draws_from_the_generator():
    _, layer = _layers(attn_dropout_ratio=0.3, hidden_dropout_ratio=0.3)
    params = layer.init(torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(1))
    plain = layer.apply(params, x)                       # training=False
    a = layer.apply(params, x, generator=torch.Generator().manual_seed(5),
                    deterministic=False)
    b = layer.apply(params, x, generator=torch.Generator().manual_seed(5),
                    deterministic=False)
    c = layer.apply(params, x, generator=torch.Generator().manual_seed(6),
                    deterministic=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, plain) and not torch.allclose(a, c)
    torch.testing.assert_close(layer.apply(params, x, deterministic=True), plain,
                               rtol=0, atol=0)


def test_layer_refusals_match_jax():
    for pkg in (jax_tl, port_tl):
        with pytest.raises(ValueError, match="intermediate_size"):
            pkg.DeepSpeedTransformerConfig(**_kw(intermediate_size=-1)).to_native()
        with pytest.raises(NotImplementedError, match="dropout"):
            pkg.DeepSpeedTransformerLayer(pkg.DeepSpeedTransformerConfig(
                **_kw(attn_dropout_ratio=0.1)))
    jl, pl = _layers()
    mask = np.ones((2, 8), bool)
    mask[1, -1] = False
    x = np.zeros((2, 8, 32), np.float32)
    with pytest.raises(NotImplementedError, match="input masks"):
        jl.apply(jl.init(jax.random.PRNGKey(0)), jnp.asarray(x), jnp.asarray(mask))
    params = pl.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="input masks"):
        pl.apply(params, torch.from_numpy(x), torch.from_numpy(mask))
    ones = pl.apply(params, torch.from_numpy(x), torch.ones((2, 8), dtype=torch.bool))
    torch.testing.assert_close(ones, pl.apply(params, torch.from_numpy(x)),
                               rtol=0, atol=0)
    with pytest.raises(KeyError, match="w_down"):
        layer_params_from_jax({k: v for k, v in _jax_params(jl).items()
                               if k != "w_down"}, device="cpu")
