"""Weight-only quantized inference of the port
(``ops/quantizer``, ``inference/quantization.py``, the quantized engine)
against the JAX package's, on the same numpy weights.

The blockwise codes and scales must equal JAX's at 8 and 4 bits (tail
blocks, zero blocks, extremes), ``quantize_params`` must pick JAX's leaves
(the stacked norm scales of a 7B-wide layer included), the int8 engine's
fp32-compute logits must match JAX's int8 engine at 1e-4, and the port's
per-layer dequantization must be bit-equal to dequantizing the whole tree
first, on every forward path, with an FFN of 130 so that blocks straddle
layers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.ops.quantizer import quantizer as jquant
from deepspeed_tpu_torch.inference import Request
from deepspeed_tpu_torch.inference.quantization import (MIN_QUANT_SIZE, QuantizedWeight,
                                                        dequantize_params,
                                                        quantize_params, tree_nbytes)
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import (forward, forward_cached,
                                                    forward_paged)
from deepspeed_tpu_torch.ops.quantizer import dequantize_blockwise, quantize_blockwise
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path
from tests._torch_ranks import run_ranks

TOL_JAX = 1e-4


def _inputs():
    rs = np.random.default_rng(0)
    x = rs.standard_normal((7, 300)).astype(np.float32)     # 2100: a tail block
    x[1] = 0.0                                               # zero blocks
    x[2, :5] = [1e4, -1e4, 3e-8, -3e-8, 0.5]                 # extremes
    x[3] = rs.standard_normal(300).astype(np.float32) * 1e-6
    x[4, ::7] = np.float32(2.5)                              # ties in code space
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [256, 16])
def test_blockwise_codes_and_scales_equal_jax(bits, block):
    x = _inputs()
    jqv, js = jquant.quantize_blockwise(jnp.asarray(x), block=block, bits=bits)
    q, s = quantize_blockwise(torch.from_numpy(x), block=block, bits=bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == jqv.shape and tuple(s.shape) == js.shape
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # codes: equal (no code differs by 1; none may differ by more)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    got = dequantize_blockwise(q, s, x.shape, torch.float32, block=block, bits=bits)
    want = jquant.dequantize_blockwise(jqv, js, x.shape, jnp.float32, block=block,
                                       bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the round trip is within half a step of the block's scale
    step = np.repeat(s.numpy(), block)[:x.size].reshape(x.shape)
    assert (np.abs(got.numpy() - x) <= 0.5 * step + 1e-6 * np.abs(x)).all()


def test_int4_nibbles_sign_extend_as_jax():
    codes = np.arange(-7, 8, dtype=np.int8)
    rows = np.concatenate([codes, codes[::-1], [0]]).astype(np.float32)[None]
    q, s = quantize_blockwise(torch.from_numpy(rows), block=16, bits=4)
    jqv, _ = jquant.quantize_blockwise(jnp.asarray(rows), block=16, bits=4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    back = dequantize_blockwise(q, s, rows.shape, torch.float32, block=16, bits=4)
    np.testing.assert_array_equal(back.numpy(), rows)


def _trees(name="tiny", seed=0, **overrides):
    jmodel = JaxCausalLM(name, dtype=jnp.float32, attn_impl="xla", **overrides)
    jparams = jmodel.init_fn(jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, np_tree


def _qw_paths(tree, is_qw):
    return sorted(p for p, x in tree_flatten_with_path(tree) if is_qw(x))


def test_quantize_params_picks_jax_leaves():
    """The same leaves, codes and scales as JAX's ``quantize_params``; a
    stacked ``[32, 4096]`` norm scale (llama2-7b's) is quantized, a
    ``[2, 64]`` one is not."""
    _, jparams, np_tree = _trees()
    np_tree = dict(np_tree, layers=dict(np_tree["layers"],
                                        big_norm=np.ones((32, 4096), np.float32)))
    jtree = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jq8 = jq.quantize_params(jtree, bits=8, compute_dtype=jnp.float32)
    q8 = quantize_params(params_from_jax(np_tree, device="cpu"), bits=8,
                         compute_dtype=torch.float32)
    jflat = {jax.tree_util.keystr(p).replace("['", "").replace("']", "/").rstrip("/"): x
             for p, x in jax.tree_util.tree_leaves_with_path(
                 jq8, is_leaf=lambda x: isinstance(x, jq.QuantizedWeight))}
    assert _qw_paths(q8, lambda x: isinstance(x, QuantizedWeight)) == sorted(
        p for p, x in jflat.items() if isinstance(x, jq.QuantizedWeight))
    assert "layers/big_norm" in jflat and isinstance(q8["layers"]["big_norm"],
                                                     QuantizedWeight)
    assert not isinstance(q8["layers"]["attn_norm_scale"], QuantizedWeight)
    for path, x in tree_flatten_with_path(q8):
        if isinstance(x, QuantizedWeight):
            np.testing.assert_array_equal(x.q.numpy(), np.asarray(jflat[path].q))
            np.testing.assert_array_equal(x.scale.numpy(), np.asarray(jflat[path].scale))
            assert x.shape == jflat[path].shape
        else:
            assert x.numel() < MIN_QUANT_SIZE or x.ndim < 2, path
    # bytes at rest: JAX's count and JAX's bars against the bf16 tree
    assert tree_nbytes(q8) == jq.tree_nbytes(jq8)
    bf16 = params_from_jax(np_tree, device="cpu", dtype=torch.bfloat16)
    q4 = quantize_params(bf16, bits=4)
    assert tree_nbytes(q8) < 0.62 * tree_nbytes(bf16)
    assert tree_nbytes(q4) < 0.40 * tree_nbytes(bf16)
    assert tree_nbytes(q4) == jq.tree_nbytes(jq.quantize_params(jtree, bits=4))


def test_int8_engine_logits_match_jax_int8_engine():
    jmodel, jparams, np_tree = _trees(seed=1)
    config = {"dtype": "float32", "quant": {"enabled": True}}
    jeng = deepspeed_tpu.init_inference(model=jmodel, params=jparams, config=config)
    teng = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32, attn_impl="xla"), config=config,
        params=params_from_jax(np_tree, device="cpu"), device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
    want = np.asarray(jeng(jnp.asarray(tokens)), np.float32)
    got = teng.forward(tokens)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_JAX, rtol=TOL_JAX)
    assert all(x.dtype == torch.float32 for _, x in tree_flatten_with_path(
        dequantize_params(teng.params)))


@pytest.mark.parametrize("bits", [8, 4])
def test_per_layer_dequant_bit_equal_to_whole_tree(bits):
    """FFN 130: a layer's 8320 elements of w_gate end mid-block, so the
    boundary block straddles two layers."""
    model = CausalLM("tiny", dtype=torch.float32, attn_impl="xla", intermediate_size=130)
    cfg = model.config
    params = model.init_fn(torch.Generator().manual_seed(2), device="cpu")
    q = quantize_params(params, bits=bits, compute_dtype=torch.float32)
    w_gate = q["layers"]["w_gate"]
    assert isinstance(w_gate, QuantizedWeight) and (64 * 130) % w_gate.block
    d = dequantize_params(q)
    for i in range(cfg.num_layers):
        assert torch.equal(w_gate.layer(i), d["layers"]["w_gate"][i])
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 12)))
    assert torch.equal(forward(cfg, q, tokens), forward(cfg, d, tokens))

    def cached(tree):
        cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
        pos = torch.arange(12)[None].expand(2, 12)
        return forward_cached(cfg, tree, tokens, cache, pos,
                              torch.ones((2, 12), dtype=torch.bool))[0]

    assert torch.equal(cached(q), cached(d))

    def paged(tree):
        cache = model.init_paged_cache(9, 8, dtype=torch.float32, device="cpu")
        table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
        start = torch.zeros(2, dtype=torch.int32)
        logits, cache = forward_paged(cfg, tree, tokens, cache, table, start,
                                      torch.ones((2, 12), dtype=torch.bool))
        step, _ = forward_paged(cfg, tree, tokens[:, :1], cache, table,
                                torch.full((2,), 12, dtype=torch.int32),
                                torch.ones((2, 1), dtype=torch.bool))
        return logits, step

    for a, b in zip(paged(q), paged(d)):
        assert torch.equal(a, b)


def test_quantized_generate_and_serving_equal_dequantized():
    model = CausalLM("tiny", dtype=torch.bfloat16, intermediate_size=130)
    params = model.init_fn(torch.Generator().manual_seed(4), device="cpu")
    qeng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "int8"},
                                              params=params, device="cpu")
    assert qeng.model is model   # the CausalLM reads the quantized tree itself
    deq = dequantize_params(qeng.params)
    assert all(x.dtype == torch.bfloat16 for _, x in tree_flatten_with_path(deq))
    ref = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                             params=deq, device="cpu")
    rs = np.random.default_rng(5)
    prompts = rs.integers(0, 256, (3, 9)).astype(np.int32)
    np.testing.assert_array_equal(qeng.generate(prompts, max_new_tokens=6).numpy(),
                                  ref.generate(prompts, max_new_tokens=6).numpy())
    reqs = [Request(rid=i, input_ids=rs.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=5) for i, n in enumerate((4, 11, 7, 19))]
    outs = {}
    for name, eng in (("q", qeng), ("ref", ref)):
        sv = eng.serving(b_slots=3, page_size=8, max_model_len=64)
        assert sv._exec.pools[0].dtype == torch.bfloat16   # compute dtype, not int8
        outs[name] = {r.rid: r.output_ids for r in sv.run(list(reqs))}
        assert sv.page_accounting()["balanced"]
    for rid in outs["ref"]:
        np.testing.assert_array_equal(outs["q"][rid], outs["ref"][rid])
    # an fp32-activation model beside a bf16-compute pool is refused by name
    f32 = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32), config={"dtype": "int8"},
        params=params, device="cpu")
    with pytest.raises(ValueError, match="compute dtype"):
        f32.serving(b_slots=3, page_size=8, max_model_len=64)


def test_refusals(tmp_path):
    """JAX's refusals: no params, the ``generate(model=...)`` guard, and a
    model axis above 1 (two gloo ranks, through ``mesh=`` and
    ``tp_size``); a bare apply_fn reads the tree dequantized whole."""
    model = CausalLM("tiny", dtype=torch.float32)
    params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="param tree"):
        deepspeed_tpu_torch.init_inference(apply_fn=lambda p, x: x,
                                           config={"dtype": "int8"}, device="cpu")
    q = deepspeed_tpu_torch.init_inference(model, config={"dtype": "int8"},
                                           params=params, device="cpu")
    with pytest.raises(NotImplementedError, match="explicit params"):
        q.generate(np.zeros((1, 4), np.int32), max_new_tokens=2,
                   model=CausalLM("tiny", dtype=torch.float32))
    bare = deepspeed_tpu_torch.init_inference(
        apply_fn=model.apply_fn, params=params, config={"dtype": "int8"}, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    assert torch.equal(bare.forward(tokens), q.forward(tokens))
    outs = run_ranks(2, "quant_tp", tmp_path, timeout=90, model="tiny", tp=2)
    for out in outs:
        assert set(out) == {"mesh", "tp_size"}
        assert all("tp=1" in msg for msg in out.values())
