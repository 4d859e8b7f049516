"""The port's inference engine against the JAX package's.

Greedy ``generate`` must be token-exact against JAX
``init_inference(..., config={"dtype": "float32"}).generate`` on the same
numpy weights, with ragged prompts (``attention_mask``) and an eos row.
Sampled streams use the port's own generators, so they are checked for
determinism per seed within the port, not for equality with JAX's keys;
``filter_logits`` (the sampling math) is held to JAX's on the same logits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.inference import DeepSpeedInferenceConfig, Request, SamplingParams
from deepspeed_tpu_torch.inference import sampling as tsampling
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.quantization import QuantizedWeight
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax


def _engines(name, seed=3):
    jmodel = JaxCausalLM(name, dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(seed))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    tmodel = CausalLM(name, dtype=torch.float32, attn_impl="xla")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    teng = deepspeed_tpu_torch.init_inference(tmodel, config={"dtype": "float32"},
                                              params=tparams, device="cpu")
    return jeng, teng


def _ragged(vocab, lengths, seed=0):
    rs = np.random.RandomState(seed)
    S = max(lengths)
    ids = np.zeros((len(lengths), S), np.int32)
    mask = np.zeros((len(lengths), S), bool)
    for i, n in enumerate(lengths):
        ids[i, :n] = rs.randint(0, vocab, n)
        mask[i, :n] = True
    return ids, mask


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_greedy_generate_token_exact_vs_jax(name):
    jeng, teng = _engines(name)
    ids, mask = _ragged(256, [5, 17, 9], seed=1)
    ref = np.asarray(jeng.generate(ids, max_new_tokens=12, attention_mask=mask))
    out = teng.generate(ids, max_new_tokens=12, attention_mask=mask)
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), ref)


def test_greedy_generate_with_eos_token_exact_vs_jax():
    jeng, teng = _engines("tiny", seed=5)
    prompt = np.array([[5, 3, 9, 2], [1, 7, 2, 8]], np.int32)
    plain = teng.generate(prompt, max_new_tokens=8).numpy()
    eos = int(plain[0, 5])   # the 2nd generated token of row 0
    ref = np.asarray(jeng.generate(prompt, max_new_tokens=8, eos_token_id=eos))
    out = teng.generate(prompt, max_new_tokens=8, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(out, ref)
    gen = out[0, 4:]
    first = np.where(gen == eos)[0][0]
    assert (gen[first:] == eos).all()


def test_forward_matches_jax_engine_logits():
    jeng, teng = _engines("tiny-gqa", seed=7)
    ids = np.random.RandomState(2).randint(0, 256, (2, 32)).astype(np.int32)
    ref = np.asarray(jeng.forward(jnp.asarray(ids)))
    out = teng.forward(ids)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_filter_logits_matches_jax():
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((5, 64)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.0, 1.3, 2.0], np.float32)
    top_k = np.array([0, 5, 64, 3, 100], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.3], np.float32)
    ref = np.asarray(jsampling.filter_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    out = tsampling.filter_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                                  torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(ref))
    kept = ~np.isinf(ref)
    np.testing.assert_allclose(out.numpy()[kept], ref[kept], rtol=1e-6)


def test_sampled_streams_deterministic_per_seed():
    _, teng = _engines("tiny", seed=9)
    ids, mask = _ragged(256, [6, 11], seed=3)
    lanes = [SamplingParams(temperature=1.0, top_k=20, seed=11),
             SamplingParams(temperature=0.8, top_p=0.9, seed=12)]
    a = teng.generate(ids, max_new_tokens=10, attention_mask=mask, sampling=lanes)
    b = teng.generate(ids, max_new_tokens=10, attention_mask=mask, sampling=lanes)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = [SamplingParams(temperature=1.0, top_k=20, seed=99), lanes[1]]
    c = teng.generate(ids, max_new_tokens=10, attention_mask=mask, sampling=other)
    assert not torch.equal(a[0], c[0])          # another seed, another stream
    torch.testing.assert_close(a[1], c[1], rtol=0, atol=0)  # lanes independent
    # greedy lanes are the greedy path
    g = teng.generate(ids, max_new_tokens=10, attention_mask=mask,
                      sampling=SamplingParams())
    torch.testing.assert_close(g, teng.generate(ids, max_new_tokens=10,
                                                attention_mask=mask),
                               rtol=0, atol=0)
    # the legacy knobs draw from one generator in order: same seed, same tokens
    r1 = teng.generate(ids, max_new_tokens=6, attention_mask=mask, greedy=False,
                       top_k=8, rng=torch.Generator().manual_seed(4))
    r2 = teng.generate(ids, max_new_tokens=6, attention_mask=mask, greedy=False,
                       top_k=8, rng=torch.Generator().manual_seed(4))
    torch.testing.assert_close(r1, r2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        teng.generate(ids, sampling=lanes, top_k=3)


def test_sampled_stream_resumes_at_any_position():
    """Counter-based generators: re-prefilling prompt + the first n sampled
    tokens continues the stream exactly."""
    _, teng = _engines("tiny", seed=10)
    prompt = np.array([[4, 8, 15, 16, 23]], np.int32)
    sp = SamplingParams(temperature=1.0, seed=5)
    full = teng.generate(prompt, max_new_tokens=8, sampling=sp).numpy()
    resumed = teng.generate(full[:, :8], max_new_tokens=5, sampling=sp).numpy()
    np.testing.assert_array_equal(resumed, full)


def test_config_and_unported_paths(tmp_path, monkeypatch):
    monkeypatch.delenv("DS_TPU_FLEET_COORD_DIR", raising=False)
    cfg = DeepSpeedInferenceConfig.from_dict(
        {"dtype": "fp32", "tp": {"tp_size": 1}, "max_out_tokens": "auto",
         "no_such_knob": 1})
    assert cfg.torch_dtype == torch.float32
    assert cfg.max_out_tokens == 1024
    with pytest.raises(ValueError):
        DeepSpeedInferenceConfig.from_dict({"tensor_parallel": {"tp_size": 0}})
    model = CausalLM("tiny", dtype=torch.float32)
    params = model.init_fn(torch.Generator().manual_seed(0))
    # dtype "int8": weight-only quantization (tests/test_torch_quantization.py)
    q = deepspeed_tpu_torch.init_inference(model, config={"dtype": "int8"},
                                           params=params, device="cpu")
    assert isinstance(q.params["embed"], QuantizedWeight)
    assert q.params["embed"].dtype == torch.bfloat16 and q.params["embed"].bits == 8
    assert DeepSpeedInferenceConfig(dtype="int8").compute_torch_dtype == torch.bfloat16
    # tensor parallelism runs one rank per device (tests/test_torch_tp.py)
    with pytest.raises(RuntimeError, match="tensor-parallel inference .* process group"):
        deepspeed_tpu_torch.init_inference(
            model, config={"tensor_parallel": {"tp_size": 2}}, params=params,
            device="cpu")
    # an HF directory loads through module_inject (tests/test_torch_sharded_load.py);
    # one without a config.json says so
    with pytest.raises(FileNotFoundError, match="config.json"):
        deepspeed_tpu_torch.init_inference("/some/hf/checkpoint", device="cpu")
    eng = deepspeed_tpu_torch.init_inference(model, params=params, device="cpu")
    assert eng.params["embed"].dtype == torch.bfloat16   # default dtype
    # the serving fleet (item 14) builds its members on this engine's weights
    # (tests/test_torch_fleet.py); without a store it says so
    with pytest.raises(ValueError, match="coord_dir"):
        eng.serving_fleet(b_slots=1, page_size=8, max_model_len=32)
    router = eng.serving_fleet(n_engines=1, coord_dir=str(tmp_path / "fleet"), b_slots=1,
                               page_size=8, max_model_len=32)
    ids = np.array([3, 1, 4, 1, 5], np.int32)
    (res,) = router.run([Request(rid=0, input_ids=ids, max_new_tokens=3)], max_ticks=100)
    (want,) = eng.serving(b_slots=1, page_size=8, max_model_len=32).run(
        [Request(rid=0, input_ids=ids, max_new_tokens=3)])
    np.testing.assert_array_equal(res.output_ids, want.output_ids)
    assert res.finish_reason == "length" and len(res.output_ids) == 3
    # the supervisor is ported (tests/test_torch_serving_supervisor.py)
    sup = eng.supervised_serving(b_slots=1, page_size=8, max_model_len=32)
    assert type(sup).__name__ == "ServingSupervisor" and sup.restarts == 0
    with pytest.raises(TypeError, match="MeshLayout"):
        eng.serving(mesh=object())


# ---------------------------------------------------------------------------
# The full-recompute fallback (a bare apply_fn: no KV cache)
# ---------------------------------------------------------------------------

def _uncached_engines(name="tiny", seed=11, head_scale=1.0, wrap=None):
    """JAX and port engines over ``apply_fn`` alone (no model, so no
    ``apply_cached``), on the same weights; ``wrap(apply_fn, onehot)``
    builds a variant apply_fn in both packages."""
    jmodel = JaxCausalLM(name, dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(seed))
    jparams = dict(jparams, lm_head=jparams["lm_head"] * head_scale)
    tmodel = CausalLM(name, dtype=torch.float32, attn_impl="xla")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    japply = lambda p, t: jmodel.apply_fn(p, t)  # noqa: E731
    tapply = lambda p, t: tmodel.apply_fn(p, t)  # noqa: E731
    if wrap is not None:
        V = tmodel.config.vocab_size
        japply = wrap(japply, lambda t: jax.nn.one_hot(t, V))
        tapply = wrap(tapply, lambda t: torch.nn.functional.one_hot(t.long(), V).float())
    jeng = deepspeed_tpu.init_inference(apply_fn=japply, params=jparams,
                                        config={"dtype": "float32"})
    teng = deepspeed_tpu_torch.init_inference(apply_fn=tapply, params=tparams,
                                              config={"dtype": "float32"}, device="cpu")
    assert teng.model is None
    return jeng, teng


def test_uncached_generate_greedy_token_exact_vs_jax():
    jeng, teng = _uncached_engines()
    ids = np.random.RandomState(3).randint(0, 256, (3, 13)).astype(np.int32)
    ref = np.asarray(jeng.generate(ids, max_new_tokens=9))   # crosses bucket 16 -> 32
    out = teng.generate(ids, max_new_tokens=9)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert teng._uncached_causal is True and InferenceEngine._warned_uncached
    # early exit once every row's last token is eos (one row: its 2nd token)
    one = ids[:1]
    eos = int(out[0, 14])
    ref = np.asarray(jeng.generate(one, max_new_tokens=9, eos_token_id=eos))
    got = teng.generate(one, max_new_tokens=9, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (1, 15)


def test_uncached_generate_probe_takes_the_exact_path_for_non_causal_apply_fn():
    """An apply_fn whose logits read the sequence's last token (a pad, once
    bucketed) is not causal: the probe latches the exact, unpadded path in
    both packages, and the tokens agree."""
    def wrap(apply, onehot):
        return lambda p, t: apply(p, t) + 30.0 * onehot(t[:, -1])[:, None, :]

    jeng, teng = _uncached_engines(seed=12, wrap=wrap)
    ids = np.random.RandomState(4).randint(1, 256, (2, 10)).astype(np.int32)
    ref = np.asarray(jeng.generate(ids, max_new_tokens=5))
    out = teng.generate(ids, max_new_tokens=5).numpy()
    np.testing.assert_array_equal(out, ref)
    assert teng._uncached_causal is False and jeng._uncached_causal is False
    # the exact path repeats the last token (the wrap's bias wins)
    assert (out[:, 10:] == ids[:, -1:]).all()


def test_uncached_generate_sampled_follows_jax_distribution():
    """Temperature sampling draws from the same distribution as JAX's
    ``jax.random.categorical`` (the generators differ, so the tokens are
    compared in law): the frequencies of the likeliest first tokens over
    2000 rows lie within 4 sigma of JAX's probabilities, as JAX's own
    samples do; the port's draws are fixed by its generator."""
    jeng, teng = _uncached_engines(seed=13, head_scale=40.0)
    T, n = 0.8, 2000
    prompt = np.random.RandomState(5).randint(0, 256, (1, 6)).astype(np.int32)
    rows = np.repeat(prompt, n, axis=0)
    logits = np.asarray(jeng(jnp.asarray(prompt)))[0, -1].astype(np.float64) / T
    p = np.exp(logits - logits.max())
    p /= p.sum()
    top = np.argsort(-p)[:4]
    assert p[top[0]] < 0.9 and p[top].sum() > 0.5     # peaked, not degenerate
    gen = torch.Generator().manual_seed(0)
    ours = teng.generate(rows, max_new_tokens=1, greedy=False, temperature=T,
                         rng=gen).numpy()[:, -1]
    theirs = np.asarray(jeng.generate(rows, max_new_tokens=1, greedy=False,
                                      temperature=T, rng=jax.random.PRNGKey(0)))[:, -1]
    for draws in (ours, theirs):
        for tok in top:
            freq = (draws == tok).mean()
            assert abs(freq - p[tok]) < 4 * np.sqrt(p[tok] * (1 - p[tok]) / n), (tok, freq)
    again = teng.generate(rows[:8], max_new_tokens=3, greedy=False, temperature=T,
                          rng=torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_array_equal(
        again, teng.generate(rows[:8], max_new_tokens=3, greedy=False, temperature=T,
                             rng=torch.Generator().manual_seed(1)).numpy())
    # temperature <= 0 folds to greedy
    np.testing.assert_array_equal(
        teng.generate(prompt, max_new_tokens=3, greedy=False, temperature=0.0).numpy(),
        np.asarray(jeng.generate(prompt, max_new_tokens=3)))


def test_uncached_generate_refusals():
    _, teng = _uncached_engines()
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError, match="attention_mask"):
        teng.generate(ids, attention_mask=np.ones((1, 4), bool))
    for kw in ({"top_k": 5}, {"top_p": 0.9}):
        with pytest.raises(NotImplementedError, match="top_k/top_p"):
            teng.generate(ids, greedy=False, **kw)
    with pytest.raises(NotImplementedError, match="lane path"):
        teng.generate(ids, sampling=SamplingParams(temperature=1.0, seed=1))
