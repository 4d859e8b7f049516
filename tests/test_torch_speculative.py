"""Speculative decoding of the port against the JAX package's, on the CPU.

Same numpy weights, fp32: ``SpeculativeConfig.validate`` refusing what
JAX's refuses, ``layer_skip_draft`` trees equal to JAX's, greedy
speculative decoding token-exact against non-speculative decoding with the
accepted lengths (emitted tokens and verify ticks in total and per request)
equal to JAX's on the same perturbed draft (built by JAX, carried over with
``models.convert``), a weight swap local to its server, eos and budget
cutting a verify block, an int8 draft
pool, and sampled streams: deterministic under their seeds, and the
distribution of the first two generated tokens over 240 seeds within
JAX's total-variation bar (0.25) of JAX's speculative engine and of the
port's plain sampler (the random streams differ by design, the
distributions must not).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.sampling import SamplingParams as JaxSamplingParams
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.inference.speculative import SpeculativeConfig as JaxSpeculativeConfig
from deepspeed_tpu.inference.speculative import layer_skip_draft as jax_layer_skip_draft
from deepspeed_tpu.inference.speculative import perturbed_draft as jax_perturbed_draft
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.inference import (Request, SamplingParams, SpeculativeConfig,
                                           layer_skip_draft, perturbed_draft)
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax

SERVE = {"b_slots": 3, "page_size": 8, "max_model_len": 64}
TV_BAR = 0.25   # the JAX package's sampled-distribution bar (test_kv_quant)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these tiny shapes: a pool of threads costs
    more than the ops when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(3))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    tmodel = CausalLM("tiny", dtype=torch.float32, attn_impl="xla")
    teng = deepspeed_tpu_torch.init_inference(
        tmodel, config={"dtype": "float32"}, device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    jdraft, jdparams = jax_perturbed_draft(jmodel, jparams, scale=0.05, seed=1)
    tdparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jdparams), "cpu")
    return {"jeng": jeng, "teng": teng,
            "jspec": JaxSpeculativeConfig(jdraft, jdparams, k=3),
            "tspec": SpeculativeConfig(CausalLM(tmodel.config, attn_impl="xla"),
                                       tdparams, k=3)}


def _stream(n, seed, cls=Request, new=(8, 12), eos=None):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, input_ids=rng.integers(1, 250, int(rng.integers(3, 14))
                                              ).astype(np.int32),
                max_new_tokens=int(rng.choice(new)), eos_token_id=eos)
            for i in range(n)]


def _by_rid(results):
    return {r.rid: r for r in results}


def test_validate_and_layer_skip_match_jax(setup):
    jeng, teng = setup["jeng"], setup["teng"]
    tm, jm = teng.model, jeng.model
    for kw, match in (({"k": 0}, "k="), ({}, "vocab")):
        draft = tm if "k" in kw else CausalLM("tiny", vocab_size=128)
        jdraft = jm if "k" in kw else JaxCausalLM("tiny", vocab_size=128)
        with pytest.raises(ValueError, match=match):
            SpeculativeConfig(draft, None, **kw).validate(tm, 64)
        with pytest.raises(ValueError, match=match):
            JaxSpeculativeConfig(jdraft, None, **kw).validate(jm, 64)
    short = CausalLM("tiny", max_seq_len=32)
    with pytest.raises(ValueError, match="max_seq_len"):
        SpeculativeConfig(short, None).validate(tm, 64)
    with pytest.raises(ValueError, match="num_layers"):
        layer_skip_draft(tm, teng.params, tm.config.num_layers)
    dm, dp = layer_skip_draft(tm, teng.params, 1)
    jdm, jdp = jax_layer_skip_draft(jm, jeng.params, 1)
    assert dm.config.num_layers == jdm.config.num_layers == 1
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jdp), "cpu")
    for k in want["layers"]:
        assert torch.equal(dp["layers"][k], want["layers"][k]), k
    assert dp["layers"]["wq"].data_ptr() == teng.params["layers"]["wq"].data_ptr()
    pm, pp = perturbed_draft(tm, teng.params, scale=1e-3)
    assert pm.config == tm.config
    d = (pp["layers"]["wq"] - teng.params["layers"]["wq"]).abs().max()
    assert 0 < d < 1e-2


def test_greedy_speculative_token_exact_with_jax_acceptance(setup):
    """Greedy speculative decoding equals plain greedy decoding; on the same
    draft the port accepts what JAX accepts: the same emitted and drafted
    tokens over the same verify ticks, the same decode ticks per request."""
    teng, jeng = setup["teng"], setup["jeng"]
    plain = _by_rid(teng.serving(**SERVE).run(_stream(6, seed=41)))
    serve = teng.serving(speculative=setup["tspec"], **SERVE)
    ours = _by_rid(serve.run(_stream(6, seed=41)))
    jserve = jeng.serving(speculative=setup["jspec"], **SERVE)
    theirs = _by_rid(jserve.run(_stream(6, seed=41, cls=JaxRequest)))
    for rid, r in ours.items():
        np.testing.assert_array_equal(r.output_ids, plain[rid].output_ids)
        np.testing.assert_array_equal(r.output_ids, theirs[rid].output_ids)
        assert r.decode_ticks == theirs[rid].decode_ticks
    h, jh = serve.health(), jserve.health()
    for key in ("speculative_k", "spec_verify_slot_ticks_total",
                "spec_emitted_tokens_total", "spec_drafted_tokens_total",
                "spec_mean_accepted_len"):
        assert h[key] == jh[key], (key, h[key], jh[key])
    assert 1.0 < h["spec_mean_accepted_len"] <= 3
    assert serve.page_accounting()["balanced"]
    inv = serve.program_inventory()
    assert inv["speculative"]["draft_decode"] == inv["speculative"]["verify"] == 1
    assert inv["captures"] == 0      # every step eager on the CPU


def test_weight_swap_is_local_to_the_server(setup):
    """``update_params`` with a layer-skip draft, whose layers are views of
    the InferenceEngine's: the first swap moves the target and the draft
    onto the server's own copies (the engine's tensors keep the base
    weights), the speculative stream is then token-exact with plain decoding
    over the new weights, and a second swap copies in place."""
    teng = setup["teng"]
    base = {k: v.clone() for k, v in teng.params["layers"].items()}
    dm, dp = layer_skip_draft(teng.model, teng.params, 1)
    serve = teng.serving(speculative=SpeculativeConfig(dm, dp, k=3), **SERVE)
    _, new = perturbed_draft(teng.model, teng.params, scale=0.05, seed=2)
    serve.update_params(new, draft_params=layer_skip_draft(teng.model, new, 1)[1])
    assert serve._exec.owns_params and serve._spec.owns_draft
    for k, v in base.items():
        assert torch.equal(teng.params["layers"][k], v), k
    ref = deepspeed_tpu_torch.init_inference(teng.model, config={"dtype": "float32"},
                                             device="cpu", params=new)
    want = _by_rid(ref.serving(**SERVE).run(_stream(4, seed=47)))
    got = _by_rid(serve.run(_stream(4, seed=47)))
    for rid, r in got.items():
        np.testing.assert_array_equal(r.output_ids, want[rid].output_ids)
    assert serve.health()["spec_mean_accepted_len"] > 1.0
    ptr = serve.params["layers"]["wq"].data_ptr()
    serve.update_params(teng.params)
    assert serve.params["layers"]["wq"].data_ptr() == ptr and serve.weight_epoch == 2
    plain = _by_rid(teng.serving(**SERVE).run(_stream(4, seed=48)))
    for rid, r in _by_rid(serve.run(_stream(4, seed=48))).items():
        np.testing.assert_array_equal(r.output_ids, plain[rid].output_ids)


def test_verify_block_cut_by_eos_and_budget(setup):
    teng = setup["teng"]
    serve = teng.serving(speculative=setup["tspec"], **SERVE)
    probe = _stream(1, seed=44, new=(8,))[0]
    base = teng.generate(probe.input_ids[None], max_new_tokens=8).numpy()[0]
    eos = int(base[len(probe.input_ids) + 2])
    (res,) = serve.run([Request(rid="se", input_ids=probe.input_ids,
                                max_new_tokens=8, eos_token_id=eos)])
    assert res.finish_reason == "eos"
    np.testing.assert_array_equal(res.output_ids,
                                  base[len(probe.input_ids):][:len(res.output_ids)])
    (r2,) = serve.run([Request(rid="sb", input_ids=probe.input_ids, max_new_tokens=2)])
    assert r2.finish_reason == "length" and len(r2.output_ids) == 2
    assert serve.page_accounting()["balanced"]


def test_int8_draft_pool(setup):
    """With ``kv_dtype="int8"`` both pools are int8, and greedy speculative
    decoding equals the plain int8 engine and JAX's int8 speculative
    engine."""
    teng, jeng = setup["teng"], setup["jeng"]
    plain = _by_rid(teng.serving(kv_dtype="int8", **SERVE).run(_stream(5, seed=7)))
    serve = teng.serving(speculative=setup["tspec"], kv_dtype="int8", **SERVE)
    assert serve._spec.dpools[0].dtype == torch.int8 and len(serve._spec.dpools) == 4
    ours = _by_rid(serve.run(_stream(5, seed=7)))
    theirs = _by_rid(jeng.serving(speculative=setup["jspec"], kv_dtype="int8", **SERVE)
                     .run(_stream(5, seed=7, cls=JaxRequest)))
    for rid, r in ours.items():
        np.testing.assert_array_equal(r.output_ids, plain[rid].output_ids)
        np.testing.assert_array_equal(r.output_ids, theirs[rid].output_ids)
    h = serve.health()
    assert h["draft_pool_bytes_per_device"] == h["kv_pool_bytes_per_device"]


def _pairs(results):
    hist = {}
    for r in results:
        key = tuple(int(t) for t in r.output_ids[:2])
        hist[key] = hist.get(key, 0) + 1
    return hist


def _tv(a, b):
    na, nb = sum(a.values()), sum(b.values())
    return 0.5 * sum(abs(a.get(k, 0) / na - b.get(k, 0) / nb) for k in set(a) | set(b))


def test_sampled_streams_deterministic_and_in_distribution(setup):
    """One prompt under 240 seeds (top-k 3, a one-layer draft that gets
    rejected often): the port's speculative streams repeat under their
    seeds, and the histogram of (token 1, token 2), token 2 the first that
    speculation emits, is within TV_BAR of JAX's speculative engine and of
    the port's plain sampler."""
    teng, jeng = setup["teng"], setup["jeng"]
    prompt = np.arange(3, 12, dtype=np.int32)
    n = 240

    def reqs(cls, sp_cls):
        return [cls(rid=i, input_ids=prompt, max_new_tokens=3,
                    sampling=sp_cls(temperature=1.0, top_k=3, seed=1000 + i))
                for i in range(n)]

    kw = {"b_slots": 4, "page_size": 8, "max_model_len": 32}
    dm, dp = layer_skip_draft(teng.model, teng.params, 1)
    spec = SpeculativeConfig(dm, dp, k=2)
    serve = teng.serving(speculative=spec, **kw)
    a = serve.run(reqs(Request, SamplingParams))
    b = teng.serving(speculative=spec, **kw).run(reqs(Request, SamplingParams))
    by_b = _by_rid(b)
    for r in a:
        np.testing.assert_array_equal(r.output_ids, by_b[r.rid].output_ids)
    assert serve.health()["spec_mean_accepted_len"] < 2   # rejections happen
    jdm, jdp = jax_layer_skip_draft(jeng.model, jeng.params, 1)
    jres = jeng.serving(speculative=JaxSpeculativeConfig(jdm, jdp, k=2), **kw).run(
        reqs(JaxRequest, JaxSamplingParams))
    plain = teng.serving(**kw).run(reqs(Request, SamplingParams))
    ours = _pairs(a)
    assert len(ours) > 3
    assert _tv(ours, _pairs(jres)) <= TV_BAR
    assert _tv(ours, _pairs(plain)) <= TV_BAR
