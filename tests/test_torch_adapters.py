"""Multi-tenant adapter serving of the port against the JAX package's, on
the CPU.

Same numpy weights and LoRA factors, fp32: ``adapter_salt`` equal to JAX's
(crc32, process-independent), the registry's rank-padded factors equal to
JAX's, a mixed stream of the base model and three tenants (ranks 4, 8, 12
over both rank buckets) token-exact against JAX's engine and against the
port's ``generate`` over each tenant's fused weights, tenant prefix
isolation (no cross-tenant hit or COW, a same-tenant hit), ``fuse_adapter``
serving the tenant's stream token-exactly with exclusive admission and
``fuse_adapter(None)`` restoring the base weights bit for bit, the fused
weights local to their server (a second server over the same engine and
the engine's ``generate`` stay token-exact with JAX's base engine), the
refusals (``UnknownAdapter``, no registry, bad registrations), and the
serving extras together (int8 pages, a host tier, speculative decoding and
adapters in one engine, then a fused tenant) on two gloo ranks of a serving
mesh at tp=2: tokens equal to the same program at tp=1, the int8 scale
planes bit-equal across the ranks (the row amax is reduced over the model
axis) and within 1e-5 of tp=1's, the tier's and the draft's movements equal
to tp=1's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from deepspeed_tpu.inference.adapters import adapter_salt as jax_adapter_salt
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.runtime.lora import LoRAConfig as JaxLoRAConfig
from deepspeed_tpu_torch.inference import (AdapterRegistry, Request, SamplingParams,
                                           UnknownAdapter)
from deepspeed_tpu_torch.inference.adapters import adapter_salt
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.lora import LoRAConfig
from tests._torch_ranks import prog_serve_extras, run_ranks

SERVE = {"b_slots": 4, "page_size": 8, "max_model_len": 64}
PROMPT = np.arange(5, 14, dtype=np.int32)
TENANTS = (("acme", 4), ("globex", 8), ("initech", 12))


def _lora(params, rank, seed):
    """Non-zero A and B (a fresh LoRA init has B = 0: parity would be
    vacuous)."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in ("wq", "wk", "wv", "wo"):
        L, d_in, d_out = (int(s) for s in np.shape(params["layers"][t]))
        out[t] = {"A": (rng.standard_normal((L, d_in, rank)) / np.sqrt(rank)
                        ).astype(np.float32),
                  "B": (rng.standard_normal((L, rank, d_out)) * 0.05).astype(np.float32)}
    return out


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
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    teng = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32, attn_impl="xla"),
        config={"dtype": "float32"}, params=params_from_jax(np_params, "cpu"),
        device="cpu")
    jreg, treg = JaxRegistry(jparams["layers"]), AdapterRegistry(teng.params["layers"])
    for i, (aid, rank) in enumerate(TENANTS):
        lora = _lora(np_params, rank, seed=40 + i)
        jreg.register(aid, lora, JaxLoRAConfig(rank=rank, alpha=2.0 * rank))
        treg.register(aid, lora, LoRAConfig(rank=rank, alpha=2.0 * rank))
    return jeng, jreg, teng, treg


def _mixed(cls, tag="m", sampled=False):
    reqs = []
    rng = np.random.default_rng(5)
    for i, aid in enumerate([None] + [t for t, _ in TENANTS]):
        for j in range(2):
            ids = PROMPT.copy() if j == 0 else rng.integers(1, 250, 11).astype(np.int32)
            kw = {}
            if sampled and j == 1:
                kw["sampling"] = SamplingParams(temperature=0.8, top_k=12, seed=7 + i)
            reqs.append(cls(rid=f"{tag}{i}{j}", input_ids=ids, max_new_tokens=6,
                            adapter_id=aid, **kw))
    return reqs


def test_adapter_salt_and_lora_config_match_jax():
    for aid in ("acme", "tenant-β", "x" * 300, "0"):
        assert adapter_salt(aid) == jax_adapter_salt(aid) != 0
    assert adapter_salt(None) == jax_adapter_salt(None) == 0
    assert LoRAConfig(rank=4, alpha=8).scaling == JaxLoRAConfig(rank=4, alpha=8).scaling
    for bad in ({"rank": 0}, {"alpha": 0.0}, {"targets": ()},
                {"targets": ("wq", "wq")}):
        with pytest.raises(ValueError):
            LoRAConfig(**bad).validate()
        with pytest.raises(ValueError):
            JaxLoRAConfig(**bad).validate()


def test_registry_pads_like_jax(setup):
    jeng, jreg, teng, treg = setup
    assert treg.loaded() == jreg.loaded() and treg.nbytes() == jreg.nbytes()
    for aid, rank in TENANTS:
        ta, ja = treg.resolve(aid), jreg.resolve(aid)
        assert (ta.bucket, ta.scale, ta.salt) == (ja.bucket, ja.scale, ja.salt)
        for t in ta.factors:
            for n in ("A", "B"):
                np.testing.assert_array_equal(ta.factors[t][n], ja.factors[t][n])
    stacks, jstacks = treg.make_slot_stacks(4), jreg.make_slot_stacks(4)
    treg.write_slot(stacks, 2, treg.resolve("initech"))
    jreg.write_slot(jstacks, 2, jreg.resolve("initech"))
    np.testing.assert_array_equal(stacks["scale"], jstacks["scale"])
    for t in stacks["factors"]:
        np.testing.assert_array_equal(stacks["factors"][t]["A"], jstacks["factors"][t]["A"])


def test_mixed_tenant_stream_token_exact(setup):
    """Base + three tenants through one engine: greedy streams equal JAX's
    engine and the port's generate over each tenant's fused weights;
    sampled lanes equal the port's fused generate (counter-based)."""
    jeng, jreg, teng, treg = setup
    serve = teng.serving(adapters=treg, **SERVE)
    ours = {r.rid: r for r in serve.run(_mixed(Request, sampled=True))}
    theirs = {r.rid: np.asarray(r.output_ids)
              for r in jeng.serving(adapters=jreg, **SERVE).run(_mixed(JaxRequest))}
    fused = {aid: deepspeed_tpu_torch.init_inference(
        teng.model, config={"dtype": "float32"}, device="cpu",
        params=treg.fuse(teng.params, aid)) for aid, _ in TENANTS}
    fused[None] = teng
    for req in _mixed(Request, sampled=True):
        got = ours[req.rid]
        assert got.adapter_id == req.adapter_id
        want = fused[req.adapter_id].generate(
            req.input_ids[None], max_new_tokens=6,
            sampling=req.sampling or SamplingParams()).numpy()[0, len(req.input_ids):]
        np.testing.assert_array_equal(got.output_ids, want)
        if req.sampling is None:
            np.testing.assert_array_equal(got.output_ids, theirs[req.rid])
    assert not np.array_equal(ours["m10"].output_ids, ours["m00"].output_ids)
    stats = serve.adapter_stats()
    assert set(stats) == set(treg.loaded())
    assert all(s["admissions"] == 2 and s["tokens"] == 12 for s in stats.values())
    h = serve.health()
    assert h["adapters_loaded"] == treg.loaded() and h["adapter_admissions_total"] == 6
    assert h["adapter_bytes"] == treg.nbytes() and h["fused_adapter_id"] is None
    assert serve.page_accounting()["balanced"]
    assert not serve._exec.adapter_operand()["scale"].any()   # slots cleared


def test_prefix_isolation_across_tenants(setup):
    _, _, teng, treg = setup
    serve = teng.serving(adapters=treg, **SERVE)
    prompt = np.random.default_rng(123).integers(1, 250, 28).astype(np.int32)

    def one(tag, aid):
        serve.run([Request(rid=f"iso{tag}", input_ids=prompt.copy(),
                           max_new_tokens=3, adapter_id=aid)])
        h = serve.health()
        return h["prefix_hits_total"], h["cow_copies_total"]

    one("pub", "acme")
    one("other", "globex")
    base = one("base", None)
    same = one("again", "acme")
    assert base == (0, 0) and same[0] == 1


def test_fuse_adapter_serves_per_slot_tokens_and_restores_base(setup):
    _, _, teng, treg = setup
    serve = teng.serving(adapters=treg, **SERVE)
    reqs = [Request(rid=i, input_ids=r.input_ids, max_new_tokens=6,
                    adapter_id="globex", sampling=r.sampling)
            for i, r in enumerate(_mixed(Request, sampled=True)[4:6])]
    per_slot = {r.rid: r.output_ids for r in serve.run(list(reqs))}
    base = {k: v.clone() for k, v in teng.params["layers"].items()}
    stats = serve.fuse_adapter("globex")
    assert serve.weight_epoch == 1 and stats["fused_adapter_id"] == "globex"
    assert not torch.equal(serve.params["layers"]["wq"], base["wq"])
    for k, v in base.items():   # the fused weights are the server's alone
        assert torch.equal(teng.params["layers"][k], v), k
    for bad in (None, "acme"):
        with pytest.raises(ValueError, match="FUSED"):
            serve.submit(Request(rid="x", input_ids=PROMPT.copy(), max_new_tokens=2,
                                 adapter_id=bad))
    fused = {r.rid: r.output_ids for r in serve.run(
        [Request(rid=10 + r.rid, input_ids=r.input_ids, max_new_tokens=6,
                 adapter_id="globex", sampling=r.sampling) for r in reqs])}
    for rid, toks in per_slot.items():
        np.testing.assert_array_equal(fused[10 + rid], toks)
    serve.fuse_adapter(None)
    assert serve.weight_epoch == 2 and serve.fused_adapter_id is None
    for k, v in base.items():
        assert torch.equal(serve.params["layers"][k], v), k
        assert torch.equal(teng.params["layers"][k], v), k
    again = serve.run([Request(rid=20 + r.rid, input_ids=r.input_ids, max_new_tokens=6,
                               adapter_id="globex", sampling=r.sampling) for r in reqs])
    for r in again:
        np.testing.assert_array_equal(r.output_ids, per_slot[r.rid - 20])


def test_fuse_adapter_is_local_to_its_server(setup):
    """Two servers over one InferenceEngine: fusing a tenant in one leaves
    the other server (its prefix cache warmed before the fuse) and the
    engine's generate on the base weights, token-exact with JAX's base
    engine, as JAX's immutable trees make it; the fused server serves the
    tenant's fused weights."""
    jeng, _, teng, treg = setup
    fused, other = (teng.serving(adapters=treg, **SERVE) for _ in range(2))
    prompts = [PROMPT, np.random.default_rng(9).integers(1, 250, 19).astype(np.int32)]

    def reqs(cls, tag, aid=None):
        return [cls(rid=f"{tag}{i}", input_ids=ids.copy(), max_new_tokens=6,
                    adapter_id=aid) for i, ids in enumerate(prompts)]

    other.run(reqs(Request, "warm"))
    fused.fuse_adapter("acme")
    base = {r.rid[1:]: np.asarray(r.output_ids)
            for r in jeng.serving(**SERVE).run(reqs(JaxRequest, "j"))}
    got = other.run(reqs(Request, "o"))
    assert other.health()["prefix_hits_total"] >= len(prompts)
    for r in got:
        np.testing.assert_array_equal(r.output_ids, base[r.rid[1:]])
    for i, ids in enumerate(prompts):
        full = teng.generate(ids[None], max_new_tokens=6).numpy()[0]
        np.testing.assert_array_equal(full[len(ids):], base[str(i)])
    acme = deepspeed_tpu_torch.init_inference(
        teng.model, config={"dtype": "float32"}, device="cpu",
        params=treg.fuse(teng.params, "acme"))
    for r in fused.run(reqs(Request, "f", aid="acme")):
        ids = prompts[int(r.rid[1:])]
        want = acme.generate(ids[None], max_new_tokens=6).numpy()[0, len(ids):]
        np.testing.assert_array_equal(r.output_ids, want)
        assert not np.array_equal(r.output_ids, base[r.rid[1:]])
    assert other.weight_epoch == 0 and fused.weight_epoch == 1


def test_adapter_refusals(setup):
    _, _, teng, treg = setup
    serve = teng.serving(adapters=treg, **SERVE)
    misses = treg.resolve_miss_total
    with pytest.raises(UnknownAdapter):
        serve.submit(Request(rid="nope", input_ids=PROMPT.copy(), max_new_tokens=2,
                             adapter_id="nobody"))
    assert treg.resolve_miss_total == misses + 1
    with pytest.raises(UnknownAdapter):
        serve.fuse_adapter("nobody")
    plain = teng.serving(**SERVE)
    with pytest.raises(ValueError, match="no AdapterRegistry"):
        plain.submit(Request(rid="r", input_ids=PROMPT.copy(), max_new_tokens=2,
                             adapter_id="acme"))
    with pytest.raises(RuntimeError, match="AdapterRegistry"):
        plain.fuse_adapter("acme")
    lora = _lora({"layers": {k: v.numpy() for k, v in teng.params["layers"].items()}}, 4, 1)
    with pytest.raises(ValueError, match="already registered"):
        treg.register("acme", lora, LoRAConfig(rank=4, alpha=8))
    with pytest.raises(ValueError, match="rank bucket"):
        treg.register("big", _lora({"layers": {k: v.numpy() for k, v in
                                               teng.params["layers"].items()}}, 32, 1),
                      LoRAConfig(rank=32, alpha=8))
    with pytest.raises(ValueError, match="do not match"):
        treg.register("bad", lora, LoRAConfig(rank=8, alpha=8))


def test_extras_together_at_tp2_match_tp1(setup, tmp_path):
    """int8 + host tier + speculative + adapters in one engine at tp=2 over
    gloo: what a missing amax all-reduce (ranks storing different scales) or
    a ``wo`` delta summed on both ranks would break."""
    from deepspeed_tpu.inference.speculative import perturbed_draft as jax_perturbed

    jeng, _, teng, _ = setup
    params_np = jax.tree_util.tree_map(np.asarray, jeng.params)
    _, jdraft = jax_perturbed(jeng.model, jeng.params, scale=0.05, seed=1)
    draft_np = jax.tree_util.tree_map(np.asarray, jdraft)
    loras = {aid: (rank, _lora(params_np, rank, seed=40 + i))
             for i, (aid, rank) in enumerate(TENANTS[:2])}
    rng = np.random.default_rng(17)
    systems = [rng.integers(1, 250, 17).tolist() for _ in range(3)]
    stream = [{"rid": i, "ids": systems[i % 3] + rng.integers(1, 250, 3).tolist(),
               "max_new": 5, "adapter": (None, "acme", "globex")[i % 3]}
              for i in range(9)]
    kw = {"b_slots": 2, "page_size": 8, "max_model_len": 40, "num_pages": 12}
    args = dict(model="tiny", params_np=params_np, draft_np=draft_np, loras=loras,
                stream=stream, serve_kw=kw, fuse="acme")
    one = prog_serve_extras(tp=1, **args)
    ranks = run_ranks(2, "serve_extras", tmp_path, timeout=120, tp=2, **args)
    assert one["demotions_total"] > 0 and one["promotions_total"] > 0
    assert one["adapter_admissions_total"] > 0 and one["fused"]
    for rank in ranks:
        assert rank["balanced"] and rank["balanced_after_fuse"]
        for rid, toks in one["served"].items():
            np.testing.assert_array_equal(rank["served"][rid], toks)
        for rid, toks in one["fused"].items():
            np.testing.assert_array_equal(rank["fused"][rid], toks)
        for key in ("demotions_total", "promotions_total", "spec_emitted_tokens_total",
                    "spec_verify_slot_ticks_total", "prefix_hits_total"):
            assert rank[key] == one[key], key
        for key in ("k_scale", "v_scale", "draft_k_scale"):
            torch.testing.assert_close(rank[key], one[key], rtol=1e-5, atol=0)
    for key in ("k_scale", "v_scale", "draft_k_scale"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key
