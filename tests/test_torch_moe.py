"""The port's MoE (``deepspeed_tpu_torch/moe``, MoE layers of the transformer
family, expert parallelism) against the JAX package, on the CPU.

- **Gating and dispatch** (``top_k_gating``, ``moe_ffn``, ``moe_ffn_nodrop``)
  on the same numpy inputs: top-1 and top-2, capacity drops that keep the
  earlier tokens, the no-drop contract, adversarial routing, per-expert
  biases on the gelu path, jitter fed the same uniforms, the residual
  layer.  Both packages gate in fp32 (JAX casts the logits), so outputs
  agree at rtol/atol 2e-6 and the routing decisions exactly.
- **Whole models**: ``tiny-moe`` (capacity and no-drop) and ``tiny-prmoe``
  (a PR-MoE pyramid: a dense layer and a residual 4-expert layer) trained
  3 steps in fp64 against the single-device fp64 JAX engine at 5e-6 (the
  golden gate's tolerance: both compute the gates and the loss in fp32);
  ``forward_cached``/``forward_paged`` logits at 1e-5, greedy ``generate``
  and paged serving token-exact against JAX's engines in fp32.
- **Expert parallelism** over gloo ranks (``tests/_torch_ranks.py``):
  ep=2, ep=2 x tp=2 (expert-internal tensor parallelism), ZeRO 1 and 3 x
  ep=2 and ep=2 x dp=2 against the same fp64 JAX engine at 5e-6; each rank
  holds half the experts, ZeRO cuts them over 'data' only; ``init_inference``
  with ``moe.ep_size=2`` matches one process; a save at ep=2 loads at ep=1
  bit for bit and the other way round.
- **Conversion and loading**: PR-MoE per-layer lists both ways; a tiny
  in-process ``megatron_gpt_moe`` state dict loads bit-equal to the JAX
  loader's tree, and streamed from safetensors files equal to the dense
  load.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.moe import MoE as JaxMoE
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu_torch.inference import Request
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import (params_from_jax, params_to_numpy,
                                                pool_from_jax)
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

from ._torch_ranks import make_batches, megatron_moe_state_dict, run_ranks

torch.set_num_threads(1)

GATE_TOL = dict(rtol=2e-6, atol=2e-6)
TOL = dict(rtol=5e-6, atol=5e-6)
STEPS, TRAIN_BATCH, GAS, CLIP = 3, 8, 2, 0.05
DEADLINE = 90.0


# ---------------------------------------------------------------------------
# Gating and dispatch
# ---------------------------------------------------------------------------

def _experts(seed, D, F, E, act, bias=False, scale=0.2):
    r = np.random.default_rng(seed)
    p = {"w_down": r.standard_normal((E, F, D)) * scale}
    if act == "swiglu":
        p["w_gate"] = r.standard_normal((E, D, F)) * scale
        p["w_up"] = r.standard_normal((E, D, F)) * scale
    else:
        p["w_in"] = r.standard_normal((E, D, F)) * scale
        if bias:
            p["b_in"] = r.standard_normal((E, F)) * 0.5
            p["b_down"] = r.standard_normal((E, D)) * 0.5
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(fn_j, fn_t, x, router, p, jcfg, tcfg, **kw):
    yj, aj = fn_j(jnp.asarray(x), jnp.asarray(router),
                  {k: jnp.asarray(v) for k, v in p.items()}, jcfg, **kw)
    yt, at = fn_t(torch.from_numpy(x), torch.from_numpy(router),
                  {k: torch.from_numpy(v) for k, v in p.items()}, tcfg, **kw)
    return np.asarray(yj), yt.numpy(), float(aj), float(at)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("act,bias", [("swiglu", False), ("gelu", True)])
@pytest.mark.parametrize("deterministic", [True, False])
def test_moe_ffn_matches_jax(top_k, drop, act, bias, deterministic):
    """Capacity (factor 0.5: 8 slots an expert for 12 tokens an expert on
    average, so tokens drop) and no-drop dispatch, top-1 and top-2,
    swiglu and biased gelu experts, train and eval capacity."""
    D, F, E, B, S = 8, 16, 4, 2, 48
    r = np.random.default_rng(3)
    x = r.standard_normal((B, S, D)).astype(np.float32)
    router = (r.standard_normal((D, E)) * 0.5).astype(np.float32)
    p = _experts(4, D, F, E, act, bias)
    kw = dict(num_experts=E, top_k=top_k, drop_tokens=drop, capacity_factor=0.5,
              eval_capacity_factor=0.5, min_capacity=4)
    yj, yt, aj, at = _both(jmoe.moe_ffn, tmoe.moe_ffn, x, router, p,
                           jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw),
                           activation=act, deterministic=deterministic)
    np.testing.assert_allclose(yt, yj, **GATE_TOL)
    np.testing.assert_allclose(at, aj, **GATE_TOL)
    dropped_j = np.abs(yj).sum(-1) == 0
    np.testing.assert_array_equal(np.abs(yt).sum(-1) == 0, dropped_j)
    if drop and top_k == 1 and not bias:
        assert dropped_j.any()       # a dropped top-1 token is a zero row
    if not drop:
        assert not dropped_j.any()


@pytest.mark.parametrize("top_k", [1, 2])
def test_top_k_gating_matches_jax(top_k):
    """The dense (combine, dispatch, aux) of one group, with drops."""
    lg = np.random.default_rng(5).standard_normal((40, 4)).astype(np.float32)
    kw = dict(num_experts=4, top_k=top_k, capacity_factor=0.5, min_capacity=4)
    cj, dj, aj = jmoe.top_k_gating(jnp.asarray(lg), jmoe.MoEConfig(**kw), False)
    ct, dt, at = tmoe.top_k_gating(torch.from_numpy(lg), tmoe.MoEConfig(**kw), False)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **GATE_TOL)
    np.testing.assert_allclose(float(at), float(aj), **GATE_TOL)
    assert int(dt.sum()) < 40 * top_k    # drops happened


def test_gating_contracts():
    """The JAX tests' contracts: capacity drops keep the first 8 of 64
    tokens all routed to one expert; the no-drop contract (C = T) keeps
    all 64; top-1 keeps the raw gate probability; top-2 weights sum to 1."""
    lg = torch.stack([torch.ones(64), -torch.ones(64)], dim=1)
    cfg = tmoe.MoEConfig(num_experts=2, top_k=1, capacity_factor=0.25, min_capacity=8)
    _, dispatch, _ = tmoe.top_k_gating(lg, cfg, deterministic=False)
    assert int(dispatch.sum()) == 8
    assert dispatch[:8, 0].any(-1).all() and not dispatch[8:].any()
    nd = dataclasses.replace(cfg, drop_tokens=False)
    _, dispatch, _ = tmoe.top_k_gating(lg, nd, deterministic=False)
    assert int(dispatch.sum()) == 64 and dispatch.shape[2] >= 64
    lg = torch.randn(16, 4, generator=torch.Generator().manual_seed(2))
    combine, _, _ = tmoe.top_k_gating(
        lg, tmoe.MoEConfig(num_experts=4, top_k=1, capacity_factor=4.0), False)
    torch.testing.assert_close(combine.sum((1, 2)), torch.softmax(lg, -1).max(-1).values)
    combine, _, _ = tmoe.top_k_gating(
        lg, tmoe.MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0), False)
    torch.testing.assert_close(combine.sum((1, 2)), torch.ones(16))


def test_no_drop_survives_adversarial_routing():
    """All tokens to one expert: the capacity path at cf=0.25 drops at
    least 48 of 64 rows (zero rows, as in JAX), the no-drop path none; and
    both match JAX's."""
    D, F, E = 8, 16, 4
    p = _experts(2, D, F, E, "swiglu", scale=0.1)
    router = (np.random.default_rng(2).standard_normal((D, E)) * 0.1).astype(np.float32)
    x = np.broadcast_to(np.random.default_rng(3).standard_normal(D).astype(np.float32),
                        (1, 64, D)).copy()
    nd = dict(num_experts=E, top_k=1, drop_tokens=False)
    tight = dict(num_experts=E, top_k=1, capacity_factor=0.25,
                 eval_capacity_factor=0.25, min_capacity=8)
    for kw in (nd, tight):
        yj, yt, _, _ = _both(jmoe.moe_ffn, tmoe.moe_ffn, x, router, p,
                             jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw))
        np.testing.assert_allclose(yt, yj, **GATE_TOL)
        rows = np.abs(yt[0]).sum(-1)
        if kw is nd:
            assert (rows > 0).all()
        else:
            assert (rows == 0).sum() >= 48


def test_nodrop_static_path_equals_segments():
    """The no-drop path's two forms (every expert over every row, static
    shapes; sorted segments with one host sync) compute the same values
    and gradients (fp64)."""
    D, F, E = 8, 16, 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 3, D, generator=g, dtype=torch.float64, requires_grad=True)
    router = torch.randn(D, E, generator=g, dtype=torch.float64, requires_grad=True)
    p = {k: torch.from_numpy(v).double().requires_grad_()
         for k, v in _experts(1, D, F, E, "gelu", bias=True).items()}
    cfg = tmoe.MoEConfig(num_experts=E, top_k=2, drop_tokens=False)
    assert tmoe._static_nodrop(3, cfg) and not tmoe._static_nodrop(5, cfg)
    y_static, _ = tmoe.moe_ffn(x, router, p, cfg, activation="gelu")
    leaves = [x, router, *p.values()]
    g_static = torch.autograd.grad(y_static.square().sum(), leaves)
    x5 = torch.cat([x, x[:, :2]], 1)        # 5 rows: the segments path
    y_seg, _ = tmoe.moe_ffn(x5, router, p, cfg, activation="gelu")
    torch.testing.assert_close(y_seg[:, :3], y_static, rtol=1e-12, atol=1e-12)
    g_seg = torch.autograd.grad(y_seg[:, :3].square().sum(), leaves)
    for a, b in zip(g_static, g_seg):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_jitter_fed_the_same_uniforms_matches_jax():
    """``noisy_gate_policy='jitter'``: JAX draws its multipliers from a key;
    the port takes the same uniforms as a tensor (or draws its own from a
    generator, which changes the routing input)."""
    D, F, E, B, S = 8, 16, 4, 2, 16
    r = np.random.default_rng(6)
    x = r.standard_normal((B, S, D)).astype(np.float32)
    router = (r.standard_normal((D, E)) * 0.5).astype(np.float32)
    p = _experts(7, D, F, E, "swiglu")
    kw = dict(num_experts=E, top_k=2, noisy_gate_policy="jitter", capacity_factor=1.0)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, 1.0 - 1e-2, 1.0 + 1e-2))
    yj, aj = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(router),
                          {k: jnp.asarray(v) for k, v in p.items()},
                          jmoe.MoEConfig(**kw), deterministic=False, rng=key)
    yt, at = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(router),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          tmoe.MoEConfig(**kw), deterministic=False,
                          rng=torch.from_numpy(noise))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **GATE_TOL)
    np.testing.assert_allclose(float(at), float(aj), **GATE_TOL)
    plain, _ = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(router),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            tmoe.MoEConfig(**kw), deterministic=True)
    assert not torch.allclose(plain, yt)


@pytest.mark.parametrize("residual", [False, True])
def test_moe_layer_matches_jax(residual):
    """``moe.MoE`` (an ``nn.Module``) on JAX ``MoE.init``'s weights: the
    same output and aux; the residual branch mixes in (and the coefficient
    gets a gradient); ``param_specs`` equal JAX's."""
    jl = JaxMoE(hidden_size=16, intermediate_size=32, num_experts=4, k=2,
                use_residual=residual)
    tl = MoE(hidden_size=16, intermediate_size=32, num_experts=4, k=2,
             use_residual=residual)
    jp = jl.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((2, 8, 16)).astype(np.float32)
    yj, aj = jl.apply(jp, jnp.asarray(x), deterministic=False)
    tp = {k: torch.from_numpy(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    yt, at = tl.apply(tp, torch.from_numpy(x), deterministic=False)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **GATE_TOL)
    np.testing.assert_allclose(float(at), float(aj), **GATE_TOL)
    assert {k: tuple(v) for k, v in jl.param_specs().items()} == tl.param_specs
    assert sorted(tl.init(torch.Generator().manual_seed(0))) == sorted(jp)
    if residual:
        (g,) = torch.autograd.grad(yt.sum(), [tp["coefficient"]])
        assert float(g.abs().sum()) > 0
        plain, _ = MoE(hidden_size=16, intermediate_size=32, num_experts=4,
                       k=2).apply(tp, torch.from_numpy(x), deterministic=False)
        assert not torch.allclose(plain, yt)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _jax_tree(name, seed=0, **kw):
    return jax.tree_util.tree_map(np.asarray, jtf.init_params(
        jtf.get_config(name, **kw), jax.random.PRNGKey(seed)))


def _config(stage=0, **extra):
    cfg = {"train_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": GAS,
           "gradient_clipping": CLIP,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.1,
                                    "mu_dtype": "float64", "nu_dtype": "float64"}},
           "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0},
           "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


def _flat_np(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_engine_run(name, params_np, batches, **kw):
    """The single-device fp64 JAX engine's losses and final weights."""
    jax.config.update("jax_enable_x64", True)
    try:
        jmesh.reset_mesh()
        mesh = jmesh.initialize_mesh(jmesh.MeshLayout(dp=1), devices=jax.devices()[:1])
        model = JaxCausalLM(jtf.get_config(name, dtype=jnp.float64, **kw))
        eng, *_ = deepspeed_tpu.initialize(
            model=model, config=_config(),
            params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
        losses = [float(eng.train_batch(batch={k: v.astype(np.int32) for k, v in b.items()}))
                  for b in batches]
        params = _flat_np(eng.get_params())
    finally:
        jax.config.update("jax_enable_x64", False)
        jmesh.reset_mesh()
    return {"losses": losses, "params": params}


@pytest.fixture(scope="module")
def batches():
    return make_batches(STEPS, TRAIN_BATCH)


CASES = {"tiny-moe": {}, "tiny-moe-nodrop": {"moe_drop_tokens": False},
         "tiny-prmoe": {}}


@pytest.fixture(scope="module")
def jax_runs(batches):
    out = {}
    for case, kw in CASES.items():
        name = case.replace("-nodrop", "")
        params_np = _jax_tree(name, **kw)
        out[case] = (params_np, _jax_engine_run(name, params_np, batches, **kw))
    return out


def _port_run(name, params_np, batches, **kw):
    model = CausalLM(name, dtype=torch.float64, **kw)
    params = params_from_jax(params_np, device="cpu")
    from deepspeed_tpu_torch.utils.tree import tree_map

    engine, *_ = ds.initialize(model=model, config=_config(), device="cpu",
                               params=tree_map(lambda x: x.double(), params))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    return losses, {p: x.numpy() for p, x in tree_flatten_with_path(
        engine.get_params(fp32=True))}


@pytest.mark.parametrize("case", list(CASES))
def test_training_trajectory_matches_jax(case, jax_runs, batches):
    """3 steps of gas 2 (AdamW, weight decay, clipping) in fp64: losses and
    final weights against the fp64 JAX engine at 5e-6; the loss carries
    the aux term (``moe_aux_loss_coef`` x aux)."""
    name = case.replace("-nodrop", "")
    params_np, ref = jax_runs[case]
    losses, params = _port_run(name, params_np, batches, **CASES[case])
    np.testing.assert_allclose(losses, ref["losses"], **TOL)
    assert sorted(params) == sorted(ref["params"])
    for k in params:
        np.testing.assert_allclose(params[k], ref["params"][k], err_msg=k, **TOL)


def test_loss_includes_the_aux_term():
    """``loss_fn`` = cross entropy + ``moe_aux_loss_coef`` x the layers'
    summed aux, as JAX's ``CausalLM._loss``; a zero coefficient leaves the
    cross entropy alone."""
    params_np = _jax_tree("tiny-moe")
    toks = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int32)
    jm = JaxCausalLM("tiny-moe", dtype=jnp.float32)
    want = float(jm.loss_fn(jax.tree_util.tree_map(jnp.asarray, params_np),
                            {"input_ids": jnp.asarray(toks)}, jax.random.PRNGKey(0)))
    tm = CausalLM("tiny-moe", dtype=torch.float32)
    p = params_from_jax(params_np, "cpu")
    got = float(tm.loss_fn(p, {"input_ids": torch.from_numpy(toks)}))
    np.testing.assert_allclose(got, want, rtol=2e-6)
    logits, aux = tm.apply_fn(p, torch.from_numpy(toks), deterministic=False,
                              return_aux=True)
    ce = float(ttf.cross_entropy_loss(logits, torch.from_numpy(
        np.concatenate([toks[:, 1:], np.full((2, 1), -100)], 1))))
    assert float(aux["moe_aux_loss"]) > 0
    np.testing.assert_allclose(got, ce + 0.01 * float(aux["moe_aux_loss"]), rtol=1e-6)


def _inference_pair(name, seed=3, **kw):
    jmodel = JaxCausalLM(name, dtype=jnp.float32, attn_impl="xla", **kw)
    jparams = jmodel.init_fn(jax.random.PRNGKey(seed))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    tmodel = CausalLM(name, dtype=torch.float32, attn_impl="xla", **kw)
    teng = ds.init_inference(tmodel, config={"dtype": "float32"}, device="cpu",
                             params=params_from_jax(jax.tree_util.tree_map(
                                 np.asarray, jparams), "cpu"))
    return jeng, teng


@pytest.mark.parametrize("name,kw", [("tiny-moe", {}),
                                     ("tiny-moe", {"moe_drop_tokens": False})])
def test_forward_cached_and_generate_match_jax(name, kw):
    """The KV-cached path (eval capacity): a ragged prefill and decode
    steps' logits at 1e-5, greedy ``generate`` token-exact."""
    jeng, teng = _inference_pair(name, **kw)
    rs = np.random.RandomState(2)
    prompts = rs.randint(1, 250, (3, 9)).astype(np.int32)
    want = np.asarray(jeng.generate(prompts, max_new_tokens=8))
    got = teng.generate(prompts, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    toks = rs.randint(1, 250, (8, 24)).astype(np.int32)   # JAX shards rows over 8
    np.testing.assert_allclose(teng.forward(torch.from_numpy(toks)).numpy(),
                               np.asarray(jeng.forward(jnp.asarray(toks))),
                               rtol=1e-5, atol=1e-5)
    jm, tm = jeng.model, teng.model
    jc = jm.init_cache(8, 32)
    tc = tm.init_cache(8, 32, device="cpu")
    pos = np.tile(np.arange(12, dtype=np.int32), (8, 1))
    mask = np.ones((8, 12), bool)
    mask[1, 9:] = False                 # a ragged row
    jl, jc = jm.apply_cached(jeng.params, jnp.asarray(toks[:, :12]), jc,
                             jnp.asarray(pos), jnp.asarray(mask))
    tl, tc = tm.apply_cached(teng.params, torch.from_numpy(toks[:, :12]), tc,
                             torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask], rtol=1e-5, atol=1e-5)
    for step in range(3):
        nxt = toks[:, 12 + step:13 + step]
        p = np.full((8, 1), 12 + step, np.int32)
        p[1] = 9 + step
        jl, jc = jm.apply_cached(jeng.params, jnp.asarray(nxt), jc, jnp.asarray(p),
                                 jnp.ones((8, 1), bool))
        tl, tc = tm.apply_cached(teng.params, torch.from_numpy(nxt), tc,
                                 torch.from_numpy(p), torch.ones((8, 1), dtype=torch.bool))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_prmoe_decode_paths_match_jax_forward():
    """A PR-MoE pyramid's cached and paged decode (JAX refuses both: its
    layer scan needs uniform stacks; the port loops over layers): greedy
    ``generate`` and served streams equal greedy decoding by JAX's full
    ``forward`` recomputed at every step (eval capacity; the first 16
    positions are one bucket, so capacity groups agree)."""
    jeng, teng = _inference_pair("tiny-prmoe")
    rs = np.random.RandomState(3)
    prompts = rs.randint(1, 250, (2, 6)).astype(np.int32)
    want = prompts.copy()
    for _ in range(6):
        toks = np.zeros((8, 16), np.int32)       # JAX shards rows over 8
        toks[:2, :want.shape[1]] = want
        logits = np.asarray(jeng.forward(jnp.asarray(toks)))
        want = np.concatenate([want, logits[:2, want.shape[1] - 1].argmax(-1)[:, None]], 1)
    got = teng.generate(prompts, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    sv = teng.serving(b_slots=2, page_size=8, max_model_len=32)
    for r in sv.run([Request(rid=i, input_ids=prompts[i], max_new_tokens=6)
                     for i in range(2)]):
        np.testing.assert_array_equal(r.output_ids, want[r.rid, 6:])
    assert sv.page_accounting()["balanced"]


@pytest.mark.parametrize("name,kw", [("tiny-moe", {}),
                                     ("tiny-moe", {"moe_drop_tokens": False})])
def test_forward_paged_and_serving_match_jax(name, kw):
    """The paged path: a bucketed prefill (capacity counted over the
    padded bucket, as JAX's) and a decode step over 3 slots, logits at
    1e-5; a mixed stream through ``serving().run`` token-exact against
    JAX's serving engine and the port's ``generate`` (the decode tick runs
    the no-drop path's static form: 3 slots x top-2 <= 2 rows an expert)."""
    jeng, teng = _inference_pair(name, **kw)
    jm, tm = jeng.model, teng.model
    P, ps, maxp = 12, 8, 4
    jcache = jm.init_paged_cache(P, ps)
    tcache = pool_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    japply = jax.jit(jm.apply_paged)   # jitted, as the JAX executor runs it
    table = np.zeros((3, maxp), np.int32)
    table[0, :2], table[1, :2], table[2, :2] = [3, 7], [5, 2], [9, 4]
    rs = np.random.RandomState(4)
    for slot, n in ((0, 11), (1, 13), (2, 5)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = rs.randint(1, 250, n)
        mask = np.arange(16)[None] < n
        jl, jcache = japply(jeng.params, jnp.asarray(toks), jcache,
                                    jnp.asarray(table[slot:slot + 1]),
                                    jnp.zeros(1, jnp.int32), jnp.asarray(mask))
        tl, tcache = tm.apply_paged(teng.params, torch.from_numpy(toks), tcache,
                                    torch.from_numpy(table[slot:slot + 1]),
                                    torch.zeros(1, dtype=torch.int32),
                                    torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy()[0, :n], np.asarray(jl)[0, :n],
                                   rtol=1e-5, atol=1e-5)
    last = rs.randint(1, 250, (3, 1)).astype(np.int32)
    lengths = np.array([11, 13, 5], np.int32)
    jl, _ = japply(jeng.params, jnp.asarray(last), jcache, jnp.asarray(table),
                           jnp.asarray(lengths), jnp.ones((3, 1), bool))
    tl, _ = tm.apply_paged(teng.params, torch.from_numpy(last), tcache,
                           torch.from_numpy(table), torch.from_numpy(lengths),
                           torch.ones((3, 1), dtype=torch.bool))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)

    from deepspeed_tpu.inference.serving import Request as JaxRequest

    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, input_ids=rng.integers(1, 250, int(rng.integers(3, 14))
                                                  ).astype(np.int32),
                    max_new_tokens=int(rng.choice((4, 6))))
            for i in range(6)]
    serve = {"b_slots": 3, "page_size": 8, "max_model_len": 64}
    ref = {r.rid: np.asarray(r.output_ids) for r in jeng.serving(**serve).run(
        [JaxRequest(rid=r.rid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens)
         for r in reqs])}
    sv = teng.serving(**serve)
    ours = sv.run(list(reqs))
    assert sv.page_accounting()["balanced"]
    for r in ours:
        np.testing.assert_array_equal(r.output_ids, ref[r.rid])
        req = reqs[r.rid]
        base = teng.generate(req.input_ids[None], max_new_tokens=req.max_new_tokens
                             ).numpy()[0, len(req.input_ids):]
        np.testing.assert_array_equal(r.output_ids, base)


# ---------------------------------------------------------------------------
# Expert parallelism over gloo ranks
# ---------------------------------------------------------------------------

EP_CASES = [
    ("ep2", 2, {"ep": 2}, 0, {}),
    ("ep2_stage1", 2, {"ep": 2}, 1, {}),
    ("ep2_stage3", 2, {"ep": 2}, 3, {}),
    ("ep2_nodrop", 2, {"ep": 2}, 0, {"moe_drop_tokens": False}),
    ("ep2_tp2", 4, {"ep": 2, "tp": 2}, 0, {}),
    ("ep2_dp2_stage3", 4, {"ep": 2, "dp": 2}, 3, {}),
    ("ep2_dp2_stage1", 4, {"ep": 2, "dp": 2}, 1, {}),
]


@pytest.fixture(scope="module")
def ep_spawn(tmp_path_factory, jax_runs, batches):
    """One spawn per world size, every case of that size in it."""
    tmp = tmp_path_factory.mktemp("ep")
    out = {}
    for world in (2, 4):
        cases = [c for c in EP_CASES if c[1] == world]
        res = run_ranks(world, "train", tmp, timeout=DEADLINE, cases=[
            {"config": _config(stage), "model": "tiny-moe", "mesh": mesh,
             "model_kw": kw, "params_np": jax_runs[
                 "tiny-moe-nodrop" if kw else "tiny-moe"][0]}
            for _, _, mesh, stage, kw in cases], params_np=None, batches=batches)
        for i, case in enumerate(cases):
            out[case[0]] = [r[i] for r in res]
    return out


@pytest.mark.parametrize("case", [c[0] for c in EP_CASES])
def test_expert_parallel_training_matches_jax(case, ep_spawn, jax_runs):
    """Every rank: losses and the gathered weights against the single-device
    fp64 JAX engine at 5e-6; each rank holds half the experts (and, at
    ZeRO-3, its 'data' piece of them: never cut over 'expert' again)."""
    _, world, mesh, stage, kw = next(c for c in EP_CASES if c[0] == case)
    ref = jax_runs["tiny-moe-nodrop" if kw else "tiny-moe"][1]
    for r in ep_spawn[case]:
        np.testing.assert_allclose(r["losses"], ref["losses"], **TOL)
        for k, v in r["masters"].items():
            np.testing.assert_allclose(v, ref["params"][k], err_msg=k, **TOL)
        shape = r["master_shapes"]["layers/w_gate"]
        assert shape[1] == 2                         # 4 experts over ep=2
        # ZeRO (stage >= 1: the masters) cuts an expert leaf over 'data' only
        dp = mesh.get("dp", 1) if stage >= 1 else 1
        assert int(np.prod(shape)) == 2 * 2 * 64 * (128 // mesh.get("tp", 1)) // dp


def test_expert_parallel_inference_matches_one_process(tmp_path):
    """``init_inference`` with ``moe.ep_size=2`` on 2 ranks: each holds 2
    of 4 experts; logits and greedy tokens equal the one-process engine's
    (capacity path: the buffers exchanged over 'expert')."""
    params_np = _jax_tree("tiny-moe", seed=3)
    rs = np.random.RandomState(5)
    tokens = rs.randint(1, 250, (2, 16)).astype(np.int64)
    prompts = rs.randint(1, 250, (2, 7)).astype(np.int64)
    res = run_ranks(2, "moe_infer", tmp_path, timeout=DEADLINE, model="tiny-moe",
                    params_np=params_np, ep=2, tokens=tokens, prompts=prompts, max_new=6)
    one = ds.init_inference(CausalLM("tiny-moe", dtype=torch.float32),
                            config={"dtype": "float32"}, device="cpu",
                            params=params_from_jax(params_np, "cpu"))
    want_logits = one.forward(torch.from_numpy(tokens)).numpy()
    want = one.generate(prompts, max_new_tokens=6).numpy()
    for r in res:
        assert r["local_shapes"]["layers/w_gate"] == (2, 2, 64, 128)
        np.testing.assert_allclose(r["logits"], want_logits, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["greedy"], want)


def test_expert_parallel_checkpoints_cross_layouts(tmp_path, batches):
    """ZeRO-1 at ep=2 saves; dp=2 and a one-device engine load the same
    whole masters bit for bit; a save at dp=2 resumes at ep=2 with the
    losses of the run that never stopped."""
    params_np = _jax_tree("tiny-moe")
    cfg = _config(1)
    more = make_batches(4, TRAIN_BATCH, seed=3)
    kw = dict(config=cfg, params_np=params_np, batches=more, model="tiny-moe",
              dtype="float64")
    saved = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                      ckpt_dir=str(tmp_path / "ep2"), mode="save", mesh={"ep": 2}, **kw)
    loaded = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                       ckpt_dir=str(tmp_path / "ep2"), mode="load", mesh={"dp": 2}, **kw)
    for a, b in zip(saved, loaded):
        for k in a["saved"]:
            np.testing.assert_array_equal(b["saved"][k], a["saved"][k])
    from deepspeed_tpu_torch.utils.tree import tree_map

    engine, *_ = ds.initialize(model=CausalLM("tiny-moe", dtype=torch.float64),
                               config={**cfg, "train_batch_size": 4}, device="cpu",
                               params=tree_map(lambda x: x.double(),
                                               params_from_jax(params_np, "cpu")))
    engine.load_checkpoint(str(tmp_path / "ep2"))
    one = {p: x.numpy() for p, x in tree_flatten_with_path(engine.get_params(fp32=True))}
    for k in one:
        np.testing.assert_array_equal(one[k], saved[0]["saved"][k])
    assert saved[0]["saved"]["layers/w_gate"].shape == (2, 4, 64, 128)
    back = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                     ckpt_dir=str(tmp_path / "dp2"), mode="save", mesh={"dp": 2}, **kw)
    resumed = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                        ckpt_dir=str(tmp_path / "dp2"), mode="resume", mesh={"ep": 2}, **kw)
    for k in back[0]["saved"]:
        np.testing.assert_array_equal(resumed[0]["saved"][k], back[0]["saved"][k])
    np.testing.assert_allclose(resumed[0]["losses"], back[0]["losses"][2:], rtol=1e-12)


def test_expert_axis_refusals():
    """A 'seq' axis with MoE layers is refused before any collective runs
    (groups are whole rows); paged serving keeps a mesh without experts."""
    from deepspeed_tpu_torch.runtime.engine import _has_moe

    assert _has_moe(ttf.get_config("tiny-prmoe")) and not _has_moe(ttf.get_config("tiny"))
    with pytest.raises(ValueError, match="num_experts tuple"):
        ttf.init_params(ttf.get_config("tiny-prmoe", num_experts=(1, 4, 4)),
                        torch.Generator(), device="meta")
    with pytest.raises(NotImplementedError, match="pipeline"):
        ttf.param_specs(ttf.get_config("tiny-prmoe", pipeline_stages=2))


# ---------------------------------------------------------------------------
# Conversion and loading
# ---------------------------------------------------------------------------

def test_prmoe_lists_convert_both_ways():
    """A PR-MoE pyramid's ``layers`` list of per-layer dicts (a dense layer
    and an MoE layer with the residual branch) converts to the port and
    back bit for bit; the port's own init has the same structure and
    shapes, and ``param_specs`` equals JAX's entry for entry."""
    ref = _jax_tree("tiny-prmoe")
    tree = params_from_jax(ref, "cpu")
    assert isinstance(tree["layers"], list) and "router" in tree["layers"][1]
    back = params_to_numpy(tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(CausalLM("tiny-prmoe").init_fn(torch.Generator(), device="cpu"))
    assert [a.shape for a in jax.tree_util.tree_leaves(own)] == \
        [a.shape for a in jax.tree_util.tree_leaves(ref)]
    jspecs = jtf.param_specs(jtf.get_config("tiny-prmoe"))
    tspecs = ttf.param_specs(ttf.get_config("tiny-prmoe"))
    for jl, tl in zip(jspecs["layers"], tspecs["layers"]):
        assert {k: tuple(v) for k, v in jl.items()} == tl
    js = jtf.param_specs(jtf.get_config("tiny-moe", mlp_bias=True, activation="gelu"))
    ts = ttf.param_specs(ttf.get_config("tiny-moe", mlp_bias=True, activation="gelu"))
    assert {k: tuple(v) for k, v in js["layers"].items()} == ts["layers"]
    assert ttf.get_config("tiny-prmoe").param_count == jtf.get_config("tiny-prmoe").param_count


def test_megatron_gpt_moe_loads_bit_equal_to_jax(tmp_path):
    """A tiny Megatron-DeepSpeed MoE state dict: the port's dense load is
    JAX's tree bit for bit; streamed from safetensors shards it equals the
    dense load; the loaded model's logits match JAX's at 1e-5."""
    from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint
    from deepspeed_tpu_torch.module_inject.sharded_load import (load_hf_checkpoint_sharded,
                                                                save_safetensors)

    cfg_dict, sd = megatron_moe_state_dict()
    jcfg, jparams = jax_load((cfg_dict, sd))
    cfg, params = load_hf_checkpoint((cfg_dict, {k: torch.from_numpy(v) for k, v in sd.items()}),
                                     device="cpu")
    ref = _flat_np(jax.tree_util.tree_map(np.asarray, jparams))
    dense = {p: x.numpy() for p, x in tree_flatten_with_path(params)}
    assert sorted(dense) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(dense[k], ref[k], err_msg=k)
    import json

    keys = sorted(sd)
    half = len(keys) // 2
    index = {}
    for i, part in enumerate((keys[:half], keys[half:])):
        fname = f"model-0000{i + 1}-of-00002.safetensors"
        save_safetensors({k: torch.from_numpy(sd[k]) for k in part}, str(tmp_path / fname))
        index.update({k: fname for k in part})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": index}))
    (tmp_path / "config.json").write_text(json.dumps(cfg_dict))
    _, streamed = load_hf_checkpoint_sharded(str(tmp_path), device="cpu")
    for p, x in tree_flatten_with_path(streamed):
        np.testing.assert_array_equal(x.numpy(), dense[p], err_msg=p)
    toks = np.random.RandomState(0).randint(0, 64, (2, 8)).astype(np.int32)
    want = np.asarray(jtf.forward(dataclasses.replace(jcfg, dtype=jnp.float32), jparams,
                                  jnp.asarray(toks)))
    got = ttf.forward(dataclasses.replace(cfg, dtype=torch.float32), params,
                      torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
