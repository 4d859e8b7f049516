"""The port's LoRA training (``runtime/lora.py``) and hybrid engine
(``runtime/hybrid_engine.py``) against the JAX package's.

- ``init_lora_params``: the shapes, B = 0, A's scale, JAX's errors;
- ``LoRAModel`` in the engine trains the adapters only: the base tree is
  never written, every adapter moves;
- ``fused`` (``base + A @ B * alpha / r``) equals JAX's ``apply_lora`` on
  the same factors;
- the LoRA trajectory (fp32 ``tiny``, AdamW, gas 2) from the same A (JAX's
  draw carried over by ``convert.lora_from_jax``) equals the JAX LoRA
  engine's: losses at rtol 1e-5; adapters at rtol/atol 1e-5 (0.2% of one
  step at lr 5e-3) but for at most 0.5% of a leaf's elements, which stay
  within atol 1e-4 (fp32 summation order, which Adam's normalisation
  carries into tiny-gradient elements: tests/test_torch_training.py's
  rule); the Adam moments within 1e-4 of each leaf's largest (the
  gradients' fp32 rounding);
- the hybrid engine's greedy tokens equal the JAX hybrid engine's in fp32
  before training and after each step (the fused view refreshed after
  ``train_batch``), and a fresh ``init_inference`` on ``fused(lora)``;
- ``eval()``/``train()`` are no-ops, ``generate`` needs the KV-cache
  contract, ``rollout_engine`` is not ported yet.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as mesh_mod
from deepspeed_tpu.runtime import lora as jlora
from deepspeed_tpu.runtime.hybrid_engine import DeepSpeedHybridEngine as JaxHybrid

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import (lora_from_jax, opt_state_to_numpy,
                                                params_from_jax, params_to_numpy)
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
from deepspeed_tpu_torch.runtime.lora import (LoRAConfig, LoRAModel, init_lora_params,
                                              lora_param_specs)
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

torch.set_num_threads(1)

S, RANK, ALPHA = 16, 4, 8.0
CFG = LoRAConfig(rank=RANK, alpha=ALPHA)
TRAIN = {"train_batch_size": 4, "gradient_accumulation_steps": 2, "seed": 2,
         "optimizer": {"type": "adamw", "params": {"lr": 5e-3, "weight_decay": 0.01}},
         "steps_per_print": 10 ** 9}


@pytest.fixture(scope="module")
def base_np():
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(9)))


@pytest.fixture(scope="module")
def lora_np(base_np):
    """JAX's adapter draw, with B perturbed so the fused tree differs."""
    tree = jlora.init_lora_params(base_np["layers"], CFG, jax.random.PRNGKey(3))
    rs = np.random.RandomState(4)
    return {k: {"A": np.asarray(v["A"]),
                "B": (rs.randn(*v["B"].shape) * 0.05).astype(np.float32)}
            for k, v in tree.items()}


def _batches(n, seed=5):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 256, (4, S)).astype(np.int32)} for _ in range(n)]


def test_init_shapes_and_errors(base_np):
    layers = params_from_jax(base_np, device="cpu")["layers"]
    lora = init_lora_params(layers, CFG, torch.Generator().manual_seed(0))
    assert sorted(lora) == sorted(CFG.targets)
    for k, ab in lora.items():
        L, d_in, d_out = layers[k].shape
        assert ab["A"].shape == (L, d_in, RANK) and ab["B"].shape == (L, RANK, d_out)
        assert ab["A"].dtype == ab["B"].dtype == torch.float32
        assert not ab["B"].any()
        assert abs(float(ab["A"].std()) - 1.0 / RANK) < 0.02
    assert lora_param_specs(CFG)["wq"] == {"A": (None, None, None), "B": (None, None, None)}
    for bad, exc in ((LoRAConfig(targets=("nope",)), ValueError),
                     (LoRAConfig(targets=("attn_norm_scale",)), NotImplementedError),
                     (LoRAConfig(rank=0), ValueError), (LoRAConfig(alpha=0.0), ValueError),
                     (LoRAConfig(targets=("wq", "wq")), ValueError)):
        with pytest.raises(exc) as ours:
            init_lora_params(layers, bad, torch.Generator())
        with pytest.raises(exc) as theirs:
            jlora.init_lora_params(base_np["layers"], bad, jax.random.PRNGKey(0))
        assert str(ours.value) == str(theirs.value)


def test_fused_matches_jax_apply_lora(base_np, lora_np):
    model = LoRAModel(CausalLM("tiny", dtype=torch.float32),
                      params_from_jax(base_np, device="cpu"), CFG)
    got = params_to_numpy(model.fused(lora_from_jax(lora_np, device="cpu")))
    want = jlora.apply_lora(jax.tree_util.tree_map(jnp.asarray, base_np),
                            jax.tree_util.tree_map(jnp.asarray, lora_np), CFG.scaling)
    for k in CFG.targets:
        np.testing.assert_allclose(got["layers"][k], np.asarray(want["layers"][k]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["embed"], base_np["embed"])
    with pytest.raises(ValueError, match="not \\[L, d_in, r\\]"):
        lora_from_jax({"wq": {"A": np.zeros((2, 3)), "B": np.zeros((2, 4, 5))}}, "cpu")


def _engines(base_np, lora_np):
    mesh_mod.reset_mesh()
    mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1), devices=jax.devices()[:1])
    jbase = JaxCausalLM("tiny", dtype=jnp.float32)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jlora.LoRAModel(jbase, jax.tree_util.tree_map(jnp.asarray, base_np), CFG),
        config=dict(TRAIN), params=jax.tree_util.tree_map(jnp.asarray, lora_np), mesh=mesh)
    base = CausalLM("tiny", dtype=torch.float32)
    model = LoRAModel(base, params_from_jax(base_np, device="cpu"), CFG)
    eng, *_ = ds.initialize(model=model, config=dict(TRAIN), device="cpu",
                            params=lora_from_jax(lora_np, device="cpu"))
    return jeng, eng, model


def test_only_the_adapters_train(base_np, lora_np):
    model = LoRAModel(CausalLM("tiny", dtype=torch.float32),
                      params_from_jax(base_np, device="cpu"), CFG)
    before = {p: x.clone() for p, x in tree_flatten_with_path(model.base_params)}
    eng, *_ = ds.initialize(model=model, config=dict(TRAIN), device="cpu")
    assert eng.param_count == sum(a.numel() + b.numel() for a, b in (
        (v["A"], v["B"]) for v in eng.state.params.values()))
    start = {p: x.clone() for p, x in tree_flatten_with_path(eng.state.params)}
    for b in _batches(2):
        eng.train_batch(batch=b)
    for p, x in tree_flatten_with_path(model.base_params):
        assert torch.equal(x, before[p]), p
    for p, x in tree_flatten_with_path(eng.state.params):
        assert not torch.equal(x, start[p]), p


def test_lora_trajectory_matches_jax(base_np, lora_np):
    try:
        jeng, eng, _ = _engines(base_np, lora_np)
        batches = _batches(3, seed=6)
        want = [float(jeng.train_batch(batch=b)) for b in batches]
        got = [float(eng.train_batch(batch=b)) for b in batches]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        theirs = jax.tree_util.tree_map(np.asarray, jeng.get_params())
        ours = params_to_numpy(eng.get_params())
        for k in CFG.targets:
            for m in ("A", "B"):
                a, b = ours[k][m], theirs[k][m]
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
                assert (~np.isclose(a, b, rtol=1e-5, atol=1e-5)).mean() <= 5e-3
        for a, b in zip(opt_state_to_numpy(eng.state.opt_state),
                        opt_state_to_numpy(jeng.state.opt_state)):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * np.abs(b).max())
    finally:
        mesh_mod.reset_mesh()


def test_hybrid_tokens_track_training_like_jax(base_np, lora_np):
    try:
        jeng, eng, model = _engines(base_np, lora_np)
        jh, th = JaxHybrid(jeng), DeepSpeedHybridEngine(eng)
        prompts = np.random.RandomState(7).randint(0, 256, (2, 8)).astype(np.int32)
        for step, b in enumerate([None] + _batches(2, seed=8)):
            if b is not None:
                jh.train_batch(batch=b)
                th.train_batch(batch=b)
            want = np.asarray(jh.generate(prompts, max_new_tokens=6))
            got = th.generate(prompts, max_new_tokens=6).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
            fresh = ds.init_inference(model.base_model, config={"dtype": "fp32"},
                                      device="cpu", params=model.fused(eng.state.params))
            assert torch.equal(fresh.generate(prompts, max_new_tokens=6),
                               torch.from_numpy(got))
            assert th._fused_at_step == eng.global_steps
        assert th.report_generate_latency() > 0
    finally:
        mesh_mod.reset_mesh()


def test_hybrid_surface(base_np):
    base = CausalLM("tiny", dtype=torch.float32)
    eng, *_ = ds.initialize(model=base, config=dict(TRAIN), device="cpu",
                            params=params_from_jax(base_np, device="cpu"))
    h = DeepSpeedHybridEngine(eng)
    assert h.eval() is h and h.train() is h and h.train(False) is h
    assert h.report_generate_latency() is None
    ids = np.random.RandomState(1).randint(0, 256, (1, 8))
    want = ds.init_inference(base, config={"dtype": "fp32"}, device="cpu",
                             params=eng.state.params).generate(ids, max_new_tokens=4)
    assert torch.equal(h.generate(ids, max_new_tokens=4), want)
    h.fuse_lora_weight()   # no adapters: nothing to fuse
    assert h._fused_params is None
    with pytest.raises(NotImplementedError, match="item 14"):
        h.rollout_engine(b_slots=2)

    class NoCache:
        config = base.config

        def loss_fn(self, p, b, g):
            return base.loss_fn(p, b, g)

        def init_fn(self, g):
            return base.init_fn(g, device="cpu")

    plain, *_ = ds.initialize(model=NoCache(), config=dict(TRAIN), device="cpu")
    with pytest.raises(ValueError, match="KV-cache-capable"):
        DeepSpeedHybridEngine(plain)


@pytest.mark.parametrize("stage", [1, 3])
def test_lora_under_zero_over_two_ranks_equals_one_process(stage, base_np, lora_np, tmp_path):
    """ZeRO shards the adapter tree like any other (stage 3: the forward
    gathers A and B where it reads them); the hybrid engine generates from
    the gathered view: losses, adapters and tokens equal the one-process
    engine's (fp32 sums in another order: rtol/atol 1e-6, tests/test_torch_zero.py's
    bound)."""
    from ._torch_ranks import prog_lora, run_ranks

    cfg = {**TRAIN, "zero_optimization": {"stage": stage}}
    batches = _batches(2, seed=10)
    prompts = np.random.RandomState(11).randint(0, 256, (2, 8))
    one = prog_lora(dict(TRAIN), base_np, lora_np, batches, prompts, 5)
    ranks = run_ranks(2, "lora", tmp_path, config=cfg, base_np=base_np, lora_np=lora_np,
                      batches=batches, prompts=prompts, max_new=5)
    for rec in ranks:
        assert rec["local_shapes"]["wq/A"][1] == one["local_shapes"]["wq/A"][1] // 2
        np.testing.assert_allclose(rec["losses"], one["losses"], rtol=1e-6)
        for k, v in one["lora"].items():
            np.testing.assert_allclose(rec["lora"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(rec["tokens"], one["tokens"])
