"""The port's progressive layer drop (``runtime/progressive_layer_drop.py``)
and random-LTD (``runtime/data_pipeline/data_routing/random_ltd.py``)
against the JAX package's.

The draws cannot match bit for bit (``jax.random`` against torch
generators), so each model test patches ``pld_keep_mask`` and
``select_tokens`` in both packages, inside this process, to return the
same seeded numpy mask or indices; nothing in ``deepspeed_tpu`` is edited.
Then, in fp64, a 4-layer ``tiny``'s loss and gradients under PLD (the
dropped layers skipped in the port, selected away in JAX's scan) and
under random-LTD (each layer on the kept subset) equal JAX's at rtol
1e-5 / atol 1e-8 (both take the cross-entropy in fp32); ``keep >= S`` is
a passthrough, bit for bit.  The schedules match value for
value, the port's mask keeps layer i with probability 1 - (i+1)/L (1 -
theta), the engines step theta and the kept count as JAX's, a dropped
layer launches nothing, and JAX's refusals hold.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as mesh_mod
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.data_pipeline.data_routing import random_ltd as jltd

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import random_ltd as tltd
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map

torch.set_num_threads(1)

L, S, B = 4, 32, 2
# fp64 weights and activations; both packages take the cross-entropy in
# fp32, so the loss and gradients agree to its rounding
TOL = dict(rtol=1e-5, atol=1e-8)


def _np_params(seed=0):
    cfg = jtf.get_config("tiny", num_layers=L, max_seq_len=S)
    return jax.tree_util.tree_map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(seed=1):
    return {"input_ids": np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)}


def _jax_loss_and_grads(np_params, batch, **overrides):
    jax.config.update("jax_enable_x64", True)
    try:
        model = JaxCausalLM(dataclasses.replace(
            jtf.get_config("tiny", num_layers=L, max_seq_len=S, **overrides),
            dtype=jnp.float64))
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), np_params)
        jb = {k: (jnp.asarray(v) if not isinstance(v, float) else jnp.float64(v))
              for k, v in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda p: model.loss_fn(p, jb, jax.random.PRNGKey(0)))(params)
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        return float(loss), {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(g)
                             for p, g in flat}
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_loss_and_grads(np_params, batch, **overrides):
    model = CausalLM("tiny", num_layers=L, max_seq_len=S, dtype=torch.float64, **overrides)
    params = tree_map(lambda x: x.double().requires_grad_(),
                      params_from_jax(np_params, device="cpu"))
    tb = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items()}
    loss = model.loss_fn(params, tb, torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    loss = loss.detach()
    paths = [p for p, _ in tree_flatten_with_path(params)]
    return float(loss), {p: (np.zeros(x.shape) if g is None else g.numpy())
                         for p, g, x in zip(paths, grads, tree_leaves(params))}


def _close(ours, theirs):
    assert ours[0] == pytest.approx(theirs[0], rel=TOL["rtol"])
    assert set(ours[1]) == set(theirs[1])
    for k, g in theirs[1].items():
        np.testing.assert_allclose(ours[1][k], g, err_msg=k, **TOL)


@pytest.mark.parametrize("mask", [(1, 0, 1, 1), (0, 1, 1, 0), (1, 1, 1, 1)],
                         ids=lambda m: "".join(map(str, m)))
def test_pld_forward_and_grads_match_jax(mask, monkeypatch):
    keep = np.asarray(mask, bool)
    monkeypatch.setattr(jpld, "pld_keep_mask", lambda rng, n, theta: jnp.asarray(keep))
    monkeypatch.setattr(tpld, "pld_keep_mask", lambda gen, n, theta: torch.from_numpy(keep))
    np_params, batch = _np_params(2), {**_batch(3), "pld_theta": 0.5}
    ours = _port_loss_and_grads(np_params, batch)
    _close(ours, _jax_loss_and_grads(np_params, batch))
    for i, k in enumerate(keep):   # a dropped layer gets no gradient
        assert (np.abs(ours[1]["layers/wq"][i]).max() > 0) == bool(k)


def test_pld_skips_dropped_layers():
    """A dropped layer runs nothing: the forward reads only the kept
    layers' weights (counted through the block)."""
    from deepspeed_tpu_torch.models import transformer as tt

    calls = []
    real = tt._block_aux

    def counting(cfg, lp, *a, **k):
        calls.append(1)
        return real(cfg, lp, *a, **k)

    model = CausalLM("tiny", num_layers=8, max_seq_len=S, dtype=torch.float32)
    params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(5)
    want = int(tpld.pld_keep_mask(torch.Generator().manual_seed(5), 8, 0.3).sum())
    tt._block_aux = counting
    try:
        model.loss_fn(params, {"input_ids": torch.from_numpy(_batch()["input_ids"]),
                               "pld_theta": 0.3, "pld_generator": gen})
    finally:
        tt._block_aux = real
    assert len(calls) == want < 8


def test_pld_mask_probabilities_and_schedule_match_jax():
    gen = torch.Generator().manual_seed(0)
    theta, n = 0.4, 20000
    masks = torch.stack([tpld.pld_keep_mask(gen, L, theta) for _ in range(n)]).double()
    want = 1.0 - (np.arange(L) + 1.0) / L * (1.0 - theta)
    np.testing.assert_allclose(masks.mean(0).numpy(), want, atol=0.015)
    ours, theirs = tpld.ProgressiveLayerDrop(0.5, 0.01), jpld.ProgressiveLayerDrop(0.5, 0.01)
    for step in (0, 1, 7, 100, 5000):
        assert ours.update_state(step) == theirs.update_state(step)
    assert ours.get_state() == theirs.get_state()


@pytest.mark.parametrize("keep", [8, 24])
def test_random_ltd_forward_and_grads_match_jax(keep, monkeypatch):
    rs = np.random.RandomState(keep)
    idx = np.sort(np.stack([rs.permutation(S)[:keep] for _ in range(B)]), axis=1)
    monkeypatch.setattr(jltd, "select_tokens", lambda rng, b, s, k: jnp.asarray(idx))
    monkeypatch.setattr(tltd, "select_tokens",
                        lambda gen, b, s, k: torch.from_numpy(idx))
    np_params, batch = _np_params(4), _batch(5)
    kw = dict(random_ltd=True, random_ltd_keep=keep)
    ours = _port_loss_and_grads(np_params, batch, **kw)
    _close(ours, _jax_loss_and_grads(np_params, batch, **kw))
    plain = _port_loss_and_grads(np_params, batch)
    assert abs(ours[0] - plain[0]) > 1e-6   # the subset changed the loss


def test_random_ltd_passthrough_and_eval():
    np_params, batch = _np_params(6), _batch(7)
    plain = _port_loss_and_grads(np_params, batch)
    full = _port_loss_and_grads(np_params, batch, random_ltd=True, random_ltd_keep=S)
    assert full[0] == plain[0]
    for k in plain[1]:
        np.testing.assert_array_equal(full[1][k], plain[1][k])
    model = CausalLM("tiny", num_layers=L, max_seq_len=S, dtype=torch.float64,
                     random_ltd=True, random_ltd_keep=8)
    base = CausalLM("tiny", num_layers=L, max_seq_len=S, dtype=torch.float64)
    params = tree_map(lambda x: x.double(), params_from_jax(np_params, device="cpu"))
    tb = {"input_ids": torch.from_numpy(batch["input_ids"])}
    assert float(model.eval_fn(params, tb)) == float(base.eval_fn(params, tb))


def test_select_gather_scatter():
    gen = torch.Generator().manual_seed(3)
    idx = tltd.select_tokens(gen, 3, 16, 5)
    assert idx.shape == (3, 5)
    assert all(len(set(r.tolist())) == 5 and r.tolist() == sorted(r.tolist()) for r in idx)
    x = torch.randn(3, 16, 4)
    sub = tltd.gather_tokens(x, idx)
    np.testing.assert_array_equal(sub.numpy(), np.take_along_axis(
        x.numpy(), idx.numpy()[:, :, None].repeat(4, 2), axis=1))
    back = tltd.scatter_tokens(x, sub * 2, idx)
    want = x.clone()
    for b in range(3):
        want[b, idx[b]] = sub[b] * 2
    assert torch.equal(back, want)


def test_ltd_scheduler_matches_jax():
    cfg = {"min_value": 96, "max_value": 512, "random_ltd_schedule": {
        "schedule_config": {"seq_per_step": 32, "require_steps": 50}}}
    ours, theirs = tltd.RandomLTDScheduler(cfg), jltd.RandomLTDScheduler(cfg)
    assert [ours.update_seq(s) for s in range(0, 80, 3)] == \
        [theirs.update_seq(s) for s in range(0, 80, 3)]
    assert ours.state_dict() == theirs.state_dict()
    with pytest.raises(ValueError, match="fixed_linear only"):
        tltd.RandomLTDScheduler({"random_ltd_schedule": {"schedule_type": "cosine"}})


def _ltd_pld_config(**extra):
    return {"train_batch_size": 2, "seed": 3, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.1},
            "data_efficiency": {"data_routing": {"random_ltd": {
                "enabled": True, "min_value": 8, "max_value": S,
                "random_ltd_schedule": {"schedule_config": {"seq_per_step": 8,
                                                            "require_steps": 3}}}}},
            **extra}


def test_engines_step_theta_and_keep_like_jax():
    batches = [_batch(s) for s in range(5)]
    mesh_mod.reset_mesh()
    try:
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1), devices=jax.devices()[:1])
        jeng, *_ = deepspeed_tpu.initialize(
            model=JaxCausalLM("tiny", max_seq_len=S, dtype=jnp.float32),
            config=_ltd_pld_config(), mesh=mesh)
        want = []
        for b in batches:
            jeng.train_batch(batch=b)
            want.append((jeng.progressive_layer_drop.get_theta(), jeng._ltd_keep))
    finally:
        mesh_mod.reset_mesh()
    eng, *_ = ds.initialize(model=CausalLM("tiny", max_seq_len=S, dtype=torch.float32),
                            device="cpu", config=_ltd_pld_config())
    got = []
    for b in batches:
        assert np.isfinite(float(eng.train_batch(batch=b)))
        got.append((eng.progressive_layer_drop.get_theta(), eng._ltd_keep))
    assert got == want
    with pytest.raises(ValueError, match="needs dict batches"):
        eng.train_batch(batch=torch.zeros((2, S), dtype=torch.long))


def test_pld_engine_resume_is_bit_exact(tmp_path):
    """The host generator PLD draws its masks from rides the checkpoint."""
    cfg = _ltd_pld_config(data_efficiency={})
    batches = [_batch(s) for s in range(4)]
    a, *_ = ds.initialize(model=CausalLM("tiny", num_layers=4, max_seq_len=S,
                                         dtype=torch.float32), device="cpu", config=cfg)
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path), tag="t")
    want = [float(a.train_batch(batch=b)) for b in batches[2:]]
    b_, *_ = ds.initialize(model=CausalLM("tiny", num_layers=4, max_seq_len=S,
                                          dtype=torch.float32), device="cpu", config=cfg)
    b_.load_checkpoint(str(tmp_path), tag="t")
    assert [float(b_.train_batch(batch=b)) for b in batches[2:]] == want


def test_refusals():
    pipe = CausalLM("tiny", pipeline_stages=2)
    with pytest.raises(NotImplementedError,
                       match="progressive layer drop requires the scanned-layers path"):
        ds.initialize(model=pipe, device="cpu", config={
            "train_batch_size": 2, "progressive_layer_drop": {"enabled": True}})
    with pytest.raises(NotImplementedError,
                       match="pipeline_schedule='1f1b' \\+ random_ltd: unsupported"):
        ds.initialize(model=CausalLM("tiny", pipeline_stages=2, pipeline_schedule="1f1b"),
                      device="cpu", config={"train_batch_size": 2, "data_efficiency": {
                          "data_routing": {"random_ltd": {"enabled": True}}}})
    with pytest.raises(NotImplementedError,
                       match="pipeline_schedule='1f1b' \\+ progressive_layer_drop"):
        ds.initialize(model=CausalLM("tiny", pipeline_stages=2, pipeline_schedule="1f1b"),
                      device="cpu", config={"train_batch_size": 2,
                                            "progressive_layer_drop": {"enabled": True}})
    with pytest.raises(NotImplementedError, match="attention types"):
        CausalLM("tiny", random_ltd=True, random_ltd_keep=8,
                 attention_layers=("global", "local")).loss_fn(
            CausalLM("tiny").init_fn(torch.Generator(), device="cpu"),
            {"input_ids": torch.zeros((1, 16), dtype=torch.long)})


@pytest.mark.parametrize("feature", ["random_ltd", "pld"])
def test_offload_param_refusals_match_jax(feature, tmp_path):
    extra = ({"data_efficiency": {"data_routing": {"random_ltd": {"enabled": True}}}}
             if feature == "random_ltd" else {"progressive_layer_drop": {"enabled": True}})
    cfg = {"train_batch_size": 2, "bf16": {"enabled": True}, **extra,
           "zero_optimization": {"stage": 3, "offload_param": {
               "device": "nvme", "nvme_path": str(tmp_path / "jax")}}}
    mesh_mod.reset_mesh()
    try:
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1), devices=jax.devices()[:1])
        with pytest.raises(NotImplementedError) as theirs:
            deepspeed_tpu.initialize(model=JaxCausalLM("tiny"), config=dict(cfg), mesh=mesh)
    finally:
        mesh_mod.reset_mesh()
    cfg["zero_optimization"]["offload_param"]["nvme_path"] = str(tmp_path / "port")
    with pytest.raises(NotImplementedError) as ours:
        ds.initialize(model=CausalLM("tiny"), config=cfg, device="cpu")
    assert str(ours.value) == str(theirs.value)
