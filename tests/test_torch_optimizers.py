"""The port's LAMB, SGD, Adagrad, Lion and RMSprop
(``deepspeed_tpu_torch/runtime/optimizer.py``) against the JAX package's.

- each optimizer's whole update chain (``create_optimizer``: clipping, the
  optimizer's links, the learning rate) against JAX's optax chain on the
  same random fp64 trees, over 4 updates, with weight decay on and off:
  updates and state at rtol 1e-12 (fp64 on both sides, optax's
  arithmetic);
- each optimizer x weight decay trained in the engine on ``tiny`` (fp64
  activations) against the JAX engine on one virtual device under x64,
  3 steps of gas 2 with clipping: losses and final weights at rtol/atol
  5e-6, the golden gate's tolerance (the JAX engine keeps fp32 masters);
- LAMB at ZeRO-3 over 2 gloo ranks equals the one-process engine within
  1e-6 (the fp32 sums in another order): its trust ratio reads the norms
  of whole leaves, summed over the shards;
- offload's host Adam refuses the other optimizers with JAX's words, and
  the optimizer state's bytes a parameter are each optimizer's own.
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
from deepspeed_tpu.runtime import optimizer as jax_opt

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.runtime import optimizer as port_opt
from deepspeed_tpu_torch.utils.tree import tree_leaves

from ._torch_ranks import _run_case, make_batches, run_ranks

torch.set_num_threads(1)

TOL = dict(rtol=5e-6, atol=5e-6)
# dp=2 against one process: the fp32 loss and gradient sums in another
# order (tests/test_torch_zero.py's bound)
SELF_TOL = dict(rtol=1e-6, atol=1e-6)
STEPS, TRAIN_BATCH, GAS, CLIP = 3, 8, 2, 0.5
OPTIMIZERS = {
    "lamb": {"lr": 2e-3, "betas": [0.9, 0.99]},
    "sgd": {"lr": 5e-2, "momentum": 0.9, "nesterov": True},
    "adagrad": {"lr": 5e-2},
    "lion": {"lr": 1e-3, "betas": [0.9, 0.99]},
    "rmsprop": {"lr": 1e-3},
}
CASES = [(name, wd) for name in OPTIMIZERS for wd in (0.0, 0.01)]


def _ids(case):
    return f"{case[0]}-wd{case[1]}"


def _params(name, wd):
    return {**OPTIMIZERS[name], "weight_decay": wd}


# ---------------------------------------------------------------------------
# The chains
# ---------------------------------------------------------------------------

def _trees(seed, n):
    rs = np.random.RandomState(seed)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rs.randn(*s)

    return draw(shapes), [draw(shapes) for _ in range(n)]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chain_matches_optax(case):
    name, wd = case
    params, grads = _trees(3, 4)
    jax.config.update("jax_enable_x64", True)
    try:
        jchain = jax_opt.create_optimizer(name, _params(name, wd), gradient_clipping=1.0)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = jchain.init(jp)
        want = []
        for g in grads:
            u, jstate = jchain.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
            jp = jax.tree_util.tree_map(lambda p, d: p + d, jp, u)
            want.append([np.asarray(x) for x in jax.tree_util.tree_leaves(u)])
        want_state = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)
                      if np.ndim(x) > 0]
    finally:
        jax.config.update("jax_enable_x64", False)
    chain = port_opt.create_optimizer(name, _params(name, wd), gradient_clipping=1.0)

    def t(tree):
        return {k: t(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else torch.from_numpy(tree)

    tp = t(params)
    state = chain.init(tp)
    for g, w in zip(grads, want):
        u, state = chain.update(t(g), state, tp)
        tp = port_opt.apply_updates(tp, u)
        for a, b in zip(tree_leaves(u), w):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-15)

    def leaves(obj):
        if isinstance(obj, torch.Tensor):
            return [obj] if obj.dim() else []
        if dataclasses.is_dataclass(obj):
            return [x for f in dataclasses.fields(obj) for x in leaves(getattr(obj, f.name))]
        if isinstance(obj, (tuple, list)):
            return [x for o in obj for x in leaves(o)]
        if isinstance(obj, dict):
            return [x for k in sorted(obj) for x in leaves(obj[k])]
        return []

    got_state = leaves(state)
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-15)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unsupported optimizer"):
        port_opt.create_optimizer("adafactor", {})


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(4)))


@pytest.fixture(scope="module")
def batches():
    return make_batches(STEPS, TRAIN_BATCH, seed=5)


def _config(name, wd, stage=0):
    return {"train_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": GAS,
            "gradient_clipping": CLIP,
            "optimizer": {"type": name, "params": _params(name, wd)},
            "zero_optimization": {"stage": stage}, "steps_per_print": 10 ** 9}


def _jax_run(params_np, batches, config):
    jax.config.update("jax_enable_x64", True)
    try:
        mesh_mod.reset_mesh()
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1),
                                        devices=jax.devices()[:1])
        model = JaxCausalLM(dataclasses.replace(jtf.get_config("tiny"),
                                                dtype=jnp.float64))
        eng, *_ = deepspeed_tpu.initialize(
            model=model, config=config,
            params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
        losses = [float(eng.train_batch(batch={k: v.astype(np.int32)
                                               for k, v in b.items()}))
                  for b in batches]
        flat = jax.tree_util.tree_flatten_with_path(eng.get_params())[0]
        params = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
                  for path, x in flat}
    finally:
        jax.config.update("jax_enable_x64", False)
        mesh_mod.reset_mesh()
    return losses, params


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_engine_trajectory_matches_jax(case, params_np, batches):
    name, wd = case
    losses, params = _jax_run(params_np, batches, _config(name, wd))
    ours = _run_case({"config": _config(name, wd)}, params_np, batches)
    np.testing.assert_allclose(ours["losses"], losses, **TOL)
    for k, want in params.items():
        np.testing.assert_allclose(ours["masters"][k], want, err_msg=k, **TOL)


@pytest.mark.parametrize("frozen", [(), ("embed",)], ids=["leafwise", "tree"])
def test_lamb_at_zero3_over_two_ranks_equals_one_process(frozen, params_np, batches,
                                                         tmp_path):
    """The engine updates a leaf at a time, or (frozen leaves) the whole
    tree at once: both sum LAMB's norms over the shards."""
    cfg = _config("lamb", 0.01, stage=3)
    kw = {"model_kw": {"frozen_keywords": frozen}} if frozen else {}
    one = _run_case({"config": _config("lamb", 0.01), **kw}, params_np, batches)
    ranks = run_ranks(2, "train", tmp_path, cases=[{"config": cfg, **kw}],
                      params_np=params_np, batches=batches)
    for rank in ranks:
        ours = rank[0]
        assert ours["master_shapes"]["layers/wq"] != one["master_shapes"]["layers/wq"]
        np.testing.assert_allclose(ours["losses"], one["losses"], **SELF_TOL)
        for k, want in one["masters"].items():
            np.testing.assert_allclose(ours["masters"][k], want, err_msg=k, **SELF_TOL)


def test_optimizer_state_bytes():
    """fp32 masters: SGD without momentum keeps no state, with it one
    trace (4 B/param); Adagrad 4; RMSprop 4; Lion 4; LAMB 8 (Adam's
    moments)."""
    want = {("sgd", 0.0): 0, ("sgd", 0.9): 4, ("adagrad", 0.0): 4,
            ("rmsprop", 0.0): 4, ("lion", 0.0): 4, ("lamb", 0.0): 8}
    for (name, momentum), per_param in want.items():
        cfg = {"train_batch_size": 2, "bf16": {"enabled": True},
               "optimizer": {"type": name, "params": {"lr": 1e-3, "momentum": momentum}}}
        eng, *_ = ds.initialize(model=CausalLM("tiny"), config=cfg, device="cpu")
        nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(
            _tensors(eng.state.opt_state)) if x.dim())
        assert nbytes == per_param * eng.param_count, (name, momentum)


def _tensors(obj):
    if dataclasses.is_dataclass(obj):
        return [_tensors(getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    if isinstance(obj, (tuple, list)):
        return [_tensors(o) for o in obj]
    if isinstance(obj, (dict, torch.Tensor)):
        return obj
    return []


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_host_offload_refuses_like_jax(name):
    cfg = {"train_batch_size": 2, "bf16": {"enabled": True},
           "optimizer": {"type": name, "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 1, "offload_optimizer": {
               "device": "cpu", "host_step": True}}}
    mesh_mod.reset_mesh()
    try:
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1), devices=jax.devices()[:1])
        with pytest.raises(NotImplementedError) as theirs:
            deepspeed_tpu.initialize(model=JaxCausalLM("tiny"), config=dict(cfg), mesh=mesh)
    finally:
        mesh_mod.reset_mesh()
    with pytest.raises(NotImplementedError) as ours:
        ds.initialize(model=CausalLM("tiny"), config=cfg, device="cpu")
    assert "not supported on the host path" in str(theirs.value)
    assert "not supported on the host path" in str(ours.value)
    # streamed offload (the default for a non-Adam type) steps any optimizer
    cfg["zero_optimization"]["offload_optimizer"].pop("host_step")
    eng, *_ = ds.initialize(model=CausalLM("tiny"), config=cfg, device="cpu")
    assert np.isfinite(float(eng.train_batch(batch={"input_ids": np.zeros((2, 16), np.int64)})))
