"""The fp64 golden-parity gate of the port's trainer (the port's side of
``tests/unit/test_golden_parity.py``).

A tiny GPT-2 is built in-process by transformers (no download) and trained
in fp64 with plain ``torch.optim.AdamW`` on fixed data: a trajectory that
shares no code with either package.  Its initial weights go through the
JAX package's ``load_hf_checkpoint`` (fp64) and ``params_from_jax`` into the
port, which trains the same model (the JAX config carried over field by
field, fp64 activations) on the same batches with the same
hyperparameters: fp64 weights (the engine keeps masters of the
parameters' own dtype when it is wider than fp32) and forward/backward,
the norms and the loss in fp32 (as ``_norm`` and ``cross_entropy_loss``
compute them in both packages), the gradient landing at the fp32
accumulation dtype, and Adam's moment math in fp32 over fp64 moments
(``nu_dtype`` set).  The 8-step loss trajectory is held against the torch
golden at rtol 5e-6 / atol 5e-6, the JAX test's tolerance, and, at the
same tolerance, losses and final weights against the JAX engine on one
device under x64 (which casts its initial tree to fp32,
``deepspeed_tpu/runtime/engine.py:492``, so its weights are fp32: a second
reference, not a bit-for-bit one).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.module_inject import load_hf_checkpoint
from deepspeed_tpu.parallel import mesh as mesh_mod
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.utils.tree import tree_leaves

transformers = pytest.importorskip("transformers")

STEPS = 8
B, S = 8, 16
LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 0.0
TOL = dict(rtol=5e-6, atol=5e-6)
CONFIG = {
    "train_micro_batch_size_per_gpu": B,
    "optimizer": {"type": "adamw",
                  "params": {"lr": LR, "betas": list(BETAS), "eps": EPS,
                             "weight_decay": WD, "mu_dtype": "float64",
                             "nu_dtype": "float64"}},
    "steps_per_print": 10 ** 9,
}


def _tiny_gpt2():
    cfg = transformers.GPT2Config(
        vocab_size=96, n_embd=32, n_layer=2, n_head=4, n_positions=64,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return cfg, transformers.GPT2LMHeadModel(cfg)


def _batches():
    r = np.random.default_rng(7)
    return r.integers(0, 96, (STEPS, B, S)).astype(np.int64)


@pytest.fixture(scope="module")
def golden():
    """The external reference run: fp64 torch AdamW on the tiny GPT-2."""
    hf_cfg, hf = _tiny_gpt2()
    init_sd = copy.deepcopy(hf.state_dict())
    hf = hf.double().train()
    opt = torch.optim.AdamW(hf.parameters(), lr=LR, betas=BETAS, eps=EPS,
                            weight_decay=WD)
    losses = []
    for x in _batches():
        xb = torch.from_numpy(x)
        out = hf(input_ids=xb, labels=xb)
        opt.zero_grad()
        out.loss.backward()
        opt.step()
        losses.append(out.loss.item())
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg, np_params = load_hf_checkpoint((hf_cfg, init_sd), dtype=np.float64)
        np_params = jax.tree_util.tree_map(np.asarray, np_params)
    finally:
        jax.config.update("jax_enable_x64", False)
    return jcfg, np_params, np.asarray(losses)


def _port_config(jcfg) -> ttf.TransformerConfig:
    names = {f.name for f in dataclasses.fields(ttf.TransformerConfig)} - {"dtype"}
    return ttf.TransformerConfig(
        **{n: getattr(jcfg, n) for n in names if hasattr(jcfg, n)},
        dtype=torch.float64)


def _loss_fn(cfg, forward, loss, concat, full_like):
    def loss_fn(p, batch, rng):
        tokens = batch["input_ids"]
        labels = concat([tokens[:, 1:], full_like(tokens[:, :1], -100)], 1)
        return loss(forward(cfg, p, tokens, attn_impl="xla", deterministic=True),
                    labels)
    return loss_fn


def test_port_reproduces_torch_golden_trajectory(golden):
    jcfg, np_params, want = golden
    cfg = _port_config(jcfg)
    params = params_from_jax(np_params, device="cpu")
    assert all(p.dtype == torch.float64 for p in tree_leaves(params))
    engine, *_ = ds.initialize(
        loss_fn=_loss_fn(cfg, ttf.forward, ttf.cross_entropy_loss, torch.cat,
                         torch.full_like),
        params=params, config=CONFIG, device="cpu")
    assert engine.state.master_params is None
    assert all(p.dtype == torch.float64 for p in tree_leaves(engine.state.params))
    ours = [float(engine.train_batch(batch={"input_ids": x}))
            for x in _batches()]
    np.testing.assert_allclose(ours, want, **TOL)
    assert want[-1] < want[0]


def test_port_matches_fp64_jax_engine(golden):
    """The JAX engine on one device under x64, same weights and batches."""
    jcfg, np_params, _ = golden
    cfg = _port_config(jcfg)
    engine, *_ = ds.initialize(
        loss_fn=_loss_fn(cfg, ttf.forward, ttf.cross_entropy_loss, torch.cat,
                         torch.full_like),
        params=params_from_jax(np_params, device="cpu"), config=CONFIG,
        device="cpu")
    ours = [float(engine.train_batch(batch={"input_ids": x})) for x in _batches()]
    jax.config.update("jax_enable_x64", True)
    try:
        mesh_mod.reset_mesh()
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout.from_world(1),
                                        devices=jax.devices()[:1])
        jcfg64 = dataclasses.replace(jcfg, dtype=jnp.float64)
        jeng, *_ = deepspeed_tpu.initialize(
            loss_fn=_loss_fn(jcfg64, jtf.forward, jtf.cross_entropy_loss,
                             jnp.concatenate, jnp.full_like),
            params=jax.tree_util.tree_map(jnp.asarray, np_params),
            config=CONFIG, mesh=mesh)
        theirs = [float(jeng.train_batch(batch={"input_ids": x.astype(np.int32)}))
                  for x in _batches()]
        jparams = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            np.asarray, jeng.get_params()))
    finally:
        jax.config.update("jax_enable_x64", False)
        mesh_mod.reset_mesh()
    np.testing.assert_allclose(ours, theirs, **TOL)
    for a, b in zip(tree_leaves(engine.get_params()), jparams):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
