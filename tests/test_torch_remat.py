"""The port's remat policies against its own ``nothing_saveable`` and against
the JAX package's ``jax.checkpoint`` policies.

Every policy recomputes a different part of the layer, but the autograd
graph is the same, so the port's gradients under each policy equal its
``nothing_saveable`` gradients bit for bit (dropout on: every recomputed
part redraws its masks).  Against ``jax.grad`` of the JAX model under the
same policy, on the same numpy weights and tokens (fp32, ``attn_impl=
"pallas"`` so that both take the flash route at S=128; JAX's kernels run
in interpret mode), the loss agrees at rtol 1e-5 and every gradient at
rtol 1e-4 / atol 1e-6, the tolerance of ``test_torch_training.py``'s
``jax.grad`` comparison.

What each policy keeps shows in how often the flash forward runs: once per
layer in the forward, and once more in the backward unless the policy
keeps q, k, v, the output and the lse (``save_qkv``, ``save_matmuls``).
The JAX package's count is the number of forward kernels (``pallas_call``s
with an lse output) in ``make_jaxpr(grad(loss))``: 2 per layer under every
policy.  Its ``save_qkv`` and ``save_matmuls`` name the attention output
``attn_out`` after ``flash_attention`` swaps it back to ``[B,S,H,hd]``,
while the kernel's ``custom_vjp`` keeps the ``[B,H,S,hd]`` output as its
residual; that unnamed tensor is recomputed, so the forward kernel runs
again in the backward, though the comment beside the policy says it
never does.  The port's kernel returns ``[B,S,H,hd]`` itself, so the
named ``attn_out`` is the residual and those two policies run it once:
the saving the JAX policy was written for, at the same saved tensors.
The test holds the port to JAX's count under the other policies and to
one run fewer under these two.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import REMAT_POLICIES
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.utils.tree import tree_leaves

POLICIES = ["save_attn", "save_qkv", "save_matmuls", "dots_saveable"]
S = 128
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np_params(name, seed=0):
    jcfg = jtf.get_config(name, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray,
                                  jtf.init_params(jcfg, jax.random.PRNGKey(seed)))


def _tokens(vocab, B=2, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the flash forward's calls (the kernel on a card, its plain
    version here)."""
    calls = {"n": 0}
    forward = fa._forward

    def counting(*args, **kwargs):
        calls["n"] += 1
        return forward(*args, **kwargs)

    monkeypatch.setattr(fa, "_forward", counting)
    return calls


def _port_grads(name, np_params, tokens, policy, **cfg):
    model = CausalLM(name, dtype=torch.float32, attn_impl="pallas", remat=True,
                     remat_policy=policy, **cfg)
    params = params_from_jax(np_params, device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss_fn(params, {"input_ids": torch.from_numpy(tokens)},
                         torch.Generator().manual_seed(3))
    grads = torch.autograd.grad(loss, leaves)
    return loss, grads


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,cfg", [
    ("tiny-gqa", {"dropout": 0.1}),
    ("tiny-gpt2", {"dropout": 0.1}),
    ("tiny", {"parallel_residual": True, "dropout": 0.1}),
    ("tiny", {"post_layernorm": True}),
], ids=["gqa-dropout", "gpt2-dropout", "parallel-residual", "post-ln"])
def test_policy_grads_equal_nothing_saveable(policy, name, cfg):
    np_params = _np_params(name, seed=2)
    tokens = _tokens(256, seed=3)
    ref_loss, ref = _port_grads(name, np_params, tokens, "nothing_saveable", **cfg)
    loss, grads = _port_grads(name, np_params, tokens, policy, **cfg)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(grads, ref):
        assert torch.equal(a, b)


def _jax_grads(name, np_params, tokens, policy):
    model = JaxCausalLM(name, dtype=jnp.float32, attn_impl="pallas", remat=True,
                        remat_policy=policy)
    batch = {"input_ids": jnp.asarray(tokens)}

    def loss_fn(p):
        return model.loss_fn(p, batch, jax.random.PRNGKey(0))

    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return loss_fn, params


def _forward_kernels(jaxpr) -> int:
    """Forward flash kernels in a jaxpr and its sub-jaxprs: the
    ``pallas_call``s whose second output is the lse ``[B, H, 1, S]``."""
    from jax.extend import core as jcore

    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            outs = [o.aval.shape for o in eqn.outvars]
            n += len(outs) == 2 and len(outs[1]) == 4 and outs[1][2] == 1
            continue
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    n += _forward_kernels(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    n += _forward_kernels(sub)
    return n


@pytest.mark.parametrize("policy", ["nothing_saveable"] + POLICIES)
def test_flash_forward_runs_per_layer_against_jax_jaxpr(policy, flash_calls):
    """The layers sit in a ``lax.scan`` in JAX, so its jaxpr holds each
    per-layer kernel once: its count is per layer."""
    name = "tiny"
    np_params = _np_params(name, seed=4)
    tokens = _tokens(256, seed=5)
    loss_fn, params = _jax_grads(name, np_params, tokens, policy)
    want = _forward_kernels(jax.make_jaxpr(jax.grad(loss_fn))(params).jaxpr)
    _port_grads(name, np_params, tokens, policy)
    layers = jtf.get_config(name).num_layers
    assert want == 2
    keeps_kernel_outputs = policy in ("save_qkv", "save_matmuls")
    assert flash_calls["n"] == layers * (want - keeps_kernel_outputs)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_grads_match_jax(policy):
    name = "tiny-gqa"
    np_params = _np_params(name, seed=6)
    tokens = _tokens(256, seed=7)
    loss_fn, params = _jax_grads(name, np_params, tokens, policy)
    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    loss, grads = _port_grads(name, np_params, tokens, policy)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for a, b in zip(grads, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_unknown_policy_raises():
    """The JAX package hands an unknown name to ``jax.checkpoint`` as
    ``policy=None``, which saves nothing; the port refuses it instead of
    running a policy the config did not name."""
    assert set(POLICIES + ["nothing_saveable"]) <= set(REMAT_POLICIES)
    model = CausalLM("tiny", dtype=torch.float32, remat=True,
                     remat_policy="save_everything_please")
    params = model.init_fn(device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        model.loss_fn(params, {"input_ids": torch.zeros((1, 8), dtype=torch.long)})
