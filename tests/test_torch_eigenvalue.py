"""The port's Hessian eigenvalue estimator (``runtime/eigenvalue.py``,
``engine.compute_eigenvalue``) against a dense Hessian and the JAX
package's.

- the Hessian-vector product (double backward) equals the dense Hessian
  of a small nonlinear function times v, to fp64 rounding, and on ``tiny``
  equals JAX's forward-over-reverse product along the same v (fp64
  weights; both packages take the cross-entropy in fp32: rtol 1e-6);
- from the same starting vector (JAX's own draws, handed to the port),
  lambda_max and the per-leaf Rayleigh quotients equal JAX's at rtol 1e-5,
  through ``Eigenvalue`` and through the engines' ``compute_eigenvalue``;
- at S >= 2048 under ``attn_impl="auto"`` the JAX package fails (``jvp``
  of its Pallas kernel); the port refuses there too, with a message,
  instead of differentiating around the kernel.
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
from deepspeed_tpu.runtime import eigenvalue as jeig

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import eigenvalue as teig
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

torch.set_num_threads(1)

S, B = 16, 2


def test_hvp_equals_dense_hessian():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 2, generator=gen, dtype=torch.float64)
    w = {"a": torch.randn(3, 2, generator=gen, dtype=torch.float64),
         "b": torch.randn(4, generator=gen, dtype=torch.float64)}

    def loss_fn(p, batch, g):
        return (torch.sin(p["a"] * batch).sum() * p["b"].square().sum()
                + (p["a"] ** 3).sum() * p["b"][0])

    v = {"a": torch.randn(3, 2, generator=gen, dtype=torch.float64),
         "b": torch.randn(4, generator=gen, dtype=torch.float64)}
    hv = teig.hvp(loss_fn, w, a, None, v)

    def flat_loss(x):
        return loss_fn({"a": x[:6].reshape(3, 2), "b": x[6:]}, a, None)

    x0 = torch.cat([w["a"].reshape(-1), w["b"]])
    H = torch.autograd.functional.hessian(flat_loss, x0)
    want = H @ torch.cat([v["a"].reshape(-1), v["b"]])
    got = torch.cat([hv["a"].reshape(-1), hv["b"]])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _np_params(seed=1):
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(seed)))


def _batch(seed=2):
    return {"input_ids": np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)}


def _jax_model():
    return JaxCausalLM(dataclasses.replace(jtf.get_config("tiny"), dtype=jnp.float64))


def _port_model():
    return CausalLM("tiny", dtype=torch.float64)


def _port_params(np_params):
    return tree_map(lambda x: x.double(), params_from_jax(np_params, device="cpu"))


def _jax_v0(np_params):
    """JAX's own starting draws (``Eigenvalue.compute_eigenvalue``)."""
    rng = jax.random.PRNGKey(0)
    leaves = jax.tree_util.tree_leaves(np_params)
    return [np.asarray(jax.random.normal(jax.random.fold_in(rng, i), x.shape,
                                         jnp.float32)).astype(np.float64)
            for i, x in enumerate(leaves)]


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)
        mesh_mod.reset_mesh()


def test_hvp_matches_jax_on_tiny():
    np_params, batch = _np_params(), _batch()
    rs = np.random.RandomState(3)
    v_np = [rs.randn(*x.shape) for x in jax.tree_util.tree_leaves(np_params)]

    def jax_hv():
        p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), np_params)
        v = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(p),
                                         [jnp.asarray(x) for x in v_np])
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jeig.hvp(_jax_model().loss_fn, p, jb, jax.random.PRNGKey(0), v))]

    want = _x64(jax_hv)
    params = _port_params(np_params)
    v = tree_unflatten_like(params, [torch.from_numpy(x) for x in v_np])
    got = tree_leaves(teig.hvp(_port_model().loss_fn, params,
                               {"input_ids": torch.from_numpy(batch["input_ids"])}, None, v))
    for a, b in zip(got, want):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * scale)


def test_power_iteration_matches_jax():
    np_params, batch = _np_params(4), _batch(5)
    v0 = _jax_v0(np_params)

    def jax_eig():
        p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), np_params)
        est = jeig.Eigenvalue(max_iter=30, tol=1e-4)
        return est.compute_eigenvalue(_jax_model().loss_fn, p,
                                      {k: jnp.asarray(x) for k, x in batch.items()},
                                      jax.random.PRNGKey(0))

    want, want_leaf = _x64(jax_eig)
    params = _port_params(np_params)
    got, got_leaf = teig.Eigenvalue(max_iter=30, tol=1e-4).compute_eigenvalue(
        _port_model().loss_fn, params, {"input_ids": torch.from_numpy(batch["input_ids"])},
        None, v0=tree_unflatten_like(params, [torch.from_numpy(x) for x in v0]))
    assert got == pytest.approx(want, rel=1e-5)
    assert set(got_leaf) == set(want_leaf)
    top = max(abs(x) for x in want_leaf.values())
    for k, x in want_leaf.items():
        assert got_leaf[k] == pytest.approx(x, rel=1e-4, abs=1e-5 * top), k


def test_engine_compute_eigenvalue_matches_jax_engine():
    np_params, batch = _np_params(6), _batch(7)
    cfg = {"train_batch_size": B, "eigenvalue": {"enabled": True, "max_iter": 15,
                                                 "tol": 1e-4}}

    def jax_eig():
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1),
                                        devices=jax.devices()[:1])
        eng, *_ = deepspeed_tpu.initialize(
            model=_jax_model(), config=cfg, mesh=mesh,
            params=jax.tree_util.tree_map(jnp.asarray, np_params))
        return eng.compute_eigenvalue(batch)

    want, want_leaf = _x64(jax_eig)
    eng, *_ = ds.initialize(model=_port_model(), config=cfg, device="cpu",
                            params=_port_params(np_params))
    v0 = tree_unflatten_like(eng.state.params,
                             [torch.from_numpy(x) for x in _jax_v0(np_params)])
    got, got_leaf = eng.compute_eigenvalue(batch, v0=v0)
    assert got == pytest.approx(want, rel=1e-5)
    top = max(abs(x) for x in want_leaf.values())
    for k, x in want_leaf.items():
        assert got_leaf[k] == pytest.approx(x, rel=1e-4, abs=1e-5 * top), k
    # the default start is a seeded draw: the same estimate every call
    first = eng.compute_eigenvalue(batch)
    assert np.isfinite(first[0]) and eng.compute_eigenvalue(batch) == first


def test_flash_path_refuses_as_jax_fails():
    """S = 2048 under "auto" takes the flash kernels in both packages: JAX
    cannot differentiate its Pallas kernel forward (its jvp rule asserts),
    the port refuses with a message; the plain branch serves there."""
    S2 = 2048
    np_params = jax.tree_util.tree_map(np.asarray, jtf.init_params(
        jtf.get_config("tiny", max_seq_len=S2), jax.random.PRNGKey(0)))
    ids = np.random.RandomState(0).randint(0, 256, (1, S2)).astype(np.int32)
    jmodel = JaxCausalLM("tiny", max_seq_len=S2, dtype=jnp.float32)
    with pytest.raises(Exception):
        jeig.Eigenvalue(max_iter=1).compute_eigenvalue(
            jmodel.loss_fn, jax.tree_util.tree_map(jnp.asarray, np_params),
            {"input_ids": ids}, jax.random.PRNGKey(0))
    params = params_from_jax(np_params, device="cpu")
    with pytest.raises(NotImplementedError, match="no derivative of its own"):
        teig.Eigenvalue(max_iter=1).compute_eigenvalue(
            CausalLM("tiny", max_seq_len=S2, dtype=torch.float32).loss_fn, params,
            {"input_ids": torch.from_numpy(ids)})
    lam, _ = teig.Eigenvalue(max_iter=2).compute_eigenvalue(
        CausalLM("tiny", max_seq_len=S2, dtype=torch.float32, attn_impl="xla").loss_fn,
        params, {"input_ids": torch.from_numpy(ids[:, :256])})
    assert np.isfinite(lam)


@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_kernels_refuse_a_second_derivative(return_lse):
    """Any double backward through K1-K3 raises (a gradient penalty as
    well as the HVP), instead of treating attention as constant."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 128, 2, 16, generator=gen, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=True, return_lse=return_lse)
    out = out[0] + out[1].sum() if return_lse else out
    with pytest.raises(NotImplementedError, match="no derivative of its own"):
        torch.autograd.grad(out.square().sum(), q, create_graph=True)
    # without create_graph the first derivative is the plain version's
    (dq,) = torch.autograd.grad(out.square().sum(), q)
    assert torch.isfinite(dq).all()
