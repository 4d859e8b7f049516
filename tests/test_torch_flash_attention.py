"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in interpret mode, as tests/unit/test_flash_attention.py runs
it.  Inputs are drawn with numpy and fed to both.  fp32, atol 2e-5 (the
tolerance the JAX kernel's own tests use: only summation order differs).
Gradients go through the port's autograd Functions (whose backward runs the
plain versions of the dq and dk/dv kernels on the CPU) against ``jax.grad``
of the interpreted Pallas kernels, at atol 5e-4 (the tolerance of
tests/unit/test_flash_attention.py's gradient checks).  The CUDA kernels
themselves are checked on the card: tests/test_torch_kernels_gpu.py and
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import flash_attention as jax_fa
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.kernels import NEG_INF, mask_to_i32, pick_block
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa_module
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_reference)
from deepspeed_tpu_torch.ops.op_builder import KernelBuildError, find_nvcc

ATOL = 2e-5
GRAD_ATOL = 5e-4


def _qkv(B=2, S=128, Hq=4, Hkv=4, hd=64, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal((B, S, H, hd)).astype(np.float32)
                 for H in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_matches_jax_kernel(causal, S, Hq, Hkv):
    q, k, v = _qkv(S=S, Hq=Hq, Hkv=Hkv, seed=S + Hq)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=64, block_k=64, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_kernel(causal):
    q, k, v = _qkv(S=128, Hq=8, Hkv=2, seed=3)
    ref_out, ref_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, block_q=64, block_k=64,
                                 interpret=True, return_lse=True)
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               return_lse=True)
    assert lse.shape == (2, 8, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)


def test_custom_scale_matches_jax_kernel():
    q, k, v = _qkv(S=128, seed=5)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    sm_scale=0.3, block_q=64, block_k=64, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, sm_scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=128))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_reference(q, k, v),
                               rtol=0, atol=0)


def test_unsupported_modes_raise_cleanly():
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=128))
    with pytest.raises(NotImplementedError, match="block_mask"):
        flash_attention(q, k, v, block_mask=np.ones((2, 2), bool))
    with pytest.raises(NotImplementedError, match="bias"):
        flash_attention(q, k, v, bias=torch.zeros(1))
    q2, k2, v2 = (torch.from_numpy(a) for a in _qkv(S=100))
    with pytest.raises(NotImplementedError, match="plain path"):
        flash_attention(q2, k2, v2)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k[:, :, :3], v[:, :, :3])


def _grads_vs_jax(q, k, v, do, causal, sm_scale=None, dlse=None):
    """(port grads, JAX grads) of sum(out * do) [+ sum(lse * dlse)]."""
    with_lse = dlse is not None

    def jloss(q, k, v):
        res = jax_flash(q, k, v, causal=causal, sm_scale=sm_scale, block_q=64,
                        block_k=64, interpret=True, return_lse=with_lse)
        if with_lse:
            return jnp.sum(res[0] * do) + jnp.sum(res[1] * dlse)
        return jnp.sum(res * do)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    res = flash_attention(tq, tk, tv, causal=causal, sm_scale=sm_scale,
                          return_lse=with_lse)
    if with_lse:
        loss = (res[0] * torch.from_numpy(do)).sum() + \
            (res[1] * torch.from_numpy(dlse)).sum()
    else:
        loss = (res * torch.from_numpy(do)).sum()
    loss.backward()
    return (tq.grad, tk.grad, tv.grad), ref


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_grads_match_jax_kernel(causal, Hq, Hkv):
    q, k, v = _qkv(S=128, Hq=Hq, Hkv=Hkv, seed=11 + Hq)
    do = np.random.RandomState(12).standard_normal(q.shape).astype(np.float32)
    got, ref = _grads_vs_jax(q, k, v, do, causal)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_grads_with_custom_scale_match_jax_kernel():
    q, k, v = _qkv(S=128, Hq=8, Hkv=2, seed=13)
    do = np.random.RandomState(14).standard_normal(q.shape).astype(np.float32)
    got, ref = _grads_vs_jax(q, k, v, do, True, sm_scale=0.3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_cotangent_folds_into_delta_as_in_jax(causal):
    """``return_lse`` differentiates through lse (``_flash_lse``): a
    non-zero lse cotangent changes dq and dk, and the port folds it in as
    the JAX backward does."""
    q, k, v = _qkv(S=128, Hq=8, Hkv=2, seed=15)
    rs = np.random.RandomState(16)
    do = rs.standard_normal(q.shape).astype(np.float32)
    dlse = rs.standard_normal((2, 8, 128)).astype(np.float32)
    got, ref = _grads_vs_jax(q, k, v, do, causal, dlse=dlse)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL)
    without, _ = _grads_vs_jax(q, k, v, do, causal)
    assert (got[0] - without[0]).abs().max() > 1e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_plain_bwd_functions_match_jax_bwd(causal, Hq, Hkv):
    """The plain dq and dk/dv functions against the JAX package's ``_bwd``
    (the two Pallas kernels, interpreted) on the same residuals."""
    q, k, v = _qkv(S=128, Hq=Hq, Hkv=Hkv, seed=17 + Hq)
    do = np.random.RandomState(18).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    qt, kt, vt, dot = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do))
    out, lse = jax_fa._fwd(qt, kt, vt, scale, causal, 64, 64, True)
    dq, dk, dv = jax_fa._bwd(scale, causal, 64, 64, True,
                             (qt, kt, vt, out, lse), dot)
    o = np.asarray(jnp.swapaxes(out, 1, 2))
    delta = np.ascontiguousarray((do * o).sum(-1).transpose(0, 2, 1))
    args = [torch.from_numpy(np.array(x)) for x in
            (q, k, v, do, np.asarray(lse)[:, :, 0, :], delta)]
    rdq = flash_attention_bwd_dq_reference(*args, causal, scale)
    rdk, rdv = flash_attention_bwd_dkv_reference(*args, causal, scale)
    # the CPU wrappers are exactly the plain versions
    torch.testing.assert_close(flash_attention_bwd_dq(*args, causal, scale), rdq,
                               rtol=0, atol=0)
    for a, b in ((dq, rdq), (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(jnp.swapaxes(a, 1, 2)),
                                   atol=GRAD_ATOL)
    assert flash_attention_bwd_dkv(*args, causal, scale)[0].shape == k.shape


def test_cuda_only_path_raises_cleanly():
    """The kernel path never falls back to the plain version: its checks
    raise before any launch (block-sparse masks, fp64, head_dim, a backward
    of fp64), and without nvcc the builds raise with a message instead of a
    plain run."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(S=128))
    with pytest.raises(NotImplementedError, match="block_mask"):
        flash_attention(q, k, v, block_mask=np.ones((2, 2), bool))
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        fa_module._launch(q.double(), k.double(), v.double(), True, 0.125)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa_module._launch(q[..., :32], k[..., :32], v[..., :32], True, 0.125)
    lse = torch.zeros((2, 4, 128))
    with pytest.raises(TypeError, match="bfloat16"):
        fa_module._check_bwd(q, k, v, q, lse, lse)
    try:
        find_nvcc()
    except KernelBuildError as e:
        assert "nvcc not found" in str(e)
        for b in fa_module.builders():
            with pytest.raises(KernelBuildError):
                b.build()


def test_common_helpers():
    assert NEG_INF == -1e30
    assert pick_block(1024, 512, floor=128) == 512
    assert pick_block(4, 1024) == 4
    assert pick_block(192, 512, floor=128) == 192
    with pytest.raises(NotImplementedError):
        pick_block(192, 128, floor=128)
    assert mask_to_i32(np.array([True, False])).tolist() == [1, 0]
