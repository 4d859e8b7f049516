"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in interpret mode, as tests/unit/test_flash_attention.py runs
it.  Inputs are drawn with numpy and fed to both.  fp32, atol 2e-5 (the
tolerance the JAX kernel's own tests use: only summation order differs).
The CUDA kernel itself is checked on the card: tests/test_torch_kernels_gpu.py
and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.kernels import NEG_INF, mask_to_i32, pick_block
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa_module
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from deepspeed_tpu_torch.ops.op_builder import KernelBuildError, find_nvcc

ATOL = 2e-5


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


def test_cuda_only_path_raises_cleanly():
    """The kernel path never falls back to the plain version: its checks
    raise before any launch (a backward is not ported; fp64 is refused), and
    without nvcc the build raises with a message instead of a plain run."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(S=128))
    with pytest.raises(NotImplementedError, match="backward"):
        fa_module._launch(q, k, v, True, 0.125)
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        fa_module._launch(q.double(), k.double(), v.double(), True, 0.125)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa_module._launch(q[..., :32], k[..., :32], v[..., :32], True, 0.125)
    try:
        find_nvcc()
    except KernelBuildError as e:
        assert "nvcc not found" in str(e)
        with pytest.raises(KernelBuildError):
            fa_module.builder().build()



def test_common_helpers():
    assert NEG_INF == -1e30
    assert pick_block(1024, 512, floor=128) == 512
    assert pick_block(4, 1024) == 4
    assert pick_block(192, 512, floor=128) == 192
    with pytest.raises(NotImplementedError):
        pick_block(192, 128, floor=128)
    assert mask_to_i32(np.array([True, False])).tolist() == [1, 0]
