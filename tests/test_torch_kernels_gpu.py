"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip on a host without a CUDA card.  This file imports
no jax (the GPU machine has none), so it runs there on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest --noconftest "
                    "-m gpu tests/test_torch_kernels_gpu.py` on the GPU machine")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_forward_matches_plain_version(cuda, dtype, hd, causal):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 256, H, hd), generator=g, device="cuda").to(dt)
               for H in (8, 2, 2))
    with torch.inference_mode():
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref, ref_lse = flash_attention_reference(q, k, v, causal, None, True)
    # bf16/fp16: P is rounded before P.V and sums run in another order
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_flash_forward_refuses_what_it_cannot_run(cuda):
    q = torch.randn((1, 128, 2, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="block_mask"):
        flash_attention(q, q, q, block_mask=torch.ones((2, 2), dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(q.requires_grad_(), q, q)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.randn((1, 2, 128, 128), device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)
        flash_attention(x, x, x)
