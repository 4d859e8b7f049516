"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip on a host without a CUDA card.  This file imports
no jax (the GPU machine has none), so it runs there on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``-rP`` also shows each comparison's readings.)
"""
import json

import pytest
import torch

from chip_smoke import AGREE_TOL, LSE_ATOL, agreement
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_reference)

# bf16 autograd against an fp32 autograd of the plain forward, which rounds
# neither P nor dS: worst tile 3.0e-3 and per-element need 0.033 on the H100
VS_FP32_TOL = {"tile_rel": 1e-2, "elem_rtol": 2e-2, "elem_atol_rms": 0.1}


def assert_agrees(got, ref, tol):
    """``chip_smoke.agreement``: the worst 128-row tile's relative error and
    a per-element bound, within ``tol``.  The readings are printed (shown
    with ``-rP``) for setting the limits."""
    reading = agreement(got, ref, tol)
    print(json.dumps(reading))
    assert reading["ok"], reading


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest --noconftest "
                    "-m gpu tests/test_torch_kernels_gpu.py` on the GPU machine")
    return torch.device("cuda")


def _inputs(B, S, Hq, Hkv, hd, dt, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
                 for H in (Hq, Hkv, Hkv, Hq))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_forward_matches_plain_version(cuda, dtype, hd, causal):
    dt = getattr(torch, dtype)
    q, k, v, _ = _inputs(2, 256, 8, 2, hd, dt)
    with torch.inference_mode():
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref, ref_lse = flash_attention_reference(q, k, v, causal, None, True)
    assert_agrees(out, ref, AGREE_TOL["fwd"][dt])
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_flash_backward_kernels_match_plain_versions(cuda, Hq, Hkv, hd, dtype,
                                                     causal):
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(2, 384, Hq, Hkv, hd, dt, seed=hd + Hq)
    with torch.inference_mode():
        out, lse = flash_attention_reference(q, k, v, causal, None, True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        n2, n3 = flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        assert flash_attention_bwd_dq.launches == n2 + 1
        assert flash_attention_bwd_dkv.launches == n3 + 1
        rq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal)
        rk, rv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dt and got.shape == ref.shape
        assert_agrees(got, ref, AGREE_TOL["bwd"][dt])


@pytest.mark.gpu
def test_flash_autograd_launches_each_kernel_once(cuda):
    q, k, v, do = _inputs(1, 256, 8, 2, 128, torch.bfloat16, seed=3)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    counts = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    out = flash_attention(q, k, v)
    out.backward(do.transpose(1, 2).contiguous().transpose(1, 2))   # strided dO
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    qr, kr, vr = (x.detach().float().requires_grad_() for x in (q, k, v))
    flash_attention_reference(qr, kr, vr).backward(do.float())
    for got, ref in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        assert_agrees(got, ref, VS_FP32_TOL)


@pytest.mark.gpu
def test_flash_forward_refuses_what_it_cannot_run(cuda):
    q = torch.randn((1, 128, 2, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="block_mask"):
        flash_attention(q, q, q, block_mask=torch.ones((2, 2), dtype=torch.bool))
    f = q.float().requires_grad_()
    with pytest.raises(NotImplementedError, match="bfloat16/float16"):
        flash_attention(f, f, f)
    lse = torch.zeros((1, 2, 128), device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_bwd_dq(q.float(), q.float(), q.float(), q.float(), lse, lse)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.randn((1, 2, 128, 128), device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dkv(q, q, q, q, lse[:, :1], lse)
