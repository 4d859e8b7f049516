"""Flash attention forward: the hand-written Hopper kernel and its plain
PyTorch version (counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``).

``flash_attention`` takes the model's layout, q ``[B,S,Hq,hd]`` and k/v
``[B,S,Hkv,hd]``, and returns ``[B,S,Hq,hd]`` (or ``(out, lse [B,Hq,S])``
with ``return_lse``).  For CUDA tensors it launches
``ops/csrc/flash_attention_fwd.cu`` (built by the op builder at first use)
or raises; for CPU tensors it runs :func:`flash_attention_reference`.
There is no fallback from one to the other.

Not ported yet: the backward kernels (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) and the ``block_mask`` (block-sparse) mode — both
raise ``NotImplementedError`` (ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..op_builder import KernelBuilder
from .common import NEG_INF

# Query rows per CTA of the CUDA kernel: S must be a multiple (the model
# only dispatches here when S % 128 == 0).
BLOCK = 128
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_BUILDER = KernelBuilder("flash_attention_fwd", "flash_attention_fwd.cu")


def builder() -> KernelBuilder:
    """The op builder for this kernel (``chip_smoke.py`` builds it up front)."""
    return _BUILDER


def _lib() -> ctypes.CDLL:
    lib = _BUILDER.load()
    fn = lib.ds_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              return_lse: bool = False):
    """The plain version: einsum + mask + softmax in fp32, GQA by repeat,
    the same finite ``NEG_INF``, and P cast to the input dtype before P.V."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _check(q, k, v):
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("flash_attention takes q [B,S,Hq,hd], k/v [B,S,Hkv,hd]")
    B, S, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if S % BLOCK:
        # mirrors pick_block's refusal: the caller takes its plain path
        raise NotImplementedError(
            f"S={S} is not a multiple of the {BLOCK}-row tile; use the plain path")


def _launch(q, k, v, causal: bool, sm_scale: float):
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32/float16/bfloat16, all "
                        f"alike; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, Hq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention backward (K2/K3) is not ported yet: run under "
            "torch.no_grad()/inference_mode (ROADMAP queue 2)")
    lib = _lib()
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ds_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, Hq, k.shape[2], hd, _DTYPE_CODES[q.dtype],
            int(causal), float(sm_scale), stream)
    if err:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           + lib.ds_cuda_error_string(err).decode())
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, bias=None,
                    block_mask=None, return_lse: bool = False):
    """q [B,S,Hq,hd], k/v [B,S,Hkv,hd] -> [B,S,Hq,hd]
    (or ``(out, lse [B,Hq,S])`` with ``return_lse``).

    CUDA tensors launch the kernel (``flash_attention.launches`` counts the
    launches); CPU tensors take :func:`flash_attention_reference`.
    """
    if bias is not None:
        raise NotImplementedError("bias is handled by the plain attention path")
    if block_mask is not None:
        raise NotImplementedError(
            "block_mask (block-sparse attention) is not ported yet "
            "(ROADMAP queue 2, sparse-attention slice)")
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale, return_lse)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash kernel for device {q.device}")
    out, lse = _launch(q, k, v, causal, sm_scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
