"""Flash attention: the hand-written Hopper kernels, their plain PyTorch
versions and the autograd wiring (counterpart of
``deepspeed_tpu/ops/pallas/flash_attention.py``).

``flash_attention`` takes the model's layout, q ``[B,S,Hq,hd]`` and k/v
``[B,S,Hkv,hd]``, and returns ``[B,S,Hq,hd]`` (or ``(out, lse [B,Hq,S])``
with ``return_lse``).  Three kernels, each behind a wrapper that counts its
launches:

  - K1 ``flash_attention`` forward: ``ops/csrc/flash_attention_fwd.cu``;
  - K2 ``flash_attention_bwd_dq``: ``ops/csrc/flash_attention_bwd.cu``;
  - K3 ``flash_attention_bwd_dkv``: the same source.

A gradient flows through one of two ``torch.autograd.Function``s, as the
JAX package's two ``custom_vjp``s: ``_Flash`` drops the lse cotangent,
``_FlashLse`` (``return_lse=True``) folds it into ``delta``.  The backward
computes ``delta = rowsum(dO * O)`` in fp32 as a torch expression and
launches K2 then K3.  CUDA tensors launch the kernels (built by the op
builder at first use) or raise; CPU tensors run the plain versions.  There
is no fallback from one to the other.

Not ported yet: the ``block_mask`` (block-sparse) mode, which raises
``NotImplementedError`` (ROADMAP queue 1 item 8), and the backward of fp32
inputs on CUDA (the forward has a CUDA-core fp32 variant; the backward
kernels take bf16/fp16 only).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..op_builder import KernelBuilder
from .common import NEG_INF

# Query rows per CTA of the CUDA kernels: S must be a multiple (the model
# only dispatches here when S % 128 == 0).
BLOCK = 128
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_FWD_BUILDER = KernelBuilder("flash_attention_fwd", "flash_attention_fwd.cu")
_BWD_BUILDER = KernelBuilder("flash_attention_bwd", "flash_attention_bwd.cu")


def builders():
    """Every op builder of this module (``chip_smoke.py`` builds them up
    front, in parallel)."""
    return (_FWD_BUILDER, _BWD_BUILDER)


def _error_string(lib, err: int) -> str:
    lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib.ds_cuda_error_string(err).decode()


def _fwd_lib() -> ctypes.CDLL:
    lib = _FWD_BUILDER.load()
    fn = lib.ds_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _BWD_BUILDER.load()
    for fn, n_ptr in ((lib.ds_flash_attention_bwd_dq, 7),
                      (lib.ds_flash_attention_bwd_dkv, 8)):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _repeat_kv(q, k, v):
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    return k, v


def _causal_keep(S: int, device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              return_lse: bool = False):
    """The plain version of K1: einsum + mask + softmax in fp32, GQA by
    repeat, the same finite ``NEG_INF``, and P cast to the input dtype
    before P.V."""
    S, hd = q.shape[1], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k, v = _repeat_kv(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_keep(S, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _bwd_scores(q, k, v, do, lse, delta, causal, sm_scale):
    """The ``_bwd`` formulas in fp32 over [B,Hq,S,S] (GQA by repeat):
    ``p = exp(s*scale - lse)`` and ``ds = p (dp - delta) scale``."""
    S = q.shape[1]
    k, v = _repeat_kv(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_keep(S, q.device), NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.float()[..., None]) * sm_scale
    return k, p, ds


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = True,
                                     sm_scale: Optional[float] = None):
    """The plain version of K2: ``dq = ds . K`` with ds rounded to k's dtype
    (as ``_bwd_dq_kernel`` rounds it), products in fp32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kr, _, ds = _bwd_scores(q, k, v, do, lse, delta, causal, sm_scale)
    ds = ds.to(k.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", ds, kr.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                                      sm_scale: Optional[float] = None):
    """The plain version of K3: ``dv = p^T . dO`` and ``dk = ds^T . Q`` per
    query head (p, ds rounded to the input dtype as ``_bwd_dkv_kernel``
    rounds them), then summed over each GQA group."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    _, p, ds = _bwd_scores(q, k, v, do, lse, delta, causal, sm_scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(B, S, Hkv, Hq // Hkv, hd).sum(3)
    dv = dv.reshape(B, S, Hkv, Hq // Hkv, hd).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

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


def _check_launch(dtypes=_DTYPE_CODES, **tensors):
    """Device, dtype, head_dim and layout checks before any launch."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{', '.join(tensors)} on different devices: {devices}")
    kinds = {t.dtype for name, t in tensors.items() if name not in ("lse", "delta")}
    if len(kinds) != 1 or next(iter(kinds)) not in dtypes:
        raise TypeError(
            f"the flash kernels take {'/'.join(str(d).replace('torch.', '') for d in dtypes)}"
            f", all alike; got {', '.join(f'{n} {t.dtype}' for n, t in tensors.items())}")
    hd = tensors["q"].shape[-1]
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


_BWD_DTYPES = {torch.float16: 1, torch.bfloat16: 2}


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(q, k, v, causal: bool, sm_scale: float):
    """K1: returns (out, lse)."""
    _check_launch(q=q, k=k, v=v)
    B, S, Hq, hd = q.shape
    lib = _fwd_lib()
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, Hq, k.shape[2], hd, _DTYPE_CODES[q.dtype],
            int(causal), float(sm_scale), _stream(q.device))
    if err:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           + _error_string(lib, err))
    flash_attention.launches += 1
    return out, lse


def _check_bwd(q, k, v, do, lse, delta):
    _check_launch(dtypes=_BWD_DTYPES, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    B, S, Hq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, Hq, S):
            raise ValueError(f"{name} must be float32 [B,Hq,S]={(B, Hq, S)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           sm_scale: Optional[float] = None):
    """K2: dq [B,S,Hq,hd] from q, k, v, dO and the fp32 lse/delta
    [B,Hq,S].  CUDA tensors launch the kernel (``.launches`` counts the
    launches); CPU tensors run :func:`flash_attention_bwd_dq_reference`."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                                sm_scale)
    _check_bwd(q, k, v, do, lse, delta)
    B, S, Hq, hd = q.shape
    lib = _bwd_lib()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, Hq,
            k.shape[2], hd, _BWD_DTYPES[q.dtype], int(causal), float(sm_scale),
            _stream(q.device))
    if err:
        raise RuntimeError("flash_attention_bwd_dq launch failed: "
                           + _error_string(lib, err))
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            sm_scale: Optional[float] = None):
    """K3: (dk, dv) [B,S,Hkv,hd], the GQA group summed in the kernel.  CUDA
    tensors launch the kernel (``.launches``); CPU tensors run
    :func:`flash_attention_bwd_dkv_reference`."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                                 sm_scale)
    _check_bwd(q, k, v, do, lse, delta)
    B, S, Hq, hd = q.shape
    lib = _bwd_lib()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
            Hq, k.shape[2], hd, _BWD_DTYPES[q.dtype], int(causal),
            float(sm_scale), _stream(q.device))
    if err:
        raise RuntimeError("flash_attention_bwd_dkv launch failed: "
                           + _error_string(lib, err))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

def _forward(q, k, v, causal: bool, sm_scale: float):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale, True)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash kernel for device {q.device}")
    return _launch(q, k, v, causal, sm_scale)


def _backward(ctx, do, dlse=None):
    """``_bwd``: delta = rowsum(dO * O) in fp32 (minus dlse when lse is
    differentiable), then K2 and K3."""
    q, k, v, out, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if dlse is not None:
        # d s_ij = p_ij (dp_ij - delta_i) + p_ij dlse_i: a shifted delta
        delta = delta - dlse.float()
    args = (q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv, None, None


class _Flash(torch.autograd.Function):
    """``_flash``: (out, lse) with the lse cotangent dropped (lse is only a
    residual of the backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        return _backward(ctx, do)


class _FlashLse(torch.autograd.Function):
    """``_flash_lse``: lse is a real output whose cotangent folds into
    delta (the ring-attention merge differentiates through it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, bias=None,
                    block_mask=None, return_lse: bool = False):
    """q [B,S,Hq,hd], k/v [B,S,Hkv,hd] -> [B,S,Hq,hd]
    (or ``(out, lse [B,Hq,S])`` with ``return_lse``).

    CUDA tensors launch the kernels (``flash_attention.launches`` counts
    the forward's launches); CPU tensors take the plain versions.  With
    gradients enabled the call records one of the autograd Functions.
    """
    if bias is not None:
        raise NotImplementedError("bias is handled by the plain attention path")
    if block_mask is not None:
        raise NotImplementedError(
            "block_mask (block-sparse attention) is not ported yet "
            "(ROADMAP queue 1, item 8)")
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sm_scale = float(sm_scale)
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        out, lse = _forward(q, k, v, causal, sm_scale)
        return (out, lse) if return_lse else out
    if q.device.type == "cuda" and q.dtype not in _BWD_DTYPES:
        raise NotImplementedError(
            f"the flash backward kernels take bfloat16/float16, not {q.dtype} "
            "(ROADMAP queue 2): run fp32 training through the plain branch")
    fn = _FlashLse if return_lse else _Flash
    out, lse = fn.apply(q, k, v, causal, sm_scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
