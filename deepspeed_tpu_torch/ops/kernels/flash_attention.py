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
launches K2 then K3.  ``_Flash`` keeps q, k, v, out and lse with
``save_for_backward`` and returns out in the model's layout, so the
attention output a remat policy names (``attn_out``) is the residual
itself: called outside a checkpoint (``save_qkv``, ``save_matmuls`` in
``models/transformer.py``) the backward finds all five kept and K1 runs
once; inside one, the recompute runs K1 again.  CUDA tensors launch the kernels (built by the op
builder at first use) or raise; CPU tensors run the plain versions.  There
is no fallback from one to the other.

Block-sparse mode (``block_mask``, what ``ops/sparse_attention`` drives): a
bool ``[S/block_q, S/block_k]`` grid of live blocks, ANDed with causal.  As
in the JAX package, ``block_q``/``block_k`` set that grid (one tile size
each, at most 1024) and the mask must match it.  The kernels' own tiles
are fixed, so the wrapper turns the mask into each kernel's live-tile
table (``live_tile_tables``, built once per layout, length and device): a
CTA walks only its live tiles, and tests the mask element by element only
in tiles that are partly live.  A row with no live key gives out 0, lse
``NEG_INF`` and no gradient, as the Pallas kernels give (they never run a
dead block).  ``return_lse`` with a mask raises, as in JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..op_builder import KernelBuilder
from .common import NEG_INF, cost_sinks, first_derivative_only, note_cost, pick_block

# Query rows per CTA of the CUDA kernels: S must be a multiple (the model
# only dispatches here when S % 128 == 0).
BLOCK = 128
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# The JAX package's default tiles (``DEFAULT_BLOCK_Q``/``_K``); with a
# block mask they set its grid, capped at MAX_MASK_BLOCK.  Without one they
# change nothing here: the CUDA tiles are fixed.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 2048
MAX_MASK_BLOCK = 1024

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


# Each entry point takes its tensors' pointers, then the four pointers of a
# live-tile table (null when unmasked), then B, S, Hq, Hkv, hd, dtype,
# causal, the scale and the stream.
def _fwd_lib() -> ctypes.CDLL:
    lib = _FWD_BUILDER.load()
    fn = lib.ds_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _BWD_BUILDER.load()
    for fn, n_ptr in ((lib.ds_flash_attention_bwd_dq, 7 + 4),
                      (lib.ds_flash_attention_bwd_dkv, 8 + 4)):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Block masks
# ---------------------------------------------------------------------------

def _as_block_mask(block_mask, S: int) -> Optional[torch.Tensor]:
    """A block mask (numpy, nested lists or a tensor on any device) as a
    contiguous bool tensor on the CPU whose grid divides S; None stays
    None."""
    if block_mask is None:
        return None
    if isinstance(block_mask, torch.Tensor):
        bm = block_mask.detach().to("cpu", torch.bool).contiguous()
    else:
        bm = torch.from_numpy(np.ascontiguousarray(np.asarray(block_mask, dtype=bool)))
    if bm.dim() != 2 or S % bm.shape[0] or S % bm.shape[1]:
        raise ValueError(f"block_mask shape {tuple(bm.shape)} is not a block grid "
                         f"of S={S}")
    return bm


def attended(S: int, causal: bool, block_mask=None, device=None):
    """The bool ``[S, S]`` of attended (query, key) pairs: causal AND the
    block mask expanded element by element; None when every pair is."""
    keep = (torch.ones(S, S, dtype=torch.bool, device=device).tril()
            if causal else None)
    bm = _as_block_mask(block_mask, S)
    if bm is not None:
        e = bm.to(device).repeat_interleave(S // bm.shape[0], 0) \
              .repeat_interleave(S // bm.shape[1], 1)
        keep = e if keep is None else keep & e
    return keep


# Tiles of each CUDA kernel's loop, (rows of the CTA's own axis, rows of the
# axis it walks), by table name: K1 (bf16/fp16) walks 128-key tiles of a
# 128-row query tile (``BLOCK_M``/``BLOCK_N`` of flash_attention_fwd.cu), K2
# 64-key tiles of a 128-row query tile, the fp32 variants of K1 and K2
# 64-key tiles of a 64-row query tile, K3 64-row query tiles of a 128-key
# tile, K3's fp32 variant 64-row query tiles of a 64-key tile.  The tables
# of K3 ("kv", "f32kv") run along the keys: their rows are keys.
_TILES = {"fwd": (128, 128), "q": (128, 64), "f32": (64, 64), "kv": (128, 64),
          "f32kv": (64, 64)}
_KEY_ROWS = ("kv", "f32kv")
_GROUP = 8      # the tables' granularity: live 8x8 element groups
# least recently used tables, by (layout, S, causal, device)
_TABLE_CACHE: "OrderedDict[tuple, Dict[str, TileTable]]" = OrderedDict()
_TABLE_CACHE_SIZE = 16
_TABLE_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True, eq=False)
class TileTable:
    """One kernel's live tiles in CSR form, int32 on the device: CTA tile
    ``t`` visits the other axis' tiles ``idx[off[t]:off[t + 1]]``
    (ascending); ``bits[e]`` holds entry ``e``'s live 8x8 element groups,
    one bit each, row group major, in 32-bit words; ``order`` lists the CTA
    tiles longest list first (the launch order)."""
    off: torch.Tensor
    idx: torch.Tensor
    bits: torch.Tensor
    order: torch.Tensor

    def ptrs(self):
        return (self.off.data_ptr(), self.idx.data_ptr(), self.bits.data_ptr(),
                self.order.data_ptr())

    def partial_share(self) -> float:
        """Share of the visited tiles that are only partly live."""
        if not self.idx.numel():
            return 0.0
        return (self.bits != -1).any(-1).float().mean().item()


def _table(groups: torch.Tensor, rows: int, cols: int) -> TileTable:
    gr, gc = rows // _GROUP, cols // _GROUP
    n_r, n_c = groups.shape[0] // gr, groups.shape[1] // gc
    tiles = groups.reshape(n_r, gr, n_c, gc).transpose(1, 2).reshape(n_r, n_c, gr * gc)
    live = tiles.any(-1)
    counts = live.sum(1)
    off = torch.zeros(n_r + 1, dtype=torch.int64, device=groups.device)
    off[1:] = counts.cumsum(0)
    r, c = live.nonzero(as_tuple=True)             # row major: idx ascending
    bits = tiles[r, c].reshape(-1, gr * gc // 32, 32).long()
    words = (bits << torch.arange(32, device=groups.device)).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    order = torch.argsort(counts, descending=True, stable=True)
    return TileTable(off.int(), c.int().contiguous(), words.int().contiguous(),
                     order.int())


def live_tile_tables(block_mask, S: int, causal: bool, device) -> Dict[str, TileTable]:
    """The kernels' live-tile tables of a block mask at length S (``"fwd"``:
    K1; ``"q"``: K2; ``"f32"``: the fp32 variants of K1 and K2; ``"kv"``:
    K3; ``"f32kv"``: K3's fp32 variant), built on
    ``device`` at first use and cached per (layout, S, causal, device)."""
    bm = _as_block_mask(block_mask, S)
    device = torch.device(device)
    key = (tuple(bm.shape), np.packbits(bm.numpy()).tobytes(), S, bool(causal),
           str(device))
    with _TABLE_LOCK:
        tables = _TABLE_CACHE.get(key)
        if tables is not None:
            _TABLE_CACHE.move_to_end(key)
            return tables
    bq, bk = S // bm.shape[0], S // bm.shape[1]
    if bq % _GROUP or bk % _GROUP:
        raise NotImplementedError(
            f"mask blocks of {bq}x{bk}: the CUDA kernels take blocks that are "
            f"multiples of {_GROUP}")
    groups = bm.to(device).repeat_interleave(bq // _GROUP, 0) \
               .repeat_interleave(bk // _GROUP, 1)
    if causal:
        groups = groups & torch.ones_like(groups).tril()
    tables = {name: _table(groups.t() if name in _KEY_ROWS else groups, *tile)
              for name, tile in _TILES.items()}
    with _TABLE_LOCK:
        _TABLE_CACHE[key] = tables
        if len(_TABLE_CACHE) > _TABLE_CACHE_SIZE:
            _TABLE_CACHE.popitem(last=False)
    return tables


def _table_ptrs(block_mask, S, causal, device, name):
    if block_mask is None:
        return (None,) * 4
    return live_tile_tables(block_mask, S, causal, device)[name].ptrs()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _repeat_kv(q, k, v):
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    return k, v


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              return_lse: bool = False, block_mask=None):
    """The plain version of K1: einsum + mask + softmax in fp32 (fp64 for
    fp64 inputs), GQA by repeat, the same finite ``NEG_INF``, and P cast to
    the input dtype before P.V.  With ``block_mask`` (its grid divides S) a row with no
    live key gives out 0 and lse ``NEG_INF``, as the kernels do, not the
    uniform row a softmax over ``NEG_INF`` would give."""
    S, hd = q.shape[1], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k, v = _repeat_kv(q, k, v)
    wide = _wide(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), k.to(wide)) * sm_scale
    keep = attended(S, causal, block_mask, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    if block_mask is not None:
        dead = ~keep.any(-1)
        p = p.masked_fill(dead[:, None], 0.0)
        if return_lse:
            lse = lse.masked_fill(dead, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
    return (out, lse) if return_lse else out


def _wide(q) -> torch.dtype:
    """The plain versions' arithmetic: fp32, or fp64 for fp64 inputs."""
    return torch.promote_types(q.dtype, torch.float32)


def _bwd_scores(q, k, v, do, lse, delta, causal, sm_scale, block_mask=None):
    """The ``_bwd`` formulas in fp32 (fp64 for fp64) over [B,Hq,S,S] (GQA by repeat):
    ``p = exp(s*scale - lse)`` and ``ds = p (dp - delta) scale``.  With a
    block mask every masked pair's p is set to 0: a dead row's lse is
    ``NEG_INF``, where ``exp(s - lse)`` would be 1."""
    S = q.shape[1]
    k, v = _repeat_kv(q, k, v)
    wide = _wide(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), k.to(wide)) * sm_scale
    keep = attended(S, causal, block_mask, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse.to(wide)[..., None])
    if block_mask is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(wide), v.to(wide))
    ds = p * (dp - delta.to(wide)[..., None]) * sm_scale
    return k, p, ds


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = True,
                                     sm_scale: Optional[float] = None,
                                     block_mask=None):
    """The plain version of K2: ``dq = ds . K`` with ds rounded to k's dtype
    (as ``_bwd_dq_kernel`` rounds it), products in fp32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kr, _, ds = _bwd_scores(q, k, v, do, lse, delta, causal, sm_scale, block_mask)
    wide = _wide(q)
    ds = ds.to(k.dtype).to(wide)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kr.to(wide)).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                                      sm_scale: Optional[float] = None,
                                      block_mask=None):
    """The plain version of K3: ``dv = p^T . dO`` and ``dk = ds^T . Q`` per
    query head (p, ds rounded to the input dtype as ``_bwd_dkv_kernel``
    rounds them), then summed over each GQA group."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    _, p, ds = _bwd_scores(q, k, v, do, lse, delta, causal, sm_scale, block_mask)
    wide = _wide(q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(wide), do.to(wide))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(wide), q.to(wide))
    dk = dk.reshape(B, S, Hkv, Hq // Hkv, hd).sum(3)
    dv = dv.reshape(B, S, Hkv, Hq // Hkv, hd).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

# the tensor-core products each kernel runs over every attended (query,
# key) pair: the forward 2 (QK^T, PV), K2 3 (QK^T, dO V^T, dS K), K3 4 (the
# same two scores, P^T dO, dS^T Q)
GEMMS = {"fwd": 2, "dq": 3, "dkv": 4}


def attended_pairs(S: int, causal: bool, block_mask=None) -> int:
    """How many (query, key) pairs a row block attends: all, the causal
    triangle, or the live elements of a block mask (ANDed with causal)."""
    if block_mask is not None:
        return int(attended(S, causal, block_mask).sum())
    return S * (S + 1) // 2 if causal else S * S


def kernel_cost(kernel: str, B: int, S: int, Hq: int, Hkv: int, hd: int,
                esize: int, pairs: int) -> tuple:
    """(operations, bytes) of one launch of ``kernel`` ("fwd", "dq",
    "dkv"): ``GEMMS[kernel] * 2 * B * Hq * pairs * hd`` operations; bytes
    with each input read once and each output written once (q-sized
    tensors q, dO, out, dq; k/v-sized k, v, dk, dv; the fp32 lse/delta rows
    [B, Hq, S])."""
    q_bytes, kv_bytes, row_bytes = (esize * B * S * Hq * hd, esize * B * S * Hkv * hd,
                                    4 * B * Hq * S)
    nbytes = {"fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,       # q,k,v -> out,lse
              "dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,     # q,k,v,dO,lse,delta -> dq
              "dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes}[kernel]   # ... -> dk,dv
    return GEMMS[kernel] * 2.0 * B * Hq * pairs * hd, float(nbytes)


def _note_launch(name: str, kernel: str, q, k, causal: bool, block_mask) -> None:
    if cost_sinks:
        B, S, Hq, hd = q.shape
        note_cost(name, *kernel_cost(kernel, B, S, Hq, k.shape[2], hd, q.element_size(),
                                     attended_pairs(S, causal, block_mask)))


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


def _check_launch(**tensors):
    """Device, dtype, head_dim and layout checks before any launch."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{', '.join(tensors)} on different devices: {devices}")
    kinds = {t.dtype for name, t in tensors.items() if name not in ("lse", "delta")}
    if len(kinds) != 1 or next(iter(kinds)) not in _DTYPE_CODES:
        raise TypeError(
            f"the flash kernels take {'/'.join(str(d).replace('torch.', '') for d in _DTYPE_CODES)}"
            f", all alike; got {', '.join(f'{n} {t.dtype}' for n, t in tensors.items())}")
    hd = tensors["q"].shape[-1]
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(q, k, v, causal: bool, sm_scale: float, block_mask=None):
    """K1: returns (out, lse)."""
    _check_launch(q=q, k=k, v=v)
    B, S, Hq, hd = q.shape
    table = _table_ptrs(block_mask, S, causal, q.device,
                        "f32" if q.dtype == torch.float32 else "fwd")
    lib = _fwd_lib()
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *table, B, S, Hq, k.shape[2], hd,
            _DTYPE_CODES[q.dtype], int(causal), float(sm_scale), _stream(q.device))
    if err:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           + _error_string(lib, err))
    flash_attention.launches += 1
    _note_launch("flash_attention", "fwd", q, k, causal, block_mask)
    return out, lse


def _check_bwd(q, k, v, do, lse, delta):
    _check_launch(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    B, S, Hq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, Hq, S):
            raise ValueError(f"{name} must be float32 [B,Hq,S]={(B, Hq, S)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           sm_scale: Optional[float] = None, block_mask=None):
    """K2: dq [B,S,Hq,hd] from q, k, v, dO and the fp32 lse/delta
    [B,Hq,S], over the live blocks of ``block_mask`` when given (its grid
    divides S).  CUDA tensors launch the kernel (``.launches`` counts the
    launches); CPU tensors run :func:`flash_attention_bwd_dq_reference`."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                                sm_scale, block_mask)
    _check_bwd(q, k, v, do, lse, delta)
    B, S, Hq, hd = q.shape
    table = _table_ptrs(block_mask, S, causal, q.device,
                        "f32" if q.dtype == torch.float32 else "q")
    lib = _bwd_lib()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *table, B, S, Hq,
            k.shape[2], hd, _DTYPE_CODES[q.dtype], int(causal), float(sm_scale),
            _stream(q.device))
    if err:
        raise RuntimeError("flash_attention_bwd_dq launch failed: "
                           + _error_string(lib, err))
    flash_attention_bwd_dq.launches += 1
    _note_launch("flash_attention_bwd_dq", "dq", q, k, causal, block_mask)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            sm_scale: Optional[float] = None, block_mask=None):
    """K3: (dk, dv) [B,S,Hkv,hd], the GQA group summed in the kernel, over
    the live blocks of ``block_mask`` when given.  CUDA tensors launch the
    kernel (``.launches``); CPU tensors run
    :func:`flash_attention_bwd_dkv_reference`."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                                 sm_scale, block_mask)
    _check_bwd(q, k, v, do, lse, delta)
    B, S, Hq, hd = q.shape
    table = _table_ptrs(block_mask, S, causal, q.device,
                        "f32kv" if q.dtype == torch.float32 else "kv")
    lib = _bwd_lib()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *table, B, S, Hq, k.shape[2], hd, _DTYPE_CODES[q.dtype], int(causal),
            float(sm_scale), _stream(q.device))
    if err:
        raise RuntimeError("flash_attention_bwd_dkv launch failed: "
                           + _error_string(lib, err))
    flash_attention_bwd_dkv.launches += 1
    _note_launch("flash_attention_bwd_dkv", "dkv", q, k, causal, block_mask)
    return dk, dv


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

def _forward(q, k, v, causal: bool, sm_scale: float, block_mask=None):
    """(out, lse) through K1 on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale, True, block_mask)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash kernel for device {q.device}")
    return _launch(q, k, v, causal, sm_scale, block_mask)


def _backward(ctx, do, dlse=None):
    """``_bwd``: delta = rowsum(dO * O) in fp32 (minus dlse when lse is
    differentiable), then K2 and K3.  Returns (dq, dk, dv)."""
    q, k, v, out, lse = ctx.saved_tensors
    do = do.contiguous()
    wide = _wide(q)
    delta = (do.to(wide) * out.to(wide)).sum(-1).transpose(1, 2).contiguous()
    if dlse is not None:
        # d s_ij = p_ij (dp_ij - delta_i) + p_ij dlse_i: a shifted delta
        delta = delta - dlse.to(wide)
    args = (q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale, ctx.block_mask)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv


_NO_SECOND = (
    "the flash kernels: their backward is a kernel with no derivative of its "
    "own (the JAX package fails here too, at jvp of its Pallas kernel); compute "
    "the Hessian with attn_impl='xla', or under 'auto' at sequences shorter than "
    "2048")


class _Flash(torch.autograd.Function):
    """``_flash``: (out, lse) with the lse cotangent dropped (lse is only a
    residual of the backward); the block mask rides along as a
    non-differentiable argument."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_mask):
        out, lse = _forward(q, k, v, causal, sm_scale, block_mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.block_mask = causal, sm_scale, block_mask
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @first_derivative_only(_NO_SECOND)
    def backward(ctx, do, _dlse):
        return (*_backward(ctx, do), None, None, None)


class _FlashLse(torch.autograd.Function):
    """``_flash_lse``: lse is a real output whose cotangent folds into
    delta (the ring-attention merge differentiates through it).  No block
    mask, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.block_mask = causal, sm_scale, None
        return out, lse

    @staticmethod
    @first_derivative_only(_NO_SECOND)
    def backward(ctx, do, dlse):
        return (*_backward(ctx, do, dlse), None, None)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, bias=None,
                    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
                    block_mask=None, return_lse: bool = False):
    """q [B,S,Hq,hd], k/v [B,S,Hkv,hd] -> [B,S,Hq,hd]
    (or ``(out, lse [B,Hq,S])`` with ``return_lse``).

    ``block_mask`` (bool ``[S/block_q, S/block_k]``, numpy or tensor) skips
    dead blocks in forward and backward; ``block_q``/``block_k`` set its
    grid as in the JAX package (``pick_block(S, min(block, 1024))``) and a
    mask of another shape raises ``ValueError``.  CUDA tensors launch the
    kernels (``flash_attention.launches`` counts the forward's launches);
    CPU tensors take the plain versions.  With gradients enabled the call
    records one of the autograd Functions.
    """
    if bias is not None:
        raise NotImplementedError("bias is handled by the plain attention path")
    if any(hasattr(t, "placements") for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on DTensors (a generic model under a model axis "
            "above 1) runs per shard through local_map, which is not ported yet "
            "(ROADMAP queue 1, item 4)")
    _check(q, k, v)
    S = q.shape[1]
    if block_mask is not None:
        block_q = pick_block(S, min(block_q, MAX_MASK_BLOCK))
        block_k = pick_block(S, min(block_k, MAX_MASK_BLOCK))
        want = (S // block_q, S // block_k)
        shape = tuple(np.shape(block_mask))
        if shape != want:
            raise ValueError(
                f"block_mask shape {shape} does not match the block grid "
                f"{want} (S={S}, block_q={block_q}, block_k={block_k})")
        if return_lse:
            raise NotImplementedError("return_lse + block_mask")
        block_mask = _as_block_mask(block_mask, S)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sm_scale = float(sm_scale)
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        out, lse = _forward(q, k, v, causal, sm_scale, block_mask)
        return (out, lse) if return_lse else out
    if return_lse:
        return _FlashLse.apply(q, k, v, causal, sm_scale)
    out, _ = _Flash.apply(q, k, v, causal, sm_scale, block_mask)
    return out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
