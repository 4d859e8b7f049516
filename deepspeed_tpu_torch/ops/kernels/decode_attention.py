"""Paged decode attention: the hand-written Hopper kernel K4, its plain
PyTorch version and its launch counter (counterpart of the retired Pallas
``flash_decode`` in ``tools/retired_decode_attention.py``).

``decode_attention(q, k, v, mask, page_table=None)`` attends one query token
per row, q ``[B, Hq, hd]``, to that row's keys and returns ``[B, Hq, hd]``:

  - with ``page_table`` (int32 ``[B, maxp]``), k/v are one layer's pools
    ``[P, page, Hkv, hd]`` read in place: key ``t`` of row ``b`` is pool row
    ``page_table[b, t // page] * page + t % page``.  Several rows may map
    the same page (prefix sharing);
  - without it, k/v are contiguous caches ``[B, T, Hkv, hd]`` (the same
    call with the identity table).

``mask`` is ``[B, T]`` (bool or int; nonzero = attendable) with ``T <= maxp
* page``.  Every row must attend at least one key: a row with none is
outside the contract, and the kernel (zeros) and the plain version (the
mean of the masked values) need not agree there.

CUDA tensors launch ``ops/csrc/decode_attention.cu`` (built by the op
builder at first use; ``decode_attention.launches`` counts the launches) or
raise; CPU tensors run :func:`decode_attention_reference`.  The wrapper
allocates its output, launches on the current stream and never
synchronises, so a CUDA graph can capture it.  The kernel splits each
(slot, KV head)'s keys over a thread-block cluster: tiles of ``rows`` keys
inside one page, tile ``j`` to cluster rank ``j % nsplit``
(:func:`split_plan`, :func:`key_tiles`), each rank's online-softmax state
merged in rank order; :func:`decode_attention_split_reference` repeats that
arithmetic for the tests.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..op_builder import KernelBuilder
from .common import NEG_INF, mask_to_i32

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)          # query heads per KV head the kernel is built for
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_BUILDER = KernelBuilder("decode_attention", "decode_attention.cu")
# the kernel's tiling (decode_attention.cu): a tile holds at most TILE_BYTES
# of K and MAX_ROWS keys of one page; clusters of up to MAX_SPLIT CTAs
TILE_BYTES, MAX_ROWS, MAX_SPLIT = 8 * 1024, 64, 8


def builders():
    """The op builder of this module (``chip_smoke.py`` builds every source
    up front, in parallel)."""
    return (_BUILDER,)


def _lib() -> ctypes.CDLL:
    lib = _BUILDER.load()
    fn = lib.ds_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _as_pool(k, v, page_table):
    """(k, v, page_table) in the pool form: a contiguous cache [B, T, Hkv,
    hd] becomes B pages of T rows with the identity table."""
    if page_table is not None:
        return k, v, page_table
    B = k.shape[0]
    return k, v, torch.arange(B, dtype=torch.int32, device=k.device)[:, None]


def _check(q, k, v, mask, page_table):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention takes q [B,Hq,hd] and k/v pools "
                         f"[P,page,Hkv,hd]; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, hd = q.shape
    page, Hkv = k.shape[1], k.shape[2]
    if k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not [B={B}, maxp]")
    if mask.dim() != 2 or mask.shape[0] != B \
            or mask.shape[1] > page_table.shape[1] * page:
        raise ValueError(f"mask {tuple(mask.shape)} is not [B={B}, T] with T <= "
                         f"maxp * page = {page_table.shape[1] * page}")


def decode_attention_reference(q, k, v, mask, page_table=None,
                               sm_scale: Optional[float] = None):
    """The plain version of K4, as ``_attention_paged`` computes it: gather
    each row's keys, GQA by reshape, the finite ``NEG_INF`` mask, softmax in
    fp32, probabilities cast to q's dtype before P.V.  The scores are taken
    from fp32 copies of q and k, as the kernel (and the Pallas K4, with its
    fp32 ``preferred_element_type``) keeps them in fp32; the einsum of
    ``_attention_paged`` rounds them to the input dtype first."""
    k, v, page_table = _as_pool(k, v, page_table)
    _check(q, k, v, mask, page_table)
    B, Hq, hd = q.shape
    P, page, Hkv, _ = k.shape
    T = mask.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    t = torch.arange(T, device=q.device)
    rows = page_table.long()[:, t // page] * page + t % page       # [B, T]
    ck = k.reshape(P * page, Hkv, hd)[rows]                         # [B, T, Hkv, hd]
    cv = v.reshape(P * page, Hkv, hd)[rows]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) * sm_scale
    s = s.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgt,btkd->bkgd", p, cv).reshape(B, Hq, hd)


def split_plan(T: int, page: int, hd: int, dtype) -> tuple:
    """``(nsplit, rows)`` the kernel takes for these shapes: tiles of
    ``rows`` keys inside one page, and a cluster of ``nsplit`` CTAs, the
    largest of 1, 2, 4, 8 not above the number of tiles."""
    esize = torch.empty((), dtype=dtype).element_size()
    rows = max(1, min(TILE_BYTES // (hd * esize), MAX_ROWS, page))
    ntiles = int(key_tiles(T, page, rows)[-1]) + 1 if T else 0
    nsplit = 1
    while nsplit * 2 <= min(MAX_SPLIT, ntiles):
        nsplit *= 2
    return nsplit, rows


def key_tiles(T: int, page: int, rows: int) -> torch.Tensor:
    """The kernel's tile of each key ``0 .. T-1``: ``ceil(page / rows)``
    tiles a page, numbered in key order (the last of a page may be short).
    Tile ``j`` belongs to cluster rank ``j % nsplit``."""
    t = torch.arange(T)
    return (t // page) * -(-page // rows) + (t % page) // rows


def _split_states(q, k, v, mask, page_table, nsplit, sm_scale):
    """Each cluster rank's online-softmax state ``(m, l, acc)`` over its
    tiles in order ([B, Hkv, G], [B, Hkv, G], [B, Hkv, G, hd], fp32), as
    the kernel keeps it: scores in fp32, P rounded to V's dtype before P.V,
    a dead key's V never read.  A rank without a live key keeps
    ``(NEG_INF, 0, 0)``."""
    B, Hq, hd = q.shape
    P, page, Hkv, _ = k.shape
    T, G = mask.shape[1], Hq // Hkv
    t = torch.arange(T, device=q.device)
    rows = page_table.long()[:, t // page] * page + t % page       # [B, T]
    ck = k.reshape(P * page, Hkv, hd)[rows].float()                 # [B, T, Hkv, hd]
    cv = v.reshape(P * page, Hkv, hd)[rows]
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, Hkv, G, hd).float(), ck) * sm_scale
    live = mask.bool()
    rows = split_plan(T, page, hd, q.dtype)[1]
    tiles = key_tiles(T, page, rows).to(q.device)
    ntiles = int(tiles[-1]) + 1 if T else 0
    states = []
    for r in range(nsplit):
        m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G), device=q.device)
        acc = torch.zeros((B, Hkv, G, hd), device=q.device)
        for j in range(r, ntiles, nsplit):
            keys = (tiles == j).nonzero().squeeze(1)
            lj = live[:, keys][:, None, None, :]                    # [B, 1, 1, n]
            sj = s[..., keys].masked_fill(~lj, NEG_INF)
            mn = torch.maximum(m, sj.amax(-1))
            alpha = torch.exp(m - mn)
            p = torch.where(lj, torch.exp(sj - mn[..., None]), 0.0)
            vj = torch.where(live[:, keys][:, :, None, None], cv[:, keys], 0).float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgn,bnkd->bkgd", p.to(v.dtype).float(), vj)
            m = mn
        states.append((m, l, acc))
    return states


def decode_attention_split_reference(q, k, v, mask, page_table=None,
                                     nsplit: Optional[int] = None,
                                     sm_scale: Optional[float] = None):
    """K4's arithmetic in PyTorch: the keys split into the kernel's tiles
    over ``nsplit`` cluster ranks (by default the kernel's own choice,
    :func:`split_plan`), one online softmax per rank (:func:`_split_states`),
    then the ranks merged in rank order, ``O = sum_r acc_r e^(m_r - M) /
    sum_r l_r e^(m_r - M)``, zeros where no key is live.  Used by the tests;
    nothing on the main path calls it."""
    k, v, page_table = _as_pool(k, v, page_table)
    _check(q, k, v, mask, page_table)
    B, Hq, hd = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if nsplit is None:
        nsplit = split_plan(mask.shape[1], k.shape[1], hd, q.dtype)[0]
    states = _split_states(q, k, v, mask, page_table, nsplit, sm_scale)
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L, O = torch.zeros_like(M), torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp(m - M)
        L = L + l * w
        O = O + acc * w[..., None]
    out = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)


def _launch(q, k, v, mask, page_table, sm_scale: float):
    B, Hq, hd = q.shape
    page, Hkv = k.shape[1], k.shape[2]
    if {t.device for t in (q, k, v, mask, page_table)} != {q.device}:
        raise ValueError("q, k, v, mask and page_table must share one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32/float16/bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Hq // Hkv not in GROUPS:
        raise NotImplementedError(
            f"{Hq // Hkv} query heads per KV head: the kernel is built for {GROUPS}")
    for name, x in (("q", q), ("k", k), ("v", v), ("mask", mask),
                    ("page_table", page_table)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.ds_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), page_table.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, mask.shape[1],
            page, page_table.shape[1], _DTYPE_CODES[q.dtype], float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.ds_cuda_error_string(err).decode())
    decode_attention.launches += 1
    return out


def decode_attention(q, k, v, mask, page_table=None,
                     sm_scale: Optional[float] = None):
    """K4: q [B,Hq,hd] against k/v pools [P,page,Hkv,hd] through
    ``page_table`` (or contiguous caches [B,T,Hkv,hd] without one), int
    mask [B,T] -> [B,Hq,hd] in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, mask, page_table, sm_scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no decode kernel for device {q.device}")
    k, v, page_table = _as_pool(k, v, page_table)
    _check(q, k, v, mask, page_table)
    # int32 on the wire, as mask_to_i32 does for the JAX kernel (no-ops for
    # int32 inputs)
    return _launch(q, k, v, mask_to_i32(mask).contiguous(),
                   page_table.to(torch.int32).contiguous(), sm_scale)


decode_attention.launches = 0
