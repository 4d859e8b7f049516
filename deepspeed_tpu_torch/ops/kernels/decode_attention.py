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

``k_scale``/``v_scale`` (both or neither) turn on the int8 mode: k/v are
int8 pools (``kv_dtype="int8"`` pages) with one fp32 scale per pool row,
``[P, page]`` (``[B, T]`` for a contiguous cache), and each element is
``(float(code) * scale)`` rounded to q's dtype before it is used, exactly
as ``models.transformer.kv_dequantize`` makes the compute-dtype copy.
The kernel reads the int8 pages and their scale rows in place (on the
card the page must be a multiple of 4 rows: a tile's scale rows are one
16-byte bulk copy).

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
        q8 = getattr(lib, "ds_decode_attention_q8", None)
        if q8 is not None:   # an older source (an --ab copy) has no int8 mode
            q8.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
            q8.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _as_pool(k, v, page_table):
    """(k, v, page_table) in the pool form: a contiguous cache [B, T, Hkv,
    hd] becomes B pages of T rows with the identity table (a scale plane
    [B, T] is then the pool's [P, page] already)."""
    if page_table is not None:
        return k, v, page_table
    B = k.shape[0]
    return k, v, torch.arange(B, dtype=torch.int32, device=k.device)[:, None]


def _check_scales(k, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention takes k_scale and v_scale together")
    if k_scale is None:
        if k.dtype == torch.int8:
            raise ValueError("int8 k/v pools need their k_scale/v_scale planes")
        return
    P, page = k.shape[0], k.shape[1]
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != (P, page) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [P, page] = {(P, page)}; got "
                             f"{s.dtype} {tuple(s.shape)}")


def _gather(k, v, page_table, T, dtype, k_scale=None, v_scale=None):
    """Each row's keys and values [B, T, Hkv, hd] through the page table, in
    ``dtype`` when the pools are int8 (multiplied by their row scale in
    fp32, then rounded), as they lie otherwise."""
    P, page, Hkv, hd = k.shape
    t = torch.arange(T, device=k.device)
    rows = page_table.long()[:, t // page] * page + t % page       # [B, T]
    ck = k.reshape(P * page, Hkv, hd)[rows]
    cv = v.reshape(P * page, Hkv, hd)[rows]
    if k_scale is not None:
        ck = (ck.float() * k_scale.reshape(P * page)[rows][..., None, None]).to(dtype)
        cv = (cv.float() * v_scale.reshape(P * page)[rows][..., None, None]).to(dtype)
    return ck, cv


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
                               sm_scale: Optional[float] = None,
                               k_scale=None, v_scale=None):
    """The plain version of K4, as ``_attention_paged`` computes it: gather
    each row's keys (int8 pools: then ``kv_dequantize`` to q's dtype), GQA
    by reshape, the finite ``NEG_INF`` mask, softmax in fp32, probabilities
    cast to q's dtype before P.V.  The scores are taken from fp32 copies of
    q and k, as the kernel (and the Pallas K4, with its fp32
    ``preferred_element_type``) keeps them in fp32; the einsum of
    ``_attention_paged`` rounds them to the input dtype first."""
    k, v, page_table = _as_pool(k, v, page_table)
    _check(q, k, v, mask, page_table)
    _check_scales(k, k_scale, v_scale)
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    T = mask.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    ck, cv = _gather(k, v, page_table, T, q.dtype, k_scale, v_scale)
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) * sm_scale
    s = s.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgt,btkd->bkgd", p, cv).reshape(B, Hq, hd)


def split_plan(T: int, page: int, hd: int, dtype) -> tuple:
    """``(nsplit, rows)`` the kernel takes for these shapes: tiles of
    ``rows`` keys inside one page, and a cluster of ``nsplit`` CTAs, the
    largest of 1, 2, 4, 8 not above the number of tiles.  ``dtype`` is the
    pools' (``torch.int8`` in the int8 mode: 1-byte rows, so a tile is
    MAX_ROWS keys at hd 64 and 128, 4 KB or 8 KB of K)."""
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


def _split_states(q, k, v, mask, page_table, nsplit, sm_scale,
                  k_scale=None, v_scale=None):
    """Each cluster rank's online-softmax state ``(m, l, acc)`` over its
    tiles in order ([B, Hkv, G], [B, Hkv, G], [B, Hkv, G, hd], fp32), as
    the kernel keeps it: scores in fp32, P rounded to the (dequantized)
    V's dtype before P.V, a dead key's V never read.  A rank without a live
    key keeps ``(NEG_INF, 0, 0)``."""
    B, Hq, hd = q.shape
    P, page, Hkv, _ = k.shape
    T, G = mask.shape[1], Hq // Hkv
    ck, cv = _gather(k, v, page_table, T, q.dtype, k_scale, v_scale)
    ck = ck.float()
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, Hkv, G, hd).float(), ck) * sm_scale
    live = mask.bool()
    rows = split_plan(T, page, hd, k.dtype)[1]
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
                "bkgn,bnkd->bkgd", p.to(cv.dtype).float(), vj)
            m = mn
        states.append((m, l, acc))
    return states


def decode_attention_split_reference(q, k, v, mask, page_table=None,
                                     nsplit: Optional[int] = None,
                                     sm_scale: Optional[float] = None,
                                     k_scale=None, v_scale=None):
    """K4's arithmetic in PyTorch: the keys split into the kernel's tiles
    over ``nsplit`` cluster ranks (by default the kernel's own choice,
    :func:`split_plan`), one online softmax per rank (:func:`_split_states`),
    then the ranks merged in rank order, ``O = sum_r acc_r e^(m_r - M) /
    sum_r l_r e^(m_r - M)``, zeros where no key is live.  Used by the tests;
    nothing on the main path calls it."""
    k, v, page_table = _as_pool(k, v, page_table)
    _check(q, k, v, mask, page_table)
    _check_scales(k, k_scale, v_scale)
    B, Hq, hd = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if nsplit is None:
        nsplit = split_plan(mask.shape[1], k.shape[1], hd, k.dtype)[0]
    states = _split_states(q, k, v, mask, page_table, nsplit, sm_scale,
                           k_scale, v_scale)
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L, O = torch.zeros_like(M), torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp(m - M)
        L = L + l * w
        O = O + acc * w[..., None]
    out = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)


def _launch(q, k, v, mask, page_table, sm_scale: float, k_scale=None, v_scale=None):
    B, Hq, hd = q.shape
    page, Hkv = k.shape[1], k.shape[2]
    scales = () if k_scale is None else (k_scale, v_scale)
    if {t.device for t in (q, k, v, mask, page_table, *scales)} != {q.device}:
        raise ValueError("q, k, v, mask, page_table (and the scales) must share one device")
    kv_dtype = torch.int8 if scales else q.dtype
    if q.dtype not in _DTYPE_CODES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"decode_attention takes float32/float16/bfloat16 q with k, v "
                        f"of q's dtype (or int8 with scales); got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Hq // Hkv not in GROUPS:
        raise NotImplementedError(
            f"{Hq // Hkv} query heads per KV head: the kernel is built for {GROUPS}")
    for name, x in (("q", q), ("k", k), ("v", v), ("mask", mask),
                    ("page_table", page_table)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, x in zip(("k_scale", "v_scale"), scales):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if scales and page % 4:
        raise NotImplementedError(
            f"page={page}: the int8 mode loads a tile's scale rows as one bulk "
            "copy of whole 16 bytes, so the page must be a multiple of 4 rows")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if scales:
            err = lib.ds_decode_attention_q8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), page_table.data_ptr(), mask.data_ptr(),
                out.data_ptr(), B, Hq, Hkv, hd, mask.shape[1], page,
                page_table.shape[1], _DTYPE_CODES[q.dtype], float(sm_scale), stream)
        else:
            err = lib.ds_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), page_table.data_ptr(),
                mask.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, mask.shape[1],
                page, page_table.shape[1], _DTYPE_CODES[q.dtype], float(sm_scale),
                stream)
    if err:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.ds_cuda_error_string(err).decode())
    decode_attention.launches += 1
    return out


def decode_attention(q, k, v, mask, page_table=None,
                     sm_scale: Optional[float] = None, k_scale=None, v_scale=None):
    """K4: q [B,Hq,hd] against k/v pools [P,page,Hkv,hd] through
    ``page_table`` (or contiguous caches [B,T,Hkv,hd] without one), int
    mask [B,T] -> [B,Hq,hd] in q's dtype.  With ``k_scale``/``v_scale``
    the pools are int8 pages read in the kernel's int8 mode."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, mask, page_table, sm_scale,
                                          k_scale, v_scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no decode kernel for device {q.device}")
    k, v, page_table = _as_pool(k, v, page_table)
    _check(q, k, v, mask, page_table)
    _check_scales(k, k_scale, v_scale)
    # int32 on the wire, as mask_to_i32 does for the JAX kernel (no-ops for
    # int32 inputs)
    return _launch(q, k, v, mask_to_i32(mask).contiguous(),
                   page_table.to(torch.int32).contiguous(), sm_scale,
                   k_scale, v_scale)


decode_attention.launches = 0
