"""Ring attention and Ulysses: sequence parallelism over the mesh's 'seq'
axis (counterpart of ``deepspeed_tpu/ops/ring_attention.py`` and of the
Ulysses branch of ``deepspeed_tpu/models/transformer.py`` ``_attention``).

Each rank of the 'seq' axis holds a contiguous slice ``[B, S/sp, H, hd]``
of the sequence.

**Ring.**  Queries stay on their rank; the K/V blocks rotate round the
ring, ``n - 1`` point-to-point rotations (:class:`_RingKV`, whose backward
rotates the cotangents the other way), and each rank merges the
``(out, lse)`` of every block it attends in fp32 by ``logaddexp`` on the
lse, with one cast at the end.  Step 0 is the local block and the only
causal one; a rotated block is wholly past (attended, non-causal) or
wholly future.  JAX runs a future block's kernel and forces its lse to
-1e30; eager torch may branch per rank, so a rank skips the kernels of
its future blocks (their merge weight is exactly 0 either way) while
still making every rotation.  The inner block is the flash kernel with a
differentiable lse (``flash_attention(..., return_lse=True)``: K1, then K2
and K3 with ``delta - dlse`` in the backward) when the local shard is
tile-aligned (``S/sp % 128 == 0``), the grouped einsum block otherwise
(``impl``: "auto", "flash", "einsum").

One schedule, two callers: :func:`ring_rank` is one rank's schedule over
the K/V blocks it holds after each rotation; :func:`ring_attention` feeds
it the blocks the P2P rotations bring, :func:`ring_attention_virtual`
runs ``sp`` ranks in lockstep in one process, each rotation a list index
(the card's check of the schedule and its kernel launches).

**Ulysses** (:func:`ulysses_attention`): an all-to-all over 'seq' turns
the sequence slices of every head into the whole sequence of ``H/sp``
heads, full-sequence causal attention runs on those, and the inverse
all-to-all turns them back (:class:`_AllToAll`, whose backward is the
inverse all-to-all).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from .kernels.common import NEG_INF, first_derivative_only
from .kernels.flash_attention import flash_attention

SEQ_AXIS = "seq"
IMPLS = ("auto", "flash", "einsum")


def _comm():
    from .. import comm

    return comm


def _block_attn(q, k, v, q_off: int, k_off: int, sm_scale: float, causal: bool):
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> (o [B,Sq,Hq,hd], lse [B,Hq,Sq]):
    grouped-query attention kept grouped (q folds to [B,Sq,Hkv,G,hd], no
    repeat), scores in fp32, the causal mask by global offsets."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(
        torch.promote_types(q.dtype, torch.float32)) * sm_scale
    if causal:
        rows = q_off + torch.arange(Sq, device=q.device)[:, None]
        cols = k_off + torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~(rows >= cols), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                             # [B,Hkv,G,Sq]
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, Sq, Hq, hd)
    return o, lse.reshape(B, Hq, Sq)


def flash_ok(s_local: int) -> bool:
    """Whether the flash kernel takes a local shard (128-row tiles)."""
    return s_local % 128 == 0


def _impl(impl: str, s_local: int) -> str:
    if impl not in IMPLS:
        raise ValueError(f"ring impl={impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "flash" if flash_ok(s_local) else "einsum"
    if impl == "flash" and not flash_ok(s_local):
        raise ValueError(f"ring impl='flash' requires a 128-multiple local shard, "
                         f"got S_local={s_local}")
    return impl


def _merge(o, lse, o_b, lse_b):
    """Two partial softmaxes merged in fp32: ``o`` [B,S,H,hd] fp32, lse
    [B,H,S]."""
    new_lse = torch.logaddexp(lse, lse_b)
    w_old = torch.exp(lse - new_lse).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_b - new_lse).transpose(1, 2)[..., None]
    return o * w_old + o_b.to(o.dtype) * w_new, new_lse


def ring_rank(q, ks: List[torch.Tensor], vs: List[torch.Tensor], me: int, n: int,
              causal: bool = True, sm_scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Rank ``me``'s ring over the K/V blocks it holds after each rotation
    (``ks[r]``: the block of rank ``(me - r) % n``): step 0 causal, every
    past block non-causal, every future one skipped; the merge in fp32."""
    B, Sl, Hq, hd = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    impl = _impl(impl, Sl)
    acc = torch.promote_types(q.dtype, torch.float32)
    o = lse = None
    for r in range(n):
        src = (me - r) % n
        if r and causal and src > me:
            continue                      # wholly future: merge weight 0
        block_causal = causal and r == 0
        if impl == "flash":
            o_b, lse_b = flash_attention(q, ks[r], vs[r], causal=block_causal,
                                         sm_scale=sm_scale, return_lse=True)
        else:
            o_b, lse_b = _block_attn(q, ks[r], vs[r], me * Sl, src * Sl, sm_scale,
                                     block_causal)
        if o is None:
            o, lse = o_b.to(acc), lse_b.to(acc)
        else:
            o, lse = _merge(o, lse, o_b, lse_b.to(acc))
    return o.to(q.dtype)


class _RingKV(torch.autograd.Function):
    """The K/V blocks a rank holds after 0..n-1 rotations (each rotation
    sends to the next rank on the 'seq' ring and receives from the
    previous).  Backward: the cotangents travel back the other way, each
    rotation's added to the block it came from.  Every rank runs every
    rotation both ways, whatever blocks it skips."""

    @staticmethod
    def forward(ctx, k, v, n):
        comm = _comm()
        ctx.n = n
        ks, vs = [k.view_as(k)], [v.view_as(v)]
        for _ in range(n - 1):
            ks.append(comm.send_recv_next(ks[-1], SEQ_AXIS))
            vs.append(comm.send_recv_next(vs[-1], SEQ_AXIS))
        ring_attention.rotations += n - 1
        return (*ks, *vs)

    @staticmethod
    @first_derivative_only("the ring's K/V rotations")
    def backward(ctx, *grads):
        # an unused block's cotangent arrives as zeros (materialized), so
        # every rank makes every rotation back; the sums are fp32 (or wider)
        comm = _comm()
        n = ctx.n
        out = []
        for gs in (grads[:n], grads[n:]):
            wide = torch.promote_types(gs[0].dtype, torch.float32)
            acc = gs[n - 1].to(wide)
            for r in range(n - 2, -1, -1):
                acc = comm.send_recv_prev(acc, SEQ_AXIS) + gs[r]
            out.append(acc.to(gs[0].dtype))
        return out[0], out[1], None


def ring_attention(q, k, v, axis: str = SEQ_AXIS, causal: bool = True,
                   sm_scale: Optional[float] = None, impl: str = "auto"):
    """This rank's output of ring attention: q/k/v are its local shards
    ``[B, S/sp, H, hd]`` of the 'seq' axis; returns its shard of the
    output.  Counts ``ring_attention.rotations`` (K/V rotations, forward
    and remat recomputes)."""
    if axis != SEQ_AXIS:
        raise ValueError(f"ring attention runs over the {SEQ_AXIS!r} axis, not {axis!r}")
    comm = _comm()
    n, me = comm.get_axis_size(SEQ_AXIS), comm.axis_index(SEQ_AXIS)
    if n == 1:
        return ring_rank(q, [k], [v], 0, 1, causal, sm_scale, impl)
    blocks = _RingKV.apply(k, v, n)
    return ring_rank(q, list(blocks[:n]), list(blocks[n:]), me, n, causal, sm_scale,
                     impl)


ring_attention.rotations = 0


def ring_attention_virtual(qs, ks, vs, causal: bool = True,
                           sm_scale: Optional[float] = None, impl: str = "auto"):
    """``len(qs)`` ranks of the ring in one process, in lockstep: rank
    ``me``'s block after ``r`` rotations is ``ks[(me - r) % n]``.  Returns
    every rank's output shard (the same schedule as :func:`ring_attention`)."""
    n = len(qs)
    return [ring_rank(qs[me], [ks[(me - r) % n] for r in range(n)],
                      [vs[(me - r) % n] for r in range(n)], me, n, causal, sm_scale,
                      impl)
            for me in range(n)]


def ring_attention_sharded(q, k, v, causal: bool = True,
                           sm_scale: Optional[float] = None, impl: str = "auto"):
    """The engine's entry (JAX's name): q/k/v are this rank's shards of
    the batch rows, the 'seq' slice and the model axis's heads, as the
    training engine cuts them; the ring runs over 'seq'."""
    return ring_attention(q, k, v, SEQ_AXIS, causal, sm_scale, impl)


class _AllToAll(torch.autograd.Function):
    """``comm.all_to_all`` over 'seq' (split ``split_dim`` across the
    ranks, concatenate what arrives along ``concat_dim``); the backward is
    the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim):
        ctx.dims = (split_dim, concat_dim)
        return _comm().all_to_all(x.contiguous(), SEQ_AXIS, split_dim, concat_dim)

    @staticmethod
    @first_derivative_only("Ulysses' all-to-all")
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_comm().all_to_all(g.contiguous(), SEQ_AXIS, concat_dim, split_dim),
                None, None)


def seq_to_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, S/sp, H, hd]`` -> ``[B, S, H/sp, hd]`` (Ulysses' first
    all-to-all)."""
    return _AllToAll.apply(x, 2, 1)


def heads_to_seq(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`."""
    return _AllToAll.apply(x, 1, 2)


def ulysses_attention(q, k, v, attend):
    """DeepSpeed-Ulysses: ``attend(q, k, v)`` (causal attention over the
    whole sequence) on this rank's ``H/sp`` heads, between the two
    all-to-alls."""
    return heads_to_seq(attend(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)))


class _GatherSeq(torch.autograd.Function):
    """All-gather along the sequence dim over 'seq', every rank reading
    the whole: the backward sums the ranks' gradients and keeps this
    rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x):
        return _comm().all_gather(x.contiguous(), SEQ_AXIS, gather_dim=1)

    @staticmethod
    @first_derivative_only("the sequence all-gather")
    def backward(ctx, g):
        return _comm().reduce_scatter(g.contiguous(), SEQ_AXIS, scatter_dim=1)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """``[B, S/sp, ...]`` -> ``[B, S, ...]`` on every rank of 'seq'
    (differentiable)."""
    return _GatherSeq.apply(x)


__all__ = ["ring_attention", "ring_attention_sharded", "ring_attention_virtual",
           "ring_rank", "ulysses_attention", "seq_to_heads", "heads_to_seq",
           "gather_sequence", "flash_ok", "SEQ_AXIS"]
