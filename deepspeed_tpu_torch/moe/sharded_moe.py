"""Expert-parallel MoE (counterpart of ``deepspeed_tpu/moe/sharded_moe.py``;
reference ``deepspeed/moe/sharded_moe.py``).

Gating is the JAX package's, step for step (``top_k_gating``): top-1 or
top-2 by repeated ``argmax`` (the first maximum on ties, in both
packages), each expert's capacity slots filled in token order so a token
beyond capacity is dropped and earlier ones kept, the load-balancing aux
loss over the top-1 assignment, top-2 weights renormalised over the kept
experts and top-1 keeping the raw gate probability.

Dispatch differs in form only.  The JAX package builds one-hot
``[G, S, E, C]`` tensors and dispatches and combines by einsum; those
einsums copy rows and add at most ``top_k`` non-zero terms a token.  The
port gathers the kept rows into the ``[G, E, C, D]`` capacity buffers by
index and gathers each token's ``top_k`` expert outputs back, weighted by
the same combine weights (``moe_ffn``).  No host synchronisation.

Expert parallelism: the expert leaves a rank holds are its ``E / ep``
experts (the 'expert' axis of ``param_specs``), the router is whole.  When
the leaves hold fewer experts than the router scores, the capacity path
exchanges the buffers over the 'expert' axis with :class:`_AllToAll` (the
reference's ``_AllToAll``, sharded_moe.py:90): every rank sends expert
``e``'s slots of its groups to the rank that holds ``e`` and gets the
outputs back, so an expert's gradient already sums every rank's tokens.

The no-drop path (``moe_ffn_nodrop``, ``drop_tokens=False``) keeps every
token.  JAX sorts the ``T * top_k`` assignments by expert and runs
``lax.ragged_dot``; the port does the same with one matmul chain per
expert over its segment, which costs one host synchronisation a layer
(the segment sizes).  Where that cannot happen, inside a CUDA graph's
capture, or where every expert is read anyway (at most two rows an
expert, a decode tick), it runs every expert over every row and weights
the outputs by the routing (zero where a row did not pick the expert):
static shapes, no synchronisation, the same sums.  On an expert axis
above 1 it gathers the expert weights over the axis, as GSPMD does in
the JAX package, and warns once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.logging import log_dist


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2                      # 1 = Switch, 2 = GShard
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 8
    noisy_gate_policy: Optional[str] = None   # None | "jitter"
    # the aux loss is returned unscaled; the model applies its coefficient
    drop_tokens: bool = True


def _capacity(tokens_per_group: int, cfg: MoEConfig, deterministic: bool) -> int:
    if not cfg.drop_tokens:
        # the no-drop contract for direct top_k_gating callers: C = T fits
        # every token (an expert receives each token at most once)
        return ((tokens_per_group + 7) // 8) * 8
    cf = cfg.eval_capacity_factor if deterministic else cfg.capacity_factor
    cap = int(cf * tokens_per_group * cfg.top_k / cfg.num_experts)
    cap = max(cap, cfg.min_capacity)
    return ((cap + 7) // 8) * 8


def _route(logits: torch.Tensor, cfg: MoEConfig, C: int):
    """The routing of one group or a batch of them: ``logits [..., T, E]``
    -> (expert ``[K, ..., T]``, slot ``[K, ..., T]``, kept ``[K, ..., T]``
    fp32 0/1, combine weight ``[K, ..., T]`` fp32, aux ``[...]``), K =
    top_k, in the JAX package's ``top_k_gating`` arithmetic."""
    E = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    counts = gates.new_zeros(gates.shape[:-2] + (E,))
    denom = gates.new_zeros(gates.shape[:-1])
    masked = gates
    experts, slots, kepts, gate_ks = [], [], [], []
    aux = None
    for k in range(cfg.top_k):
        idx = masked.argmax(dim=-1)                               # [..., T]
        mask = F.one_hot(idx, E).to(gates.dtype)                  # [..., T, E]
        if k == 0:
            aux = E * (gates.mean(-2) * mask.mean(-2)).sum(-1)
        pos = mask.cumsum(-2) - mask + counts[..., None, :]
        keep = mask.bool() & (pos < C)
        pos_in = (pos * mask).sum(-1).long()
        kept = keep.any(-1).to(gates.dtype)
        gate_k = (gates * mask).sum(-1)
        denom = denom + gate_k * kept
        counts = counts + (mask * keep).sum(-2)
        masked = masked * (1.0 - mask)
        experts.append(idx)
        slots.append(pos_in.clamp(max=C - 1))
        kepts.append(kept)
        gate_ks.append(gate_k * kept)
    weight = torch.stack(gate_ks)
    if cfg.top_k > 1:
        # renormalised over the kept top-k (reference top2 :297); top-1 keeps
        # the raw gate probability (reference top1 :228)
        weight = weight / denom.clamp(min=1e-9)
    return torch.stack(experts), torch.stack(slots), torch.stack(kepts), weight, aux


def top_k_gating(logits: torch.Tensor, cfg: MoEConfig, deterministic: bool):
    """Route one group: ``logits [T, E]`` -> (combine ``[T, E, C]`` fp32,
    dispatch ``[T, E, C]`` bool, aux fp32), the JAX package's dense form
    (``moe_ffn`` uses the indices instead)."""
    T, E = logits.shape
    C = _capacity(T, cfg, deterministic)
    expert, slot, kept, weight, aux = _route(logits, cfg, C)
    combine = logits.new_zeros((T, E, C), dtype=torch.float32)
    dispatch = torch.zeros((T, E, C), dtype=torch.bool, device=logits.device)
    t = torch.arange(T, device=logits.device)
    for k in range(cfg.top_k):
        live = kept[k].bool()
        combine[t[live], expert[k][live], slot[k][live]] += weight[k][live]
        dispatch[t[live], expert[k][live], slot[k][live]] = True
    return combine, dispatch, aux


def _router_logits(x, router_w, cfg: MoEConfig, deterministic: bool, rng):
    """``x [..., D] @ router [D, E]`` in fp32.  Jitter (``noisy_gate_policy
    == "jitter"``, training only) multiplies the router's input by
    uniforms in [1 - 1e-2, 1 + 1e-2] (reference sharded_moe.py:350):
    drawn from ``rng`` when it is a ``torch.Generator``, or ``rng`` itself
    when it is a tensor of such multipliers."""
    x_router = x.float()
    if cfg.noisy_gate_policy == "jitter" and not deterministic and rng is not None:
        if isinstance(rng, torch.Tensor):
            noise = rng.to(x_router)
        else:
            noise = torch.empty(x_router.shape, dtype=torch.float32,
                                device=x_router.device).uniform_(
                1.0 - 1e-2, 1.0 + 1e-2, generator=rng)
        x_router = x_router * noise
    return x_router @ router_w.float()


class _AllToAll(torch.autograd.Function):
    """``comm.all_to_all`` over ``axis`` whose backward is the inverse
    exchange (reference sharded_moe.py:90)."""

    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        from .. import comm

        ctx.axis, ctx.split_dim, ctx.concat_dim = axis, split_dim, concat_dim
        return comm.all_to_all(x.contiguous(), axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        from .. import comm

        return (comm.all_to_all(g.contiguous(), ctx.axis, ctx.concat_dim,
                                ctx.split_dim), None, None, None)


def _expert_weights(expert_params: Dict[str, Any], n_experts: int, dtype):
    """The experts' leaves in ``dtype``: whole (an expert axis of 1), or,
    where a rank holds ``E / ep`` of them, gathered over 'expert' (the
    backward reduce-scatters each gradient back)."""
    names = [n for n in ("w_gate", "w_up", "w_in", "w_down", "b_in", "b_down")
             if n in expert_params]
    local = expert_params[names[0]].shape[0]
    out = {n: expert_params[n].to(dtype) for n in names}
    if local == n_experts:
        return out
    from ..runtime.zero.partition import gather_param

    _warn_nodrop_on_expert_mesh(n_experts // local)
    return {n: gather_param(w, 0, ("expert",), w.dtype) for n, w in out.items()}


def _expert_ffn(xs, w: Dict[str, torch.Tensor], e, activation: str):
    """One expert's FFN over rows ``xs [N, D]`` (biases on the gelu path)."""
    if activation == "swiglu":
        h = F.silu(xs @ w["w_gate"][e]) * (xs @ w["w_up"][e])
    else:
        h = xs @ w["w_in"][e]
        if "b_in" in w:
            h = h + w["b_in"][e]
        h = F.gelu(h, approximate="tanh")
    out = h @ w["w_down"][e]
    if "b_down" in w and activation != "swiglu":
        out = out + w["b_down"][e]
    return out


def _all_experts(x2, w: Dict[str, torch.Tensor], activation: str):
    """Every expert over every row: ``x2 [T, D]`` -> ``[E, T, D]``."""
    if activation == "swiglu":
        h = F.silu(torch.einsum("td,edf->etf", x2, w["w_gate"])) * \
            torch.einsum("td,edf->etf", x2, w["w_up"])
    else:
        h = torch.einsum("td,edf->etf", x2, w["w_in"])
        if "b_in" in w:
            h = h + w["b_in"][:, None, :]
        h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, w["w_down"])
    if "b_down" in w and activation != "swiglu":
        out = out + w["b_down"][:, None, :]
    return out


def _static_nodrop(T: int, cfg: MoEConfig) -> bool:
    """Whether the no-drop path runs every expert over every row: inside a
    CUDA graph's capture (no host synchronisation allowed), or where the
    rows average at most two an expert (each expert is read anyway)."""
    capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
    return capturing or T * cfg.top_k <= 2 * cfg.num_experts


def moe_ffn_nodrop(x: torch.Tensor, router_w: torch.Tensor,
                   expert_params: Dict[str, Any], cfg: MoEConfig,
                   activation: str = "swiglu", deterministic: bool = True,
                   rng=None, reduce=None, bias=None,
                   router_x=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """No token dropped (``drop_tokens=False``; JAX's ragged path): each
    token's output is its top-k experts' outputs weighted by the gates
    (renormalised for top-2).  ``x [B, S, D]`` -> (out, aux).  ``reduce``
    and ``bias`` as in :func:`moe_ffn`."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    logits = _router_logits(x if router_x is None else router_x, router_w, cfg,
                            deterministic, rng)
    gates = torch.softmax(logits.reshape(T, E), dim=-1)
    # top-k as repeated argmax: the first maximum on ties (lax.top_k's order)
    idxs, vals, masked = [], [], gates
    for _ in range(k):
        i = masked.argmax(dim=-1)
        idxs.append(i)
        vals.append(gates.gather(1, i[:, None])[:, 0])
        masked = masked.scatter(1, i[:, None], float("-inf"))
    idx, val = torch.stack(idxs, 1), torch.stack(vals, 1)           # [T, k]
    mask1 = F.one_hot(idx[:, 0], E).to(gates.dtype)
    aux = (E * (gates.reshape(B, S, E).mean(1)
                * mask1.reshape(B, S, E).mean(1)).sum(-1)).mean()
    if k > 1:
        val = val / val.sum(-1, keepdim=True).clamp(min=1e-9)
    w = _expert_weights(dict(expert_params, **(bias or {})), E, x.dtype)
    b_down = w.pop("b_down", None) if reduce is not None else None
    x2 = x.reshape(T, D)
    if _static_nodrop(T, cfg):
        route = torch.zeros(T, E, dtype=val.dtype, device=x.device).scatter_add(
            1, idx, val)                                            # [T, E]
        out = _all_experts(x2, w, activation)                       # [E, T, D]
        if reduce is not None:
            out = reduce(out)
            if b_down is not None:
                out = out + b_down[:, None, :]
        y = torch.einsum("te,etd->td", route.to(x.dtype), out)
        return y.reshape(B, S, D), aux
    flat_expert = idx.reshape(T * k)
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // k
    xs = x2[token_of]                                               # [T*k, D]
    sizes = torch.bincount(flat_expert, minlength=E).tolist()       # the host sync
    outs, lo = [], 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(_expert_ffn(xs[lo:lo + n], w, e, activation))
        lo += n
    out = torch.cat(outs)
    if reduce is not None:
        out = reduce(out)
        if b_down is not None:
            out = out + b_down[flat_expert[order]]
    out = out * val.reshape(T * k)[order][:, None].to(x.dtype)
    y = torch.zeros(T, D, dtype=out.dtype, device=x.device).index_add(0, token_of, out)
    return y.reshape(B, S, D), aux


_NODROP_EP_WARNED = [False]


def _warn_nodrop_on_expert_mesh(ep: int) -> None:
    """drop_tokens=False on an expert axis above 1 gathers every expert's
    weights on every rank (no all-to-all dispatch): warn once, rank 0."""
    if _NODROP_EP_WARNED[0]:
        return
    _NODROP_EP_WARNED[0] = True
    log_dist(f"MoE drop_tokens=False with expert mesh axis size {ep}: the "
             "no-drop path gathers the expert weights on every rank (no "
             "all-to-all dispatch); prefer drop_tokens=True capacity buffers "
             "when sharding the expert axis.", ranks=[0])


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, expert_params: Dict[str, Any],
            cfg: MoEConfig, activation: str = "swiglu", deterministic: bool = True,
            rng=None, reduce=None, bias=None,
            router_x=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> (out ``[B, S, D]``, aux): groups are batch rows,
    capacity per group.  ``expert_params`` leaves are ``[E, D, F]`` /
    ``[E, F, D]`` (this rank's ``E / ep`` of them on an expert axis).
    Expert-internal tensor parallelism: ``x`` is the experts' input (its
    gradient summed over the model axis), ``router_x`` the router's (the
    same values, whose gradient every rank computes whole), ``reduce`` sums
    the experts' down projections over the axis, and ``bias``
    (``{"b_down": [E, D]}``) is added after it."""
    if not cfg.drop_tokens:
        return moe_ffn_nodrop(x, router_w, expert_params, cfg, activation=activation,
                              deterministic=deterministic, rng=rng, reduce=reduce,
                              bias=bias, router_x=router_x)
    expert_params = dict(expert_params, **(bias or {}))
    G, S, D = x.shape
    E = cfg.num_experts
    C = _capacity(S, cfg, deterministic)
    logits = _router_logits(x if router_x is None else router_x, router_w, cfg,
                            deterministic, rng)                     # [G, S, E]
    expert, slot, kept, weight, aux = _route(logits, cfg, C)
    aux = aux.mean()
    # flat buffer row of each (k, g, s): g*E*C + e*C + c, the trash row
    # G*E*C for a dropped one
    g = torch.arange(G, device=x.device)[None, :, None]
    dest = torch.where(kept.bool(), (g * E + expert) * C + slot,
                       torch.full_like(slot, G * E * C))            # [K, G, S]
    token = (g * S + torch.arange(S, device=x.device)[None, None, :]).expand_as(dest)
    # which token fills each slot (token G*S, a zero row, for an empty one)
    src = torch.full((G * E * C + 1,), G * S, dtype=torch.long, device=x.device)
    src = src.scatter(0, dest.reshape(-1), token.reshape(-1))[:-1]
    xs = torch.cat([x.reshape(G * S, D), x.new_zeros(1, D)])
    expert_in = xs[src].reshape(G, E, C, D)
    local = expert_params["w_down"].shape[0]
    ep = E // local
    if ep > 1:   # this rank's experts' slots of every rank's groups
        expert_in = _AllToAll.apply(expert_in, "expert", 1, 0)       # [ep*G, E/ep, C, D]
    w = {n: expert_params[n].to(x.dtype) for n in
         ("w_gate", "w_up", "w_in", "w_down", "b_in", "b_down") if n in expert_params}
    h_in = expert_in.transpose(0, 1).reshape(local, -1, D)          # [E_l, G'*C, D]
    if activation == "swiglu":
        h = F.silu(torch.bmm(h_in, w["w_gate"])) * torch.bmm(h_in, w["w_up"])
    else:
        h = torch.bmm(h_in, w["w_in"])
        if "b_in" in w:
            h = h + w["b_in"][:, None, :]
        h = F.gelu(h, approximate="tanh")
    expert_out = torch.bmm(h, w["w_down"])
    if reduce is not None:
        expert_out = reduce(expert_out)
    if "b_down" in w and activation != "swiglu":
        expert_out = expert_out + w["b_down"][:, None, :]
    expert_out = expert_out.reshape(local, -1, C, D).transpose(0, 1)  # [G', E_l, C, D]
    if ep > 1:
        expert_out = _AllToAll.apply(expert_out, "expert", 0, 1)      # [G, E, C, D]
    eo = torch.cat([expert_out.reshape(G * E * C, D), expert_out.new_zeros(1, D)])
    out = None
    for k in range(cfg.top_k):
        term = weight[k].to(x.dtype)[..., None] * eo[dest[k]]
        out = term if out is None else out + term
    return out, aux
