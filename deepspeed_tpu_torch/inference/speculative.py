"""Speculative decoding over the paged KV pool: draft k, verify in one pass
(counterpart of ``deepspeed_tpu/inference/speculative.py``).

- **Mirrored paged pools.**  The draft model gets its own pool with the
  same ``(num_pages, page_size)`` geometry (and storage dtype), indexed by
  the engine's page tables: every admission prefills both pools, every COW
  snapshots both, so page accounting, prefix sharing and quarantine stay
  the engine's.  The draft pool is not tiered (a promoted page's draft
  side costs acceptance, never correctness).
- **Draft loop.**  Per tick the draft decodes ``k`` tokens: one captured
  ``[B_slots, 1]`` draft step (write the pending token, the proposal
  distribution ``q`` under each slot's sampling lane, the proposal)
  replayed ``k`` times, the position and token advanced on the device
  between replays.
- **Verify.**  One captured ``[B_slots, k+1]`` target step writes
  ``[last_tok, d_1..d_k]`` at positions ``L..L+k`` (the attention is K4
  over ``B*(k+1)`` decode rows, ``forward_paged(verify=True)``), takes the
  ``k+1`` target distributions ``p`` and runs the rejection sampling on the
  device: accept ``d_i`` iff ``u_i * q_i(d_i) < p_i(d_i)``, the first
  rejection truncates, the correction token is drawn from
  ``normalize(max(p - q, 0))`` at it.  Each slot emits 1..k tokens a tick
  and the target distribution is preserved.  As in JAX, no bonus token on
  full acceptance (it would sit one past the last draft-pool write).
  Greedy lanes make ``p`` one-hot, so greedy speculative decoding is
  token-exact with plain greedy decoding.  One host fetch a tick.
- **Counter-based draws, salted per role.**  The draft proposal, the accept
  uniform and the correction draw for the token at absolute position
  ``pos`` read uniforms from ``sampling.position_uniforms(seed, pos,
  SALT_*)``: the stream is independent of block alignment, so replay and
  resume re-derive it.  The uniforms are drawn on the host (only for
  sampled lanes) and copied into the graphs' static inputs; a draw is the
  inverse CDF of its distribution at its uniform.  The bits differ from
  the JAX package's keys (its sampled streams are matched in
  distribution, not token for token).

The tick is written once over the steps' static input buffers: on CUDA a
step is its graph replayed, on the CPU the same step function run eagerly
over the same buffers.  Rejected
positions leave draft-token K/V past the accepted length in both pools;
causality hides it until the next tick overwrites it, and
``forward_paged`` sends writes past a slot's page table to the trash page.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import paged_pool_cache, paged_pool_tuple
from ..parallel import tensor_parallel
from ..utils.tree import tree_map
from .engine import place_params
from .execution import capture_graph, copy_tree, pool_bytes, swap_tree
from .sampling import (SALT_ACCEPT, SALT_DRAFT, SALT_RESAMPLE, position_uniforms,
                       sampling_probs)

__all__ = ["SpeculativeConfig", "SpeculativeDecoder", "layer_skip_draft",
           "perturbed_draft", "SALT_DRAFT", "SALT_ACCEPT", "SALT_RESAMPLE"]


@dataclasses.dataclass
class SpeculativeConfig:
    """Draft-side configuration for a speculative :class:`ServingEngine`.

    ``draft_model``/``draft_params`` must expose the same paged contract as
    the target (``models.CausalLM``) over the same vocabulary; ``k`` is the
    number of draft tokens proposed per verify tick (each slot then emits
    1..k tokens per tick)."""
    draft_model: Any
    draft_params: Any
    k: int = 4

    def validate(self, target_model, max_model_len: int) -> None:
        if self.k < 1:
            raise ValueError(f"speculative k={self.k} must be >= 1")
        if not hasattr(self.draft_model, "apply_paged"):
            raise ValueError(
                "speculative draft_model needs the paged decode contract "
                "(init_paged_cache/apply_paged) — see models.CausalLM")
        dv = self.draft_model.config.vocab_size
        tv = target_model.config.vocab_size
        if dv != tv:
            raise ValueError(
                f"draft vocab {dv} != target vocab {tv}: rejection "
                "sampling compares p and q over one token space")
        if self.draft_model.config.max_seq_len < max_model_len:
            raise ValueError(
                f"draft max_seq_len {self.draft_model.config.max_seq_len} "
                f"< max_model_len {max_model_len}: the draft must reach "
                "every position the target serves")


def layer_skip_draft(model, params, num_layers: int):
    """Self-speculative draft: the target's first ``num_layers`` blocks plus
    its embedding, norm and head.  The draft's layer leaves are views of the
    target's (no extra weights; a serving engine's weight swap moves the
    target onto its own copy and leaves them, as the JAX package's slices
    stay: pass ``draft_params=`` to refresh the draft).  Returns
    ``(draft_model, draft_params)``."""
    cfg = model.config
    if not (0 < num_layers < cfg.num_layers):
        raise ValueError(
            f"layer_skip_draft num_layers={num_layers} must be in "
            f"(0, {cfg.num_layers}) — the draft must be a strict prefix "
            "of the target stack")
    if isinstance(params.get("layers"), (list, tuple)):
        raise NotImplementedError(
            "layer_skip_draft needs a uniform stacked layer tree "
            "(scan_layers); per-layer pyramids are not sliceable")
    from ..models import CausalLM

    draft = CausalLM(cfg, attn_impl=getattr(model, "attn_impl", "auto"),
                     num_layers=num_layers)
    draft_params = dict(params)
    draft_params["layers"] = tree_map(lambda x: x[:num_layers], params["layers"])
    return draft, draft_params


def perturbed_draft(model, params, scale: float = 1e-3, seed: int = 0):
    """A noise-perturbed full copy of the target (a stand-in for a distilled
    draft on random-weight models): each floating leaf plus ``scale`` times
    its std times a standard normal draw from a generator seeded ``seed``
    (on the leaf's device).  Small scales keep argmax agreement high,
    larger ones exercise the rejection path.  The draws differ from the
    JAX package's (carry a JAX draft over with ``models.convert`` to hold
    the two against each other)."""
    from ..models import CausalLM

    draft = CausalLM(model.config, attn_impl=getattr(model, "attn_impl", "auto"))
    gens: Dict[Any, torch.Generator] = {}

    def perturb(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        g = gens.get(x.device)
        if g is None:
            g = gens[x.device] = torch.Generator(device=x.device).manual_seed(seed)
        std = x.float().std() + 1e-8
        noise = torch.randn(x.shape, generator=g, device=x.device, dtype=torch.float32)
        return (x.float() + scale * std * noise).to(x.dtype)

    with torch.no_grad():
        return draft, tree_map(perturb, params)


def _icdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The inverse-CDF draw of each row of ``probs`` [N, V] at its uniform
    ``u`` [N] (no host synchronisation)."""
    c = probs.cumsum(-1)
    idx = (c < (u[:, None] * c[:, -1:])).sum(-1)
    return idx.clamp(max=probs.shape[-1] - 1)


class SpeculativeDecoder:
    """The draft pool, the draft step and the verify block, owned by a
    :class:`~.serving.ServingEngine` built with ``speculative=``.  On CUDA
    both steps are captured once, at build (``captures``: 2, two more when
    a weight swap moves the tensors they read), and replayed (the draft
    step ``k`` times a tick); ``draft_k4_launches`` and
    ``verify_k4_launches`` are the K4 launches recorded in each graph."""

    def __init__(self, config: SpeculativeConfig, target_exec, max_model_len: int):
        config.validate(target_exec.model, max_model_len)
        self.config = config
        self.k = int(config.k)
        self.target = target_exec
        self.draft_model = config.draft_model
        self.num_pages = target_exec.num_pages
        self.page_size = target_exec.page_size
        self.b_slots = target_exec.b_slots
        self.kv_dtype = target_exec.kv_dtype
        self.device = target_exec.device
        self.mesh = target_exec.mesh
        tp = target_exec.tp
        if tp > 1 and self.draft_model.config.kv_heads % tp:
            raise ValueError(
                f"draft kv_heads={self.draft_model.config.kv_heads} not "
                f"divisible by the mesh's model axis ({tp}): the draft pool "
                "shards its heads over 'model' like the target's")
        # the caller's tensors until the first draft refresh (owns_draft)
        self.draft_params = place_params(self.draft_model, config.draft_params,
                                         self.mesh)
        self.owns_draft = False
        with self._region():
            cache = self.draft_model.init_paged_cache(
                self.num_pages, self.page_size, kv_dtype=self.kv_dtype,
                device=self.device)
        self.dpools = paged_pool_tuple(cache)
        self.pool_bytes = pool_bytes(*self.dpools, tp=tp)
        self._draft_prefill_buckets: Dict[int, int] = {}
        self.verify_slot_ticks = 0
        self.emitted_tokens = 0
        self.drafted_tokens = 0
        self.captures = 0
        self.draft_replays = self.verify_replays = 0
        self.draft_k4_launches = self.verify_k4_launches = 0
        self._st = self._static_inputs()
        self._graphs: Dict[str, tuple] = {}   # step -> (graph, its outputs)
        if self.device.type == "cuda":
            self._capture()

    def _region(self):
        return tensor_parallel.region(self.mesh is not None)

    # ------------------------------------------------------- the two steps

    def _draft_step(self, pt, pos, tok, active, temp, top_k, top_p, u):
        """Write ``tok`` (pending at ``pos``) into the draft pool and propose
        the token at ``pos + 1``: (proposal [B] int64, its distribution
        ``q`` [B, V] fp32)."""
        with self._region():
            logits, _ = self.draft_model.apply_paged(
                self.draft_params, tok[:, None], paged_pool_cache(self.dpools),
                pt, pos, active[:, None])
        lg = logits[:, -1, :]
        q = sampling_probs(lg, temp, top_k, top_p)
        d = torch.where(temp <= 0.0, torch.argmax(lg, dim=-1), _icdf(q, u))
        return d, q

    def _verify(self, pt, lengths, last_tok, active, d_toks, d_probs,
                temp, top_k, top_p, u_acc, u_res):
        """The target over ``[last_tok, d_1..d_k]`` at ``lengths..lengths+k``
        and the rejection sampling: (emitted [B, k+1] int64, n_emit [B])."""
        B, k = d_toks.shape
        V = d_probs.shape[-1]
        tokens = torch.cat([last_tok[:, None], d_toks], dim=1)
        seq_mask = active[:, None].expand(B, k + 1)
        ex = self.target
        with self._region():
            logits, _ = ex.model.apply_paged(
                ex.params, tokens, paged_pool_cache(ex.pools), pt, lengths, seq_mask,
                adapters=ex.adapter_operand(), verify=True)
        rep = lambda x: x.repeat_interleave(k + 1)               # noqa: E731
        p = sampling_probs(logits.reshape(B * (k + 1), V), rep(temp), rep(top_k),
                           rep(top_p)).reshape(B, k + 1, V)
        p_at = torch.gather(p[:, :k], -1, d_toks[..., None])[..., 0]      # [B, k]
        q_at = torch.gather(d_probs, -1, d_toks[..., None])[..., 0]
        accept = u_acc * q_at < p_at
        n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)           # [B] 0..k
        p_n = torch.gather(p, 1, n_acc[:, None, None].expand(B, 1, V))[:, 0]
        q_n = torch.gather(d_probs, 1, n_acc.clamp(max=k - 1)[:, None, None]
                           .expand(B, 1, V))[:, 0]
        residual = torch.clamp(p_n - q_n, min=0.0)
        rs = residual.sum(-1, keepdim=True)
        corr = torch.where(rs > 0, residual / rs.clamp(min=1e-38), p_n)
        u_r = torch.gather(u_res, 1, n_acc[:, None])[:, 0]
        final = torch.where(temp <= 0.0, torch.argmax(corr, dim=-1), _icdf(corr, u_r))
        emitted = torch.cat([d_toks, torch.zeros_like(d_toks[:, :1])], dim=1)
        emitted = emitted.scatter(1, n_acc[:, None], final[:, None])
        n_emit = torch.clamp(n_acc + 1, max=k)
        return emitted, n_emit

    # --------------------------------------------- static inputs and capture

    def _static_inputs(self) -> Dict[str, torch.Tensor]:
        """The steps' input buffers, on the device: a tick copies into
        them, the draft step and the verify block read them (on CUDA their
        graphs were captured over them)."""
        B, k, dev = self.b_slots, self.k, self.device
        V = self.draft_model.config.vocab_size
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
        return {"pt": z(B, self.target.pages_per_slot, dt=torch.int32),
                "len": z(B, dt=torch.int32), "pos": z(B, dt=torch.int32),
                "last": z(B, dt=torch.long), "tok": z(B, dt=torch.long),
                "active": z(B, dt=torch.bool), "temp": z(B),
                "top_k": z(B, dt=torch.int32), "top_p": torch.ones(B, device=dev),
                "u_d": z(B), "u_draft": z(k, B), "u_acc": z(B, k), "u_res": z(B, k + 1),
                "d_toks": z(B, k, dt=torch.long), "d_probs": z(B, k, V)}

    def _step(self, name: str):
        """The draft step or the verify block over the static inputs."""
        st = self._st
        lanes = (st["temp"], st["top_k"], st["top_p"])
        if name == "draft":
            return self._draft_step(st["pt"], st["pos"], st["tok"], st["active"],
                                    *lanes, st["u_d"])
        return self._verify(st["pt"], st["len"], st["last"], st["active"],
                            st["d_toks"], st["d_probs"], *lanes, st["u_acc"], st["u_res"])

    def _run(self, name: str):
        """One step's outputs: its graph replayed on CUDA, the step run
        eagerly on the CPU."""
        if name in self._graphs:
            graph, out = self._graphs[name]
            graph.replay()
            return out
        return self._step(name)

    def _capture(self) -> None:
        dev = self.device
        g_d, d_out, self.draft_k4_launches = capture_graph(
            lambda: self._step("draft"), dev, self._region)
        g_v, v_out, self.verify_k4_launches = capture_graph(
            lambda: self._step("verify"), dev, self._region)
        self._graphs = {"draft": (g_d, d_out), "verify": (g_v, v_out)}
        self.captures += 2

    def recapture(self) -> None:
        """Capture both steps again (the tensors they read moved: a weight
        swap's first copy of the target or draft weights); nothing on the
        CPU."""
        if self._graphs:
            torch.cuda.synchronize(self.device)
            for graph, _ in self._graphs.values():
                graph.reset()
            self._capture()

    # ------------------------------------------------------------- the tick

    def _uniforms(self, seeds, lengths, sampled):
        """(draft [k, B], accept [B, k], resample [B, k+1]) uniforms of this
        tick at each slot's positions (zeros for greedy lanes)."""
        B, k = self.b_slots, self.k
        u_d, u_a, u_r = (np.zeros(s, np.float32) for s in ((k, B), (B, k), (B, k + 1)))
        for b in np.flatnonzero(sampled):
            s, L = int(seeds[b]), int(lengths[b])
            u_d[:, b] = position_uniforms([s] * k, [L + 1 + i for i in range(k)],
                                          SALT_DRAFT).numpy()
            u_a[b] = position_uniforms([s] * k, [L + 1 + i for i in range(k)],
                                       SALT_ACCEPT).numpy()
            u_r[b] = position_uniforms([s] * (k + 1), [L + 1 + i for i in range(k + 1)],
                                       SALT_RESAMPLE).numpy()
        return u_d, u_a, u_r

    def tick(self, page_table, lengths, last_tok, active, lanes,
             sampled) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative tick: k draft steps and one verify.  ``lanes`` are
        the engine's device lane vectors and host seeds
        (``MeshExecutor.lanes``), ``sampled`` the host mask of sampled
        lanes.  Returns ``(emitted [B, k+1], n_emit [B])`` (numpy): the
        caller consumes ``emitted[b, :n_emit[b]]`` per slot."""
        temp, top_k, top_p, seeds = lanes
        u_d, u_a, u_r = self._uniforms(seeds, lengths, sampled)
        st, k = self._st, self.k
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
        with torch.no_grad():
            st["pt"].copy_(t(page_table))
            st["len"].copy_(t(lengths))
            st["pos"].copy_(st["len"])
            st["last"].copy_(t(last_tok.astype(np.int64)))
            st["tok"].copy_(st["last"])
            st["active"].copy_(t(active))
            st["temp"].copy_(temp)
            st["top_k"].copy_(top_k)
            st["top_p"].copy_(top_p)
            st["u_draft"].copy_(t(u_d))
            st["u_acc"].copy_(t(u_a))
            st["u_res"].copy_(t(u_r))
            for i in range(k):
                st["u_d"].copy_(st["u_draft"][i])
                d_tok, q = self._run("draft")
                st["d_toks"][:, i].copy_(d_tok)
                st["d_probs"][:, i].copy_(q)
                st["tok"].copy_(d_tok)
                st["pos"].add_(1)
            emitted, n_emit = self._run("verify")
            out = torch.cat([emitted, n_emit[:, None]], dim=1).cpu().numpy()
        self.draft_replays += k
        self.verify_replays += 1
        n_active = int(np.asarray(active).sum())
        self.verify_slot_ticks += n_active
        self.drafted_tokens += k * n_active
        return out[:, :-1], out[:, -1]

    # ------------------------------------------------------ admission side

    def prefill(self, s_pad: int, pt_row: np.ndarray, tokens: np.ndarray,
                n_real: int, start: int) -> None:
        """Write the prompt tail's K/V into the draft pool (the bucket, page
        table row and ``start`` of the target prefill that just ran; the
        draft emits nothing)."""
        self._draft_prefill_buckets[s_pad] = self._draft_prefill_buckets.get(s_pad, 0) + 1
        dev = self.device
        with torch.no_grad(), self._region():
            self.draft_model.apply_paged(
                self.draft_params, torch.from_numpy(tokens).to(dev).long(),
                paged_pool_cache(self.dpools), torch.from_numpy(pt_row).to(dev),
                torch.tensor([start], dtype=torch.int32, device=dev),
                (torch.arange(s_pad, device=dev) < n_real)[None, :])

    def cow(self, cow_prog, src: int, dst: int) -> None:
        """Mirror a target-pool COW snapshot in the draft pool."""
        with torch.no_grad():
            cow_prog(self.dpools, int(src), int(dst))

    def update_params(self, draft_params) -> bool:
        """New draft weights: the first refresh moves the decoder onto a
        copy of them (the live tensors were the caller's, a layer-skip
        draft's even the target's), later ones copy into it in place.
        Returns whether the tensors moved (the caller then recaptures).
        The draft pool is not flushed: stale draft K/V costs acceptance,
        never correctness."""
        placed = swap_tree(self.draft_model, self.draft_params, draft_params, self.mesh)
        moved = not self.owns_draft
        with torch.no_grad():
            if moved:
                self.draft_params = tree_map(lambda x: x.detach().clone(), placed)
                self.owns_draft = True
            else:
                copy_tree(self.draft_params, placed)
        return moved

    # ------------------------------------------------------------- reading

    def program_inventory(self) -> Dict[str, Any]:
        return {"k": self.k, "draft_decode": 1, "verify": 1,
                "draft_prefill_buckets": sorted(self._draft_prefill_buckets),
                "captures": self.captures}

    def mean_accepted_len(self) -> float:
        """Tokens emitted per verify tick per slot (1..k; > 1 means the
        draft pays for itself)."""
        if self.verify_slot_ticks == 0:
            return 0.0
        return self.emitted_tokens / self.verify_slot_ticks

    def pool_alive(self) -> bool:
        return bool(self.dpools)

    def close(self) -> None:
        """Release the two graphs and the draft pool."""
        if self._graphs:
            torch.cuda.synchronize(self.device)
            for graph, _ in self._graphs.values():
                graph.reset()
        self._graphs = {}
        self.dpools = ()

    def compatible(self, other: Optional["SpeculativeDecoder"]) -> bool:
        return (other is not None
                and self.draft_model is other.draft_model
                and self.k == other.k
                and self.num_pages == other.num_pages
                and self.page_size == other.page_size
                and self.b_slots == other.b_slots
                and self.kv_dtype == other.kv_dtype)

    def adopt_programs(self, old: "SpeculativeDecoder") -> None:
        """Warm-restart carry: the dead decoder's draft prefill bucket
        record.  Its graphs are bound to the dead pools' addresses, so this
        decoder captured its own at build."""
        for b in old._draft_prefill_buckets:
            self._draft_prefill_buckets.setdefault(b, 0)
