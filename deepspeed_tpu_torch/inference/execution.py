"""The device half of the serving engine, on one device (counterpart of
``deepspeed_tpu/inference/execution.py`` ``MeshExecutor``).

:class:`~.serving.ServingEngine` keeps the host scheduling (admission, page
tables, the prefix index, deadlines: pure Python over numpy) and calls the
entry points here: :meth:`MeshExecutor.decode`, :meth:`MeshExecutor.prefill`,
:meth:`MeshExecutor.cow`, the tier movers (:meth:`~MeshExecutor.extract`,
:meth:`~MeshExecutor.inject`), the adapter slots, the weight swap and the
lane cache.  This class owns the paged KV pool and runs the model over it.

Where the JAX executor compiles one fixed-shape program per step kind, the
port runs:

- **decode** as one CUDA graph on CUDA: the forward of every slot's last
  token (embedding, each layer's pool write and K4, final norm, logits into
  a static ``[b_slots, 1, V]`` buffer), captured once when the executor is
  built, with every slot inactive so that the warm-up writes only to the
  trash page.  Each tick copies the page table, lengths, last tokens and
  active flags into the graph's static inputs and replays it.  Sampling
  runs eagerly on the logits afterwards (per-row ``torch.Generator``s and
  a host check are not graph-safe).  "Zero recompiles" becomes "zero new
  captures": :attr:`captures` stays 1 (2 after the first weight swap;
  speculative decoding's draft step and verify block are two more,
  captured by ``SpeculativeDecoder``).  On the CPU the same forward runs
  eagerly, as the caller asked;
- **prefill** eagerly, one ``[1, s_pad]`` bucket shape per prompt-length
  bucket (the bucket set is the program inventory);
- **COW** as one in-place page copy across layers (all four planes of an
  int8 pool, as raw bytes);
- **the tier moves** as page copies to and from pinned host memory
  (``kv_tiering``);
- **the weight swap** (``update_params``) local to this engine, as the
  JAX executor's is: the executor starts on the tensors the caller passed
  (an ``InferenceEngine``'s, through :meth:`InferenceEngine.serving`, which
  that engine and its other servers read too) and never writes into them.
  The first swap moves it onto its own copy of the new tree and recaptures
  the decode graph over it (``captures`` 2); every later swap is an
  in-place ``copy_`` into that copy, so the graph keeps its addresses.

``kv_dtype="int8"`` pools are int8 pages plus fp32 scale planes; the decode
graph reads them through K4's int8 mode.  With an adapter registry the
per-slot LoRA stacks (``{"scale": [B], "factors": {target: {"A": [L, B,
d_in, R], "B": [L, B, R, d_out]}}}`` at ``R = max(rank_buckets)``) are
allocated once on the device and a slot's rows are written in place at
admission, so the captured graph never sees a new address; the prefill
reads one slot's views of them.

On a mesh (``mesh=``, the JAX executor's layout): one process per device,
every rank running this executor and the same scheduler.  The params are
the rank's model-axis shards (:func:`place_params`), the KV pool is
``[L, P, page, Hkv/tp, hd]`` (the rank's KV heads; ``kv_heads % tp`` is
checked first), pages and the host arrays are the same on every rank; an
int8 pool's scale planes are whole on every rank (the row amax is reduced
over the model axis before rounding).  Adapter factors are cut like the
weights they adapt: ``B``'s output columns to the rank's heads for
``wq``/``wk``/``wv``, ``A``'s input rows for ``wo``.  The model runs its
tensor-parallel path (``parallel.tensor_parallel``): each layer's two
all-reduces and the logits' all-gather run inside the decode step, so they
are captured in its one CUDA graph (the eager warm-up runs on the capture
stream create the NCCL communicators first), and every rank samples the
same token from the same gathered logits.

Not ported (``NotImplementedError`` naming the ROADMAP item): per-program
accounting (item 12).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..parallel import tensor_parallel
from ..models.transformer import (ADAPTER_TARGETS, cow_copy_pool, normalize_kv_dtype,
                                  paged_pool_cache, paged_pool_tuple)
from ..ops.kernels.decode_attention import decode_attention
from ..utils.compile_counter import record_compile
from ..utils.tree import tree_leaves, tree_map
from .engine import check_mesh_model, install_mesh, place_params
from .kv_tiering import extract_pool_page, inject_pool_page
from .sampling import position_generator, sample_tokens

__all__ = ["MeshExecutor", "pool_bytes", "place_params", "capture_graph", "swap_tree",
           "copy_tree"]

_GRAPH_WARMUP = 2   # eager runs on the capture stream before capture


def pool_bytes(*pools, tp: int = 1) -> Dict[str, int]:
    """Total and per-device bytes of the pool tensors: this rank holds
    ``1/tp`` of the heads, so the pool over the mesh is ``tp`` times its
    (an int8 pool's scale planes, whole on every rank, are counted once a
    rank as well: the JAX package's replicated planes)."""
    per = sum(a.numel() * a.element_size() for a in pools)
    return {"total": per * tp, "per_device": per}


def swap_tree(model, live, params, mesh):
    """``params`` placed as this rank's shards and checked against the
    ``live`` tree: the same leaves, shapes and dtypes, every leaf a plain
    tensor (a quantized tree's codes are not swapped)."""
    placed = place_params(model, params, mesh)
    old, new = tree_leaves(live), tree_leaves(placed)
    if len(old) != len(new):
        raise ValueError(f"update_params: the new tree has {len(new)} leaves, "
                         f"the live one {len(old)}")
    for i, (a, b) in enumerate(zip(old, new)):
        if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
            raise ValueError(
                f"update_params: leaf {i} is a {type(a).__name__}/"
                f"{type(b).__name__}; only plain tensor trees swap in place "
                "(a quantized engine's tree does not)")
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(
                f"update_params: leaf {i} is {b.dtype} {tuple(b.shape)}, the "
                f"live one {a.dtype} {tuple(a.shape)}: the swap must be "
                "shape- and dtype-identical")
    return placed


def copy_tree(live, new) -> None:
    """Every leaf of ``new`` copied into ``live``'s, in place."""
    for a, b in zip(tree_leaves(live), tree_leaves(new)):
        if a.data_ptr() != b.data_ptr():
            a.copy_(b)


def capture_graph(fn, device, region, before_capture=None):
    """``fn()`` run ``_GRAPH_WARMUP`` times eagerly on a side stream (which
    builds the kernels and, on a mesh, the NCCL communicators), then
    captured once on that stream (``before_capture()`` runs between the
    two).  Returns ``(graph, outputs, k4)``: the outputs are the graph's
    static result tensors, ``k4`` the K4 launches recorded in it."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), torch.cuda.stream(side), region():
        for _ in range(_GRAPH_WARMUP):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    if before_capture is not None:
        before_capture()
    graph = torch.cuda.CUDAGraph()
    before = decode_attention.launches
    # captured on the warm-up stream: the model axis's NCCL collectives
    # were first issued there
    with torch.no_grad(), region(), torch.cuda.graph(graph, stream=side):
        out = fn()
    record_compile()
    return graph, out, decode_attention.launches - before


class MeshExecutor:
    """Paged KV pool + the decode / prefill / COW steps on one device."""

    def __init__(self, model, params, num_pages: int, page_size: int,
                 b_slots: int, pages_per_slot: int, dtype=None, kv_dtype=None,
                 mesh=None, prefix_cache: bool = True, host_tier: bool = False,
                 adapters=None, device=None):
        self.mesh, self.tp, self.ranks = self._install_mesh(model, mesh), 1, 1
        if self.mesh is not None:
            import torch.distributed as dist

            self.tp = check_mesh_model(model, self.mesh)
            self.ranks = dist.get_world_size()
        self.model = model
        # the rank's model-axis shards (a whole tree is cut here); the
        # caller's tensors until the first weight swap (owns_params)
        self.params = place_params(model, params, self.mesh)
        self.owns_params = False
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.b_slots = int(b_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.device = resolve_device(device)
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        with self._region():
            cache = model.init_paged_cache(self.num_pages, self.page_size,
                                           dtype=dtype, kv_dtype=kv_dtype,
                                           device=self.device)
        self.pools = paged_pool_tuple(cache)
        self.quantized = "k_scale" in cache
        self.pool_bytes = pool_bytes(*self.pools, tp=self.tp)
        self._prefill_buckets: Dict[int, int] = {}   # bucket -> calls
        self._cow_prog = cow_copy_pool if prefix_cache else None
        self.host_tier = bool(host_tier)
        self._lanes_device = None
        self.adapters = adapters
        self._ad = self._alloc_adapter_stacks() if adapters is not None else None
        # the CUDA graph of the decode step (None on the CPU)
        self.captures = 0
        self.replays = 0
        self.graph_k4_launches = 0   # K4 launches recorded in the graph
        # collectives recorded in the graph, {op: {axes: calls}} (read from
        # the comms logger during the capture; {} without one)
        self.graph_collectives: Dict[str, Dict[str, int]] = {}
        self._graph = None
        if self.device.type == "cuda":
            self._capture_decode()

    @staticmethod
    def _install_mesh(model, mesh):
        """``mesh`` (a ``MeshLayout`` or a mesh from ``parallel.mesh``)
        checked against the model's KV heads, then installed as the global
        mesh; None without one."""
        if mesh is None:
            return None
        from ..parallel import mesh as mesh_mod

        if isinstance(mesh, mesh_mod.OutsideMesh):
            mesh.refuse()

        layout = (mesh if isinstance(mesh, mesh_mod.MeshLayout)
                  else mesh_mod.layout_of(mesh) if hasattr(mesh, "mesh_dim_names")
                  else None)
        if layout is None:
            raise TypeError(f"mesh={type(mesh).__name__}: pass a mesh from "
                            "parallel.mesh.initialize_serving_mesh or a MeshLayout")
        kv = model.config.kv_heads
        if layout.tp > 1 and kv % layout.tp:
            raise ValueError(
                f"kv_heads={kv} not divisible by the mesh's model axis "
                f"({layout.tp}): the paged KV pool shards its head dim over "
                "'model' — pick tp dividing kv_heads or replicate with tp=1")
        check_mesh_model(model, layout)
        return install_mesh(mesh)

    def _region(self):
        return tensor_parallel.region(self.mesh is not None)

    def mesh_info(self) -> Dict[str, Any]:
        """Static mesh facts for health(): device count and the non-trivial
        axis sizes (``{}`` / 1 device without a mesh)."""
        if self.mesh is None:
            return {"mesh_devices": 1, "mesh_axes": {}}
        return {"mesh_devices": int(self.mesh.size()),
                "mesh_axes": {a: int(n) for a, n in zip(self.mesh.mesh_dim_names,
                                                        self.mesh.shape) if n > 1}}

    def agree(self, value):
        """Rank 0's ``value`` on every rank (the scheduler's clock: every
        host decision must match across the ranks of the mesh)."""
        if self.ranks == 1:
            return value
        from .. import comm

        return comm.broadcast_object(value)

    def tp_rank(self) -> int:
        """This rank's index on the model axis (0 without a mesh)."""
        if self.tp == 1:
            return 0
        from .. import comm

        return comm.axis_index("model")

    # ----------------------------------------------------------- adapters

    def _alloc_adapter_stacks(self):
        """The per-slot factor stacks on the device, allocated once at the
        registry's ``max_rank`` (the projections the paged block adapts,
        cut to this rank's heads on a mesh)."""
        reg, B, R, n = self.adapters, self.b_slots, self.adapters.max_rank, self.tp
        factors = {}
        for k, (L, d_in, d_out) in reg.shapes.items():
            if k not in ADAPTER_TARGETS:
                continue
            if k == "wo":
                d_in //= n
            else:
                d_out //= n
            factors[k] = {"A": torch.zeros((L, B, d_in, R), device=self.device),
                          "B": torch.zeros((L, B, R, d_out), device=self.device)}
        return {"scale": torch.zeros((B,), device=self.device), "factors": factors}

    def write_adapter_slot(self, host_stacks, slot: int) -> None:
        """Copy slot ``slot``'s rows of the registry's host stacks
        (``AdapterRegistry.make_slot_stacks``/``write_slot``) into the
        device stacks, in place (this rank's cut on a mesh)."""
        s, r, n = int(slot), self.tp_rank(), self.tp
        with torch.no_grad():
            self._ad["scale"][s] = float(host_stacks["scale"][s])
            for k, ab in self._ad["factors"].items():
                A = torch.from_numpy(host_stacks["factors"][k]["A"][:, s])
                B = torch.from_numpy(host_stacks["factors"][k]["B"][:, s])
                if n > 1 and k == "wo":
                    A = A.chunk(n, dim=1)[r]
                elif n > 1:
                    B = B.chunk(n, dim=2)[r]
                ab["A"][:, s].copy_(A)
                ab["B"][:, s].copy_(B)

    def adapter_operand(self, slot: Optional[int] = None):
        """The device stacks (every slot: the decode step's operand) or one
        slot's views of them (``[.., 1, ..]``: a prefill's); None without
        a registry."""
        if self._ad is None:
            return None
        if slot is None:
            return self._ad
        s = slice(int(slot), int(slot) + 1)
        return {"scale": self._ad["scale"][s],
                "factors": {k: {"A": ab["A"][:, s], "B": ab["B"][:, s]}
                            for k, ab in self._ad["factors"].items()}}

    def fuse_shard(self, name: str, delta: torch.Tensor) -> torch.Tensor:
        """A whole ``[L, d_in, d_out]`` fused delta of layer leaf ``name``
        cut to this rank's model-axis shard (whole without a mesh)."""
        if self.tp == 1:
            return delta
        spec = self.model.param_specs["layers"][name]
        return tensor_parallel.shard_leaf(delta, spec, self.tp_rank(), self.tp)

    # ------------------------------------------------------------ decode

    def _decode_forward(self, page_table, lengths, last_tok, active):
        """Every slot's next-token logits [B, 1, V]: write each slot's last
        token at position ``lengths`` (inactive slots write to the trash
        page) and attend through the page table."""
        with self._region():
            logits, _ = self.model.apply_paged(
                self.params, last_tok[:, None], paged_pool_cache(self.pools),
                page_table, lengths, active[:, None],
                adapters=self.adapter_operand())
        return logits

    def _capture_decode(self) -> None:
        """Capture the decode forward once, on static input buffers with
        every slot inactive (so the warm-up runs, which build K4 and warm
        the GEMM libraries, write only to the trash page)."""
        B, dev = self.b_slots, self.device
        self._g_pt = torch.zeros((B, self.pages_per_slot), dtype=torch.int32, device=dev)
        self._g_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._g_tok = torch.zeros((B,), dtype=torch.long, device=dev)
        self._g_active = torch.zeros((B,), dtype=torch.bool, device=dev)
        args = (self._g_pt, self._g_len, self._g_tok, self._g_active)
        from ..comm import get_comms_logger

        log = get_comms_logger()
        logged = {}   # the logger's totals after the warm-up runs

        def snapshot():
            if log is not None:
                logged.update(log.totals_by_axis())

        self._graph, self._g_logits, self.graph_k4_launches = capture_graph(
            lambda: self._decode_forward(*args), dev, self._region, snapshot)
        if log is not None:
            self.graph_collectives = {
                op: {axes: rec["calls"] - logged.get(op, {}).get(axes, {}).get("calls", 0)
                     for axes, rec in by_axes.items()}
                for op, by_axes in log.totals_by_axis().items()}
        self.captures += 1
        if self.ranks > 1:   # the group's teardown closes it first
            from .. import comm

            comm.register_capture(self)

    def decode(self, page_table: np.ndarray, lengths: np.ndarray,
               last_tok: np.ndarray, active: np.ndarray, lanes) -> np.ndarray:
        """One decode step over all slots; returns the sampled [B_slots]
        tokens (numpy) and updates the pools in place.  The token sampled
        for a slot sits at stream position ``lengths + 1``, the counter
        ``generate(sampling=...)`` derives for it."""
        with torch.no_grad():
            if self._graph is not None:
                if page_table.shape != tuple(self._g_pt.shape):
                    raise ValueError(
                        f"page table {page_table.shape} does not match the "
                        f"captured decode step's {tuple(self._g_pt.shape)}")
                self._g_pt.copy_(torch.from_numpy(page_table))
                self._g_len.copy_(torch.from_numpy(lengths))
                self._g_tok.copy_(torch.from_numpy(last_tok.astype(np.int64)))
                self._g_active.copy_(torch.from_numpy(active))
                self._graph.replay()
                self.replays += 1
                logits = self._g_logits[:, -1, :]
            else:
                dev = self.device
                logits = self._decode_forward(
                    torch.from_numpy(page_table).to(dev),
                    torch.from_numpy(lengths).to(dev),
                    torch.from_numpy(last_tok.astype(np.int64)).to(dev),
                    torch.from_numpy(active).to(dev))[:, -1, :]
            temp, top_k, top_p, seeds = lanes
            pos = (lengths + 1).tolist()
            nxt = sample_tokens(
                logits, temp, top_k, top_p,
                lambda: [position_generator(int(s), p, self.device)
                         for s, p in zip(seeds, pos)])
            return nxt.cpu().numpy()

    # ----------------------------------------------------------- prefill

    def prefill(self, s_pad: int, pt_row: np.ndarray, tokens: np.ndarray,
                n_real: int, start: int, lane_t: float, lane_k: int,
                lane_p: float, lane_s: int, slot: Optional[int] = None) -> int:
        """One bucketed prefill (``tokens [1, s_pad]``, the first ``n_real``
        real, at slot position ``start``); returns the first sampled token,
        which sits at stream position ``start + n_real``.  ``slot`` names
        the adapter row the prefill reads (the registry's; zeros when
        None)."""
        self._prefill_buckets[s_pad] = self._prefill_buckets.get(s_pad, 0) + 1
        dev = self.device
        ad = None
        if self._ad is not None:
            ad = self.adapter_operand(0 if slot is None else slot)
            if slot is None:   # a probe: the base model
                ad = {"scale": torch.zeros_like(ad["scale"]), "factors": ad["factors"]}
        with torch.no_grad(), self._region():
            seq_mask = (torch.arange(s_pad, device=dev) < n_real)[None, :]
            logits, _ = self.model.apply_paged(
                self.params, torch.from_numpy(tokens).to(dev).long(),
                paged_pool_cache(self.pools), torch.from_numpy(pt_row).to(dev),
                torch.tensor([start], dtype=torch.int32, device=dev), seq_mask,
                adapters=ad)
            lg = logits[0, n_real - 1][None]
            nxt = sample_tokens(
                lg, torch.tensor([lane_t], device=dev),
                torch.tensor([lane_k], device=dev),
                torch.tensor([lane_p], device=dev),
                lambda: [position_generator(lane_s, start + n_real, dev)])
            return int(nxt[0])

    # --------------------------------------------------------------- COW

    def cow(self, src: int, dst: int) -> None:
        """Snapshot physical page ``src`` onto ``dst`` across all layers
        (the copy-on-write boundary page), in place."""
        with torch.no_grad():
            self._cow_prog(self.pools, int(src), int(dst))

    # --------------------------------------------------------- tier moves

    def extract(self, src: int):
        """Demote half of the tier move: physical page ``src`` copied to
        host slabs in canonical pool order (pinned, asynchronous on a
        card).  Returns ``(slabs, event)``; the pool is only read."""
        with torch.no_grad():
            return extract_pool_page(self.pools, int(src),
                                     pin=self.device.type == "cuda")

    def inject(self, slabs, dst: int) -> None:
        """Promote half: the host slabs written into physical page ``dst``
        on the current stream (the one the decode graph replays on)."""
        with torch.no_grad():
            inject_pool_page(self.pools, slabs, int(dst))

    # ----------------------------------------------------- weight swap

    def update_params(self, params, adopt: bool = False) -> bool:
        """Swap in a new parameter tree (cut to this rank's shards first;
        its structure, shapes and dtypes must equal the live tree's, and a
        quantized tree is refused).  While the live tensors are the
        caller's, the swap moves this executor onto a copy of the new tree
        (``adopt``: onto the new tree's own tensors, which the caller gives
        up) and recaptures the decode graph over it; afterwards it copies
        into them in place.  Returns whether the tensors moved."""
        placed = swap_tree(self.model, self.params, params, self.mesh)
        moved = not self.owns_params
        with torch.no_grad():
            if moved:
                self.params = placed if adopt else tree_map(
                    lambda x: x.detach().clone(), placed)
                self.owns_params = True
            else:
                copy_tree(self.params, placed)
        if moved and self._graph is not None:
            torch.cuda.synchronize(self.device)
            self._graph.reset()
            self._capture_decode()
        return moved

    # ------------------------------------------------------------- lanes

    def lanes(self, temp, top_k, top_p, seeds):
        """Cached device copy of the per-slot lane vectors (the seeds stay
        on the host: they seed the per-row generators); the engine
        invalidates it on admission and retirement."""
        if self._lanes_device is None:
            dev = self.device
            self._lanes_device = (torch.from_numpy(temp).to(dev),
                                  torch.from_numpy(top_k).to(dev),
                                  torch.from_numpy(top_p).to(dev),
                                  [int(s) for s in seeds])
        return self._lanes_device

    def invalidate_lanes(self) -> None:
        self._lanes_device = None

    def pool_alive(self) -> bool:
        """False once :meth:`close` released the pool."""
        return bool(self.pools)

    def close(self) -> None:
        """Release the decode graph (``reset()``: its captured work goes
        with it, whoever else holds the graph object) and the pool.  A live
        graph holding NCCL collectives keeps the group's teardown waiting
        (seen on 4 H100s, NCCL 2.28.9): ``comm.destroy_process_group()``
        closes every registered executor first."""
        if self._graph is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._graph.reset()
        self._graph = self._g_logits = None
        self.pools = ()
        self._ad = None

    def program_inventory(self) -> Dict[str, Any]:
        inv = {"decode": 1, "prefill_buckets": sorted(self._prefill_buckets)}
        if self._cow_prog is not None:
            inv["cow"] = 1
        if self.host_tier:
            inv["tier"] = {"extract": 1, "inject": 1}
        return inv

    def adopt_programs(self, old: "MeshExecutor") -> None:
        """Warm-restart carry: the dead executor's prefill bucket record.
        Its CUDA graph is bound to the dead pool's addresses, so this
        executor captured its own at build (``captures`` counts it)."""
        for b, n in old._prefill_buckets.items():
            self._prefill_buckets.setdefault(b, 0)
