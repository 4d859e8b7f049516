"""The device half of the serving engine, on one device (counterpart of
``deepspeed_tpu/inference/execution.py`` ``MeshExecutor``).

:class:`~.serving.ServingEngine` keeps the host scheduling (admission, page
tables, the prefix index, deadlines: pure Python over numpy) and calls four
entry points here: :meth:`MeshExecutor.decode`, :meth:`MeshExecutor.prefill`,
:meth:`MeshExecutor.cow` and the lane cache.  This class owns the paged KV
pool and runs the model over it.

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
  captures": :attr:`captures` stays 1.  On the CPU the same forward runs
  eagerly, as the caller asked;
- **prefill** eagerly, one ``[1, s_pad]`` bucket shape per prompt-length
  bucket (the bucket set is the program inventory);
- **COW** as one in-place page copy across layers.

On a mesh (``mesh=``, the JAX executor's layout): one process per device,
every rank running this executor and the same scheduler.  The params are
the rank's model-axis shards (:func:`place_params`), the KV pool is
``[L, P, page, Hkv/tp, hd]`` (the rank's KV heads; ``kv_heads % tp`` is
checked first), pages and the host arrays are the same on every rank.
The model runs its tensor-parallel path (``parallel.tensor_parallel``):
each layer's two all-reduces and the logits' all-gather run inside the
decode step, so they are captured in its one CUDA graph (the eager
warm-up runs on the capture stream create the NCCL communicators first),
and every rank samples the same token from the same gathered logits.

Not ported (``NotImplementedError`` naming the ROADMAP item): the host
tier (item 7), per-slot adapters (item 7), live weight updates (item 11)
and per-program accounting (item 12).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..accelerator import resolve_device
from ..parallel import tensor_parallel
from ..models.transformer import cow_copy_pool, paged_pool_cache, paged_pool_tuple
from ..ops.kernels.decode_attention import decode_attention
from .engine import check_mesh_model, install_mesh, place_params
from .sampling import position_generator, sample_tokens

__all__ = ["MeshExecutor", "pool_bytes", "place_params"]

_GRAPH_WARMUP = 2   # eager runs on the capture stream before capture


def pool_bytes(*pools, tp: int = 1) -> Dict[str, int]:
    """Total and per-device bytes of the pool tensors: this rank holds
    ``1/tp`` of the heads, so the pool over the mesh is ``tp`` times its."""
    per = sum(a.numel() * a.element_size() for a in pools)
    return {"total": per * tp, "per_device": per}


class MeshExecutor:
    """Paged KV pool + the decode / prefill / COW steps on one device."""

    def __init__(self, model, params, num_pages: int, page_size: int,
                 b_slots: int, pages_per_slot: int, dtype=None, kv_dtype=None,
                 mesh=None, prefix_cache: bool = True, host_tier: bool = False,
                 device=None):
        self.mesh, self.tp, self.ranks = self._install_mesh(model, mesh), 1, 1
        if self.mesh is not None:
            import torch.distributed as dist

            self.tp = check_mesh_model(model, self.mesh)
            self.ranks = dist.get_world_size()
        if host_tier:
            raise NotImplementedError(
                "the host-RAM KV tier (host_tier_pages) is not ported yet "
                "(ROADMAP queue 1, item 7)")
        self.model = model
        # the rank's model-axis shards (a whole tree is cut here)
        self.params = place_params(model, params, self.mesh)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.b_slots = int(b_slots)
        self.device = resolve_device(device)
        with self._region():
            cache = model.init_paged_cache(self.num_pages, self.page_size,
                                           dtype=dtype, kv_dtype=kv_dtype,
                                           device=self.device)
        self.pools = paged_pool_tuple(cache)
        self.pool_bytes = pool_bytes(*self.pools, tp=self.tp)
        self._prefill_buckets: Dict[int, int] = {}   # bucket -> calls
        self._cow_prog = cow_copy_pool if prefix_cache else None
        self._lanes_device = None
        # the CUDA graph of the decode step (None on the CPU)
        self.captures = 0
        self.replays = 0
        self.graph_k4_launches = 0   # K4 launches recorded in the graph
        # collectives recorded in the graph, {op: {axes: calls}} (read from
        # the comms logger during the capture; {} without one)
        self.graph_collectives: Dict[str, Dict[str, int]] = {}
        self._graph = None
        if self.device.type == "cuda":
            self._capture_decode(int(pages_per_slot))

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

    # ------------------------------------------------------------ decode

    def _decode_forward(self, page_table, lengths, last_tok, active):
        """Every slot's next-token logits [B, 1, V]: write each slot's last
        token at position ``lengths`` (inactive slots write to the trash
        page) and attend through the page table."""
        with self._region():
            logits, _ = self.model.apply_paged(
                self.params, last_tok[:, None], paged_pool_cache(self.pools),
                page_table, lengths, active[:, None])
        return logits

    def _capture_decode(self, maxp: int) -> None:
        """Capture the decode forward once, on static input buffers with
        every slot inactive (so the warm-up runs, which build K4 and warm
        the GEMM libraries, write only to the trash page)."""
        B, dev = self.b_slots, self.device
        self._g_pt = torch.zeros((B, maxp), dtype=torch.int32, device=dev)
        self._g_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._g_tok = torch.zeros((B,), dtype=torch.long, device=dev)
        self._g_active = torch.zeros((B,), dtype=torch.bool, device=dev)
        args = (self._g_pt, self._g_len, self._g_tok, self._g_active)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(_GRAPH_WARMUP):
                self._decode_forward(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        from ..comm import get_comms_logger

        log = get_comms_logger()
        logged = log.totals_by_axis() if log is not None else {}
        before = decode_attention.launches
        # captured on the warm-up stream: the model axis's NCCL collectives
        # were first issued there
        with torch.no_grad(), torch.cuda.graph(graph, stream=side):
            self._g_logits = self._decode_forward(*args)
        self.graph_k4_launches = decode_attention.launches - before
        if log is not None:
            self.graph_collectives = {
                op: {axes: rec["calls"] - logged.get(op, {}).get(axes, {}).get("calls", 0)
                     for axes, rec in by_axes.items()}
                for op, by_axes in log.totals_by_axis().items()}
        self._graph = graph
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
                lane_p: float, lane_s: int) -> int:
        """One bucketed prefill (``tokens [1, s_pad]``, the first ``n_real``
        real, at slot position ``start``); returns the first sampled token,
        which sits at stream position ``start + n_real``."""
        self._prefill_buckets[s_pad] = self._prefill_buckets.get(s_pad, 0) + 1
        dev = self.device
        with torch.no_grad(), self._region():
            seq_mask = (torch.arange(s_pad, device=dev) < n_real)[None, :]
            logits, _ = self.model.apply_paged(
                self.params, torch.from_numpy(tokens).to(dev).long(),
                paged_pool_cache(self.pools), torch.from_numpy(pt_row).to(dev),
                torch.tensor([start], dtype=torch.int32, device=dev), seq_mask)
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

    def program_inventory(self) -> Dict[str, Any]:
        inv = {"decode": 1, "prefill_buckets": sorted(self._prefill_buckets)}
        if self._cow_prog is not None:
            inv["cow"] = 1
        return inv
