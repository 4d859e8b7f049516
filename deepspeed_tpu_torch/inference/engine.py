"""InferenceEngine (reference ``deepspeed/inference/engine.py:89``;
counterpart of ``deepspeed_tpu/inference/engine.py``).

``forward`` runs the model's full-sequence forward (prefill and scoring);
``generate`` runs one prefill plus a decode loop over a contiguous KV cache,
with the JAX engine's shapes: prompts right-padded to a power-of-two bucket
(>= 16) and the cache rounded up to a multiple of 128 slots.  PyTorch runs
eagerly, so where the JAX engine compiles one program per shape the port
runs the same steps as a Python loop under ``torch.inference_mode()``.

``serving()`` builds the paged continuous-batching
:class:`~.serving.ServingEngine` over the engine's params and device
(with its extras: ``kv_dtype="int8"``, ``host_tier_pages``,
``speculative``, ``adapters``, ``probe_after_ticks``);
``supervised_serving()`` wraps it in a
:class:`~.serving_supervisor.ServingSupervisor` (warm restarts with an
exact replay).

Tensor parallelism (``mesh=`` from ``parallel.mesh.initialize_serving_mesh``,
or ``tensor_parallel.tp_size``): one process per device, each holding its
model-axis shards.  Auto-TP for a ``models.CausalLM`` takes the model's
``param_specs``, the Megatron layout of the same function (padded where
the model axis does not divide a dim).  Any other tree (a bare
``apply_fn``, another model) takes the JAX package's ``auto_tp_specs``
(each leaf's largest dim, where the axis divides it) and runs under
DTensor sharding propagation: each leaf a DTensor of its shard on the
'model' sub-mesh, the inputs replicated, the output redistributed to
``Replicate``.  ``forward`` and ``generate`` run the model's
tensor-parallel path (``parallel.tensor_parallel.region``): the KV cache
holds the rank's KV heads, the logits are gathered before sampling, so
every rank picks the same tokens.

Weight-only quantization (``dtype="int8"`` or the ``quant`` block,
reference ZeRO-Inference): the engine quantizes the tree leaf by leaf on
its device (``inference/quantization.py``), one shard (tp=1) as in the JAX
package; ``forward``, ``generate`` and ``serving()`` read the quantized
tree, which ``models/transformer.py`` dequantizes a layer at a time.  A
model without a KV cache (a bare ``apply_fn``) generates by the
full-recompute fallback (``_generate_uncached``).

Expert parallelism (``moe.ep_size``, as the JAX engine): the mesh gets
an 'expert' axis and each rank holds its experts of every MoE leaf; the
capacity path exchanges its buffers over the axis.  Paged serving keeps
the JAX package's ('data', 'model') serving mesh with the experts whole.

``serving_fleet`` builds a :class:`~.fleet.FleetRouter` over supervised
serving engines in this process (``fleet.py``; one member per process is
``fleet_daemon.py`` behind the ``fleet_member`` entry point).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..accelerator.real_accelerator import resolve_device
from ..parallel import tensor_parallel
from ..utils.logging import log_dist, logger
from .config import DeepSpeedInferenceConfig
from .quantization import dequantize_params, quantize_params
from .sampling import SamplingParams, position_generator, sample_tokens


def place_params(model, params, mesh, dtype=None, device=None):
    """``params`` as this rank's model-axis shards of ``model.param_specs``
    on ``mesh`` (the JAX package's ``place_params``): a tree already of the
    shards' shapes passes through, a whole tree is cut (before any cast or
    move, so the whole tree is never cast on the device).  ``mesh=None`` or
    a model axis of 1 keeps the tree whole; a model without
    ``shard_params`` is cut by :func:`~..parallel.tensor_parallel.
    auto_tp_specs`.  Then cast to ``dtype`` and moved to ``device`` when
    given."""
    if mesh is not None and params is not None and not hasattr(model, "shard_params"):
        from .. import comm
        from ..parallel.mesh import MeshLayout, layout_of

        n = (mesh if isinstance(mesh, MeshLayout) else layout_of(mesh)).tp
        if n > 1:
            params = tensor_parallel.slice_tree(
                params, tensor_parallel.auto_tp_specs(params, n),
                comm.axis_index("model"), n)
    elif mesh is not None and params is not None:
        from .. import comm
        from ..parallel.mesh import MeshLayout, layout_of
        from ..utils.tree import tree_leaves

        layout = mesh if isinstance(mesh, MeshLayout) else layout_of(mesh)
        n = layout.tp
        # the shards' shapes: the whole tree's on the meta device, cut
        whole = model.init_fn(torch.Generator(), device="meta")
        if layout.ep > 1:   # experts cut over 'expert' (moe.ep_size)
            cuts = {"model": (0, n), "expert": (0, layout.ep)}
            shards = model.cut_params(whole, cuts)
            if any(tuple(x.shape) != tuple(w.shape) for x, w in zip(
                    tree_leaves(params), tree_leaves(shards))):
                params = model.cut_params(params, {
                    "model": (comm.axis_index("model"), n),
                    "expert": (comm.axis_index("expert"), layout.ep)})
        else:
            shards = model.shard_params(whole, 0, n)
            if any(tuple(x.shape) != tuple(w.shape) for x, w in zip(
                    tree_leaves(params), tree_leaves(shards))):
                params = model.shard_params(params, comm.axis_index("model"), n)
    if dtype is not None and params is not None:
        params = _cast_tree(params, dtype, device)
    return params


def check_mesh_model(model, mesh) -> int:
    """The mesh's model-axis size (a handle of a rank outside a serving
    mesh raises, naming the rank)."""
    from ..parallel.mesh import MeshLayout, OutsideMesh, layout_of

    if isinstance(mesh, OutsideMesh):
        mesh.refuse()
    return (mesh if isinstance(mesh, MeshLayout) else layout_of(mesh)).tp


def install_mesh(mesh, tp: int = 1, ep: int = 1):
    """``mesh`` (a ``parallel.mesh.MeshLayout`` or a mesh built by
    ``parallel.mesh``; None: the world with a model axis of ``tp`` and an
    expert axis of ``ep``) installed as the global mesh over the process
    group, which must exist (one rank per device)."""
    import torch.distributed as dist

    from ..parallel import mesh as mesh_mod

    if isinstance(mesh, mesh_mod.OutsideMesh):
        mesh.refuse()
    if mesh is not None and not (isinstance(mesh, mesh_mod.MeshLayout)
                                 or hasattr(mesh, "mesh_dim_names")):
        raise TypeError(f"mesh={type(mesh).__name__}: pass a mesh from "
                        "parallel.mesh.initialize_serving_mesh or a MeshLayout")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("tensor-parallel inference (mesh=, tp_size > 1) needs a "
                           "process group, one rank per device: call "
                           "deepspeed_tpu_torch.comm.init_distributed() (or run "
                           "under torchrun) first")
    if mesh is None:
        mesh = mesh_mod.MeshLayout.from_world(dist.get_world_size(), tp=tp, ep=ep)
    if isinstance(mesh, mesh_mod.MeshLayout):
        return mesh_mod.initialize_mesh(mesh)
    mesh_mod.set_mesh(mesh)
    return mesh


def _cast_tree(tree, dtype: torch.dtype, device: torch.device):
    """Floating leaves -> ``dtype`` on ``device`` (a no-op for leaves already
    there), integer leaves moved only.  One leaf at a time, so peak memory
    stays near one copy of the tree plus one leaf."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):   # a PR-MoE pyramid's layer list
        return type(tree)(_cast_tree(v, dtype, device) for v in tree)
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)


class _DequantizingModel:
    """A model that cannot read ``QuantizedWeight`` leaves, its cached and
    paged contracts (those it has) called on the tree dequantized whole
    (the JAX engine's shim)."""

    def __init__(self, model):
        self._inner = model

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in ("apply_cached", "apply_paged"):
            return lambda params, *a, **k: attr(dequantize_params(params), *a, **k)
        return attr


class InferenceEngine:
    _warned_uncached = False   # one-time fallback warning (class-wide)

    def __init__(self, model: Any = None,
                 config: Optional[DeepSpeedInferenceConfig] = None,
                 apply_fn: Optional[Callable] = None, params: Any = None,
                 device=None, mesh=None):
        self._config = config or DeepSpeedInferenceConfig()
        if self._config.use_flash_decode:
            logger.warning("use_flash_decode is a retired knob, accepted for "
                           "config compatibility and ignored")
        tp = (self._config.tensor_parallel.tp_size
              if self._config.tensor_parallel.enabled else 1)
        self.device = resolve_device(device)
        self._model = model if hasattr(model, "apply_cached") else None
        if model is not None:
            apply_fn = apply_fn or getattr(model, "apply_fn", None)
            params = params if params is not None else getattr(model, "params", None)
        if apply_fn is None:
            raise ValueError("InferenceEngine needs apply_fn(params, *args) "
                             "(directly or via a model adapter)")
        # weight-only quantization (reference ZeRO-Inference int8): weights
        # int8/int4 at rest, dequantized at use
        self._quant = self._config.weights_quantized
        if self._quant and params is None:
            raise ValueError(
                "weight quantization (dtype int8 / quant.enabled) needs a param "
                "tree: a bare apply_fn engine has no weights to quantize")
        self.apply_fn = apply_fn
        self.mesh = self._resolve_mesh(mesh, tp, model)
        if self._quant:
            if self.tp != 1:
                raise NotImplementedError(
                    "quantized inference is single-shard (tp=1) for now: blockwise "
                    "scales do not carry TP specs")
            self.params = quantize_params(
                place_params(model, params, self.mesh), bits=self._config.quant.num_bits,
                compute_dtype=self._config.compute_torch_dtype, device=self.device)
            if not getattr(model, "reads_quantized", False):
                # a model that reads plain tensors gets the tree dequantized
                # whole at each call, as the JAX engine does for every model
                self.apply_fn = lambda p, *a, **k: apply_fn(dequantize_params(p), *a, **k)
                if self._model is not None:
                    self._model = _DequantizingModel(self._model)
        else:
            self.params = place_params(model, params, self.mesh,
                                       self._config.torch_dtype, self.device)
        # a generic tree on a model axis above 1: DTensor sharding propagation
        self._generic_specs = None
        if self.tp > 1 and not hasattr(model, "shard_params") and params is not None:
            self._generic_specs = tensor_parallel.auto_tp_specs(params, self.tp)
        log_dist(f"inference engine ready: device={self.device} "
                 f"dtype={self._config.dtype} tp={self.tp}"
                 + (f" quant=int{self._config.quant.num_bits}" if self._quant else ""),
                 ranks=[0])

    def _resolve_mesh(self, mesh, tp: int, model):
        """The serving mesh (``mesh=``, else one built for ``tp_size`` > 1
        over the process group), installed as the global mesh; None for one
        device."""
        self.tp = 1
        ep = self._config.moe.ep_size   # JAX inference/engine.py:79-82
        if mesh is None and tp == 1 and ep == 1:
            return None
        mesh = install_mesh(mesh, tp, ep)
        n = check_mesh_model(model, mesh)
        if tp not in (1, n):
            raise ValueError(f"tensor_parallel.tp_size={tp} != the mesh's model "
                             f"axis ({n})")
        self.tp = n
        return mesh

    def _region(self):
        """The model's tensor-parallel path on a mesh (copies for
        collectives at a model axis of 1), its plain path otherwise (and
        for a generic tree, which DTensor shards)."""
        return tensor_parallel.region(self.mesh is not None
                                      and self._generic_specs is None)

    @property
    def model(self):
        """The wrapped model adapter (reference InferenceEngine.module)."""
        return self._model

    def serving(self, **kwargs):
        """A continuous-batching :class:`~.serving.ServingEngine` sharing
        this engine's model, params and device, so serving numerics follow
        :meth:`generate`'s (greedy token-exact in fp32; in bf16 the paged
        decode attention rounds differently).  Keyword arguments are the
        ServingEngine's (``b_slots``, ``page_size``, ``max_model_len``,
        ``num_pages``, ``prefix_cache``, ``kv_dtype``, ``host_tier_pages``,
        ``speculative``, ``adapters``, ``probe_after_ticks``, ...).  The
        serving engine never writes these shared tensors: its first
        ``update_params``/``fuse_adapter`` moves it onto its own copy, so
        this engine and its other servers keep their weights."""
        if self._model is None or not hasattr(self._model, "apply_paged"):
            raise ValueError(
                "serving() needs a model with the paged decode contract "
                "(apply_paged); see models.CausalLM")
        from ..parallel.mesh import MeshLayout, layout_of

        if self.mesh is not None and (self.mesh if isinstance(self.mesh, MeshLayout)
                                      else layout_of(self.mesh)).ep > 1:
            raise ValueError(
                "paged serving runs on a ('data', 'model') serving mesh with the "
                "experts whole, as in the JAX package: build the engine without "
                "moe.ep_size (initialize_serving_mesh(tp=...))")
        from .serving import ServingEngine

        kwargs.setdefault("device", self.device)
        kwargs.setdefault("mesh", self.mesh)
        if self._quant and kwargs.get("dtype") is None:
            # the KV pool computes in the compute dtype, never in the
            # weights' storage dtype (also over an explicit dtype=None)
            kwargs["dtype"] = self._config.compute_torch_dtype
            act = getattr(getattr(self._model, "config", None), "dtype", kwargs["dtype"])
            if act != kwargs["dtype"]:
                raise ValueError(
                    f"serving() on a quantized engine keeps its KV pool in the "
                    f"compute dtype {kwargs['dtype']}, but the model computes in "
                    f"{act}; the paged decode kernel reads queries and pages in "
                    f"one dtype: build the model with dtype={kwargs['dtype']} "
                    "(CausalLM.from_hf does)")
        return ServingEngine(self._model, self.params, **kwargs)

    def supervised_serving(self, max_restarts: int = 5, **kwargs):
        """A :class:`~.serving_supervisor.ServingSupervisor` whose engine
        factory is :meth:`serving` with these kwargs: a failed tick
        warm-restarts a fresh KV pool (its graphs recaptured) and replays
        queue and in-flight requests token-exactly."""
        from .serving_supervisor import ServingSupervisor

        return ServingSupervisor(lambda: self.serving(**kwargs),
                                 max_restarts=max_restarts,
                                 monitor=kwargs.get("monitor"))

    def serving_fleet(self, n_engines: int = None, coord_dir: str = None,
                      store=None, router_id: str = "router0",
                      max_restarts: int = 5, lease_s: float = None,
                      miss_limit: int = None, max_fleet_queue: int = None,
                      fleet_monitor=None, metrics_port: int = None,
                      **kwargs):
        """A :class:`~.fleet.FleetRouter` over ``n_engines`` supervised
        serving engines in this process (each a :meth:`supervised_serving`
        sharing this engine's model and params, with a KV pool and decode
        graphs of its own), leased on a coordination store (``store=``, or
        ``coord_dir`` for the file backend).  ``metrics_port=0`` gives every
        member its own ephemeral /metrics endpoint.

        ``n_engines`` / ``coord_dir`` / ``lease_s`` / ``miss_limit`` left
        unset fall back to the launcher's exported contract
        (``DS_TPU_FLEET_SIZE`` / ``_COORD_DIR`` / ``_LEASE`` /
        ``_MISS_LIMIT``, ``--fleet N ...``), then to 2 / 5.0 s / 3; an
        explicit argument always wins.  See docs/FLEET.md."""
        import os

        from ..elasticity.coordination import FileCoordinationStore
        from .fleet import FleetMember, FleetRouter

        env = os.environ
        if n_engines is None:
            n_engines = int(env.get("DS_TPU_FLEET_SIZE", 2))
        if lease_s is None:
            lease_s = float(env.get("DS_TPU_FLEET_LEASE", 5.0))
        if miss_limit is None:
            miss_limit = int(env.get("DS_TPU_FLEET_MISS_LIMIT", 3))
        if store is None:
            coord_dir = coord_dir or env.get("DS_TPU_FLEET_COORD_DIR")
            if not coord_dir:
                raise ValueError(
                    "serving_fleet needs store= or coord_dir= (the "
                    "coordination store engines lease on; the launcher's "
                    "--fleet flags export DS_TPU_FLEET_COORD_DIR)")
            store = FileCoordinationStore(coord_dir)
        members = [
            FleetMember(f"engine{i}",
                        self.supervised_serving(max_restarts=max_restarts,
                                                **kwargs),
                        store, lease_s=lease_s, metrics_port=metrics_port)
            for i in range(int(n_engines))]
        return FleetRouter(store, members, router_id=router_id,
                           lease_s=lease_s, miss_limit=miss_limit,
                           max_fleet_queue=max_fleet_queue,
                           monitor=fleet_monitor)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def forward(self, input_ids, *args, **kwargs):
        with torch.inference_mode(), self._region():
            tokens = self._tensor(input_ids, torch.long)
            if self._generic_specs is not None:
                return tensor_parallel.replicated(self.apply_fn(
                    tensor_parallel.as_dtensors(self.params, self._generic_specs),
                    *tensor_parallel.as_dtensors((tokens,) + args), **kwargs))
            if self.params is not None:
                return self.apply_fn(self.params, tokens, *args, **kwargs)
            return self.apply_fn(tokens, *args, **kwargs)

    __call__ = forward

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """Prompt-length bucket (next power of two >= 16)."""
        b = 16
        while b < n:
            b *= 2
        return b

    @staticmethod
    def _pad_prompt(input_ids, attention_mask):
        """Right-pad the (possibly ragged) prompt to its pow2 bucket and
        derive the cumulative positions (pads repeat the last real index)."""
        ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor)
                         else input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        B, S = ids.shape
        mask = (np.ones_like(ids, dtype=bool) if attention_mask is None
                else np.asarray(attention_mask.cpu()
                                if isinstance(attention_mask, torch.Tensor)
                                else attention_mask, dtype=bool))
        S_pad = InferenceEngine._bucket(S)
        toks = np.zeros((B, S_pad), ids.dtype)
        toks[:, :S] = ids
        mpad = np.zeros((B, S_pad), bool)
        mpad[:, :S] = mask
        pos = np.maximum(np.cumsum(mpad, axis=1) - 1, 0).astype(np.int32)
        return ids, toks, mpad, pos, B, S_pad

    def _decode(self, model, params, input_ids, attention_mask, max_new: int,
                eos_token_id: Optional[int], choose):
        """Prefill + ``max_new`` decode steps; ``choose(logits [B,V],
        positions [B]) -> tokens [B]`` picks each token.  Rows that emitted
        ``eos_token_id`` repeat it verbatim."""
        ids, toks, mpad, pos, B, S_pad = self._pad_prompt(input_ids,
                                                          attention_mask)
        T_cache = -(-(S_pad + max_new) // 128) * 128
        params = self.params if params is None else params
        with torch.inference_mode(), self._region():
            mask_t = self._tensor(mpad)
            cache = model.init_cache(B, T_cache, dtype=model.config.dtype,
                                     device=self.device)
            logits, cache = model.apply_cached(
                params, self._tensor(toks, torch.long), cache,
                self._tensor(pos), mask_t)
            lengths = mask_t.sum(-1)                                   # [B]
            last = logits[torch.arange(B, device=self.device), lengths - 1]
            eos = -1 if eos_token_id is None else int(eos_token_id)
            done = torch.zeros(B, dtype=torch.bool, device=self.device)
            cur = lengths.clone()
            out = []
            for step in range(max_new):
                tok = choose(last, cur)
                tok = torch.where(done, torch.full_like(tok, eos), tok)
                done = done | (tok == eos)
                out.append(tok)
                if step + 1 < max_new:   # the last token's logits are unused
                    lg, cache = model.apply_cached(
                        params, tok[:, None], cache, cur[:, None], ~done[:, None])
                    last = lg[:, 0]
                cur = cur + 1
            ids_t = self._tensor(ids)
            new = (torch.stack(out, dim=1) if out else
                   torch.zeros((B, 0), dtype=torch.long, device=self.device))
            return torch.cat([ids_t, new.to(ids_t.dtype)], dim=1)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, greedy: bool = True,
                 rng: Optional[torch.Generator] = None, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, attention_mask=None,
                 model=None, params=None, sampling=None):
        """KV-cached autoregressive generation.

        Prompts may be right-padded ragged rows (pass ``attention_mask``).
        Returns the original ids with ``max_new_tokens`` tokens appended, as
        a tensor on the engine's device.  ``sampling`` — one
        :class:`SamplingParams` or one per row — switches to per-row lanes
        with counter-based generators (deterministic per seed and
        position); it excludes the legacy ``greedy``/``rng``/
        ``temperature``/``top_k``/``top_p`` knobs, where ``rng`` is one
        ``torch.Generator`` drawn from in order.  A model without a KV
        cache takes the full-recompute fallback (:meth:`_generate_uncached`).
        """
        if (model is not None and model is not self._model
                and self._quant and params is None):
            raise NotImplementedError(
                "generate(model=...) on a quantized engine needs explicit "
                "params (the JAX engine's rule): self.params is a "
                "QuantizedWeight tree quantized for the engine's own model")
        model = model or self._model
        if sampling is not None:
            if rng is not None:
                raise ValueError(
                    "generate(sampling=...) derives its generators from "
                    "SamplingParams.seed — rng= would be silently ignored")
            if not greedy or temperature != 1.0 or top_k or top_p < 1.0:
                raise ValueError(
                    "generate(sampling=...) is mutually exclusive with the "
                    "legacy greedy/temperature/top_k/top_p knobs")
            if model is None or not hasattr(model, "apply_cached"):
                raise NotImplementedError(
                    "generate(sampling=...) requires a KV-cache-capable model "
                    "(apply_cached); the full-recompute fallback has no lane path")
            return self._generate_lanes(model, input_ids, max_new_tokens,
                                        eos_token_id, sampling,
                                        attention_mask, params)
        if model is None or not hasattr(model, "apply_cached"):
            if attention_mask is not None:
                raise NotImplementedError(
                    "attention_mask requires a KV-cache-capable model "
                    "(apply_cached); the full-recompute fallback would "
                    "silently attend to pad tokens")
            if top_k or top_p < 1.0:
                raise NotImplementedError(
                    "top_k/top_p require a KV-cache-capable model "
                    "(apply_cached); the fallback would silently sample the "
                    "full distribution")
            return self._generate_uncached(input_ids, max_new_tokens, eos_token_id,
                                           greedy, rng, temperature, params=params)
        if greedy:
            def choose(lg, pos):
                return torch.argmax(lg, dim=-1)
        else:
            if rng is None:
                rng = torch.Generator(device=self.device)
                rng.manual_seed(0)

            def choose(lg, pos):
                B = lg.shape[0]
                return sample_tokens(
                    lg, torch.full((B,), float(temperature), device=lg.device),
                    torch.full((B,), int(top_k), device=lg.device),
                    torch.full((B,), float(top_p), device=lg.device),
                    [rng] * B)
        return self._decode(model, params, input_ids, attention_mask,
                            max_new_tokens, eos_token_id, choose)

    def _generate_lanes(self, model, input_ids, max_new_tokens, eos_token_id,
                        sampling, attention_mask, params):
        B = 1 if np.ndim(input_ids) == 1 else len(input_ids)
        lanes = ([sampling] * B if isinstance(sampling, SamplingParams)
                 else list(sampling))
        if len(lanes) != B:
            raise ValueError(f"sampling: got {len(lanes)} SamplingParams for a "
                             f"batch of {B} rows (pass one, or one per row)")
        for sp in lanes:
            sp.validate()
        dev = self.device
        temp = torch.tensor([sp.temperature for sp in lanes], device=dev)
        top_k = torch.tensor([sp.top_k for sp in lanes], device=dev)
        top_p = torch.tensor([sp.top_p for sp in lanes], device=dev)

        def choose(lg, pos):
            # `pos` is the stream position each sampled token will occupy
            def gens():
                return [position_generator(sp.seed, int(p), dev)
                        for sp, p in zip(lanes, pos.tolist())]
            return sample_tokens(lg, temp, top_k, top_p, gens)

        return self._decode(model, params, input_ids, attention_mask,
                            max_new_tokens, eos_token_id, choose)

    def _generate_uncached(self, input_ids, max_new_tokens: int = 32,
                           eos_token_id: Optional[int] = None, greedy: bool = True,
                           rng: Optional[torch.Generator] = None,
                           temperature: float = 1.0, params=None):
        """Full-recompute fallback for any logits-returning ``apply_fn``
        (the JAX engine's ``_generate_uncached``): one full forward per new
        token, on the sequence right-padded to its :meth:`_bucket`, the
        logits read at the last real position, so the forward sees O(log)
        shapes; rows stop early once every row's last token is
        ``eos_token_id``.

        Bucketing needs a causal ``apply_fn`` (tail pads must not change
        earlier positions' logits).  The first padded step probes it once:
        the JAX engine compares the padded forward with the unpadded one at
        fp32 tolerances; here the two lengths may take different attention
        paths (the flash kernel at a multiple of 128, the plain branch
        otherwise) that round differently in bf16, so the probe runs the
        padded forward a second time with other pad tokens (copies of the
        prompt's), which a causal ``apply_fn`` leaves bit-identical at any
        precision.  A non-causal one latches the exact, unpadded path (one
        shape per length), with a warning."""
        if not InferenceEngine._warned_uncached:
            InferenceEngine._warned_uncached = True
            logger.warning(
                "generate() is using the full-recompute fallback (O(S) forward "
                "per token).  Give the model a KV cache (apply_cached, see "
                "models.CausalLM) for the cached decode path.")
        ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor)
                         else input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        B = ids.shape[0]
        if not greedy and temperature > 0 and rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)

        def fwd(tokens):
            if params is not None:
                with torch.inference_mode(), self._region():
                    logits = self.apply_fn(params, self._tensor(tokens, torch.long))
            else:
                logits = self.forward(tokens)
            return logits[0] if isinstance(logits, tuple) else logits

        for _ in range(max_new_tokens):
            n = ids.shape[1]
            causal = getattr(self, "_uncached_causal", None)
            if causal is False:
                next_logits = fwd(ids)[:, n - 1]
            else:
                padded = np.zeros((B, self._bucket(n)), ids.dtype)
                padded[:, :n] = ids
                next_logits = fwd(padded)[:, n - 1]
                if causal is None and padded.shape[1] > n:
                    other = padded.copy()
                    other[:, n:] = np.resize(ids, (B, padded.shape[1] - n))
                    # pads equal to zeros would compare a forward with itself
                    if (other[:, n:] != 0).any():
                        self._uncached_causal = bool(torch.equal(
                            fwd(other)[:, n - 1], next_logits))
                        if not self._uncached_causal:
                            logger.warning(
                                "uncached generate: apply_fn is not causal (pad "
                                "tokens leak into earlier logits); using the exact "
                                "per-step path, one forward shape per length")
                            next_logits = fwd(ids)[:, n - 1]
            if greedy or temperature <= 0:
                # temperature <= 0 folds to greedy (dividing by it would be
                # a silent NaN factory), as the sampling subsystem does
                nxt = torch.argmax(next_logits, dim=-1)
            else:
                probs = torch.softmax(next_logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=rng)[:, 0]
            nxt = nxt.cpu().numpy()
            ids = np.concatenate([ids, nxt[:, None].astype(ids.dtype)], axis=1)
            if eos_token_id is not None and bool((nxt == eos_token_id).all()):
                break
        return self._tensor(ids)
