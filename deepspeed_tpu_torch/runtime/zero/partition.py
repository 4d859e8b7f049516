"""Execution of a ZeRO plan over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/runtime/zero/planner.py``'s plan as GSPMD
runs it: the JAX package declares each leaf's sharding and XLA emits the
collectives; here :class:`ZeroPartition` issues them, per leaf, through
the ``comm`` facade:

- stage 3: a sharded compute param is gathered where the forward reads it
  (:class:`ShardedParams`, :func:`gather_param`), and its gradient is
  reduce-scattered over the ZeRO axes by the gather's backward, at the
  accumulation dtype;
- stage 2: each micro-batch's gradient is reduce-scattered into the
  sharded accumulator (:meth:`ZeroPartition.reduce_micro`);
- stages 0/1, and leaves no stage shards: the window's summed gradient is
  all-reduced over the data-parallel axes (:meth:`reduce_window`), then a
  sharded master takes its slice; under MiCS the ZeRO-reduced shards are
  all-reduced across the 'data_outer' replicas;
- after the update on the master shards, the compute params are cast and
  re-gathered where the plan keeps them replicated (stages 1/2,
  :meth:`compute_params`); at stage 3 they stay sharded at rest.

Under tensor parallelism (a 'model' axis in the plan's placements) the
tree this class sees is the rank's model-axis shards, its "full" leaves
(``template``): ZeRO cuts each within it (the model-major order JAX
writes as ``('model', 'data')``), so a gather over the ZeRO axes rebuilds
the rank's contiguous tensor-parallel shard; ``global_shapes`` are the
whole leaves a checkpoint describes.  A leaf whose model-axis shards
are padded (uneven) has ``true_shapes`` smaller than its global shape: a
checkpoint holds it whole at its true shape (:meth:`whole_true`,
:meth:`piece_of_true`).

Expert and pipeline parallelism are per leaf: an expert leaf (its spec
names 'expert') is cut by ZeRO over 'data' only and its gradient summed
over the data axes without 'expert' (each rank of that axis holds other
experts); a leaf every pipe rank holds whole (embedding, head, norms)
sums its gradient over 'pipe' too, a layer leaf cut over 'pipe' does not.

Sequence parallelism adds 'seq' to the axes the gradients are summed over
(``GRAD_AXES``): its ranks read other tokens of the same rows, and hold
the same ZeRO pieces, so 'seq' joins MiCS's 'data_outer' in
``REPLICA_AXES``.

The global norm adds the squares of a leaf's shards over the axes that
shard it (the ZeRO axes, 'model') and counts a replicated leaf once
(:meth:`global_norm`); the overflow check is all-reduced over the whole
world so every rank skips together (:meth:`all_finite`).
Collectives are per leaf: bucketing and overlap are later work (ROADMAP
queue 1, item 4).

ZeRO++ (``runtime/zero/zeropp.py``, JAX's ``make_zeropp_cast``): under
qwZ/qgZ the step differentiates the fp32 master shard of every sharded,
non-persistent leaf, and every read of it is
:func:`ops.quantizer.quantized_all_gather` (int8 codes of the master and
fp32 scales on the wire, landing the compute dtype; its backward the
reduce-scatter, quantized under qgZ), so a remat recompute re-runs the
quantized gather.  hpZ keeps the masters,
the optimizer state and the gradients sharded over the whole group
(``zero_axes + ('data_outer',)``, 'data_outer' minor: rank (o, j) holds
piece ``j * n_outer + o``) and the compute view over the inner group
only (``param_axes``): after an update, each compute shard is
all-gathered over 'data_outer' (the outer hop, quantized under qwZ), the
per-layer gathers at use stay within the inner group, and the inner
shard's gradient is reduce-scattered over 'data_outer' (quantized under
qgZ).  The hierarchical DP size shards everything over the whole group
(outer-major) and reduces gradients in two quantized hops under qgZ.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ... import comm
from ...parallel.mesh import BATCH_AXES, MESH_AXES, ZERO_AXES
from ...utils.tree import tree_flatten_with_path, tree_leaves, tree_unflatten_like
from .planner import ZeroShardingPlan, shard_dim, walk

# the axes a gradient is summed over: the data-parallel ones and 'seq' (its
# ranks hold other tokens of the same rows)
GRAD_AXES = BATCH_AXES + ("seq",)
# the axes of GRAD_AXES a ZeRO shard is replicated over (MiCS's replicas, 'seq')
REPLICA_AXES = tuple(a for a in GRAD_AXES if a not in ZERO_AXES)
# the ZeRO axes of an expert leaf: its ranks on 'expert' hold other experts
EXPERT_ZERO_AXES = ("data",)


class _GatherParam(torch.autograd.Function):
    """All-gather a shard along ``dim`` over ``axes`` in the forward;
    reduce-scatter the gradient back to the shard in the backward, at
    ``grad_dtype``."""

    @staticmethod
    def forward(ctx, shard, dim, axes, grad_dtype):
        ctx.dim, ctx.axes, ctx.grad_dtype = dim, axes, grad_dtype
        ctx.dtype = shard.dtype
        full = comm.all_gather(shard, axes, gather_dim=dim)
        return full.view_as(full) if full is shard else full

    @staticmethod
    def backward(ctx, g):
        out = comm.reduce_scatter(g.to(ctx.grad_dtype), ctx.axes, scatter_dim=ctx.dim)
        return out.to(ctx.dtype), None, None, None


def gather_param(shard: torch.Tensor, dim: int, axes=ZERO_AXES,
                 grad_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The full parameter of a ZeRO shard (autograd-aware)."""
    return _GatherParam.apply(shard, dim, axes, grad_dtype)


def _gather(value, dim, axes, grad_dtype, quant, hpz_master):
    """A ZeRO shard gathered: an hpZ master piece in two hops (outer, then
    inner), a quantized gather under ZeRO++, else :func:`gather_param`."""
    if hpz_master:
        inner = comm.all_gather(value.contiguous(), "data_outer", gather_dim=dim)
        return comm.all_gather(inner, axes, gather_dim=dim)
    if quant is not None:
        from ...ops.quantizer import quantized_all_gather

        return quantized_all_gather(value, axes, gather_dim=dim, block=quant["block"],
                                    bits=quant["weight_bits"], out_dtype=quant["dtype"],
                                    grad_bits=quant["grad_bits"],
                                    grad_hierarchy=quant["hierarchy"])
    return gather_param(value, dim, axes, grad_dtype)


class ShardedParams(dict):
    """A parameter tree whose ZeRO-sharded leaves are gathered when read.

    ``params["wq"]`` returns the full tensor (one all-gather, whose
    backward reduce-scatters the gradient), so model code written against
    a plain tree runs unchanged at stage 3; every read gathers again, so a
    checkpointed block re-gathers in its recompute and one layer's weights
    are live at a time.  ``dims`` mirrors the tree: the shard dim of each
    leaf, None for a full one.  ``raw``/``local`` give the shards."""

    def __init__(self, local: Dict[str, Any], dims: Dict[str, Any],
                 grad_dtype: torch.dtype = torch.float32, axes=ZERO_AXES,
                 quant: Optional[dict] = None, hpz_master: bool = False):
        super().__init__(local)
        self.dims = dims
        self.grad_dtype = grad_dtype
        # the ZeRO axes: one tuple for every leaf, or a tree like ``dims``
        # (an expert leaf's are ('data',))
        self.axes = axes
        # ZeRO++: the quantized gather's settings; an hpZ master view
        self.quant, self.hpz_master = quant, hpz_master

    def _like(self, local, dims, axes) -> "ShardedParams":
        return ShardedParams(local, dims, self.grad_dtype, axes, self.quant, self.hpz_master)

    def _axes_of(self, key):
        return self.axes[key] if isinstance(self.axes, dict) else self.axes

    def _wrap(self, value, dim, axes):
        if isinstance(value, dict):
            return self._like(value, dim, axes)
        if isinstance(value, (list, tuple)):
            per = axes if isinstance(axes, (list, tuple)) and not isinstance(
                axes[0] if axes else None, str) else [axes] * len(value)
            return type(value)(self._wrap(v, d, a) for v, d, a in zip(value, dim, per))
        if dim is None:
            return value
        return _gather(value, dim, axes, self.grad_dtype, self.quant, self.hpz_master)

    def __getitem__(self, key):
        return self._wrap(dict.__getitem__(self, key), self.dims[key], self._axes_of(key))

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]

    def raw(self, key):
        """``(value, dim)`` without gathering."""
        return dict.__getitem__(self, key), self.dims[key]

    def local(self) -> Dict[str, Any]:
        """The plain tree of shards (and full leaves)."""
        out = {}
        for k in self:
            value, dim = self.raw(k)
            out[k] = (self._like(value, dim, self._axes_of(k)).local()
                      if isinstance(value, dict) else value)
        return out

    def pin(self, *keys) -> "ShardedParams":
        """A copy whose ``keys`` are gathered once now, so several reads
        share one gather (a tied embedding: both uses' gradients sum before
        the one reduce-scatter)."""
        local, dims = dict(self), dict(self.dims)
        for k in keys:
            if k in self:
                local[k], dims[k] = self[k], None
        return self._like(local, dims, self.axes)

    def unstack(self) -> List["ShardedParams"]:
        """Per-layer trees of a tree of stacked ``[L, ...]`` leaves: each
        layer's shard slice, gathered when the layer reads it; a leaf
        sharded on the ``L`` dim itself is gathered whole once."""
        names = list(self)
        views, dims = [], []
        for name in names:
            value, dim = self.raw(name)
            if dim == 0:
                value, dim = self[name], None
            views.append(value.unbind(0))
            dims.append(None if dim is None else dim - 1)
        axes = ({n: self._axes_of(n) for n in names} if isinstance(self.axes, dict)
                else self.axes)
        return [self._like(dict(zip(names, layer)), dict(zip(names, dims)), axes)
                for layer in zip(*views)]


class ZeroPartition:
    """The plan's collectives for one engine.  Leaves are addressed by
    their position in ``tree_leaves`` order of the parameter tree."""

    def __init__(self, plan: ZeroShardingPlan, template: Any,
                 use_master_weights: bool, accum_dtype: torch.dtype,
                 frozen: Optional[List[bool]] = None,
                 global_shapes: Optional[List[tuple]] = None,
                 true_shapes: Optional[List[tuple]] = None,
                 zero_axes: tuple = ZERO_AXES, hpz: bool = False,
                 zeropp: Optional[dict] = None):
        self.plan = plan
        self.stage = plan.stage
        self.template = template
        self.paths = [p for p, _ in tree_flatten_with_path(template)]
        self.shapes = [tuple(x.shape) for x in tree_leaves(template)]
        self.global_shapes = ([tuple(s) for s in global_shapes]
                              if global_shapes is not None else self.shapes)
        self.true_shapes = ([tuple(s) for s in true_shapes]
                            if true_shapes is not None else self.global_shapes)
        # the model-axis dim of each leaf (None: replicated over 'model')
        self.tdims = [shard_dim(p, ("model",))
                      for p in _leaf_list(template, plan.master_specs)]
        self.tp_n = comm.get_axis_size("model")
        # per leaf: an expert leaf (sharded over 'expert' by its spec) is cut
        # by ZeRO over 'data' only and its gradient summed over the data
        # axes only (its ranks on 'expert' hold other experts); a leaf a
        # pipe rank holds whole (embedding, head, norms) sums its gradient
        # over 'pipe' as well (the stages that read it; ReduceTiedGrads)
        placements = _leaf_list(template, plan.master_specs)
        self.edims = [_expert_dim(p) for p in placements]
        self.pipe_dims = [shard_dim(p, ("pipe",)) for p in placements]
        # the axes each leaf's masters are cut over, and its compute view
        # (hpZ: the inner group); hpZ's 'data_outer' is handled apart
        self.hpz = hpz
        self.zaxes = [EXPERT_ZERO_AXES if e is not None else tuple(zero_axes)
                      for e in self.edims]
        self.gaxes = [tuple(a for a in GRAD_AXES if not (e is not None and a == "expert"))
                      + (() if pd is not None else ("pipe",))
                      for e, pd in zip(self.edims, self.pipe_dims)]
        self.zn = [comm.get_axis_size(z) for z in self.zaxes]
        self.zi = [comm.axis_index(z) for z in self.zaxes]
        self.pdims = [shard_dim(p, z) for p, z in
                      zip(_leaf_list(template, plan.param_specs), self.zaxes)]
        self.mdims = [shard_dim(p, z) for p, z in zip(placements, self.zaxes)]
        # hpZ: a master piece is 1/(n_inner * n_outer), 'data_outer' minor
        self.on = comm.get_axis_size("data_outer") if hpz else 1
        self.oi = comm.axis_index("data_outer") if hpz else 0
        self.hdims = [shard_dim(p, ("data_outer",)) if hpz else None for p in placements]
        self.zeropp = zeropp
        self.num_quantized_leaves = (sum(p is not None for p in self.pdims)
                                     if zeropp is not None else 0)
        self.use_master_weights = use_master_weights
        # where the compute params rest: their own placement, or the
        # masters' when they are the masters (fp32/fp64 compute)
        self.rdims = self.pdims if use_master_weights else self.mdims
        for p, m in zip(self.pdims, self.mdims):
            if p is not None and p != m:
                raise AssertionError(f"param shard dim {p} != master dim {m}")
        self.accum_dtype = accum_dtype
        self.frozen = frozen or [False] * len(self.paths)
        self._dims = {"param": self.pdims, "master": self.mdims, "rest": self.rdims}

    # -- placement helpers ------------------------------------------------
    def placements(self, which: str) -> list:
        """Each leaf's placements: of the compute params (``"param"``) or
        of the masters (``"master"``)."""
        specs = self.plan.param_specs if which == "param" else self.plan.master_specs
        return _leaf_list(self.template, specs)

    def dims_tree(self, which: str) -> Any:
        return tree_unflatten_like(self.template, list(self._dims[which]))

    def _outer(self, i: int) -> bool:
        """Whether leaf ``i``'s masters are cut over 'data_outer' too (hpZ)."""
        return self.hdims[i] is not None

    def local_shape(self, i: int, dim: Optional[int]) -> tuple:
        """Leaf ``i``'s master piece shape (``dim``: its master dim)."""
        shape = list(self.shapes[i])
        if dim is not None:
            shape[dim] //= self.zn[i] * (self.on if self._outer(i) else 1)
        return tuple(shape)

    def local_slice(self, full: torch.Tensor, dim: Optional[int], i: int,
                    which: str = "master") -> torch.Tensor:
        """This rank's piece of ``full`` at leaf ``i``'s ``which`` placement
        (an hpZ master: piece ``inner * n_outer + outer``)."""
        if dim is None:
            return full
        piece = full.chunk(self.zn[i], dim)[self.zi[i]]
        if which == "master" and self._outer(i):
            piece = piece.chunk(self.on, dim)[self.oi]
        return piece.contiguous()

    def shard_tree(self, full_tree: Any, which: str) -> Any:
        """This rank's shards of a full tree, at the ``which`` placement."""
        kind = "param" if which == "param" or (which == "rest" and self.use_master_weights) \
            else "master"
        return tree_unflatten_like(self.template, [
            self.local_slice(x, d, i, kind)
            for i, (x, d) in enumerate(zip(tree_leaves(full_tree), self._dims[which]))])

    def view(self, local_tree: Any, which: str = "rest") -> ShardedParams:
        """``local_tree`` as a :class:`ShardedParams` at ``which``: its
        reads gather (quantized under ZeRO++ for the compute params)."""
        axes = (tree_unflatten_like(self.template, list(self.zaxes))
                if any(e is not None for e in self.edims) else self.zaxes[0]
                if self.zaxes else ZERO_AXES)
        compute = which == "param" or (which == "rest" and self.use_master_weights)
        return ShardedParams(local_tree, self.dims_tree(which), self.accum_dtype, axes,
                             quant=self.zeropp if compute and not self.hpz else None,
                             hpz_master=self.hpz and not compute)

    # -- the step -----------------------------------------------------------
    def work_leaves(self, rest_leaves: List[torch.Tensor],
                    masters: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        """The leaves the forward differentiates: stage-3 shards stay
        shards (gathered at use); leaves resting sharded that the plan wants
        full in the forward (the fp32 masters at stages 1/2) are gathered
        now; an hpZ master piece resting as the compute param (fp32
        compute) first takes its outer hop to the inner shard.  Under
        qwZ/qgZ (outside hpZ) a sharded leaf's is its fp32 master shard
        (given in ``masters``), as JAX's ``make_zeropp_cast``
        differentiates the masters: its gather quantizes the master and
        lands the compute dtype."""
        out = []
        for i, (x, p, r) in enumerate(zip(rest_leaves, self.pdims, self.rdims)):
            if r is not None and self._outer(i) and not self.use_master_weights:
                x = comm.all_gather(x.contiguous(), "data_outer", gather_dim=r)
            if r is not None and p is None:
                x = comm.all_gather(x, self.zaxes[i], gather_dim=r)
            out.append(x)
        if masters is not None and self.zeropp is not None and not self.hpz:
            out = [m if p is not None else x for x, m, p in zip(out, masters, self.pdims)]
        return out

    def reduce_micro(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Stage 2: reduce-scatter each micro-batch's full gradient of a
        sharded leaf into its shard, at the accumulation dtype."""
        if self.stage != 2:
            return grads
        grads = list(grads)
        for i, (m, f) in enumerate(zip(self.mdims, self.frozen)):
            if m is not None and not f:   # in place: one full gradient live at a time
                grads[i] = comm.reduce_scatter(grads[i].to(self.accum_dtype),
                                               self.zaxes[i], scatter_dim=m)
        return grads

    def _zero_reduced(self, i: int) -> bool:
        return ((self.stage == 2 and self.mdims[i] is not None)
                or (self.stage == 3 and self.pdims[i] is not None))

    def _outer_reduce(self, g: torch.Tensor, i: int) -> torch.Tensor:
        """hpZ: the inner shard's gradient -> this rank's master piece, a
        reduce-scatter over 'data_outer' (quantized under qgZ)."""
        q = self.zeropp
        if q is not None and q["grad_bits"] is not None:
            from ...ops.quantizer import quantized_reduce_scatter

            return quantized_reduce_scatter(g.float(), "data_outer",
                                            scatter_dim=self.mdims[i], block=q["block"],
                                            bits=q["grad_bits"]).to(g.dtype)
        return comm.reduce_scatter(g, "data_outer", scatter_dim=self.mdims[i])

    def reduce_window(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The window's summed local gradients -> the global sums at the
        masters' placement."""
        out = list(grads)
        for i, g in enumerate(grads):
            m = self.mdims[i]
            if self.frozen[i]:
                out[i] = g.new_zeros(self.local_shape(i, m))
            elif self._zero_reduced(i):
                zax = self.zaxes[i] + (("data_outer",) if self._outer(i) else ())
                if self._outer(i):
                    g = out[i] = self._outer_reduce(g, i)
                replicas = tuple(a for a in self.gaxes[i] if a not in zax)
                if comm.get_axis_size(replicas) > 1:
                    out[i] = comm.all_reduce(g, comm.SUM, replicas)
            else:
                out[i] = self.local_slice(comm.all_reduce(g, comm.SUM, self.gaxes[i]), m, i)
        return out

    def _norm_axes(self, i: int) -> tuple:
        """The axes whose ranks hold disjoint pieces of leaf ``i``'s masters
        (the ZeRO axes, 'model', 'expert' and 'pipe' where its spec cuts
        it); a leaf is replicated over the others."""
        axes = self.zaxes[i] if self.mdims[i] is not None else ()
        if self._outer(i):
            axes = axes + ("data_outer",)
        if self.tp_n > 1 and self.tdims[i] is not None:
            axes = axes + ("model",)
        if self.edims[i] is not None:
            axes = axes + ("expert",)
        if self.pipe_dims[i] is not None:
            axes = axes + ("pipe",)
        return axes

    def global_norm(self, tree: Any) -> torch.Tensor:
        """sqrt of the sum of squares over the whole (global) tree: a
        sharded leaf's squares summed over the axes that shard it, a
        replicated one counted once (its gradients are equal on every rank
        of the model axis); the leaves added in tree order."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self.mdims):
            raise ValueError(f"global_norm over {len(leaves)} leaves, the plan "
                             f"has {len(self.mdims)}")
        return self.norm_of_squares(
            [x.to(torch.promote_types(x.dtype, torch.float32)).square().sum()
             for x in leaves])

    def norm_of_squares(self, sq: List[torch.Tensor]) -> torch.Tensor:
        """:meth:`global_norm` from each leaf's local sum of squares."""
        sq = list(sq)
        groups: Dict[tuple, List[int]] = {}
        for i in range(len(sq)):
            axes = self._norm_axes(i)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            vec = torch.stack([sq[i].double() for i in idx])
            vec = comm.all_reduce(vec, comm.SUM, axes)
            for j, i in enumerate(idx):
                sq[i] = vec[j].to(sq[i].dtype)
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        return torch.sqrt(total)

    def all_finite(self, grads: List[torch.Tensor]) -> bool:
        """Every rank's gradients finite (one all-reduce over the world)."""
        return self.none_bad([(~torch.isfinite(g)).any() for g in grads])

    def none_bad(self, bad: List[torch.Tensor]) -> bool:
        """No rank flagged a leaf (``bad``: a bool tensor a leaf)."""
        bad = torch.stack(bad).any()
        bad = comm.all_reduce(bad.to(torch.int32), comm.MAX, MESH_AXES)
        return not bool(bad)

    def compute_param(self, i: int, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Leaf ``i``'s compute param at rest from its updated master shard:
        cast, then all-gathered where the plan keeps it replicated."""
        q = self.zeropp
        if (self._outer(i) and self.pdims[i] is not None and q is not None
                and q["weight_bits"] is not None):
            # hpZ's outer hop under qwZ: the fp32 master piece quantized, the
            # inner shard at rest landed in the compute dtype
            from ...ops.quantizer import quantized_all_gather

            with torch.no_grad():
                return quantized_all_gather(x, "data_outer", gather_dim=self.mdims[i],
                                            block=q["block"], bits=q["weight_bits"],
                                            out_dtype=dtype)
        x = x.to(dtype) if x.is_floating_point() else x
        if self._outer(i):   # hpZ: the outer hop ...
            x = comm.all_gather(x, "data_outer", gather_dim=self.mdims[i])
            if self.pdims[i] is not None:   # ... to the inner shard at rest
                return x
        if self.mdims[i] is not None and self.pdims[i] is None:
            x = comm.all_gather(x, self.zaxes[i], gather_dim=self.mdims[i])
        return x

    def compute_params(self, masters: List[torch.Tensor],
                       dtype: torch.dtype) -> List[torch.Tensor]:
        """The compute params at rest from the updated master shards."""
        return [self.compute_param(i, x, dtype) for i, x in enumerate(masters)]

    # -- checkpoints ---------------------------------------------------------
    def leaf_for(self, key: str):
        """``(leaf index, placements)`` of a flat checkpoint key
        (``params/...``, ``master_params/...``, ``opt_state/.../<param
        path>``), or None for a value that is not a parameter's."""
        best = None
        for i, path in enumerate(self.paths):
            if key.endswith("/" + path) and (best is None
                                             or len(path) > len(self.paths[best])):
                best = i
        if best is None:
            return None
        which = (self.plan.param_specs
                 if key.startswith("params/") and self.use_master_weights
                 else self.plan.master_specs)
        return best, _leaf(which, self.paths[best])

    def uneven(self, i: int) -> bool:
        """Whether leaf ``i`` goes into checkpoints whole: its model-axis
        shards carry padding, or (hpZ) its master pieces lie in an order
        DTensor does not describe."""
        return self.true_shapes[i] != self.global_shapes[i] or self._outer(i)

    def whole_true(self, i: int, placements, x: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole at its true shape from this rank's piece ``x``
        at ``placements`` (collective over the ZeRO and model axes)."""
        z = shard_dim(placements, self.zaxes[i])
        if z is not None and self._outer(i) and shard_dim(placements, ("data_outer",)) == z:
            x = comm.all_gather(x.contiguous(), "data_outer", gather_dim=z)
        if z is not None:
            x = comm.all_gather(x.contiguous(), self.zaxes[i], gather_dim=z)
        t = self.tdims[i]
        if t is None:
            return x
        x = comm.all_gather(x.contiguous(), "model", gather_dim=t)
        return x.narrow(t, 0, self.true_shapes[i][t]).contiguous()

    def piece_of_true(self, i: int, placements, whole: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`whole_true`: this rank's (padded) piece."""
        t = self.tdims[i]
        x = whole
        if t is not None:
            extent = self.global_shapes[i][t]
            pad = list(whole.shape)
            pad[t] = extent - whole.shape[t]
            x = torch.cat([whole, whole.new_zeros(pad)], t)
            x = x.chunk(self.tp_n, t)[comm.axis_index("model")]
        z = shard_dim(placements, self.zaxes[i])
        if z is None:
            return x.contiguous()
        x = x.chunk(self.zn[i], z)[self.zi[i]]
        if self._outer(i) and shard_dim(placements, ("data_outer",)) == z:
            x = x.chunk(self.on, z)[self.oi]
        return x.contiguous()


def _expert_dim(placements) -> Optional[int]:
    """The experts' dim of an expert leaf: sharded over 'expert' on a dim
    'data' does not share (a ZeRO-sharded leaf has both on one dim)."""
    e = shard_dim(placements, ("expert",))
    return e if e is not None and shard_dim(placements, ("data",)) != e else None


def _leaf_list(template: Any, tree: Any) -> list:
    """The leaves of a plan tree (tuples of placements) in ``tree_leaves``
    order of ``template``."""
    out: list = []
    walk(lambda _, s: out.append(s), template, tree)
    return out


def _leaf(tree: Any, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree
