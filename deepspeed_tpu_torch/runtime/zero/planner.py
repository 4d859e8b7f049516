"""ZeRO as a sharding plan (counterpart of
``deepspeed_tpu/runtime/zero/planner.py``; reference
``runtime/zero/stage_1_and_2.py``, ``stage3.py``).

Per leaf, where each copy of a parameter lives:

  stage 0  params R | grads R (all-reduce)        | opt R
  stage 1  params R | grads R (all-reduce)        | opt sharded over DP
  stage 2  params R | grads sharded (reduce-scatter) | opt sharded
  stage 3  params sharded (gathered at use)       | grads sharded | opt sharded

``R`` = replicated over the data-parallel axes (still sharded over the
model axis by any tensor-parallel spec the model supplies).  The dim rule
is the JAX package's: the largest dimension whose per-TP-shard size
divides the ZeRO world, never a dim that already carries a ZeRO axis (nor
the experts' or the layers' dim of a leaf its spec cuts over 'expert' or
'pipe').  An expert leaf (its spec names 'expert') is cut over 'data'
only, where the JAX planner leaves it whole: its ranks on 'expert' hold
other experts, so ZeRO shares each expert among its data ranks;
leaves no dim divides stay replicated; compute params smaller than
``stage3_param_persistence_threshold`` stay replicated at stage 3 (the
masters and the optimizer state are sharded whatever their size).

A spec is a tuple of DTensor placements, one per mesh dim of
``MESH_AXES``: ``Shard(dim)`` on the ZeRO axes, ``Replicate()`` elsewhere
(plus the model axis's ``Shard`` where ``tp_specs`` asks for one).  Where
the JAX planner keeps a leaf replicated because the ZeRO world is 1 (a
size-1 axis costs nothing under GSPMD), the port keeps the ``Shard`` over
the size-1 axis: the data are the same, and a world of one runs the same
gather and reduce-scatter code as a larger one.  ``tp_specs`` are
PartitionSpec-like tuples (an entry per dim: None, an axis name or a
tuple of names): a ``CausalLM``'s ``param_specs`` under tensor
parallelism.  Where the ZeRO axes land on the model axis's dim, JAX's
spec reads ``('model', 'data')``: each ZeRO piece lies within the rank's
model-axis shard.  The placements keep one ``Shard`` per mesh dim, which
DTensor would order by mesh dim ('data' before 'model'); the engine cuts
the pieces model-major itself (``partition.py``) and its checkpoints put
'model' first (``checkpoint_engine/dcp_engine.py`` ``CKPT_AXES``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from ...parallel.mesh import MESH_AXES, ZERO_AXES, MeshLayout, layout_of


@dataclasses.dataclass(frozen=True)
class ZeroShardingPlan:
    """Per-tree placements produced by :func:`plan_sharding`."""

    param_specs: Any      # compute params (bf16/fp16): what the fwd/bwd sees
    master_specs: Any     # fp32 masters (sharded at stage >= 1)
    grad_specs: Any       # where gradients land (sharded at stage >= 2)
    opt_specs: Any        # optimizer state per param (== master_specs)
    stage: int


def _placements():
    from torch.distributed.tensor import Replicate, Shard

    return Replicate, Shard


def _sizes(mesh) -> dict:
    layout = mesh if isinstance(mesh, MeshLayout) else layout_of(mesh)
    return dict(zip(MESH_AXES, layout.axis_sizes()))


def _spec_axes_in_dim(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _entries(spec, ndim: int) -> list:
    spec = tuple(spec or ())
    return list(spec) + [None] * (ndim - len(spec))


def _shard_dim_for(shape: Tuple[int, ...], base_spec, sizes: dict, zero_size: int,
                   used_axes: frozenset) -> Optional[int]:
    """The dimension to shard over the ZeRO axes: the largest dim whose
    per-TP-shard size is divisible by the ZeRO world and which does not
    already carry a ZeRO axis."""
    best_dim, best_size = None, 0
    entries = _entries(base_spec, len(shape))
    for dim, extent in enumerate(shape):
        axes_here = _spec_axes_in_dim(entries[dim])
        if used_axes & set(axes_here):
            return None  # already ZeRO-sharded (explicit user spec) — keep it
        if {"expert", "pipe"} & set(axes_here):
            continue     # the experts' or the layers' dim: cut by its own axis
        tp_div = math.prod(sizes[a] for a in axes_here) if axes_here else 1
        if extent % tp_div != 0:
            continue
        per_shard = extent // tp_div
        if per_shard % zero_size == 0 and extent > best_size:
            best_dim, best_size = dim, extent
    return best_dim


def _compose_spec(shape, base_spec, sizes: dict, zero_axes: Tuple[str, ...]) -> tuple:
    """``base_spec`` with the ZeRO axes added on the chosen dim (a
    PartitionSpec-like tuple, trailing Nones dropped)."""
    zero_size = math.prod(sizes[a] for a in zero_axes)
    dim = _shard_dim_for(shape, base_spec, sizes, zero_size, frozenset(zero_axes))
    entries = _entries(base_spec, len(shape))
    if dim is not None:
        entries[dim] = _spec_axes_in_dim(entries[dim]) + tuple(zero_axes)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_to_placements(spec) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``
    names that mesh axis, ``Replicate()`` elsewhere."""
    Replicate, Shard = _placements()
    out = [Replicate()] * len(MESH_AXES)
    for dim, entry in enumerate(spec or ()):
        for axis in _spec_axes_in_dim(entry):
            out[MESH_AXES.index(axis)] = Shard(dim)
    return tuple(out)


def shard_dim(placements, axes: Sequence[str] = ZERO_AXES) -> Optional[int]:
    """The tensor dim ``placements`` shard over ``axes``, or None."""
    for axis in axes:
        p = placements[MESH_AXES.index(axis)]
        if p.is_shard():
            return p.dim
    return None


def _leaf_size(shape) -> int:
    return math.prod(shape) if shape else 1


def walk(fn, shapes: Any, *others: Any) -> Any:
    """``fn(leaf, *matching)`` over the leaves of the parameter tree
    ``shapes`` (dicts and lists of tensors or ``torch.Size``), the other
    trees indexed alongside: a plan's leaves are tuples, which the
    generic tree helpers would walk into."""
    if isinstance(shapes, dict):
        return {k: walk(fn, shapes[k], *(o[k] for o in others)) for k in sorted(shapes)}
    if isinstance(shapes, (list, tuple)) and not isinstance(shapes, torch.Size):
        return type(shapes)(walk(fn, s, *(o[i] for o in others))
                            for i, s in enumerate(shapes))
    return fn(shapes, *others)


def plan_sharding(param_shapes: Any, stage: int, mesh, tp_specs: Optional[Any] = None,
                  persistence_threshold: int = 0,
                  zero_axes: Tuple[str, ...] = ZERO_AXES,
                  param_zero_axes: Optional[Tuple[str, ...]] = None) -> ZeroShardingPlan:
    """The ZeRO plan for a tree of parameter shapes (anything with
    ``.shape``: tensors, meta tensors, ``torch.Size``).  ``mesh`` is a
    ``DeviceMesh`` from ``parallel.mesh.build_mesh`` or a ``MeshLayout``
    (planning needs no process group).  ``tp_specs``: an optional tree of
    PartitionSpec-like tuples the ZeRO axes are composed onto.

    ``param_zero_axes``: the compute params' axes where they differ from
    the masters' (ZeRO++ hpZ, reference partition_parameters.py:1019
    ``zero_hpz_partition_size``): the masters, optimizer state and
    gradients shard over ``zero_axes`` (the whole group), the compute view
    over the inner group only, on the masters' dim."""
    sizes = _sizes(mesh)
    shape_of = (lambda s: tuple(s) if isinstance(s, tuple) else tuple(s.shape))
    if tp_specs is None:
        tp_specs = walk(lambda _: (), param_shapes)
    base = walk(lambda _, b: tuple(b or ()), param_shapes, tp_specs)

    def spec_for(shaped, base, threshold):
        shape = shape_of(shaped)
        if threshold and _leaf_size(shape) < threshold:
            return tuple(base or ())
        axes = zero_axes
        if any("expert" in _spec_axes_in_dim(e) for e in base or ()):
            axes = tuple(a for a in zero_axes if a != "expert")
        return _compose_spec(shape, base, sizes, axes)

    # stage >= 1: master/opt sharded; no size threshold (the optimizer
    # state is the memory the stage exists to shard)
    master = (walk(lambda s, b: spec_for(s, b, 0), param_shapes, base)
              if stage >= 1 else base)
    # stage >= 3: compute params sharded, small ones persist replicated
    params = (walk(lambda s, b: spec_for(s, b, persistence_threshold),
                   param_shapes, base)
              if stage >= 3 else base)
    if stage >= 3 and param_zero_axes is not None and \
            tuple(param_zero_axes) != tuple(zero_axes):
        drop = set(zero_axes) - set(param_zero_axes)

        def inner(shaped, mspec, pspec):
            if pspec == mspec:   # sharded: the same dim, inner axes only
                out = [tuple(a for a in _spec_axes_in_dim(e) if a not in drop) or None
                       for e in mspec]
                out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in out]
                while out and out[-1] is None:
                    out.pop()
                return tuple(out)
            return pspec   # persistent (replicated): stays as it is

        params = walk(inner, param_shapes, master, params)
    # stage >= 2: grads land sharded; stage 3 grads follow the params
    grads = params if stage >= 3 else master if stage == 2 else base

    def to_pl(tree):
        return walk(lambda _, spec: spec_to_placements(spec), param_shapes, tree)

    master_pl = to_pl(master)
    return ZeroShardingPlan(param_specs=to_pl(params), master_specs=master_pl,
                            grad_specs=to_pl(grads), opt_specs=master_pl,
                            stage=stage)
