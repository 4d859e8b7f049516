"""Process-group topology (counterpart of ``deepspeed_tpu/parallel/mesh.py``;
reference ``deepspeed/utils/groups.py`` and ``runtime/pipe/topology.py``).

The JAX package builds one ``jax.sharding.Mesh`` whose named axes stand for
every process group.  The port builds the same named mesh over the
``torch.distributed`` world: one process per device, ranks laid out
row-major over the axes

    ('pipe', 'data_outer', 'data', 'expert', 'seq', 'model')

- the data-parallel world (batch rows) is ``BATCH_AXES`` = data_outer x
  data x expert; ZeRO shards over the inner ``ZERO_AXES`` = (data,
  expert) only, so under MiCS (``mics_shard_size``) the shards live in
  inner groups and replicate across 'data_outer';
- ``build_mesh`` returns a ``torch.distributed.device_mesh.DeviceMesh``
  whose dim names are ``MESH_AXES`` (DTensor placements and DCP use it);
- the collectives of ``comm`` address groups by axis name or tuple of axis
  names (:func:`axis_group`): the group of a tuple holds the ranks whose
  coordinates differ only on those axes, ranked row-major over them.

A mesh needs an initialised process group (``comm.init_distributed``).
'model' is the innermost axis, so the ranks of one tensor-parallel group
are adjacent ranks (on a multi-card node, NVLink peers);
``parallel/tensor_parallel.py`` runs the model over it, and
``ops/ring_attention.py`` the sequence over 'seq', ``moe/sharded_moe.py``
exchanges the experts' capacity buffers over 'expert' (``comm.all_to_all``)
and ``runtime/pipe/executor.py`` hands activations and gradients between
the stages of 'pipe' (point to point, the pairs ``send_recv_next``/
``send_recv_prev`` name).  A serving mesh may cover the first ``n`` ranks of a
larger world (``initialize_serving_mesh(n_devices=)``): every rank makes
the groups, the others get an :class:`OutsideMesh` handle.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

MESH_AXES = ("pipe", "data_outer", "data", "expert", "seq", "model")

# Axes over which a ZeRO-sharded non-expert parameter is partitioned.
ZERO_AXES = ("data", "expert")
# Pure data-parallel axes (batch sharding excluding the expert dimension).
DATA_AXES = ("data_outer", "data")
# Batch (data-parallel) sharding axes.
BATCH_AXES = DATA_AXES + ("expert",)

AxisName = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Degrees of each parallelism dimension (reference
    ``PipeModelDataParallelTopology`` plus the expert/sequence axes).
    ``dp_outer`` is MiCS's replica-group count: ZeRO shards live on the
    inner axes and replicate across 'data_outer'."""

    dp: int = 1  # data-parallel degree EXCLUDING expert axis
    tp: int = 1  # tensor/model parallel
    pp: int = 1  # pipeline stages
    ep: int = 1  # expert parallel
    sp: int = 1  # sequence/context parallel
    dp_outer: int = 1

    @property
    def world_size(self) -> int:
        return self.dp * self.dp_outer * self.tp * self.pp * self.ep * self.sp

    @property
    def dp_world_size(self) -> int:
        """Total data-parallel degree as the reference counts it (dp x ep)."""
        return self.dp * self.dp_outer * self.ep

    def axis_sizes(self) -> Tuple[int, int, int, int, int, int]:
        return (self.pp, self.dp_outer, self.dp, self.ep, self.sp, self.tp)

    @staticmethod
    def from_world(world_size: int, tp: int = 1, pp: int = 1, ep: int = 1, sp: int = 1,
                   dp: Optional[int] = None, dp_outer: int = 1) -> "MeshLayout":
        denom = tp * pp * ep * sp * dp_outer
        if dp is None:
            if world_size % denom != 0:
                raise ValueError(
                    f"world size {world_size} not divisible by "
                    f"tp*pp*ep*sp*dp_outer={denom}")
            dp = world_size // denom
        layout = MeshLayout(dp=dp, tp=tp, pp=pp, ep=ep, sp=sp, dp_outer=dp_outer)
        if layout.world_size != world_size:
            raise ValueError(
                f"mesh layout {layout} covers {layout.world_size} devices, have {world_size}")
        return layout


def _dist():
    import torch.distributed as dist

    return dist


def _world() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def build_mesh(layout: MeshLayout, device_type: Optional[str] = None,
               first_ranks: bool = False):
    """The ``DeviceMesh`` of ``layout`` over the process group's world (one
    rank per device, row-major over ``MESH_AXES``); ``first_ranks``: over
    the first ``layout.world_size`` ranks of a larger world (every rank
    calls it; the mesh makes no groups, :func:`axis_group` does)."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_mesh needs a process group: call "
                           "deepspeed_tpu_torch.comm.init_distributed() first")
    world = dist.get_world_size()
    if layout.world_size != world and not (first_ranks and layout.world_size < world):
        raise ValueError(f"layout needs {layout.world_size} ranks, the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from ..accelerator import get_accelerator

    device_type = device_type or get_accelerator().device_name()
    if layout.world_size == world:
        return init_device_mesh(device_type, layout.axis_sizes(),
                                mesh_dim_names=MESH_AXES)
    import torch

    ranks = torch.arange(layout.world_size).reshape(layout.axis_sizes())
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES,
                      _init_backend=False)


@dataclasses.dataclass(frozen=True)
class OutsideMesh:
    """What ``initialize_serving_mesh(n_devices=)`` returns on a rank past
    the first ``n_devices``: the mesh does not hold it."""

    rank: int
    n_devices: int
    world_size: int

    def refuse(self):
        raise ValueError(
            f"rank {self.rank} is outside the serving mesh, which holds the first "
            f"{self.n_devices} of the {self.world_size} ranks: serve on ranks "
            f"0..{self.n_devices - 1}")


def layout_of(mesh) -> MeshLayout:
    """The ``MeshLayout`` of a mesh built by :func:`build_mesh`."""
    s = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return MeshLayout(dp=s["data"], tp=s["model"], pp=s["pipe"], ep=s["expert"],
                      sp=s["seq"], dp_outer=s["data_outer"])


# ---------------------------------------------------------------------------
# Global mesh registry (the analogue of groups.py's cached process groups).
# ---------------------------------------------------------------------------
_GLOBAL_MESH = None
_GLOBAL_LAYOUT: Optional[MeshLayout] = None
# axes tuple -> (group or None, size): the groups of this rank
_GROUPS: Dict[Tuple[str, ...], tuple] = {}


def initialize_mesh(layout: Optional[MeshLayout] = None, **kwargs):
    global _GLOBAL_MESH, _GLOBAL_LAYOUT
    if layout is None:
        layout = MeshLayout.from_world(_world(), **kwargs)
    mesh = build_mesh(layout)
    reset_mesh()
    _GLOBAL_LAYOUT, _GLOBAL_MESH = layout, mesh
    return mesh


def set_mesh(mesh) -> None:
    """Install a mesh built by :func:`build_mesh` as the global one."""
    global _GLOBAL_MESH, _GLOBAL_LAYOUT
    if tuple(mesh.mesh_dim_names or ()) != MESH_AXES:
        raise ValueError(f"mesh dims {mesh.mesh_dim_names} are not {MESH_AXES}; "
                         "build it with parallel.mesh.build_mesh")
    if mesh is _GLOBAL_MESH:
        return
    reset_mesh()
    _GLOBAL_MESH, _GLOBAL_LAYOUT = mesh, layout_of(mesh)


def initialize_serving_mesh(tp: int = 1, n_devices: Optional[int] = None,
                            dp: Optional[int] = None):
    """The multi-card serving recipe (the JAX package's
    ``initialize_serving_mesh``): install a global mesh whose 'model' axis
    is ``tp`` and whose 'data' axis takes the rest, and return it (pass it
    to ``init_inference(mesh=...)`` / ``ServingEngine(mesh=...)``).  Where
    the JAX package lays one process's devices out, the port's mesh is the
    process group's world: one rank per card (``torchrun --nproc-per-node
    N``, or ``comm.init_distributed``), every rank running the same serving
    loop.  ``n_devices`` (at most the world) takes the first
    ``n_devices`` ranks, as JAX takes the first devices: every rank must
    call this, in the same order (it makes the mesh's groups), and a rank
    past them gets an :class:`OutsideMesh` handle, which
    ``init_inference(mesh=)`` refuses naming the rank."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("initialize_serving_mesh needs a process group (one "
                           "rank per device): call deepspeed_tpu_torch.comm."
                           "init_distributed() first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"n_devices={n} exceeds the {world} rank(s) of the process group")
    if n == world:
        return initialize_mesh(MeshLayout.from_world(world, tp=tp, dp=dp))
    global _GLOBAL_MESH, _GLOBAL_LAYOUT
    layout = MeshLayout.from_world(n, tp=tp, dp=dp)
    mesh = build_mesh(layout, first_ranks=True)
    reset_mesh()
    _GLOBAL_LAYOUT, _GLOBAL_MESH = layout, mesh
    for axis in MESH_AXES:   # every rank makes every group, in one order
        axis_group(axis)
    axis_group(MESH_AXES)
    if dist.get_rank() >= n:
        return OutsideMesh(dist.get_rank(), n, world)
    return mesh


def get_mesh():
    if _GLOBAL_MESH is None:
        initialize_mesh()
    return _GLOBAL_MESH


def get_layout() -> MeshLayout:
    """The global layout; a world of one when no mesh exists and no process
    group does (single-process mode)."""
    if _GLOBAL_LAYOUT is None:
        if _world() == 1 and not _dist().is_initialized():
            return MeshLayout()
        initialize_mesh()
    return _GLOBAL_LAYOUT


def reset_mesh() -> None:
    """Forget the global mesh and destroy the axis groups made for it."""
    global _GLOBAL_MESH, _GLOBAL_LAYOUT
    dist = _dist()
    for group in {id(g): g for g, _ in _GROUPS.values()}.values():
        if group is not None and group is not dist.group.WORLD \
                and dist.is_initialized():
            dist.destroy_process_group(group)
    _GROUPS.clear()
    _GLOBAL_MESH = None
    _GLOBAL_LAYOUT = None


# ---------------------------------------------------------------------------
# Axis groups
# ---------------------------------------------------------------------------

def canonical_axes(axis: AxisName) -> Tuple[str, ...]:
    """``axis`` as a tuple of mesh axes in mesh order (groups are ranked
    row-major over the mesh, so a tuple is always read outer to inner)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    bad = [a for a in axes if a not in MESH_AXES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad}; axes are {MESH_AXES}")
    return tuple(a for a in MESH_AXES if a in axes)


def axis_size(mesh_or_layout, axis: AxisName) -> int:
    layout = (mesh_or_layout if isinstance(mesh_or_layout, MeshLayout)
              else layout_of(mesh_or_layout))
    sizes = dict(zip(MESH_AXES, layout.axis_sizes()))
    return math.prod(sizes[a] for a in canonical_axes(axis))


def axis_group(axis: AxisName):
    """``(group, size)`` of this rank along ``axis``: the process group
    (``torch.distributed``'s WORLD when the axes span every rank, None when
    they have size 1) and its size.  Groups are made on first use, every
    group of the axes in the same order on every rank (``new_group`` is
    collective over the world)."""
    axes = canonical_axes(axis)
    hit = _GROUPS.get(axes)
    if hit is not None:
        return hit
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return None, 1
    layout = get_layout()
    size = axis_size(layout, axes)
    sizes = dict(zip(MESH_AXES, layout.axis_sizes()))
    # axes of size 1 add no rank: the group of the others is the same one
    key = tuple(a for a in axes if sizes[a] > 1)
    if key != axes and key in _GROUPS:
        _GROUPS[axes] = _GROUPS[key]
        return _GROUPS[key]
    if size == dist.get_world_size():
        hit = (dist.group.WORLD, size)
    elif size == 1:
        hit = (None, 1)
    else:
        topo = ProcessTopology(MESH_AXES, layout.axis_sizes())
        me, mine = dist.get_rank(), None
        for ranks in topo.get_axes_comm_lists(axes):
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
        hit = (mine, size)
    _GROUPS[axes] = _GROUPS[key] = hit
    return hit


def axis_coordinate(axis: AxisName, rank: Optional[int] = None) -> int:
    """This rank's index along ``axis`` (row-major over a tuple of axes)."""
    axes = canonical_axes(axis)
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    layout = get_layout()
    coord = ProcessTopology(MESH_AXES, layout.axis_sizes()).get_coord(
        dist.get_rank() if rank is None else rank)
    idx = 0
    for a in axes:
        idx = idx * dict(zip(MESH_AXES, layout.axis_sizes()))[a] + getattr(coord, a)
    return idx


def dp_world_size(mesh=None) -> int:
    return axis_size(mesh if mesh is not None else get_layout(), BATCH_AXES)


# ---------------------------------------------------------------------------
# Coordinate bookkeeping (ProcessTopology parity, topology.py:12).  Ranks
# are process ranks, one process per device, row-major over the axes.
# ---------------------------------------------------------------------------

class ProcessTopology:
    """Named-axis cartesian rank mapping over arbitrary axes.

    API parity with the reference ``ProcessTopology`` (topology.py:12):
    ``get_rank(**coords)``, ``get_coord(rank)``, ``get_dim``, ``get_axis_list``.
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        assert len(axes) == len(dims)
        self.axes = tuple(axes)
        self.dims = tuple(int(d) for d in dims)

    def world_size(self) -> int:
        return math.prod(self.dims) if self.dims else 1

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)]

    def get_rank(self, **coords) -> int:
        missing = set(self.axes) - set(coords)
        if missing:
            raise ValueError(f"missing coords for axes {missing}")
        rank = 0
        for axis, dim in zip(self.axes, self.dims):
            c = coords[axis]
            if not 0 <= c < dim:
                raise ValueError(f"coord {axis}={c} out of range [0,{dim})")
            rank = rank * dim + c
        return rank

    def get_coord(self, rank: int):
        coords = {}
        for axis, dim in zip(reversed(self.axes), reversed(self.dims)):
            coords[axis] = rank % dim
            rank //= dim
        Coord = collections.namedtuple("Coord", self.axes)
        return Coord(**{a: coords[a] for a in self.axes})

    def get_axis_list(self, axis: str, idx: int):
        """All ranks whose coordinate on `axis` equals idx (a "group")."""
        return [r for r in range(self.world_size()) if getattr(self.get_coord(r), axis) == idx]

    def get_axis_comm_lists(self, axis: str):
        """Lists of ranks that communicate along `axis` (vary axis, fix others)."""
        return self.get_axes_comm_lists((axis,))

    def get_axes_comm_lists(self, axes: Sequence[str]):
        """Lists of ranks that communicate along several axes at once (vary
        ``axes``, fix the others), in the order of the fixed coordinates."""
        others = [a for a in self.axes if a not in axes]
        groups = {}
        for r in range(self.world_size()):
            coord = self.get_coord(r)
            key = tuple(getattr(coord, a) for a in others)
            groups.setdefault(key, []).append(r)
        return [sorted(v) for _, v in sorted(groups.items())]


def _check_factorization(zero_cfg) -> None:
    mics = zero_cfg.mics_shard_size
    hpz = zero_cfg.zero_hpz_partition_size
    hier = getattr(zero_cfg, "zero_hierarchical_dp_size", -1)
    actives = [k for k, v in [("mics_shard_size", mics > 0),
                              ("zero_hpz_partition_size", hpz > 1),
                              ("zero_hierarchical_dp_size", hier > 1)] if v]
    if len(actives) > 1:
        raise ValueError(
            f"{' and '.join(actives)} all factorize the data axis — "
            "enable exactly one")
    # hpZ and the hierarchical DP size reuse MiCS's inner x outer split
    # ('data' x 'data_outer'); the engine's planner diverges for them
    # (hpZ: masters and gradients on the whole group, the compute view on
    # the inner one; hierarchical: everything on the whole group)
    if hpz > 1:
        return hpz
    if hier > 1:
        return hier
    return mics


def engine_layout(mc, zero_cfg, world: int) -> MeshLayout:
    """The engine's layout over ``world`` ranks from the config's
    parallelism degrees (``mc``: dp, tp, pp, ep, sp) and the data axis's
    factorization (MiCS, reference ``runtime/zero/mics.py:351``: ZeRO
    shards within groups of ``mics_shard_size`` ranks, replicated across
    'data_outer' replica groups; ZeRO++ hpZ and the hierarchical DP size
    split it the same way).  The JAX package's arithmetic and messages."""
    mics = _check_factorization(zero_cfg)
    dp_outer = 1
    if mics > 0:
        # ZeRO shards over ZERO_AXES=('data','expert'), so the shard
        # group spans the expert axis too: inner data size = mics / ep.
        denom = mc.tp * mc.pp * mc.ep * mc.sp
        if not mc.dp and world % denom != 0:
            raise ValueError(
                f"world size {world} not divisible by "
                f"tp*pp*ep*sp={denom}")
        full_dp = mc.dp or (world // denom)
        if mics % mc.ep != 0:
            raise ValueError(
                f"mics_shard_size={mics} must be a multiple of "
                f"ep={mc.ep}: ZeRO shard groups span the expert axis")
        inner_dp = mics // mc.ep
        if full_dp % inner_dp != 0:
            raise ValueError(
                f"mics_shard_size={mics} (inner data degree "
                f"{inner_dp} after the ep={mc.ep} factor) must "
                f"divide the DP degree {full_dp}")
        dp_outer = full_dp // inner_dp
        mics = inner_dp
    return MeshLayout.from_world(
        world, tp=mc.tp, pp=mc.pp, ep=mc.ep, sp=mc.sp,
        dp=(mics if mics > 0 else (mc.dp or None)), dp_outer=dp_outer)


def resolve_engine_mesh(mc, zero_cfg, mesh=None):
    """Build (or validate and install) the engine's mesh: ``mesh`` is a
    ``MeshLayout`` or a mesh built by :func:`build_mesh`; by default the
    config's :func:`engine_layout` over the process group's world."""
    if isinstance(mesh, MeshLayout):
        mesh = initialize_mesh(mesh)
    if mesh is None:
        mesh = initialize_mesh(engine_layout(mc, zero_cfg, _world()))
        _log_hierarchical(zero_cfg)
        return mesh
    mics = _check_factorization(zero_cfg)
    set_mesh(mesh)
    _log_hierarchical(zero_cfg)
    if mics > 0:
        # ZeRO shard group on an explicit mesh = inner data x expert
        layout = layout_of(mesh)
        group = layout.dp * layout.ep
        if group != mics:
            raise ValueError(
                f"mics_shard_size={mics} conflicts with the explicit "
                f"mesh's ZeRO group size data×expert={group}; build the "
                f"mesh with MeshLayout(dp=mics//ep, dp_outer=...) instead")
    return mesh


def _log_hierarchical(zero_cfg) -> None:
    if zero_cfg.mics_shard_size > 0 and zero_cfg.mics_hierarchical_params_gather:
        from ..utils.logging import log_dist

        # the gathers over the factorized axes already run inner group by
        # inner group: the knob is satisfied by the layout
        log_dist("MiCS: hierarchical gather is implicit in the factorized "
                 "mesh (per-axis process groups)", ranks=[0])


def topology_from_mesh(mesh=None) -> ProcessTopology:
    layout = layout_of(mesh) if mesh is not None else get_layout()
    return ProcessTopology(axes=MESH_AXES, dims=layout.axis_sizes())
