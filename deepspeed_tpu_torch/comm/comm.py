"""``deepspeed_tpu_torch.comm`` — the comm facade (counterpart of
``deepspeed_tpu/comm/comm.py``; reference ``deepspeed/comm/comm.py``).

The same two halves as the JAX package:

- **Data plane** — ``all_reduce``, ``all_gather``, ``reduce_scatter``,
  ``all_to_all``, ``ppermute``/``send_recv_next``/``send_recv_prev``,
  ``broadcast``, ``axis_index`` and ``get_axis_size``, each addressed by
  mesh axis name or tuple of names (``parallel.mesh``), as the JAX
  functions are inside ``shard_map``.  Here they run eagerly over
  ``torch.distributed`` (``backend.TorchBackend``) and return new tensors.
- **Control plane** — ``init_distributed`` (the process group, one process
  per device), ``get_rank``/``get_world_size``/``get_local_rank``,
  ``barrier``, ``broadcast_object``.

Every data-plane op is wrapped by :func:`timed_op`, which feeds the comms
logger (``configure``, ``get_comms_logger``, ``log_summary``): the op kind,
the mesh axes it ran over and the bytes of the tensor handed in, per call.
The model-axis collectives of tensor parallelism
(``parallel/tensor_parallel.py``) go through the same ops, so they can run
inside autograd and inside a CUDA graph's capture (after a warm-up that
creates the NCCL communicators); a captured call is logged once, when it
is captured.
"""
from __future__ import annotations

import datetime
import functools
import inspect
import os
import weakref
from typing import Any, Optional

import torch

from ..parallel.mesh import BATCH_AXES, AxisName, canonical_axes, reset_mesh
from ..utils.logging import log_dist
from .backend import TorchBackend


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    AVG = "avg"
    PRODUCT = "prod"


# module-level aliases of the canonical ReduceOp vocabulary
SUM = ReduceOp.SUM
MAX = ReduceOp.MAX
MIN = ReduceOp.MIN
AVG = ReduceOp.AVG

_backend = TorchBackend()
_comms_logger = None  # attached by configure()


def configure(comms_config=None) -> None:
    """Attach a fresh comms logger (reference ``dist.configure``) when
    ``comms_config`` (a dict or an object with ``enabled`` and the optional
    ``verbose``, ``prof_all``, ``prof_ops``) is enabled; otherwise leave
    things as they are, as the JAX package does."""
    global _comms_logger
    from ..utils.comms_logging import CommsLogger, _get

    if comms_config is not None and _get(comms_config, "enabled", False):
        _comms_logger = CommsLogger(comms_config)


def get_comms_logger():
    return _comms_logger


def _nbytes(tensor: Any) -> int:
    if isinstance(tensor, torch.Tensor):
        return tensor.numel() * tensor.element_size()
    return 0


def timed_op(fn):
    """Record the op's name, mesh axes and message size (reference
    comm.py:100)."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(tensor, *args, **kwargs):
        if _comms_logger is not None:
            bound = sig.bind(tensor, *args, **kwargs)
            bound.apply_defaults()
            axis = bound.arguments.get("axis")
            _comms_logger.append(fn.__name__, _nbytes(tensor),
                                 axis=None if axis is None else
                                 "/".join(canonical_axes(axis)),
                                 dtype=(str(tensor.dtype).replace("torch.", "")
                                        if isinstance(tensor, torch.Tensor) else None))
        return fn(tensor, *args, **kwargs)

    return wrapper


# ---------------------------------------------------------------------------
# Data plane
# ---------------------------------------------------------------------------

@timed_op
def all_reduce(tensor, op: str = SUM, axis: AxisName = BATCH_AXES):
    return _backend.all_reduce(tensor, op, axis)


@timed_op
def inference_all_reduce(tensor, axis: AxisName = "model"):
    return _backend.all_reduce(tensor, SUM, axis)


@timed_op
def all_gather(tensor, axis: AxisName, gather_dim: int = 0):
    """Tiled all-gather: the shards concatenated along gather_dim (reference
    all_gather_into_tensor, comm.py:300)."""
    return _backend.all_gather(tensor, axis, gather_dim=gather_dim)


@timed_op
def reduce_scatter(tensor, axis: AxisName, scatter_dim: int = 0):
    """Tiled reduce-scatter (reference reduce_scatter_tensor, comm.py:257)."""
    return _backend.reduce_scatter(tensor, axis, scatter_dim)


@timed_op
def all_to_all(tensor, axis: AxisName, split_dim: int = 0, concat_dim: int = 0):
    """Tiled all-to-all (reference all_to_all_single, comm.py:361)."""
    return _backend.all_to_all(tensor, axis, split_dim, concat_dim)


@timed_op
def ppermute(tensor, axis: AxisName, perm):
    """Collective permute over axis indices (reference pipeline send/recv
    pairs, runtime/pipe/p2p.py:50-99)."""
    return _backend.permute(tensor, axis, list(perm))


@timed_op
def broadcast(tensor, src: int = 0, axis: AxisName = BATCH_AXES):
    return _backend.broadcast(tensor, src, axis)


def send_recv_next(tensor, axis: AxisName):
    """Shift +1 along an axis ring (index i -> i+1, the last wraps to 0)."""
    n = _backend.axis_size(axis)
    return ppermute(tensor, axis, [(i, (i + 1) % n) for i in range(n)])


def send_recv_prev(tensor, axis: AxisName):
    n = _backend.axis_size(axis)
    return ppermute(tensor, axis, [((i + 1) % n, i) for i in range(n)])


def axis_index(axis: AxisName) -> int:
    return _backend.axis_index(axis)


def get_axis_size(axis: AxisName) -> int:
    return _backend.axis_size(axis)


# ---------------------------------------------------------------------------
# Control plane
# ---------------------------------------------------------------------------
_initialized = False


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """True once ``init_distributed`` ran (in single-process mode too) or a
    process group exists."""
    dist = _dist()
    return _initialized or (dist.is_available() and dist.is_initialized())


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def init_distributed(dist_backend: Optional[str] = None, auto_mpi_discovery: bool = True,
                     verbose: bool = True, timeout=None, init_method: Optional[str] = None,
                     rank: int = -1, world_size: int = -1) -> None:
    """The process group (reference init_distributed, comm.py:578-745).

    One process per device.  Discovery order: explicit ``rank`` and
    ``world_size`` (with ``init_method``, else ``MASTER_ADDR``/
    ``MASTER_PORT``) > ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
    ``MASTER_PORT`` (torchrun's) > ``init_method`` alone (a URL carrying
    rank and world size) > single-process mode, which creates no group.
    The backend is the accelerator's (NCCL on the card, gloo on the CPU)
    unless ``dist_backend`` names one.  On the card each rank binds to the
    device ``LOCAL_RANK`` names (else rank modulo the device count) before
    the group exists; a rank that finds no card raises."""
    global _initialized
    dist = _dist()
    if dist.is_initialized():
        _initialized = True
        return
    if _initialized:
        return
    from ..accelerator import get_accelerator

    accel = get_accelerator()
    backend = dist_backend or accel.communication_backend_name()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend={backend!r}: the port runs nccl or gloo")
    world = world_size if world_size > 0 else _env_int("WORLD_SIZE", 0)
    r = rank if rank >= 0 else _env_int("RANK", -1)
    if isinstance(timeout, (int, float)):
        timeout = datetime.timedelta(seconds=timeout)
    kw = {} if timeout is None else {"timeout": timeout}
    method = init_method
    if world > 0 and r >= 0:
        if method is None:
            if not os.environ.get("MASTER_ADDR"):
                raise ValueError(
                    f"rank {r} of {world} given but no rendezvous: pass "
                    "init_method= or set MASTER_ADDR/MASTER_PORT")
            method = "env://"
        kw.update(rank=r, world_size=world)
    elif method is None:
        if verbose:
            log_dist("init_distributed: single-process mode", [0])
        _initialized = True
        return
    if backend == "nccl":
        from ..accelerator.cuda_accelerator import require_cuda

        require_cuda()
        count = torch.cuda.device_count()
        local = _env_int("LOCAL_RANK", (r if r >= 0 else 0) % count)
        if local >= count:
            raise RuntimeError(f"LOCAL_RANK={local} but only {count} CUDA device(s)")
        torch.cuda.set_device(local)
        # gloo beside NCCL serves the host tensors (checkpoint planning)
        backend = "cpu:gloo,cuda:nccl"
        kw["device_id"] = torch.device("cuda", local)
    if verbose:
        log_dist(f"init_distributed: backend={backend} init_method={method} "
                 f"world_size={world if world > 0 else '?'}", [0])
    dist.init_process_group(backend=backend, init_method=method, **kw)
    _initialized = True


# Objects holding a CUDA graph that captured collectives (the serving
# executor's decode step), held weakly: the group's teardown closes them
# first, since a live graph with NCCL work keeps destroy_process_group
# from returning (seen on 4 H100s).
_CAPTURES: "weakref.WeakSet" = weakref.WeakSet()


def register_capture(owner) -> None:
    """Record ``owner`` (anything with ``close()``) as holding a CUDA graph
    whose capture issued collectives; :func:`destroy_process_group` closes
    it before the teardown."""
    _CAPTURES.add(owner)


def destroy_process_group() -> None:
    """Tear the process group and the mesh's groups down, after closing
    every live owner of a captured graph (:func:`register_capture`)."""
    global _initialized
    dist = _dist()
    for owner in list(_CAPTURES):
        owner.close()
    _CAPTURES.clear()
    reset_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def get_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank() -> int:
    return _env_int("LOCAL_RANK", 0)


def barrier() -> None:
    """Every rank waits for every other (reference comm.py:398)."""
    dist = _dist()
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj: Any, src_process: int = 0) -> Any:
    """Rank ``src_process``'s picklable object on every rank."""
    dist = _dist()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src_process)
    return box[0]


def log_summary(show_bandwidth: bool = False, print_log: bool = True):
    """Print (and return) the comms table; ``show_bandwidth`` re-times each
    (op, size) as a standalone collective for algbw/busbw columns."""
    if _comms_logger is None:
        return ""
    return _comms_logger.log_all(print_log=print_log,
                                 show_bandwidth=show_bandwidth)


# -- capability probing (reference comm.py:300 has_all_gather_into_tensor,
#    torch.py:39 has_coalescing_manager), answered for torch.distributed
def has_all_gather_into_tensor() -> bool:
    return hasattr(_dist(), "all_gather_into_tensor")


def has_reduce_scatter_tensor() -> bool:
    return hasattr(_dist(), "reduce_scatter_tensor")


def has_coalescing_manager() -> bool:
    """The facade issues one collective per call; no coalescing manager is
    exposed (bucketing is later work, ROADMAP queue 1, item 4)."""
    return False


def has_all_to_all_single() -> bool:
    return hasattr(_dist(), "all_to_all_single")
