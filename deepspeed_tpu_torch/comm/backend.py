"""Communication backend (counterpart of ``deepspeed_tpu/comm/backend.py``,
whose ``XLABackend`` emits traced ``lax`` collectives over mesh axes;
reference ``comm/backend.py:25`` and ``comm/torch.py``).

:class:`TorchBackend` runs the same collectives eagerly through
``torch.distributed``, over the process group of a mesh axis or tuple of
axes (``parallel.mesh.axis_group``): NCCL on the card, gloo on the CPU,
as ``get_accelerator().communication_backend_name()`` says.  Every op is
functional, as in the JAX package: it returns a new tensor and leaves its
input alone, except that an axis of size 1 in a larger world (or any axis
without a process group) needs no communication and returns the input
itself.  In a world of one the axes' group is the world, so the
collectives still run (as copies).  A collective that fails raises
``torch.distributed``'s error.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..parallel.mesh import AxisName, axis_coordinate, axis_group


class Backend:
    def __init__(self, name: str = "backend", rank: int = 0, size: int = 1):
        self.name = name
        self.initialized = False

    def is_initialized(self) -> bool:
        return self.initialized

    def init_process_group(self) -> None:
        self.initialized = True

    def destroy_process_group(self) -> None:
        self.initialized = False


_REDUCE_OPS = ("sum", "max", "min", "avg", "mean", "prod")


def _dist():
    import torch.distributed as dist

    return dist


class TorchBackend(Backend):
    """Data-plane collectives over mesh axes, issued eagerly."""

    def __init__(self):
        super().__init__(name="torch")

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum",
                   axis: AxisName = ()) -> torch.Tensor:
        if op not in _REDUCE_OPS:
            raise ValueError(f"unsupported reduce op {op}")
        group, n = axis_group(axis)
        if group is None:
            return tensor
        dist = _dist()
        out = tensor.clone()
        # AVG is a SUM and a division on every backend (gloo has no AVG)
        red = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
               "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}[op]
        dist.all_reduce(out, op=red, group=group)
        if op in ("avg", "mean"):
            out = out / n
        return out

    def all_gather(self, tensor: torch.Tensor, axis: AxisName,
                   gather_dim: int = 0) -> torch.Tensor:
        """The shards concatenated along ``gather_dim`` in axis order
        (tiled, as ``lax.all_gather(..., tiled=True)``)."""
        group, n = axis_group(axis)
        if group is None:
            return tensor
        x = tensor.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _dist().all_gather_into_tensor(out, x, group=group)
        if gather_dim == 0:
            return out
        return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=gather_dim)

    def reduce_scatter(self, tensor: torch.Tensor, axis: AxisName,
                       scatter_dim: int = 0) -> torch.Tensor:
        """The sum over the axis, this rank's 1/n slice along
        ``scatter_dim`` (``lax.psum_scatter(..., tiled=True)``)."""
        group, n = axis_group(axis)
        if group is None:
            return tensor
        if tensor.shape[scatter_dim] % n:
            raise ValueError(f"reduce_scatter: dim {scatter_dim} of "
                             f"{tuple(tensor.shape)} not divisible by {n}")
        if scatter_dim == 0:
            x = tensor.contiguous()
        else:
            x = torch.stack(tensor.chunk(n, dim=scatter_dim))
        out_shape = list(tensor.shape)
        out_shape[scatter_dim] //= n
        if scatter_dim == 0:
            out = x.new_empty(out_shape)
            _dist().reduce_scatter_tensor(out, x, group=group)
            return out
        out = x.new_empty(x.shape[1:])
        _dist().reduce_scatter_tensor(out, x.reshape((-1,) + tuple(x.shape[2:])),
                                      group=group)
        return out

    def all_to_all(self, tensor: torch.Tensor, axis: AxisName, split_dim: int = 0,
                   concat_dim: int = 0) -> torch.Tensor:
        """Split along ``split_dim`` into n chunks, chunk j to axis index j,
        the chunks received concatenated along ``concat_dim`` in axis order
        (``lax.all_to_all(..., tiled=True)``)."""
        group, n = axis_group(axis)
        if group is None:
            return tensor
        if tensor.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{tuple(tensor.shape)} not divisible by {n}")
        x = torch.stack(tensor.chunk(n, dim=split_dim))
        out = torch.empty_like(x)
        _dist().all_to_all_single(out, x, group=group)
        return torch.cat(out.unbind(0), dim=concat_dim)

    def permute(self, tensor: torch.Tensor, axis: AxisName,
                perm: List[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: axis index ``src`` sends to ``dst`` for each
        pair; a rank no pair sends to gets zeros."""
        group, n = axis_group(axis)
        me = axis_coordinate(axis)
        if group is None:
            return tensor.clone() if (0, 0) in list(perm) else torch.zeros_like(tensor)
        dist = _dist()
        x = tensor.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in perm:
            if src == dst == me:
                out.copy_(x)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst),
                                      group=group))
            if dst == me:
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                                      group=group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def broadcast(self, tensor: torch.Tensor, src: int, axis: AxisName) -> torch.Tensor:
        """Axis index ``src``'s tensor on every rank of the axis."""
        group, n = axis_group(axis)
        if group is None:
            return tensor
        dist = _dist()
        out = tensor.clone()
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    def axis_index(self, axis: AxisName) -> int:
        return axis_coordinate(axis)

    def axis_size(self, axis: AxisName) -> int:
        return axis_group(axis)[1]
