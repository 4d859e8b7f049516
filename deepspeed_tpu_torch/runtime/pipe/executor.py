"""The pipeline executor (the port's counterpart of
``deepspeed_tpu/runtime/pipe/spmd.py``; reference ``runtime/pipe/engine.py``).

The JAX package runs the stages as one SPMD program: a scan over a shifted
buffer of stage states, rolled one stage forward each step by a
``collective_permute``; its backward is AD of that scan (GPipe) or a second
wavefront in the same scan (1F1B).  Fill and drain steps compute on zero
padding, whose aux loss it masks (spmd.py:55-60).

The port runs the reference's way: each stage holds its layers and steps
through an instruction stream (``schedule.py``): ``GPipeSchedule`` (every
forward, then every backward, each backward through autograd) or
``TrainSchedule`` (1F1B).  A tick first moves the activations and
gradients the previous tick produced (``Send*``/``Recv*``), then runs its
``ForwardPass``/``BackwardPass``.  A stage runs only the microbatches it
holds, so a fill or drain bubble computes nothing and adds no aux loss:
that is the JAX package's masking.

The transport is a parameter:

- :class:`VirtualTransport`: every stage in this process (one card or the
  CPU), messages handed over in memory, as ``ops/ring_attention.py``'s
  virtual ring runs its ranks;
- :class:`AxisTransport`: one stage a rank of the mesh's 'pipe' axis, each
  tick's sends and receives posted together (``batch_isend_irecv``), so
  neighbouring stages never wait on each other's order.

A stage program is ``forward(stage, m, x) -> (y, extra)``: stage 0 gets
``x = None`` and loads microbatch ``m`` itself, the last stage returns its
scalar objective as ``y``; ``extra`` is an optional scalar (the stage's
share of the MoE aux loss) that the backward adds as a second root.  The
backward of ``y`` (with the gradient received from the next stage, or
``loss_scale`` for the last) accumulates into the ``.grad`` of whatever
leaves the stage read.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .schedule import (BackwardPass, ForwardPass, GPipeSchedule, LoadMicroBatch,
                       RecvActivation, RecvGrad, SendActivation, SendGrad,
                       TrainSchedule)

SCHEDULES = {"gpipe": GPipeSchedule, "1f1b": TrainSchedule}


def stage_layer_count(num_layers: int, num_stages: int) -> int:
    if num_layers % num_stages:
        raise ValueError(
            f"num_layers={num_layers} not divisible by pipeline stages={num_stages}")
    return num_layers // num_stages


class VirtualTransport:
    """Every stage in one process: a mailbox keyed by (kind, src, dst, m)."""

    def __init__(self):
        self.box: Dict[tuple, torch.Tensor] = {}

    def exchange(self, sends: List[tuple], recvs: List[tuple]) -> List[torch.Tensor]:
        for key, tensor in sends:
            self.box[key] = tensor
        return [self.box.pop(key) for key, _, _ in recvs]


class AxisTransport:
    """One stage a rank of ``axis``: a tick's messages in one
    ``batch_isend_irecv`` over the axis's group (stage i = axis index i)."""

    def __init__(self, device, axis: str = "pipe"):
        from ...parallel.mesh import axis_group

        self.group, _ = axis_group(axis)
        self.device = device

    def exchange(self, sends: List[tuple], recvs: List[tuple]) -> List[torch.Tensor]:
        import torch.distributed as dist

        ops, out = [], []
        for (kind, src, dst, m), tensor in sends:
            ops.append(dist.P2POp(dist.isend, tensor.contiguous(),
                                  dist.get_global_rank(self.group, dst), group=self.group))
        for (kind, src, dst, m), shape, dtype in recvs:
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            out.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(self.group, src),
                                  group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


class _Stage:
    """One stage's buffers: its inputs (leaves whose grad goes back), its
    outputs and extras, by microbatch."""

    def __init__(self):
        self.fwd_m = 0          # next microbatch to run forward
        self.bwd_m = 0          # next microbatch to run backward
        self.inputs: Dict[int, Optional[torch.Tensor]] = {}
        self.outputs: Dict[int, torch.Tensor] = {}
        self.extras: Dict[int, Optional[torch.Tensor]] = {}
        self.grads_in: Dict[int, torch.Tensor] = {}
        self.sent: Dict[int, torch.Tensor] = {}


def run_pipeline(forward: Callable, num_stages: int, micro_batches: int,
                 stages: Sequence[int], transport, act_shape: Tuple[int, ...],
                 act_dtype: torch.dtype, schedule: str = "gpipe",
                 loss_scale: float = 1.0) -> Dict[int, torch.Tensor]:
    """Run ``schedule`` over the ``stages`` this process holds (all of them
    for a :class:`VirtualTransport`, one for an :class:`AxisTransport`),
    calling ``forward(stage, m, x) -> (y, extra)`` for each forward and
    backpropagating each through autograd.  Activations are ``act_shape``
    of ``act_dtype`` between stages (what a stage sends is cast to it).
    Returns the last stage's objective per microbatch (detached; empty
    where this process does not hold the last stage)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {schedule!r}; "
                         f"one of {', '.join(SCHEDULES)}")
    last = num_stages - 1
    scheds = {s: iter(SCHEDULES[schedule](micro_batches, num_stages, s)) for s in stages}
    state = {s: _Stage() for s in stages}
    losses: Dict[int, torch.Tensor] = {}
    while True:
        ticks = {s: next(scheds[s], None) for s in stages}
        if all(t is None for t in ticks.values()):
            break
        sends, recvs, owners = [], [], []
        for s, cmds in ticks.items():
            st = state[s]
            for cmd in cmds or ():
                if isinstance(cmd, SendActivation):
                    m = st.fwd_m - 1
                    sends.append((("act", s, s + 1, m), st.sent.pop(m).to(act_dtype)))
                elif isinstance(cmd, SendGrad):
                    m = st.bwd_m - 1
                    sends.append((("grad", s, s - 1, m), st.sent.pop(m).to(act_dtype)))
                elif isinstance(cmd, RecvActivation):
                    recvs.append((("act", s - 1, s, st.fwd_m), act_shape, act_dtype))
                    owners.append((s, "act", st.fwd_m))
                elif isinstance(cmd, RecvGrad):
                    recvs.append((("grad", s + 1, s, st.bwd_m), act_shape, act_dtype))
                    owners.append((s, "grad", st.bwd_m))
        for (s, kind, m), t in zip(owners, transport.exchange(sends, recvs)):
            if kind == "act":
                state[s].inputs[m] = t.detach().requires_grad_()
            else:
                state[s].grads_in[m] = t
        for s, cmds in ticks.items():
            st = state[s]
            for cmd in cmds or ():
                if isinstance(cmd, LoadMicroBatch):
                    continue   # the stage program loads its own microbatch
                if isinstance(cmd, ForwardPass):
                    m = st.fwd_m
                    y, extra = forward(s, m, st.inputs.get(m))
                    st.outputs[m], st.extras[m] = y, extra
                    if s == last:
                        losses[m] = y.detach()
                    else:   # the activation the next tick ships
                        st.sent[m] = y.detach()
                    st.fwd_m += 1
                elif isinstance(cmd, BackwardPass):
                    m = st.bwd_m
                    y, extra = st.outputs.pop(m), st.extras.pop(m)
                    roots, grads = [y], [
                        torch.full_like(y, loss_scale) if s == last
                        else st.grads_in.pop(m).to(y.dtype)]
                    if extra is not None:
                        roots.append(extra)
                        grads.append(torch.full_like(extra, loss_scale))
                    torch.autograd.backward(roots, grads)
                    x = st.inputs.pop(m, None)
                    if s > 0:   # the activation gradient the next tick ships
                        st.sent[m] = x.grad
                    st.bwd_m += 1
    return losses
