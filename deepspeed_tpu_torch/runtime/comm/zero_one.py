"""0/1 Adam: variance freeze and local steps (counterpart of
``deepspeed_tpu/runtime/comm/zero_one.py``; reference
``deepspeed/runtime/fp16/onebit/zoadam.py``, arXiv 2202.06009).

Two mechanisms the error-feedback 1-bit path does not have:

  1. **Adaptive variance freeze** (the 0): the second moment updates only
     on an exponentially growing interval (``var_interval`` doubles every
     ``var_update_scaler`` updates) and freezes after ``var_freeze_step``.
     On a variance step the gradients are averaged in full precision; on
     the other warm-up steps, 1-bit compressed.
  2. **Local steps** (the 1): once the variance froze, each rank applies
     Adam updates from its own gradients to its own parameters (the
     reference's drifting ``p.data``); every ``local_step_interval`` steps
     (doubling every ``local_step_scaler`` steps, at most
     ``local_step_clipper``) the ranks exchange the accumulated update
     1-bit compressed, the average replaces each rank's drift, and the
     momentum resyncs as ``m = -u_avg / sum(lr)`` (zoadam.py:246-262).

Each rank's masters are its drifted parameters; ``acc`` holds the update
they accumulated since the last sync (the reference's accumulator, the
JAX package's per-worker ``delta``), so the synced parameters are
``masters - acc``.  The schedule, the arithmetic and the reported norm are
the JAX package's; the counters are host integers.  Pure data parallelism
at ZeRO stage 0, no fp16 loss scaling and no clipping, as there.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ... import comm
from ...parallel.mesh import BATCH_AXES
from ...utils.tree import tree_leaves
from .compressed import DEFAULT_BLOCK, compressed_mean, flat_padded, pad_len


@dataclasses.dataclass
class ZeroOneState:
    """Per rank: ``exp_avg`` (drifts between syncs), ``acc``, ``error``
    (flat [npad] EF residuals); equal on every rank: ``exp_avg_sq`` (fed
    only with averaged gradients), ``lrs`` and the interval counters."""

    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]
    acc: List[torch.Tensor]
    error: List[torch.Tensor]
    lrs: float = 0.0
    var_interval: int = 1
    var_counter: int = 0
    local_interval: int = 1
    local_counter: int = 0


def init_zero_one_state(params, device=None, block: int = DEFAULT_BLOCK) -> ZeroOneState:
    leaves = tree_leaves(params)
    zeros = lambda: [torch.zeros_like(x, dtype=torch.float32) for x in leaves]  # noqa: E731
    return ZeroOneState(
        exp_avg=zeros(), exp_avg_sq=zeros(), acc=zeros(),
        error=[torch.zeros(pad_len(x.numel(), block), dtype=torch.float32,
                           device=x.device) for x in leaves])


def zero_one_step(masters: List[torch.Tensor], local_grads: List[torch.Tensor],
                  zo: ZeroOneState, step: int, lr: float, hyper: dict,
                  axis=BATCH_AXES, block: int = DEFAULT_BLOCK):
    """One 0/1 Adam step: ``masters`` (this rank's fp32 leaves) and
    ``local_grads`` (this rank's unscaled gradients: its mean over its
    rows and the window) -> (new masters, new state, grad norm)."""
    b1, b2 = hyper.get("betas", (0.9, 0.999))
    eps = hyper.get("eps", 1e-8)
    wd = hyper.get("weight_decay", 0.0)
    var_freeze_step = int(hyper.get("var_freeze_step", 100000))
    var_update_scaler = int(hyper.get("var_update_scaler", 16))
    local_step_scaler = int(hyper.get("local_step_scaler", 32678))
    local_step_clipper = int(hyper.get("local_step_clipper", 16))
    count = step + 1   # the reference's state['step'] after its increment
    error = zo.error
    if count == var_freeze_step + 1:
        # the EF buffers change meaning at the freeze (gradient residual ->
        # accumulated-update residual): reset once (reinitial_error_buffer)
        error = [torch.zeros_like(e) for e in error]

    def compressed(tensors, errs):
        means, new = [], []
        for t, e in zip(tensors, errs):
            m, e2 = compressed_mean(flat_padded(t, block), e, axis, block)
            means.append(m[:t.numel()].reshape(t.shape))
            new.append(e2)
        return means, new

    def vdot_sum(ts):
        total = None
        for t in ts:
            s = torch.dot(t.reshape(-1), t.reshape(-1))
            total = s if total is None else total + s
        return total

    if count <= var_freeze_step:   # phase A: the variance still updates
        on_var = count % zo.var_interval == 0
        if on_var:
            g = [comm.all_reduce(x, comm.AVG, axis) for x in local_grads]
            new_error = error
        else:
            g, new_error = compressed(local_grads, error)
        m = [b1 * mi + (1.0 - b1) * gi for mi, gi in zip(zo.exp_avg, g)]
        v = ([b2 * vi + (1.0 - b2) * gi * gi for vi, gi in zip(zo.exp_avg_sq, g)]
             if on_var else zo.exp_avg_sq)
        new_p = [p - lr * (mi / (torch.sqrt(vi) + eps) + wd * p)
                 for p, mi, vi in zip(masters, m, v)]
        gnorm = torch.sqrt(vdot_sum(g))
        vc = zo.var_counter + 1 if on_var else zo.var_counter
        grow = vc == var_update_scaler
        new_zo = dataclasses.replace(
            zo, exp_avg=m, exp_avg_sq=v, acc=[torch.zeros_like(a) for a in zo.acc],
            error=new_error, lrs=0.0, var_counter=0 if grow else vc,
            var_interval=zo.var_interval * 2 if grow else zo.var_interval)
        return new_p, new_zo, gnorm

    # phase B: frozen variance, local steps
    m = [b1 * mi + (1.0 - b1) * gi for mi, gi in zip(zo.exp_avg, local_grads)]
    upd = [mi / (torch.sqrt(vi) + eps) + wd * p
           for mi, vi, p in zip(m, zo.exp_avg_sq, masters)]
    drifted = [p - lr * u for p, u in zip(masters, upd)]
    acc = [a - lr * u for a, u in zip(zo.acc, upd)]
    lrs = zo.lrs + lr
    if count % zo.local_interval == 0:   # sync
        # acc * (sqrt(v)+eps) = -sum(lr * m) (zoadam.py:248)
        buf = [a * (torch.sqrt(vi) + eps) for a, vi in zip(acc, zo.exp_avg_sq)]
        buf_avg, new_error = compressed(buf, error)
        m = [-ba / lrs for ba in buf_avg]
        new_p = [(d - a) + ba / (torch.sqrt(vi) + eps)
                 for d, a, ba, vi in zip(drifted, acc, buf_avg, zo.exp_avg_sq)]
        acc = [torch.zeros_like(a) for a in acc]
        lrs = 0.0
    else:
        new_p, new_error = drifted, error
    gsq = comm.all_reduce(vdot_sum(local_grads), comm.AVG, axis)
    gnorm = torch.sqrt(gsq)
    lc = zo.local_counter + 1
    grow = lc == local_step_scaler
    new_zo = dataclasses.replace(
        zo, exp_avg=m, acc=acc, error=new_error, lrs=lrs,
        local_counter=0 if grow else lc,
        local_interval=(min(local_step_clipper, zo.local_interval * 2) if grow
                        else zo.local_interval))
    return new_p, new_zo, gnorm
