"""Megatron-style tensor parallelism over the mesh's ``'model'`` axis.

The JAX package declares ``param_specs`` (``models/transformer.py``) and
lets GSPMD insert the collectives a column- or row-parallel product needs.
Torch has no GSPMD, so this module spells them out, each through the
``comm`` facade on the model-axis group (NCCL on the card, gloo on the
CPU; an all-reduce, an all-gather, nothing else):

- :func:`copy_to_model`: identity forward, all-reduce backward; it feeds
  a column-parallel product (``wq``/``wk``/``wv``, ``w_gate``/``w_up``/
  ``w_in``, the LM head) the replicated activation, and sums the input's
  gradient over the ranks' column shards;
- :func:`reduce_from_model`: all-reduce forward, identity backward; it
  sums a row-parallel product's partial outputs (``wo``, ``w_down``);
- :func:`gather_from_model`: all-gather forward along the last dim (the
  vocab-parallel logits of inference), this rank's slice backward;
- :func:`vocab_parallel_embed`: look up the ids this rank's rows of the
  embedding own, zero the rest, all-reduce;
- :func:`vocab_parallel_cross_entropy_terms`: the ``(NLL sum, count)`` of
  ``models/transformer.py`` ``cross_entropy_terms`` over vocab-sharded
  logits: fp32, the max and the sum of exponentials all-reduced, the gold
  logit taken on the rank that owns it.  At one rank it computes what
  ``torch.logsumexp`` computes, in the same order (max, shifted exps,
  sum, log, add), and its gradient is the one autograd takes through the
  plain loss, so the one-rank path is bit-equal to the unsharded one.

The sharded path runs inside :func:`region` (the training engine, the
inference engine and the serving executor enter it around the model) or
whenever the global layout's model axis is above 1.  Outside it every
function here is the identity or the plain operation, so the model code
reads the same in both.  Every collective is a plain ``torch.distributed``
call, so the forward can run inside autograd and inside CUDA-graph
capture (after eager warm-up runs, which create the NCCL communicators).

Uneven shards: a dimension the model axis does not divide is padded at
its end to ``n`` whole shards (:func:`padded`; a head-sharded dim pads
whole heads, its ``unit`` the head dim) with zeros, then cut evenly
(:func:`slice_tree`), so rank ``i``'s true piece starts where the same
piece of the unpadded leaf starts.  The pads are zero weights whose
gradients are zero (a padded vocabulary column is ``NEG_INF`` before the
vocab-parallel logsumexp and is cut from gathered logits), so they stay
zero through the optimizer; :func:`gather_tree` cuts them off.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

MODEL_AXIS = "model"

# None: follow the global layout; True/False: forced by region().  Process-
# wide, not per thread: the autograd engine runs a backward's remat
# recompute on its own device threads, and it must take the path the
# forward took.
_FORCED: list = [None]


@contextlib.contextmanager
def region(active: bool = True):
    """Run the model's tensor-parallel path (``active``) or its plain path
    inside this block, whatever the global layout says."""
    prev, _FORCED[0] = _FORCED[0], bool(active)
    try:
        yield
    finally:
        _FORCED[0] = prev


def active() -> bool:
    """Whether the model runs its tensor-parallel path here."""
    if _FORCED[0] is not None:
        return _FORCED[0]
    from . import mesh

    layout = mesh._GLOBAL_LAYOUT
    return layout is not None and layout.tp > 1


def size() -> int:
    """Ranks on the model axis (1 outside the tensor-parallel path)."""
    if not active():
        return 1
    from .. import comm

    return comm.get_axis_size(MODEL_AXIS)


def rank() -> int:
    """This rank's index on the model axis (0 outside the path)."""
    if not active():
        return 0
    from .. import comm

    return comm.axis_index(MODEL_AXIS)


def _comm():
    from .. import comm

    return comm


def _same(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # a Function must not hand its input back as its output
    return out.view_as(out) if out is x else out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _comm().all_reduce(g, "sum", MODEL_AXIS)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _same(_comm().all_reduce(x, "sum", MODEL_AXIS), x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n, ctx.i = _comm().get_axis_size(MODEL_AXIS), _comm().axis_index(MODEL_AXIS)
        return _same(_comm().all_gather(x, MODEL_AXIS, gather_dim=x.dim() - 1), x)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, -1)[ctx.i].contiguous()


class _GatherShared(torch.autograd.Function):
    """All-gather along ``dim`` where every rank reads the whole result
    its own way: the gradient is the sum of the ranks' gradients, cut to
    this rank's piece (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _same(_comm().all_gather(x.contiguous(), MODEL_AXIS, gather_dim=dim), x)

    @staticmethod
    def backward(ctx, g):
        return _comm().reduce_scatter(g.contiguous(), MODEL_AXIS, scatter_dim=ctx.dim), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product (identity outside the path)."""
    return _CopyToModel.apply(x) if active() else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of a row-parallel product's partial outputs."""
    return _ReduceFromModel.apply(x) if active() else x


def gather_from_model(x: torch.Tensor, size: Optional[int] = None) -> torch.Tensor:
    """Vocab-sharded ``[..., V/tp]`` logits -> ``[..., V]`` on every rank
    (``size``: the true vocabulary, whose padded columns are cut)."""
    if not active():
        return x
    x = _GatherFromModel.apply(x)
    return x if size is None or x.shape[-1] == size else x[..., :size]


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model axis (no gradient:
    the int8 KV store's row amax, taken over every rank's KV heads)."""
    if not active() or size() == 1:
        return x
    return _comm().all_reduce(x, "max", MODEL_AXIS)


def gather_shared(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's piece of ``x`` along ``dim``, for a use that reads all
    of them (the gradient is summed over the ranks and cut back)."""
    return _GatherShared.apply(x, dim) if active() else x


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a table holding this rank's rows of the vocabulary
    (rows ``[rank*V/tp, (rank+1)*V/tp)``): the owned ids looked up, the
    others zero, the sum over the model axis."""
    if not active():
        return table[ids]
    n = table.shape[0]
    local = ids - rank() * n
    owned = (local >= 0) & (local < n)
    rows = table[torch.where(owned, local, torch.zeros_like(local))]
    return reduce_from_model(rows.masked_fill(~owned[..., None], 0))


class _VocabParallelNLL(torch.autograd.Function):
    """Per-position NLL of vocab-sharded logits: ``(logz - gold) * mask``,
    ``logz`` the log-sum-exp over the whole vocabulary."""

    @staticmethod
    def forward(ctx, logits, target, mask, vocab_size):
        comm = _comm()
        lg = logits.float()
        n = lg.shape[-1]
        if vocab_size is not None:
            # padded columns of the last shards: no share of the logsumexp
            live = max(min(vocab_size - comm.axis_index(MODEL_AXIS) * n, n), 0)
            if live < n:
                lg = lg.clone() if lg is logits else lg
                lg[..., live:] = float("-inf")
        # the steps of ATen's logsumexp: max (0 where infinite), shifted
        # exponentials, their sum, log, plus the max
        m = lg.amax(dim=-1, keepdim=True)
        m = _same(comm.all_reduce(m, "max", MODEL_AXIS), m)
        m.masked_fill_(m.abs() == float("inf"), 0)
        sumexp = torch.sum(torch.exp(lg - m), dim=-1)
        sumexp = _same(comm.all_reduce(sumexp, "sum", MODEL_AXIS), sumexp)
        logz = sumexp.log_().add_(m[..., 0])
        local = target - comm.axis_index(MODEL_AXIS) * n
        owned = (local >= 0) & (local < n)
        safe = torch.where(owned, local, torch.zeros_like(local))
        gold = torch.gather(lg, -1, safe[..., None])[..., 0] * owned
        gold = _same(comm.all_reduce(gold, "sum", MODEL_AXIS), gold)
        ctx.save_for_backward(lg, logz, safe, owned, mask)
        ctx.in_dtype = logits.dtype
        return (logz - gold) * mask

    @staticmethod
    def backward(ctx, g):
        lg, logz, safe, owned, mask = ctx.saved_tensors
        gm = g * mask
        # logsumexp's backward, then gather's (a scatter-add into zeros)
        soft = gm[..., None] * (lg - logz[..., None]).exp()
        gold = torch.zeros_like(lg).scatter_add_(-1, safe[..., None],
                                                 (-gm * owned)[..., None])
        return (soft + gold).to(ctx.in_dtype), None, None, None


def vocab_parallel_cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                                       ignore_index: int = -100,
                                       vocab_size: Optional[int] = None) -> tuple:
    """``(NLL sum, labelled count)`` of ``logits [..., V/tp]`` holding this
    rank's vocabulary columns, equal on every rank of the model axis
    (``vocab_size``: the true vocabulary; columns past it are padding)."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    nll = _VocabParallelNLL.apply(logits, safe, mask, vocab_size)
    return nll.sum(), mask.sum()


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def spec_dim(spec, axis: str = MODEL_AXIS) -> Optional[int]:
    """The tensor dim a PartitionSpec-like tuple shards over ``axis``."""
    for d, entry in enumerate(spec or ()):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if axis in names:
            return d
    return None


def _walk(fn, tree: Any, specs: Any, *others: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(fn, tree[k], specs[k], *(o[k] for o in others)) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        return type(tree)(_walk(fn, x, s, *(o[i] for o in others))
                          for i, (x, s) in enumerate(zip(tree, specs)))
    return fn(tree, specs, *others)


def spec_paths(specs: Any, prefix: str = "") -> dict:
    """``{'a/b': spec}`` of a tree of PartitionSpec-like tuples (the paths
    ``utils.tree.tree_flatten_with_path`` gives the parameter tree)."""
    if isinstance(specs, dict):
        out: dict = {}
        for k in sorted(specs):
            out.update(spec_paths(specs[k], f"{prefix}{k}/"))
        return out
    if isinstance(specs, list):   # a list of subtrees (specs are tuples)
        out = {}
        for i, sub in enumerate(specs):
            out.update(spec_paths(sub, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: specs}


def padded(extent: int, n: int, unit: int = 1) -> int:
    """``extent`` rounded up to ``n`` equal shards of whole ``unit``s."""
    count = extent // unit
    return -(-count // n) * n * unit


def local_shape(shape, spec, n: int, unit: int = 1) -> tuple:
    """The shape of one of ``n`` model-axis shards of a leaf (padded)."""
    shape = list(shape)
    d = spec_dim(spec)
    if d is not None:
        shape[d] = padded(shape[d], n, unit) // n
    return tuple(shape)


def pad_to(x: torch.Tensor, dim: int, extent: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to ``extent``."""
    if x.shape[dim] == extent:
        return x
    shape = list(x.shape)
    shape[dim] = extent - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim)


def shard_leaf(x: torch.Tensor, spec, index: int, n: int, unit: int = 1) -> torch.Tensor:
    """Shard ``index`` of ``n`` of one whole leaf (padded when uneven)."""
    d = spec_dim(spec)
    if d is None or n == 1:
        return x
    piece = pad_to(x, d, padded(x.shape[d], n, unit)).chunk(n, d)[index]
    return piece.clone(memory_format=torch.contiguous_format)   # frees the whole


def true_piece(x: torch.Tensor, spec, index: int, n: int, extent: int) -> torch.Tensor:
    """Rank ``index``'s shard ``x`` without its padding: the rows of it
    that lie within the whole leaf's ``extent`` along the sharded dim."""
    d = spec_dim(spec)
    if d is None or n == 1:
        return x
    live = max(min(extent - index * x.shape[d], x.shape[d]), 0)
    return x if live == x.shape[d] else x.narrow(d, 0, live)


def slice_tree(tree: Any, specs: Any, index: int, n: int, units: Any = None) -> Any:
    """Shard ``index`` of ``n`` of every leaf along its model-axis dim
    (contiguous chunks, rank order, padded at the end where ``n`` does not
    divide the dim in whole ``units``); replicated leaves as they are."""
    if units is None:
        return _walk(lambda x, spec: shard_leaf(x, spec, index, n), tree, specs)
    return _walk(lambda x, spec, u: shard_leaf(x, spec, index, n, u), tree, specs, units)


def gather_tree(tree: Any, specs: Any, shapes: Any = None,
                axis: str = MODEL_AXIS) -> Any:
    """The full leaves of a tree of model-axis shards (collective: every
    rank of the axis calls it, in the same order); ``shapes``, a tree of
    the whole leaves' shapes, cuts the padding of uneven shards.  ``axis``
    names another axis the specs cut ('expert', 'pipe')."""
    comm = _comm()

    def gather(x, spec, shape=None):
        d = spec_dim(spec, axis)
        if d is None:
            return x
        out = comm.all_gather(x.contiguous(), axis, gather_dim=d)
        if shape is not None and out.shape[d] != shape.shape[d]:
            out = out.narrow(d, 0, shape.shape[d]).contiguous()
        return out

    if shapes is None:
        return _walk(gather, tree, specs)
    return _walk(gather, tree, specs, shapes)


# ---------------------------------------------------------------------------
# Generic models: DTensor sharding propagation
# ---------------------------------------------------------------------------

def auto_tp_specs(params: Any, n: int) -> Any:
    """The JAX package's auto-TP rule (``inference/engine.py``
    ``auto_tp_specs``): each leaf of two or more dims shards its largest
    dim over 'model' when ``n`` divides it; everything else replicates."""
    def spec_for(x):
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) < 2 or n == 1:
            return ()
        dim = max(range(len(shape)), key=lambda i: (shape[i], -i))
        if shape[dim] % n:
            return ()
        return tuple("model" if i == dim else None for i in range(len(shape)))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return spec_for(tree)

    return walk(params)


def check_even(tree: Any, specs: Any, n: int) -> Any:
    """``tree``, after checking that ``n`` divides every dim its specs
    shard (a generic model's shards are DTensor's even ones)."""
    def check(x, spec):
        d = spec_dim(spec)
        if d is not None and x.shape[d] % n:
            raise ValueError(
                f"param_specs shard dim {d} of a leaf of shape {tuple(x.shape)} "
                f"over a model axis of {n}: uneven shards are padded for "
                "models.CausalLM only; a generic model's specs must divide")
        return x

    return _walk(check, tree, specs)


def _model_mesh():
    from . import mesh

    return mesh.get_mesh()[MODEL_AXIS]


def as_dtensors(tree: Any, specs: Any = None) -> Any:
    """Each tensor leaf of ``tree`` (this rank's pieces) as a DTensor on
    the 'model' sub-mesh: ``Shard`` on its spec's dim, ``Replicate`` where
    the spec names none or ``specs`` is None (a batch).  Differentiable:
    the gradients land on the local tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = _model_mesh()

    def wrap(x, spec=None):
        if not isinstance(x, torch.Tensor):
            return x
        d = spec_dim(spec)
        return DTensor.from_local(x, mesh, [Replicate() if d is None else Shard(d)],
                                  run_check=False)

    if specs is None:
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v) for v in t)
            return wrap(t)

        return walk(tree)
    return _walk(wrap, tree, specs)


def replicated(x: Any) -> Any:
    """A DTensor output as the whole tensor on every rank (partial sums
    reduced, shards gathered; differentiable); other values unchanged."""
    if hasattr(x, "full_tensor"):
        return x.full_tensor()
    if isinstance(x, (list, tuple)):
        return type(x)(replicated(v) for v in x)
    return x


__all__ = ["MODEL_AXIS", "region", "active", "size", "rank", "copy_to_model",
           "reduce_from_model", "gather_from_model", "gather_shared",
           "vocab_parallel_embed", "vocab_parallel_cross_entropy_terms", "spec_dim",
           "spec_paths", "padded", "local_shape", "pad_to", "shard_leaf", "true_piece",
           "slice_tree", "gather_tree", "auto_tp_specs", "check_even", "as_dtensors",
           "replicated"]
