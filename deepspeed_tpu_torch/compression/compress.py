"""Compression orchestration: config -> parameter transform -> physical
cleanup (counterpart of ``deepspeed_tpu/compression/compress.py``;
reference ``compression/compress.py`` ``init_compression:100``,
``redundancy_clean:148``, ``student_initialization:192``).

As in the JAX package, compression is one function ``transform(params,
step) -> params`` built from the ``compression_training`` block and applied
by the engine to the compute-precision tree each micro-step: the
straight-through fake-quant and the pruning masks, composed in the
config's technique order.  Modules match by '/'-joined parameter-path
substring; a stacked ``[L, ...]`` leaf ('layers/wq') is one match for every
layer.  Weight quantization takes its statistics over the whole stacked
leaf; the pruning masks are per layer (``_per_layer``), as the JAX
package's vmap makes them.

The step is a Python int here, so each technique's ``schedule_offset`` gate
and the annealed bit-width are decided on the host (JAX traces them into
one compiled step; the values are the same).

:meth:`ParamTransform.leaf_ops` splits a leaf's transform into elementwise
operations and their operands (a fake-quant's scale, a mask), computed on
the whole leaf: the engine takes them over the gathered leaf and applies
them to the piece a rank holds (ZeRO-3, the 'model' axis), so the
statistics are the whole leaf's, as GSPMD gives them in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.logging import logger
from ..utils.tree import tree_leaves, tree_map, tree_map_with_path
from .prune import apply_mask, channel_mask, head_mask, row_mask, sparse_mask
from .quantize import bit_schedule, quant_apply, quant_stats


@dataclasses.dataclass(frozen=True)
class TechniqueGroup:
    """One ``different_groups`` entry: params + module name patterns."""
    name: str
    modules: Tuple[str, ...]
    params: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Technique:
    kind: str                       # weight_quantization | sparse_pruning | ...
    shared: Dict[str, Any]
    groups: Tuple[TechniqueGroup, ...]

    @property
    def schedule_offset(self) -> int:
        return int(self.shared.get("schedule_offset", 0))


TECHNIQUES = ("weight_quantization", "activation_quantization",
              "sparse_pruning", "row_pruning", "head_pruning",
              "channel_pruning")
STRUCTURED = ("row_pruning", "head_pruning", "channel_pruning")


def parse_compression_config(ds_config: Optional[Dict]) -> List[Technique]:
    block = (ds_config or {}).get("compression_training")
    if not block:
        return []
    techniques = []
    for kind in TECHNIQUES:
        tc = block.get(kind)
        if not tc:
            continue
        shared = tc.get("shared_parameters", {})
        if not shared.get("enabled", False):
            continue
        groups = tuple(
            TechniqueGroup(name=gname,
                           modules=tuple(g.get("modules", ["*"])),
                           params=dict(g.get("params", {})))
            for gname, g in tc.get("different_groups", {}).items())
        techniques.append(Technique(kind=kind, shared=shared, groups=groups))
    unknown = set(block) - set(TECHNIQUES) - {"layer_reduction"}
    if unknown:
        raise ValueError(f"unknown compression_training techniques: {unknown}")
    return techniques


def _matches(path: str, patterns: Sequence[str]) -> bool:
    return any(p == "*" or p in path for p in patterns)


def _per_layer(mask_fn):
    """A mask builder applied per stacked layer: leaves in the stacked
    layout are [L, ...] and thresholds must not mix layers
    (``redundancy_clean`` keeps indices per layer too)."""
    def wrapped(w, *args, **kw):
        return mask_fn(w, *args, batch_dims=1 if w.ndim >= 3 else 0, **kw)
    return wrapped


def apply_op(op: tuple, x: torch.Tensor) -> torch.Tensor:
    """One elementwise operation of :meth:`ParamTransform.leaf_ops` on
    ``x`` (the whole leaf or a piece of it, with the operands cut alike)."""
    if op[0] == "quant":
        _, bits, symmetric, (scale, lo) = op
        return quant_apply(x, bits, symmetric, scale, lo)
    return apply_mask(x, op[-1][0])


class ParamTransform:
    """``transform(params, step) -> params`` of a ``compression_training``
    block (the QAT and pruning techniques; activation quantization is a
    forward concern, wired into the model by the engine)."""

    def __init__(self, techniques: List[Technique], num_heads: Optional[int]):
        self.techniques = techniques
        self.num_heads = num_heads

    def touches(self, name: str, ndim: int) -> bool:
        """Whether any technique matches the leaf ``name``."""
        return ndim >= 2 and any(_matches(name, g.modules)
                                 for t in self.techniques for g in t.groups)

    def leaf_ops(self, name: str, w: torch.Tensor, step: int) -> List[tuple]:
        """The leaf's elementwise operations at ``step``, in order, each
        with its operands (last, tensors that broadcast against the leaf)
        taken on the running (whole) value: ``("quant", bits, symmetric,
        (scale, lo))`` or ``("mask", (mask,))``."""
        ops: List[tuple] = []
        if w.ndim < 2:
            return ops
        out = w.detach()
        for t in self.techniques:
            for g in t.groups:
                if not _matches(name, g.modules) or step < t.schedule_offset:
                    continue
                op = self._op(t, g, out, step)
                if op is not None:
                    ops.append(op)
                    out = apply_op(op, out)
        return ops

    def _op(self, t: Technique, g: TechniqueGroup, out: torch.Tensor, step: int):
        ratio = float(g.params.get("dense_ratio", 0.5))
        if t.kind == "weight_quantization":
            bits = bit_schedule(step, int(g.params.get("start_bits", 8)),
                                int(g.params.get("target_bits", 8)), t.schedule_offset,
                                int(g.params.get("quantization_period", 1)))
            if bits >= 16:
                return None
            sym = t.shared.get("quantization_type", "symmetric") == "symmetric"
            per_channel = bool(t.shared.get("quantize_groups", 1) != 1)
            return ("quant", bits, sym, quant_stats(out, bits, sym, per_channel))
        if t.kind == "sparse_pruning":
            mask = _per_layer(sparse_mask)(out, ratio, t.shared.get("method", "l1"))
        elif t.kind == "row_pruning":
            mask = _per_layer(row_mask)(out, ratio, axis=-1)
        elif t.kind == "channel_pruning":
            mask = _per_layer(channel_mask)(out, ratio, axis=-2)
        else:   # head_pruning
            nh = int(t.shared.get("num_heads", self.num_heads or 0))
            if nh <= 0:
                raise ValueError(
                    "head_pruning needs shared_parameters."
                    "num_heads (or an engine-known head count)")
            mask = _per_layer(head_mask)(out, nh, ratio)
        return ("mask", (mask,))

    def apply_leaf(self, name: str, w: torch.Tensor, step: int) -> torch.Tensor:
        out = w
        for op in self.leaf_ops(name, w, step):
            out = apply_op(op, out)
        return out

    def __call__(self, params, step: int):
        step = int(step)
        return tree_map_with_path(
            lambda name, w: self.apply_leaf(name, w, step)
            if isinstance(w, torch.Tensor) else w, params)


def build_param_transform(ds_config: Optional[Dict],
                          num_heads: Optional[int] = None) -> Optional[ParamTransform]:
    """transform(params, step) -> params, or None when compression is off.

    Weight quantization uses the annealed bit schedule; pruning masks
    engage from each technique's ``schedule_offset``."""
    techniques = [t for t in parse_compression_config(ds_config)
                  if t.kind != "activation_quantization"]
    if not techniques:
        return None
    for t in techniques:
        if t.kind in STRUCTURED:
            for g in t.groups:
                if "*" in g.modules:
                    raise ValueError(
                        f"{t.kind} group '{g.name}' must list explicit "
                        "modules: structured masks assume a specific weight "
                        "layout (e.g. head_pruning applies to the attention "
                        "output projection 'wo'); a wildcard would corrupt "
                        "embeddings and mismatched projections")
    matched = [f"{t.kind}({', '.join(g.name for g in t.groups)})" for t in techniques]
    logger.info(f"compression enabled: {'; '.join(matched)}")
    return ParamTransform(techniques, num_heads)


# ---------------------------------------------------------------------------
# Physical cleanup and distillation init (offline)
# ---------------------------------------------------------------------------

def _descending(score: torch.Tensor, keep: int) -> torch.Tensor:
    """``argsort(score)[:, ::-1][:, :keep]`` (a stable ascending sort,
    reversed: among equal scores the later index comes first)."""
    return torch.argsort(score, dim=1, stable=True).flip(1)[:, :keep]


def redundancy_clean(params: Dict[str, Any], ds_config: Dict,
                     num_heads: Optional[int] = None) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Physically remove pruned structures on the stacked transformer
    layout: row/channel pruning shrinks the MLP's hidden dimension (w_gate/
    w_up columns and w_down rows, kept per layer by the summed L1 of
    w_gate and w_up), head pruning the heads of wo, and of wq/wk/wv where
    their last dim is the heads' (a GQA model keeps its KV heads).
    Returns (new_params, new_dims) with {'intermediate_size': F',
    'num_heads': H'} where they changed."""
    techniques = {t.kind: t for t in parse_compression_config(ds_config)}
    params = tree_map(lambda x: x, params)   # a new tree, the same leaves
    new_dims: Dict[str, int] = {}
    layers = params.get("layers")

    row = techniques.get("row_pruning") or techniques.get("channel_pruning")
    if row is not None and layers is not None and "w_gate" in layers:
        ratio = float(next(iter(row.groups)).params.get("dense_ratio", 0.5)) \
            if row.groups else 0.5
        g, u, d = layers["w_gate"], layers["w_up"], layers["w_down"]
        F = g.shape[2]
        keep = max(1, int(round(F * ratio)))
        score = (torch.sum(torch.abs(g.to(torch.float32)), dim=1)
                 + torch.sum(torch.abs(u.to(torch.float32)), dim=1))    # [L, F]
        idx = _descending(score, keep)                                   # [L, keep]
        layers["w_gate"] = torch.stack([m.index_select(-1, i) for m, i in zip(g, idx)])
        layers["w_up"] = torch.stack([m.index_select(-1, i) for m, i in zip(u, idx)])
        layers["w_down"] = torch.stack([m.index_select(0, i) for m, i in zip(d, idx)])
        new_dims["intermediate_size"] = keep

    head = techniques.get("head_pruning")
    if head is not None and layers is not None and "wo" in layers:
        nh = int(head.shared.get("num_heads", num_heads or 0))
        if nh <= 0:
            raise ValueError("head_pruning cleanup needs num_heads")
        ratio = float(next(iter(head.groups)).params.get("dense_ratio", 0.5)) \
            if head.groups else 0.5
        wo = layers["wo"]                        # [L, H*hd, d]
        L, in_dim, dmodel = wo.shape
        hd = in_dim // nh
        keep = max(1, int(round(nh * ratio)))
        score = torch.sum(torch.abs(wo.to(torch.float32)).reshape(L, nh, hd * dmodel), dim=-1)
        idx = _descending(score, keep)

        def take_heads(m, i, head_axis):
            mh = m.reshape(m.shape[:head_axis] + (nh, hd) + m.shape[head_axis + 1:])
            out = mh.index_select(head_axis, i)
            return out.reshape(m.shape[:head_axis] + (keep * hd,) + m.shape[head_axis + 1:])

        layers["wo"] = torch.stack([take_heads(m, i, 0) for m, i in zip(wo, idx)])
        for name in ("wq", "wk", "wv"):
            if name in layers and layers[name].shape[-1] == in_dim:
                layers[name] = torch.stack([take_heads(m, i, 1)
                                            for m, i in zip(layers[name], idx)])
        new_dims["num_heads"] = keep

    if new_dims:
        logger.info(f"redundancy_clean: new dims {new_dims}")
    return params, new_dims


def student_initialization(teacher_params: Dict[str, Any],
                           ds_config: Dict) -> Dict[str, Any]:
    """Layer-reduction init: a shallower student gathering the
    ``teacher_layer`` indices (default: ``keep_number_layer`` evenly
    strided) of the stacked per-layer leaves; the rest copies through."""
    lr = (ds_config or {}).get("compression_training", {}).get("layer_reduction", {})
    if not lr.get("enabled", False):
        raise ValueError("layer_reduction is not enabled in the config")
    teacher_layer = lr.get("teacher_layer")
    if not teacher_layer:
        keep = int(lr["keep_number_layer"])
        L = tree_leaves(teacher_params["layers"])[0].shape[0]
        stride = L / keep
        teacher_layer = [int(i * stride) for i in range(keep)]
    student = dict(teacher_params)

    def take(x):
        return x.index_select(0, torch.as_tensor(teacher_layer, dtype=torch.long,
                                                 device=x.device))

    student["layers"] = tree_map(take, teacher_params["layers"])
    logger.info(f"student init from teacher layers {list(teacher_layer)}")
    return student


def init_compression(params: Dict[str, Any], ds_config: Dict,
                     teacher_params: Optional[Dict[str, Any]] = None,
                     num_heads: Optional[int] = None):
    """(params, transform): the layer-reduction student init now (when the
    config enables it), and the transform for the engine to apply each
    step."""
    lr = (ds_config or {}).get("compression_training", {}).get("layer_reduction", {})
    if lr.get("enabled", False):
        params = student_initialization(teacher_params or params, ds_config)
    return params, build_param_transform(ds_config, num_heads=num_heads)

